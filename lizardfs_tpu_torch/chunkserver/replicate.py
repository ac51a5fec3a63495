"""The compute of a chunkserver's part rebuild (the replicator), without
the wire.

Counterpart of the JAX package's ``ChunkServer._replicator_encoder`` and
``ChunkServer._replicate`` (``chunkserver/server.py``), step for step:
parse the target part, plan the read (a plain copy for std, else the
slice planner over the sources' parts with their health scores), run the
plan, checksum the rebuilt part's blocks and write them into the store.
The read itself is injected (``execute``): the server brings the network
executor; tests and ``chip_smoke.py`` pass one that reads stores in
process. The token bucket, QoS admission, metrics and the master notify
of the reference are the server's, not this module's.
"""

from __future__ import annotations

import numpy as np

from lizardfs_tpu_torch.chunkserver.chunk_store import ChunkStoreError
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry, plans
from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS
from lizardfs_tpu_torch.core.encoder import ChunkEncoder, MeshUnavailable, get_encoder
from lizardfs_tpu_torch.proto import status as st

Addr = tuple[str, int]


def replicator_encoder(configured: ChunkEncoder) -> ChunkEncoder:
    """The rebuild's encoder: the mesh-sharded one where it binds (two or
    more cards, ``LZ_SHARDED_RECOVERY`` open), else ``configured`` (the
    card's). Only the sharded encoder's refusal falls back; a build or
    launch error surfaces."""
    try:
        return get_encoder("sharded")
    except MeshUnavailable:
        return configured


def source_locations(target: geometry.ChunkPartType, sources) -> dict[int, tuple[Addr, int]]:
    """Slice part index -> (address, wire part id) of the first source of
    each part of ``target``'s slice. ``sources`` are objects with
    ``.part_id`` and ``.addr.host``/``.addr.port`` (part locations)."""
    locations: dict[int, tuple[Addr, int]] = {}
    for loc in sources:
        cpt = geometry.ChunkPartType.from_id(loc.part_id)
        if int(cpt.type) == int(target.type):
            locations.setdefault(cpt.part, ((loc.addr.host, loc.addr.port), loc.part_id))
    return locations


def rebuild_part(
    store,
    chunk_id: int,
    version: int,
    part_id: int,
    sources,
    execute,
    encoder: ChunkEncoder,
    scores: dict[int, float] | None = None,
) -> plans.SliceReadPlan:
    """Rebuild part ``part_id`` of a chunk into ``store`` from ``sources``
    (part locations, see :func:`source_locations`) and return the plan it
    ran. ``execute(plan, chunk_id, version, locations)`` reads the plan's
    parts and returns its post-processed buffer, as the network executor
    does; recovery in post-processing and the checksum run on
    ``encoder``. ``scores`` (slice part -> health) default to the
    process-wide chunkserver stats of each source's address."""
    target = geometry.ChunkPartType.from_id(part_id)
    slice_type = target.type
    locations = source_locations(target, sources)
    nblocks = geometry.number_of_blocks_in_part(target)
    if int(slice_type) == geometry.STANDARD:
        # plain copy of the same part (mode 1 of slice_recovery_planner)
        if 0 not in locations:
            raise ChunkStoreError(st.NO_CHUNK, "no source for copy")
        plan = plans.plan_for_standard(nblocks * MFSBLOCKSIZE)
    else:
        if scores is None:
            scores = {p: GLOBAL_STATS.score(a) for p, (a, _) in locations.items()}
        planner = plans.SliceReadPlanner(
            slice_type, list(locations.keys()), scores=scores, encoder=encoder,
        )
        if not planner.is_readable([target.part]):
            raise ChunkStoreError(st.NO_CHUNK, "not enough source parts")
        # per-part geometry lengths: trailing data parts hold one block
        # fewer than part 0 when the chunk does not stripe evenly
        part_sizes = {
            p: geometry.number_of_blocks_in_part(geometry.ChunkPartType(slice_type, p))
            * MFSBLOCKSIZE
            for p in range(slice_type.expected_parts)
        }
        plan = planner.build_plan([target.part], 0, nblocks, part_sizes)
    data = execute(plan, chunk_id, version, locations)
    if store.get(chunk_id, part_id) is None:
        store.create(chunk_id, version, part_id)
    blocks = np.asarray(data[: nblocks * MFSBLOCKSIZE]).reshape(nblocks, MFSBLOCKSIZE)
    crcs = encoder.checksum(blocks)
    for b in range(nblocks):
        store.write(chunk_id, version, part_id, b, 0, blocks[b].tobytes(), int(crcs[b]))
    return plan
