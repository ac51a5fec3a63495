"""The compute of a chunkserver's part rebuild (the replicator), without
the wire.

Counterpart of the JAX package's ``ChunkServer._replicator_encoder`` and
``ChunkServer._replicate`` (``chunkserver/server.py``), step for step:
parse the target part, plan the read (a plain copy for std, else the
slice planner over the sources' parts with their health scores), run the
plan, checksum the rebuilt part's blocks and write them into the store.
:func:`plan_rebuild` and :func:`write_rebuilt` are the steps on either
side of the read, so that the server (``chunkserver/server.py``) awaits
the network executor between them; :func:`rebuild_part` composes the
three with an injected read (``execute``), as tests and ``chip_smoke.py``
run it over stores in process. The token bucket, QoS admission, metrics
and the master notify of the reference are the server's, not this
module's.
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


def plan_rebuild(
    part_id: int,
    sources,
    encoder: ChunkEncoder,
    scores: dict[int, float] | None = None,
) -> tuple[plans.SliceReadPlan, dict[int, tuple[Addr, int]], int]:
    """The read plan that rebuilds part ``part_id`` from ``sources``
    (part locations, see :func:`source_locations`), with the locations
    it reads and the part's block count. Recovery in the plan's
    post-processing runs on ``encoder``. ``scores`` (slice part ->
    health) default to the process-wide chunkserver stats of each
    source's address. Raises ``ChunkStoreError(NO_CHUNK)`` where the
    sources cannot rebuild the part."""
    target = geometry.ChunkPartType.from_id(part_id)
    slice_type = target.type
    locations = source_locations(target, sources)
    nblocks = geometry.number_of_blocks_in_part(target)
    if int(slice_type) == geometry.STANDARD:
        # plain copy of the same part (mode 1 of slice_recovery_planner)
        if 0 not in locations:
            raise ChunkStoreError(st.NO_CHUNK, "no source for copy")
        return plans.plan_for_standard(nblocks * MFSBLOCKSIZE), locations, nblocks
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
    return planner.build_plan([target.part], 0, nblocks, part_sizes), locations, nblocks


def write_rebuilt(
    store,
    chunk_id: int,
    version: int,
    part_id: int,
    data,
    nblocks: int,
    checksum_encoder: ChunkEncoder,
) -> None:
    """Write the first ``nblocks`` blocks of ``data`` (a plan's result)
    as part ``part_id`` into ``store``, creating the part if it is
    missing, with block CRCs from ``checksum_encoder``."""
    if store.get(chunk_id, part_id) is None:
        store.create(chunk_id, version, part_id)
    blocks = np.asarray(data[: nblocks * MFSBLOCKSIZE]).reshape(nblocks, MFSBLOCKSIZE)
    crcs = checksum_encoder.checksum(blocks)
    for b in range(nblocks):
        store.write(chunk_id, version, part_id, b, 0, blocks[b].tobytes(), int(crcs[b]))


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
    and return the plan it ran: :func:`plan_rebuild`, then
    ``execute(plan, chunk_id, version, locations)`` (reads the plan's
    parts and returns its post-processed buffer, as the network executor
    does), then :func:`write_rebuilt`. Recovery and the checksum both
    run on ``encoder``."""
    plan, locations, nblocks = plan_rebuild(part_id, sources, encoder, scores)
    data = execute(plan, chunk_id, version, locations)
    write_rebuilt(store, chunk_id, version, part_id, data, nblocks, encoder)
    return plan
