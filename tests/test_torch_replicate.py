"""The port's part rebuild (``chunkserver/replicate.py``) against the JAX
package's replicator compute, on the CPU.

Each case writes one chunk's parts into one store per "server" of each
package, loses a part, and rebuilds it: the port through ``rebuild_part``
with ``CudaChunkEncoder(device="cpu")`` (the kernels' plain versions),
the reference through the steps of ``ChunkServer._replicate`` with its
planner, ``CpuChunkEncoder`` and its store. Both read through the same
kind of in-process executor (wave by wave over the stores, failing parts
on request). The rebuilt files must be byte-identical to each other and
hold the lost part's bytes. Every value is exact.
"""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

from lizardfs_tpu.chunkserver import chunk_store as ref_store
from lizardfs_tpu.core import geometry as ref_geometry
from lizardfs_tpu.core import plans as ref_plans
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuEncoder
from lizardfs_tpu_torch.chunkserver import chunk_store as port_store
from lizardfs_tpu_torch.chunkserver import replicate
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import encoder as port_encoder
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.core.encoder import (
    CpuChunkEncoder,
    CudaChunkEncoder,
    MeshUnavailable,
    ShardedCudaChunkEncoder,
)
from lizardfs_tpu_torch.ops import crc32 as crc_mod
from lizardfs_tpu_torch.parallel.sharded import make_mesh
from lizardfs_tpu_torch.utils import data_generator, striping

CHUNK_ID, VERSION = 0x5EED, 3
CHUNK_LEN = 7 * MFSBLOCKSIZE + 12345  # trailing parts short and zero-padded


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """A rebuild computes over whole parts of the 1024-block geometry on
    the plain versions; two intra-op threads keep that from crowding the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@dataclass
class Addr:
    host: str
    port: int


@dataclass
class Loc:
    part_id: int
    addr: Addr


class StoreExecutor:
    """Runs a read plan wave by wave against stores in process, as the
    network executor does against chunkservers: ``stores`` maps an
    address to its store, parts in ``failing`` fail, a store error or a
    piece whose CRC does not match fails the part. Records the waves
    that ran."""

    def __init__(self, stores, failing=()):
        self.stores = stores
        self.failing = set(failing)
        self.waves = []

    def __call__(self, plan, chunk_id, version, locations):
        buffer = np.zeros(plan.buffer_size, dtype=np.uint8)
        available: list[int] = []
        unreadable: list[int] = []
        max_wave = max((op.wave for op in plan.read_operations), default=0)
        for wave in range(max_wave + 1):
            self.waves.append(wave)
            for op in plan.read_operations:
                if op.wave != wave:
                    continue
                try:
                    if op.part in self.failing or op.part not in locations:
                        raise IOError(f"part {op.part} unreadable")
                    addr, wire_part_id = locations[op.part]
                    pieces = self.stores[addr].read(
                        chunk_id, version, wire_part_id, op.request_offset, op.request_size)
                    if any(crc_mod.crc32(p) != c for _, p, c in pieces):
                        raise IOError(f"part {op.part}: piece CRC mismatch")
                except (IOError, port_store.ChunkStoreError, ref_store.ChunkStoreError):
                    unreadable.append(op.part)
                    if not plan.is_finishing_possible(unreadable):
                        raise IOError("plan cannot finish") from None
                    continue
                for off, piece, _crc in pieces:
                    start = op.buffer_offset + off - op.request_offset
                    buffer[start : start + len(piece)] = np.frombuffer(piece, np.uint8)
                available.append(op.part)
            if plan.is_reading_finished(available):
                break
        else:
            raise IOError("waves exhausted without enough parts")
        return plan.postprocess(buffer, available)


def _write_parts(mod, root, st, parts, lost):
    """One store per part (a "server" each) under ``root``, holding the
    part's real bytes (``part_length`` of the chunk); ``lost`` is not
    written. Returns (stores by address, part locations)."""
    stores, sources = {}, []
    for p, data in sorted(parts.items()):
        if p == lost:
            continue
        part_id = geometry.ChunkPartType(st, p).id
        addr = Addr("127.0.0.1", 9400 + p)
        store = mod.ChunkStore(str(root / f"cs{p}"))
        store.create(CHUNK_ID, VERSION, part_id)
        real = data[: striping.part_length(st, p, CHUNK_LEN)]
        for b in range(0, len(real), MFSBLOCKSIZE):
            piece = real[b : b + MFSBLOCKSIZE].tobytes()
            store.write(CHUNK_ID, VERSION, part_id, b // MFSBLOCKSIZE, 0, piece,
                        crc_mod.crc32(piece))
        stores[(addr.host, addr.port)] = store
        sources.append(Loc(part_id, addr))
    return stores, sources


def ref_replicate(store, part_id, sources, execute, encoder, scores=None):
    """The JAX package's ``ChunkServer._replicate`` compute
    (chunkserver/server.py), without its bucket, QoS, metrics and notify."""
    target = ref_geometry.ChunkPartType.from_id(part_id)
    slice_type = target.type
    locations = {}
    for loc in sources:
        cpt = ref_geometry.ChunkPartType.from_id(loc.part_id)
        if int(cpt.type) == int(slice_type):
            locations.setdefault(cpt.part, ((loc.addr.host, loc.addr.port), loc.part_id))
    nblocks = ref_geometry.number_of_blocks_in_part(target)
    if int(slice_type) == ref_geometry.STANDARD:
        plan = ref_plans.plan_for_standard(nblocks * MFSBLOCKSIZE)
    else:
        planner = ref_plans.SliceReadPlanner(
            slice_type, list(locations.keys()), scores=scores or {}, encoder=encoder)
        assert planner.is_readable([target.part])
        part_sizes = {
            p: ref_geometry.number_of_blocks_in_part(ref_geometry.ChunkPartType(slice_type, p))
            * MFSBLOCKSIZE
            for p in range(slice_type.expected_parts)
        }
        plan = planner.build_plan([target.part], 0, nblocks, part_sizes)
    data = execute(plan, CHUNK_ID, VERSION, locations)
    if store.get(CHUNK_ID, part_id) is None:
        store.create(CHUNK_ID, VERSION, part_id)
    blocks = np.asarray(data[: nblocks * MFSBLOCKSIZE]).reshape(nblocks, MFSBLOCKSIZE)
    crcs = encoder.checksum(blocks)
    for b in range(nblocks):
        store.write(CHUNK_ID, VERSION, part_id, b, 0, blocks[b].tobytes(), int(crcs[b]))
    return plan


def _ops(plan):
    return [(op.part, op.request_offset, op.request_size, op.buffer_offset, op.wave)
            for op in plan.read_operations]


# (slice type, lost part, failing source parts, scores)
CASES = {
    "ec(4,2)-data": (geometry.ec_type(4, 2), 1, (), None),
    "ec(8,4)-data": (geometry.ec_type(8, 4), 3, (), None),
    "ec(8,4)-parity-fallback": (geometry.ec_type(8, 4), 9, (0,), {11: 0.2, 2: 0.5}),
    "xor3-parity": (geometry.xor_type(3), 0, (), None),
    "xor3-trailing-data": (geometry.xor_type(3), 3, (), None),
    "std-copy": (geometry.SliceType(geometry.STANDARD), 0, (), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rebuild_part_matches_reference(tmp_path, case):
    _rebuild_against_reference(tmp_path, *CASES[case], CudaChunkEncoder(device="cpu"))


def test_rebuild_part_on_a_mesh_matches_reference(tmp_path):
    """The replicator's sharded encoder (a mesh of four CPU devices here)
    rebuilds on its mesh path, with the same file bytes."""
    enc = ShardedCudaChunkEncoder(mesh=make_mesh(["cpu"] * 4))
    _rebuild_against_reference(tmp_path, geometry.ec_type(8, 4), 3, (), None, enc)
    assert enc.recovers == {"mesh": 1, "card": 0}


def _rebuild_against_reference(tmp_path, st, lost, failing, scores, encoder):
    chunk = data_generator.generate(11, CHUNK_LEN)
    parts = striping.split_chunk(chunk, st, CpuChunkEncoder())
    if st.is_standard:
        parts = {0: chunk}
    part_id = geometry.ChunkPartType(st, lost).id

    port_sources = dict(zip(("stores", "sources"),
                            _write_parts(port_store, tmp_path / "port", st, parts,
                                         None if st.is_standard else lost)))
    ref_sources = dict(zip(("stores", "sources"),
                           _write_parts(ref_store, tmp_path / "ref", st, parts,
                                        None if st.is_standard else lost)))
    target = port_store.ChunkStore(str(tmp_path / "port-target"))
    ref_target = ref_store.ChunkStore(str(tmp_path / "ref-target"))
    run = StoreExecutor(port_sources["stores"], failing)
    ref_run = StoreExecutor(ref_sources["stores"], failing)
    plan = replicate.rebuild_part(
        target, CHUNK_ID, VERSION, part_id, port_sources["sources"], run, encoder, scores=scores)
    ref_plan = ref_replicate(ref_target, part_id, ref_sources["sources"], ref_run,
                             RefCpuEncoder(), scores=scores)
    assert _ops(plan) == _ops(ref_plan)
    assert run.waves == ref_run.waves
    if failing:
        assert max(run.waves) >= 1, "a fallback wave ran"

    cf, rcf = target.get(CHUNK_ID, part_id), ref_target.get(CHUNK_ID, part_id)
    assert open(cf.path, "rb").read() == open(rcf.path, "rb").read()
    assert target.test_part(cf)
    nblocks = geometry.number_of_blocks_in_part(geometry.ChunkPartType(st, lost))
    pieces = target.read(CHUNK_ID, VERSION, part_id, 0, nblocks * MFSBLOCKSIZE)
    got = np.concatenate([np.frombuffer(p, np.uint8) for _, p, _ in pieces])
    want = np.zeros(nblocks * MFSBLOCKSIZE, np.uint8)
    want[: len(parts[lost])] = parts[lost][: nblocks * MFSBLOCKSIZE]
    np.testing.assert_array_equal(got, want)
    # the other package's store scans and tests the rebuilt file
    other = ref_store.ChunkStore(str(tmp_path / "port-target"))
    [found] = other.scan()
    assert other.test_part(found)


def test_rebuild_part_refuses_without_sources(tmp_path):
    target = port_store.ChunkStore(str(tmp_path))
    st = geometry.ec_type(4, 2)
    sources = [Loc(geometry.ChunkPartType(st, p).id, Addr("h", p)) for p in (0, 1, 2)]
    for part_id, srcs in ((geometry.ChunkPartType(st, 5).id, sources), (0, [])):
        with pytest.raises(port_store.ChunkStoreError) as e:
            replicate.rebuild_part(target, 1, 1, part_id, srcs, None, CpuChunkEncoder())
        assert e.value.code == port_store.st.NO_CHUNK
    assert target.all_parts() == []


def test_source_locations_keep_the_targets_slice():
    st, other = geometry.ec_type(4, 2), geometry.xor_type(2)
    sources = [Loc(geometry.ChunkPartType(st, 2).id, Addr("a", 1)),
               Loc(geometry.ChunkPartType(other, 1).id, Addr("b", 2)),
               Loc(geometry.ChunkPartType(st, 2).id, Addr("c", 3)),
               Loc(geometry.ChunkPartType(st, 5).id, Addr("d", 4))]
    got = replicate.source_locations(geometry.ChunkPartType(st, 0), sources)
    assert got == {2: (("a", 1), sources[0].part_id), 5: (("d", 4), sources[3].part_id)}


def test_replicator_encoder_falls_back_only_on_the_mesh_refusal(monkeypatch):
    configured = CudaChunkEncoder(device="cpu")
    # no card here: the sharded encoder refuses with MeshUnavailable
    assert replicate.replicator_encoder(configured) is configured
    monkeypatch.setenv("LZ_SHARDED_RECOVERY", "0")
    with pytest.raises(MeshUnavailable, match="disabled"):
        port_encoder.get_encoder("sharded")
    assert replicate.replicator_encoder(configured) is configured
    monkeypatch.delenv("LZ_SHARDED_RECOVERY")
    sentinel = object()
    monkeypatch.setattr(replicate, "get_encoder", lambda name: sentinel)
    assert replicate.replicator_encoder(configured) is sentinel


@pytest.mark.parametrize("error", [RuntimeError("CUDA kernel encode failed to launch: error 98"),
                                   OSError("nvcc: not found"), ValueError("bad mesh")])
def test_replicator_encoder_surfaces_other_errors(monkeypatch, error):
    def failing(name):
        raise error

    monkeypatch.setattr(replicate, "get_encoder", failing)
    with pytest.raises(type(error), match=str(error)[:10]):
        replicate.replicator_encoder(CudaChunkEncoder(device="cpu"))


def test_mesh_refusal_is_a_runtime_error_of_its_own():
    assert issubclass(MeshUnavailable, RuntimeError)
    with pytest.raises(MeshUnavailable, match=">= 2 cards"):
        port_encoder.ShardedCudaChunkEncoder()


class Counting:
    """An encoder that counts the calls of each method it forwards."""

    def __init__(self, inner):
        self.inner, self.calls = inner, {}

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def counted(*args, **kwargs):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        return counted


@pytest.mark.parametrize("case", ["ec(4,2)-data", "xor3-parity"])
def test_plan_then_write_is_rebuild_part(tmp_path, case):
    """The server's two steps around its network read give the same plan
    and the same file as ``rebuild_part``. (The std copy's plan is one
    read; ``tests/test_torch_chunkserver.py`` holds the server's split
    to the reference for it.)"""
    st, lost, failing, scores = CASES[case]
    chunk = data_generator.generate(12, CHUNK_LEN)
    parts = {0: chunk} if st.is_standard else striping.split_chunk(chunk, st, CpuChunkEncoder())
    part_id = geometry.ChunkPartType(st, lost).id
    stores, sources = _write_parts(port_store, tmp_path / "src", st, parts,
                                   None if st.is_standard else lost)
    encoder = CudaChunkEncoder(device="cpu")
    whole = port_store.ChunkStore(str(tmp_path / "whole"))
    split = port_store.ChunkStore(str(tmp_path / "split"))
    plan = replicate.rebuild_part(whole, CHUNK_ID, VERSION, part_id, sources,
                                  StoreExecutor(stores, failing), encoder, scores=scores)
    plan2, locations, nblocks = replicate.plan_rebuild(part_id, sources, encoder, scores)
    assert _ops(plan2) == _ops(plan)
    assert locations == replicate.source_locations(geometry.ChunkPartType.from_id(part_id),
                                                   sources)
    assert nblocks == geometry.number_of_blocks_in_part(geometry.ChunkPartType(st, lost))
    data = StoreExecutor(stores, failing)(plan2, CHUNK_ID, VERSION, locations)
    replicate.write_rebuilt(split, CHUNK_ID, VERSION, part_id, data, nblocks, encoder)
    a, b = whole.get(CHUNK_ID, part_id), split.get(CHUNK_ID, part_id)
    assert open(a.path, "rb").read() == open(b.path, "rb").read()


def test_checksum_runs_on_the_encoder_given_to_write_rebuilt(tmp_path):
    """Recovery runs on the plan's encoder, the checksum on the one
    ``write_rebuilt`` is given, as the server splits them."""
    st, lost = geometry.ec_type(4, 2), 1
    parts = striping.split_chunk(data_generator.generate(13, CHUNK_LEN), st, CpuChunkEncoder())
    part_id = geometry.ChunkPartType(st, lost).id
    stores, sources = _write_parts(port_store, tmp_path / "src", st, parts, lost)
    recovery = Counting(CudaChunkEncoder(device="cpu"))
    configured = Counting(CudaChunkEncoder(device="cpu"))
    plan, locations, nblocks = replicate.plan_rebuild(part_id, sources, recovery)
    data = StoreExecutor(stores)(plan, CHUNK_ID, VERSION, locations)
    target = port_store.ChunkStore(str(tmp_path / "target"))
    replicate.write_rebuilt(target, CHUNK_ID, VERSION, part_id, data, nblocks, configured)
    assert recovery.calls == {"recover": 1}
    assert configured.calls == {"checksum": 1}
    assert target.test_part(target.get(CHUNK_ID, part_id))
