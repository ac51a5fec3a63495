"""The port's chunkserver and wave read executor on the wire, against the
JAX package's, on the CPU, byte-exact.

Each case runs chunkservers of one package and drives them with the
other package's client side (framed part writes, ``read_part_range``,
``execute_plan``), in process on ephemeral localhost ports: a part
written over the network and read back, a write chain relayed through
servers of both packages, and a degraded ec(3,2) read with one server
stopped (its connect is refused, so the plan's next wave runs at once).
Port servers compute on ``CudaChunkEncoder(device="cpu")``, the kernels'
plain versions; the servers of both packages serve through their asyncio
path, and the port's executor reads through its asyncio exchange (its
native one set aside; the native plane is compared in
``tests/test_torch_native_*.py``). ``core/read_executor.py`` is a
verbatim copy (the package name changed in imports).
"""

import asyncio
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest

from lizardfs_tpu.chunkserver import server as ref_server
from lizardfs_tpu.core import conn_pool as ref_conn_pool
from lizardfs_tpu.core import geometry as ref_geometry
from lizardfs_tpu.core import plans as ref_plans
from lizardfs_tpu.core import read_executor as ref_executor
from lizardfs_tpu.proto import framing as ref_framing
from lizardfs_tpu.proto import messages as ref_m
from lizardfs_tpu_torch.chunkserver import server as port_server
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import conn_pool, geometry, native_io, plans, read_executor
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder
from lizardfs_tpu_torch.ops import crc32
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.utils import striping
from tests.test_torch_master import assert_copy

ENCODER = CudaChunkEncoder(device="cpu")
PKG = {
    "port": SimpleNamespace(
        framing=framing, m=m, executor=read_executor, plans=plans, geometry=geometry,
        encoder=ENCODER,
        server=lambda root: port_server.ChunkServer(
            root, master_addr=None, encoder=ENCODER, native_data_plane=False),
    ),
    "jax": SimpleNamespace(
        framing=ref_framing, m=ref_m, executor=ref_executor, plans=ref_plans,
        geometry=ref_geometry, encoder=None,  # the JAX plans' default, its CPU encoder
        server=lambda root: ref_server.ChunkServer(
            root, master_addr=None, native_data_plane=False),
    ),
}
OTHER = {"port": "jax", "jax": "port"}


@pytest.fixture(autouse=True)
def asyncio_port_executor(monkeypatch):
    """The port executor's native read exchange set aside."""
    monkeypatch.setattr(native_io, "_lib", None)


def test_executor_is_a_copy():
    assert_copy("core/read_executor.py")


@contextlib.asynccontextmanager
async def running(pkgs, root):
    """Start one chunkserver of each package named in ``pkgs`` (a data
    folder each under ``root``); stop them all and close both packages'
    connection pools on the way out."""
    servers = []
    try:
        for i, pkg in enumerate(pkgs):
            cs = PKG[pkg].server(str(root / f"cs{i}"))
            await cs.start()
            servers.append(cs)
        yield servers
    finally:
        for cs in servers:
            await cs.stop()
        conn_pool.GLOBAL_POOL.close_all()
        ref_conn_pool.GLOBAL_POOL.close_all()


def addr(cs) -> tuple[str, int]:
    return ("127.0.0.1", cs.port)


async def write_part(pkg, cs, chunk_id, version, part_id, data, chain=()):
    """Write ``data`` as a part over the wire with ``pkg``'s framing: a
    ``CltocsWriteInit`` that creates the part (relayed down ``chain``, a
    list of (server, part id)), one ``CltocsWriteData`` a block with its
    host CRC, and a ``CltocsWriteEnd``. Every status must be OK."""
    fr, mm = PKG[pkg].framing, PKG[pkg].m
    reader, writer = await asyncio.open_connection(*addr(cs))
    try:
        await fr.send_message(writer, mm.CltocsWriteInit(
            req_id=1, chunk_id=chunk_id, version=version, part_id=part_id, create=True,
            chain=[mm.PartLocation(addr=mm.Addr(host="127.0.0.1", port=s.port), part_id=p)
                   for s, p in chain],
        ))
        assert (await fr.read_message(reader)).status == st.OK
        nblocks = -(-len(data) // MFSBLOCKSIZE)
        for b in range(nblocks):
            piece = bytes(data[b * MFSBLOCKSIZE : (b + 1) * MFSBLOCKSIZE])
            await fr.send_message(writer, mm.CltocsWriteData(
                req_id=10 + b, chunk_id=chunk_id, write_id=b + 1, block=b, offset=0,
                crc=crc32.crc32(piece), data=piece,
            ))
        acks = [await fr.read_message(reader) for _ in range(nblocks)]
        assert sorted(a.write_id for a in acks) == list(range(1, nblocks + 1))
        assert all(a.status == st.OK for a in acks), [a.status for a in acks]
        await fr.send_message(writer, mm.CltocsWriteEnd(req_id=99, chunk_id=chunk_id))
        assert (await fr.read_message(reader)).status == st.OK
    finally:
        writer.close()


def seeded(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("servers", ["port", "jax"])
def test_write_and_read_over_network(tmp_path, servers):
    """A part written and read by one package's client on the other's
    server; a wrong version is refused."""
    client = PKG[OTHER[servers]]
    part = geometry.ChunkPartType(geometry.ec_type(3, 2), 1).id
    data = seeded(MFSBLOCKSIZE + 500, 1)

    async def run():
        async with running([servers], tmp_path) as (cs,):
            await write_part(OTHER[servers], cs, 42, 1, part, data)
            got = await client.executor.read_part_range(addr(cs), 42, 1, part, 0, len(data))
            np.testing.assert_array_equal(got, data)
            mid = await client.executor.read_part_range(addr(cs), 42, 1, part, 60000, 6000)
            np.testing.assert_array_equal(mid, data[60000:66000])  # across a block
            with pytest.raises(client.executor.ReadError):
                await client.executor.read_part_range(addr(cs), 42, 9, part, 0, 10)

    asyncio.run(run())


@pytest.mark.parametrize("chain", [("port", "jax", "port"), ("jax", "port", "jax")],
                         ids=["port-head", "jax-head"])
def test_chain_write_across_packages(tmp_path, chain):
    """A write chain relayed through servers of both packages: every
    server stores the same bytes under its own part id, and both
    packages' executors read each copy back."""
    t = geometry.xor_type(2)
    part_ids = [geometry.ChunkPartType(t, p).id for p in range(3)]
    data = seeded(3 * MFSBLOCKSIZE + 777, 2)

    async def run():
        async with running(chain, tmp_path) as servers:
            head = servers[0]
            await write_part(OTHER[chain[0]], head, 7, 1, part_ids[0], data,
                             chain=list(zip(servers[1:], part_ids[1:])))
            for cs, pid in zip(servers, part_ids):
                for reader_pkg in ("port", "jax"):
                    got = await PKG[reader_pkg].executor.read_part_range(
                        addr(cs), 7, 1, pid, 0, len(data))
                    np.testing.assert_array_equal(got, data)

    asyncio.run(run())


@pytest.mark.parametrize("servers", ["port", "jax"])
def test_degraded_ec_read_with_a_server_stopped(tmp_path, servers):
    """ec(3,2) parts written over the wire to five servers; the server of
    part 1 stops; the other package's planner and ``execute_plan`` read
    data parts 0-2 over all five locations (the dead one refuses its
    connect, so the fallback wave runs) and recover part 1."""
    client = PKG[OTHER[servers]]
    t = geometry.ec_type(3, 2)
    length = 4 * MFSBLOCKSIZE + 777  # trailing data parts are short
    chunk = seeded(length, 3)
    parts = striping.split_chunk(chunk, t, ENCODER)

    async def run():
        async with running([servers] * 5, tmp_path) as cs:
            locations = {}
            for p, data in parts.items():
                pid = geometry.ChunkPartType(t, p).id
                await write_part(OTHER[servers], cs[p], 5, 1, pid,
                                 data[: striping.part_length(t, p, length)])
                locations[p] = (addr(cs[p]), pid)
            await cs[1].stop()
            planner = client.plans.SliceReadPlanner(
                client.geometry.ec_type(3, 2), list(range(5)), scores={p: 1.0 for p in range(5)},
                encoder=client.encoder)
            sizes = {p: striping.part_length(t, p, length) for p in range(5)}
            plan = planner.build_plan([0, 1, 2], 0, 2, sizes)
            assert max(op.wave for op in plan.read_operations) >= 1
            buf = await client.executor.execute_plan(plan, 5, 1, locations, wave_timeout=30.0)
            bps = 2 * MFSBLOCKSIZE
            got = striping.assemble_chunk(
                {p: buf[p * bps : (p + 1) * bps] for p in range(3)}, t, length)
            np.testing.assert_array_equal(got, chunk)

    asyncio.run(run())
