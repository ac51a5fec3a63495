"""The port's ``ChunkServer`` against the JAX package's, on the CPU.

* The encoder: without one a server resolves the card's and raises here,
  where there is none; the entry point refuses a native data plane.
* Rebuild: ``_cmd_replicate`` on a port server and on a JAX server, over
  the same source servers (of both packages, written over the wire),
  write byte-identical part files, CRC slots included, holding the lost
  part's bytes: an ec(4,2) data part, an xor3 parity part, a std copy.
* Guards: a corrupt source piece surfaces ``ReadError(crc=True)`` through
  either package's executor from either package's server, and a
  ``serve_read`` fault armed in the port's rule set reaches only the
  port's server.
* The master link: a port server registers with the JAX package's
  master, which lists it and the part it reported.

Every case runs in process on ephemeral localhost ports, byte-exact.
"""

import asyncio

import numpy as np
import pytest
import torch

from lizardfs_tpu.master.server import MasterServer
from lizardfs_tpu_torch.chunkserver import __main__ as cs_main
from lizardfs_tpu_torch.chunkserver import server as port_server
from lizardfs_tpu_torch.chunkserver.chunk_store import HEADER_SIZE, SIGNATURE_SIZE
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder
from lizardfs_tpu_torch.ops import crc32
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.runtime import faults
from lizardfs_tpu_torch.utils import striping
from tests.test_cluster import make_goals
from tests.test_torch_read_executor import ENCODER, PKG, addr, running, seeded, write_part


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """A rebuild recovers whole parts of the 1024-block geometry on the
    plain versions; two intra-op threads keep that from crowding the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_server_without_an_encoder_needs_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_server.ChunkServer(str(tmp_path / "a"), master_addr=None)
    cs = port_server.ChunkServer(str(tmp_path / "b"), master_addr=None, encoder_name="cpu")
    assert isinstance(cs.encoder, CpuChunkEncoder)


def test_entry_point_refuses_a_native_data_plane(tmp_path, monkeypatch):
    cfg = tmp_path / "cs.cfg"
    cfg.write_text(f"DATA_PATH = {tmp_path / 'data'}\nNATIVE_DATA_PLANE = true\n")
    monkeypatch.setattr("sys.argv", ["chunkserver", str(cfg)])
    with pytest.raises(SystemExit, match="NATIVE_DATA_PLANE"):
        cs_main.main()


REBUILDS = {  # slice type, lost part
    "ec(4,2)-data": (geometry.ec_type(4, 2), 1),
    "xor3-parity": (geometry.xor_type(3), 0),
    "std-copy": (geometry.SliceType(geometry.STANDARD), 0),
}


@pytest.mark.parametrize("case", sorted(REBUILDS))
def test_replicate_matches_reference(tmp_path, case):
    t, lost = REBUILDS[case]
    length = 7 * MFSBLOCKSIZE + 12345  # trailing parts short and zero-padded
    chunk = seeded(length, 4)
    parts = striping.split_chunk(chunk, t, ENCODER)
    lost_id = geometry.ChunkPartType(t, lost).id
    holders = [p for p in sorted(parts) if p != lost] if not t.is_standard else [0]
    # sources alternate between the packages; the last two servers rebuild
    pkgs = ["port" if i % 2 == 0 else "jax" for i in range(len(holders))] + ["port", "jax"]

    async def run():
        async with running(pkgs, tmp_path) as servers:
            sources = []
            for cs, p in zip(servers, holders):
                pid = geometry.ChunkPartType(t, p).id
                await write_part("port", cs, 9, 2, pid, parts[p][: striping.part_length(t, p, length)])
                sources.append(m.PartLocation(addr=m.Addr(host="127.0.0.1", port=cs.port),
                                              part_id=pid))
            files = []
            for target in servers[-2:]:
                mm = PKG["port" if isinstance(target, port_server.ChunkServer) else "jax"].m
                msg = mm.MatocsReplicate(
                    req_id=1, chunk_id=9, version=2, part_id=lost_id,
                    sources=[mm.PartLocation(addr=mm.Addr(host=s.addr.host, port=s.addr.port),
                                             part_id=s.part_id) for s in sources],
                )
                await target._cmd_replicate(msg)
                cf = target.store.get(9, lost_id)
                assert cf is not None and target.store.test_part(cf), type(target).__module__
                with open(cf.path, "rb") as f:
                    files.append(f.read())
            port_cs = servers[-2]
            assert port_cs._replicator_encoder() is port_cs.encoder  # no mesh here
            assert port_cs.metrics.counter("replications").total == 1
            return files

    port_file, ref_file = asyncio.run(run())
    assert port_file == ref_file
    nblocks = geometry.number_of_blocks_in_part(geometry.ChunkPartType.from_id(lost_id))
    want = np.zeros(nblocks * MFSBLOCKSIZE, np.uint8)
    real = parts[lost][: striping.part_length(t, lost, length)]
    want[: len(real)] = real
    assert port_file[HEADER_SIZE:] == want.tobytes()
    slots = np.frombuffer(port_file[SIGNATURE_SIZE : SIGNATURE_SIZE + 4 * nblocks], ">u4")
    np.testing.assert_array_equal(slots, crc32.block_crcs_golden(want.reshape(nblocks, -1)))


@pytest.mark.parametrize("servers,client", [
    ("port", "port"), ("port", "jax"), ("jax", "port"), ("jax", "jax"),
])
def test_corrupt_source_piece_is_a_crc_read_error(tmp_path, servers, client):
    part = geometry.ChunkPartType(geometry.ec_type(3, 2), 2).id
    data = seeded(2 * MFSBLOCKSIZE, 5)

    async def run():
        async with running([servers], tmp_path) as (cs,):
            await write_part(client, cs, 3, 1, part, data)
            with open(cs.store.get(3, part).path, "r+b") as f:
                f.seek(HEADER_SIZE + MFSBLOCKSIZE + 99)  # a byte of block 1
                f.write(bytes([data[MFSBLOCKSIZE + 99] ^ 0xFF]))
            executor = PKG[client].executor
            with pytest.raises(executor.ReadError) as err:
                await executor.read_part_range(addr(cs), 3, 1, part, 0, len(data))
            assert err.value.crc
            ok = await executor.read_part_range(addr(cs), 3, 1, part, 0, MFSBLOCKSIZE)
            np.testing.assert_array_equal(ok, data[:MFSBLOCKSIZE])

    asyncio.run(run())


def test_serve_read_fault_reaches_only_the_port_server(tmp_path):
    part = geometry.ChunkPartType(geometry.ec_type(3, 2), 0).id
    data = seeded(MFSBLOCKSIZE, 6)

    async def run():
        async with running(["port", "jax"], tmp_path) as servers:
            for cs in servers:
                await write_part("port", cs, 4, 1, part, data)
            faults.arm("chunkserver:serve_read error")
            try:
                for reader in ("port", "jax"):
                    executor = PKG[reader].executor
                    # the port server drops the connection at the fault
                    with pytest.raises(asyncio.IncompleteReadError):
                        await executor.read_part_range(addr(servers[0]), 4, 1, part, 0, len(data))
                    got = await executor.read_part_range(addr(servers[1]), 4, 1, part, 0, len(data))
                    np.testing.assert_array_equal(got, data)
                assert faults.fired_total() == 2
            finally:
                faults.clear()

    asyncio.run(run())


def test_registers_with_the_reference_master(tmp_path):
    """A port chunkserver holding one std part registers with the JAX
    package's master, which lists the server and the part."""
    std = geometry.SliceType(geometry.STANDARD)
    pid = geometry.ChunkPartType(std, 0).id
    block = seeded(MFSBLOCKSIZE, 7).tobytes()

    async def run():
        master = MasterServer(str(tmp_path / "m"), goals=make_goals())
        await master.start()
        cs = None
        try:
            chunk = master.meta.registry.create_chunk(int(std), version=3)
            cs = port_server.ChunkServer(str(tmp_path / "cs"), master_addr=("127.0.0.1", master.port),
                                         encoder=ENCODER)
            cs.store.create(chunk.chunk_id, 3, pid)
            cs.store.write(chunk.chunk_id, 3, pid, 0, 0, block, crc32.crc32(block))
            await cs.start()
            srv = master.meta.registry.servers[cs.cs_id]
            assert (srv.host, srv.port) == ("127.0.0.1", cs.port)
            assert master.meta.registry.chunks[chunk.chunk_id].parts == {(cs.cs_id, 0)}
        finally:
            if cs is not None:
                await cs.stop()
            await master.stop()

    asyncio.run(run())
