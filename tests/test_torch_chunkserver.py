"""The port's ``ChunkServer`` against the JAX package's, on the CPU.

* Source: ``chunkserver/server.py`` is the JAX package's, its native
  data plane included, but for the card's encoder and the replicator's
  steps; ``chunkserver/__main__.py`` differs only in its encoder default.
* The encoder: without one a server resolves the card's and raises here,
  where there is none. The entry point starts the native data plane under
  ``NATIVE_DATA_PLANE = true`` and under the default, as the JAX
  package's does, and not under ``false``.
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

Every case runs in process on ephemeral localhost ports, byte-exact, on
the asyncio data path of both packages (the native plane is compared in
``tests/test_torch_native_*.py``).
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
from tests.test_torch_master import assert_departs
from tests.test_torch_native_serve import NATIVE_HOST
from tests.test_torch_read_executor import (  # noqa: F401 (autouse fixture)
    ENCODER, PKG, addr, asyncio_port_executor, running, seeded, write_part)


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


@pytest.mark.parametrize("setting,plane", [
    ("NATIVE_DATA_PLANE = true\n", True), ("", True), ("NATIVE_DATA_PLANE = false\n", False),
], ids=["true", "default", "false"])
def test_entry_point_starts_the_native_data_plane(tmp_path, monkeypatch, setting, plane):
    """``main()`` with its loop cut to a start and a stop (against a JAX
    master on an ephemeral port): the listener is up, on its own port,
    exactly when the key says so."""
    cfg = tmp_path / "cs.cfg"
    # a loopback address other than 127.0.0.1, whose abstract listener
    # names a JAX process test scans for (tests/test_torch_native_serve.py)
    cfg.write_text(f"DATA_PATH = {tmp_path / 'data'}\nENCODER = cpu\nLISTEN_HOST = {NATIVE_HOST}\n"
                   f"{setting}")
    seen = {}

    async def start_and_stop(self):
        master = MasterServer(str(tmp_path / "m"), goals=make_goals())
        await master.start()
        self.master_addrs = [("127.0.0.1", master.port)]
        self.master_addr = self.master_addrs[0]
        try:
            await self.start()
            seen["data_port"] = self.data_server.port if self.data_server else None
            seen["port"] = self.port
            await self.stop()
        finally:
            await master.stop()

    monkeypatch.setattr(cs_main.ChunkServer, "run_forever", start_and_stop)
    monkeypatch.setattr("sys.argv", ["chunkserver", str(cfg)])
    cs_main.main()
    if plane:
        assert seen["data_port"] and seen["data_port"] != seen["port"]
    else:
        assert seen["data_port"] is None


def test_server_departs_only_by_its_encoder_and_replicator():
    """The port's ``ChunkServer`` is the JAX package's, its native data
    plane included (the listener's start and stand-down, the stats,
    trace and QoS folds, the native read exchange and the shared-memory
    ring's demux), but for the card's encoder and the replicator's steps
    in ``chunkserver/replicate.py``."""
    removed = [
        'ChunkStore,',
        'from lizardfs_tpu_torch.core import geometry, native_io, plans',
        'from lizardfs_tpu_torch.core.encoder import get_encoder',
        'encoder_name: str | None = "cpu",',
        'self.encoder = get_encoder(encoder_name)',
        "# the auto ladder's mesh-sharded backend when real multichip",
        '# silicon is attached (LZ_SHARDED_RECOVERY=0 kills it), else',
        '# the configured encoder',
        '"""The rebuild compute backend: try the encoder auto-ladder\'s',
        'mesh-sharded wide-stripe decoder (parallel/recovery.py) — it',
        'binds only on a real multi-device mesh with the',
        'LZ_SHARDED_RECOVERY switch open — and degrade to the configured',
        'single-chip encoder everywhere else."""',
        'try:',
        'self._recovery_encoder = get_encoder("sharded")',
        'except Exception:  # no mesh / no silicon / kill switch',
        'self._recovery_encoder = self.encoder',
        'target = geometry.ChunkPartType.from_id(msg.part_id)',
        'slice_type = target.type',
        '# source availability: slice part index -> (addr, wire part id)',
        'locations: dict[int, tuple[tuple[str, int], int]] = {}',
        'for loc in msg.sources:',
        'cpt = geometry.ChunkPartType.from_id(loc.part_id)',
        'if int(cpt.type) == int(slice_type):',
        'locations.setdefault(',
        'cpt.part, ((loc.addr.host, loc.addr.port), loc.part_id)',
        ')',
        'nblocks = geometry.number_of_blocks_in_part(target)',
        'if int(slice_type) == geometry.STANDARD:',
        '# plain copy of the same part (mode 1 of slice_recovery_planner)',
        'if 0 not in locations:',
        'raise ChunkStoreError(st.NO_CHUNK, "no source for copy")',
        'plan = plans.plan_for_standard(nblocks * MFSBLOCKSIZE)',
        'else:',
        'from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS',
        '',
        'planner = plans.SliceReadPlanner(',
        'slice_type, list(locations.keys()),',
        'scores={p: GLOBAL_STATS.score(a)',
        'for p, (a, _) in locations.items()},',
        'encoder=self._replicator_encoder(),',
        ')',
        'if not planner.is_readable([target.part]):',
        'raise ChunkStoreError(st.NO_CHUNK, "not enough source parts")',
        '# per-part geometry lengths: trailing data parts hold one block',
        "# fewer than part 0 when the chunk doesn't stripe evenly",
        'part_sizes = {',
        'p: geometry.number_of_blocks_in_part(',
        'geometry.ChunkPartType(slice_type, p)',
        ')',
        '* MFSBLOCKSIZE',
        'for p in range(slice_type.expected_parts)',
        '}',
        'plan = planner.build_plan([target.part], 0, nblocks, part_sizes)',
        '# starve rebuilds either (ROADMAP 4 both ways)',
        '',
        'def write_part():',
        'if self.store.get(msg.chunk_id, msg.part_id) is None:',
        'self.store.create(msg.chunk_id, msg.version, msg.part_id)',
        'arr = np.asarray(data[: nblocks * MFSBLOCKSIZE])',
        'blocks = arr.reshape(nblocks, MFSBLOCKSIZE)',
        'crcs = self.encoder.checksum(blocks)',
        'for b in range(nblocks):',
        'self.store.write(',
        'msg.chunk_id,',
        'msg.version,',
        'msg.part_id,',
        'b,',
        '0,',
        'blocks[b].tobytes(),',
        'int(crcs[b]),',
        ')',
        '',
        'await asyncio.to_thread(write_part)',
        '# cousin of the PR-8 blackholed-WriteInit fix)',
    ]
    added = [
        '',
        "The port's copy of the JAX package's ``chunkserver/server.py``, with",
        'these differences:',
        "* the encoder is the card's: ``ChunkServer`` takes an ``encoder`` or",
        'an ``encoder_name``, and with neither resolves ``get_encoder()``,',
        'which raises without a card. Tests pass a CPU encoder;',
        "* the replicator's steps are ``chunkserver/replicate.py``'s",
        '``plan_rebuild`` and ``write_rebuilt`` around the network read, and',
        'its recovery encoder falls back to the configured one only on the',
        "sharded encoder's ``MeshUnavailable``.",
        'The native data plane (the C++ listener of ``native_serve``, the native',
        "read exchange and the shared-memory part ring) is the JAX package's, on",
        "the port's build of ``native/`` (``core/native.py``).",
        'from lizardfs_tpu_torch.chunkserver import replicate',
        'from lizardfs_tpu_torch.core import geometry, native_io',
        'from lizardfs_tpu_torch.core.encoder import ChunkEncoder, get_encoder',
        'encoder: ChunkEncoder | None = None,',
        'encoder_name: str | None = None,',
        '# the configured encoder: the one given, else by name, else the',
        "# card's (get_encoder() raises without one)",
        'self.encoder = encoder if encoder is not None else get_encoder(encoder_name)',
        '# the mesh-sharded encoder over two or more cards',
        '# (LZ_SHARDED_RECOVERY=0 kills it), else the configured encoder',
        '"""The rebuild compute backend: the mesh-sharded encoder where',
        'it binds (two or more cards, the LZ_SHARDED_RECOVERY switch',
        "open), else the configured encoder. Only the sharded encoder's",
        'refusal falls back (``replicate.replicator_encoder``)."""',
        'self._recovery_encoder = replicate.replicator_encoder(self.encoder)',
        'if self._recovery_encoder is not self.encoder:',
        '# source availability, the plan (a plain copy for std, else the',
        "# slice planner over the sources' health scores) and the part's",
        "# block count; recovery runs on the replicator's encoder",
        'plan, locations, nblocks = replicate.plan_rebuild(',
        'msg.part_id, msg.sources, self._replicator_encoder()',
        ')',
        '# starve rebuilds either',
        '# the checksum runs on the configured encoder, not the recovery one',
        'await asyncio.to_thread(',
        'replicate.write_rebuilt, self.store, msg.chunk_id, msg.version,',
        'msg.part_id, data, nblocks, self.encoder,',
        ')',
        '# cousin of the bounded WriteInit reply above)',
    ]
    assert_departs("chunkserver/server.py", removed, added)


def test_entry_point_departs_only_by_its_encoder():
    """``NATIVE_DATA_PLANE`` is read as the JAX package reads it, default
    true; only the encoder's default differs."""
    removed = [
        '"""Run a chunkserver: python -m lizardfs_tpu_torch.chunkserver [config]',
        'MASTER_HOST/PORT), LABEL, ENCODER (cpu|cpp|tpu|auto),',
        'encoder_name=cfg.get_str("ENCODER", "cpu"),',
    ]
    added = [
        '"""Run the port\'s chunkserver: python -m lizardfs_tpu_torch.chunkserver [config]',
        'MASTER_HOST/PORT), LABEL, ENCODER (cuda|sharded|auto|cpu; unset is',
        "the card's, ``get_encoder()``, which refuses to start without one),",
        'encoder_name=cfg.get_str("ENCODER", "") or None,',
    ]
    assert_departs("chunkserver/__main__.py", removed, added)


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
                                         encoder=ENCODER, native_data_plane=False)
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
