"""The port's master, chunkservers and client as one cluster, against the
JAX package's, on the CPU.

* Source: the client's helper modules are verbatim copies (the package
  name changed in imports; lines that cite the JAX package's own change
  requests by number are reworded). ``client.py`` is the JAX
  package's, its native data plane included, line for line but for four
  reworded comments (the encoder's default and three that cite change
  requests by number) and its read-path timing
  (``tests/torch_timing_departs.py``).
* Clusters: a port cluster (a port ``MasterServer``, port
  ``ChunkServer``s on ``CudaChunkEncoder(device="cpu")`` and a port
  ``Client`` on the same encoder) runs the scenarios of
  ``tests/test_cluster.py`` beside the JAX package's cluster on the same
  seed: the write/read round trip (std2, ec(3,2), xor3, and ec(3,2) on
  the strictly serial write path), the degraded read after a chunkserver
  stops, the master's health loop rebuilding the lost part, a master
  restart that recovers the metadata, and ec(8,4) on thirteen servers.
  Both give the same read bytes and the same part files by (chunk id,
  part id). A seeded metadata workload gives both masters the same
  replies, changelog and state on a pinned clock.
* Interop: a port client on a JAX master and JAX chunkservers, and a JAX
  client on a port master and port chunkservers.

Both sides run their asyncio data path (``native_data_plane=False`` on
the servers, both clients' native exchange set aside): the native data
plane is compared in ``tests/test_torch_native_*.py``. Every case is in
process on ephemeral localhost ports,
polls with a bound of a few seconds, and closes both packages' connection
pools after its event loop.
"""

import asyncio
import importlib
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from lizardfs_tpu.core import conn_pool as ref_conn_pool
from lizardfs_tpu.core import native_io as ref_native_io
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuChunkEncoder
from lizardfs_tpu_torch.chunkserver.chunk_store import HEADER_SIZE
from lizardfs_tpu_torch.client import client as port_client
from lizardfs_tpu_torch.core import conn_pool, native_io
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder
from lizardfs_tpu_torch.runtime import faults
from tests.test_torch_master import assert_copy, assert_departs

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "lizardfs_tpu", "port": "lizardfs_tpu_torch"}
ENCODER = CudaChunkEncoder(device="cpu")
GOALS = {"std2": 2, "ec32": 10, "xor3": 11, "ec84": 13}
COPIES = ["client/__init__.py", "client/cache.py", "client/io_limit_group.py",
          "client/write_window.py"]
def mod(pkg: str, name: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """A port rebuild recovers a part of the whole-chunk geometry on the
    plain versions; two intra-op threads keep it from crowding the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def asyncio_jax_client(monkeypatch):
    """Both clients' native exchange set aside, so that both run the
    asyncio data path."""
    monkeypatch.setattr(ref_native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_lib", None)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


def test_client_is_the_reference_asyncio_path():
    """The port's client is the JAX package's, the asyncio path and the
    native data plane, but for the encoder default's comment, three
    comments that cite change requests by number and the read-path
    timing that ``renamed`` puts in place."""
    assert_departs("client/client.py", [
        '# default "auto": tpu on real silicon, else the native C++ SIMD',
        "# backend, else numpy — the old hardcoded \"cpu\" default made any",
        "# library user pay the golden path's 3.8x penalty (VERDICT r05",
        "# weak #2); LIZARDFS_TPU_ENCODER still overrides",
        "# adaptive N-deep write window (spends PR 1's phase telemetry):",
        "# LZ_WRITE_WINDOW=0 is the kill switch: the PR-1 double-buffered",
        "# implementation detail below this line (the PR-7 double-count",
    ], [
        "# default: the card's encoder (get_encoder(None): cuda:0, or the",
        "# mesh over two or more cards), which raises without a card;",
        "# callers on the CPU pass an encoder",
        "# adaptive N-deep write window (spends the write phase telemetry):",
        "# LZ_WRITE_WINDOW=0 is the kill switch: the double-buffered",
        "# implementation detail below this line (the double-count",
    ])


def test_client_without_an_encoder_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_client.Client("127.0.0.1", 1)


# --- clusters ---------------------------------------------------------------------


def make_goals(pkg: str):
    geometry = mod(pkg, "core.geometry")
    goals = geometry.default_goals()
    for line in ("10 ectest : $ec(3,2)", "11 xortest : $xor3", "13 fast : $ec(8,4)"):
        gid, goal = geometry.parse_goal_line(line)
        goals[gid] = goal
    return goals


class Cluster:
    """A master, chunkservers and clients, each of the package named."""

    def __init__(self, root: Path, master="port", servers="port", client="port", n_cs=6,
                 native_data_plane=False, cs_host="127.0.0.1"):
        self.root, self.pkgs, self.n_cs = root, (master, servers, client), n_cs
        self.native_data_plane, self.cs_host = native_data_plane, cs_host
        self.master = None
        self.chunkservers = []
        self.clients = []

    async def start(self, health_interval=0.2):
        master_pkg, cs_pkg, _ = self.pkgs
        self.master = mod(master_pkg, "master.server").MasterServer(
            str(self.root / "master"), goals=make_goals(master_pkg),
            health_interval=health_interval)
        await self.master.start()
        for i in range(self.n_cs):
            await self.add_chunkserver(self.root / f"cs{i}")

    async def add_chunkserver(self, folder, master_port=None):
        cs_pkg = self.pkgs[1]
        kw = ({"encoder": ENCODER} if cs_pkg == "port" else {"encoder_name": "cpu"})
        cs = mod(cs_pkg, "chunkserver.server").ChunkServer(
            str(folder), master_addr=("127.0.0.1", master_port or self.master.port),
            host=self.cs_host, wave_timeout=0.2, native_data_plane=self.native_data_plane, **kw)
        await cs.start()
        self.chunkservers.append(cs)
        return cs

    async def client(self):
        pkg = self.pkgs[2]
        c = mod(pkg, "client.client").Client(
            "127.0.0.1", self.master.port, wave_timeout=0.2,
            encoder=ENCODER if pkg == "port" else RefCpuChunkEncoder())
        await c.connect()
        self.clients.append(c)
        return c

    def holder(self, cs_id: int):
        """The running chunkserver the master knows as ``cs_id``."""
        port = self.master.meta.registry.servers[cs_id].port
        return next(cs for cs in self.chunkservers if cs.port == port)

    async def stop_server(self, cs):
        await cs.stop()
        self.chunkservers.remove(cs)

    async def stop_data_holder(self, inode: int, data_parts: int) -> int:
        """Stop the server that holds the lowest data part of the file's
        first chunk, unless a stopped server holds one already; returns
        the count of that chunk's parts."""
        registry = self.master.meta.registry
        chunk = registry.chunks[self.master.meta.fs.nodes[inode].chunks[0]]
        holders = [cs for cs, p in sorted(chunk.parts) if p < data_parts]
        live = {cs.port for cs in self.chunkservers}
        if all(registry.servers[cs].port in live for cs in holders):
            await self.stop_server(self.holder(holders[0]))
        return len(chunk.parts)

    def parts(self) -> dict[tuple[int, int], bytes]:
        """Every live server's part files by (chunk id, part id); copies
        of one part must be identical."""
        out = {}
        for cs in self.chunkservers:
            for cf in cs.store.all_parts():
                data = Path(cf.path).read_bytes()
                assert out.setdefault((cf.chunk_id, cf.part_id), data) == data
        return out

    def live_parts(self) -> dict[tuple[int, int], bytes]:
        """The part files of the chunks the master still holds (a
        deleted chunk's files leave the servers in the background)."""
        return {k: v for k, v in self.parts().items() if k[0] in self.master.meta.registry.chunks}

    async def stop(self):
        for c in self.clients:
            await c.close()
        for cs in self.chunkservers:
            await cs.stop()
        if self.master is not None:
            await self.master.stop()


def run(coro):
    """Run one scenario's event loop; close both packages' pools after it."""
    try:
        return asyncio.run(coro)
    finally:
        conn_pool.GLOBAL_POOL.close_all()
        ref_conn_pool.GLOBAL_POOL.close_all()


async def wait_for(cond, what: str, timeout: float = 5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


def payload(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


async def write_file(cluster, name, goal, data):
    c = await cluster.client()
    f = await c.create(1, name)
    await c.setgoal(f.inode, goal)
    await c.write_file(f.inode, data)
    assert (await c.getattr(f.inode)).length == len(data)
    return c, f.inode


def pkgs_of(kind: str) -> dict:
    return {"port": dict(master="port", servers="port", client="port"),
            "jax": dict(master="jax", servers="jax", client="jax"),
            "port-client": dict(master="jax", servers="jax", client="port"),
            "jax-client": dict(master="port", servers="port", client="jax")}[kind]


ROUNDTRIPS = {  # goal, size, serial write path
    "std2": ("std2", 300_000, False),
    "ec32": ("ec32", 5 * 65536 + 777, False),
    "xor3": ("xor3", 4 * 65536 + 1, False),
    "ec32-serial": ("ec32", 5 * 65536 + 777, True),
}


def _roundtrip(root, kind, case):
    goal, size, serial = ROUNDTRIPS[case]
    data = payload(size, size)

    async def go():
        cluster = Cluster(root / kind, **pkgs_of(kind))
        await cluster.start()
        try:
            c = await cluster.client()
            c.write_pipeline = not serial
            f = await c.create(1, "data.bin")
            await c.setgoal(f.inode, GOALS[goal])
            await c.write_file(f.inode, data)
            reads = [await c.read_file(f.inode), await c.read_file(f.inode, offset=65530, size=20)]
            return reads, cluster.parts()
        finally:
            await cluster.stop()

    return run(go())


@pytest.mark.parametrize("case", sorted(ROUNDTRIPS))
def test_roundtrip_matches_reference(tmp_path, case):
    port_reads, port_parts = _roundtrip(tmp_path, "port", case)
    ref_reads, ref_parts = _roundtrip(tmp_path, "jax", case)
    size = ROUNDTRIPS[case][1]
    data = payload(size, size)
    assert port_reads == ref_reads == [data, data[65530:65550]]
    assert port_parts == ref_parts and port_parts


def _degraded(root, kind, goal="ec32", size=7 * 65536 + 4242, n_cs=6, data_parts=3):
    """Write, stop a holder of a data part of chunk 0, read through
    recovery. The master's health loop is held off (no rebuild)."""
    data = payload(7, size)

    async def go():
        cluster = Cluster(root / kind, n_cs=n_cs, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        try:
            c, inode = await write_file(cluster, "ec.bin", GOALS[goal], data)
            parts = cluster.parts()
            chunk = cluster.master.meta.registry.chunks[min(cluster.master.meta.registry.chunks)]
            victim = cluster.holder(next(cs for cs, p in sorted(chunk.parts) if p < data_parts))
            await cluster.stop_server(victim)
            c.cache.invalidate(inode)
            return await c.read_file(inode), parts
        finally:
            await cluster.stop()

    return run(go())


@pytest.mark.parametrize("kind", ["port", "port-client", "jax-client"])
def test_degraded_read_matches_reference(tmp_path, kind):
    got, parts = _degraded(tmp_path, kind)
    ref, ref_parts = _degraded(tmp_path, "jax")
    assert got == ref == payload(7, 7 * 65536 + 4242)
    assert parts == ref_parts


def test_wide_ec_on_thirteen_servers_matches_reference(tmp_path):
    """The shipped ec(8,4) goal: twelve parts on thirteen servers, a data
    part's holder stopped, the read recovered."""
    size = 9 * 65536 + 123
    got, parts = _degraded(tmp_path, "port", "ec84", size, n_cs=13, data_parts=8)
    ref, ref_parts = _degraded(tmp_path, "jax", "ec84", size, n_cs=13, data_parts=8)
    assert got == ref == payload(7, size)
    assert parts == ref_parts and len(parts) == 12


def _rebuild(root, kind):
    """Write ec(3,2), stop the holder of the lowest (server, part) pair,
    let the master's health loop rebuild the part onto a spare, read."""
    data = payload(11, 3 * 65536)

    async def go():
        cluster = Cluster(root / kind, **pkgs_of(kind))
        await cluster.start(health_interval=0.2)
        try:
            c, inode = await write_file(cluster, "heal.bin", GOALS["ec32"], data)
            registry = cluster.master.meta.registry
            chunk = next(iter(registry.chunks.values()))
            assert len(chunk.parts) == 5
            before = cluster.parts()
            victim_cs, victim_part = sorted(chunk.parts)[0]
            await cluster.stop_server(cluster.holder(victim_cs))
            await wait_for(lambda: not registry.servers[victim_cs].connected,
                           "the master to see the server go")
            # the rebuild recovers a whole-chunk-geometry part on the CPU
            # (2-4 s in either package); the bound leaves room for a
            # loaded host
            await wait_for(lambda: not registry.evaluate(chunk).missing_parts,
                           "the health loop's rebuild", timeout=20.0)
            c.cache.invalidate(inode)
            back = await c.read_file(inode)
            return back, before, cluster.parts(), victim_part
        finally:
            await cluster.stop()

    return run(go())


@pytest.mark.parametrize("kind", ["port", "jax-client"])
def test_health_loop_rebuild_matches_reference(tmp_path, kind):
    back, before, after, lost = _rebuild(tmp_path, kind)
    ref_back, ref_before, ref_after, ref_lost = _rebuild(tmp_path, "jax")
    assert back == ref_back == payload(11, 3 * 65536)
    assert before == ref_before
    # the rebuilt part's file, CRC slots and version included, is the one
    # the JAX package's rebuild writes
    assert after == ref_after and lost == ref_lost
    key = next(k for k in before if mod("port", "core.geometry").ChunkPartType.from_id(k[1]).part == lost)
    data = before[key][HEADER_SIZE:]
    assert after[key][HEADER_SIZE:].rstrip(b"\0") == data.rstrip(b"\0")


def _restart(root, kind):
    async def go():
        cluster = Cluster(root / kind, n_cs=3, **pkgs_of(kind))
        await cluster.start()
        try:
            c = await cluster.client()
            d = await c.mkdir(1, "persist")
            f = await c.create(d.inode, "f.bin")
            await c.write_file(f.inode, b"x" * 100_000)
            inode = f.inode
        finally:
            await cluster.stop()
        # a new master on the same data folder (a new port); new
        # chunkservers on the old folders register their parts again
        again = Cluster(root / kind, n_cs=0, **pkgs_of(kind))
        await again.start()
        try:
            for i in range(3):
                await again.add_chunkserver(root / kind / f"cs{i}")
            c2 = await again.client()
            d2 = await c2.lookup(1, "persist")
            f2 = await c2.lookup(d2.inode, "f.bin")
            assert (f2.inode, f2.length) == (inode, 100_000)
            return await c2.read_file(f2.inode), again.master.meta.checksum()
        finally:
            await again.stop()

    return run(go())


def test_master_restart_matches_reference(tmp_path, monkeypatch):
    """On a pinned clock (the image holds the nodes' times), both
    packages' restarted masters hold the same metadata."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    back, checksum = _restart(tmp_path, "port")
    ref_back, ref_checksum = _restart(tmp_path, "jax")
    assert back == ref_back == b"x" * 100_000
    assert checksum == ref_checksum


# --- the master's replies on a seeded metadata workload -----------------------------


def _fields(x):
    if hasattr(x, "FIELDS"):
        return {name: _fields(getattr(x, name)) for name, _ in x.FIELDS}
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    return x


def _workload(root, kind, seed):
    """A seeded sequence of metadata calls through one client, each
    reply (or refusal) recorded; returns the replies, the changelog and
    the master's state."""
    rng = np.random.default_rng(seed)
    st = mod(pkgs_of(kind)["client"], "proto.status")

    async def go():
        cluster = Cluster(root / kind, n_cs=1, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        out = []

        async def call(name, *args, **kw):
            try:
                out.append((name, _fields(await getattr(c, name)(*args, **kw))))
            except st.StatusError as e:
                out.append((name, "status", e.code))

        try:
            c = await cluster.client()
            dirs, files = [1], []
            for i in range(40):
                pick = int(rng.integers(10))
                parent = dirs[int(rng.integers(len(dirs)))]
                name = f"e{int(rng.integers(6))}"
                if pick < 2:
                    await call("mkdir", parent, name, mode=int(rng.choice([0o755, 0o700])))
                    if out[-1][1] != "status":
                        dirs.append(out[-1][1]["inode"])
                elif pick < 4:
                    await call("create", parent, name, uid=int(rng.choice([0, 1000])))
                    if out[-1][1] != "status":
                        files.append(out[-1][1]["inode"])
                elif pick == 4 and files:
                    inode = files[int(rng.integers(len(files)))]
                    await call("write_file", inode, payload(i, int(rng.integers(1, 70_000))))
                    await call("read_file", inode)
                elif pick == 5 and files:
                    await call("link", files[int(rng.integers(len(files)))], parent, name)
                elif pick == 6:
                    await call("rename", parent, name, dirs[int(rng.integers(len(dirs)))], f"r{i}")
                elif pick == 7:
                    await call("unlink", parent, name)
                elif pick == 8 and files:
                    inode = files[int(rng.integers(len(files)))]
                    await call("set_xattr", inode, "user.k", payload(i, 5))
                    await call("set_acl", inode, {"users": {"1000": 6}, "groups": {}, "mask": 6})
                    await call("set_quota", "user", 1000, hard_inodes=int(rng.integers(2, 9)))
                    await call("posix_lock", inode, 0, 100, 2, token=1)
                    await call("test_lock", inode, 50, 60, 1, token=2)
                elif files:
                    inode = files[int(rng.integers(len(files)))]
                    await call("truncate", inode, int(rng.integers(0, 100_000)))
                    await call("setgoal", inode, int(rng.choice([1, 2, 10])))
                await call("readdir", parent)
            await call("trash_list")
            await call("get_quota")
            log = (root / kind / "master" / "changelog.0.log").read_text()
            return out, log, cluster.master.meta.to_sections()
        finally:
            await cluster.stop()

    return run(go())


@pytest.mark.parametrize("seed", [1, 2])
def test_master_replies_match_reference(tmp_path, monkeypatch, seed):
    """On a pinned clock, the port's master gives a port client the same
    replies, writes the same changelog and holds the same state as the
    JAX package's master gives a JAX client."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)
    port = _workload(tmp_path, "port", seed)
    ref = _workload(tmp_path, "jax", seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1] and port[1].count("\n") > 20
    assert port[2] == ref[2]


def test_faults_reach_only_the_port_client(tmp_path):
    """A dial fault armed in the port's rule set (once) leaves a JAX
    client's write alone and fails a port client's first part dial, which
    the port client's retry then gets past: the packages keep their own
    rules."""
    data = payload(3, 100_000)

    async def go():
        cluster = Cluster(tmp_path / "mixed", n_cs=2, **pkgs_of("jax-client"))
        await cluster.start(health_interval=30.0)
        try:
            faults.arm("client:dial:cs error,limit=1")
            jax_client, inode = await write_file(cluster, "a.bin", 1, data)
            assert await jax_client.read_file(inode) == data
            assert faults.fired_total() == 0
            cluster.pkgs = ("port", "port", "port")
            port, inode = await write_file(cluster, "b.bin", 1, data)
            assert faults.fired_total() == 1
            assert await port.read_file(inode) == data
        finally:
            faults.clear()
            await cluster.stop()

    run(go())
