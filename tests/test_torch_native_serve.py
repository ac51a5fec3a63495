"""The port's native data plane against the JAX package's, on the CPU.

* Source: ``core/native_io.py`` and ``chunkserver/native_serve.py`` are
  copies (the package name changed in imports); ``native_io`` departs by
  its timed hop, ``Hop`` (``tests/torch_timing_departs.py``).
  ``client/native_client.py`` and ``nfs/cnfs.py`` differ only in the
  library they load, the port's build of the C client. ``core/native.py``
  keeps the JAX package's stripe helpers line for line (its CPU codec is
  held to the JAX package's in ``tests/test_torch_cpp_encoder.py``), and
  builds the two libraries of ``native/Makefile`` into ``ops/build/`` at
  first use: never into ``native/``, once under a file lock, and a failed
  build raises with the compiler's message.
* The listener: the cases of ``tests/test_native_serve.py`` on port
  chunkservers, driven by the port's client and by the JAX package's: the
  asyncio server's bulk read answering a native read exchange, a sparse
  tail, a corrupt replica, a read pipelined behind unacknowledged writes,
  a truncated part header and the per-session QoS budget.
* Mixed clusters: an ec(3,2) file through the windowed stripe pipeline
  (eight segments, each its own ``encode_into``), an ec(3,2) file through
  the one-call parts scatter, a std goal-2 copy down a write chain and an
  xor3 file, written and read back whole (the ec file also through the
  whole-stripe native gather) and, with a data-part holder stopped,
  degraded. Port client on port native chunkservers, port client on JAX
  native chunkservers and JAX client on port native chunkservers each
  give the bytes written and the same part files, CRC slots included, by
  (chunk id, part id), as the port's asyncio plane; the listeners carried
  the bytes both ways.
* Stand-down: with a fault rule armed, the chunkserver starts no listener
  and the client takes none of its native exchanges.

The JAX package's native modules bind their library when they are
imported: its own ``make -C native`` build where that existed then. Where
it did not, each test of the port's native files lends them the port's
build of the same sources, and takes it back with every encoder the JAX
package's ``get_encoder`` built meanwhile, so no JAX test runs on the
port's build. Native chunkservers listen on
``NATIVE_HOST``; every case runs in process on ephemeral ports, polls
with bounds of a few seconds and stops every listener, and each native
module's file shuts both packages' native-IO thread pools down when it
ends.
"""

import asyncio
import contextlib
import inspect
import os
import re
import stat
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from lizardfs_tpu.chunkserver import native_serve as ref_native_serve
from lizardfs_tpu.client import native_client as ref_native_client
from lizardfs_tpu.core import encoder as ref_encoder
from lizardfs_tpu.core import native as ref_native
from lizardfs_tpu.core import native_io as ref_native_io
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuChunkEncoder
from lizardfs_tpu_torch.chunkserver import native_serve
from lizardfs_tpu_torch.chunkserver import server as port_server
from lizardfs_tpu_torch.chunkserver.chunk_store import HEADER_SIZE
from lizardfs_tpu_torch.client import native_client
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import native, native_io
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder
from lizardfs_tpu_torch.ops import crc32
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from tests.test_torch_client import (  # noqa: F401 (autouse fixture)
    GOALS, ROOT, Cluster, payload, run, two_threads)
from tests.test_torch_master import assert_copy, assert_departs, mod

MiB = 1 << 20


@pytest.fixture(autouse=True)
def jax_native_library(monkeypatch):
    """The JAX package's native modules on a library, for this test: its
    own build where one was loaded at import, else the port's build of the
    same sources. The JAX package's encoder registry is the test's own
    copy, so a ``CppChunkEncoder`` built on the lent library goes with it."""
    for ref, port in ((ref_native_io, native_io), (ref_native_serve, native_serve),
                      (ref_native, native), (ref_native_client, native_client)):
        if ref._lib is None:
            monkeypatch.setattr(ref, "_lib", port._lib)
    monkeypatch.setattr(ref_encoder, "_ENCODERS", dict(ref_encoder._ENCODERS))


# The native listener also binds an abstract unix name after the host it
# advertises, ``@lzfs-data-<host>-<port>``, and the JAX package's process
# tests take the first such name at 127.0.0.1 that appears on the host.
# So native chunkservers here listen on another loopback address. Not
# ``LZ_NO_UDS``: the C side reads it once a process, in a switch both
# packages' libraries share, so setting it in one test would turn the
# unix socket off for every later test in the worker.
NATIVE_HOST = "127.0.0.2"


@pytest.fixture(autouse=True, scope="module")
def native_threads_released():
    """Both packages' native-IO thread pools, which a native chunkserver
    or client fills up front (48 threads each), are shut down after the
    module and replaced by fresh pools that start their threads lazily:
    a worker that runs a later file keeps no idle threads from here (a
    sampling profiler's cost per sample grows with the threads it walks)."""
    yield
    for io in (native_io, ref_native_io):
        for name in ("EXECUTOR", "SERVE_EXECUTOR"):
            old = getattr(io, name)
            setattr(io, name, ThreadPoolExecutor(max_workers=old._max_workers,
                                                 thread_name_prefix=old._thread_name_prefix))
            old.shutdown(wait=True)
        io._prestarted = False


def close_native_pools() -> None:
    """Drop both packages' pooled blocking data sockets (their servers
    are gone once a scenario's loop ends)."""
    for io in (native_io, ref_native_io):
        for pool in (io.POOL, io.RING_POOL):
            with pool._lock:
                idle = [s for bucket in pool._idle.values() for s in bucket]
                pool._idle.clear()
            for sock in idle:
                pool.discard(sock)


def run_native(coro):
    try:
        return run(coro)
    finally:
        close_native_pools()


async def settled(read, done, timeout: float = 5.0):
    """``read()`` once ``done`` holds of it, polled for up to ``timeout``
    seconds: a listener counts an op after its last send, so a client can
    hold every byte before the count moves."""
    deadline = time.monotonic() + timeout
    value = read()
    while not done(value) and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
        value = read()
    return value


# --- the sources ------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["core/native_io.py", "chunkserver/native_serve.py"])
def test_native_module_is_a_copy(rel):
    assert_copy(rel)


def test_read_pool_departs_only_by_its_library():
    assert_departs("client/native_client.py", [
        "_LIB_PATH = os.path.join(",
        "os.path.dirname(os.path.dirname(os.path.dirname(__file__))),",
        '"native", "liblizardfs_client.so",',
        ")",
    ], [
        "from lizardfs_tpu_torch.core import native",
        "",
        "# the port's build of the C client (core/native.py), built at first use",
        "_LIB_PATH = str(native.build(native.CLIENT))",
    ])


def test_c_nfs_client_departs_only_by_its_library():
    assert_departs("nfs/cnfs.py", [
        "# so the C NFS client runs instrumented under the real Python gateway",
        '_LIB_PATH = os.environ.get("LZ_CLIENT_SO") or os.path.join(',
        "os.path.dirname(os.path.dirname(os.path.dirname(__file__))),",
        '"native", "liblizardfs_client.so",',
        ")",
    ], [
        "from lizardfs_tpu_torch.core import native",
        "",
        "# so the C NFS client runs instrumented under the real Python gateway;",
        "# else the port's build of the C client (core/native.py)",
        '_LIB_PATH = os.environ.get("LZ_CLIENT_SO") or str(native.build(native.CLIENT))',
    ])


@pytest.mark.parametrize("name", [
    "available", "_ptr_array", "stripe_helpers_available", "stripe_scatter", "stripe_gather"])
def test_loader_keeps_the_stripe_helpers(name):
    want = inspect.getsource(getattr(ref_native, name))
    assert inspect.getsource(getattr(native, name)) == want


def test_loader_leaves_out_the_cpu_codec(monkeypatch):
    """The loader carries the CPU codec, but the encoder registry's auto
    ladder leaves it out: without a card it raises, where the JAX
    package's ladder lands on the codec."""
    for name in ("CppChunkEncoder", "apply_matrix", "crc32", "crc32_blocks", "ENCODE_THREADS"):
        assert hasattr(ref_native, name) and hasattr(native, name), name
    from lizardfs_tpu_torch.core import encoder as port_encoder

    monkeypatch.setattr(port_encoder, "_ENCODERS", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_encoder.get_encoder("auto")
    assert port_encoder.get_encoder("cpp").name == "cpp"


def test_libraries_come_from_the_build_directory():
    """Every library the port loaded is its own build, named by the hash
    of its sources, under ``ops/build/``; none is a ``native/*.so``."""
    build = ROOT / "lizardfs_tpu_torch" / "ops" / "build"
    assert native.BUILD_DIR == build and native.NATIVE_DIR == ROOT / "native"
    want = {native.DATA_PLANE: native.library_path(native.DATA_PLANE),
            native.CLIENT: native.library_path(native.CLIENT)}
    for name, path in want.items():
        assert path.parent == build and re.fullmatch(rf"{name}_[0-9a-f]{{16}}\.so", path.name)
        assert path.exists()
    if not os.environ.get("LZ_NATIVE_SO"):
        for lib in (native._lib, native_io._lib, native_serve._lib):
            assert Path(lib._name) == want[native.DATA_PLANE]
    assert Path(native_client._LIB_PATH) == want[native.CLIENT]
    assert want[native.DATA_PLANE] != want[native.CLIENT]


def fake_compiler(tmp_path, body: str) -> Path:
    """A stand-in for g++ that logs its arguments and runs ``body``."""
    log = tmp_path / "cxx.log"
    script = tmp_path / "cxx"
    script.write_text(f'#!/bin/sh\necho "$@" >> {log}\n{body}\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


def test_concurrent_builds_build_once(tmp_path, monkeypatch):
    """Two threads that build together compile each source and link once
    (the second waits on the file lock and finds the library)."""
    cxx = fake_compiler(tmp_path, (
        "sleep 0.3\n"
        'while [ $# -gt 0 ]; do if [ "$1" = "-o" ]; then shift; : > "$1"; fi; shift; done'))
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build(native.CLIENT)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    out = native.library_path(native.CLIENT)
    assert paths == [out, out] and out.exists()
    calls = (tmp_path / "cxx.log").read_text().splitlines()
    assert len(calls) == len(native.SOURCES[native.CLIENT]) + 1, calls
    assert sorted(p.name for p in out.parent.iterdir()) == sorted([out.name, f"{native.CLIENT}.lock"])
    assert native.build(native.CLIENT) == out  # built: no compiler call
    assert len((tmp_path / "cxx.log").read_text().splitlines()) == len(calls)


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    cxx = fake_compiler(tmp_path, 'echo "serve_native.cpp:1: error: no such thing" >&2\nexit 1')
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed(.|\n)*error: no such thing"):
        native.build(native.DATA_PLANE)
    assert not native.library_path(native.DATA_PLANE).exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [f"{native.DATA_PLANE}.lock"]


# --- the listener -----------------------------------------------------------------


def port_cluster(tmp_path, client="port", n_cs=1, native_data_plane=True):
    return Cluster(tmp_path, master="port", servers="port", client=client, n_cs=n_cs,
                   native_data_plane=native_data_plane, cs_host=NATIVE_HOST)


CLIENTS = ["port", "jax"]


@pytest.mark.parametrize("client", CLIENTS)
def test_asyncio_bulk_read_answers_the_native_exchange(tmp_path, monkeypatch, client):
    """With the listener off, a client's native read exchange is served
    by the asyncio server's bulk path, byte-identical."""
    calls = []
    real = port_server.ChunkServer._serve_read_bulk

    async def spy(self, writer, msg):
        calls.append(msg)
        return await real(self, writer, msg)

    monkeypatch.setattr(port_server.ChunkServer, "_serve_read_bulk", spy)

    async def scenario():
        cluster = port_cluster(tmp_path, client, n_cs=2, native_data_plane=False)
        await cluster.start()
        try:
            c = await cluster.client()
            data = payload(1, MiB)
            f = await c.create(1, "big")
            await c.write_file(f.inode, data)
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
            assert all(cs.data_server is None for cs in cluster.chunkservers)
        finally:
            await cluster.stop()

    run_native(scenario())
    assert calls, "the asyncio bulk read never served"


@pytest.mark.parametrize("client", CLIENTS)
def test_native_serve_sparse_tail(tmp_path, client):
    """Reads past stored data come back as zeros (sparse semantics)."""

    async def scenario():
        cluster = port_cluster(tmp_path, client)
        await cluster.start()
        try:
            assert cluster.chunkservers[0].data_server is not None
            c = await cluster.client()
            f = await c.create(1, "sparse")
            await c.write_file(f.inode, b"\xaa" * 1000)
            await c.truncate(f.inode, 900 * 1024)
            got = await c.read_file(f.inode)
            assert got[:1000] == b"\xaa" * 1000
            assert got[1000:] == b"\0" * (900 * 1024 - 1000)
            served = await settled(lambda: cluster.chunkservers[0].data_server.stats()["bytes_read"],
                                   lambda n: n > 0)
            assert served > 0
        finally:
            await cluster.stop()

    run_native(scenario())


@pytest.mark.parametrize("client", CLIENTS)
def test_native_serve_detects_corruption(tmp_path, client):
    """Bit rot on one replica: the listener's CRC check rejects it and the
    client reads the healthy copy."""

    async def scenario():
        cluster = port_cluster(tmp_path, client, n_cs=2)
        await cluster.start()
        try:
            c = await cluster.client()
            data = payload(2, 512 * 1024)
            f = await c.create(1, "rotten")
            await c.setgoal(f.inode, GOALS["std2"])
            await c.write_file(f.inode, data)
            parts = list(cluster.chunkservers[0].store.all_parts())
            assert parts
            for cf in parts:
                with open(cf.path, "r+b") as fh:
                    fh.seek(HEADER_SIZE + 100)
                    b = fh.read(1)
                    fh.seek(HEADER_SIZE + 100)
                    fh.write(bytes([b[0] ^ 0xFF]))
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
        finally:
            await cluster.stop()

    run_native(scenario())


def test_read_pipelined_behind_write_does_not_interleave(tmp_path):
    """A large read racing unacknowledged pipelined writes on one
    connection to the listener: every frame parses, each block is whole
    or absent, and after the acks a read sees every block."""

    async def scenario():
        cluster = port_cluster(tmp_path)
        await cluster.start()
        try:
            cs = cluster.chunkservers[0]
            reader, writer = await asyncio.open_connection(NATIVE_HOST, cs.data_server.port)
            framing.write_message(writer, m.CltocsWriteInit(
                req_id=1, chunk_id=7, version=1, part_id=0, chain=[], create=True))
            await writer.drain()
            st0 = await framing.read_message(reader)
            assert isinstance(st0, m.CstoclWriteStatus) and st0.status == 0
            block = payload(3, MFSBLOCKSIZE)
            for blk in range(4):
                framing.write_message(writer, m.CltocsWriteData(
                    req_id=2 + blk, chunk_id=7, write_id=blk, block=blk, offset=0,
                    crc=crc32.crc32(block), data=block))
            framing.write_message(writer, m.CltocsRead(
                req_id=50, chunk_id=7, version=1, part_id=0, offset=0, size=4 * MFSBLOCKSIZE))
            await writer.drain()
            acks, done, got = 0, False, bytearray(4 * MFSBLOCKSIZE)
            while not done or acks < 4:
                msg = await asyncio.wait_for(framing.read_message(reader), 5)
                if isinstance(msg, m.CstoclWriteStatus):
                    assert msg.status == 0
                    acks += 1
                elif isinstance(msg, m.CstoclReadData):
                    assert crc32.crc32(msg.data) == msg.crc
                    got[msg.offset:msg.offset + len(msg.data)] = msg.data
                elif isinstance(msg, m.CstoclReadStatus):
                    assert msg.status == 0
                    done = True
            for blk in range(4):
                piece = bytes(got[blk * MFSBLOCKSIZE:(blk + 1) * MFSBLOCKSIZE])
                assert piece in (block, b"\0" * MFSBLOCKSIZE)
            framing.write_message(writer, m.CltocsRead(
                req_id=60, chunk_id=7, version=1, part_id=0, offset=0, size=4 * MFSBLOCKSIZE))
            await writer.drain()
            got2 = bytearray(4 * MFSBLOCKSIZE)
            while True:
                msg = await asyncio.wait_for(framing.read_message(reader), 5)
                if isinstance(msg, m.CstoclReadData):
                    assert crc32.crc32(msg.data) == msg.crc
                    got2[msg.offset:msg.offset + len(msg.data)] = msg.data
                elif isinstance(msg, m.CstoclReadStatus):
                    assert msg.status == 0
                    break
            assert bytes(got2) == block * 4
            writer.close()
        finally:
            await cluster.stop()

    run_native(scenario())


@pytest.mark.parametrize("client", CLIENTS)
def test_truncated_header_not_served_as_zeros(tmp_path, client):
    """A part file cut inside its header yields an error, never
    fabricated zeros with status OK."""

    async def scenario():
        cluster = port_cluster(tmp_path, client)
        await cluster.start()
        try:
            c = await cluster.client()
            f = await c.create(1, "trunc")
            await c.write_file(f.inode, b"\xcd" * (256 * 1024))
            for cf in cluster.chunkservers[0].store.all_parts():
                os.truncate(cf.path, 1030)  # signature kept, CRC slots cut
            c.cache.invalidate(f.inode)
            with pytest.raises((mod(client, "proto.status").StatusError, OSError)):
                await asyncio.wait_for(c.read_file(f.inode), 30)
        finally:
            await cluster.stop()

    run_native(scenario())


def test_native_qos_budget_paces_reads(tmp_path):
    """A per-session byte-rate budget on the listener paces that session's
    reads (bytes unchanged, the deferral count moves); an empty table
    unpaces."""

    async def scenario():
        cluster = port_cluster(tmp_path)
        await cluster.start()
        try:
            plane = cluster.chunkservers[0].data_server
            c = await cluster.client()
            data = payload(4, 2 * MiB)
            f = await c.create(1, "qos.bin")
            await c.write_file(f.inode, data)
            assert plane.qos_set({c.session_id: 512 * 1024})
            for off in range(4):
                c.cache.invalidate(f.inode)
                got = await c.read_file(f.inode, off * 512 * 1024, 512 * 1024)
                assert got == data[off * 512 * 1024:(off + 1) * 512 * 1024]
            assert plane.qos_deferrals() >= 1, "the budgeted session was never paced"
            assert plane.qos_set({})
            before = plane.qos_deferrals()
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
            assert plane.qos_deferrals() == before
        finally:
            await cluster.stop()

    run_native(scenario())


# --- mixed clusters ---------------------------------------------------------------

FILES = {  # name: goal, size, through the windowed stripe pipeline
    "windowed.ec32": (GOALS["ec32"], 6 * MiB, True),
    "serial.ec32": (GOALS["ec32"], 3 * MiB + 777, False),
    "chain.std2": (GOALS["std2"], MiB + 55, False),
    "xor3": (GOALS["xor3"], 2 * MiB + 1, False),
}
WINDOW_SEGMENTS = 8  # LZ_WRITE_WINDOW's default depth: the least segment count
_ASYNCIO: dict = {}


class CountingEncoder(CudaChunkEncoder):
    """The port's encoder on the plain versions, counting its calls."""

    def __init__(self):
        super().__init__(device="cpu")
        self.calls = Counter()

    def encode_into(self, k, m, data_parts, out):
        self.calls["encode_into"] += 1
        return super().encode_into(k, m, data_parts, out)

    def recover(self, k, m, parts, wanted):
        self.calls["recover"] += 1
        return super().recover(k, m, parts, wanted)


@contextlib.contextmanager
def asyncio_plane():
    """Both packages' native exchanges set aside for the clients."""
    saved = native_io._lib, ref_native_io._lib
    native_io._lib = ref_native_io._lib = None
    try:
        yield
    finally:
        native_io._lib, ref_native_io._lib = saved


async def mixed_scenario(root: Path, servers: str, client: str, plane: bool) -> dict:
    cluster = Cluster(root, master=servers, servers=servers, client=client, n_cs=6,
                      native_data_plane=plane, cs_host=NATIVE_HOST)
    await cluster.start(health_interval=30.0)  # no rebuild: raw degraded reads
    try:
        enc = CountingEncoder() if client == "port" else RefCpuChunkEncoder()
        c = mod(client, "client.client").Client(
            "127.0.0.1", cluster.master.port, wave_timeout=0.2, encoder=enc)
        await c.connect()
        cluster.clients.append(c)
        inodes, reads, degraded = {}, {}, {}
        serial_min = c.WRITE_PIPELINE_MIN_BYTES
        for name, (goal, size, windowed) in FILES.items():
            c.WRITE_PIPELINE_MIN_BYTES = 1 if windowed else serial_min
            f = await c.create(1, name)
            await c.setgoal(f.inode, goal)
            await c.write_file(f.inode, payload(size % 97, size))
            inodes[name] = f.inode
        writes = dict(getattr(enc, "calls", {}))
        for name, inode in inodes.items():
            c.cache.invalidate(inode)
            reads[name] = bytes(await c.read_file(inode))
        into = np.zeros(FILES["windowed.ec32"][1], np.uint8)
        c.cache.invalidate(inodes["windowed.ec32"])
        assert await c.read_file_into(inodes["windowed.ec32"], 0, into) == len(into)
        reads["windowed.ec32/into"] = into.tobytes()
        parts = cluster.live_parts()
        planes = [cs.data_server.stats() for cs in cluster.chunkservers if cs.data_server]
        await cluster.stop_data_holder(inodes["windowed.ec32"], 3)
        for name in ("windowed.ec32", "serial.ec32"):
            c.cache.invalidate(inodes[name])
            degraded[name] = bytes(await c.read_file(inodes[name]))
        return {"reads": reads, "degraded": degraded, "parts": parts, "planes": planes,
                "ops": dict(c.op_counters), "writes": writes,
                "calls": dict(getattr(enc, "calls", {}))}
    finally:
        await cluster.stop()


def asyncio_reference(root: Path) -> dict:
    if "run" not in _ASYNCIO:
        with asyncio_plane():
            _ASYNCIO["run"] = run_native(mixed_scenario(root / "asyncio", "port", "port", False))
    return _ASYNCIO["run"]


@pytest.mark.parametrize("servers,client", [("port", "port"), ("jax", "port"), ("port", "jax")],
                         ids=["port-on-port", "port-on-jax", "jax-on-port"])
def test_mixed_cluster_native_plane_matches_asyncio(tmp_path, servers, client):
    ref = asyncio_reference(tmp_path)
    got = run_native(mixed_scenario(tmp_path / "native", servers, client, True))
    for name, (_, size, _) in FILES.items():
        want = payload(size % 97, size)
        assert ref["reads"][name] == want and got["reads"][name] == want, name
    assert got["reads"]["windowed.ec32/into"] == ref["reads"]["windowed.ec32/into"]
    for name, data in got["degraded"].items():
        assert data == ref["degraded"][name] == payload(FILES[name][1] % 97, FILES[name][1]), name
    assert got["parts"] == ref["parts"]  # part files: headers, CRC slots and bytes
    assert not ref["planes"] and len(got["planes"]) == 6
    assert sum(s["bytes_written"] for s in got["planes"]) > 0, "the listeners took no write"
    assert sum(s["bytes_read"] for s in got["planes"]) > 0, "the listeners served no read"
    for op in ("write_window", "parts_scatter_write", "stripe_gather_fast"):
        assert got["ops"].get(op, 0) >= 1 and not ref["ops"].get(op), op
    if client == "port":
        # the windowed file encodes segment by segment; the asyncio plane's
        # serial path encodes each chunk once, with encode
        assert got["writes"]["encode_into"] >= WINDOW_SEGMENTS
        assert not ref["writes"].get("encode_into")
        assert got["calls"]["recover"] >= 1


def test_armed_faults_stand_the_plane_down(tmp_path):
    """With a fault rule armed (one that never fires), the chunkserver
    starts no listener and the client's write and read take the hookable
    asyncio path: same bytes, no native exchange, as the JAX package's
    stand-downs do."""
    from lizardfs_tpu_torch.runtime import faults

    async def scenario():
        cluster = port_cluster(tmp_path, n_cs=6)
        await cluster.start()
        try:
            assert all(cs.data_server is None for cs in cluster.chunkservers)
            c = await cluster.client()
            c.WRITE_PIPELINE_MIN_BYTES = 1
            f = await c.create(1, "faulted.bin")
            await c.setgoal(f.inode, GOALS["ec32"])
            data = payload(7, 6 * MiB)
            await c.write_file(f.inode, data)
            c.cache.invalidate(f.inode)
            back = np.zeros(len(data), np.uint8)
            assert await c.read_file_into(f.inode, 0, back) == len(data)
            assert back.tobytes() == data
            for op in ("write_window", "parts_scatter_write", "stripe_gather_fast"):
                assert not c.op_counters.get(op), op
        finally:
            await cluster.stop()

    faults.arm("chunkserver:disk_pwrite error,after=1000000")
    try:
        run_native(scenario())
    finally:
        faults.clear()
