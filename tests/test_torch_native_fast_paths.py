"""The port's native fast paths against the JAX package's, on the CPU.

* Stripe helpers: ``core/native.py``'s scatter and gather against the JAX
  package's numpy layout (its striping with the helpers off) on odd
  shapes, ``utils/striping.py`` with and without the helpers, and a dirty
  reused staging buffer. ``utils/striping.py`` departs from the JAX
  package's only by its encoder default and by checking and filling a
  caller's ``out``.
* The cases of ``tests/test_fast_paths.py`` on port clients and port
  chunkservers: the whole-stripe gather (its failure and a dead holder
  fall back to the wave executor), the gather's abort, the one-call parts
  scatter write (its failure falls back per part; chained copies stand
  aside), the scatter's abort, and a cancelled striped write that must
  not pool a buffer a sender thread may still read.
* The shared-memory ring on asyncio chunkservers (their demux maps the
  client's memfd through ``/proc``): engaged for a port client on port
  servers, a JAX client on port servers and a port client on JAX
  servers, with the bytes and part files of the socket path; a ring too
  small falls back to the vectored send; ``LZ_SHM_RING=0`` stays on the
  socket path; descriptor frames sent by hand land; a remote peer's
  ``ShmInit`` is refused; the allocator's rollback.
* The C NFSv3 client (``nfs/cnfs.py``) drives either package's gateway.
* The read path's timing on native chunkservers: each native exchange
  and de-interleave is a hop whose queue, run and resume parts partition
  its charge, recovery charges the seam's stage and sync, and a traced
  read's spans merge across the client, the master and the chunkservers
  on one clock.

No case binds the abstract unix name ``@lzfs-data-127.0.0.1-<port>`` on
the shared host: native chunkservers listen on ``NATIVE_HOST``
(``tests/test_torch_native_serve.py``), and the ring's cases run asyncio
chunkservers advertised as ``localhost``. The ring through the native
listener, which rides that name's unix socket, runs on the card
(``chip_smoke.py``).
"""

import asyncio
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from lizardfs_tpu.core import native as ref_native
from lizardfs_tpu.core import native_io as ref_native_io
from lizardfs_tpu.utils import striping as ref_striping
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE, MFSCHUNKSIZE
from lizardfs_tpu_torch.core import native, native_io
from lizardfs_tpu_torch.ops import crc32
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.metrics import phase_delta
from lizardfs_tpu_torch.utils import data_generator, striping
from tests.test_torch_client import GOALS, Cluster, two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_master import assert_departs, mod
from tests.test_torch_native_serve import (  # noqa: F401 (autouse fixtures)
    NATIVE_HOST, jax_native_library, native_threads_released, run_native, settled)
from tests.test_torch_read_hops import hops

B = MFSBLOCKSIZE
MiB = 1 << 20
EC_GOAL = GOALS["ec32"]


# --- the stripe helpers -----------------------------------------------------------


def test_striping_departs_only_by_its_encoder_and_out():
    assert_departs("utils/striping.py", [
        "whole write pipeline. ``out`` (shape (d, part_len)) reuses a staging",
        "buffer on the native path.",
        "stacked = native.stripe_scatter(data, d, blocks_per_part, out=out)",
        "stacked = np.ascontiguousarray(grid.transpose(1, 0, 2))",
        "return [stacked[p].reshape(part_len) for p in range(d)], part_len",
        'enc = encoder or get_encoder("cpu")',
    ], [
        "whole write pipeline. ``out`` (C-contiguous uint8 of shape",
        "(d, part_len)) receives the streams, and the parts are its rows.",
        "stacked = np.empty((d, part_len), dtype=np.uint8) if out is None else out",
        "if stacked.shape != (d, part_len) or not stacked.flags.c_contiguous:",
        'raise ValueError(f"out must be C-contiguous of shape {(d, part_len)}")',
        "native.stripe_scatter(data, d, blocks_per_part, out=stacked)",
        "stacked.reshape(d, blocks_per_part, MFSBLOCKSIZE)[...] = grid.transpose(1, 0, 2)",
        "return list(stacked), part_len",
        "``encoder`` defaults to the CUDA encoder on ``cuda:0``.",
        "enc = encoder or get_encoder()",
    ])


ODD_SHAPES = [  # (d, nbytes)
    (3, 7 * B + 4242),       # partial tail, nblocks % d != 0
    (8, 3 * B),              # nblocks < d
    (5, 5 * B + 1),          # partial tail lands in part 0 slot 1
    (2, B - 17),             # single partial block
    (4, 16 * B),             # exact grid
    (3, 2 * B + B // 2),     # nblocks % d == 0 after pad
]


def reference_layout(data: np.ndarray, d: int, monkeypatch) -> np.ndarray:
    """The JAX package's numpy layout (its striping with the helpers off)."""
    with monkeypatch.context() as mp:
        mp.setattr(ref_native, "stripe_helpers_available", lambda: False)
        parts, _ = ref_striping.padded_data_parts(data, d)
    return np.stack(parts)


def odd(seed: int, nbytes: int) -> np.ndarray:
    return np.frombuffer(data_generator.generate(seed, nbytes).tobytes(), dtype=np.uint8)


@pytest.mark.parametrize("d,nbytes", ODD_SHAPES)
def test_native_scatter_matches_reference_layout(d, nbytes, monkeypatch):
    data = odd(d, nbytes)
    want = reference_layout(data, d, monkeypatch)
    np.testing.assert_array_equal(native.stripe_scatter(data, d, want.shape[1] // B), want)


@pytest.mark.parametrize("d,nbytes", ODD_SHAPES)
def test_native_gather_matches_reference_layout(d, nbytes, monkeypatch):
    data = odd(d + 100, nbytes)
    parts = reference_layout(data, d, monkeypatch)
    out = np.full(nbytes, 0xEE, dtype=np.uint8)
    native.stripe_gather(list(parts), nbytes, out=out)
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("d,nbytes", ODD_SHAPES)
def test_padded_data_parts_native_vs_fallback(d, nbytes, monkeypatch):
    data = odd(2 * d, nbytes)
    native_parts, plen_n = striping.padded_data_parts(data, d)
    monkeypatch.setattr(native, "stripe_helpers_available", lambda: False)
    numpy_parts, plen_f = striping.padded_data_parts(data, d)
    want = reference_layout(data, d, monkeypatch)
    assert plen_n == plen_f == want.shape[1]
    for a, b, c in zip(native_parts, numpy_parts, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_stripe_scatter_reused_buffer_tail_zeroed():
    """Scatter zeroes the pad tail: a dirty reused buffer comes out
    byte-identical to a fresh one, and to the JAX package's."""
    rng = np.random.default_rng(10)
    for d, nblocks, tail in ((3, 7, 100), (8, 16, 0), (2, 1, 17), (5, 5, 1)):
        nbytes = (nblocks - 1) * B + (tail or B)
        data = rng.integers(0, 256, nbytes, dtype=np.uint8)
        fresh = native.stripe_scatter(data, d, -(-nblocks // d))
        dirty = np.full_like(fresh, 0xAB)
        reused = native.stripe_scatter(data, d, -(-nblocks // d), out=dirty)
        np.testing.assert_array_equal(fresh, reused)
        np.testing.assert_array_equal(fresh, ref_native.stripe_scatter(data, d, -(-nblocks // d)))


# --- whole-stripe gather ----------------------------------------------------------


def native_cluster(tmp_path, n_cs=6, **kw):
    return Cluster(tmp_path, n_cs=n_cs, native_data_plane=True, cs_host=NATIVE_HOST, **kw)


async def write_ec_file(cluster, nbytes=6 * MiB, seed=3, name="stripe.bin", goal=EC_GOAL):
    c = await cluster.client()
    f = await c.create(1, name)
    await c.setgoal(f.inode, goal)
    data = data_generator.generate(seed, nbytes).tobytes()
    await c.write_file(f.inode, data)
    return c, f, data


def test_stripe_gather_failure_falls_back_to_waves(tmp_path, monkeypatch):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start()
        try:
            c, f, data = await write_ec_file(cluster)

            def boom(*a, **k):
                raise native_io.NativeIOError(5, "injected gather failure")

            monkeypatch.setattr(native_io, "read_parts_gather_blocking", boom)
            back = np.zeros(len(data), dtype=np.uint8)
            c.cache.invalidate(f.inode)
            assert await c.read_file_into(f.inode, 0, back) == len(data)
            assert back.tobytes() == data
            assert c.op_counters.get("stripe_gather_fallback", 0) >= 1
        finally:
            await cluster.stop()

    run_native(scenario())


def test_stripe_gather_cs_death_still_reads(tmp_path):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)  # no repair: raw recovery
        try:
            c, f, data = await write_ec_file(cluster)
            await cluster.stop_data_holder(f.inode, 3)
            back = np.zeros(len(data), dtype=np.uint8)
            c.cache.invalidate(f.inode)
            assert await c.read_file_into(f.inode, 0, back) == len(data)
            assert back.tobytes() == data
            assert not c.op_counters.get("stripe_gather_fast")
        finally:
            await cluster.stop()

    run_native(scenario())



def hop_checks(charges, phase: str) -> int:
    """Each ``phase`` hop's queue, run and resume parts sum to its charge
    within 1%; returns how many hops there were."""
    got = hops(charges, phase)
    for h in got:
        assert min(h["queue"], h["run"], h["resume"]) >= 0
        assert h["queue"] + h["run"] + h["resume"] == pytest.approx(h["whole"], rel=0.01)
    return len(got)


def test_read_hops_partition_their_phases(tmp_path, monkeypatch):
    """A whole read on the stripe gather, then a degraded one on the wave
    executor, recovery and the de-interleave: each native exchange and
    de-interleave is a hop whose parts partition its charge, recovery
    charges the seam's stage and sync, and the read's sub-phases land in
    ``read_phases`` beside the phases they split."""
    was = tracing.enabled()
    tracing.set_enabled(True)

    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)  # no repair: raw recovery
        try:
            c, f, data = await write_ec_file(cluster)
            charges = []
            sink = c._read_sink

            def keep(phase, t0, t1):
                charges.append((phase, t0, t1))
                sink(phase, t0, t1)

            monkeypatch.setattr(c, "_read_sink", keep)
            back = np.zeros(len(data), dtype=np.uint8)
            c.cache.invalidate(f.inode)
            assert await c.read_file_into(f.inode, 0, back) == len(data)
            assert back.tobytes() == data and c.op_counters.get("stripe_gather_fast")
            assert hop_checks(charges, "net") >= 1
            charges.clear()
            await cluster.stop_data_holder(f.inode, 3)
            c.cache.invalidate(f.inode)
            before = c.read_phases.snapshot()
            tid = tracing.start_trace()
            assert await c.read_file(f.inode) == data
            tracing.clear_trace()
            assert hop_checks(charges, "net") >= 2
            assert hop_checks(charges, "gather") >= 1
            phases = phase_delta(c.read_phases.snapshot(), before)
            for sub in ("seam_stage", "seam_sync"):
                assert phases[f"{sub}_ms"] > 0
            assert phases["seam_stage_ms"] + phases["seam_sync_ms"] <= phases["decode_ms"] + 0.02
            parts = sum(phases[f"gather_{x}_ms"] for x in tracing.HOP_PARTS)
            assert parts == pytest.approx(phases["gather_ms"], abs=0.05)
            assert sum(phases[f"net_{x}_ms"] for x in tracing.HOP_PARTS) <= phases["net_ms"] + 0.05
            return tid, c.trace_ring.dump(tid), [
                json.loads(d.handle_admin_basics(m.AdminCommand(
                    req_id=1, command="trace-dump", json=json.dumps({"trace_id": tid}))).json)
                for d in [cluster.master, *cluster.chunkservers]]
        finally:
            await cluster.stop()

    try:
        tid, client_spans, dumps = run_native(scenario())
    finally:
        tracing.set_enabled(was)
    names = {s["name"] for s in client_spans}
    assert {"read:seam_stage", "read:seam_sync", "read:net_queue", "read:net_run",
            "read:net_resume", "read:gather_queue", "read:gather_run",
            "read:gather_resume"} <= names
    # every role's spans on the one clock: the chunkservers' native ops
    # and the master's RPCs fall inside the client's read
    (root,) = [s for s in client_spans if s["name"] == "read_file"]
    daemon_spans = [s for d in dumps for s in d["spans"]]
    assert {s["role"] for s in daemon_spans} == {"master", "chunkserver"}
    for s in daemon_spans:
        assert root["t0"] - 0.005 <= s["t0"] <= s["t1"] <= root["t1"] + 0.005, s
    timeline = tracing.merge_timeline(client_spans + daemon_spans, tid, wall_name="read_file")
    assert {"client", "master", "chunkserver"} <= set(timeline["by_role_ms"])
    attr = tracing.attribute_timeline(timeline)
    assert sum(attr["buckets_ms"].values()) == pytest.approx(attr["wall_ms"], abs=0.01)
    assert attr["buckets_ms"]["queue"] > 0 and attr["buckets_ms"]["compute"] > 0
    # each dump's anchor moves its spans onto the epoch clock
    for d in dumps:
        for s in tracing.to_epoch(d["spans"], d["anchor"]):
            assert abs(s["t0"] - time.time()) < 60.0

async def stalled_server():
    """A server that accepts, reads one request and stays silent until
    ``teardown`` is set."""
    stalled, teardown = asyncio.Event(), asyncio.Event()

    async def handler(reader, writer):
        try:
            await reader.read(4096)
            stalled.set()
            await teardown.wait()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], stalled, teardown


def test_abort_parts_gather_quiesces_buffer():
    """The abort unblocks the gather's thread promptly, and nothing
    writes the destination after the caller resumes."""

    async def scenario():
        server, port, stalled, teardown = await stalled_server()
        try:
            out = np.zeros(6 * B, dtype=np.uint8)
            cell: dict = {}
            loop = asyncio.get_running_loop()
            fut = loop.run_in_executor(native_io.EXECUTOR, lambda: native_io.read_parts_gather_blocking(
                [("127.0.0.1", port)] * 3, 42, 1, [1, 2, 3], 0, 6, out, cell))
            await asyncio.wait_for(stalled.wait(), 10.0)
            t0 = loop.time()
            native_io.abort_parts_gather(cell)
            with pytest.raises((native_io.NativeIOError, OSError)):
                await asyncio.wait_for(fut, 10.0)
            assert loop.time() - t0 < 5.0, "abort did not unblock the thread"
            sentinel = odd(99, out.nbytes)
            out[:] = sentinel
            await asyncio.sleep(0.3)
            np.testing.assert_array_equal(out, sentinel)
        finally:
            teardown.set()
            server.close()
            await server.wait_closed()

    run_native(scenario())


def test_abort_before_dial_refuses_cleanly():
    out = np.full(3 * B, 0x77, dtype=np.uint8)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    try:
        with pytest.raises(native_io.NativeIOError):
            run_native(native_io.run(
                native_io.read_parts_gather_blocking,
                [("127.0.0.1", sock.getsockname()[1])] * 3, 7, 1, [1, 2, 3], 0, 3, out,
                {"aborted": True}))
        assert np.all(out == 0x77)
    finally:
        sock.close()


# --- parts scatter write ----------------------------------------------------------


def test_parts_scatter_write_failure_falls_back(tmp_path, monkeypatch):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start()
        try:
            def boom(*a, **k):
                raise native_io.NativeIOError(5, "injected scatter failure")

            monkeypatch.setattr(native_io, "write_parts_scatter_blocking", boom)
            c, f, data = await write_ec_file(cluster, 2 * MiB, seed=12)
            assert c.op_counters.get("parts_scatter_fallback", 0) >= 1
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
            written = await settled(
                lambda: sum(cs.data_server.stats()["bytes_written"] for cs in cluster.chunkservers),
                lambda n: n > 0)
            assert written > 0
        finally:
            await cluster.stop()

    run_native(scenario())


def test_parts_scatter_skips_chained_copies(tmp_path):
    async def scenario():
        cluster = native_cluster(tmp_path, n_cs=4)
        await cluster.start()
        try:
            c, f, data = await write_ec_file(cluster, MiB + 55, seed=13, goal=GOALS["std2"])
            assert not c.op_counters.get("parts_scatter_write")
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
            copies = [cf for cs in cluster.chunkservers for cf in cs.store.all_parts()]
            assert len(copies) == 2
        finally:
            await cluster.stop()

    run_native(scenario())


def test_abort_write_scatter_unblocks_thread():
    async def scenario():
        server, port, stalled, teardown = await stalled_server()
        try:
            payloads = [np.zeros(B, dtype=np.uint8) for _ in range(3)]
            cell: dict = {"submitted": True}
            loop = asyncio.get_running_loop()
            fut = loop.run_in_executor(native_io.EXECUTOR, lambda: native_io.write_parts_scatter_blocking(
                [("127.0.0.1", port)] * 3, 42, 1, [1, 2, 3], payloads, [B] * 3, 0, cell))
            await asyncio.wait_for(stalled.wait(), 10.0)
            t0 = loop.time()
            native_io.abort_write(cell)
            with pytest.raises((native_io.NativeIOError, OSError)):
                await asyncio.wait_for(fut, 10.0)
            assert loop.time() - t0 < 5.0, "abort did not unblock the sender thread"
            assert cell.get("finished") is True
        finally:
            teardown.set()
            server.close()
            await server.wait_closed()

    run_native(scenario())


def test_cancelled_striped_write_does_not_pool_staging(tmp_path, monkeypatch):
    """A full-chunk write pools its staging buffer; a cancelled one whose
    sender may still run pools nothing and aborts the sender. At xor3,
    whose parity is a cheap XOR on the CPU: the staging is the same as at
    ec(k,m)."""

    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start()
        try:
            c = await cluster.client()
            c.write_pipeline = False  # the serial parts scatter
            full = data_generator.generate(21, MFSCHUNKSIZE).tobytes()
            f = await c.create(1, "pool.bin")
            await c.setgoal(f.inode, GOALS["xor3"])
            await c.write_file(f.inode, full)
            assert sum(len(b) for b in c._stage_buffers.values()) >= 1
            started = threading.Event()
            cells: list[dict] = []

            def hang_until_abort(addrs, cid, ver, pids, payloads, lengths, part_offset=0,
                                 cell=None):
                cells.append(cell)
                started.set()
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline and not (cell and cell.get("aborted")):
                    time.sleep(0.01)
                try:
                    raise native_io.NativeIOError(-1, "hung exchange aborted")
                finally:
                    if cell is not None:
                        cell["finished"] = True

            monkeypatch.setattr(native_io, "write_parts_scatter_blocking", hang_until_abort)
            g = await c.create(1, "pool2.bin")
            await c.setgoal(g.inode, GOALS["xor3"])
            task = asyncio.ensure_future(c.write_file(g.inode, full))
            assert await asyncio.to_thread(started.wait, 60), "the scatter never started"
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            assert sum(len(b) for b in c._stage_buffers.values()) == 0
            assert any(cl and cl.get("aborted") for cl in cells)
        finally:
            await cluster.stop()

    run_native(scenario())


# --- the shared-memory ring on asyncio chunkservers -------------------------------


def ring_cluster(tmp_path, servers="port", client="port", n_cs=6):
    """Asyncio chunkservers advertised as ``localhost``: the client's
    ring rides loopback TCP, and nothing binds an abstract unix name."""
    return Cluster(tmp_path, master=servers, servers=servers, client=client, n_cs=n_cs,
                   native_data_plane=False, cs_host="localhost")


async def ring_roundtrip(cluster, name="ring.bin", nbytes=8 * MiB, seed=29):
    c = await cluster.client()
    c.WRITE_PIPELINE_MIN_BYTES = 1
    f = await c.create(1, name)
    await c.setgoal(f.inode, EC_GOAL)
    data = data_generator.generate(seed, nbytes).tobytes()
    await c.write_file(f.inode, data)
    c.cache.invalidate(f.inode)
    assert bytes(await c.read_file(f.inode, 0, nbytes)) == data
    return c


def mapped_segments(cluster) -> float:
    return sum(cs.metrics.series["shm_segments_mapped"].total
               for cs in cluster.chunkservers if "shm_segments_mapped" in cs.metrics.series)


@pytest.mark.parametrize("servers,client", [("port", "port"), ("port", "jax"), ("jax", "port")],
                         ids=["port-on-port", "jax-on-port", "port-on-jax"])
def test_shm_ring_engages_on_asyncio_chunkservers(tmp_path, monkeypatch, servers, client):
    """The windowed write maps rings and lands its parts as descriptor
    frames; the part files equal the socket path's."""

    async def scenario(root, ring):
        monkeypatch.setenv("LZ_SHM_RING", "1" if ring else "0")
        cluster = ring_cluster(root, servers, client)
        await cluster.start()
        try:
            c = await ring_roundtrip(cluster)
            return dict(c.op_counters), mapped_segments(cluster), cluster.live_parts()
        finally:
            await cluster.stop()

    ops, mapped, parts = run_native(scenario(tmp_path / "ring", True))
    socket_ops, socket_mapped, socket_parts = run_native(scenario(tmp_path / "socket", False))
    assert ops.get("write_shm", 0) >= 1 and mapped >= 1, "the ring did not engage"
    assert not socket_ops.get("write_shm") and socket_mapped == 0
    assert socket_ops.get("write_window", 0) >= 1
    assert parts == socket_parts


def test_shm_ring_full_falls_back_to_scatterv(tmp_path, monkeypatch):
    monkeypatch.setenv("LZ_SHM_RING_MB", "0.0625")  # smaller than any parity region

    async def scenario():
        cluster = ring_cluster(tmp_path)
        await cluster.start()
        try:
            c = await ring_roundtrip(cluster, "tiny_ring.bin")
            fallbacks = c.metrics.series.get("shm_ring_fallbacks")
            assert fallbacks is not None and fallbacks.total >= 1
            assert not c.op_counters.get("write_pipeline_fallback")
        finally:
            await cluster.stop()

    run_native(scenario())


def test_shm_ring_kill_switch_stays_on_socket_path(tmp_path, monkeypatch):
    monkeypatch.setenv("LZ_SHM_RING", "0")

    async def scenario():
        cluster = ring_cluster(tmp_path)
        await cluster.start()
        try:
            c = await ring_roundtrip(cluster, "killed.bin")
            assert c.op_counters.get("write_window", 0) >= 1
            assert not c.op_counters.get("write_shm")
            assert "shm_ring_desc_parts" not in c.metrics.series
            assert mapped_segments(cluster) == 0
        finally:
            await cluster.stop()

    run_native(scenario())


def test_shm_ring_segments_released_on_session_teardown(tmp_path):
    """Pooled ring connections keep their segment; dropping the pools
    closes the connections, and every server releases its mapping."""

    async def scenario():
        cluster = ring_cluster(tmp_path)
        await cluster.start()
        try:
            for rep in range(2):
                await ring_roundtrip(cluster, f"seg{rep}.bin", 4 * MiB, seed=rep)
            assert mapped_segments(cluster) >= 1
            idle = []
            for pool in (native_io.POOL, native_io.RING_POOL):
                with pool._lock:
                    idle += [s for bucket in pool._idle.values() for s in bucket]
                    pool._idle.clear()
            assert idle
            for s in idle:
                native_io.shm_ring_drop(s)
                s.close()
            assert native_io._SOCK_RINGS.get(idle[0]) is None
        finally:
            await cluster.stop()

    run_native(scenario())


def test_shm_ring_asyncio_fallback_demux(tmp_path):
    """Descriptor frames sent by hand to a port asyncio chunkserver: the
    ``ShmInit`` maps the memfd, the ``ShmWritePart`` lands the bytes with
    their CRCs, and the client reads them back."""

    async def scenario():
        cluster = Cluster(tmp_path, n_cs=3)
        await cluster.start()
        try:
            c = await cluster.client()
            f = await c.create(1, "pyring.bin")
            await c.write_file(f.inode, data_generator.generate(31, 2 * B).tobytes())
            loc = await c.chunk_info(f.inode, 0)
            part = loc.locations[0]
            ring = native_io.ShmRing(1 << 20)
            fresh = data_generator.generate(37, 2 * B).tobytes()
            try:
                ring.arr[: len(fresh)] = np.frombuffer(fresh, dtype=np.uint8)
                reader, writer = await asyncio.open_connection(part.addr.host, part.addr.port)
                try:
                    await framing.send_message(writer, m.CltocsShmInit(
                        req_id=1, pid=os.getpid(), mem_fd=ring.memfd, seg_size=ring.size))
                    assert (await framing.read_message(reader)).status == st.OK
                    await framing.send_message(writer, m.CltocsWriteInit(
                        req_id=2, chunk_id=loc.chunk_id, version=loc.version,
                        part_id=part.part_id, chain=[], create=False))
                    assert (await framing.read_message(reader)).status == st.OK
                    crcs = [crc32.crc32(fresh[i * B:(i + 1) * B]) for i in range(2)]
                    await framing.send_message(writer, m.CltocsShmWritePart(
                        req_id=3, chunk_id=loc.chunk_id, write_id=3, part_id=part.part_id,
                        part_offset=0, ring_off=0, length=len(fresh), crcs=crcs))
                    assert (await framing.read_message(reader)).status == st.OK
                    await framing.send_message(writer, m.CltocsWriteEnd(
                        req_id=4, chunk_id=loc.chunk_id))
                    assert (await framing.read_message(reader)).status == st.OK
                finally:
                    writer.close()
                    await writer.wait_closed()
            finally:
                ring.close()
            c.cache.invalidate(f.inode)
            assert bytes(await c.read_file(f.inode, 0, len(fresh))) == fresh
            assert sum(cs.metrics.series["shm_desc_writes"].total for cs in cluster.chunkservers
                       if "shm_desc_writes" in cs.metrics.series) == 1
        finally:
            await cluster.stop()

    run_native(scenario())


def test_shm_init_refused_for_remote_peers(tmp_path):
    """A ``ShmInit`` from a non-loopback peer is refused and maps
    nothing."""

    class RemoteWriter:
        def __init__(self):
            self.buf = bytearray()
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)

        def get_extra_info(self, key):
            return {"socket": self.sock, "peername": ("203.0.113.9", 54321)}.get(key)

        def write(self, data):
            self.buf += data

        async def drain(self):
            pass

    async def scenario():
        cluster = Cluster(tmp_path, n_cs=1)
        await cluster.start()
        try:
            memfd = os.memfd_create("lzshm-test")
            os.ftruncate(memfd, 1 << 20)
            w = RemoteWriter()
            shm_state: dict = {}
            try:
                await cluster.chunkservers[0]._serve_shm_init(
                    w, m.CltocsShmInit(req_id=1, pid=os.getpid(), mem_fd=memfd,
                                       seg_size=1 << 20), shm_state)
            finally:
                w.sock.close()
                os.close(memfd)
            reader = asyncio.StreamReader()
            reader.feed_data(bytes(w.buf))
            reader.feed_eof()
            ack = await framing.read_message(reader)
            assert isinstance(ack, m.CstoclWriteStatus) and ack.status == st.EINVAL
            assert "mm" not in shm_state
        finally:
            await cluster.stop()

    run_native(scenario())


def test_shm_ring_unalloc_rollback_does_not_overlap_live_regions():
    ring = native_io.ShmRing(native_io.shm_seg_bytes())
    try:
        ring.size = 100  # drive the allocator, not the mapping
        live = []
        for _ in range(2):
            off, _cost = ring.alloc(30)
            live.append((off, off + 30))
        off3, cost3 = ring.alloc(20)
        ring.unalloc(off3, cost3, 20)
        ring.free(30)
        live.pop(0)
        for nbytes in (20, 30, 20):
            got = ring.alloc(nbytes)
            if got is None:
                continue
            off, _cost = got
            for lo, hi in live:
                assert not (off < hi and off + nbytes > lo), (off, nbytes, lo, hi)
    finally:
        ring.close()


# --- the C NFSv3 client -----------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_c_nfs_client_roundtrip(tmp_path, pkg):
    """The port's C NFSv3 client writes, commits, looks up and reads a
    file through either package's gateway."""
    from lizardfs_tpu_torch.nfs import cnfs
    from tests.test_torch_nfs import gateway

    async def scenario():
        cluster = Cluster(tmp_path, master=pkg, servers=pkg, client=pkg, n_cs=2)
        await cluster.start()
        gw = gateway(pkg, cluster.master.port)
        await gw.start()
        try:
            blob = bytes(range(256)) * 1024

            def drive() -> bytes:
                with cnfs.CNfs3Client("127.0.0.1", gw.port) as c:
                    root = c.mnt("/")
                    fh = c.create(root, "cclient.bin")
                    for off in range(0, len(blob), 65536):
                        assert c.write(fh, off, blob[off:off + 65536], stable=0) == 65536
                    c.commit(fh)
                    assert c.lookup(root, "cclient.bin") == fh
                    out = b""
                    while len(out) < len(blob):
                        out += c.read(fh, len(out), 65536)
                    return out

            assert await asyncio.to_thread(drive) == blob
        finally:
            await gw.stop()
            await cluster.stop()

    assert cnfs.available()
    run_native(scenario())
