"""The EC stripe fan-in (``core/stripe_fanin.py``), on the CPU encoder.

* The recovery: for the parts a plan's wave 0 reads, the fan-in's
  gathered stripes with the lost slots rebuilt by ``recover_slots`` equal
  the wave executor's buffer post-processed by ``ECReadPlan`` and then
  de-interleaved, byte for byte; a chunk's tail with short parts and a
  plan that reads no whole slots are left to the wave executor.
* On native chunkservers: degraded ec(8,4) reads inside one slot, across
  slot boundaries and unaligned at both ends, an ec(3,2) read with two
  data parts down, and a healthy ``read_file`` (no recovery) each take
  one fan-in and give the bytes written; a read of a chunk's tail keeps
  the wave executor.
* Failure: a part that fails mid-exchange and a part that stalls past
  the wave timeout both fall back to the wave executor with the bytes
  written (the stall is not redialled), and a read cancelled mid-hop
  joins the hop's thread before it returns, so nothing writes the
  caller's buffer after.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry, native_io, plans, stripe_fanin
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder
from lizardfs_tpu_torch.runtime.metrics import phase_delta
from lizardfs_tpu_torch.utils import data_generator, striping
from tests.test_torch_client import GOALS, two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_native_fast_paths import native_cluster, stalled_server, write_ec_file
from tests.test_torch_wide_stripe import wide_cluster
from tests.test_torch_native_serve import (  # noqa: F401 (autouse fixtures)
    jax_native_library, native_threads_released, run_native)

B = MFSBLOCKSIZE
MiB = 1 << 20
ENCODER = CudaChunkEncoder(device="cpu")


# --- the recovery against the wave executor's ------------------------------------


def encoded(k: int, m: int, nslots: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    data = [rng.integers(0, 256, nslots * B, dtype=np.uint8) for _ in range(k)]
    return data + [np.asarray(p) for p in ENCODER.encode(k, m, data)]


@pytest.mark.parametrize("k,m,lost,nslots", [
    (8, 4, [3], 2), (8, 4, [0], 1), (3, 2, [0, 2], 3), (3, 2, [1], 2), (3, 2, [], 2),
])
def test_recover_slots_matches_the_wave_executor(k, m, lost, nslots):
    slice_type = geometry.ec_type(k, m)
    parts = encoded(k, m, nslots, seed=k * 100 + nslots)
    avail = [p for p in range(k + m) if p not in lost]
    plan = plans.SliceReadPlanner(slice_type, avail, encoder=ENCODER).build_plan(
        list(range(k)), 5, nslots)
    by_slot, blocks = stripe_fanin.slots(plan, nslots * k)
    assert blocks == nslots * k
    assert [op.part for op in by_slot if op.part < k] == [p for p in range(k) if p not in lost]

    # the wave executor: wave 0's parts at their buffer offsets, then the
    # plan's recovery and the de-interleave
    buf = np.zeros(plan.buffer_size, dtype=np.uint8)
    wave0 = [op for op in plan.read_operations if op.wave == 0]
    for op in wave0:
        buf[op.buffer_offset : op.buffer_offset + nslots * B] = parts[op.part]
    result = plan.postprocess(buf, [op.part for op in wave0])
    bps = nslots * B
    want = striping.assemble_chunk(
        {p: result[p * bps : (p + 1) * bps] for p in range(k)}, slice_type, k * bps)

    # the fan-in: the gather's layout, slot i from the op of slot i
    region = np.zeros((nslots, k, B), dtype=np.uint8)
    for i, op in enumerate(by_slot):
        region[:, i, :] = parts[op.part].reshape(nslots, B)
    region = region.reshape(-1)
    if lost:
        stripe_fanin.recover_slots(plan, by_slot, ENCODER, region, nslots)
    np.testing.assert_array_equal(region, np.asarray(want))
    np.testing.assert_array_equal(region, np.stack(parts[:k]).reshape(k, nslots, B)
                                  .transpose(1, 0, 2).reshape(-1))


def test_slots_refuses_what_the_waves_serve():
    slice_type = geometry.ec_type(3, 2)
    tail_sizes = {0: 3 * B, 1: 3 * B, 2: 2 * B, 3: 3 * B, 4: 3 * B}
    # a chunk's tail with a data part lost: part 2 holds one block fewer
    tail = plans.SliceReadPlanner(slice_type, [1, 2, 3, 4], encoder=ENCODER).build_plan(
        [0, 1, 2], 0, 3, part_sizes=tail_sizes)
    assert stripe_fanin.slots(tail, 8) is None
    # the same tail with every data part: the blocks up to the request's last
    healthy = plans.SliceReadPlanner(slice_type, [0, 1, 2, 3, 4], encoder=ENCODER).build_plan(
        [0, 1, 2], 0, 3, part_sizes=tail_sizes)
    by_slot, blocks = stripe_fanin.slots(healthy, 8)
    assert [op.part for op in by_slot] == [0, 1, 2] and blocks == 8
    assert stripe_fanin.slots(healthy, 9) is None  # part 2 holds no third block
    partial = {**tail_sizes, 1: 2 * B + 100}
    half = plans.SliceReadPlanner(slice_type, [0, 1, 2, 3, 4], encoder=ENCODER).build_plan(
        [0, 1, 2], 0, 3, part_sizes=partial)
    assert stripe_fanin.slots(half, 8) is None  # part 1's third block is partial
    assert stripe_fanin.slots(half, 7)[1] == 7
    whole = plans.SliceReadPlanner(slice_type, [1, 2, 3, 4], encoder=ENCODER).build_plan(
        [0, 1, 2], 0, 3)
    by_slot, blocks = stripe_fanin.slots(whole, 7)
    assert [op.part for op in by_slot] == [3, 1, 2] and blocks == 9  # whole slots
    xor_type = geometry.SliceType(geometry.XOR_FIRST)
    xor = plans.SliceReadPlanner(xor_type, [0, 1, 2], encoder=ENCODER).build_plan([1, 2], 0, 1)
    by_slot, blocks = stripe_fanin.slots(xor, 2)
    assert [op.part for op in by_slot] == [1, 2] and blocks == 2
    lost = plans.SliceReadPlanner(xor_type, [0, 2], encoder=ENCODER).build_plan([1, 2], 0, 1)
    assert stripe_fanin.slots(lost, 2) is None  # xor recovery stays on the waves


# --- on native chunkservers -------------------------------------------------------


def counts(c) -> tuple[int, int]:
    return c.op_counters.get("stripe_fanin", 0), c.op_counters.get("stripe_fanin_fallback", 0)


async def stop_holders(cluster, inode: int, parts: list[int]) -> None:
    """Stop the servers holding ``parts`` of the file's first chunk."""
    registry = cluster.master.meta.registry
    chunk = registry.chunks[cluster.master.meta.fs.nodes[inode].chunks[0]]
    for cs_id in sorted({cs for cs, p in chunk.parts if p in parts}):
        await cluster.stop_server(cluster.holder(cs_id))


EC84_READS = [  # (offset, size): inside one slot, across slot boundaries, unaligned ends
    (5 * B + 100, 1000),
    (2 * 8 * B + 3 * B + 17, 9 * B),
    (12345, 2 * MiB + 777),
    (8 * B, 16 * B),
]


def test_degraded_ec84_reads_take_the_fanin(tmp_path):
    async def scenario():
        cluster = native_cluster(tmp_path, n_cs=13)
        await cluster.start(health_interval=30.0)  # no repair: raw recovery
        try:
            c, f, data = await write_ec_file(cluster, nbytes=8 * MiB, goal=GOALS["ec84"])
            await cluster.stop_data_holder(f.inode, 8)
            for i, (off, size) in enumerate(EC84_READS):
                c.cache.invalidate(f.inode)
                assert await c.read_file(f.inode, off, size) == data[off : off + size], off
                assert counts(c) == (i + 1, 0)
            # a slot-aligned region straight into the caller's buffer
            back = np.zeros(4 * 8 * B, dtype=np.uint8)
            c.cache.invalidate(f.inode)
            assert await c.read_file_into(f.inode, 8 * 8 * B, back) == back.size
            assert back.tobytes() == data[8 * 8 * B : 12 * 8 * B]
            assert counts(c) == (len(EC84_READS) + 1, 0)
            assert c.metrics.counter("stripe_fanin").total == len(EC84_READS) + 1
        finally:
            await cluster.stop()

    run_native(scenario())


def test_ec32_two_data_parts_down(tmp_path):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=3 * MiB)
            await stop_holders(cluster, f.inode, [0, 2])
            c.cache.invalidate(f.inode)
            before = c.read_phases.snapshot()
            assert await c.read_file(f.inode) == data
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode, 3 * B + 5, 4 * B) == data[3 * B + 5 : 7 * B + 5]
            assert counts(c) == (2, 0)
            after = c.read_phases.snapshot()
            assert after["decode_ms"] > before["decode_ms"]
        finally:
            await cluster.stop()

    run_native(scenario())


def test_healthy_read_file_takes_the_fanin_without_recovery(tmp_path):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster)
            c.cache.invalidate(f.inode)
            before = c.read_phases.snapshot()
            assert await c.read_file(f.inode, 0, len(data)) == data
            assert counts(c) == (1, 0)
            after = c.read_phases.snapshot()
            assert after["decode_ms"] == before["decode_ms"]
            assert after["gather_ms"] == before["gather_ms"]
        finally:
            await cluster.stop()

    run_native(scenario())


def test_healthy_short_slots_take_the_fanin(tmp_path):
    """With every data part present the gather reads just the blocks up
    to the request's last one: a region ending inside a slot, straight
    into the caller's buffer, an xor slice, and a chunk's tail up to its
    last whole block; the tail's partial last block keeps the waves."""

    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster)
            back = np.zeros(4 * B, dtype=np.uint8)  # slot 1 and a block of slot 2
            c.cache.invalidate(f.inode)
            assert await c.read_file_into(f.inode, 3 * B, back) == back.size
            assert back.tobytes() == data[3 * B : 7 * B]
            assert counts(c) == (1, 0)
            x, g, xdata = await write_ec_file(cluster, nbytes=MiB + 999, name="x.bin",
                                              goal=GOALS["xor3"])
            for off, size in ((0, len(xdata)), (B + 7, 5 * B)):
                x.cache.invalidate(g.inode)
                assert await x.read_file(g.inode, off, size) == xdata[off : off + size]
            assert counts(x) == (1, 0)  # the tail's partial last block: waves
            t, h, tdata = await write_ec_file(cluster, nbytes=7 * B + 4242, name="t.bin")
            t.cache.invalidate(h.inode)
            assert await t.read_file(h.inode, 0, 7 * B) == tdata[: 7 * B]
            assert counts(t) == (1, 0)
        finally:
            await cluster.stop()

    run_native(scenario())


def count_rounds(monkeypatch) -> list:
    """Each call of the parts gather: its region's blocks."""
    real = native_io.read_parts_gather_blocking
    calls = []

    def counted(addrs, chunk_id, version, part_ids, offset, region_blocks, *a):
        calls.append(region_blocks)
        return real(addrs, chunk_id, version, part_ids, offset, region_blocks, *a)

    monkeypatch.setattr(native_io, "read_parts_gather_blocking", counted)
    return calls


def test_whole_chunk_at_the_default_wave_timeout(tmp_path, monkeypatch):
    """A whole 64 MiB ec(8,4) chunk with a data part lost, at the
    client's default wave timeout: one fan-in, gathered in rounds of
    ``ROUND_SLOTS`` slots, each within the wave timeout."""
    from lizardfs_tpu_torch.client.client import Client
    import inspect

    async def scenario():
        cluster = native_cluster(tmp_path, n_cs=13)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=64 * MiB, goal=GOALS["ec84"])
            c.wave_timeout = inspect.signature(Client).parameters["wave_timeout"].default
            await cluster.stop_data_holder(f.inode, 8)
            rounds = count_rounds(monkeypatch)
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
            assert counts(c) == (1, 0)
            assert rounds == [16 * 8] * 8  # 1 MiB of each of the 8 parts a round
        finally:
            await cluster.stop()

    run_native(scenario())


async def throttled_proxy(target: dict, rate: float, stop_after: int | None = None):
    """A proxy to ``target["addr"]`` that passes requests on at once and
    answers at ``rate`` bytes a second, and, with ``stop_after``, sends
    nothing more once it has answered that many bytes in all; returns
    the server, its port and its connections' writers."""
    writers = []
    sent = [0]

    async def pipe(reader, writer, paced):
        try:
            while data := await reader.read(B):
                if paced and stop_after is not None:
                    data = data[: max(stop_after - sent[0], 0)]
                    if not data:
                        await asyncio.sleep(3600)
                writer.write(data)
                await writer.drain()
                sent[0] += len(data) if paced else 0
                if paced:
                    await asyncio.sleep(len(data) / rate)
        except ConnectionError:
            pass
        finally:
            writer.close()

    async def handler(reader, writer):
        up_reader, up_writer = await asyncio.open_connection(*target["addr"])
        writers.extend((writer, up_writer))
        await asyncio.gather(pipe(reader, up_writer, False), pipe(up_reader, writer, True))

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], writers


def test_slow_part_that_keeps_moving_stays_on_the_fanin(tmp_path, monkeypatch):
    """A part served at 16 MiB/s takes longer than the wave timeout for
    the whole read but delivers each round within it: the read stays on
    the fan-in, with no fallback."""

    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=24 * MiB)
            await cluster.stop_data_holder(f.inode, 3)
            c.wave_timeout = 0.3
            target: dict = {}
            server, port, writers = await throttled_proxy(target, 16 * MiB)
            real = native_io.read_parts_gather_blocking
            rounds = []

            def proxied(addrs, *a):
                target["addr"] = addrs[0]
                rounds.append(1)
                return real([("127.0.0.1", port), *addrs[1:]], *a)

            monkeypatch.setattr(native_io, "read_parts_gather_blocking", proxied)
            try:
                c.cache.invalidate(f.inode)
                t0 = time.monotonic()
                assert await c.read_file(f.inode) == data
                took = time.monotonic() - t0
            finally:
                for w in writers:
                    w.close()
                server.close()
            assert counts(c) == (1, 0)
            assert len(rounds) == 8 and took > c.wave_timeout
        finally:
            await cluster.stop()

    run_native(scenario())


async def proxy_every_part(monkeypatch, cluster, rate: float, stop_after=None):
    """The fan-in's gather with every part served through a proxy at
    ``rate`` (the first slot's, with ``stop_after``, stopping there);
    returns the proxies' servers and writers and the gather's calls."""
    by_port, servers, writers, calls = {}, [], [], []
    for cs in cluster.chunkservers:  # each one's native data port
        addr = (cluster.cs_host, cs.data_server.port)
        server, by_port[addr[1]], w = await throttled_proxy({"addr": addr}, rate)
        servers.append(server)
        writers.append(w)
    first: dict = {}
    server, first_port, w = await throttled_proxy(first, rate, stop_after)
    servers.append(server)
    writers.append(w)
    real = native_io.read_parts_gather_blocking

    def proxied(addrs, *a):
        calls.append(len(addrs))
        via = [("127.0.0.1", by_port[port]) for _, port in addrs]
        if stop_after is not None:
            first["addr"] = addrs[0]
            via[0] = ("127.0.0.1", first_port)
        return real(via, *a)

    monkeypatch.setattr(native_io, "read_parts_gather_blocking", proxied)
    return servers, writers, calls


def test_wide_read_whose_parts_crawl_within_the_round_stays_on_the_fanin(tmp_path, monkeypatch):
    """ec(32,8) with a data part lost, every part served at 2 MiB/s
    (under the 3.3 MiB/s that 1 MiB a part a wave timeout asks for) and
    none stalling: the read's one round, 256 KiB a part, fits in the
    wave timeout, so the read stays on the fan-in, one gather call."""
    async def scenario():
        cluster, goal = await wide_cluster(tmp_path)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=8 * MiB, goal=goal)
            await cluster.stop_data_holder(f.inode, 32)
            c.wave_timeout = 0.5
            servers, writers, calls = await proxy_every_part(monkeypatch, cluster, 2 * MiB)
            try:
                c.cache.invalidate(f.inode)
                t0 = time.monotonic()
                assert await c.read_file(f.inode) == data
                took = time.monotonic() - t0
            finally:
                for w in sum(writers, []):
                    w.close()
                for server in servers:
                    server.close()
            assert calls == [32] and took > 0.1  # 256 KiB a part at 2 MiB/s
            assert counts(c) == (1, 0) and c.op_counters["stripe_fanin_rounds"] == 1
            assert c.read_phases.snapshot()["fanin_fallback_ms"] == 0
        finally:
            await cluster.stop()

    run_native(scenario())


def test_wide_read_whose_part_stops_falls_back(tmp_path, monkeypatch):
    """The same read, but slot 0's part stops after its first 100 KiB:
    the round runs out of the wave timeout, and the read falls back to
    the waves after that one timeout, with the bytes written; the
    abandoned hop is charged as ``fanin_fallback`` and its round
    counted."""
    async def scenario():
        cluster, goal = await wide_cluster(tmp_path)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=8 * MiB, goal=goal)
            await cluster.stop_data_holder(f.inode, 32)
            c.wave_timeout = 0.5
            servers, writers, calls = await proxy_every_part(
                monkeypatch, cluster, 2 * MiB, stop_after=100 << 10)
            try:
                c.cache.invalidate(f.inode)
                before = c.read_phases.snapshot()
                t0 = time.monotonic()
                assert await c.read_file(f.inode) == data
                took = time.monotonic() - t0
            finally:
                for w in sum(writers, []):
                    w.close()
                for server in servers:
                    server.close()
            assert calls == [32] and counts(c) == (0, 1)
            assert c.op_counters["stripe_fanin_rounds"] == 1
            spent = phase_delta(c.read_phases.snapshot(), before)["fanin_fallback_ms"]
            # a stall costs the read one wave timeout before the waves
            assert 500 <= spent < min(1000, 1000 * took)
        finally:
            await cluster.stop()

    run_native(scenario())


def test_part_too_slow_for_its_round_falls_back(tmp_path, monkeypatch):
    """ec(3,2) with a data part lost: slot 0's part keeps moving at 0.5
    MiB/s while the other two send their 1 MiB at once. It has not
    stalled, but it cannot deliver its 1 MiB round within the wave
    timeout: the read falls back to the waves when the round runs out,
    not after the 2 s the part needs."""

    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=3 * MiB)
            await cluster.stop_data_holder(f.inode, 3)
            c.wave_timeout = 0.3
            target: dict = {}
            server, port, writers = await throttled_proxy(target, MiB / 2)
            real = native_io.read_parts_gather_blocking

            def proxied(addrs, *a):
                target["addr"] = addrs[0]
                return real([("127.0.0.1", port), *addrs[1:]], *a)

            monkeypatch.setattr(native_io, "read_parts_gather_blocking", proxied)
            try:
                c.cache.invalidate(f.inode)
                t0 = time.monotonic()
                assert await c.read_file(f.inode) == data
                took = time.monotonic() - t0
            finally:
                for w in writers:
                    w.close()
                server.close()
            assert counts(c) == (0, 1) and took < 1.9  # not the 2 s the part needs
            assert c.op_counters["stripe_fanin_rounds"] == 1
        finally:
            await cluster.stop()

    run_native(scenario())


def test_chunk_tail_keeps_the_wave_executor(tmp_path):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            size = 7 * B + 4242  # part 2 is a block short of parts 0 and 1
            c, f, data = await write_ec_file(cluster, nbytes=size)
            await cluster.stop_data_holder(f.inode, 3)
            for off, n in ((0, size), (6 * B + 1, B + 4000)):
                c.cache.invalidate(f.inode)
                assert await c.read_file(f.inode, off, n) == data[off : off + n]
            assert counts(c) == (0, 0)
        finally:
            await cluster.stop()

    run_native(scenario())


# --- failure ----------------------------------------------------------------------


async def half_server():
    """A server that reads one request, answers with the start of a data
    frame and hangs up; ``dials`` counts its connections."""
    dials = []

    async def handler(reader, writer):
        dials.append(1)
        try:
            await reader.read(4096)
            writer.write((1207).to_bytes(4, "big") + (1 << 20).to_bytes(4, "big") + bytes(64))
            await writer.drain()
        except ConnectionError:
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handler, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1], dials


def swap_first_part(monkeypatch, addr):
    """The fan-in's gather with slot 0's part served from ``addr``;
    returns the threads' exits, one event a call."""
    real = native_io.read_parts_gather_blocking
    exits = []

    def swapped(addrs, *a):
        done = threading.Event()
        exits.append(done)
        try:
            return real([addr, *addrs[1:]], *a)
        finally:
            done.set()

    monkeypatch.setattr(native_io, "read_parts_gather_blocking", swapped)
    return exits


@pytest.mark.parametrize("how", ["mid_exchange", "stall"])
def test_failed_part_falls_back_to_the_waves(tmp_path, monkeypatch, how):
    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster)
            await cluster.stop_data_holder(f.inode, 3)
            if how == "stall":
                server, port, stalled, teardown = await stalled_server()
                dials = None
                c.wave_timeout = 0.3
            else:
                server, port, dials = await half_server()
            try:
                swap_first_part(monkeypatch, ("127.0.0.1", port))
                c.cache.invalidate(f.inode)
                t0 = time.monotonic()
                assert await c.read_file(f.inode) == data
                took = time.monotonic() - t0
            finally:
                if how == "stall":
                    teardown.set()
                server.close()
                await server.wait_closed()
            assert counts(c) == (0, 1)
            if how == "stall":
                assert stalled.is_set() and 0.25 <= took < 10.0
            else:
                assert dials  # the exchange met the broken part
        finally:
            await cluster.stop()

    run_native(scenario())


def test_cancelled_fanin_joins_its_thread(tmp_path, monkeypatch):
    """Cancelled while a part stalls, the read returns only once the
    hop's thread is done, and nothing writes the buffer after."""

    async def scenario():
        cluster = native_cluster(tmp_path)
        await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster)
            await cluster.stop_data_holder(f.inode, 3)
            c.wave_timeout = 30.0
            server, port, stalled, teardown = await stalled_server()
            try:
                exits = swap_first_part(monkeypatch, ("127.0.0.1", port))
                back = np.zeros(len(data), dtype=np.uint8)
                c.cache.invalidate(f.inode)
                task = asyncio.ensure_future(c.read_file_into(f.inode, 0, back))
                await asyncio.wait_for(stalled.wait(), 10.0)
                t0 = time.monotonic()
                task.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await task
                assert time.monotonic() - t0 < 5.0, "the abort did not end the hop"
                assert len(exits) == 1 and exits[0].is_set()
                sentinel = np.frombuffer(data_generator.generate(99, back.size).tobytes(),
                                         dtype=np.uint8)
                back[:] = sentinel
                await asyncio.sleep(0.3)
                np.testing.assert_array_equal(back, sentinel)
                assert counts(c) == (0, 0)
            finally:
                teardown.set()
                server.close()
                await server.wait_closed()
        finally:
            await cluster.stop()

    run_native(scenario())
