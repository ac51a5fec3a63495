"""The port's read-path timing on the CPU: the off-loop hop
(``core/native_io.py`` ``Hop``) and its four ``perf_counter`` stamps, the
encoder seam's ``seam_stage``/``seam_sync`` charges, the span clock and
the ``trace-dump`` anchor, the attribution buckets of the new span names,
and the dominant read phase of ``lizardfs-admin top`` and the web UI.

A hop's phase (``net``, ``gather``) runs from its submission on the loop
to the awaiting coroutine's resume, and its ``_queue``, ``_run`` and
``_resume`` parts partition that interval. The real read path's hops,
on a native-plane cluster, are checked in
``tests/test_torch_native_fast_paths.py``.
"""

import asyncio
import contextvars
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from lizardfs_tpu_torch.core import native_io
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.runtime import accounting, tracing
from lizardfs_tpu_torch.runtime.daemon import Daemon
from lizardfs_tpu_torch.runtime.metrics import PhaseBreakdown
from lizardfs_tpu_torch.tools import admin_cli, webui


class Sink:
    """A read-phase sink that keeps every charge, in order."""

    def __init__(self):
        self.charges: list[tuple[str, float, float]] = []

    def __call__(self, phase, t0, t1):
        self.charges.append((phase, t0, t1))

    def seconds(self, phase: str) -> list[float]:
        return [t1 - t0 for p, t0, t1 in self.charges if p == phase]


def hops(charges, phase: str) -> list[dict]:
    """Each hop's four charges (the phase, then its three parts)."""
    out = []
    for i, (p, _, _) in enumerate(charges):
        if p == f"{phase}_queue":
            whole, parts = charges[i - 1], charges[i : i + 3]
            assert whole[0] == phase
            assert [q[0] for q in parts] == [f"{phase}_{x}" for x in tracing.HOP_PARTS]
            out.append({"whole": whole[2] - whole[1],
                        **{x: q[2] - q[1] for x, q in zip(tracing.HOP_PARTS, parts)}})
    return out


def under_sink(sink, coro_fn):
    async def main():
        tok = tracing.PHASE_SINK.set(sink)
        try:
            return await coro_fn()
        finally:
            tracing.PHASE_SINK.reset(tok)

    return asyncio.run(main())


def test_second_hop_queues_behind_the_first():
    """One executor thread, two hops: the second waits in the queue at
    least as long as the first runs."""
    sink = Sink()
    pool = ThreadPoolExecutor(max_workers=1)
    gate = threading.Event()

    async def scenario():
        # the thread is held until both hops are submitted
        held = asyncio.get_running_loop().run_in_executor(pool, gate.wait)
        first = native_io.Hop(pool, time.sleep, 0.03)
        second = native_io.Hop(pool, time.sleep, 0.01)
        gate.set()
        await held
        await first.future
        first.charge("net")
        await second.future
        second.charge("net")

    try:
        under_sink(sink, scenario)
    finally:
        pool.shutdown()
    first, second = hops(sink.charges, "net")
    assert first["run"] >= 0.03
    assert second["queue"] >= first["run"]


def test_blocked_loop_counts_as_resume():
    """A loop callback that blocks for 50 ms after the hop returned puts
    at least that much into the hop's resume part."""
    sink = Sink()
    pool = ThreadPoolExecutor(max_workers=1)

    async def scenario():
        hop = native_io.Hop(pool, int, 7)

        def block():
            while not hop.returned:
                time.sleep(0.0005)
            time.sleep(0.05)

        asyncio.get_running_loop().call_soon(block)
        assert await hop.future == 7
        hop.charge("net")

    try:
        under_sink(sink, scenario)
    finally:
        pool.shutdown()
    (hop,) = hops(sink.charges, "net")
    assert hop["resume"] >= 0.05
    assert hop["resume"] > hop["queue"] + hop["run"]


def test_hop_parts_partition_the_phase():
    """Many concurrent hops of both phases on a small pool: each hop's
    parts sum to its phase's charge within 1%, and none is negative."""
    sink = Sink()
    pool = ThreadPoolExecutor(max_workers=3)

    async def scenario():
        await asyncio.gather(*(
            native_io.run_hop(phase, pool, time.sleep, 0.002 * (i % 4))
            for i in range(24) for phase in ("net", "gather")))

    try:
        under_sink(sink, scenario)
    finally:
        pool.shutdown()
    for phase in ("net", "gather"):
        got = hops(sink.charges, phase)
        assert len(got) == 24
        for h in got:
            assert min(h["queue"], h["run"], h["resume"]) >= 0
            parts = h["queue"] + h["run"] + h["resume"]
            assert parts == pytest.approx(h["whole"], rel=0.01)


def test_hop_carries_trace_and_session_into_the_thread():
    """The trace id and wire session of the calling task reach the
    worker thread for the call, and leave it afterwards."""
    seen = []

    def probe():
        seen.append(native_io._thread_trace_id())

    async def scenario():
        tid = tracing.start_trace()
        with accounting.task_session(5):
            await native_io.run(probe)
        tracing.clear_trace()
        await native_io.run(probe)
        return tid

    was = tracing.enabled()
    tracing.set_enabled(True)
    try:
        tid = asyncio.run(scenario())
    finally:
        tracing.set_enabled(was)
    assert seen == [tid, 0] and tid


def test_hop_charges_nothing_without_a_sink():
    async def scenario():
        assert await native_io.run_hop("gather", None, sum, [1, 2]) == 3

    asyncio.run(scenario())  # no sink: nothing to charge, nothing raised


def test_partial_with_trace_is_gone():
    assert not hasattr(native_io, "partial_with_trace")
    assert not hasattr(tracing, "ensure_trace")


# --- the encoder seam ---------------------------------------------------------------


def recover_once(enc):
    k, m_, n = 4, 2, 4096
    rng = np.random.default_rng(11)
    data = [rng.integers(0, 256, n, dtype=np.uint8) for _ in range(k)]
    parity = enc.encode(k, m_, data)
    parts = {i: data[i] for i in range(1, k)}
    parts.update({k + j: parity[j] for j in range(m_)})
    out = enc.recover(k, m_, parts, [0])
    assert np.array_equal(out[0], data[0])


def test_encoder_charges_seam_phases_into_a_sink():
    sink = Sink()
    enc = CudaChunkEncoder(device="cpu")
    tok = tracing.PHASE_SINK.set(sink)
    try:
        recover_once(enc)
    finally:
        tracing.PHASE_SINK.reset(tok)
    # encode and recover each stage once and fetch once
    assert len(sink.seconds("seam_stage")) == 2
    assert len(sink.seconds("seam_sync")) == 2
    assert {p for p, _, _ in sink.charges} == {"seam_stage", "seam_sync"}
    assert all(t1 >= t0 for _, t0, t1 in sink.charges)


def test_encoder_charges_nothing_without_a_sink(monkeypatch):
    """Outside a read each stage and fetch still asks for a sink, finds
    none, and charges nothing (a sink in another context stays empty)."""
    asked, sink = [], Sink()
    charge = tracing.charge_phase
    monkeypatch.setattr(tracing, "charge_phase",
                        lambda phase, t0: (asked.append(phase), charge(phase, t0)))
    contextvars.copy_context().run(tracing.PHASE_SINK.set, sink)
    assert tracing.PHASE_SINK.get() is None
    recover_once(CudaChunkEncoder(device="cpu"))
    assert asked == ["seam_stage", "seam_sync"] * 2
    assert sink.charges == []


def test_seam_phases_land_in_a_read_breakdown():
    phases = PhaseBreakdown("client_read", tracing.READ_PHASES + tracing.READ_SUBPHASES)
    tok = tracing.PHASE_SINK.set(lambda p, t0, t1: phases.add(p, t1 - t0))
    try:
        recover_once(CudaChunkEncoder(device="cpu"))
    finally:
        tracing.PHASE_SINK.reset(tok)
    snap = phases.snapshot()
    assert {"seam_stage_ms", "seam_sync_ms", "net_queue_ms", "gather_resume_ms"} <= set(snap)
    assert snap["seam_sync_ms"] >= 0 and snap["decode_ms"] == 0


# --- one clock ----------------------------------------------------------------------


def test_spans_on_perf_counter_and_dump_anchor_converts():
    """Spans recorded inside a ``perf_counter`` interval fall within it;
    a ``trace-dump`` reply's anchor moves them to within 50 ms of the
    epoch clock."""
    was = tracing.enabled()
    tracing.set_enabled(True)

    async def scenario():
        d = Daemon()
        tid = tracing.start_trace()
        lo, wall = time.perf_counter(), time.time()
        with d.trace_ring.span("probe", role="daemon"):
            time.sleep(0.01)
        tracing.charge_queue_wait(None, d.trace_ring, "gate", "t", lo, role="daemon")
        hi = time.perf_counter()
        tracing.clear_trace()
        reply = d.handle_admin_basics(m.AdminCommand(
            req_id=1, command="trace-dump", json=json.dumps({"trace_id": tid})))
        return lo, hi, wall, json.loads(reply.json)

    try:
        lo, hi, wall, doc = asyncio.run(scenario())
    finally:
        tracing.set_enabled(was)
    spans = doc["spans"]
    assert {s["name"] for s in spans} == {"probe", "queue_wait:gate"}
    for s in spans:
        assert lo <= s["t0"] <= s["t1"] <= hi
    epoch = tracing.to_epoch(spans, doc["anchor"])
    for s, e in zip(spans, epoch):
        assert abs(e["t0"] - (wall + s["t0"] - lo)) < 0.05
        # epoch seconds keep about a microsecond in a double
        assert e["t1"] - e["t0"] == pytest.approx(s["t1"] - s["t0"], abs=1e-6)
    assert abs(epoch[0]["t0"] - time.time()) < 5.0


def test_span_ids_are_distinct_and_nonzero():
    ids = {tracing.new_id() for _ in range(10000)}
    assert len(ids) == 10000 and 0 not in ids
    assert all(i & 1 and i < 1 << 63 for i in ids)


# --- attribution of the new span names ----------------------------------------------


@pytest.mark.parametrize("name,bucket", [
    ("read:net_queue", "queue"), ("read:gather_queue", "queue"),
    ("read:net_resume", "queue"), ("read:gather_resume", "queue"),
    ("read:net_run", "net"), ("read:gather_run", "compute"),
    ("read:seam_stage", "compute"), ("read:seam_sync", "compute"),
    ("read:fanin_fallback", "net"),
    # the whole phases keep their buckets
    ("read:net", "net"), ("read:gather", "compute"), ("read:decode", "compute"),
])
def test_bucket_rules_know_the_parts(name, bucket):
    assert tracing.classify_segment(name) == bucket


def test_attribution_splits_a_hop_into_its_parts():
    """A ``read:net`` hop whose queue and resume parts are spans of their
    own: the parts go to the queue bucket, the rest of the hop to net."""
    spans = [
        {"trace_id": 1, "role": "client", "name": "read_file", "t0": 0.0, "t1": 0.010},
        {"trace_id": 1, "role": "client", "name": "read:net", "t0": 0.0, "t1": 0.010},
        {"trace_id": 1, "role": "client", "name": "read:net_queue", "t0": 0.0, "t1": 0.002},
        {"trace_id": 1, "role": "client", "name": "read:net_run", "t0": 0.002, "t1": 0.007},
        {"trace_id": 1, "role": "client", "name": "read:net_resume", "t0": 0.007, "t1": 0.010},
    ]
    attr = tracing.attribute_timeline(tracing.merge_timeline(spans, 1, wall_name="read_file"))
    assert attr["buckets_ms"]["queue"] == pytest.approx(5.0)
    assert attr["buckets_ms"]["net"] == pytest.approx(5.0)
    assert sum(attr["buckets_ms"].values()) == pytest.approx(attr["wall_ms"])


# --- the dominant read phase --------------------------------------------------------


def session_with_phases() -> dict:
    """A `top` entry whose read phases have a sub-phase larger than any
    top-level phase (a hop's resume inside ``gather``)."""
    phases = {f"{p}_ms": 0.0 for p in tracing.READ_PHASES + tracing.READ_SUBPHASES}
    phases.update(net_ms=40.0, gather_ms=90.0, gather_resume_ms=85.0,
                  seam_sync_ms=5.0, wall_ms=150.0, reps=3)
    return phases


def top_doc(phases: dict) -> dict:
    return {"sessions": {"s1": {"info": "mount", "read_phases": phases}}}


def test_top_ranks_only_the_top_level_phases(capsys):
    admin_cli._print_top(top_doc(session_with_phases()))
    (line,) = [x for x in capsys.readouterr().out.splitlines() if "read phases" in x]
    assert "dominant gather" in line
    assert "gather_resume" not in line and "seam_sync" not in line


class Page(webui.Dashboard):
    """The web UI's page over fixed replies instead of a master."""

    def __init__(self, phases):
        self.phases = phases

    def info(self):
        return {"chunkservers": []}

    def health(self):
        return {}

    def rebuild_status(self):
        return {}

    def top(self):
        return top_doc(self.phases)

    def metrics(self, resolution="sec"):
        return {}

    def cs_metrics_all(self, addrs, resolution="sec"):
        return []


def test_webui_ranks_only_the_top_level_phases():
    page = Page(session_with_phases()).render()
    assert "<td>gather 90ms</td>" in page
    assert "gather_resume" not in page


# --- the benchmark's readers of these phases ----------------------------------------

# each new per-layer metric and the read_phases keys it sums
READERS = {
    "client.read_queue_ms_per_MiB": ("net_queue", "gather_queue"),
    "client.read_resume_ms_per_MiB": ("net_resume", "gather_resume"),
    "client.read_exchange_ms_per_MiB": ("net_run",),
    "client.read_gather_run_ms_per_MiB": ("gather_run",),
    "seam.recover_stage_ms_per_MiB": ("seam_stage",),
    "seam.recover_sync_ms_per_MiB": ("seam_sync",),
    "client.read_fanin_fallback_ms_per_MiB": ("fanin_fallback",),
}


def window(phases: dict, sizes: list[int]):
    from fsbench.run import Window

    reqs = [{"op": "read", "ok": True, "size": n, "end": 1.0} for n in sizes]
    reqs.append({"op": "read", "ok": False, "size": 1 << 30, "end": 1.0})
    return Window(read_phases=phases, requests=reqs, t1=2.0, seconds=2.0)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_benchmark_reader(metric):
    from fsbench import manifest

    read = manifest.reader(metric)
    names = tracing.READ_PHASES + tracing.READ_SUBPHASES
    phases = {f"{p}_ms": 10.0 * (i + 1) for i, p in enumerate(names)}
    phases.update(wall_ms=1e4, reps=5)
    want = sum(phases[f"{p}_ms"] for p in READERS[metric]) / 4.0
    # 4 MiB read in two requests; the failed one does not count
    assert read(window(phases, [3 << 20, 1 << 20])) == pytest.approx(want)
    assert read(window(phases, [])) is None
    # a program without the sub-phases (the tree before them) reads nothing
    old = {f"{p}_ms": 1.0 for p in tracing.READ_PHASES}
    assert read(window(old, [1 << 20])) is None
    entry = next(e for e in manifest.load()["per_layer"] if e["name"] == metric)
    assert entry["source"] == "program_span" and entry["moves"] == "read_MiBps"
