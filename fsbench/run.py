"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout:

    python3 fsbench/run.py --workload ec8_4-degraded-read --seed 7 --seconds 51 --trace 0

Set-up: build the program's CUDA and native libraries into the
checkout, start the cell's cluster (a master and its chunkservers, one
process each, data under ``TMPDIR``), connect this process as the mount
(one ``lizardfs_tpu_torch`` client on the card's encoder), then hand the
run to the mix's kind (``fsbench/kinds/<kind>.py``, named by the mix's
data file): its ``setup`` makes the inputs from ``--seed``, writes the
data set and warms up the mix's own shapes, its ``drive`` is the window
of ``--seconds``, and its ``check`` compares what the window produced
with the plain reference to decide ``correct``. The last line of
standard output is the result: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics (and the card's trace) with
``--trace 1``.

Without a card, or with fewer cards than the cell asks for, it exits 1
and prints no result; so it does if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (to 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fsbench import cluster as clustermod  # noqa: E402
from fsbench import controls, host, manifest, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lizardfs_tpu")
MARKER = "fsbench.clock_marker"


def forbidden_modules() -> list[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Window:
    """What a metric's reader gets: the window's requests and what the
    program, the operating system and the card counted over it."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Cell:
    """One run of one cell. What every cell shares lives here; what
    belongs to a kind of traffic lives in ``fsbench/kinds/<kind>.py``."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float,
                 trace_on: bool, device: str, control: str | None = None,
                 client_encoder: str | None = None, params: dict | None = None):
        self.bench = bench
        self.cell = manifest.workload(bench, cell)
        self.config = manifest.config(bench, self.cell["config"])
        self.params = params or manifest.traffic(self.cell["traffic"])
        self.kind = manifest.kind(self.params["kind"])
        self.seed, self.seconds, self.trace_on = int(seed), float(seconds), trace_on
        self.device = device
        self.control = control
        self.client_encoder = client_encoder
        self.requests: list[dict] = []
        self.spans = trace.Spans()
        self.checks: list[tuple[str, float, object]] = []
        self.notes: dict = {}

    # ---- set-up ---------------------------------------------------------

    def build(self) -> None:
        """The program's native libraries and CUDA kernels, built once
        into their fixed directory in the checkout before any daemon
        starts (the daemons then load them)."""
        from lizardfs_tpu_torch.chunkserver import native_serve  # noqa: F401
        from lizardfs_tpu_torch.client import native_client  # noqa: F401
        from lizardfs_tpu_torch.core import native_io  # noqa: F401

        if self.device != "cpu":
            from lizardfs_tpu_torch.ops import _build

            _build.build()

    def make_encoder(self):
        from lizardfs_tpu_torch.core.encoder import get_encoder

        enc = get_encoder(self.client_encoder)
        if self.control in controls.CONTROLS:
            enc = controls.BrokenEncoder(enc, self.control)
        if self.trace_on:
            enc = trace.TimedEncoder(enc)
        return enc

    async def connect(self) -> None:
        from lizardfs_tpu_torch.client.client import Client

        self.encoder = self.make_encoder()
        self.client = Client("127.0.0.1", self.cluster.master_port, encoder=self.encoder)
        await self.client.connect(info="fsbench")
        if self.control in controls.FAULTS:
            controls.wrap_client(self.client, self.control)
        attr = await self.client.mkdir(1, self.cell["name"])
        await self.client.setgoal(attr.inode, self.config["goal"]["id"])
        self.dir_inode = attr.inode

    # ---- after the window: the comparison with the reference -------------

    def check(self, name: str, value, limit) -> None:
        """One number compared: ``limit`` a maximum, or a ``[lo, hi]`` range."""
        self.checks.append((name, value, limit))

    def passed(self) -> bool:
        for _, v, lim in self.checks:
            lo, hi = (lim if isinstance(lim, list) else (None, lim))
            if (lo is not None and v < lo) or v > hi:
                return False
        return bool(self.checks)

    # ---- the whole run --------------------------------------------------

    async def run(self) -> dict:
        import torch

        stamps = self.notes.setdefault("setup_stamps_s", {})
        self.build()
        stamps["built"] = time.perf_counter() - T_START
        self.cluster = clustermod.Cluster(self.config)
        try:
            await self.cluster.start()
            stamps["cluster_up"] = time.perf_counter() - T_START
            await self.connect()
            stamps["mounted"] = time.perf_counter() - T_START
            await self.kind.setup(self)
            return await self._measure(torch)
        finally:
            try:
                await self.client.close()
            except Exception:
                pass
            self.disk = self.cluster.disk_writes()
            self.cluster.stop()

    async def _measure(self, torch) -> dict:
        from lizardfs_tpu_torch.ops import cuda_ec
        from lizardfs_tpu_torch.runtime.metrics import phase_delta

        c = self.client
        on_card = self.device != "cpu"
        if on_card:
            # the peak the result reports is the window's own: what set-up
            # made and freed (the input pool's temporaries) is left out
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if self.trace_on and on_card:
            from torch.profiler import ProfilerActivity, profile, record_function

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            marker_t = time.perf_counter()
            with record_function(MARKER):
                pass
        wp0, rp0 = c.write_phases.snapshot(), c.read_phases.snapshot()
        cpu0 = self.cluster.cpu()
        threads0 = host.thread_cpu_seconds()
        launches0 = dict(cuda_ec.LAUNCHES)
        t0 = time.perf_counter()
        self.setup_s = t0 - T_START
        await self.kind.drive(self, t0)
        t1 = t0 + self.seconds
        if on_card:
            torch.cuda.synchronize()
        cpu1 = self.cluster.cpu()
        self.notes["mount_threads_cpu_s"] = host.threads_delta(host.thread_cpu_seconds(), threads0)
        self.notes["daemons_cpu_s"] = host.by_role({n: cpu1[n] - cpu0[n] for n in cpu1 if n in cpu0})
        self.notes["host_probe_ms"] = host.probe_ms()
        wp1, rp1 = c.write_phases.snapshot(), c.read_phases.snapshot()
        launches = {k: v - launches0.get(k, 0) for k, v in cuda_ec.LAUNCHES.items()}
        device = None
        if prof is not None:
            prof.__exit__(None, None, None)
            offset = trace.clock_offset(prof, MARKER, marker_t)
            events = trace.profiler_events(prof, offset)
            spans = [(n, a, b) for n, a, b in self.spans.items]
            spans += [(f"seam.{s.op}", s.t0, s.t1) for s in getattr(self.encoder, "calls", [])]
            spans.sort(key=lambda s: s[2] - s[1], reverse=True)
            device = trace.device_summary(events, t0, t1, spans)
            device["launches"] = launches
        self.memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
        self.window = Window(
            cell=self.cell["name"], params=self.params, config=self.config,
            seconds=self.seconds, t0=t0, t1=t1, requests=self.requests,
            write_phases=phase_delta(wp1, wp0), read_phases=phase_delta(rp1, rp0),
            seam=self.encoder.between(t0, t1) if self.trace_on else None,
            spans=self.spans, cpu={n: cpu1[n] - cpu0[n] for n in cpu1 if n in cpu0},
            device=device, launches=launches, kind=self.device_kind(),
        )
        await self.kind.check(self)
        return self.window.__dict__

    def device_kind(self) -> str:
        if self.device == "cpu":
            return "cpu"
        import torch

        return torch.cuda.get_device_name(0)

    # ---- the result -----------------------------------------------------

    def metrics(self) -> dict:
        entries = (manifest.per_layer if self.trace_on else manifest.end_to_end)(
            self.bench, self.cell["name"])
        out = {}
        for m in entries:
            if m["name"] == "setup_s":
                value = self.setup_s
            else:
                value = manifest.reader(m["name"])(self.window)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out

    def result(self) -> dict:
        reqs = self.requests
        res = {
            "correct": self.passed(),
            "attempted": len(reqs),
            "failed": sum(1 for r in reqs if not r["ok"]),
            "metrics": self.metrics(),
            "device": {"platform": "gpu" if self.device != "cpu" else "cpu",
                       "kind": self.device_kind(), "count": int(self.cell["chips"]),
                       "memory_peak_bytes": self.memory_peak},
        }
        dev = self.window.device
        if self.trace_on and dev is not None:
            res["device"]["busy_s"] = dev["busy_s"]
            res["device"]["window_s"] = dev["window_s"]
            res["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
        res["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in self.checks}
        return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=controls.CONTROLS + controls.FAULTS,
                    help="put a control or fault in the program's place (never in "
                         "a measured run)")
    args = ap.parse_args(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"fsbench: the cell needs {cell['chips']} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    run = Cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
               device="cuda", control=args.control)
    asyncio.run(run.run())
    bad = forbidden_modules()
    if bad:
        log(f"fsbench: modules of JAX or the JAX package were loaded: {bad}")
        return 1
    res = run.result()
    lat = [r["end"] - r["t_due"] for r in run.requests if r["ok"]]
    end = run.window.t1
    print(json.dumps({
        "fsbench": run.cell["name"], "seed": args.seed, "trace": args.trace,
        "control": args.control, "setup_s": run.setup_s,
        "disk_write_bytes": run.disk["write_bytes"], "disk_wchar_bytes": run.disk["wchar"],
        "latency_p50_ms": 1e3 * trace.percentile(lat, 50) if lat else None,
        "latency_p95_ms": 1e3 * trace.percentile(lat, 95) if lat else None,
        "drain_s": max([r["end"] for r in run.requests if r["ok"]] + [end]) - end,
        "read_phases": run.window.read_phases,
        **run.notes, **host.card_info(),
        **({"launches": run.window.launches, "kernel_records": run.window.device["kernels"]}
           if run.window.device else {}),
    }), flush=True)
    for name, v, lim in run.checks:
        log(f"check {name} = {v} (limit {lim})")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
