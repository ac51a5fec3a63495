"""What a traced run records beside the program: the host time of each
recovery through the encoder seam (a proxy around the client's encoder), and
the card's activity from ``torch.profiler``, reduced to busy time, the
port's kernels, the device operations that took most time and the longest
idle gaps with what the mount was doing in them.
"""

from __future__ import annotations

import re
import threading
import time

import numpy as np

from fsbench import roofline

# the port's kernels as a profiler trace names them (ops/csrc/ec_kernels.cu)
PORT_KERNELS = ("block_crc_kernel", "crc_fold_kernel", "fused_encode_crc_kernel",
                "gf_apply_kernel")


def port_kernel(name: str) -> str | None:
    """The port kernel a trace's name is of: a trace gives the demangled
    signature, ``void (anonymous namespace)::gf_apply_kernel<true>(...)``."""
    for word in re.findall(r"[A-Za-z_]\w*", name.split("<", 1)[0]):
        if word in PORT_KERNELS:
            return word
    return None


def _rows(parts) -> tuple[int, int]:
    """(row bytes, rows not elided as zeros) of a list of parts."""
    present = [p for p in parts if p is not None]
    return (len(present[0]) if present else 0), len(present)


class SeamCall:
    __slots__ = ("op", "t0", "t1", "in_bytes", "work_bytes")

    def __init__(self, op, t0, t1, in_bytes, work_bytes):
        self.op, self.t0, self.t1 = op, t0, t1
        self.in_bytes, self.work_bytes = in_bytes, work_bytes


class TimedEncoder:
    """The client's encoder with each ``recover`` call's host time recorded
    (on the ``time.perf_counter`` clock) with its input bytes and the bytes
    its work needs (:mod:`fsbench.roofline`). Everything else passes
    through."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: list[SeamCall] = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _note(self, op, t0, in_bytes, work_bytes):
        call = SeamCall(op, t0, time.perf_counter(), in_bytes, work_bytes)
        with self._lock:
            self.calls.append(call)

    def recover(self, k, m, parts, wanted):
        n, rows = _rows(list(parts.values()))
        t0 = time.perf_counter()
        out = self._inner.recover(k, m, parts, wanted)
        self._note("recover", t0, n * rows,
                   roofline.recover_bytes(k, rows, len(wanted), n))
        return out

    def between(self, t0: float, t1: float) -> list[SeamCall]:
        with self._lock:
            return [c for c in self.calls if t0 <= c.t0 and c.t1 <= t1]


class Spans:
    """The benchmark's spans around its calls into the program
    (``time.perf_counter``): name, start, end."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def device_summary(events, t0: float, t1: float, host_spans=()) -> dict:
    """Reduce the card's events of a profile to the stretch ``[t0, t1]``
    (seconds on the host's ``perf_counter``).

    ``events``: (name, start_s, end_s) of every kernel, copy and set on the
    card, already on the host's clock. ``host_spans``: (name, start, end)
    of what the mount was doing, most specific last. Returns busy seconds
    (the union of the events), each port kernel's records and seconds, the
    ten device operations that took most time and the ten longest idle
    gaps, each named by the host span that covers its middle."""
    clipped = [(n, max(a, t0), min(b, t1)) for n, a, b in events if b > t0 and a < t1]
    busy = _union([(a, b) for _, a, b in clipped])
    busy_s = sum(b - a for a, b in busy)
    by_name: dict[str, float] = {}
    for n, a, b in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    kernels: dict[str, list] = {}
    for n, a, b in clipped:
        k = port_kernel(n)
        if k is not None:
            rec = kernels.setdefault(k, [0, 0.0])
            rec[0] += 1
            rec[1] += b - a
    gaps = []
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        label = "no request in flight"
        for name, s0, s1 in host_spans:
            if s0 <= mid <= s1:
                label = name
        named.append([f"{label} ({a - t0:.3f} s into the window)", b - a])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": t1 - t0,
        "kernels": kernels,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": named,
    }


def profiler_events(prof, offset_s: float) -> list[tuple[str, float, float]]:
    """(name, start, end) of every event the profiler saw on the card,
    moved onto the host's ``perf_counter`` clock by ``offset_s``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start / 1e6 + offset_s,
                        e.time_range.end / 1e6 + offset_s))
    return out


def clock_offset(prof, marker: str, host_t: float) -> float:
    """The offset that moves the profiler's times onto ``perf_counter``:
    ``marker`` is a CPU op's name recorded at ``host_t`` on the host."""
    starts = [e.time_range.start for e in prof.events() if e.name == marker]
    if not starts:
        raise RuntimeError(f"profiler trace holds no {marker!r} marker")
    return host_t - min(starts) / 1e6


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile; ``inf`` counts as missing
    every limit."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if not len(v):
        return float("nan")
    return float(v[max(int(np.ceil(q / 100.0 * len(v))) - 1, 0)])
