"""Helpers the metric readers share: each reader under ``metrics/`` is a
``read(window)`` that returns a number or None (nothing to read)."""

from __future__ import annotations

from fsbench import roofline

MiB = float(1 << 20)
GiB = float(1 << 30)


def bytes_done(w, op: str, in_window: bool = False) -> int:
    """User bytes of the ``op`` requests that succeeded (that ended inside
    the window, where ``in_window``)."""
    return sum(r["size"] for r in w.requests
               if r["op"] == op and r["ok"] and (not in_window or r["end"] <= w.t1))


def per_mib(ms: float, nbytes: int) -> float | None:
    return ms / (nbytes / MiB) if nbytes else None


def seam_ms_per_mib(w, op: str, nbytes: int) -> float | None:
    if w.seam is None:
        return None
    calls = [c for c in w.seam if c.op == op]
    if not calls:
        return None
    return per_mib(1e3 * sum(c.t1 - c.t0 for c in calls), nbytes)


def roofline_pct(w, op: str) -> float | None:
    """The least time of the window's ``op`` calls through the seam (their
    bytes over the card's peak rate) as a share of the device time of the
    GF apply kernel launched for them (the only port kernel a recovery
    launches). Where the trace holds fewer of its records than launches,
    the time is scaled by the mean time a record."""
    if w.seam is None or w.device is None:
        return None
    calls = [c for c in w.seam if c.op == op]
    others = [c for c in w.seam if c.op != op]
    records, seconds = w.device["kernels"].get("gf_apply_kernel", (0, 0.0))
    if not calls or others or not records:
        return None
    kernel_s = seconds * max(w.launches["encode"], records) / records
    bound = roofline.bound_s(sum(c.work_bytes for c in calls), w.kind)
    return 100.0 * bound / kernel_s


def idle_pct(w) -> float | None:
    if w.device is None:
        return None
    return 100.0 * (1.0 - w.device["busy_s"] / w.device["window_s"])


def cpu_s(w, prefix: str) -> float:
    return sum(v for n, v in w.cpu.items() if n.startswith(prefix))
