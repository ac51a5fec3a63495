"""Request-scoped distributed tracing across the three roles.

The reference ships per-daemon charts and an oplog but nothing
request-scoped; closing a cross-process throughput gap (the ec(8,4)
write target) needs attribution past the client boundary. This module
is the L0 piece: trace ids, span records, a bounded per-process span
ring (oplog-style), and the client-side timeline merge.

Propagation:
  * master RPCs carry the trace id as a skew-tolerant TRAILING field on
    the wire messages (proto/messages.py ``trace_id``; the codec
    default-fills missing trailing fields, so a peer predating the
    field still decodes — version-skew pinned in tests/test_tracing.py),
  * the native data plane carries it as an OPTIONAL trailing u64 on
    request frames (native/wire.h "trace propagation" contract); the
    C++ server records per-op receive/disk/send timestamps into its own
    ring, drained into the chunkserver's SpanRing
    (chunkserver/server.py trace_spans).

Each daemon's ring is dumped over the admin link
(``lizardfs-admin <addr> trace-dump``) and merged client-side with
:func:`merge_timeline` into a per-request timeline, so one ec(8,4)
write rep decomposes into client encode/stage/send, chunkserver
recv/disk-commit, and ack segments across processes.

Cost contract: with ``LZ_TRACE=0`` no ids are issued,
``current_trace_id()`` is 0 everywhere, and every record path is a
single falsy check — the acceptance bound is <1% on the ec(8,4) write
row.

Clocks: spans carry CLOCK_REALTIME epoch seconds (C side: microseconds
via clock_gettime) so same-host cross-process merges line up; durations
inside one process stay monotonic-accurate at the span granularity
(tens of microseconds and up) this subsystem targets.
"""

from __future__ import annotations

import contextvars
import secrets
import time
from collections import deque

# process-wide kill switch: LZ_TRACE=0 disables issuing trace ids, which
# short-circuits every record path (spans are only recorded for nonzero
# trace ids)
from lizardfs_tpu_torch.constants import env_flag

_ENABLED = env_flag("LZ_TRACE")

# (trace_id, parent_span_id) of the request this task is serving
CURRENT: contextvars.ContextVar[tuple[int, int] | None] = (
    contextvars.ContextVar("lz_trace", default=None)
)


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Test/ops hook mirroring the LZ_TRACE env gate."""
    global _ENABLED
    _ENABLED = bool(on)


def new_id() -> int:
    # 63-bit nonzero: fits i64/u64 everywhere, 0 stays "untraced"
    return secrets.randbits(63) | 1


def current_trace_id() -> int:
    cur = CURRENT.get()
    return cur[0] if cur is not None else 0


def start_trace() -> int:
    """Begin a new trace in this task's context; returns the trace id
    (0 when tracing is disabled — callers pass it through untouched)."""
    if not _ENABLED:
        return 0
    tid = new_id()
    CURRENT.set((tid, 0))
    return tid


def ensure_trace() -> int:
    """Current trace id, starting a fresh trace if none is active."""
    tid = current_trace_id()
    return tid if tid else start_trace()


def begin() -> tuple[int, bool]:
    """Join the active trace or start a fresh one.

    Returns ``(trace_id, started)``; pass ``started`` to :func:`end`
    when the operation finishes so an op that STARTED its trace clears
    the context again — otherwise every later top-level op in the same
    task would silently reuse the first op's id and merge unrelated
    requests into one timeline."""
    tid = current_trace_id()
    if tid:
        return tid, False
    return start_trace(), True


def end(started: bool) -> None:
    if started:
        clear_trace()


def adopt_trace(tid: int) -> None:
    """Join an existing trace whose id arrived on the wire (e.g. the
    RebuildEngine's per-rebuild id riding MatocsReplicate) so every
    downstream op in this task propagates it."""
    if _ENABLED and tid:
        CURRENT.set((tid, 0))


def clear_trace() -> None:
    CURRENT.set(None)


class SpanRing:
    """Bounded in-memory span ring, one per daemon/client (the oplog
    model applied to spans). Records are plain dicts so dumps are
    JSON-ready for the admin link.

    ``dropped`` counts spans evicted by the bound — observability of
    the observability layer: silent trace loss under load would
    otherwise read as "the op recorded nothing". Daemons mirror it
    into their registry as ``span_ring_dropped`` so it rides
    ``/metrics`` (``lizardfs_span_ring_dropped_total``)."""

    def __init__(self, maxlen: int = 2048):
        self._ring: deque = deque(maxlen=maxlen)
        self.dropped = 0
        self._drop_counter = None  # optional Metrics counter mirror

    def attach_drop_counter(self, counter) -> None:
        """Mirror evictions into a ``Metrics`` counter (daemon wiring);
        evictions that predate the attach are folded in once."""
        self._drop_counter = counter
        if self.dropped > counter.total:
            counter.inc(self.dropped - counter.total)

    def record(
        self,
        trace_id: int,
        name: str,
        t0: float,
        t1: float,
        role: str = "",
        parent_id: int = 0,
        **attrs,
    ) -> int:
        """Record one finished span; no-op (returns 0) for trace id 0,
        which is what every call site passes when tracing is off."""
        if not trace_id:
            return 0
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
            if self._drop_counter is not None:
                self._drop_counter.inc()
        span_id = new_id()
        rec = {
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent_id,
            "role": role,
            "name": name,
            "t0": t0,
            "t1": t1,
        }
        if attrs:
            rec["attrs"] = attrs
        self._ring.append(rec)
        return span_id

    def span(self, name: str, role: str = "", trace_id: int | None = None):
        """Context manager timing a block into the ring (sync code)."""
        return _SpanCtx(self, name, role, trace_id)

    def dump(self, trace_id: int | None = None) -> list[dict]:
        if trace_id:
            return [s for s in self._ring if s["trace_id"] == trace_id]
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


class _SpanCtx:
    __slots__ = ("ring", "name", "role", "trace_id", "t0")

    def __init__(self, ring, name, role, trace_id):
        self.ring = ring
        self.name = name
        self.role = role
        self.trace_id = (
            trace_id if trace_id is not None else current_trace_id()
        )

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.ring.record(
            self.trace_id, self.name, self.t0, time.time(), role=self.role
        )
        return False


def _union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [t0, t1] intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def merge_timeline(
    spans: list[dict], trace_id: int | None = None,
    wall_name: str | None = None,
) -> dict:
    """Merge spans (from any number of role rings) into one per-request
    timeline.

    ``wall_name`` names the root span whose [t0, t1] is the rep's wall
    time; it is EXCLUDED from coverage (a root span trivially covers
    100%) — coverage is the union of the remaining segments over the
    wall, the honest "how much of the rep can we attribute" number.
    Without a matching root the wall is the overall span envelope.
    """
    if trace_id:
        spans = [s for s in spans if s["trace_id"] == trace_id]
    if not spans:
        return {"trace_id": trace_id or 0, "segments": [],
                "wall_ms": 0.0, "coverage_pct": 0.0, "by_role_ms": {}}
    root = None
    if wall_name is not None:
        for s in spans:
            if s["name"] == wall_name and (
                root is None or s["t1"] - s["t0"] > root["t1"] - root["t0"]
            ):
                root = s
    segs = [s for s in spans if s is not root]
    t_lo = root["t0"] if root else min(s["t0"] for s in spans)
    t_hi = root["t1"] if root else max(s["t1"] for s in spans)
    wall = max(t_hi - t_lo, 1e-9)
    covered = _union_seconds(
        [(max(s["t0"], t_lo), min(s["t1"], t_hi)) for s in segs
         if s["t1"] > t_lo and s["t0"] < t_hi]
    )
    by_role: dict[str, float] = {}
    segments = []
    for s in sorted(segs, key=lambda x: (x["t0"], x["t1"])):
        dur = s["t1"] - s["t0"]
        by_role[s["role"]] = by_role.get(s["role"], 0.0) + dur
        segments.append({
            "role": s["role"], "name": s["name"],
            "start_ms": round((s["t0"] - t_lo) * 1e3, 3),
            "dur_ms": round(dur * 1e3, 3),
            **({"attrs": s["attrs"]} if "attrs" in s else {}),
        })
    return {
        "trace_id": spans[0]["trace_id"],
        "wall_ms": round(wall * 1e3, 3),
        "coverage_pct": round(100.0 * covered / wall, 1),
        "by_role_ms": {
            r: round(v * 1e3, 3) for r, v in sorted(by_role.items())
        },
        "segments": segments,
    }


def format_timeline(timeline: dict) -> str:
    """Human-readable one-line-per-segment rendering (admin CLI)."""
    lines = [
        # 0x prefix: an all-digit bare hex id would reparse as decimal
        f"trace 0x{timeline.get('trace_id', 0):x}  "
        f"wall {timeline.get('wall_ms', 0.0):.2f} ms  "
        f"coverage {timeline.get('coverage_pct', 0.0):.1f}%"
    ]
    for seg in timeline.get("segments", ()):
        lines.append(
            f"  {seg['start_ms']:>10.3f} ms  +{seg['dur_ms']:<10.3f} "
            f"{seg['role']:<12s} {seg['name']}"
        )
    return "\n".join(lines)


# --- read-phase sink ---------------------------------------------------------
#
# The client activates a sink around each LOGICAL read (read_file /
# read_file_into); deep layers that have no client reference — the
# connection pool's dial, the read executor's socket waits and plan
# postprocess — charge busy-time into whatever sink is ambient. A
# contextvar (not a global) keeps concurrent clients in one process
# (in-process test clusters, gateways) from cross-charging; asyncio
# tasks and to_thread propagate it, run_in_executor does not (native
# executor hops are therefore timed at the await site instead).

PHASE_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "lz_read_phase_sink", default=None
)


def phase_t0() -> tuple[float, float]:
    """(perf_counter, wall) anchor for :func:`charge_phase` — durations
    stay monotonic-accurate while span endpoints stay epoch-aligned."""
    return (time.perf_counter(), time.time())


def charge_phase(phase: str, t0: tuple[float, float]) -> None:
    """Charge [t0, now] to ``phase`` on the ambient read-phase sink;
    free (one contextvar get) when no logical read is in flight."""
    sink = PHASE_SINK.get()
    if sink is not None:
        sink(phase, t0, (time.perf_counter(), time.time()))


def charge_queue_wait(
    metrics, ring, gate: str, tenant: str, t0: tuple[float, float],
    *, role: str = "", trace_id: int | None = None,
) -> float:
    """Charge one finished queue wait: a ``queue_wait{gate,tenant}``
    labeled timing on the owning component's registry plus a
    ``queue_wait:<gate>`` span on its ring (attribution's queue
    bucket). Explicit registry/ring arguments — in-process clusters run
    master + chunkservers + clients in one interpreter, so a
    process-global sink would misattribute the wait. Returns the
    seconds charged."""
    seconds = max(time.perf_counter() - t0[0], 0.0)
    tid = current_trace_id() if trace_id is None else trace_id
    if metrics is not None:
        metrics.labeled_timing(
            "queue_wait", {"gate": gate, "tenant": tenant or "default"},
            help="time ops spent waiting at an admission/credit gate "
                 "(DRR disk gate, write-window credits, shed retries, "
                 "connection dials) before doing any work",
        ).record(seconds, trace_id=tid)
    if ring is not None and tid:
        ring.record(
            tid, f"queue_wait:{gate}", t0[1], t0[1] + seconds,
            role=role, gate=gate,
        )
    return seconds


# --- latency attribution -----------------------------------------------------

ATTRIBUTION_BUCKETS = ("queue", "disk", "net", "compute", "unattributed")

# substring -> bucket, FIRST match wins (specific names before generic
# ones: "read:wait" must hit queue before "read" hits net). Unknown
# names classify to None and their time surfaces as unattributed-gap —
# honest, and exactly what flags a span this table should learn.
_BUCKET_RULES = (
    ("queue_wait", "queue"),
    ("dial", "queue"),
    ("throttle", "queue"),
    ("backoff", "queue"),
    ("read:wait", "queue"),
    ("qos", "queue"),
    ("locate", "net"),
    ("decode", "compute"),
    ("gather", "compute"),
    ("assemble", "compute"),
    ("encode", "compute"),
    ("stage", "compute"),
    ("crc", "compute"),
    ("disk", "disk"),
    ("net", "net"),
    ("send", "net"),
    ("recv", "net"),
    ("ack", "net"),
    ("commit", "net"),
    ("read", "net"),
    ("write", "net"),
)


def classify_segment(name: str) -> "str | None":
    label = str(name).lower()
    for pat, bucket in _BUCKET_RULES:
        if pat in label:
            return bucket
    return None


def _merge_intervals(ivs: list) -> list:
    """Sorted disjoint union of [a, b) intervals."""
    out: list = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _subtract_intervals(ivs: list, claimed: list) -> list:
    """``ivs`` minus ``claimed`` (both sorted disjoint unions)."""
    out = []
    for a, b in ivs:
        cur = a
        for ca, cb in claimed:
            if cb <= cur or ca >= b:
                continue
            if ca > cur:
                out.append((cur, ca))
            cur = max(cur, cb)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


def attribute_timeline(timeline: dict) -> dict:
    """Decompose a :func:`merge_timeline` result into queue / disk /
    net / compute / unattributed-gap milliseconds that sum EXACTLY to
    the op's wall time.

    Every wall instant lands in at most one bucket: per-bucket span
    unions are resolved in priority order (queue > disk > net >
    compute), each later bucket only claiming instants no
    higher-priority bucket covered — overlapping spans can never push
    the sum past 100%. Segments are clamped to the wall window, so a
    clock-skewed ring (a chunkserver span leaking past the client
    wall) cannot produce negative gaps; zero/negative-duration
    segments are skipped. Chunkserver spans carrying the native
    plane's ``queue_us``/``disk_us``/``net_us`` attrs are split into
    synthetic sub-intervals in that order instead of classifying the
    envelope, so one ``cs_read`` op feeds three buckets."""
    wall_ms = float(timeline.get("wall_ms", 0.0) or 0.0)
    buckets = {b: 0.0 for b in ATTRIBUTION_BUCKETS}
    out = {
        "trace_id": timeline.get("trace_id", 0),
        "wall_ms": round(wall_ms, 3),
        "buckets_ms": buckets,
        "pct": {b: 0.0 for b in ATTRIBUTION_BUCKETS},
        "dominant": "unattributed",
    }
    if wall_ms <= 0.0:
        return out
    per_bucket: dict[str, list] = {}
    for seg in timeline.get("segments", ()):
        try:
            s = float(seg.get("start_ms", 0.0))
            e = s + float(seg.get("dur_ms", 0.0))
        except (TypeError, ValueError):
            continue
        s = min(max(s, 0.0), wall_ms)
        e = min(max(e, 0.0), wall_ms)
        if e <= s:
            continue
        attrs = seg.get("attrs") or {}
        if any(k in attrs for k in ("queue_us", "disk_us", "net_us")):
            cursor = s
            for key, bucket in (
                ("queue_us", "queue"), ("disk_us", "disk"),
                ("net_us", "net"),
            ):
                dur = min(
                    max(float(attrs.get(key, 0) or 0), 0.0) / 1e3,
                    e - cursor,
                )
                if dur > 0.0:
                    per_bucket.setdefault(bucket, []).append(
                        (cursor, cursor + dur)
                    )
                    cursor += dur
            continue
        bucket = classify_segment(seg.get("name", ""))
        if bucket is not None:
            per_bucket.setdefault(bucket, []).append((s, e))
    claimed: list = []
    covered = 0.0
    for bucket in ("queue", "disk", "net", "compute"):
        ivs = _merge_intervals(per_bucket.get(bucket, []))
        own = _subtract_intervals(ivs, claimed)
        got = sum(b - a for a, b in own)
        buckets[bucket] = round(got, 3)
        covered += got
        claimed = _merge_intervals(claimed + ivs)
    buckets["unattributed"] = round(max(wall_ms - covered, 0.0), 3)
    out["pct"] = {
        b: round(100.0 * v / wall_ms, 1) for b, v in buckets.items()
    }
    out["dominant"] = max(buckets, key=lambda b: buckets[b])
    return out


def format_attribution(attr: dict) -> str:
    """One-block rendering (`trace-dump --attribute`, slowops)."""
    lines = [
        f"attribution 0x{attr.get('trace_id', 0):x}  "
        f"wall {attr.get('wall_ms', 0.0):.2f} ms  "
        f"dominant {attr.get('dominant', '?')}"
    ]
    buckets = attr.get("buckets_ms", {})
    pct = attr.get("pct", {})
    for b in ATTRIBUTION_BUCKETS:
        lines.append(
            f"  {b:<14s} {buckets.get(b, 0.0):>10.3f} ms "
            f"{pct.get(b, 0.0):>6.1f}%"
        )
    return "\n".join(lines)
