"""Per-session (per-tenant) op accounting — the measurement layer under
the `top` view and the fair-share QoS work that follows (ROADMAP 4).

The reference answers "who is hammering my cluster?" only with
per-mount ``.oplog``/``.stats`` magic files (reference:
src/mount/oplog.cc, client/fuse_mount.py here) — per-process, invisible
cluster-wide. This module threads the session identity the master
already issues through everything a daemon counts:

* :class:`SessionOps` — bounded per-session op/byte/latency accounting
  on top of the registry's labeled families
  (``Metrics.labeled_timing("session_ops", {session, op})`` +
  ``labeled_counter("session_bytes", ...)``), with trace-id exemplars
  so a hot cell links straight to a trace. Per-session rates ride
  a 60 s bucketed window (O(1) per record), so `top` shows live rates
  without a sampler thread.
* :meth:`SessionOps.top` — the top-K summary chunkservers fold into
  their heartbeat ``health_json`` and gateways push over
  ``CltomaSessionStats``, giving the master the cluster-wide view
  ``lizardfs-admin top`` renders.
* the process wire-session identity (:func:`set_process_session`) the
  data-plane request stampers read (``CltocsRead.session_id`` etc.),
  mirroring the native plane's thread-local trace id pattern.

Cost contract: ``LZ_TOP=0`` short-circuits :meth:`record` to a single
module-attribute check — no labeled series are created, heartbeat
summaries are empty, and the scrape page is byte-identical to the
pre-accounting one (pinned in tests/test_top.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

from lizardfs_tpu_torch.constants import env_flag

_ENABLED = env_flag("LZ_TOP")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Test/ops hook mirroring the LZ_TOP env gate."""
    global _ENABLED
    _ENABLED = bool(on)


# The session id this PROCESS's data-plane requests carry (one cluster
# session per client process: FUSE mount, NFS gateway, S3 gateway).
# Module-global like the native plane's thread-local trace id —
# read_executor and friends are module functions with no client handle.
# A CONTEXTVAR overrides it per top-level client op (task_session below)
# so several Clients sharing one interpreter — the in-process test
# clusters, a colocated NFS+S3 pair — attribute each request to ITS
# owning session instead of whoever registered last.
_PROCESS_SESSION = 0

_TASK_SESSION: contextvars.ContextVar[int] = contextvars.ContextVar(
    "lz_session", default=0
)


def set_process_session(sid: int) -> None:
    global _PROCESS_SESSION
    _PROCESS_SESSION = int(sid)


def wire_session() -> int:
    return _TASK_SESSION.get() or _PROCESS_SESSION


@contextlib.contextmanager
def task_session(sid: int):
    """Scope the wire-session identity to this task (and every task it
    spawns — contextvars copy at task creation): the client wraps its
    public data ops so nested read/write machinery stamps the OWNING
    client's session."""
    token = _TASK_SESSION.set(int(sid))
    try:
        yield
    finally:
        _TASK_SESSION.reset(token)


# rate window: per-second buckets over the last minute
_RATE_SPAN_S = 60
# the window `top` computes live rates over (long enough to smooth
# bucket edges, short enough to track a moving hot spot)
_RATE_WINDOW_S = 10.0


class _Rate:
    """O(1) bucketed (ops, bytes) window; rate() averages the last
    ``_RATE_WINDOW_S`` seconds."""

    __slots__ = ("buckets",)

    def __init__(self):
        # bucket epoch -> [ops, bytes]; bounded by expiry on add
        self.buckets: dict[int, list] = {}

    def add(self, now: float, nbytes: int) -> None:
        epoch = int(now)
        b = self.buckets.get(epoch)
        if b is None:
            self.buckets[epoch] = [1, nbytes]
            if len(self.buckets) > _RATE_SPAN_S:
                lo = epoch - _RATE_SPAN_S
                for e in [e for e in self.buckets if e < lo]:
                    del self.buckets[e]
        else:
            b[0] += 1
            b[1] += nbytes

    def rates(self, now: float) -> tuple[float, float]:
        lo = int(now - _RATE_WINDOW_S)
        ops = by = 0
        for e, (o, b) in self.buckets.items():
            if e >= lo:
                ops += o
                by += b
        return ops / _RATE_WINDOW_S, by / _RATE_WINDOW_S


class SessionOps:
    """Bounded per-session op accounting for one daemon/client role.

    ``record(session, op_class, seconds, nbytes, trace_id)`` charges
    one finished op to its originating session: a labeled latency
    histogram cell (with the trace-id exemplar), a labeled byte
    counter, and the in-memory rate window ``top()`` reads. Sessions
    past ``max_sessions`` fold into the ``"other"`` row — totals stay
    truthful, cardinality stays bounded (the scrape page is the
    expensive surface: each tracked (session, op) cell is a 20-bucket
    histogram)."""

    def __init__(self, metrics, role: str = "", max_sessions: int = 32):
        self.metrics = metrics
        self.role = role
        self.max_sessions = max_sessions
        # session label -> {"rate": _Rate, "ops": int, "bytes": int,
        #                   "classes": {op_class: [ops, bytes]}}
        self._sessions: dict[str, dict] = {}

    def _label(self, session) -> str:
        label = f"s{session}" if isinstance(session, int) else str(session)
        if label not in self._sessions and (
            len(self._sessions) >= self.max_sessions
        ):
            return "other"
        return label

    def record(self, session, op_class: str, seconds: float,
               nbytes: int = 0, trace_id: int = 0) -> None:
        """Account one finished op. The LZ_TOP=0 path is this first
        check and nothing else."""
        if not _ENABLED:
            return
        label = self._label(session)
        self.metrics.labeled_timing(
            "session_ops", {"session": label, "op": op_class},
            help="per-session op latency by op class (exemplar: trace "
                 "id of the slowest recent op)",
        ).record(seconds, trace_id=trace_id)
        if nbytes:
            self.metrics.labeled_counter(
                "session_bytes", {"session": label, "op": op_class},
                help="payload bytes moved per session by op class",
            ).inc(nbytes)
        entry = self._sessions.get(label)
        if entry is None:
            entry = self._sessions[label] = {
                "rate": _Rate(), "ops": 0, "bytes": 0, "classes": {},
            }
        entry["rate"].add(time.monotonic(), nbytes)
        entry["ops"] += 1
        entry["bytes"] += nbytes
        cls = entry["classes"].setdefault(op_class, [0, 0])
        cls[0] += 1
        cls[1] += nbytes

    # --- summaries ---------------------------------------------------------

    def _timing_of(self, label: str, op_class: str):
        variants = self.metrics.labeled_timings.get("session_ops", {})
        return variants.get((("op", op_class), ("session", label)))

    def top(self, k: int = 8) -> list[dict]:
        """Top-K sessions by current op rate (ties: lifetime ops) —
        the summary that rides heartbeats / gateway pushes and feeds
        the master's cluster-wide `top` rollup. JSON-ready."""
        if not _ENABLED:
            return []
        now = time.monotonic()
        rows = []
        for label, entry in self._sessions.items():
            rate_ops, rate_bytes = entry["rate"].rates(now)
            classes = {}
            p99_worst = 0.0
            exemplar = ""
            for op_class, (ops, nbytes) in entry["classes"].items():
                t = self._timing_of(label, op_class)
                p99 = round(t.quantile_us(0.99) / 1e3, 3) if t else 0.0
                p99_worst = max(p99_worst, p99)
                cls = {"ops": ops, "p99_ms": p99}
                if nbytes:
                    cls["bytes"] = nbytes
                if t is not None and t.exemplar_trace_id:
                    cls["exemplar"] = f"0x{t.exemplar_trace_id:x}"
                    exemplar = exemplar or cls["exemplar"]
                classes[op_class] = cls
            row = {
                "session": label,
                "rate_ops": round(rate_ops, 2),
                "rate_bytes": round(rate_bytes, 1),
                "ops": entry["ops"],
                "bytes": entry["bytes"],
                "p99_ms": p99_worst,
                "classes": classes,
            }
            if exemplar:
                row["exemplar"] = exemplar
            rows.append(row)
        rows.sort(key=lambda r: (-r["rate_ops"], -r["ops"], r["session"]))
        return rows[:k]

    def total_rate(self) -> float:
        """Aggregate op rate across tracked sessions (the gauge the
        metrics-history rings retain for `top` trends)."""
        if not _ENABLED:
            return 0.0
        now = time.monotonic()
        return round(
            sum(e["rate"].rates(now)[0] for e in self._sessions.values()), 2
        )

    def active_sessions(self) -> int:
        return len(self._sessions)

    def retire(self, session) -> None:
        """Drop a departed session's aggregates AND its labeled metric
        variants: without the variant cleanup, session churn would fill
        the registry's LABEL_VARIANT_CAP with dead cells and fold every
        future session into "other" (no p99, no exemplar — the `top`
        link this module exists for)."""
        label = f"s{session}" if isinstance(session, int) else str(session)
        self._sessions.pop(label, None)
        self.metrics.drop_labeled("session_ops", "session", label)
        self.metrics.drop_labeled("session_bytes", "session", label)


async def gateway_stats_push_loop(client, doc_fn, interval_s, log) -> None:
    """ONE push loop for every protocol gateway: every ``interval_s``
    seconds, push ``doc_fn()`` to the master as CltomaSessionStats so
    the cluster ``top`` names the protocol-op mix behind the gateway's
    session. Best effort by design — a missed push costs one refresh
    interval, and telemetry must never kill serving. (Shared here so
    the NFS and S3 gateways cannot drift apart on the push contract.)"""
    import asyncio
    import json

    from lizardfs_tpu_torch.proto import messages as m

    while True:
        await asyncio.sleep(interval_s)
        if not _ENABLED:
            continue
        try:
            await client._call(
                m.CltomaSessionStats, stats_json=json.dumps(doc_fn())
            )
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            log.debug("session-stats push failed", exc_info=True)
