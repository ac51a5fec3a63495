"""Multi-tenant QoS: fair-share admission + weighted data-plane queueing.

One hot client must degrade gracefully per-tenant — shed the abuser,
not the fleet (ROADMAP 4). This module holds the three mechanisms every
role composes, built on the session-identity substrate and the
in-tree budget primitives (:mod:`lizardfs_tpu_torch.runtime.limiter`):

* :class:`TenantMap` — sessions map to tenants at registration time
  (config-driven fnmatch rules over the client ``info`` string and the
  export root path; everything else lands on the default tenant).
  Identity then rides the existing ``session_id`` plumbing, so the
  data plane needs no new wire fields.
* :class:`FairShare` — the master's admission controller: per-tenant,
  per-op-class (read/write/meta_read/meta_write/locate) weighted token
  buckets over a shared class rate.  Shares are weighted max-min among
  *recently active* tenants, so a lone tenant may use the whole class
  budget while two contending tenants converge to their weight ratio.
  A refused op is shed with the transient ``BUSY`` status carrying a
  retry-after hint; clients retry through the unified RetryPolicy.
* :class:`DrrByteQueue` — the chunkserver's data-plane fair queue:
  weighted deficit-round-robin over a shared in-flight byte budget
  (:class:`~lizardfs_tpu_torch.runtime.limiter.CreditBucket` semantics:
  credits return when the disk work completes).  While the budget has
  headroom admission is immediate; under contention queued tenants are
  granted in DRR order with a quantum proportional to their weight, so
  in-flight disk-queue bytes converge to the weight ratio.  Rebuild
  traffic enters as the reserved ``_rebuild`` pseudo-tenant, capping
  RebuildEngine vs. client bandwidth both ways.

Kill-switch contract: ``LZ_QOS`` (constants.qos_enabled, default ON —
but with NO configuration the engine admits everything, so an
unconfigured cluster is byte-identical either way).  Every enforcement
site checks the switch before touching the engine; off means one
accessor call and nothing else (pinned in tests/test_qos.py).
"""

from __future__ import annotations

import asyncio
import json
import time
from collections import deque
from fnmatch import fnmatchcase

from lizardfs_tpu_torch.runtime.limiter import CreditBucket, TokenBucket

# the one class vocabulary shared by master admission (locate/meta_*/
# write grants) and the chunkserver data plane (read/write bytes)
OP_CLASSES = ("locate", "read", "write", "meta_read", "meta_write")
# the subset master admission actually maps RPCs onto — "read" is a
# DATA-PLANE class (bytes under the chunkserver's DRR budget, not a
# master ops/s rate); accepting a rates["read"] that silently binds to
# nothing would be a config footgun, so parse_config rejects it
MASTER_RATE_CLASSES = ("locate", "write", "meta_read", "meta_write")

DEFAULT_TENANT = "default"
# reserved pseudo-tenant the chunkserver charges RebuildEngine traffic
# to: rebuilds and clients share the DRR queue, so neither can starve
# the other
REBUILD_TENANT = "_rebuild"

# a tenant counts toward the fair-share split while it sent traffic in
# the last ACTIVE_WINDOW_S (work-conserving: idle tenants donate their
# share instead of wasting it)
ACTIVE_WINDOW_S = 5.0

# retry-after hint clamp (ms): never tell a client "retry now" (it
# would spin on the shed path) nor park it long enough to breach its
# own deadline before the first retry
MIN_RETRY_MS = 10
MAX_RETRY_MS = 1000


def parse_config(text: str) -> dict:
    """Parse a QOS_CFG file (JSON) into the canonical config doc::

        {
          "default_tenant": "default",
          "tenants": {
            "gold":   {"weight": 4, "match": ["vip-*"], "p99_ms": 50},
            "bulk":   {"weight": 1, "match": ["scanner*"]}
          },
          "rates":  {"locate": 2000, "meta_read": 0, ...},  # ops/s, 0=unl
          "data_inflight_mb": 64,     # CS in-flight byte budget (0=off)
          "data_bps": 0,              # optional native per-session pacing
          "rebuild_weight": 1
        }

    Raises ``ValueError`` on malformed input (reload keeps the previous
    config; strict startup load fails loudly)."""
    doc = json.loads(text or "{}")
    if not isinstance(doc, dict):
        raise ValueError("qos config must be a JSON object")
    tenants = doc.get("tenants", {})
    if not isinstance(tenants, dict):
        raise ValueError("qos 'tenants' must be an object")
    for name, t in tenants.items():
        if not isinstance(t, dict):
            raise ValueError(f"qos tenant {name!r} must be an object")
        if float(t.get("weight", 1.0)) <= 0:
            raise ValueError(f"qos tenant {name!r}: weight must be > 0")
    rates = doc.get("rates", {})
    if not isinstance(rates, dict):
        raise ValueError("qos 'rates' must be an object")
    for cls in rates:
        if cls not in MASTER_RATE_CLASSES:
            raise ValueError(
                f"qos rate for op class {cls!r} — master admission "
                f"rates are {MASTER_RATE_CLASSES} (data-plane bytes are "
                "budgeted via data_inflight_mb/data_bps, not a rate)"
            )
    return doc


class TenantMap:
    """Session -> tenant resolution, decided once at registration.

    Rules are ``(pattern, tenant)`` pairs matched with fnmatch against
    the client's ``info`` string first, then the export-root path the
    session registered under; first match wins, no match lands on the
    default tenant."""

    def __init__(self, rules: list[tuple[str, str]] | None = None,
                 default: str = DEFAULT_TENANT):
        self.rules = list(rules or [])
        self.default = default

    @classmethod
    def from_config(cls, doc: dict) -> "TenantMap":
        rules = []
        for name, t in (doc.get("tenants") or {}).items():
            for pat in t.get("match", ()):
                rules.append((str(pat), str(name)))
        return cls(rules, str(doc.get("default_tenant", DEFAULT_TENANT)))

    def tenant_of(self, info: str = "", export_path: str = "") -> str:
        for pat, tenant in self.rules:
            if fnmatchcase(info, pat) or (
                export_path and fnmatchcase(export_path, pat)
            ):
                return tenant
        return self.default


class FairShare:
    """Per-tenant, per-op-class weighted admission over shared class
    rates (the master's RPC-loop controller).

    Each configured op class has a total rate (ops/s).  Active tenants
    split it by weight into per-(tenant, class) ``TokenBucket``s;
    shares recompute when the active set changes (or every second).
    ``admit`` returns ``None`` (admitted) or a retry-after hint in ms
    (shed)."""

    def __init__(self, now_fn=time.monotonic):
        self._now = now_fn
        self.weights: dict[str, float] = {}
        self.rates: dict[str, float] = {c: 0.0 for c in OP_CLASSES}
        # per-tenant latency objective (ms) the health rollup evaluates
        self.objectives: dict[str, float] = {}
        self._buckets: dict[tuple[str, str], TokenBucket] = {}
        self._last_seen: dict[str, float] = {}
        self._shares_at = 0.0
        self._active_key: tuple = ()
        # shed accounting for health/`top`: tenant -> [count, last_ts]
        self.sheds: dict[str, list] = {}
        self.generation = 0

    # --- config ------------------------------------------------------------

    def configure(self, doc: dict) -> None:
        """Install a parsed config doc (SIGHUP / admin / tweak path)."""
        tenants = doc.get("tenants") or {}
        self.weights = {
            str(n): float(t.get("weight", 1.0)) for n, t in tenants.items()
        }
        self.objectives = {
            str(n): float(t["p99_ms"]) for n, t in tenants.items()
            if "p99_ms" in t
        }
        rates = doc.get("rates") or {}
        self.rates = {
            c: float(rates.get(c, 0.0)) for c in OP_CLASSES
        }
        self._buckets.clear()
        self._shares_at = 0.0
        self.generation += 1

    def set_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError("weight must be > 0")
        self.weights[str(tenant)] = float(weight)
        self._shares_at = 0.0
        self.generation += 1

    def set_rate(self, op_class: str, rate: float) -> None:
        if op_class not in MASTER_RATE_CLASSES:
            raise ValueError(f"unknown admission op class {op_class!r}")
        self.rates[op_class] = max(float(rate), 0.0)
        self._shares_at = 0.0
        self.generation += 1

    @property
    def armed(self) -> bool:
        """True when any class has a finite rate — an unconfigured
        engine admits everything without creating buckets."""
        return any(r > 0 for r in self.rates.values())

    # --- admission ---------------------------------------------------------

    def _weight_of(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    def _recompute_shares(self, now: float) -> None:
        lo = now - ACTIVE_WINDOW_S
        active = sorted(
            t for t, ts in self._last_seen.items() if ts >= lo
        )
        key = tuple(active)
        if key == self._active_key and now - self._shares_at < 1.0:
            return
        self._active_key = key
        self._shares_at = now
        total_w = sum(self._weight_of(t) for t in active) or 1.0
        for cls, rate in self.rates.items():
            if rate <= 0:
                continue
            for t in active:
                share = rate * self._weight_of(t) / total_w
                bucket = self._buckets.get((t, cls))
                if bucket is None:
                    # burst = one second of the tenant's share (min 1):
                    # short bursts ride through, sustained floods pace
                    self._buckets[(t, cls)] = TokenBucket(
                        share, max(share, 1.0), now_fn=self._now
                    )
                else:
                    bucket.rate = share
                    bucket.burst = max(share, 1.0)
        # drop buckets of tenants that went idle (their share returns
        # to the pool at the next recompute; state stays bounded)
        for t, cls in [k for k in self._buckets if k[0] not in key]:
            del self._buckets[(t, cls)]

    def admit(self, tenant: str, op_class: str,
              cost: float = 1.0) -> int | None:
        """Admit one op or return a retry-after hint in ms (shed)."""
        rate = self.rates.get(op_class, 0.0)
        now = self._now()
        self._last_seen[tenant] = now
        if len(self._last_seen) > 4096:
            lo = now - ACTIVE_WINDOW_S
            self._last_seen = {
                t: ts for t, ts in self._last_seen.items() if ts >= lo
            }
            self._last_seen[tenant] = now
        if rate <= 0:
            return None
        self._recompute_shares(now)
        bucket = self._buckets.get((tenant, op_class))
        if bucket is None:
            self._shares_at = 0.0  # brand-new tenant: force a split
            self._recompute_shares(now)
            bucket = self._buckets.get((tenant, op_class))
            if bucket is None:  # pragma: no cover — rate raced to 0
                return None
        if bucket.try_acquire(cost):
            return None
        # deficit in tokens -> ms until the bucket can cover the cost
        deficit = cost - bucket._tokens
        retry_ms = int(deficit / max(bucket.rate, 1e-6) * 1000.0)
        retry_ms = max(MIN_RETRY_MS, min(retry_ms, MAX_RETRY_MS))
        shed = self.sheds.setdefault(tenant, [0, 0.0])
        shed[0] += 1
        shed[1] = now
        return retry_ms

    # --- introspection -----------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready state for `lizardfs-admin qos` / health."""
        now = self._now()
        lo = now - ACTIVE_WINDOW_S
        return {
            "armed": self.armed,
            "rates": {c: r for c, r in self.rates.items() if r > 0},
            "weights": dict(self.weights),
            "objectives_ms": dict(self.objectives),
            "active_tenants": sorted(
                t for t, ts in self._last_seen.items() if ts >= lo
            ),
            "sheds": {
                t: {"count": c, "age_s": round(max(now - ts, 0.0), 1)}
                for t, (c, ts) in self.sheds.items()
            },
            "generation": self.generation,
        }

    def throttled_tenants(self, within_s: float = 10.0) -> list[str]:
        """Tenants shed within the last ``within_s`` — what health and
        `top` NAME as currently throttled."""
        now = self._now()
        return sorted(
            t for t, (_c, ts) in self.sheds.items()
            if now - ts <= within_s
        )


class DrrByteQueue:
    """Weighted deficit-round-robin admission of data-plane byte work
    over a shared in-flight credit budget.

    ``admit(tenant, nbytes)`` takes ``nbytes`` credits out; ``done``
    puts them back when the disk work completed (CreditBucket
    semantics — the budget bounds outstanding WORK, not a rate).  While
    credits cover the request and nobody queues, admission is one dict
    lookup.  Under contention each tenant's waiters queue FIFO and the
    drain grants across tenants in DRR order: every round a tenant's
    deficit grows by ``quantum * weight`` and its head waiters are
    granted while the deficit (and shared credits) cover them — so
    in-flight bytes converge to the weight ratio, and a tenant with
    jumbo requests cannot lock out small ones for more than a round."""

    # one DRR visit's base quantum (bytes), multiplied by weight — at
    # the 64 KiB block scale so weights bite at request granularity (a
    # chunk-sized quantum would let arrival order decide instead)
    QUANTUM = 64 * 1024

    def __init__(self, capacity: float = 0.0):
        self.bucket = CreditBucket(capacity)
        self.weights: dict[str, float] = {}
        # tenant -> deque[(nbytes, future)]
        self._queues: dict[str, deque] = {}
        self._deficit: dict[str, float] = {}
        # round-robin order over tenants with queued work
        self._rr: deque[str] = deque()
        # True when the front tenant is OWED its per-visit quantum: a
        # credit-blocked drain resumes mid-service WITHOUT re-crediting
        # (re-adding per resume would bank unbounded deficit and defeat
        # the weights entirely)
        self._fresh_visit = True
        self.throttle_waits = 0  # ops that had to queue
        self.granted_bytes: dict[str, int] = {}

    def configure(self, weights: dict[str, float],
                  capacity_bytes: float) -> None:
        self.weights = {str(t): float(w) for t, w in weights.items()}
        # preserve outstanding work across a live resize: credits track
        # the NEW capacity minus what is still in flight (a shrink can
        # go to zero; in-flight done() calls pay the debt back)
        outstanding = max(self.bucket.capacity - self.bucket._credits, 0.0)
        self.bucket.capacity = float(capacity_bytes)
        self.bucket._credits = max(float(capacity_bytes) - outstanding, 0.0)
        self._drain()  # a grown budget may unblock queued waiters

    @property
    def armed(self) -> bool:
        return self.bucket.capacity > 0

    def _weight_of(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0)

    async def admit(self, tenant: str, nbytes: int) -> bool:
        """Take ``nbytes`` in-flight credits for ``tenant``; returns
        True iff the caller had to queue (throttle observability, the
        CreditBucket.acquire contract)."""
        if self.bucket.capacity <= 0 or nbytes <= 0:
            return False
        n = min(float(nbytes), self.bucket.capacity)
        if not self._queues and self.bucket.try_acquire(n):
            self.granted_bytes[tenant] = (
                self.granted_bytes.get(tenant, 0) + nbytes
            )
            return False
        self.throttle_waits += 1
        fut = asyncio.get_running_loop().create_future()
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = deque()
            self._deficit.setdefault(tenant, 0.0)
            self._rr.append(tenant)
        q.append((n, fut))
        # drain now: the queue may hold only cancelled husks (or this
        # waiter may fit the current credits under DRR order) and with
        # nothing in flight no done() would ever run — a parked waiter
        # with a full bucket is the deadlock this call forecloses
        self._drain()
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # granted concurrently with the cancellation: the
                # caller will never run `done()`, return the credits
                self.bucket.release(n)
            else:
                try:
                    q.remove((n, fut))
                except ValueError:
                    pass
            raise
        self.granted_bytes[tenant] = (
            self.granted_bytes.get(tenant, 0) + nbytes
        )
        return True

    def done(self, tenant: str, nbytes: int) -> None:
        if self.bucket.capacity <= 0 or nbytes <= 0:
            return
        n = min(float(nbytes), self.bucket.capacity)
        self.bucket.release(n)
        self._drain()

    def _drop_front(self) -> None:
        t = self._rr.popleft()
        self._queues.pop(t, None)
        self._deficit.pop(t, None)
        self._fresh_visit = True

    def _drain(self) -> None:
        """Grant queued waiters in weighted-DRR order (classic DRR:
        one quantum x weight per VISIT, leftover deficit persists while
        the queue stays backlogged, resets when it empties). Returns
        when the front waiter is blocked on CREDITS — the next
        ``done()`` resumes exactly where service stopped, mid-visit,
        without re-crediting the quantum. A head blocked only on its
        tenant's deficit keeps lapping: deficits grow per lap, so
        progress is guaranteed."""
        while True:
            # prune tenants whose queue emptied (incl. cancellations)
            while self._rr and not self._queues.get(self._rr[0]):
                self._drop_front()
            if not self._rr:
                return
            granted = False
            for _ in range(len(self._rr)):
                tenant = self._rr[0]
                q = self._queues.get(tenant)
                if not q:
                    self._drop_front()
                    continue
                if self._fresh_visit:
                    self._deficit[tenant] = (
                        self._deficit.get(tenant, 0.0)
                        + self.QUANTUM * self._weight_of(tenant)
                    )
                    self._fresh_visit = False
                while q:
                    n, fut = q[0]
                    if fut.done():  # cancelled waiter left behind
                        q.popleft()
                        continue
                    if n > self._deficit[tenant]:
                        break  # visit over: deficit spent
                    if not self.bucket.try_acquire(n):
                        # credit-blocked MID-VISIT: resume here on the
                        # next done() (fresh stays False — no re-credit)
                        return
                    q.popleft()
                    self._deficit[tenant] -= n
                    fut.set_result(None)
                    granted = True
                if not q:
                    self._drop_front()
                else:
                    self._rr.rotate(-1)
                    self._fresh_visit = True
            if not granted:
                # a full lap granted nothing and nobody was credit-
                # blocked: every head is deficit-blocked — lap again
                # (each lap accrues one quantum per tenant, so the
                # largest clamped request is reached in finite laps)
                continue

    def waiting(self) -> dict[str, int]:
        return {t: len(q) for t, q in self._queues.items() if q}

    def snapshot(self) -> dict:
        return {
            "armed": self.armed,
            "capacity": self.bucket.capacity,
            "available": round(self.bucket.available, 1),
            "weights": dict(self.weights),
            "waiting": self.waiting(),
            "throttle_waits": self.throttle_waits,
            "granted_bytes": dict(self.granted_bytes),
        }


def busy_backoff_s(retry_after_ms: int, attempt: int, rng=None) -> float:
    """Jittered sleep before retrying a BUSY-shed op: honor the
    server's hint, escalate with the attempt count, and jitter so a
    thundering herd of shed clients doesn't re-arrive in phase."""
    import random as _random

    rng = rng or _random
    base = (retry_after_ms / 1000.0) if retry_after_ms > 0 else 0.05
    delay = min(base * (1.5 ** attempt), 2.0)
    return delay * (0.5 + rng.random())
