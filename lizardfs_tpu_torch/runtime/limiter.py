"""Rate and flow-control primitives for the data plane.

:class:`TokenBucket` — time-refilled rate limiting for replication /
IO bandwidth (reference: src/common/token_bucket.h client QoS
smoothing, src/chunkserver/replication_bandwidth_limiter.cc
replication cap). Async: ``acquire`` sleeps until enough tokens
accumulate; a rate of 0 means unlimited.

:class:`CreditBucket` — explicitly-returned credits bounding in-flight
work (the write window's per-chunkserver frame credits and shared
staging-byte budget): credits come back on acknowledgment, not with
time.
"""

from __future__ import annotations

import asyncio
import time


class TokenBucket:
    def __init__(self, rate: float, burst: float | None = None,
                 now_fn=time.monotonic):
        """rate: tokens (bytes) per second; burst: bucket size.
        ``now_fn`` injects a clock for deterministic tests (the QoS
        fair-share suite drives refills on virtual time)."""
        self.rate = rate
        self.burst = burst if burst is not None else max(rate, 1.0)
        self._now = now_fn
        self._tokens = self.burst
        self._last = now_fn()

    def _refill(self) -> None:
        now = self._now()
        self._tokens = min(
            self.burst, self._tokens + (now - self._last) * self.rate
        )
        self._last = now

    def try_acquire(self, n: float) -> bool:
        if self.rate <= 0:
            return True
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    async def acquire(self, n: float) -> None:
        """Debt model: requests larger than the burst still pace at
        ``rate`` instead of deadlocking — tokens go negative and the
        caller sleeps the debt off."""
        if self.rate <= 0:
            return
        self._refill()
        self._tokens -= n
        if self._tokens < 0:
            await asyncio.sleep(-self._tokens / self.rate)


class CreditBucket:
    """Counting credits with explicit put-back — the flow-control twin
    of :class:`TokenBucket` (which refills by TIME and models a rate).
    Credits model in-flight WORK: ``acquire`` takes credits out,
    ``release`` puts them back when the work is acknowledged, so the
    bucket bounds how much is outstanding rather than how fast it
    flows. Used by the client's adaptive write window: one bucket per
    chunkserver caps unacknowledged bulk frames per connection, one
    shared bucket caps total staged bytes across every in-flight
    chunk write.

    A request larger than ``capacity`` is clamped (mirroring the token
    bucket's debt model: a jumbo segment must pace, not deadlock).
    Waiters are FIFO. ``capacity <= 0`` disables accounting entirely.
    """

    def __init__(self, capacity: float):
        self.capacity = capacity
        self._credits = capacity
        from collections import deque

        self._waiters: deque = deque()

    @property
    def available(self) -> float:
        return self._credits

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.capacity <= 0:
            return True
        n = min(n, self.capacity)
        if not self._waiters and self._credits >= n:
            self._credits -= n
            return True
        return False

    async def acquire(self, n: float = 1.0) -> bool:
        """Take ``n`` credits, waiting FIFO until available. Returns
        True iff the caller had to wait (backpressure observability:
        the window exports a credit-wait counter)."""
        if self.try_acquire(n):
            return False
        n = min(n, self.capacity)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._waiters.append((fut, n))
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # granted and cancelled in the same tick: put it back
                self.release(n)
            else:
                try:
                    self._waiters.remove((fut, n))
                except ValueError:
                    pass
            raise
        return True

    def release(self, n: float = 1.0) -> None:
        if self.capacity <= 0:
            return
        self._credits = min(self._credits + min(n, self.capacity),
                            self.capacity)
        while self._waiters:
            fut, need = self._waiters[0]
            if fut.cancelled():
                self._waiters.popleft()
                continue
            if self._credits < need:
                break
            self._waiters.popleft()
            self._credits -= need
            fut.set_result(True)
