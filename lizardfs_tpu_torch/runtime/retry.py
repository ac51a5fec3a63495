"""Unified retry/backoff/deadline policy for every dial and RPC loop.

Before this module each role hand-rolled its own loop: the client's
``_retry_transient`` and failover reconnect, the chunkserver's master
and mirror dials, the master's shadow-follow link, the NFS gateway's
startup connect. Each had its own backoff shape and — worse — its own
idea of "how long is too long", so stacked layers could multiply their
budgets (a client retrying an op that retries a dial that retries a
connect could spend attempts * attempts * timeout wall-clock).

:class:`RetryPolicy` centralizes the shape (jittered exponential
backoff, attempt cap) and :class:`Deadline` threads ONE end-to-end
budget through nested calls via a contextvar: an inner ``run()`` (or
:func:`bounded_wait`) inherits the tightest enclosing deadline, so
retries deeper in the stack can only ever spend what the outermost
caller budgeted. The reference's analogs: the mount's fs_reconnect loop
and its nrtomaxtimeout connect budget (src/mount/mastercomm.cc).
"""

from __future__ import annotations

import asyncio
import contextvars
import logging
import random
import time

_DEADLINE: contextvars.ContextVar["Deadline | None"] = contextvars.ContextVar(
    "lz_retry_deadline", default=None
)

_log = logging.getLogger("retry")


class RetryError(Exception):
    """Transient failures exhausted the policy (attempts or deadline).
    ``last`` holds the final underlying exception, if any."""

    def __init__(self, what: str, last: Exception | None):
        self.what = what
        self.last = last
        super().__init__(
            f"{what} failed after retries"
            + (f": {last}" if last is not None else " (deadline)")
        )


class Deadline:
    """A monotonic point in time the whole (nested) operation must not
    outlive."""

    __slots__ = ("at",)

    def __init__(self, seconds: float):
        self.at = time.monotonic() + seconds

    def remaining(self) -> float:
        return self.at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


def current_deadline() -> Deadline | None:
    return _DEADLINE.get()


def budget(cap: float | None = None) -> float | None:
    """Seconds left in the ambient deadline, clamped by ``cap``.
    None = unbounded (no deadline and no cap)."""
    d = _DEADLINE.get()
    if d is None:
        return cap
    rem = max(d.remaining(), 0.0)
    return rem if cap is None else min(rem, cap)


def spawn_detached(coro) -> asyncio.Task:
    """Create a task with NO inherited deadline. Long-lived tasks born
    inside a policy-scoped attempt (an RPC connection's pump, a probe
    loop) must not carry the attempt's budget for the rest of their
    lives — a task context copies the deadline at creation and an
    expired one would turn every later bounded wait into an instant
    timeout."""
    token = _DEADLINE.set(None)
    try:
        return asyncio.get_running_loop().create_task(coro)
    finally:
        _DEADLINE.reset(token)


async def bounded_wait(awaitable, cap: float | None = None):
    """``await`` bounded by min(cap, ambient deadline budget). The
    workhorse of the unbounded-await audit: every dial and lone
    ``conn.call`` in the tree goes through here (or a policy) so a
    blackholed peer can cost at most the budget, never an OS timeout."""
    t = budget(cap)
    if t is None:
        return await awaitable
    return await asyncio.wait_for(awaitable, max(t, 0.001))


async def close_writer(writer, cap: float = 5.0, *,
                       swallow_cancel: bool = False) -> None:
    """THE teardown idiom: ``close()`` + bounded ``wait_closed()``,
    swallowing transport errors and the timeout. ``wait_closed`` on a
    peer that never drains FIN-ACKs can park forever; teardown paths
    must not inherit that hang (unbounded-await audit). Cancellation
    propagates by default; sites whose callers historically absorbed
    cancellation mid-close pass ``swallow_cancel=True`` — one helper,
    one cap, one exception policy, instead of seven drifting inline
    copies."""
    try:
        writer.close()
        t = budget(cap)
        await asyncio.wait_for(
            writer.wait_closed(), max(t if t is not None else cap, 0.001)
        )
    except (ConnectionError, OSError, asyncio.TimeoutError):
        pass
    except asyncio.CancelledError:
        if not swallow_cancel:
            raise


class RetryPolicy:
    """Jittered exponential backoff with an attempt cap and an optional
    end-to-end deadline.

    ``transient``: predicate deciding whether an exception is worth a
    retry (default: connection/OS/timeout errors). Non-transient errors
    surface immediately. When attempts or the deadline run out,
    :class:`RetryError` carries the last transient failure.

    ``run()`` PUBLISHES its (possibly inherited, always tightest)
    deadline to the ambient context, so nested policies and
    :func:`bounded_wait` calls inside the attempt share the same budget
    instead of amplifying it.
    """

    def __init__(
        self,
        attempts: int = 5,
        base_delay: float = 0.1,
        max_delay: float = 2.0,
        multiplier: float = 2.0,
        jitter: float = 0.1,
        deadline: float | None = None,
        attempt_timeout: float | None = None,
        transient=None,
    ):
        self.attempts = max(attempts, 1)
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline = deadline
        self.attempt_timeout = attempt_timeout
        self.transient = transient or self._default_transient

    @staticmethod
    def _default_transient(e: Exception) -> bool:
        return isinstance(e, (ConnectionError, OSError, asyncio.TimeoutError))

    def _backoff(self, attempt: int) -> float:
        delay = min(
            self.base_delay * self.multiplier ** (attempt - 1), self.max_delay
        )
        if self.jitter:
            delay *= 1.0 + self.jitter * (2 * random.random() - 1)
        return max(delay, 0.0)

    async def run(self, attempt_fn, *, what: str = "op", log=None):
        """Run ``attempt_fn`` (no-arg coroutine function) under the
        policy; returns its result."""
        log = log or _log
        outer = _DEADLINE.get()
        dl = outer
        if self.deadline is not None:
            mine = Deadline(self.deadline)
            # the TIGHTEST deadline wins: a nested policy can shrink the
            # budget but never extend what the outer caller allowed
            dl = mine if outer is None or mine.at < outer.at else outer
        token = _DEADLINE.set(dl)
        try:
            last: Exception | None = None
            for attempt in range(self.attempts):
                if attempt:
                    delay = self._backoff(attempt)
                    if dl is not None and dl.remaining() <= delay:
                        break  # budget can't even cover the backoff
                    await asyncio.sleep(delay)
                cap = self.attempt_timeout
                if dl is not None:
                    rem = dl.remaining()
                    if rem <= 0:
                        break
                    cap = rem if cap is None else min(cap, rem)
                try:
                    if cap is None:
                        return await attempt_fn()
                    return await asyncio.wait_for(attempt_fn(), max(cap, 0.001))
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — classified below
                    if not self.transient(e):
                        raise
                    last = e
                    log.info("%s retry %d/%d: %s", what, attempt + 1,
                             self.attempts, e)
            raise RetryError(what, last)
        finally:
            _DEADLINE.reset(token)
