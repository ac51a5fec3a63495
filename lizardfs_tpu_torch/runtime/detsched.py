"""Seeded deterministic asyncio scheduling — the interleaving explorer.

The cross-await-race lint rule finds *candidate* interleavings
statically; this module makes them *reproducible* dynamically. A
:class:`DetEventLoop` is a SelectorEventLoop whose ready-callback order
is permuted by a seeded RNG:

* every ``call_soon`` lands the new handle at a seeded position within
  the currently-pending ready callbacks instead of FIFO-appending, so
  two tasks racing toward the same awaited state run in a
  seed-determined order — a different seed explores a different
  interleaving of the same program;
* ``run_in_executor`` (and therefore ``asyncio.to_thread``) runs the
  function INLINE at a seeded later point on the loop thread instead of
  on a worker thread, so "thread completion order" is permuted by the
  same mechanism and — crucially — stops depending on OS scheduling.
  (Executor jobs that block on loop progress would deadlock under this;
  the tree's ``to_thread`` bodies are disk/CPU work, which is exactly
  the class worth permuting. ``detsched`` is a test harness, never a
  production mode.)
* every scheduling decision appends ``step:callback-label`` to a
  schedule log; :func:`schedule_digest` hashes it. Same seed => the
  log, and therefore the execution order of every callback, is
  byte-identical across runs — a failure replays exactly from its
  printed seed (``tools/racehunt.py`` prints the replay command).

Sources of nondeterminism the loop CANNOT tame: real sockets/
subprocesses (kernel timing decides readiness), timer callbacks racing
wall time, and ``call_soon_threadsafe`` from threads the loop does not
own. Pure-asyncio tests (locks, gather, queues, ``to_thread``) — the
race-explorer target class — are fully deterministic under it.

Usage::

    detsched.run(coro_fn(), seed=7)            # asyncio.run equivalent
    with detsched.policy(seed=7): ...          # install for a block
    LZ_DETSCHED=7 python -m pytest tests/ ...  # conftest routes async
                                               # tests through run()

``LZ_DETSCHED`` is the seed (an int); unset means the stock loop runs
(zero overhead, zero change — the kill-switch discipline).
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import os
import random
import re
import selectors

_ADDR_RE = re.compile(r" at 0x[0-9a-fA-F]+")


def detsched_seed() -> int | None:
    """The ONE accessor for LZ_DETSCHED (kill-switch inventory): the
    explorer seed, or None = stock scheduling."""
    raw = os.environ.get("LZ_DETSCHED", "").strip()
    if not raw:
        return None
    try:
        return int(raw, 0)
    except ValueError:
        raise ValueError(
            f"LZ_DETSCHED={raw!r}: expected an integer seed"
        ) from None


def _fn_label(fn) -> str:
    """Address-free name for an executor callable (``to_thread`` wraps
    the user function in ``partial(ctx.run, func)`` — dig it out)."""
    if hasattr(fn, "func"):  # functools.partial
        for a in getattr(fn, "args", ()):
            if callable(a):
                return _fn_label(a)
        return _fn_label(fn.func)
    return getattr(fn, "__qualname__", type(fn).__name__)


def _label(handle) -> str:
    cb = getattr(handle, "_callback", None)
    # a Task step callback names the coroutine — the label a human
    # reads in the schedule log to see WHICH task won the race
    task = getattr(cb, "__self__", None)
    coro = getattr(task, "get_coro", None)
    if coro is not None:
        try:
            return getattr(coro(), "__qualname__", repr(coro()))
        except Exception:
            pass
    return getattr(cb, "__qualname__", repr(cb))


class DetEventLoop(asyncio.SelectorEventLoop):
    """SelectorEventLoop with seeded ready-queue permutation, inline
    deterministic executors, and a schedule log."""

    def __init__(self, seed: int):
        super().__init__(selectors.DefaultSelector())
        self.det_seed = seed
        self._det_rng = random.Random(0xD5C0DE ^ (seed * 0x9E3779B1))
        self._det_steps = 0
        self._det_log = hashlib.sha1(str(seed).encode())
        self._det_tail: list[str] = []  # bounded human-readable tail

    # -- schedule accounting -------------------------------------------------
    def _det_note(self, event: str) -> None:
        self._det_steps += 1
        # labels must never carry object addresses: the digest is the
        # byte-identical replay contract across PROCESSES
        entry = f"{self._det_steps}:{_ADDR_RE.sub('', event)}"
        self._det_log.update(entry.encode())
        self._det_tail.append(entry)
        if len(self._det_tail) > 64:
            del self._det_tail[:32]

    def schedule_digest(self) -> str:
        """Digest over every scheduling decision so far: byte-identical
        for the same seed + same program, the replay contract racehunt
        pins."""
        return self._det_log.hexdigest()

    def schedule_tail(self) -> list[str]:
        return list(self._det_tail)

    # -- seeded permutation --------------------------------------------------
    def _det_place(self, handle) -> None:
        """Move the just-appended handle to a seeded position among the
        pending ready callbacks (permuting arrival order is exactly
        permuting the execution order asyncio would otherwise FIFO)."""
        ready = self._ready
        pos = self._det_rng.randrange(len(ready)) if len(ready) > 1 else 0
        if pos != len(ready) - 1:
            ready.insert(pos, ready.pop())
        self._det_note(f"{_label(handle)}@{pos}")

    def call_soon(self, callback, *args, context=None):
        handle = super().call_soon(callback, *args, context=context)
        self._det_place(handle)
        return handle

    # NOT overridden: call_soon_threadsafe. A foreign thread's arrival
    # time is outside the loop's control; permuting it would only add
    # noise to the digest. detsched determinism holds for the loop's
    # own scheduling (which includes every executor completion, below).

    def run_in_executor(self, executor, func, *args):
        """Deterministic executor: run ``func`` inline at a seeded later
        point on the loop thread. Completion order of concurrent
        ``to_thread`` jobs becomes a seeded permutation instead of an
        OS scheduling accident."""
        fut = self.create_future()

        def _runner():
            if fut.cancelled():
                return
            try:
                fut.set_result(func(*args))
            except BaseException as e:  # mirrors executor behavior
                fut.set_exception(e)

        _runner.__qualname__ = f"to_thread:{_fn_label(func)}"
        self.call_soon(_runner)
        return fut


class DetEventLoopPolicy(asyncio.DefaultEventLoopPolicy):
    def __init__(self, seed: int):
        super().__init__()
        self._seed = seed

    def new_event_loop(self):
        return DetEventLoop(self._seed)


@contextlib.contextmanager
def policy(seed: int):
    """Install the deterministic policy for a block (asyncio.run inside
    the block builds DetEventLoops)."""
    old = asyncio.get_event_loop_policy()
    asyncio.set_event_loop_policy(DetEventLoopPolicy(seed))
    try:
        yield
    finally:
        asyncio.set_event_loop_policy(old)


def run(coro, seed: int, return_digest: bool = False):
    """``asyncio.run`` under a seeded deterministic loop. With
    ``return_digest`` the result is ``(result, schedule_digest)`` so
    tests can pin byte-identical schedules."""
    loop = DetEventLoop(seed)
    try:
        asyncio.set_event_loop(loop)
        result = loop.run_until_complete(coro)
        digest = loop.schedule_digest()
    finally:
        try:
            _cancel_all(loop)
        finally:
            asyncio.set_event_loop(None)
            loop.close()
    return (result, digest) if return_digest else result


def _cancel_all(loop) -> None:
    pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
    for t in pending:
        t.cancel()
    if pending:
        loop.run_until_complete(
            asyncio.gather(*pending, return_exceptions=True)
        )
    loop.run_until_complete(loop.shutdown_asyncgens())
