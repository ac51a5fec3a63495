"""The port's daemon runtime against the JAX package's, on the CPU.

* The modules the port copies whole (the protocol, the runtime beneath a
  daemon, the connection pool) equal their originals' source with the
  package name changed in imports. Three module docstrings drop the JAX
  package's references to its own change requests
  (``CHANGE_REFERENCE``), and nothing else may differ.
* ``bounded_wait``, ``RetryPolicy`` (on an injected clock and seeded
  jitter), ``TokenBucket`` and ``DrrByteQueue`` decide the same as the
  JAX package's on the same inputs. Every value is exact.
"""

import asyncio
import random
import re
from pathlib import Path

import numpy as np
import pytest

from lizardfs_tpu.runtime import limiter as ref_limiter
from lizardfs_tpu.runtime import qos as ref_qos
from lizardfs_tpu.runtime import retry as ref_retry
from lizardfs_tpu_torch.runtime import limiter, qos, retry

ROOT = Path(__file__).resolve().parents[1]
COPIES = [
    "proto/codec.py", "proto/messages.py", "proto/framing.py", "proto/status.py",
    "runtime/retry.py", "runtime/limiter.py", "runtime/tweaks.py", "runtime/metrics.py",
    "runtime/tracing.py", "runtime/accounting.py", "runtime/qos.py", "runtime/slo.py",
    "runtime/profiler.py", "runtime/rpc.py", "runtime/daemon.py", "runtime/config.py",
    "core/conn_pool.py",
]
# Three of the JAX package's docstrings cite its own change requests by
# number; the copies drop each such reference, and nothing else may
# differ.
CHANGE_REFERENCE = re.compile(r" \(PR \d+\)|PR-\d+ ")


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    want = (ROOT / "lizardfs_tpu" / rel).read_text().replace("lizardfs_tpu.", "lizardfs_tpu_torch.")
    assert (ROOT / "lizardfs_tpu_torch" / rel).read_text() == CHANGE_REFERENCE.sub("", want)


class FakeClock:
    """A monotonic clock that ``sleep`` advances, standing in for the
    ``time`` and ``asyncio`` modules a retry module sees."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    async def sleep(self, seconds):
        self.sleeps.append(seconds)
        self.now += seconds

    def __getattr__(self, name):
        return getattr(asyncio, name)


def _run_policy(mod, monkeypatch, seed, policy_kw, failures, step_s):
    """Run ``RetryPolicy(**policy_kw)`` over an attempt that fails
    ``failures`` times (each attempt costs ``step_s`` on the clock).
    Returns (outcome, attempts, sleeps)."""
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    monkeypatch.setattr(mod, "asyncio", clock)
    monkeypatch.setattr(mod, "random", random.Random(seed))  # the jitter's draws
    calls = []

    async def attempt():
        calls.append(clock.now)
        clock.now += step_s
        if len(calls) <= failures:
            raise ConnectionResetError(f"attempt {len(calls)}")
        return "ok"

    async def run():
        try:
            return await mod.RetryPolicy(**policy_kw).run(attempt, what="op")
        except mod.RetryError as e:
            return f"RetryError: {e.last}"

    out = asyncio.run(run())
    return out, calls, clock.sleeps


@pytest.mark.parametrize("policy_kw,failures,step_s", [
    ({"attempts": 5, "base_delay": 0.1, "jitter": 0.1}, 3, 0.01),
    ({"attempts": 4, "base_delay": 0.2, "max_delay": 0.5, "jitter": 0.3}, 9, 0.0),
    ({"attempts": 50, "base_delay": 0.05, "deadline": 1.0, "jitter": 0.2}, 99, 0.1),
])
def test_retry_policy_matches_reference(monkeypatch, policy_kw, failures, step_s):
    seed = 1234 + failures
    port = _run_policy(retry, monkeypatch, seed, policy_kw, failures, step_s)
    ref = _run_policy(ref_retry, monkeypatch, seed, policy_kw, failures, step_s)
    assert port == ref
    assert port[2], "the policy backed off"


@pytest.mark.parametrize("mod", [retry, ref_retry], ids=["port", "jax"])
def test_bounded_wait(mod):
    async def run():
        assert await mod.bounded_wait(asyncio.sleep(0, result=7)) == 7
        assert mod.budget(2.5) == 2.5 and mod.budget() is None
        never = asyncio.get_running_loop().create_future()
        with pytest.raises(asyncio.TimeoutError):
            await mod.bounded_wait(never, 0.0)  # clamped to 1 ms
        # an expired ambient deadline bounds an uncapped wait too
        token = mod._DEADLINE.set(mod.Deadline(-1.0))
        try:
            assert mod.budget(5.0) == 0.0
            with pytest.raises(asyncio.TimeoutError):
                await mod.bounded_wait(asyncio.get_running_loop().create_future())
        finally:
            mod._DEADLINE.reset(token)

    asyncio.run(run())


def _bucket_trace(mod, rng):
    t = [0.0]
    bucket = mod.TokenBucket(1000.0, burst=4000.0, now_fn=lambda: t[0])
    out = []
    for _ in range(200):
        t[0] += float(rng.integers(0, 5)) * 0.25
        out.append(bucket.try_acquire(float(rng.integers(1, 3000))))
    return out, bucket._tokens


def test_token_bucket_matches_reference():
    port = _bucket_trace(limiter, np.random.default_rng(3))
    ref = _bucket_trace(ref_limiter, np.random.default_rng(3))
    assert port == ref and True in port[0] and False in port[0]


def _drr_order(mod, rng) -> list[int]:
    """Admissions of three weighted tenants behind a full budget; the
    order in which the queue grants them as the work completes."""
    reqs = [(str(rng.choice(["a", "b", "c"])), int(rng.integers(1, 9)) * 16384)
            for _ in range(40)]

    async def run():
        q = mod.DrrByteQueue()
        q.configure({"a": 3.0, "b": 1.0, "c": 2.0}, 256 * 1024)
        await q.admit("x", 256 * 1024)  # the whole budget in flight
        order: list[int] = []

        async def one(i, tenant, n):
            await q.admit(tenant, n)
            order.append(i)

        tasks = [asyncio.ensure_future(one(i, t, n)) for i, (t, n) in enumerate(reqs)]
        for _ in range(3):
            await asyncio.sleep(0)  # every admission queued
        in_flight = [("x", 256 * 1024)]
        while in_flight:
            q.done(*in_flight.pop(0))
            seen = len(order)
            for _ in range(3):
                await asyncio.sleep(0)  # the granted tasks record themselves
            in_flight += [reqs[i] for i in order[seen:]]
        await asyncio.gather(*tasks)
        return order

    return asyncio.run(run())


def test_drr_byte_queue_order_matches_reference():
    port = _drr_order(qos, np.random.default_rng(11))
    ref = _drr_order(ref_qos, np.random.default_rng(11))
    assert port == ref and sorted(port) == list(range(40))
    assert port != sorted(port)  # the weights reorder arrivals
