"""The port's FUSE read pool (``client/native_client.py``, the C client
built from ``native/``) on the CPU.

* The pool reads a goal-1 file through the C client and the listeners of
  port native chunkservers and of JAX native chunkservers: a prefix, an
  inner range, a range past the end, a missing inode (``None``, so the
  caller falls back), and a degraded ec(3,2) file, which the pool hands
  back to the planner path.
* The port's ``LizardFuse`` serves a read of a whole goal-1 file through
  its pool (the pool's reads and the listeners' read count rise, and the
  bytes are the file's), and a degraded ec(3,2) read falls back to its
  client's planner path, which recovers the lost part on the encoder.

Native chunkservers listen on ``NATIVE_HOST``
(``tests/test_torch_native_serve.py``); every case runs in process on
ephemeral ports and closes every pool and listener.
"""

import asyncio
import ctypes
import os
from collections import Counter

import pytest

from lizardfs_tpu_torch.client import native_client
from tests.test_torch_client import GOALS, Cluster, payload, two_threads  # noqa: F401
from tests.test_torch_fuse import Mount
from tests.test_torch_native_serve import (  # noqa: F401 (autouse fixtures)
    NATIVE_HOST, CountingEncoder, jax_native_library, native_threads_released, run_native)


def read_ops(cluster) -> int:
    return sum(cs.data_server.stats()["read_ops"] for cs in cluster.chunkservers
               if cs.data_server is not None)


@pytest.mark.parametrize("servers", ["port", "jax"])
def test_native_pool_reads_and_fallback(tmp_path, servers):
    async def scenario():
        cluster = Cluster(tmp_path, master=servers, servers=servers, client="port", n_cs=6,
                          native_data_plane=True, cs_host=NATIVE_HOST)
        await cluster.start(health_interval=30.0)
        pool = native_client.NativeReadPool(lambda: ("127.0.0.1", cluster.master.port))
        try:
            c = await cluster.client()
            f = await c.create(1, "hot.dat")
            blob = payload(5, 300_000)
            await c.write_file(f.inode, blob)
            before = read_ops(cluster)
            assert await asyncio.to_thread(pool.read, f.inode, 0, 100_000) == blob[:100_000]
            assert await asyncio.to_thread(pool.read, f.inode, 123_456, 4096) == blob[123_456:127_552]
            assert await asyncio.to_thread(pool.read, f.inode, len(blob) - 10, 4096) == blob[-10:]
            assert await asyncio.to_thread(pool.read, 999_999, 0, 16) is None
            assert read_ops(cluster) > before, "the pool read past the listeners"
            e = await c.create(1, "striped.dat")
            await c.setgoal(e.inode, GOALS["ec32"])
            sblob = payload(6, 200_000)
            await c.write_file(e.inode, sblob)
            await cluster.stop_data_holder(e.inode, 3)
            nat = await asyncio.to_thread(pool.read, e.inode, 0, 1000)
            assert nat is None or nat == sblob[:1000]
            c.cache.invalidate(e.inode)
            assert await c.read_file(e.inode, 0, 1000) == sblob[:1000]
        finally:
            await asyncio.to_thread(pool.close)
            await cluster.stop()

    run_native(scenario())


def test_fuse_reads_through_the_pool_and_falls_back(tmp_path, monkeypatch):
    """A whole goal-1 file through the mount's pool; a degraded ec(3,2)
    file through the planner path and the encoder's recovery."""
    served = Counter()
    real = native_client.NativeReadPool.read

    def counted(self, inode, offset, size):
        got = real(self, inode, offset, size)
        served["pool" if got is not None else "fallback"] += 1
        return got

    monkeypatch.setattr(native_client.NativeReadPool, "read", counted)
    size = 1 << 20

    async def scenario():
        cluster = Cluster(tmp_path, n_cs=6, native_data_plane=True, cs_host=NATIVE_HOST)
        await cluster.start(health_interval=30.0)
        mnt = Mount("port", cluster.master.port)
        enc = mnt.fuse.client.encoder = CountingEncoder()
        try:
            c = await cluster.client()
            files = {}
            for name, goal in (("plain.bin", 1), ("striped.bin", GOALS["ec32"])):
                f = await c.create(1, name)
                await c.setgoal(f.inode, goal)
                await c.write_file(f.inode, payload(len(name), size))
                files[name] = f.inode
            await cluster.stop_data_holder(files["striped.bin"], 3)
            await asyncio.to_thread(mnt.start)
            assert mnt.fuse._native_reads is not None

            def read(path: bytes) -> bytes:
                fi = mnt.file_info(os.O_RDONLY)
                assert mnt.ops.open(path, ctypes.pointer(fi)) == 0
                try:
                    return mnt.read(path, fi, size)
                finally:
                    mnt.ops.release(path, ctypes.pointer(fi))

            before = read_ops(cluster)
            assert await asyncio.to_thread(read, b"/plain.bin") == payload(len("plain.bin"), size)
            pooled, ops = served["pool"], read_ops(cluster) - before
            assert await asyncio.to_thread(read, b"/striped.bin") == payload(len("striped.bin"), size)
            return pooled, ops, dict(served), dict(enc.calls)
        finally:
            await asyncio.to_thread(mnt.fuse._native_reads.close)
            await asyncio.to_thread(mnt.close)
            await cluster.stop()

    pooled, ops, counts, calls = run_native(scenario())
    assert pooled >= 1 and ops >= pooled, "the mount's reads did not go through the pool"
    assert counts["fallback"] >= 1 and counts["pool"] == pooled
    assert calls.get("recover", 0) >= 1, "the degraded read did not recover on the encoder"
