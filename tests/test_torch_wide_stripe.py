"""``$ec(32,8)``, LizardFS's widest stripe, through the port's normal path
on the CPU: an in-process cluster of native chunkservers, the port's
master placing the 40 parts, ``Client.write_file`` encoding them and
``Client.read`` serving degraded reads through the stripe fan-in and the
encoder's ``recover``.

* The parts the chunkservers store are the plain reference's
  (``fsbench/reference_rs.py``): its striping of the written bytes and
  its parity, with the Cauchy matrix at (32,8) and the Vandermonde one at
  (8,4), so the reference is held on both of LizardFS's matrices (a
  part's last, partial block is stored whole, padded with zeros).
* With the holder of a data part stopped, reads at several offsets and
  sizes (inside a block, across a slot and a stripe row, whole rows,
  the short tail, the whole file) give the bytes written; those of
  whole rows take the fan-in, none falls back.
"""

import numpy as np
import pytest
import torch

from fsbench import reference_rs
from lizardfs_tpu_torch.chunkserver.chunk_store import HEADER_SIZE
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry
from tests.test_torch_client import GOALS, two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_native_fast_paths import native_cluster, write_ec_file
from tests.test_torch_native_serve import (  # noqa: F401 (autouse fixtures)
    jax_native_library, native_threads_released, run_native)

B = MFSBLOCKSIZE
MiB = 1 << 20
WIDE = "14 ec328 : $ec(32,8)"
SIZE = 5 * MiB + 777  # two whole stripe rows of 2 MiB and a short tail


async def wide_cluster(tmp_path, n_cs: int = 41):
    """k + m + 1 native chunkservers and the goal ``$ec(32,8)`` as 14."""
    cluster = native_cluster(tmp_path, n_cs=n_cs)
    await cluster.start(health_interval=30.0)  # no repair: raw recovery
    gid, goal = geometry.parse_goal_line(WIDE)
    cluster.master.goals[gid] = goal
    return cluster, gid


def first_chunk(cluster, inode: int):
    registry = cluster.master.meta.registry
    return registry.chunks[cluster.master.meta.fs.nodes[inode].chunks[0]]


def stored_parts(cluster, inode: int) -> dict[int, bytes]:
    """The file's first chunk as stored: part index -> the part's bytes."""
    chunk_id = cluster.master.meta.fs.nodes[inode].chunks[0]
    return {pid % 64: data[HEADER_SIZE:]
            for (cid, pid), data in cluster.live_parts().items() if cid == chunk_id}


def reference_parts(data: bytes, k: int, m: int) -> list[bytes]:
    """The reference's parts of a chunk, as a chunkserver stores them:
    a part's last, partial block whole, padded with zeros."""
    chunk = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    parts = reference_rs.stripe(chunk, k)
    parity = reference_rs.parity(parts, k, m)
    out = [p.numpy().tobytes() for p in parts + parity]
    return [p.ljust(-(-len(p) // B) * B, b"\0") for p in out]


@pytest.mark.parametrize("k,m", [(32, 8), (8, 4)])
def test_stored_parts_are_the_reference(tmp_path, k, m):
    async def scenario():
        if k == 32:
            cluster, goal = await wide_cluster(tmp_path)
        else:
            cluster, goal = native_cluster(tmp_path, n_cs=13), GOALS["ec84"]
            await cluster.start(health_interval=30.0)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=SIZE, goal=goal)
            chunk = first_chunk(cluster, f.inode)
            # one part a server: the master spreads the stripe over k + m
            # of the k + m + 1 servers
            assert len({cs for cs, _ in chunk.parts}) == len(chunk.parts) == k + m
            return stored_parts(cluster, f.inode), data
        finally:
            await cluster.stop()

    stored, data = run_native(scenario())
    want = reference_parts(data, k, m)
    assert reference_rs.uses_cauchy(k, m) == (k == 32)
    assert sorted(stored) == list(range(k + m))
    for i in range(k + m):
        assert stored[i] == want[i], f"part {i}"


READS = [  # (offset, size)
    (100, 1000),                     # inside a block
    (31 * B + 17, 2 * B),            # across slot 0 and slot 1 of row 0
    (2 * MiB - 5000, 10000),         # across the first stripe rows
    (0, 4 * MiB),                    # the two whole rows
    (12345, 3 * MiB),                # unaligned, three quarters of the rows
    (4 * MiB + 12345, SIZE - 4 * MiB - 12345),  # the short tail
    (0, SIZE),                       # the whole file
]


def test_degraded_reads_of_the_wide_stripe(tmp_path):
    async def scenario():
        cluster, goal = await wide_cluster(tmp_path)
        try:
            c, f, data = await write_ec_file(cluster, nbytes=SIZE, goal=goal)
            assert await cluster.stop_data_holder(f.inode, 32) == 40
            lost = [p for cs, p in first_chunk(cluster, f.inode).parts
                    if cluster.master.meta.registry.servers[cs].port
                    not in {s.port for s in cluster.chunkservers}]
            assert len(lost) == 1 and lost[0] < 32
            for off, size in READS:
                c.cache.invalidate(f.inode)
                assert await c.read_file(f.inode, off, size) == data[off : off + size], off
            fanin = c.op_counters.get("stripe_fanin", 0)
            assert fanin >= 4 and c.op_counters.get("stripe_fanin_fallback", 0) == 0
            assert c.op_counters["stripe_fanin_rounds"] == fanin
            # the recovery ran in the fan-in's thread on the wide plan
            assert c.read_phases.snapshot()["decode_ms"] > 0
            back = np.zeros(4 * MiB, dtype=np.uint8)
            c.cache.invalidate(f.inode)
            assert await c.read_file_into(f.inode, 0, back) == back.size
            assert back.tobytes() == data[: 4 * MiB]
        finally:
            await cluster.stop()

    run_native(scenario())
