"""Reads in a closed loop over a data set written in set-up.

Parameters of the mix: ``files`` files of ``file_bytes`` each make the
data set; ``readers`` clients each read again once a read returns, a
uniform file and offset, the size log-uniform over
``size_min``..``size_max`` (:class:`fsbench.traffic.ReadStream`);
``master_tweaks`` are set on the master before anything fails;
``kill`` names a policy under ``fsbench/kills/`` that takes a
chunkserver down before the window; ``warmup_reads`` reads of the mix's
own sizes warm up; a ``check_share`` of the reads, drawn from the seed,
is compared whole after the window.
"""

from __future__ import annotations

import asyncio
import time
import zlib

import numpy as np

from fsbench import cluster as clustermod
from fsbench import data, manifest, reference, traffic


async def setup(cell) -> None:
    p = cell.params
    n, size = int(p["files"]), int(p["file_bytes"])
    cell.pool = data.make_pool(cell.seed, n * size, cell.device)
    sem = asyncio.Semaphore(2)

    async def one(i):
        async with sem:
            attr = await cell.client.create(cell.dir_inode, f"d{i:04d}")
            await cell.client.write_file(attr.inode, cell.pool[i * size:(i + 1) * size])
            await cell.client.release(attr.inode)
            return attr.inode

    cell.inodes = list(await asyncio.gather(*(one(i) for i in range(n))))
    for name, value in p.get("master_tweaks", {}).items():
        await clustermod.admin_json(cell.cluster.master_port, "tweaks-set",
                                    {"name": name, "value": str(value)})
    cell.kill = manifest.kill(p["kill"]) if p.get("kill") else None
    if cell.kill is not None:
        await cell.kill.apply(cell)
    stream = traffic.ReadStream(p, cell.seed + 1, block=64)
    warm = [(f, 0, int(p["size_max"])) for f in range(n)]
    warm += [stream.next() for _ in range(int(p.get("warmup_reads", 32)))]
    for f, off, k in warm:
        await cell.client.read_file(cell.inodes[f], off, min(k, size - off))


async def drive(cell, t0: float) -> None:
    p = cell.params
    stream = traffic.ReadStream(p, cell.seed)
    keep = traffic.keep_sample(cell.seed, 1 << 20, float(p.get("check_share", 0.1)))
    end = t0 + cell.seconds
    size = int(p["file_bytes"])
    cell.kept, cell.spot_wrong = [], 0

    async def reader(r: int) -> None:
        while time.perf_counter() < end:
            f, off, n = stream.next()
            req = {"op": "read", "file": f, "offset": off, "size": n,
                   "index": len(cell.requests), "reader": r}
            cell.requests.append(req)
            req["start"] = req["t_due"] = time.perf_counter()
            try:
                buf = await cell.client.read_file(cell.inodes[f], off, n)
                req["ok"] = len(buf) == n
            except Exception as e:
                req["ok"] = False
                req["error"] = repr(e)[:300]
                buf = b""
            req["end"] = time.perf_counter()
            cell.spans.add("read", req["start"], req["end"])
            if not req["ok"]:
                continue
            if req["index"] < len(keep) and keep[req["index"]]:
                # the sample's answers, compared whole after the window by
                # their CRC32 (holding the bytes would grow the mount by
                # gigabytes inside the window)
                req["crc"] = zlib.crc32(buf)
                cell.kept.append(req)
            else:
                # every other answer: its first and last 64 bytes
                want = reference.expected(cell.pool, size, f, off, n)
                if not (np.array_equal(np.frombuffer(buf[:64], np.uint8), want[:64])
                        and np.array_equal(np.frombuffer(buf[-64:], np.uint8), want[-64:])):
                    cell.spot_wrong += 1

    await asyncio.gather(*(reader(r) for r in range(int(p["readers"]))))


async def check(cell) -> None:
    size = int(cell.params["file_bytes"])
    cell.check("reads_failed", sum(1 for r in cell.requests if not r["ok"]), 0)
    wrong = cell.spot_wrong
    for req in cell.kept:
        want = reference.expected(cell.pool, size, req["file"], req["offset"], req["size"])
        wrong += req["crc"] != zlib.crc32(want)
    cell.check("reads_wrong", wrong, 0)
    cell.notes["reads_compared_whole"] = len(cell.kept)
    if cell.kill is not None:
        await cell.kill.check(cell)
