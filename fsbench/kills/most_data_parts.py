"""SIGKILL the chunkserver that holds the most data parts of the cell's
data set, wait until the master sees it gone, and check after the window
that what it held stayed lost: as many degraded chunks at the end as at
the start, at least one, and no part rebuilt (the mix holds rebuilds off
by its ``master_tweaks``).
"""

from __future__ import annotations

import asyncio
import os
import time

from fsbench import cluster as clustermod
from fsbench import reference


def _holder(cell, loc, info) -> int | None:
    """The index of the chunkserver a location names: by its data port,
    learned from where the located part's file lies."""
    ports = cell.notes.setdefault("_port_index", {})
    port = loc.addr.port
    if port not in ports:
        for i in range(cell.config["chunkservers"]):
            if os.path.exists(reference.part_path(
                    cell.cluster.data_dir(i), info.chunk_id, loc.part_id, info.version)):
                ports[port] = i
                break
        else:
            return None
    return ports[port]


async def apply(cell) -> None:
    k = int(cell.config["k"])
    size = int(cell.params["file_bytes"])
    counts: dict[int, int] = {}
    for inode in cell.inodes:
        for ci in range(-(-size // reference.CHUNK)):
            info = await cell.client.chunk_info(inode, ci)
            for loc in info.locations:
                if reference.ec_part(loc.part_id) < k:
                    idx = _holder(cell, loc, info)
                    counts[idx] = counts.get(idx, 0) + 1
    cell.notes.pop("_port_index", None)
    victim = max(sorted(i for i in counts if i is not None), key=lambda i: counts[i])
    cell.notes["killed"] = {"chunkserver": victim, "data_parts": counts[victim]}
    before = await cell.cluster.connected_count()
    cell.cluster.kill9(f"cs{victim}")
    deadline = time.monotonic() + 60
    while await cell.cluster.connected_count() >= before:
        if time.monotonic() > deadline:
            raise RuntimeError("the master never saw the killed chunkserver go")
        await asyncio.sleep(0.05)
    cell.health_before = await clustermod.admin_json(cell.cluster.master_port, "chunks-health")


async def check(cell) -> None:
    port = cell.cluster.master_port
    health = await clustermod.admin_json(port, "chunks-health")
    status = await clustermod.admin_json(port, "rebuild-status")
    chunks = len(cell.inodes) * -(-int(cell.params["file_bytes"]) // reference.CHUNK)
    before = cell.health_before["endangered"]
    cell.check("degraded_chunks_at_start", before, [1, chunks])
    cell.check("degraded_chunks_at_end", health["endangered"], [before, before])
    cell.check("parts_rebuilt", status["completed"], 0)
