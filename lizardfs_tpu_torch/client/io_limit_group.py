"""cgroup-based IO limit group classification.

Maps a process (by pid) to its cgroup path so per-group bandwidth
limits apply to *workloads*, not just sessions — the reference
classifies every FUSE caller this way (reference:
src/mount/io_limit_group.cc getIoLimitGroupId reads
``/proc/<pid>/cgroup`` and matches the configured subsystem; mount
option ``cgroupsiolimits``). A mount serving several containers can
then give each container its own bandwidth share.

Supports both cgroup layouts:
  * v2 (unified): the ``0::<path>`` line, selected with subsystem "".
  * v1: the line whose controller list contains the configured
    subsystem (the reference's ``subsystem`` config key, e.g. "blkio").

Unclassifiable processes (no /proc entry, no matching line) fall into
``UNCLASSIFIED``, which the master's limit table can target explicitly
— same contract as the reference's "unclassified" limit.
"""

from __future__ import annotations

import time

from lizardfs_tpu_torch.utils.io_limits import (  # noqa: F401 — re-exports
    UNCLASSIFIED, parse_limits_cfg, resolve_limit,
)


def read_cgroup(pid: int, subsystem: str = "", proc_root: str = "/proc") -> str:
    """The cgroup path of ``pid`` for ``subsystem`` ("" = v2 unified)."""
    try:
        with open(f"{proc_root}/{pid}/cgroup", encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return UNCLASSIFIED
    for line in lines:
        parts = line.split(":", 2)
        if len(parts) != 3:
            continue
        _hid, controllers, path = parts
        if not subsystem:
            if controllers == "":  # v2 unified hierarchy
                return path or "/"
        elif subsystem in controllers.split(","):
            return path or "/"
    return UNCLASSIFIED


class GroupCache:
    """pid -> group with TTL, mirroring the reference's IoLimitGroup
    cache: classification costs a /proc read, and FUSE sees the same
    pids thousands of times per second."""

    def __init__(self, subsystem: str = "", ttl: float = 30.0,
                 proc_root: str = "/proc", max_entries: int = 4096):
        self.subsystem = subsystem
        self.ttl = ttl
        self.proc_root = proc_root
        self.max_entries = max_entries
        self._cache: dict[int, tuple[str, float]] = {}

    def classify(self, pid: int) -> str:
        now = time.monotonic()
        hit = self._cache.get(pid)
        if hit is not None and hit[1] > now:
            return hit[0]
        group = read_cgroup(pid, self.subsystem, self.proc_root)
        if len(self._cache) >= self.max_entries:
            # pids recycle; drop expired entries, or everything if none
            live = {p: v for p, v in self._cache.items() if v[1] > now}
            self._cache = live if len(live) < self.max_entries else {}
        self._cache[pid] = (group, now + self.ttl)
        return group


