"""Shared IO-limit vocabulary: config grammar + group->limit resolution.

Used by both the master (budget allocation) and the client
(classification) — the reference keeps this split the same way
(reference: src/common/io_limits_config_loader.cc shared loader;
src/mount/io_limit_group.cc client-side classification).
"""

from __future__ import annotations

UNCLASSIFIED = "unclassified"


def parse_limits_cfg(text: str) -> tuple[str, dict[str, int]]:
    """Parse an mfsiolimits.cfg-style file (reference:
    src/common/io_limits_config_loader.cc):

        subsystem blkio
        limit unclassified 1048576
        limit /containers/web 10485760

    Returns (subsystem, {group: bytes_per_sec}).
    """
    subsystem = ""
    limits: dict[str, int] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        fields = line.split()
        if fields[0] == "subsystem" and len(fields) == 2:
            subsystem = fields[1]
        elif fields[0] == "limit" and len(fields) == 3:
            limits[fields[1]] = int(fields[2])
        else:
            raise ValueError(f"iolimits line {lineno}: {raw!r}")
    return subsystem, limits



def resolve_limit(group: str, limits: dict[str, int]) -> tuple[str, int]:
    """Match ``group`` to the closest configured ancestor limit.

    Returns (matched-key, bps). The reference walks up the cgroup path
    until a configured group is found (io_limit_group.cc); unmatched
    paths use the "unclassified" entry, and a missing "unclassified"
    entry means unlimited (0).
    """
    if group in limits:
        return group, limits[group]
    path = group
    while path and path != "/" and path.startswith("/"):
        path = path.rsplit("/", 1)[0] or "/"
        if path in limits:
            return path, limits[path]
    return UNCLASSIFIED, limits.get(UNCLASSIFIED, 0)
