"""Quota database: per-user / per-group / per-directory limits.

Mirror of the reference's QuotaDatabase (reference:
src/master/quota_database.h:30-90, filesystem_quota.cc): soft and hard
limits on inode count and byte usage, keyed by uid, gid, or directory
inode (directory quotas apply to the whole subtree via the FS tree's
recursive statistics). Hard limits reject the operation with
QUOTA_EXCEEDED; soft limits mark the entry "exceeded" in reports.

uid/gid usage is tracked incrementally here; directory usage reads the
tree's stat_inodes/stat_bytes directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

KIND_USER = "user"
KIND_GROUP = "group"
KIND_DIR = "dir"

RES_INODES = "inodes"
RES_BYTES = "bytes"


@dataclass
class QuotaEntry:
    soft_inodes: int = 0  # 0 = unlimited
    hard_inodes: int = 0
    soft_bytes: int = 0
    hard_bytes: int = 0
    used_inodes: int = 0  # tracked for user/group only
    used_bytes: int = 0

    def to_dict(self) -> dict:
        return {
            "soft_inodes": self.soft_inodes, "hard_inodes": self.hard_inodes,
            "soft_bytes": self.soft_bytes, "hard_bytes": self.hard_bytes,
            "used_inodes": self.used_inodes, "used_bytes": self.used_bytes,
        }


class QuotaDatabase:
    def __init__(self):
        self.entries: dict[tuple[str, int], QuotaEntry] = {}

    def entry(self, kind: str, owner_id: int, create: bool = False) -> QuotaEntry | None:
        key = (kind, owner_id)
        e = self.entries.get(key)
        if e is None and create:
            e = self.entries[key] = QuotaEntry()
        return e

    def set_limits(
        self, kind: str, owner_id: int,
        soft_inodes: int, hard_inodes: int, soft_bytes: int, hard_bytes: int,
    ) -> None:
        e = self.entry(kind, owner_id, create=True)
        e.soft_inodes = soft_inodes
        e.hard_inodes = hard_inodes
        e.soft_bytes = soft_bytes
        e.hard_bytes = hard_bytes

    def remove(self, kind: str, owner_id: int) -> None:
        e = self.entries.get((kind, owner_id))
        if e is not None:
            # keep usage tracking for user/group entries with no limits
            if e.used_inodes or e.used_bytes:
                e.soft_inodes = e.hard_inodes = 0
                e.soft_bytes = e.hard_bytes = 0
            else:
                del self.entries[(kind, owner_id)]

    # --- incremental usage (user/group) -----------------------------------

    def charge(self, uid: int, gid: int, d_inodes: int, d_bytes: int) -> None:
        for kind, oid in ((KIND_USER, uid), (KIND_GROUP, gid)):
            e = self.entry(kind, oid, create=True)
            e.used_inodes = max(0, e.used_inodes + d_inodes)
            e.used_bytes = max(0, e.used_bytes + d_bytes)

    # --- enforcement -------------------------------------------------------

    def check(self, uid: int, gid: int, d_inodes: int, d_bytes: int) -> bool:
        """True iff the hard limits permit adding (d_inodes, d_bytes)."""
        for kind, oid in ((KIND_USER, uid), (KIND_GROUP, gid)):
            e = self.entries.get((kind, oid))
            if e is None:
                continue
            if e.hard_inodes and e.used_inodes + d_inodes > e.hard_inodes:
                return False
            if e.hard_bytes and e.used_bytes + d_bytes > e.hard_bytes:
                return False
        return True

    def check_dir(self, dir_stats: tuple[int, int], entry: QuotaEntry,
                  d_inodes: int, d_bytes: int) -> bool:
        used_i, used_b = dir_stats
        if entry.hard_inodes and used_i + d_inodes > entry.hard_inodes:
            return False
        if entry.hard_bytes and used_b + d_bytes > entry.hard_bytes:
            return False
        return True

    def dir_entries(self) -> list[tuple[int, QuotaEntry]]:
        return [
            (oid, e) for (kind, oid), e in self.entries.items() if kind == KIND_DIR
        ]

    # --- persistence -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            f"{kind}:{oid}": e.to_dict() for (kind, oid), e in self.entries.items()
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QuotaDatabase":
        db = cls()
        for key, row in d.items():
            kind, _, oid = key.partition(":")
            e = db.entry(kind, int(oid), create=True)
            for k, v in row.items():
                setattr(e, k, int(v))
        return db
