"""File locking: POSIX byte-range locks + BSD flock (held state).

Mirror of the reference's lock engine (reference: src/master/locks.h:
29-224 LockRanges/FileLocks): per-file interval lists of shared/
exclusive locks, owner = (session_id, owner_token); overlapping ranges
from one owner merge/split POSIX-style. Only HELD locks live here —
they replicate via the changelog and persist in the metadata image.
Blocked (waiting) requests are live-master-only state queued by the
master server, which re-tests and commits grants as locks release.
"""

from __future__ import annotations

from dataclasses import dataclass, field

LOCK_UNLOCK = 0
LOCK_SHARED = 1
LOCK_EXCLUSIVE = 2

MAX_OFFSET = (1 << 63) - 1


@dataclass(frozen=True)
class Owner:
    session_id: int
    token: int  # process/fd discriminator within the session


@dataclass
class Range:
    start: int
    end: int  # exclusive
    ltype: int
    owner: Owner

    def overlaps(self, start: int, end: int) -> bool:
        return self.start < end and start < self.end


class FileLocks:
    """Locks of one file: interval list + FIFO pending queue."""

    def __init__(self):
        self.ranges: list[Range] = []

    # --- queries -----------------------------------------------------------

    def test(self, owner: Owner, start: int, end: int, ltype: int) -> Range | None:
        """First conflicting range held by another owner (POSIX F_GETLK)."""
        for r in self.ranges:
            if r.owner == owner or not r.overlaps(start, end):
                continue
            if ltype == LOCK_EXCLUSIVE or r.ltype == LOCK_EXCLUSIVE:
                return r
        return None

    # --- mutations ---------------------------------------------------------

    def _remove_owner_range(self, owner: Owner, start: int, end: int) -> None:
        """Carve [start, end) out of this owner's ranges (POSIX split)."""
        out: list[Range] = []
        for r in self.ranges:
            if r.owner != owner or not r.overlaps(start, end):
                out.append(r)
                continue
            if r.start < start:
                out.append(Range(r.start, start, r.ltype, r.owner))
            if r.end > end:
                out.append(Range(end, r.end, r.ltype, r.owner))
        self.ranges = out

    def _merge_owner(self, owner: Owner) -> None:
        """Coalesce adjacent same-type ranges of one owner."""
        mine = sorted(
            (r for r in self.ranges if r.owner == owner), key=lambda r: r.start
        )
        others = [r for r in self.ranges if r.owner != owner]
        merged: list[Range] = []
        for r in mine:
            if merged and merged[-1].ltype == r.ltype and merged[-1].end >= r.start:
                merged[-1].end = max(merged[-1].end, r.end)
            else:
                merged.append(r)
        self.ranges = others + merged

    def apply(self, owner: Owner, start: int, end: int, ltype: int) -> bool:
        """Set/clear a held lock. True = applied; False = refused
        (conflict — the caller maps to LOCKED or queues the waiter)."""
        if ltype == LOCK_UNLOCK:
            self._remove_owner_range(owner, start, end)
            return True
        if self.test(owner, start, end, ltype) is not None:
            return False
        self._remove_owner_range(owner, start, end)
        self.ranges.append(Range(start, end, ltype, owner))
        self._merge_owner(owner)
        return True

    def release_session(self, session_id: int) -> None:
        self.ranges = [r for r in self.ranges if r.owner.session_id != session_id]

    @property
    def empty(self) -> bool:
        return not self.ranges


class LockManager:
    """All files' locks. flock and POSIX locks live in independent
    spaces, as on Linux: a whole-file flock never conflicts with a
    byte-range fcntl lock."""

    def __init__(self):
        self.posix_files: dict[int, FileLocks] = {}
        self.flock_files: dict[int, FileLocks] = {}

    @staticmethod
    def _file(table: dict[int, FileLocks], inode: int) -> FileLocks:
        fl = table.get(inode)
        if fl is None:
            fl = table[inode] = FileLocks()
        return fl

    def posix(self, inode: int, session_id: int, token: int, start: int,
              end: int, ltype: int) -> bool:
        return self._file(self.posix_files, inode).apply(
            Owner(session_id, token), start, end or MAX_OFFSET, ltype
        )

    def flock(self, inode: int, session_id: int, token: int,
              ltype: int) -> bool:
        return self._file(self.flock_files, inode).apply(
            Owner(session_id, token), 0, MAX_OFFSET, ltype
        )

    def test(self, inode: int, session_id: int, token: int, start: int,
             end: int, ltype: int) -> Range | None:
        fl = self.posix_files.get(inode)
        if fl is None:
            return None
        return fl.test(Owner(session_id, token), start, end or MAX_OFFSET, ltype)

    def test_flock(self, inode: int, session_id: int, token: int,
                   ltype: int) -> Range | None:
        fl = self.flock_files.get(inode)
        if fl is None:
            return None
        return fl.test(Owner(session_id, token), 0, MAX_OFFSET, ltype)

    def release_session(self, session_id: int) -> list[int]:
        """Release all held locks of a session; returns the inodes that
        freed capacity (the caller retries its queued waiters there)."""
        woken = []
        for table in (self.posix_files, self.flock_files):
            for inode, fl in list(table.items()):
                before = len(fl.ranges)
                fl.release_session(session_id)
                if len(fl.ranges) != before:
                    woken.append(inode)
                if fl.empty:
                    del table[inode]
        return woken

    def session_inodes(self, session_id: int) -> list[int]:
        """Inodes where the session holds locks."""
        inodes = set()
        for table in (self.posix_files, self.flock_files):
            for inode, fl in table.items():
                if any(r.owner.session_id == session_id for r in fl.ranges):
                    inodes.add(inode)
        return sorted(inodes)
