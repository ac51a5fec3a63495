"""POSIX access control lists (IEEE 1003.1e draft semantics).

The reference stores POSIX/Rich ACLs per inode with conversion helpers
(reference: src/master/acl_storage.cc, src/common/richacl*). This is
the POSIX model: owner/group/other classes from the mode bits plus
named users, named groups, and a mask; directories can also carry a
*default* ACL inherited by new children as their access ACL.

Permission bits: r=4 w=2 x=1.
"""

from __future__ import annotations

from dataclasses import dataclass, field

R, W, X = 4, 2, 1


@dataclass
class Acl:
    named_users: dict[int, int] = field(default_factory=dict)   # uid -> perms
    named_groups: dict[int, int] = field(default_factory=dict)  # gid -> perms
    mask: int | None = None  # None = no mask entry (pure mode semantics)

    def to_dict(self) -> dict:
        return {
            "users": {str(k): v for k, v in self.named_users.items()},
            "groups": {str(k): v for k, v in self.named_groups.items()},
            "mask": self.mask,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Acl":
        return cls(
            named_users={int(k): int(v) for k, v in d.get("users", {}).items()},
            named_groups={int(k): int(v) for k, v in d.get("groups", {}).items()},
            mask=d.get("mask"),
        )

    @property
    def effective_mask(self) -> int:
        return 7 if self.mask is None else self.mask


def check_access(
    mode: int,
    owner_uid: int,
    owner_gid: int,
    acl: Acl | None,
    uid: int,
    gids: list[int],
    want: int,
) -> bool:
    """POSIX ACL evaluation order: owner, named user, owning/named
    groups (mask-limited), other. Root bypasses."""
    if uid == 0:
        return True
    owner_bits = (mode >> 6) & 7
    group_bits = (mode >> 3) & 7
    other_bits = mode & 7
    if uid == owner_uid:
        return (owner_bits & want) == want
    if acl is not None and uid in acl.named_users:
        return (acl.named_users[uid] & acl.effective_mask & want) == want
    group_candidates = []
    if owner_gid in gids:
        bits = group_bits
        if acl is not None and acl.mask is not None:
            bits &= acl.mask
        group_candidates.append(bits)
    if acl is not None:
        for gid, perms in acl.named_groups.items():
            if gid in gids:
                group_candidates.append(perms & acl.effective_mask)
    if group_candidates:
        # POSIX: access granted if ANY matching group entry grants it
        return any((bits & want) == want for bits in group_candidates)
    return (other_bits & want) == want
