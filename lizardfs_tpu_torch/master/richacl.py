"""RichACLs: NFSv4-style allow/deny access-control entries.

The analog of the reference's RichACL support (reference:
src/common/richacl.h RichACL/Ace with ALLOW/DENY types, owner@/group@/
everyone@ special ids, inheritance flags; src/common/acl_converter.cc
POSIX<->Rich conversion). Entries are evaluated IN ORDER: each ACE may
allow or deny some of the still-undecided permission bits; evaluation
ends when every requested bit is decided (NFSv4 semantics — unlike
POSIX ACLs, a later allow cannot override an earlier deny).

Permission mask bits (the subset of NFSv4 masks the file system
serves): r=4 w=2 x=1, matching the POSIX want-masks used by
master/acl.py so the two models share the permission-check call sites.
"""

from __future__ import annotations

from dataclasses import dataclass, field

ALLOW = 0
DENY = 1

# ACE flags (richacl.h:Ace flag analogs)
FILE_INHERIT = 1    # new files under this dir inherit the ACE
DIR_INHERIT = 2     # new subdirs inherit the ACE (and keep inheriting)
INHERIT_ONLY = 4    # the ACE does not apply to this object itself
NO_PROPAGATE = 8    # inherit one level, strip inherit flags on the child

# special principals (richacl.h special ids)
OWNER = "owner@"
GROUP = "group@"
EVERYONE = "everyone@"


@dataclass
class Ace:
    ace_type: int          # ALLOW | DENY
    flags: int             # inheritance flags
    mask: int              # permission bits r|w|x
    who: str               # "owner@" / "group@" / "everyone@" / "u:UID" / "g:GID"

    def to_dict(self) -> dict:
        return {"t": self.ace_type, "f": self.flags, "m": self.mask,
                "w": self.who}

    @classmethod
    def from_dict(cls, d: dict) -> "Ace":
        who = str(d["w"])
        if who not in (OWNER, GROUP, EVERYONE):
            kind, _, ident = who.partition(":")
            if kind not in ("u", "g"):
                raise ValueError(f"bad principal {who!r}")
            who = f"{kind}:{int(ident)}"  # int() rejects garbage ids
        ace_type = int(d["t"])
        if ace_type not in (ALLOW, DENY):
            raise ValueError(f"bad ace type {ace_type}")
        return cls(ace_type, int(d["f"]), int(d["m"]) & 7, who)

    def matches(self, owner_uid: int, owner_gid: int, uid: int,
                gids: list[int]) -> bool:
        if self.who == OWNER:
            return uid == owner_uid
        if self.who == GROUP:
            return owner_gid in gids
        if self.who == EVERYONE:
            return True
        if self.who.startswith("u:"):
            return uid == int(self.who[2:])
        if self.who.startswith("g:"):
            return int(self.who[2:]) in gids
        return False


@dataclass
class RichAcl:
    aces: list[Ace] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"aces": [a.to_dict() for a in self.aces]}

    @classmethod
    def from_dict(cls, d: dict) -> "RichAcl":
        return cls([Ace.from_dict(a) for a in d.get("aces", [])])

    # --- evaluation (richacl.cc permission walk analog) --------------------

    def check_access(self, owner_uid: int, owner_gid: int, uid: int,
                     gids: list[int], want: int,
                     mode: int | None = None) -> bool:
        """NFSv4 walk: first decision per bit wins; undecided bits deny.

        When ``mode`` is given it acts as the Linux-richacl file masks:
        the mode's class bits BOUND what the ACEs can grant (so chmod
        restricts a RichACL'd file and an inherited ACL cannot exceed
        the create mode). setrichacl lifts the mode to the ACL's
        per-class unions (compute_max_masks), so a freshly set ACL is
        not immediately capped.
        """
        if uid == 0:
            return True
        # class membership is over ALL applicable ACEs — it must not be
        # truncated by the grant walk's early exit (a named-user ACE
        # after a deciding everyone@ ACE still puts the caller in the
        # group class for the mode masks)
        matched_class = any(
            ace.who != EVERYONE
            and not ace.flags & INHERIT_ONLY
            and ace.matches(owner_uid, owner_gid, uid, gids)
            for ace in self.aces
        )
        allowed = 0
        denied = 0
        for ace in self.aces:
            if ace.flags & INHERIT_ONLY:
                continue
            if not ace.matches(owner_uid, owner_gid, uid, gids):
                continue
            undecided = ace.mask & ~(allowed | denied)
            if ace.ace_type == ALLOW:
                allowed |= undecided
            else:
                denied |= undecided
            if (want & denied) or (want & ~(allowed | denied)) == 0:
                break
        if mode is not None:
            if uid == owner_uid:
                mask = (mode >> 6) & 7
            elif owner_gid in gids or matched_class:
                mask = (mode >> 3) & 7
            else:
                mask = mode & 7
            allowed &= mask
        return (want & allowed) == want and not (want & denied)

    def compute_max_masks(self, owner_uid: int) -> tuple[int, int, int]:
        """Per-class unions of the ALLOW grants (richacl_compute_max_
        masks analog): what mode bits setrichacl should publish."""
        owner = group = other = 0
        for ace in self.aces:
            if ace.ace_type != ALLOW or ace.flags & INHERIT_ONLY:
                continue
            if ace.who == OWNER or ace.who == f"u:{owner_uid}":
                owner |= ace.mask
            elif ace.who == EVERYONE:
                owner |= ace.mask
                group |= ace.mask
                other |= ace.mask
            else:
                owner |= ace.mask
                group |= ace.mask
        return owner, group, other

    # --- inheritance (richacl inheritance flag semantics) ------------------

    def inherited(self, is_dir: bool) -> "RichAcl | None":
        """The ACL a new child gets, or None if nothing inherits."""
        out = []
        for ace in self.aces:
            if is_dir and ace.flags & DIR_INHERIT:
                flags = ace.flags & ~INHERIT_ONLY
                if ace.flags & NO_PROPAGATE:
                    flags &= ~(FILE_INHERIT | DIR_INHERIT | NO_PROPAGATE)
                out.append(Ace(ace.ace_type, flags, ace.mask, ace.who))
            elif is_dir and ace.flags & FILE_INHERIT:
                # NFSv4: a file-only-inheritable ACE passes THROUGH a
                # subdirectory (inherit-only there) so files deeper in
                # the tree still inherit it
                if not ace.flags & NO_PROPAGATE:
                    out.append(Ace(ace.ace_type,
                                   FILE_INHERIT | INHERIT_ONLY,
                                   ace.mask, ace.who))
            elif not is_dir and ace.flags & FILE_INHERIT:
                # files never propagate further: strip inheritance flags
                out.append(Ace(ace.ace_type, 0, ace.mask, ace.who))
        return RichAcl(out) if out else None


def from_posix(mode: int, acl) -> RichAcl:
    """POSIX(mode [+ Acl]) -> equivalent RichACL (acl_converter.cc
    posixToRich analog).

    POSIX classes never fall through (a group-class member whose class
    grants nothing is denied even if "other" would allow), so every
    class is CLOSED with deny ACEs after its allows: owner first, then
    named users, then the whole group class (union of owning +
    named-group allows, then denies), then everyone.
    """
    owner_bits = (mode >> 6) & 7
    aces = [Ace(ALLOW, 0, owner_bits, OWNER),
            Ace(DENY, 0, 7 & ~owner_bits, OWNER)]
    emask = acl.effective_mask if acl is not None else 7
    if acl is not None:
        for uid, perms in sorted(acl.named_users.items()):
            aces.append(Ace(ALLOW, 0, perms & emask, f"u:{uid}"))
            aces.append(Ace(DENY, 0, 7, f"u:{uid}"))
    # group class: allow every matching entry (POSIX grants if ANY
    # matching group-class entry grants), then close the class
    group_members = [(GROUP, (mode >> 3) & 7 & emask)]
    if acl is not None:
        group_members += [
            (f"g:{gid}", perms & emask)
            for gid, perms in sorted(acl.named_groups.items())
        ]
    for who, perms in group_members:
        aces.append(Ace(ALLOW, 0, perms, who))
    for who, _ in group_members:
        aces.append(Ace(DENY, 0, 7, who))
    aces.append(Ace(ALLOW, 0, mode & 7, EVERYONE))
    return RichAcl(aces)
