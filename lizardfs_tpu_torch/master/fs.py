"""In-memory file system tree with deterministic, replayable mutations.

The analog of the reference's FSNode tree + filesystem_operations
(reference: src/master/filesystem_node_types.h:88-320,
filesystem_operations.cc). The key architectural property carried over:
**every mutation is expressed as a deterministic operation record** —
all non-deterministic inputs (allocated inode numbers, timestamps) are
chosen once by the live master, serialized into the changelog, and the
same ``apply_*`` code path replays them on shadows/restore
(src/master/restore.h:28 pattern). The changelog is therefore exact by
construction.

Operation records are JSON objects with an ``op`` field; see OPS at the
bottom. File content geometry: a file's data is a list of chunk ids
indexed by chunk position (64 MiB each).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from lizardfs_tpu_torch.constants import EATTR_LIFECYCLE, MFSCHUNKSIZE
from lizardfs_tpu_torch.proto import status as st

ROOT_INODE = 1

TYPE_FILE = 1
TYPE_DIR = 2
TYPE_SYMLINK = 3


class FsError(Exception):
    def __init__(self, code: int, msg: str = ""):
        self.code = code
        super().__init__(f"{st.name(code)}{(': ' + msg) if msg else ''}")


@dataclass(slots=True)
class Node:
    """One inode. ``slots=True`` drops the per-instance __dict__: at
    1M synthetic files the master costs ~620 bytes/inode vs ~740
    without slots (see doc/migration.md "master RAM"), and attribute
    typos fail loudly instead of growing the namespace."""

    inode: int
    ftype: int
    mode: int = 0o644
    uid: int = 0
    gid: int = 0
    atime: int = 0
    mtime: int = 0
    ctime: int = 0
    goal: int = 1
    trash_time: int = 86400
    # extra-attribute flags (constants.py EATTR_*): noowner / nocache /
    # noentrycache — replicated via the "seteattr" changelog op
    eattr: int = 0
    # files
    length: int = 0
    chunks: list[int] = field(default_factory=list)  # chunk ids by index, 0 = hole
    # directories
    children: dict[str, int] = field(default_factory=dict)
    # symlinks
    symlink_target: str = ""
    # link count (parents holding an edge to this node)
    nlink: int = 0
    # parent directory inodes holding edges to this node (one entry per
    # edge; duplicates allowed for hardlinks in one dir). Directories
    # always have exactly one.
    parents: list[int] = field(default_factory=list)
    # extended attributes
    xattrs: dict[str, bytes] = field(default_factory=dict)
    # POSIX ACLs, stored as plain dicts (master/acl.py evaluates)
    acl: dict | None = None
    default_acl: dict | None = None
    # RichACL (NFSv4-style, master/richacl.py evaluates); when set it
    # takes precedence over the POSIX ACL for permission checks
    rich_acl: dict | None = None
    # directories: recursive subtree statistics (fsnodes statistics
    # analog) — counts include the directory itself
    stat_inodes: int = 1
    stat_bytes: int = 0

    def to_dict(self) -> dict:
        import base64

        d = {
            "inode": self.inode,
            "ftype": self.ftype,
            "mode": self.mode,
            "uid": self.uid,
            "gid": self.gid,
            "atime": self.atime,
            "mtime": self.mtime,
            "ctime": self.ctime,
            "goal": self.goal,
            "trash_time": self.trash_time,
            "nlink": self.nlink,
            "parents": self.parents,
        }
        if self.eattr:
            d["eattr"] = self.eattr
        if self.xattrs:
            d["xattrs"] = {
                k: base64.b64encode(v).decode() for k, v in self.xattrs.items()
            }
        if self.acl is not None:
            d["acl"] = self.acl
        if self.default_acl is not None:
            d["default_acl"] = self.default_acl
        if self.rich_acl is not None:
            d["rich_acl"] = self.rich_acl
        if self.ftype == TYPE_FILE:
            d["length"] = self.length
            d["chunks"] = self.chunks
        elif self.ftype == TYPE_DIR:
            d["children"] = self.children
            d["stat_inodes"] = self.stat_inodes
            d["stat_bytes"] = self.stat_bytes
        elif self.ftype == TYPE_SYMLINK:
            d["symlink_target"] = self.symlink_target
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        import base64

        n = cls(inode=d["inode"], ftype=d["ftype"])
        for k, v in d.items():
            if k == "children":
                n.children = {str(name): int(i) for name, i in v.items()}
            elif k == "xattrs":
                n.xattrs = {
                    key: base64.b64decode(val) for key, val in v.items()
                }
            elif hasattr(n, k):
                setattr(n, k, v)
        return n


class FsTree:
    """The namespace + attributes. No I/O here; pure data structure."""

    def __init__(self):
        self.nodes: dict[int, Node] = {}
        self.next_inode = ROOT_INODE + 1
        self.trash: dict[int, tuple[str, int]] = {}  # inode -> (name, del_ts)
        # open-file registry + sustained namespace (reference: "reserved"
        # files, filesystem_node_types.h trash & reserved namespaces):
        # inode -> {session_id: open count}; a file whose last name goes
        # away while open moves to `sustained` instead of dying, and is
        # freed at the last release. Replicated via acquire/release ops.
        self.open_refs: dict[int, dict[int, int]] = {}
        self.sustained: set[int] = set()
        # directories carrying the EATTR_LIFECYCLE marker bit (S3
        # lifecycle rules): maintained by apply_seteattr / apply_rmdir
        # and rebuilt on load, so the master's lifecycle scanner never
        # walks the whole namespace just to find its roots
        self.lifecycle_dirs: set[int] = set()
        root = Node(inode=ROOT_INODE, ftype=TYPE_DIR, mode=0o755, nlink=1)
        self.nodes[ROOT_INODE] = root

    # --- helpers -------------------------------------------------------------

    def node(self, inode: int) -> Node:
        n = self.nodes.get(inode)
        if n is None:
            raise FsError(st.ENOENT, f"inode {inode}")
        return n

    def dir_node(self, inode: int) -> Node:
        n = self.node(inode)
        if n.ftype != TYPE_DIR:
            raise FsError(st.ENOTDIR, f"inode {inode}")
        return n

    def file_node(self, inode: int) -> Node:
        n = self.node(inode)
        if n.ftype != TYPE_FILE:
            raise FsError(st.EISDIR if n.ftype == TYPE_DIR else st.EINVAL)
        return n

    def alloc_inode(self) -> int:
        inode = self.next_inode
        self.next_inode += 1
        return inode

    def _add_stats(self, dir_inode: int, d_inodes: int, d_bytes: int) -> None:
        """Propagate subtree statistic deltas up the directory chain
        (fsnodes_add_stats analog). Each edge counts once."""
        seen = 0
        cur = dir_inode
        while True:
            n = self.nodes.get(cur)
            if n is None or n.ftype != TYPE_DIR:
                return
            n.stat_inodes += d_inodes
            n.stat_bytes += d_bytes
            if cur == ROOT_INODE or not n.parents:
                return
            cur = n.parents[0]
            seen += 1
            if seen > 4096:  # corrupt parent chain guard
                return

    def _node_weight(self, n: Node) -> tuple[int, int]:
        """(inodes, bytes) a single edge to this node contributes."""
        if n.ftype == TYPE_DIR:
            return n.stat_inodes, n.stat_bytes
        if n.ftype == TYPE_FILE:
            return 1, n.length
        return 1, 0

    def path_of(self, inode: int) -> str:
        """Best-effort absolute path (first hardlink); operator-facing
        (tape archive naming, diagnostics) — not a lookup primitive."""
        parts: list[str] = []
        cur = inode
        for _ in range(4096):  # corrupt parent chain guard
            if cur == ROOT_INODE:
                return "/" + "/".join(reversed(parts))
            n = self.nodes.get(cur)
            if n is None or not n.parents:
                break
            parent = self.nodes.get(n.parents[0])
            if parent is None or parent.ftype != TYPE_DIR:
                break
            name = next(
                (nm for nm, ch in parent.children.items() if ch == cur), None
            )
            if name is None:
                break
            parts.append(name)
            cur = parent.inode
        return f"/.inode/{inode}"

    def lookup(self, parent: int, name: str) -> Node:
        p = self.dir_node(parent)
        inode = p.children.get(name)
        if inode is None:
            raise FsError(st.ENOENT, name)
        return self.node(inode)

    # --- deterministic mutations (replayed verbatim from the changelog) ------

    def apply_mknode(
        self,
        parent: int,
        name: str,
        inode: int,
        ftype: int,
        mode: int,
        uid: int,
        gid: int,
        ts: int,
        goal: int,
        trash_time: int,
        symlink_target: str = "",
    ) -> Node:
        p = self.dir_node(parent)
        if name in p.children:
            raise FsError(st.EEXIST, name)
        if not name or "/" in name or name in (".", ".."):
            raise FsError(st.EINVAL, repr(name))
        if len(name) > 255:
            raise FsError(st.NAME_TOO_LONG, name)
        n = Node(
            inode=inode,
            ftype=ftype,
            mode=mode,
            uid=uid,
            gid=gid,
            atime=ts,
            mtime=ts,
            ctime=ts,
            goal=goal,
            trash_time=trash_time,
            symlink_target=symlink_target,
            nlink=1,
            parents=[parent],
        )
        # POSIX default-ACL inheritance: a directory's default ACL
        # becomes the access ACL of new children (and propagates as the
        # default for child directories)
        if p.default_acl is not None:
            n.acl = dict(p.default_acl)
            if ftype == TYPE_DIR:
                n.default_acl = dict(p.default_acl)
        if p.rich_acl is not None:
            from lizardfs_tpu_torch.master import richacl as richacl_mod

            inherited = richacl_mod.RichAcl.from_dict(p.rich_acl).inherited(
                ftype == TYPE_DIR
            )
            if inherited is not None:
                n.rich_acl = inherited.to_dict()
        self.nodes[inode] = n
        p.children[name] = inode
        p.mtime = p.ctime = ts
        self.next_inode = max(self.next_inode, inode + 1)
        self._add_stats(parent, 1, 0)
        return n

    def apply_unlink(self, parent: int, name: str, ts: int, to_trash: bool) -> Node:
        p = self.dir_node(parent)
        inode = p.children.get(name)
        if inode is None:
            raise FsError(st.ENOENT, name)
        n = self.node(inode)
        if n.ftype == TYPE_DIR:
            raise FsError(st.EPERM, "unlink of directory")
        del p.children[name]
        p.mtime = p.ctime = ts
        wi, wb = self._node_weight(n)
        self._add_stats(parent, -wi, -wb)
        if parent in n.parents:
            n.parents.remove(parent)
        n.nlink -= 1
        n.ctime = ts
        if n.nlink <= 0:
            if to_trash and n.ftype == TYPE_FILE and n.trash_time > 0:
                # keep the last parent+name so undelete can restore
                self.trash[inode] = (name, ts + n.trash_time, parent)
            elif self.open_refs.get(inode):
                # unlink-while-open (POSIX): the data outlives the last
                # name until the last close — the reference's "reserved"
                self.sustained.add(inode)
            else:
                del self.nodes[inode]
        return n

    def apply_rmdir(self, parent: int, name: str, ts: int) -> None:
        p = self.dir_node(parent)
        inode = p.children.get(name)
        if inode is None:
            raise FsError(st.ENOENT, name)
        n = self.node(inode)
        if n.ftype != TYPE_DIR:
            raise FsError(st.ENOTDIR, name)
        if n.children:
            raise FsError(st.ENOTEMPTY, name)
        del p.children[name]
        del self.nodes[inode]
        self.lifecycle_dirs.discard(inode)
        p.mtime = p.ctime = ts
        self._add_stats(parent, -1, 0)

    def apply_rename(
        self, parent_src: int, name_src: str, parent_dst: int, name_dst: str, ts: int
    ) -> None:
        ps = self.dir_node(parent_src)
        pd = self.dir_node(parent_dst)
        inode = ps.children.get(name_src)
        if inode is None:
            raise FsError(st.ENOENT, name_src)
        moving = self.node(inode)
        # validate EVERYTHING before mutating: a raise after a partial
        # mutation would diverge the live tree from the changelog
        if moving.ftype == TYPE_DIR:
            # cycle check: cannot move a directory under itself
            cur = parent_dst
            while cur != ROOT_INODE:
                if cur == inode:
                    raise FsError(st.EINVAL, "rename cycle")
                cur = self._parent_of_dir(cur)
        existing = pd.children.get(name_dst)
        if existing is not None:
            ex = self.node(existing)
            if ex.ftype == TYPE_DIR:
                if ex.children:
                    raise FsError(st.ENOTEMPTY, name_dst)
                del self.nodes[existing]
                del pd.children[name_dst]
                self._add_stats(parent_dst, -1, 0)
            else:
                self.apply_unlink(parent_dst, name_dst, ts, to_trash=True)
        wi, wb = self._node_weight(moving)
        del ps.children[name_src]
        self._add_stats(parent_src, -wi, -wb)
        if parent_src in moving.parents:
            moving.parents.remove(parent_src)
        pd.children[name_dst] = inode
        moving.parents.append(parent_dst)
        self._add_stats(parent_dst, wi, wb)
        ps.mtime = ps.ctime = ts
        pd.mtime = pd.ctime = ts
        moving.ctime = ts

    def _parent_of_dir(self, inode: int) -> int:
        n = self.nodes.get(inode)
        if n is not None and n.parents:
            return n.parents[0]
        return ROOT_INODE

    def apply_link(self, inode: int, parent: int, name: str, ts: int) -> Node:
        n = self.file_node(inode)
        p = self.dir_node(parent)
        if name in p.children:
            raise FsError(st.EEXIST, name)
        p.children[name] = inode
        n.nlink += 1
        n.parents.append(parent)
        n.ctime = ts
        p.mtime = p.ctime = ts
        self._add_stats(parent, 1, n.length)
        # re-linking a sustained (nameless-but-open) inode gives it a
        # name again: it is a normal file now — the last release must
        # NOT free it out from under the new directory entry
        self.sustained.discard(inode)
        return n

    def apply_setattr(
        self, inode: int, set_mask: int, mode: int, uid: int, gid: int,
        atime: int, mtime: int, ts: int, trash_time: int = 0,
    ) -> Node:
        n = self.node(inode)
        if set_mask & 1:
            n.mode = mode
        if set_mask & 2:
            n.uid = uid
        if set_mask & 4:
            n.gid = gid
        if set_mask & 8:
            n.atime = atime
        if set_mask & 16:
            n.mtime = mtime
        if set_mask & 32:
            n.trash_time = trash_time
        n.ctime = ts
        return n

    def apply_setgoal(self, inode: int, goal: int, ts: int) -> Node:
        n = self.node(inode)
        n.goal = goal
        n.ctime = ts
        return n

    def apply_seteattr(self, inode: int, eattr: int, ts: int) -> Node:
        n = self.node(inode)
        n.eattr = eattr & 0xFF
        n.ctime = ts
        if n.ftype == TYPE_DIR:
            if n.eattr & EATTR_LIFECYCLE:
                self.lifecycle_dirs.add(inode)
            else:
                self.lifecycle_dirs.discard(inode)
        return n

    def apply_set_chunk(self, inode: int, chunk_index: int, chunk_id: int) -> Node:
        """Attach a chunk id at a file position (write path)."""
        n = self.file_node(inode)
        while len(n.chunks) <= chunk_index:
            n.chunks.append(0)
        n.chunks[chunk_index] = chunk_id
        return n

    def apply_set_length(self, inode: int, length: int, ts: int,
                         drop_chunks: bool = True) -> list[int]:
        """Set file length; returns chunk ids dropped past the new end
        (the caller releases them in the chunk registry).

        ``drop_chunks=False`` is the write-path grow (WriteChunkEnd):
        concurrent chunk writes attach higher chunk indices before
        earlier chunks finish, so a length update for chunk N must never
        discard an already-attached chunk N+1 — only truncate drops."""
        n = self.file_node(inode)
        delta = length - n.length
        for parent in n.parents:
            self._add_stats(parent, 0, delta)
        n.length = length
        n.mtime = n.ctime = ts
        if not drop_chunks:
            return []
        nchunks = (length + MFSCHUNKSIZE - 1) // MFSCHUNKSIZE if length else 0
        removed = [c for c in n.chunks[nchunks:] if c]
        del n.chunks[nchunks:]
        return removed

    def apply_purge_trash(self, inode: int) -> None:
        self.trash.pop(inode, None)
        if self.open_refs.get(inode):
            # trash expiry with live openers: sustain instead of
            # breaking their handles; freed at the last release
            self.sustained.add(inode)
        else:
            self.nodes.pop(inode, None)

    def apply_acquire(self, inode: int, sid: int) -> None:
        self.node(inode)  # must exist
        refs = self.open_refs.setdefault(inode, {})
        refs[sid] = refs.get(sid, 0) + 1

    def apply_release(self, inode: int, sid: int) -> bool:
        """Drop one open ref. True when the LAST ref of a sustained file
        went away — the caller frees chunks/quota and the node."""
        refs = self.open_refs.get(inode)
        if not refs or sid not in refs:
            return False
        refs[sid] -= 1
        if refs[sid] <= 0:
            del refs[sid]
        if refs:
            return False
        del self.open_refs[inode]
        if inode in self.sustained:
            self.sustained.discard(inode)
            return True
        return False

    def apply_undelete(self, inode: int, ts: int) -> Node:
        """Restore a trashed file to its original directory (or the root
        if that directory is gone), resolving name collisions with a
        suffix (trash-restore analog)."""
        entry = self.trash.get(inode)
        if entry is None:
            raise FsError(st.ENOENT, f"inode {inode} not in trash")
        name, _, parent = entry
        p = self.nodes.get(parent)
        if p is None or p.ftype != TYPE_DIR:
            parent = ROOT_INODE
            p = self.dir_node(parent)
        final = name
        i = 1
        while final in p.children:
            final = f"{name}.restored.{i}"
            i += 1
        n = self.node(inode)
        p.children[final] = inode
        n.nlink = 1
        n.parents = [parent]
        n.ctime = ts
        p.mtime = p.ctime = ts
        del self.trash[inode]
        self._add_stats(parent, 1, n.length)
        return n

    def apply_set_acl(self, inode: int, access: dict | None,
                      default: dict | None, ts: int) -> None:
        n = self.node(inode)
        n.acl = dict(access) if access else None
        if n.ftype == TYPE_DIR:
            n.default_acl = dict(default) if default else None
        n.ctime = ts

    def apply_set_rich_acl(self, inode: int, acl: dict | None,
                           ts: int) -> None:
        n = self.node(inode)
        n.rich_acl = dict(acl) if acl else None
        n.ctime = ts

    def apply_set_xattr(self, inode: int, name: str, value_b64: str, ts: int) -> None:
        import base64

        n = self.node(inode)
        if value_b64 == "":
            if name not in n.xattrs:
                raise FsError(st.ENOATTR, name)
            del n.xattrs[name]
        else:
            if len(name) > 255:
                raise FsError(st.NAME_TOO_LONG, name)
            n.xattrs[name] = base64.b64decode(value_b64)
        n.ctime = ts

    def apply_append_chunks(
        self, inode_dst: int, inode_src: int, ts: int
    ) -> list[int]:
        """O(1)-per-chunk concatenation (append_file.cc analog): pad
        the destination to a chunk boundary, then share the source's
        chunk ids onto its tail. Returns the shared chunk ids (the
        caller bumps refcounts — COW on a later write keeps the files
        independent)."""
        dst = self.file_node(inode_dst)
        src = self.file_node(inode_src)
        if inode_dst == inode_src:
            raise FsError(st.EINVAL, "append onto itself")
        padded = (
            (dst.length + MFSCHUNKSIZE - 1) // MFSCHUNKSIZE * MFSCHUNKSIZE
        )
        pad_chunks = padded // MFSCHUNKSIZE
        if len(dst.chunks) > pad_chunks:
            # a chunk attached past the length boundary = a write in
            # flight (the master handler refuses CHUNK_BUSY before
            # committing, so apply/replay must never see this)
            raise FsError(st.CHUNK_BUSY, "append under in-flight write")
        while len(dst.chunks) < pad_chunks:
            dst.chunks.append(0)  # holes read as zeros
        shared = list(src.chunks)
        # a source shorter than its chunk count never happens, but a
        # trailing hole does: share slots verbatim (0 stays a hole)
        dst.chunks.extend(shared)
        new_length = padded + src.length
        delta = new_length - dst.length
        dst.length = new_length
        dst.mtime = dst.ctime = ts
        for parent in dst.parents:
            self._add_stats(parent, 0, delta)
        return [c for c in shared if c]

    def apply_demote(self, inode: int, ts: int) -> list[int]:
        """Tape-tier demote: drop the file's chunk list (the caller
        releases the ids in the registry) while KEEPING length and
        mtime — the content still exists on tape, stamped by exactly
        those fields, and stat must keep telling the truth about the
        object's size. Only ctime moves (a demote is a metadata
        event)."""
        n = self.file_node(inode)
        removed = [c for c in n.chunks if c]
        n.chunks = []
        n.ctime = ts
        return removed

    def apply_repair_zero_chunk(
        self, inode: int, chunk_index: int, ts: int
    ) -> int:
        """filerepair's last resort: zero-fill an unrecoverable chunk
        by turning its slot into a hole. Returns the released chunk id
        (0 when the slot was already a hole)."""
        n = self.file_node(inode)
        if chunk_index >= len(n.chunks):
            return 0
        cid = n.chunks[chunk_index]
        n.chunks[chunk_index] = 0
        n.mtime = n.ctime = ts
        return cid

    def apply_snapshot(
        self, src_inode: int, dst_parent: int, dst_name: str,
        inode_map: dict[str, int], ts: int,
    ) -> list[tuple[int, int]]:
        """Clone a subtree; files share chunk ids (COW happens at write
        time via chunk refcounts). ``inode_map`` assigns the new inode
        for every cloned source inode (chosen by the live master so
        replay is deterministic). Returns [(chunk_id, +1 refcount)]
        deltas for the registry."""
        src = self.node(src_inode)
        p = self.dir_node(dst_parent)
        if dst_name in p.children:
            raise FsError(st.EEXIST, dst_name)
        shared: list[tuple[int, int]] = []

        def clone(node: Node, parent_inode: int, name: str) -> None:
            new_inode = inode_map[str(node.inode)]
            new = Node(
                inode=new_inode, ftype=node.ftype, mode=node.mode,
                uid=node.uid, gid=node.gid, atime=ts, mtime=node.mtime,
                ctime=ts, goal=node.goal, trash_time=node.trash_time,
                length=node.length, chunks=list(node.chunks),
                symlink_target=node.symlink_target, nlink=1,
                parents=[parent_inode], xattrs=dict(node.xattrs),
            )
            # ACLs travel with the snapshot (dropping them while keeping
            # a setrichacl-lifted mode would widen access on the clone)
            new.acl = dict(node.acl) if node.acl else None
            new.default_acl = (
                dict(node.default_acl) if node.default_acl else None
            )
            new.rich_acl = dict(node.rich_acl) if node.rich_acl else None
            self.nodes[new_inode] = new
            self.nodes[parent_inode].children[name] = new_inode
            self.next_inode = max(self.next_inode, new_inode + 1)
            for cid in new.chunks:
                if cid:
                    shared.append((cid, 1))
            if node.ftype == TYPE_DIR:
                for child_name, child_inode in sorted(node.children.items()):
                    clone(self.node(child_inode), new_inode, child_name)
                new.stat_inodes = node.stat_inodes
                new.stat_bytes = node.stat_bytes

        clone(src, dst_parent, dst_name)
        wi, wb = self._node_weight(self.node(inode_map[str(src_inode)]))
        self._add_stats(dst_parent, wi, wb)
        p.mtime = p.ctime = ts
        return shared

    # --- persistence -----------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "next_inode": self.next_inode,
            "nodes": [n.to_dict() for n in self.nodes.values()],
            "trash": {str(i): list(v) for i, v in self.trash.items()},
            "open": {
                str(i): {str(s): c for s, c in refs.items()}
                for i, refs in self.open_refs.items() if refs
            },
            "sustained": sorted(self.sustained),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FsTree":
        fs = cls.__new__(cls)
        fs.nodes = {}
        fs.next_inode = d["next_inode"]
        fs.trash = {
            int(i): (v[0], int(v[1]), int(v[2]) if len(v) > 2 else ROOT_INODE)
            for i, v in d.get("trash", {}).items()
        }
        fs.open_refs = {
            int(i): {int(s): int(c) for s, c in refs.items()}
            for i, refs in d.get("open", {}).items()
        }
        fs.sustained = set(d.get("sustained", ()))
        fs.lifecycle_dirs = set()
        for nd in d["nodes"]:
            node = Node.from_dict(nd)
            fs.nodes[node.inode] = node
            if node.ftype == TYPE_DIR and node.eattr & EATTR_LIFECYCLE:
                fs.lifecycle_dirs.add(node.inode)
        if ROOT_INODE not in fs.nodes:
            raise ValueError("image missing root inode")
        return fs

    def checksum_data(self) -> str:
        """Stable digest of the whole tree — master/shadow divergence
        detection (filesystem_checksum analog)."""
        import hashlib

        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()
