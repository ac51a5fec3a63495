"""MetadataStore: the replayable state machine behind the master.

Owns the FS tree + the *persistent* half of the chunk registry and
applies operation records. The live master builds an op, applies it,
and appends it to the changelog; shadows and crash recovery apply the
same records through the same code path — the restore.cc pattern, with
one implementation instead of two.
"""

from __future__ import annotations

from lizardfs_tpu_torch.master.chunks import ChunkRegistry
from lizardfs_tpu_torch.master.fs import FsTree
from lizardfs_tpu_torch.master.locks import LockManager
from lizardfs_tpu_torch.master.quotas import QuotaDatabase


class MetadataStore:
    def __init__(self):
        self.fs = FsTree()
        self.registry = ChunkRegistry()
        self.quotas = QuotaDatabase()
        # held file locks replicate through the changelog so a promoted
        # shadow still knows them (reference: LOCK section,
        # src/master/filesystem_store.cc:952-1180); pending waiters are
        # live-master-only state
        self.locks = LockManager()
        # session-id allocation replicates so a promoted shadow never
        # re-issues an id whose locks are still held (sessions.mfs
        # analog for the id space; live connection state stays local)
        self.next_session = 1
        # cluster fencing epoch (uraft term analog): bumped by the
        # epoch_bump op a freshly elected master commits as its FIRST
        # write. Every register/heartbeat link carries it, so a zombie
        # ex-primary (deposed but still running) is refused by its own
        # former peers instead of having late writes merged. Replicated
        # through the changelog and persisted in the image.
        self.epoch = 0
        # tape-copy records (matotsserv analog): inode -> list of
        # {"label","length","mtime","gen","ts"} archival copies;
        # replicated through the changelog and persisted in the image
        self.tape_copies: dict[int, list[dict]] = {}
        # per-inode content generation: bumped by every content op, it
        # stamps tape copies so a same-second same-length rewrite still
        # reads as stale. Deterministic from the op stream (shadows
        # converge), so excluded from the digest like next_inode.
        self.content_gen: dict[int, int] = {}
        # lifecycle-demoted (tape-only) inodes: inode -> {"length",
        # "mtime", "gen"} content stamp at demote time. A demoted file
        # keeps its length/mtime but holds no chunks — reads/writes are
        # refused with TAPE_RECALL until a recall restores the bytes.
        # Replicated through the changelog (demote frees chunk refs, so
        # shadows must apply it identically) and persisted in the image.
        self.demoted: dict[int, dict] = {}
        # incremental metadata digest (see checksum())
        self._digest = 0
        self.reset_digest()

    # --- op application (the one true mutation path) -------------------------

    def apply(self, op: dict) -> None:
        fn = getattr(self, "_op_" + op["op"], None)
        if fn is None:
            raise ValueError(f"unknown op {op['op']!r}")
        # incremental digest (filesystem_checksum.cc analog): XOR out
        # the touched entities' pre-state hashes, apply, XOR in their
        # post-state hashes. _touched(op) must include every entity that
        # existed before AND may change; entities that appear only after
        # the op (post-only keys) hashed 0 before, so the union form is
        # exact for them. entity_hash(missing) == 0 by convention.
        keys = self._touched(op)
        delta = 0
        for key in keys:
            delta ^= self._entity_hash(key)
        fn(op)
        # unchanged keys cancel (h ^ h == 0); changed keys contribute
        # pre ^ post; post-only keys contribute their fresh hash once
        for key in keys | self._touched(op):
            delta ^= self._entity_hash(key)
        self._digest ^= delta

    def _op_mknode(self, op):
        self.fs.apply_mknode(
            op["parent"], op["name"], op["inode"], op["ftype"], op["mode"],
            op["uid"], op["gid"], op["ts"], op["goal"], op["trash_time"],
            op.get("symlink_target", ""),
        )
        self.quotas.charge(op["uid"], op["gid"], 1, 0)

    def _op_unlink(self, op):
        node = self.fs.apply_unlink(op["parent"], op["name"], op["ts"], op["to_trash"])
        if (
            node.nlink <= 0
            and node.inode not in self.fs.trash
            and node.inode not in self.fs.sustained
        ):
            self.quotas.charge(node.uid, node.gid, -1, -node.length)
            for cid in node.chunks:
                if cid:
                    self.registry.release_chunk(cid)

    def _op_rmdir(self, op):
        parent = self.fs.dir_node(op["parent"])
        child = parent.children.get(op["name"])
        node = self.fs.nodes.get(child) if child else None
        self.fs.apply_rmdir(op["parent"], op["name"], op["ts"])
        if node is not None:
            self.quotas.charge(node.uid, node.gid, -1, 0)

    def _op_rename(self, op):
        # snapshot any destination entry that the rename will overwrite:
        # if it leaves the tree entirely (no trash), its chunk references
        # and quota charges must be released here — the fs layer knows
        # nothing about the registry or quotas
        pre = None
        pd = self.fs.nodes.get(op["parent_dst"])
        if pd is not None and pd.ftype == 2:
            existing = pd.children.get(op["name_dst"])
            if existing is not None:
                ex = self.fs.nodes.get(existing)
                if ex is not None:
                    pre = (ex.inode, ex.uid, ex.gid, ex.length,
                           list(ex.chunks), ex.ftype)
        self.fs.apply_rename(
            op["parent_src"], op["name_src"], op["parent_dst"], op["name_dst"],
            op["ts"],
        )
        if pre is not None and pre[0] not in self.fs.nodes:
            _, uid, gid, length, chunks, ftype = pre
            self.quotas.charge(uid, gid, -1, -length if ftype == 1 else 0)
            for cid in chunks:
                if cid:
                    self.registry.release_chunk(cid)

    def _op_link(self, op):
        self.fs.apply_link(op["inode"], op["parent"], op["name"], op["ts"])

    def _op_setattr(self, op):
        self.fs.apply_setattr(
            op["inode"], op["set_mask"], op["mode"], op["uid"], op["gid"],
            op["atime"], op["mtime"], op["ts"], op.get("trash_time", 0),
        )

    def _op_setgoal(self, op):
        self.fs.apply_setgoal(op["inode"], op["goal"], op["ts"])

    def _op_seteattr(self, op):
        self.fs.apply_seteattr(op["inode"], op["eattr"], op["ts"])

    def _op_set_length(self, op):
        node = self.fs.file_node(op["inode"])
        delta = op["length"] - node.length
        removed = self.fs.apply_set_length(
            op["inode"], op["length"], op["ts"],
            drop_chunks=op.get("drop_chunks", True),
        )
        self.quotas.charge(node.uid, node.gid, 0, delta)
        for cid in removed:
            self.registry.release_chunk(cid)
        self.content_gen[op["inode"]] = \
            self.content_gen.get(op["inode"], 0) + 1

    def _op_create_chunk(self, op):
        self.registry.create_chunk(
            op["slice_type"], chunk_id=op["chunk_id"], version=op["version"],
            copies=op.get("copies", 1), goal_id=op.get("goal_id", 0),
        )

    def _op_set_chunk(self, op):
        self.fs.apply_set_chunk(op["inode"], op["chunk_index"], op["chunk_id"])
        self.content_gen[op["inode"]] = \
            self.content_gen.get(op["inode"], 0) + 1

    def _op_bump_chunk_version(self, op):
        self.registry.chunk(op["chunk_id"]).version = op["version"]

    def _op_delete_chunk(self, op):
        self.registry.delete_chunk(op["chunk_id"])

    def _op_goal_boost(self, op):
        """Heat-driven temporary goal boost: raise the chunk's wanted
        copy count by ``boost`` extra copies (master/heat.py adaptive
        replication). The live master decides thresholds/hysteresis
        OUTSIDE the op; apply is unconditional on a missing chunk being
        a no-op (the chunk may have been released between the heat
        decision and a shadow's replay)."""
        self.registry.set_boost(op["chunk_id"], op["boost"])

    def _op_goal_demote(self, op):
        """Heat decayed back under the demote threshold: drop the
        temporary boost (the redundant-copy path then sheds the extra
        replicas). No-op on a missing chunk, same as goal_boost."""
        self.registry.set_boost(op["chunk_id"], 0)

    def _op_purge_trash(self, op):
        node = self.fs.nodes.get(op["inode"])
        will_sustain = bool(self.fs.open_refs.get(op["inode"]))
        if node is not None and not will_sustain:
            # a sustained file keeps its chunks/quota until last close
            self.quotas.charge(node.uid, node.gid, -1, -node.length)
            for cid in node.chunks:
                if cid:
                    self.registry.release_chunk(cid)
        self.fs.apply_purge_trash(op["inode"])
        if op["inode"] not in self.fs.nodes:
            self.content_gen.pop(op["inode"], None)
            self.demoted.pop(op["inode"], None)

    def _op_undelete(self, op):
        self.fs.apply_undelete(op["inode"], op["ts"])

    def _op_set_acl(self, op):
        self.fs.apply_set_acl(
            op["inode"], op.get("access"), op.get("default"), op["ts"]
        )

    def _op_set_rich_acl(self, op):
        self.fs.apply_set_rich_acl(op["inode"], op.get("acl"), op["ts"])

    def _op_set_xattr(self, op):
        self.fs.apply_set_xattr(op["inode"], op["name"], op["value"], op["ts"])

    def _op_set_quota(self, op):
        if op.get("remove"):
            self.quotas.remove(op["kind"], op["owner_id"])
        else:
            self.quotas.set_limits(
                op["kind"], op["owner_id"], op["soft_inodes"],
                op["hard_inodes"], op["soft_bytes"], op["hard_bytes"],
            )

    def _op_snapshot(self, op):
        shared = self.fs.apply_snapshot(
            op["src_inode"], op["dst_parent"], op["dst_name"],
            op["inode_map"], op["ts"],
        )
        for cid, delta in shared:
            chunk = self.registry.chunks.get(cid)
            if chunk is not None:
                chunk.refcount += delta
        # cloned nodes charge their owners
        src = self.fs.node(op["inode_map"][str(op["src_inode"])])
        wi, wb = self.fs._node_weight(src)
        self.quotas.charge(src.uid, src.gid, wi, wb)

    def _op_append_chunks(self, op):
        dst = self.fs.file_node(op["inode_dst"])
        old_len = dst.length
        shared = self.fs.apply_append_chunks(
            op["inode_dst"], op["inode_src"], op["ts"]
        )
        for cid in shared:
            chunk = self.registry.chunks.get(cid)
            if chunk is not None:
                chunk.refcount += 1
        self.quotas.charge(dst.uid, dst.gid, 0, dst.length - old_len)
        self.content_gen[op["inode_dst"]] = \
            self.content_gen.get(op["inode_dst"], 0) + 1

    def _op_repair_zero_chunk(self, op):
        cid = self.fs.apply_repair_zero_chunk(
            op["inode"], op["chunk_index"], op["ts"]
        )
        if cid:
            self.registry.release_chunk(cid)
        self.content_gen[op["inode"]] = \
            self.content_gen.get(op["inode"], 0) + 1

    def _op_cow_chunk(self, op):
        """Copy-on-write: a file's shared chunk was duplicated; point the
        file at the private copy."""
        old = self.registry.chunks.get(op["old_chunk_id"])
        self.registry.create_chunk(
            op["slice_type"], chunk_id=op["new_chunk_id"],
            version=op["version"], copies=op.get("copies", 1),
            goal_id=op.get("goal_id", 0),
        )
        if old is not None:
            old.refcount -= 1
        self.fs.apply_set_chunk(op["inode"], op["chunk_index"], op["new_chunk_id"])

    # --- open-file registry / sustained files (reference: "reserved") ---

    def _op_acquire(self, op):
        self.fs.apply_acquire(op["inode"], op["sid"])

    def _release_one(self, inode: int, sid: int) -> None:
        node = self.fs.nodes.get(inode)
        if self.fs.apply_release(inode, sid) and node is not None:
            # last close of a sustained (nameless) file: free it now —
            # the purge_trash pattern, deferred to the final release
            self.quotas.charge(node.uid, node.gid, -1, -node.length)
            for cid in node.chunks:
                if cid:
                    self.registry.release_chunk(cid)
            self.fs.nodes.pop(inode, None)
            self.content_gen.pop(inode, None)
            self.demoted.pop(inode, None)

    def _op_release(self, op):
        self._release_one(op["inode"], op["sid"])

    def _op_release_session_opens(self, op):
        sid = op["sid"]
        for inode in [
            i for i, refs in list(self.fs.open_refs.items()) if sid in refs
        ]:
            while sid in self.fs.open_refs.get(inode, {}):
                self._release_one(inode, sid)

    def _op_lock_posix(self, op):
        self.locks.posix(
            op["inode"], op["sid"], op["token"], op["start"], op["end"],
            op["ltype"],
        )

    def _op_lock_flock(self, op):
        self.locks.flock(op["inode"], op["sid"], op["token"], op["ltype"])

    def _op_lock_release_session(self, op):
        self.locks.release_session(op["sid"])

    def _op_session_new(self, op):
        self.next_session = max(self.next_session, op["sid"] + 1)

    def _op_epoch_bump(self, op):
        """Fenced promotion (HA tentpole): a freshly elected master's
        first committed write claims the new cluster epoch. max() keeps
        replay monotone even if an old line is re-applied."""
        self.epoch = max(self.epoch, op["epoch"])

    # --- persistence sections --------------------------------------------------

    def to_sections(self) -> dict:
        return {
            "fs": self.fs.to_dict(),
            "chunks": {
                "next_chunk_id": self.registry.next_chunk_id,
                "table": [
                    {"id": c.chunk_id, "version": c.version,
                     "slice_type": c.slice_type, "copies": c.copies,
                     "refcount": c.refcount, "goal_id": c.goal_id,
                     "boost": c.boost}
                    for c in self.registry.chunks.values()
                ],
            },
            "quotas": self.quotas.to_dict(),
            "next_session": self.next_session,
            "epoch": self.epoch,
            "tape": {str(i): c for i, c in self.tape_copies.items() if c},
            "tape_gen": {str(i): g for i, g in self.content_gen.items()},
            "demoted": {str(i): d for i, d in self.demoted.items()},
            "locks": {
                kind: {
                    str(inode): [
                        [r.start, r.end, r.ltype, r.owner.session_id,
                         r.owner.token]
                        for r in fl.ranges
                    ]
                    for inode, fl in table.items() if fl.ranges
                }
                for kind, table in (
                    ("posix", self.locks.posix_files),
                    ("flock", self.locks.flock_files),
                )
            },
        }

    def load_sections(self, doc: dict) -> None:
        self.fs = FsTree.from_dict(doc["fs"])
        self.registry = ChunkRegistry()
        ch = doc["chunks"]
        self.registry.next_chunk_id = ch["next_chunk_id"]
        for row in ch["table"]:
            c = self.registry.create_chunk(
                row["slice_type"], chunk_id=row["id"], version=row["version"],
                copies=row.get("copies", 1), goal_id=row.get("goal_id", 0),
            )
            c.refcount = row.get("refcount", 1)
            self.registry.set_boost(c.chunk_id, row.get("boost", 0))
        self.registry.next_chunk_id = ch["next_chunk_id"]
        self.quotas = QuotaDatabase.from_dict(doc.get("quotas", {}))
        self.locks = LockManager()
        self.next_session = int(doc.get("next_session", 1))
        self.epoch = int(doc.get("epoch", 0))
        self.tape_copies = {
            int(i): list(c) for i, c in doc.get("tape", {}).items()
        }
        self.content_gen = {
            int(i): int(g) for i, g in doc.get("tape_gen", {}).items()
        }
        self.demoted = {
            int(i): dict(d) for i, d in doc.get("demoted", {}).items()
        }
        from lizardfs_tpu_torch.master.locks import FileLocks, Owner, Range

        for kind, table in (
            ("posix", self.locks.posix_files),
            ("flock", self.locks.flock_files),
        ):
            for inode_s, rows in doc.get("locks", {}).get(kind, {}).items():
                fl = table[int(inode_s)] = FileLocks()
                fl.ranges = [
                    Range(start, end, ltype, Owner(sid, token))
                    for start, end, ltype, sid, token in rows
                ]
        self.reset_digest()

    # --- incremental checksum (filesystem_checksum.cc analog) ---------------
    #
    # The digest is the XOR of 128-bit hashes of every persistent entity:
    # nodes, trash entries, chunks, quota entries, per-inode lock tables,
    # and a misc tuple of allocator counters. apply() maintains it in
    # O(touched entities) per op; full_digest() recomputes from scratch
    # (used at load, by offline tools, and by the background verifier in
    # the image-dump child — the filesystem_checksum_background_updater
    # analog). Derived aggregates (directory stat_inodes/stat_bytes) are
    # excluded: they are recomputable and would make every write touch
    # its whole ancestor chain.

    def _h(self, *parts) -> int:
        import hashlib

        b = hashlib.blake2b(repr(parts).encode(), digest_size=16)
        return int.from_bytes(b.digest(), "big")

    def _entity_hash(self, key: tuple) -> int:
        kind = key[0]
        if kind == "node":
            n = self.fs.nodes.get(key[1])
            if n is None:
                return 0
            # children are hashed as separate ("edge", parent, name)
            # entities — otherwise every create in a directory would
            # hash the whole directory (O(children) per op); derived
            # stats are excluded as recomputable. Collections with
            # nondeterministic order (xattrs, acls) canonicalize.
            import json

            return self._h(
                "node", n.inode, n.ftype, n.mode, n.uid, n.gid, n.atime,
                n.mtime, n.ctime, n.goal, n.trash_time, n.nlink,
                tuple(n.parents),
                tuple(sorted(n.xattrs.items())) if n.xattrs else (),
                json.dumps(n.acl, sort_keys=True),
                json.dumps(n.default_acl, sort_keys=True),
                json.dumps(n.rich_acl, sort_keys=True),
                n.length, tuple(n.chunks) if n.chunks else (),
                n.symlink_target,
            )
        if kind == "edge":
            p = self.fs.nodes.get(key[1])
            if p is None or p.ftype != 2:
                return 0
            child = p.children.get(key[2])
            return 0 if child is None else self._h("edge", key[1], key[2],
                                                   child)
        if kind == "trash":
            entry = self.fs.trash.get(key[1])
            return 0 if entry is None else self._h("trash", key[1], tuple(entry))
        if kind == "chunk":
            c = self.registry.chunks.get(key[1])
            if c is None:
                return 0
            return self._h(
                "chunk", c.chunk_id, c.version, c.slice_type, c.copies,
                c.refcount, c.goal_id, c.boost,
            )
        if kind == "quota":
            e = self.quotas.entries.get((key[1], key[2]))
            if e is None:
                return 0
            import json

            return self._h("quota", key[1], key[2],
                           json.dumps(e.to_dict(), sort_keys=True))
        if kind == "locks":
            table = (self.locks.posix_files if key[1] == "posix"
                     else self.locks.flock_files)
            fl = table.get(key[2])
            if fl is None or not fl.ranges:
                return 0
            return self._h("locks", key[1], key[2], [
                (r.start, r.end, r.ltype, r.owner.session_id, r.owner.token)
                for r in fl.ranges
            ])
        if kind == "tape":
            copies = self.tape_copies.get(key[1])
            if not copies:
                return 0
            return self._h("tape", key[1], [
                (c["label"], c["length"], c["mtime"], c.get("gen", 0),
                 c["ts"])
                for c in copies
            ])
        if kind == "demoted":
            d = self.demoted.get(key[1])
            if d is None:
                return 0
            return self._h(
                "demoted", key[1], d["length"], d["mtime"], d.get("gen", 0)
            )
        if kind == "open":
            refs = self.fs.open_refs.get(key[1])
            if not refs:
                return 0
            return self._h("open", key[1], tuple(sorted(refs.items())))
        if kind == "sustained":
            if key[1] not in self.fs.sustained:
                return 0
            return self._h("sustained", key[1])
        if kind == "misc":
            # next_inode / next_chunk_id are EXCLUDED: the server
            # pre-reserves them outside apply() (alloc_inode, chunk-id
            # reservation), and apply maintains them monotonically via
            # max(), so shadows converge on them from the ops alone
            return self._h("misc", self.next_session, self.epoch)
        raise ValueError(f"unknown entity kind {kind!r}")

    def _op_synth_populate(self, op):
        """Storm-bench bulk load: deterministically create ``count``
        synthetic file nodes (each with one standard chunk whose parts
        sit on synthetic registry servers) in ONE changelog op, so an
        active master and its shadows converge on the same million-inode
        namespace without a million changelog lines.

        Digest discipline: this op maintains the incremental digest
        itself (``_touched`` would be O(count) twice; here each fresh
        entity hashes exactly once, plus pre/post for the parent and the
        uid/gid-0 usage rows), so shadow divergence detection still
        holds — test_scalability pins digest == full_digest after it."""
        parent = op["parent"]
        count = op["count"]
        base_inode = op["base_inode"]
        base_chunk = op["base_chunk"]
        n_servers = op.get("servers", 0)
        copies = op.get("copies", 1)
        length = op.get("length", 65536)
        ts = op["ts"]
        prefix = op.get("prefix", "sf")
        d = 0
        pre_keys = [("node", parent), ("quota", "user", 0),
                    ("quota", "group", 0)]
        for key in pre_keys:
            d ^= self._entity_hash(key)
        servers = [
            self.registry.register_server(
                "synth", 1 + j, "_", 1 << 40, 0
            )
            for j in range(n_servers)
        ]
        for i in range(count):
            inode = base_inode + i
            name = f"{prefix}{inode}"
            self.fs.apply_mknode(
                parent, name, inode, 1, 0o644, 0, 0, ts, 1, 0
            )
            node = self.fs.nodes[inode]
            cid = base_chunk + i
            node.length = length
            node.chunks = [cid]
            self.fs._add_stats(parent, 0, length)
            chunk = self.registry.create_chunk(
                0, chunk_id=cid, version=1, copies=copies
            )
            if servers:
                for r in range(copies):
                    srv = servers[(i + r) % len(servers)]
                    self.registry.record_part(chunk, srv.cs_id, 0)
            d ^= self._entity_hash(("node", inode))
            d ^= self._entity_hash(("edge", parent, name))
            d ^= self._entity_hash(("chunk", cid))
        self.quotas.charge(0, 0, count, count * length)
        for key in pre_keys:
            d ^= self._entity_hash(key)
        self._digest ^= d

    def _op_tape_copy(self, op):
        copies = self.tape_copies.setdefault(op["inode"], [])
        # one copy per tape-server label; a fresh copy replaces a stale
        # one from the same label
        copies[:] = [c for c in copies if c["label"] != op["label"]]
        copies.append({
            "label": op["label"], "length": op["length"],
            "mtime": op["mtime"], "gen": op.get("gen", 0), "ts": op["ts"],
        })

    def _op_tape_drop(self, op):
        self.tape_copies.pop(op["inode"], None)
        self.content_gen.pop(op["inode"], None)
        self.demoted.pop(op["inode"], None)

    def _op_tape_demote(self, op):
        """Demote to the tape tier: free the file's chunk data, record
        the content stamp the archival copy must match for recall. The
        live master only commits this with a fresh tape copy on hand;
        apply is unconditional (replay must not re-validate against
        volatile link state)."""
        inode = op["inode"]
        node = self.fs.file_node(inode)
        removed = self.fs.apply_demote(inode, op["ts"])
        for cid in removed:
            self.registry.release_chunk(cid)
        self.demoted[inode] = {
            "length": node.length, "mtime": node.mtime,
            "gen": self.content_gen.get(inode, 0),
        }

    def _op_tape_recall_done(self, op):
        """Recall finished: the archived bytes were written back. The
        restore writes bumped mtime/content_gen; put the original mtime
        back (a recall is not a modification) and re-stamp the tape
        copies that matched the demoted stamp to the CURRENT generation
        so the recall does not read as staleness (which would trigger a
        pointless re-archive of identical bytes)."""
        inode = op["inode"]
        stamp = self.demoted.pop(inode, None)
        node = self.fs.nodes.get(inode)
        if stamp is None or node is None:
            return
        if not op.get("restore", True):
            # a write raced the restore: the content is live again but
            # it is NOT the archived version — no mtime/stamp rewrite
            node.ctime = op["ts"]
            return
        node.mtime = stamp["mtime"]
        node.ctime = op["ts"]
        gen = self.content_gen.get(inode, 0)
        for c in self.tape_copies.get(inode, []):
            if (c["length"], c["mtime"], c.get("gen", 0)) == (
                stamp["length"], stamp["mtime"], stamp["gen"]
            ):
                c["gen"] = gen

    def _touched(self, op: dict) -> set[tuple]:
        """Entities whose state the op may change — evaluated against
        the CURRENT state (called both before and after apply; must be a
        superset of reality each time)."""
        t = op["op"]
        out: set[tuple] = {("misc",)}
        fs = self.fs

        def node_quota(inode):
            n = fs.nodes.get(inode)
            if n is not None:
                out.add(("quota", "user", n.uid))
                out.add(("quota", "group", n.gid))

        def node_chunks(inode):
            n = fs.nodes.get(inode)
            if n is not None:
                for cid in getattr(n, "chunks", ()):
                    if cid:
                        out.add(("chunk", cid))

        def child_of(parent, name):
            p = fs.nodes.get(parent)
            if p is not None and p.ftype == 2:
                c = p.children.get(name)
                if c is not None:
                    out.add(("node", c))
                    out.add(("trash", c))
                    out.add(("sustained", c))
                    node_quota(c)
                    node_chunks(c)

        if t == "mknode":
            out |= {("node", op["parent"]), ("node", op["inode"]),
                    ("edge", op["parent"], op["name"]),
                    ("quota", "user", op["uid"]),
                    ("quota", "group", op["gid"])}
        elif t in ("unlink", "rmdir"):
            out.add(("node", op["parent"]))
            out.add(("edge", op["parent"], op["name"]))
            child_of(op["parent"], op["name"])
        elif t == "rename":
            out |= {("node", op["parent_src"]), ("node", op["parent_dst"]),
                    ("edge", op["parent_src"], op["name_src"]),
                    ("edge", op["parent_dst"], op["name_dst"])}
            child_of(op["parent_src"], op["name_src"])
            child_of(op["parent_dst"], op["name_dst"])
        elif t == "link":
            out |= {("node", op["inode"]), ("node", op["parent"]),
                    ("edge", op["parent"], op["name"]),
                    ("sustained", op["inode"])}
        elif t in ("setattr", "setgoal", "seteattr", "set_chunk", "set_acl",
                   "set_rich_acl", "set_xattr"):
            out.add(("node", op["inode"]))
        elif t == "set_length":
            out.add(("node", op["inode"]))
            node_quota(op["inode"])
            node_chunks(op["inode"])
        elif t in ("create_chunk", "bump_chunk_version", "delete_chunk",
                   "goal_boost", "goal_demote"):
            out.add(("chunk", op["chunk_id"]))
        elif t in ("acquire", "release"):
            out |= {("open", op["inode"]), ("sustained", op["inode"]),
                    ("node", op["inode"]), ("demoted", op["inode"])}
            node_quota(op["inode"])
            node_chunks(op["inode"])
        elif t == "release_session_opens":
            for inode, refs in self.fs.open_refs.items():
                if op["sid"] in refs:
                    out |= {("open", inode), ("sustained", inode),
                            ("node", inode), ("demoted", inode)}
                    node_quota(inode)
                    node_chunks(inode)
        elif t in ("purge_trash", "undelete"):
            out |= {("node", op["inode"]), ("trash", op["inode"]),
                    ("sustained", op["inode"]), ("demoted", op["inode"])}
            node_quota(op["inode"])
            node_chunks(op["inode"])
            entry = fs.trash.get(op["inode"])
            if entry is not None:
                out.add(("node", entry[2]))  # restore target dir
            out.add(("node", 1))  # undelete falls back to the root
            n = fs.nodes.get(op["inode"])
            if n is not None:
                # the restored edge's name may have a collision suffix:
                # find it by child inode (post state; rare op)
                for p in n.parents:
                    out.add(("node", p))
                    pn = fs.nodes.get(p)
                    if pn is not None and pn.ftype == 2:
                        for name, child in pn.children.items():
                            if child == op["inode"]:
                                out.add(("edge", p, name))
        elif t in ("tape_copy", "tape_drop"):
            out.add(("tape", op["inode"]))
            if t == "tape_drop":
                out.add(("demoted", op["inode"]))
        elif t in ("tape_demote", "tape_recall_done"):
            out |= {("node", op["inode"]), ("demoted", op["inode"]),
                    ("tape", op["inode"])}
            node_chunks(op["inode"])
        elif t == "set_quota":
            out.add(("quota", op["kind"], op["owner_id"]))
        elif t == "snapshot":
            out.add(("node", op["dst_parent"]))
            out.add(("edge", op["dst_parent"], op["dst_name"]))
            for old_s, new in op["inode_map"].items():
                out |= {("node", int(old_s)), ("node", new)}
                node_chunks(int(old_s))
                node_chunks(new)
                node_quota(int(old_s))
                # cloned directories bring fresh edges (post-only keys)
                nn = fs.nodes.get(new)
                if nn is not None and nn.ftype == 2:
                    for name in nn.children:
                        out.add(("edge", new, name))
        elif t == "cow_chunk":
            out |= {("chunk", op["old_chunk_id"]),
                    ("chunk", op["new_chunk_id"]), ("node", op["inode"])}
        elif t == "append_chunks":
            out |= {("node", op["inode_dst"]), ("node", op["inode_src"])}
            node_chunks(op["inode_dst"])
            node_chunks(op["inode_src"])
            node_quota(op["inode_dst"])
        elif t == "repair_zero_chunk":
            out.add(("node", op["inode"]))
            node_chunks(op["inode"])
        elif t in ("lock_posix", "lock_flock"):
            kind = "posix" if t == "lock_posix" else "flock"
            out.add(("locks", kind, op["inode"]))
        elif t == "lock_release_session":
            sid = op["sid"]
            for kind, table in (("posix", self.locks.posix_files),
                                ("flock", self.locks.flock_files)):
                for inode, fl in table.items():
                    if any(r.owner.session_id == sid for r in fl.ranges):
                        out.add(("locks", kind, inode))
        elif t == "session_new":
            pass  # misc only
        elif t == "epoch_bump":
            pass  # misc only (the epoch rides the misc hash)
        return out

    def full_digest(self) -> int:
        """Recompute the digest from scratch (O(everything))."""
        d = self._entity_hash(("misc",))
        for inode, n in self.fs.nodes.items():
            d ^= self._entity_hash(("node", inode))
            if n.ftype == 2:
                for name in n.children:
                    d ^= self._entity_hash(("edge", inode, name))
        for inode in self.fs.trash:
            d ^= self._entity_hash(("trash", inode))
        for inode in self.fs.open_refs:
            d ^= self._entity_hash(("open", inode))
        for inode in self.fs.sustained:
            d ^= self._entity_hash(("sustained", inode))
        for cid in self.registry.chunks:
            d ^= self._entity_hash(("chunk", cid))
        for kind, oid in self.quotas.entries:
            d ^= self._entity_hash(("quota", kind, oid))
        for lkind, table in (("posix", self.locks.posix_files),
                             ("flock", self.locks.flock_files)):
            for inode in table:
                d ^= self._entity_hash(("locks", lkind, inode))
        for inode in self.tape_copies:
            d ^= self._entity_hash(("tape", inode))
        for inode in self.demoted:
            d ^= self._entity_hash(("demoted", inode))
        return d

    def checksum(self, cache_key: int | None = None) -> str:
        """Divergence-detection digest over the persistent metadata.

        Maintained INCREMENTALLY per applied op (the reference's
        filesystem_checksum.cc); a probe costs O(1) no matter the
        namespace size. ``cache_key`` is accepted for interface
        compatibility and ignored."""
        return f"{self._digest:032x}"

    def reset_digest(self) -> None:
        """Re-anchor the incremental digest to current state (after a
        bulk load or verified drift)."""
        self._digest = self.full_digest()
