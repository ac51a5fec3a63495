"""`lizardfs` — busybox-style file tool (reference: src/tools/, the
setgoal/getgoal/fileinfo/dirinfo/... multi-tool).

Works daemonless against the master/chunkservers through the client
library (no FUSE mount needed):

    python -m lizardfs_tpu_torch.tools.cli --master host:port <command> [...]

Commands: ls, mkdir, rmdir, rm, mv, ln, symlink, readlink, put, get,
cat, stat, setgoal, getgoal, geteattr, seteattr, settrashtime,
gettrashtime, fileinfo, dirinfo, checkfile, rremove, truncate.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import stat as stat_mod
import sys

from lizardfs_tpu_torch.constants import MFSCHUNKSIZE
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.client.client import Client
from lizardfs_tpu_torch.proto import messages as msgs
from lizardfs_tpu_torch.proto import status as st

FTYPE_CHAR = {1: "-", 2: "d", 3: "l"}


def _addrs(s: str) -> list[tuple[str, int]]:
    if s.startswith("mount:"):
        # discover the master through a mounted filesystem's local proxy
        # (masterproxy.cc analog): .masterinfo names the relay address
        import os

        info = os.path.join(s[len("mount:"):], ".masterinfo")
        try:
            with open(info) as f:
                for line in f:
                    if line.startswith("masterproxy:"):
                        host, _, port = line.split()[1].rpartition(":")
                        return [(host, int(port))]
        except OSError as e:
            raise ConnectionError(
                f"{s!r} is not a lizardfs mount ({e})"
            ) from e
        raise ConnectionError(f"no masterproxy line in {info}")
    out = []
    for item in s.split(","):
        host, _, port = item.strip().rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


async def _connect(args, encoder=None) -> Client:
    addrs = _addrs(args.master)
    # encoder None: the client's default, the card's encoder
    c = Client("", 0, master_addrs=addrs, encoder=encoder)
    # lint: waive(unbounded-await): delegates to Client.connect — dials via the 5 s-bounded RpcConnection.connect and a 30 s-capped register RPC
    await c.connect(info="lizardfs-cli")
    return c


def _fmt_attr(name: str, a) -> str:
    kind = FTYPE_CHAR.get(a.ftype, "?")
    mode = stat_mod.filemode(
        (stat_mod.S_IFDIR if a.ftype == 2 else
         stat_mod.S_IFLNK if a.ftype == 3 else stat_mod.S_IFREG) | a.mode
    )[1:]
    return (
        f"{kind}{mode} {a.nlink:3d} {a.uid:5d} {a.gid:5d} "
        f"{a.length:12d} goal:{a.goal:<3d} {name}"
    )


async def cmd_ls(c: Client, args) -> int:
    a = await c.resolve(args.path)
    if a.ftype != msgs.FTYPE_DIR:
        print(_fmt_attr(args.path, a))
        return 0
    for e in await c.readdir(a.inode):
        ea = await c.getattr(e.inode)
        print(_fmt_attr(e.name, ea))
    return 0


async def cmd_mkdir(c: Client, args) -> int:
    parent, name = await c.resolve_parent(args.path)
    await c.mkdir(parent.inode, name)
    return 0


async def cmd_rmdir(c: Client, args) -> int:
    parent, name = await c.resolve_parent(args.path)
    await c.rmdir(parent.inode, name)
    return 0


async def cmd_rm(c: Client, args) -> int:
    parent, name = await c.resolve_parent(args.path)
    await c.unlink(parent.inode, name)
    return 0


async def cmd_mv(c: Client, args) -> int:
    psrc, nsrc = await c.resolve_parent(args.src)
    pdst, ndst = await c.resolve_parent(args.dst)
    await c.rename(psrc.inode, nsrc, pdst.inode, ndst)
    return 0


async def cmd_ln(c: Client, args) -> int:
    target = await c.resolve(args.target)
    parent, name = await c.resolve_parent(args.link)
    await c.link(target.inode, parent.inode, name)
    return 0


async def cmd_symlink(c: Client, args) -> int:
    parent, name = await c.resolve_parent(args.link)
    await c.symlink(parent.inode, name, args.target)
    return 0


async def cmd_readlink(c: Client, args) -> int:
    a = await c.resolve(args.path)
    print(await c.readlink(a.inode))
    return 0


async def cmd_put(c: Client, args) -> int:
    with open(args.local, "rb") as f:
        data = f.read()
    try:
        a = await c.resolve(args.remote)
    except st.StatusError:
        parent, name = await c.resolve_parent(args.remote)
        a = await c.create(parent.inode, name)
    if args.goal:
        await c.setgoal(a.inode, args.goal)
    await c.write_file(a.inode, data)
    print(f"wrote {len(data)} bytes to {args.remote}")
    return 0


async def cmd_get(c: Client, args) -> int:
    a = await c.resolve(args.remote)
    data = await c.read_file(a.inode)
    with open(args.local, "wb") as f:
        f.write(data)
    print(f"read {len(data)} bytes from {args.remote}")
    return 0


async def cmd_cat(c: Client, args) -> int:
    a = await c.resolve(args.path)
    sys.stdout.buffer.write(await c.read_file(a.inode))
    return 0


async def cmd_stat(c: Client, args) -> int:
    a = await c.resolve(args.path)
    print(json.dumps({
        "inode": a.inode, "type": a.ftype, "mode": oct(a.mode),
        "uid": a.uid, "gid": a.gid, "nlink": a.nlink, "length": a.length,
        "goal": a.goal, "trash_time": a.trash_time,
        "eattr": _eattr_flags(a.eattr),
        "atime": a.atime, "mtime": a.mtime, "ctime": a.ctime,
    }, indent=2))
    return 0


async def cmd_setgoal(c: Client, args) -> int:
    a = await c.resolve(args.path)
    await c.setgoal(a.inode, args.goal)
    return 0


async def cmd_getgoal(c: Client, args) -> int:
    a = await c.resolve(args.path)
    print(f"{args.path}: goal {a.goal}")
    return 0


def _eattr_flags(eattr: int) -> str:
    from lizardfs_tpu_torch.constants import EATTR_NAMES

    names = [n for n, bit in EATTR_NAMES.items() if eattr & bit]
    return ",".join(names) if names else "-"


async def cmd_geteattr(c: Client, args) -> int:
    a = await c.resolve(args.path)
    print(f"{args.path}: eattr {_eattr_flags(a.eattr)}")
    return 0


async def cmd_seteattr(c: Client, args) -> int:
    """FLAGS: comma list of [+|-]name over noowner/nocache/noentrycache.
    Bare names replace the whole set; +name/-name edit the current one
    (mfsseteattr -f style)."""
    from lizardfs_tpu_torch.constants import EATTR_NAMES

    a = await c.resolve(args.path)
    tokens = [t.strip() for t in args.flags.split(",") if t.strip()]
    relative = all(t[0] in "+-" for t in tokens) and tokens
    eattr = a.eattr if relative else 0
    for t in tokens:
        op, name = (t[0], t[1:]) if t[0] in "+-" else ("+", t)
        bit = EATTR_NAMES.get(name)
        if bit is None:
            print(f"unknown eattr flag {name!r} "
                  f"(known: {', '.join(EATTR_NAMES)})", file=sys.stderr)
            return 2
        eattr = (eattr | bit) if op == "+" else (eattr & ~bit)
    attr = await c.seteattr(a.inode, eattr)
    print(f"{args.path}: eattr {_eattr_flags(attr.eattr)}")
    return 0


async def cmd_settrashtime(c: Client, args) -> int:
    a = await c.resolve(args.path)
    await c.settrashtime(a.inode, args.seconds)
    return 0


async def cmd_gettrashtime(c: Client, args) -> int:
    a = await c.resolve(args.path)
    print(f"{args.path}: trash time {a.trash_time}s")
    return 0


async def cmd_truncate(c: Client, args) -> int:
    a = await c.resolve(args.path)
    await c.truncate(a.inode, args.size)
    return 0


async def cmd_fileinfo(c: Client, args) -> int:
    a = await c.resolve(args.path)
    nchunks = (a.length + MFSCHUNKSIZE - 1) // MFSCHUNKSIZE
    print(f"{args.path}: {a.length} bytes, {nchunks} chunk(s)")
    tape = await c.tape_info(a.inode)
    if tape.get("demoted"):
        state = "recalling" if tape.get("recalling") else "tape-only"
        print(f"  tier: demoted ({state}) — GET/read triggers recall")
    if tape["wanted"] or tape["copies"] or tape.get("forced"):
        state = "pending" if tape["pending"] else "in sync"
        print(
            f"  tape: {tape['fresh']}/{tape['wanted']} fresh copies"
            f" ({state})"
        )
        for cp in tape["copies"]:
            stale = "" if (cp["length"], cp["mtime"]) == \
                (a.length, a.mtime) else " [stale]"
            print(f"    label {cp['label']}: {cp['length']} bytes{stale}")
    for i in range(nchunks):
        info = await c.chunk_info(a.inode, i)
        if info.chunk_id == 0:
            print(f"  chunk {i}: hole")
            continue
        print(f"  chunk {i}: id {info.chunk_id:016X} version {info.version}")
        for loc in info.locations:
            cpt = geometry.ChunkPartType.from_id(loc.part_id)
            print(
                f"    part {cpt.to_string():>12s} on "
                f"{loc.addr.host}:{loc.addr.port}"
            )
    return 0


async def cmd_checkfile(c: Client, args) -> int:
    a = await c.resolve(args.path)
    nchunks = (a.length + MFSCHUNKSIZE - 1) // MFSCHUNKSIZE
    problems = 0
    for i in range(nchunks):
        info = await c.chunk_info(a.inode, i)
        if info.chunk_id == 0:
            continue
        parts = {geometry.ChunkPartType.from_id(l.part_id).part for l in info.locations}
        if not info.locations:
            print(f"  chunk {i}: NO COPIES (lost)")
            problems += 1
            continue
        t = geometry.ChunkPartType.from_id(info.locations[0].part_id).type
        missing = t.expected_parts - len(parts)
        if t.is_standard:
            print(f"  chunk {i}: {len(info.locations)} cop(ies)")
        elif missing > 0:
            k = t.data_parts
            state = "ENDANGERED" if len(parts) >= k else "UNREADABLE"
            print(f"  chunk {i}: {len(parts)}/{t.expected_parts} parts — {state}")
            problems += 1
    print(f"{args.path}: {'OK' if problems == 0 else f'{problems} problem chunk(s)'}")
    return 0 if problems == 0 else 1


async def cmd_filerepair(c: Client, args) -> int:
    """Repair a file with missing/unrecoverable chunks: repairable
    chunks are rebuilt through the master's RebuildEngine, stale-version
    survivors are version-fixed, and only truly unrecoverable chunks
    are zero-filled (reference: mfsfilerepair)."""
    a = await c.resolve(args.path)
    counts = await c.filerepair(a.inode)
    print(
        f"{args.path}: ok {counts['ok_chunks']}, "
        f"queued-rebuild {counts['queued_rebuild']}, "
        f"version-fixed {counts['repaired_versions']}, "
        f"zeroed {counts['zeroed']}"
    )
    return 0 if counts["zeroed"] == 0 else 1


async def cmd_appendchunks(c: Client, args) -> int:
    """Append SRC file(s) onto DST chunk-wise in O(1) per chunk (the
    chunks are shared, not copied; reference: mfsappendchunks)."""
    dst = await c.resolve(args.dst)
    for src_path in args.srcs:
        src = await c.resolve(src_path)
        attr = await c.append_chunks(dst.inode, src.inode)
    print(f"{args.dst}: now {attr.length} bytes")
    return 0


async def _walk_size(c: Client, inode: int) -> tuple[int, int, int]:
    """(files, dirs, bytes) under a directory (dirinfo analog)."""
    files = dirs = total = 0
    for e in await c.readdir(inode):
        if e.ftype == msgs.FTYPE_DIR:
            dirs += 1
            f2, d2, t2 = await _walk_size(c, e.inode)
            files, dirs, total = files + f2, dirs + d2, total + t2
        else:
            files += 1
            total += (await c.getattr(e.inode)).length
    return files, dirs, total


async def cmd_tape_demote(c: Client, args) -> int:
    """Demote a file to the tape tier (frees chunk data once a fresh
    archival copy exists; CHUNK_BUSY = archive queued, retry)."""
    a = await c.resolve(args.path)
    try:
        await c.tape_demote(a.inode)
    except st.StatusError as e:
        if e.code != st.CHUNK_BUSY:
            raise
        print(f"{args.path}: archive queued — not yet demoted, retry "
              "after the tape copy lands")
        return 1
    print(f"{args.path}: demoted to the tape tier")
    return 0


async def cmd_tape_recall(c: Client, args) -> int:
    """Recall a demoted file from the tape tier (blocks until the
    bytes are live again)."""
    a = await c.resolve(args.path)
    await c.tape_recall(a.inode)
    print(f"{args.path}: recalled")
    return 0


async def cmd_dirinfo(c: Client, args) -> int:
    a = await c.resolve(args.path)
    files, dirs, total = await _walk_size(c, a.inode)
    print(f"{args.path}: {files} files, {dirs} dirs, {total} bytes")
    return 0


async def _rremove(c: Client, parent_inode: int, name: str, inode: int, ftype: int) -> None:
    if ftype == msgs.FTYPE_DIR:
        for e in await c.readdir(inode):
            await _rremove(c, inode, e.name, e.inode, e.ftype)
        await c.rmdir(parent_inode, name)
    else:
        await c.unlink(parent_inode, name)


async def cmd_rremove(c: Client, args) -> int:
    parent, name = await c.resolve_parent(args.path)
    a = await c.lookup(parent.inode, name)
    await _rremove(c, parent.inode, name, a.inode, a.ftype)
    return 0


async def cmd_snapshot(c: Client, args) -> int:
    src = await c.resolve(args.src)
    parent, name = await c.resolve_parent(args.dst)
    await c.snapshot(src.inode, parent.inode, name)
    print(f"snapshot {args.src} -> {args.dst}")
    return 0


async def cmd_getxattr(c: Client, args) -> int:
    a = await c.resolve(args.path)
    sys.stdout.buffer.write(await c.get_xattr(a.inode, args.name) + b"\n")
    return 0


async def cmd_setxattr(c: Client, args) -> int:
    a = await c.resolve(args.path)
    await c.set_xattr(a.inode, args.name, args.value.encode())
    return 0


async def cmd_listxattr(c: Client, args) -> int:
    a = await c.resolve(args.path)
    for name in await c.list_xattr(a.inode):
        print(name)
    return 0


async def cmd_quota_set(c: Client, args) -> int:
    owner = args.id
    if args.kind == "dir":
        owner = (await c.resolve(args.id)).inode
    await c.set_quota(
        args.kind, int(owner), soft_inodes=args.soft_inodes,
        hard_inodes=args.hard_inodes, soft_bytes=args.soft_bytes,
        hard_bytes=args.hard_bytes, remove=args.remove,
    )
    return 0


async def cmd_quota_rep(c: Client, args) -> int:
    rows = await c.get_quota()
    for r in rows:
        print(
            f"{r['kind']:6s} {r['id']:<8d} "
            f"inodes {r['used_inodes']}/{r['hard_inodes'] or '-'} "
            f"bytes {r['used_bytes']}/{r['hard_bytes'] or '-'}"
        )
    return 0


async def cmd_trash_list(c: Client, args) -> int:
    for row in await c.trash_list():
        print(f"inode {row['inode']:<8d} expires {row['expires']} {row['name']}")
    return 0


async def cmd_undelete(c: Client, args) -> int:
    await c.undelete(args.inode)
    return 0


async def cmd_setrichacl(c: Client, args) -> int:
    """setrichacl PATH ACE[,ACE...] | setrichacl --clear PATH

    ACE syntax: [deny:]who:rwx[:fdino] — who is owner@|group@|
    everyone@|u:UID|g:GID; flags f=file-inherit d=dir-inherit
    i=inherit-only n=no-propagate. Examples:
      setrichacl /dir 'deny:u:1000:w,everyone@:rx:fd'
    """
    from lizardfs_tpu_torch.master import richacl as rmod

    a = await c.resolve(args.path)
    if args.clear:
        await c.set_rich_acl(a.inode, None)
        return 0
    aces = []
    try:
        for spec in args.aces.split(","):
            parts = spec.strip().split(":")
            ace_type = rmod.ALLOW
            if parts[0] == "deny":
                ace_type = rmod.DENY
                parts = parts[1:]
            if parts[0] in ("u", "g"):
                who = parts[0] + ":" + str(int(parts[1]))
                parts = parts[2:]
            elif parts[0] in (rmod.OWNER, rmod.GROUP, rmod.EVERYONE):
                who = parts[0]
                parts = parts[1:]
            else:
                raise ValueError(f"unknown principal {parts[0]!r}")
            mask = 0
            for ch in parts[0]:
                mask |= {"r": 4, "w": 2, "x": 1}[ch]
            flags = 0
            if len(parts) > 1:
                for ch in parts[1]:
                    flags |= {"f": rmod.FILE_INHERIT, "d": rmod.DIR_INHERIT,
                              "i": rmod.INHERIT_ONLY,
                              "n": rmod.NO_PROPAGATE}[ch]
            aces.append(rmod.Ace(ace_type, flags, mask, who))
    except (ValueError, KeyError, IndexError) as e:
        print(f"error: bad ACE spec: {e} — syntax: "
              "[deny:]owner@|group@|everyone@|u:UID|g:GID:rwx[:fdino]",
              file=sys.stderr)
        return 2
    await c.set_rich_acl(a.inode, rmod.RichAcl(aces).to_dict())
    return 0


async def cmd_getrichacl(c: Client, args) -> int:
    from lizardfs_tpu_torch.master import richacl as rmod

    a = await c.resolve(args.path)
    doc = await c.get_rich_acl(a.inode)
    if doc is None:
        # synthesize the equivalent view from mode + POSIX ACL (the
        # acl_converter.cc getrichacl path for POSIX-only inodes)
        from lizardfs_tpu_torch.master import acl as acl_mod
        from lizardfs_tpu_torch.master.richacl import from_posix

        posix = await c.get_acl(a.inode)
        pacl = (acl_mod.Acl.from_dict(posix["access"])
                if posix.get("access") else None)
        doc = from_posix(posix["mode"], pacl).to_dict()
        print(f"{args.path}: no richacl; synthetic from POSIX:")
    for ace in rmod.RichAcl.from_dict(doc).aces:
        kind = "deny " if ace.ace_type == rmod.DENY else "allow"
        perms = "".join(
            ch for bit, ch in ((4, "r"), (2, "w"), (1, "x")) if ace.mask & bit
        )
        flags = "".join(
            ch for bit, ch in (
                (rmod.FILE_INHERIT, "f"), (rmod.DIR_INHERIT, "d"),
                (rmod.INHERIT_ONLY, "i"), (rmod.NO_PROPAGATE, "n"),
            ) if ace.flags & bit
        )
        print(f"{kind} {ace.who:12s} {perms or '-'}"
              + (f" [{flags}]" if flags else ""))
    return 0


COMMANDS = {
    "ls": (cmd_ls, [("path", {})]),
    "mkdir": (cmd_mkdir, [("path", {})]),
    "rmdir": (cmd_rmdir, [("path", {})]),
    "rm": (cmd_rm, [("path", {})]),
    "mv": (cmd_mv, [("src", {}), ("dst", {})]),
    "ln": (cmd_ln, [("target", {}), ("link", {})]),
    "symlink": (cmd_symlink, [("target", {}), ("link", {})]),
    "readlink": (cmd_readlink, [("path", {})]),
    "put": (cmd_put, [("local", {}), ("remote", {}),
                      ("--goal", {"type": int, "default": 0})]),
    "get": (cmd_get, [("remote", {}), ("local", {})]),
    "cat": (cmd_cat, [("path", {})]),
    "stat": (cmd_stat, [("path", {})]),
    "setgoal": (cmd_setgoal, [("goal", {"type": int}), ("path", {})]),
    "getgoal": (cmd_getgoal, [("path", {})]),
    "geteattr": (cmd_geteattr, [("path", {})]),
    "seteattr": (cmd_seteattr, [("flags", {}), ("path", {})]),
    "settrashtime": (cmd_settrashtime, [("seconds", {"type": int}), ("path", {})]),
    "gettrashtime": (cmd_gettrashtime, [("path", {})]),
    "truncate": (cmd_truncate, [("size", {"type": int}), ("path", {})]),
    "fileinfo": (cmd_fileinfo, [("path", {})]),
    "checkfile": (cmd_checkfile, [("path", {})]),
    "filerepair": (cmd_filerepair, [("path", {})]),
    "appendchunks": (cmd_appendchunks, [
        ("dst", {}), ("srcs", {"nargs": "+"}),
    ]),
    "tape-demote": (cmd_tape_demote, [("path", {})]),
    "tape-recall": (cmd_tape_recall, [("path", {})]),
    "dirinfo": (cmd_dirinfo, [("path", {})]),
    "rremove": (cmd_rremove, [("path", {})]),
    "snapshot": (cmd_snapshot, [("src", {}), ("dst", {})]),
    "setrichacl": (cmd_setrichacl, [
        ("path", {}), ("aces", {"nargs": "?", "default": ""}),
        ("--clear", {"action": "store_true"}),
    ]),
    "getrichacl": (cmd_getrichacl, [("path", {})]),
    "getxattr": (cmd_getxattr, [("path", {}), ("name", {})]),
    "setxattr": (cmd_setxattr, [("path", {}), ("name", {}), ("value", {})]),
    "listxattr": (cmd_listxattr, [("path", {})]),
    "quota-set": (cmd_quota_set, [
        ("kind", {"choices": ["user", "group", "dir"]}), ("id", {}),
        ("--soft-inodes", {"type": int, "default": 0, "dest": "soft_inodes"}),
        ("--hard-inodes", {"type": int, "default": 0, "dest": "hard_inodes"}),
        ("--soft-bytes", {"type": int, "default": 0, "dest": "soft_bytes"}),
        ("--hard-bytes", {"type": int, "default": 0, "dest": "hard_bytes"}),
        ("--remove", {"action": "store_true"}),
    ]),
    "quota-rep": (cmd_quota_rep, []),
    "trash-list": (cmd_trash_list, []),
    "undelete": (cmd_undelete, [("inode", {"type": int})]),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lizardfs", description=__doc__)
    p.add_argument(
        "--master", default="127.0.0.1:9420",
        help="master address(es) host:port[,host:port...], or "
             "mount:/path to discover via a mounted FS's .masterinfo",
    )
    sub = p.add_subparsers(dest="command", required=True)
    for name, (_, params) in COMMANDS.items():
        sp = sub.add_parser(name)
        for pname, kw in params:
            sp.add_argument(pname, **kw)
    return p


async def _amain(argv, encoder=None) -> int:
    args = build_parser().parse_args(argv)
    fn = COMMANDS[args.command][0]
    c = await _connect(args, encoder)
    try:
        return await fn(c, args)
    except st.StatusError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await c.close()


def main(argv=None, encoder=None) -> int:
    try:
        return asyncio.run(_amain(argv if argv is not None else sys.argv[1:], encoder))
    except BrokenPipeError:
        # stdout consumer (e.g. `| head`) went away: exit quietly
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    except (ConnectionError, OSError) as e:
        print(f"error: cannot reach master: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
