"""FUSE frontend: mount the file system through libfuse2 via ctypes.

The analog of the reference's FUSE client (reference: src/mount/fuse/
mfs_fuse.cc + main.cc) for environments without python-fuse packages:
a minimal ctypes binding of libfuse 2.9's high-level API (the same
surface fusepy wraps) driving the async :class:`Client` from a
dedicated event-loop thread.

Usage:
    python -m lizardfs_tpu_torch.client.fuse_mount --master host:port /mnt/liz

Implemented operations: getattr, readdir, mkdir, rmdir, create, unlink,
rename, link, symlink, readlink, open, read, write, truncate, chmod,
chown, utimens, statfs, getxattr/setxattr/listxattr/removexattr, flush.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import errno
import stat as stat_mod
import sys
import threading
import time

from lizardfs_tpu_torch.client.client import Client
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st

c_off_t = ctypes.c_int64
c_mode_t = ctypes.c_uint32
c_dev_t = ctypes.c_uint64
c_uid_t = ctypes.c_uint32
c_gid_t = ctypes.c_uint32


class Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_int64), ("tv_nsec", ctypes.c_int64)]


class Stat(ctypes.Structure):
    # x86_64 linux struct stat
    _fields_ = [
        ("st_dev", ctypes.c_uint64),
        ("st_ino", ctypes.c_uint64),
        ("st_nlink", ctypes.c_uint64),
        ("st_mode", ctypes.c_uint32),
        ("st_uid", ctypes.c_uint32),
        ("st_gid", ctypes.c_uint32),
        ("__pad0", ctypes.c_int),
        ("st_rdev", ctypes.c_uint64),
        ("st_size", ctypes.c_int64),
        ("st_blksize", ctypes.c_int64),
        ("st_blocks", ctypes.c_int64),
        ("st_atim", Timespec),
        ("st_mtim", Timespec),
        ("st_ctim", Timespec),
        ("__unused", ctypes.c_int64 * 3),
    ]


class FuseFileInfo(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.c_int),
        ("fh_old", ctypes.c_ulong),
        ("writepage", ctypes.c_int),
        ("bits", ctypes.c_uint),
        ("fh", ctypes.c_uint64),
        ("lock_owner", ctypes.c_uint64),
    ]


class StatVfs(ctypes.Structure):
    _fields_ = [
        ("f_bsize", ctypes.c_ulong),
        ("f_frsize", ctypes.c_ulong),
        ("f_blocks", ctypes.c_uint64),
        ("f_bfree", ctypes.c_uint64),
        ("f_bavail", ctypes.c_uint64),
        ("f_files", ctypes.c_uint64),
        ("f_ffree", ctypes.c_uint64),
        ("f_favail", ctypes.c_uint64),
        ("f_fsid", ctypes.c_ulong),
        ("f_flag", ctypes.c_ulong),
        ("f_namemax", ctypes.c_ulong),
        ("__f_spare", ctypes.c_int * 6),
    ]


CB = ctypes.CFUNCTYPE
c_char_p = ctypes.c_char_p
c_void_p = ctypes.c_void_p
c_int = ctypes.c_int
c_size_t = ctypes.c_size_t

FILL_DIR_T = CB(c_int, c_void_p, c_char_p, ctypes.POINTER(Stat), c_off_t)

_FIELDS = [
    ("getattr", CB(c_int, c_char_p, ctypes.POINTER(Stat))),
    ("readlink", CB(c_int, c_char_p, c_void_p, c_size_t)),
    ("getdir", c_void_p),  # deprecated
    ("mknod", CB(c_int, c_char_p, c_mode_t, c_dev_t)),
    ("mkdir", CB(c_int, c_char_p, c_mode_t)),
    ("unlink", CB(c_int, c_char_p)),
    ("rmdir", CB(c_int, c_char_p)),
    ("symlink", CB(c_int, c_char_p, c_char_p)),
    ("rename", CB(c_int, c_char_p, c_char_p)),
    ("link", CB(c_int, c_char_p, c_char_p)),
    ("chmod", CB(c_int, c_char_p, c_mode_t)),
    ("chown", CB(c_int, c_char_p, c_uid_t, c_gid_t)),
    ("truncate", CB(c_int, c_char_p, c_off_t)),
    ("utime", c_void_p),  # superseded by utimens
    ("open", CB(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))),
    # NOTE: data buffers are c_void_p, NOT c_char_p — ctypes converts
    # c_char_p arguments to NUL-truncated bytes copies, corrupting
    # binary IO (the classic fusepy pitfall)
    ("read", CB(c_int, c_char_p, c_void_p, c_size_t, c_off_t,
                ctypes.POINTER(FuseFileInfo))),
    ("write", CB(c_int, c_char_p, c_void_p, c_size_t, c_off_t,
                 ctypes.POINTER(FuseFileInfo))),
    ("statfs", CB(c_int, c_char_p, ctypes.POINTER(StatVfs))),
    ("flush", CB(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))),
    ("release", CB(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))),
    ("fsync", CB(c_int, c_char_p, c_int, ctypes.POINTER(FuseFileInfo))),
    ("setxattr", CB(c_int, c_char_p, c_char_p, c_void_p, c_size_t, c_int)),
    ("getxattr", CB(c_int, c_char_p, c_char_p, c_void_p, c_size_t)),
    ("listxattr", CB(c_int, c_char_p, c_void_p, c_size_t)),
    ("removexattr", CB(c_int, c_char_p, c_char_p)),
    ("opendir", CB(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))),
    ("readdir", CB(c_int, c_char_p, c_void_p, FILL_DIR_T, c_off_t,
                   ctypes.POINTER(FuseFileInfo))),
    ("releasedir", CB(c_int, c_char_p, ctypes.POINTER(FuseFileInfo))),
    ("fsyncdir", CB(c_int, c_char_p, c_int, ctypes.POINTER(FuseFileInfo))),
    ("init", CB(c_void_p, c_void_p)),
    ("destroy", CB(None, c_void_p)),
    ("access", CB(c_int, c_char_p, c_int)),
    ("create", CB(c_int, c_char_p, c_mode_t, ctypes.POINTER(FuseFileInfo))),
    ("ftruncate", CB(c_int, c_char_p, c_off_t, ctypes.POINTER(FuseFileInfo))),
    ("fgetattr", CB(c_int, c_char_p, ctypes.POINTER(Stat),
                    ctypes.POINTER(FuseFileInfo))),
    ("lock", c_void_p),
    ("utimens", CB(c_int, c_char_p, ctypes.POINTER(Timespec))),
    ("bmap", c_void_p),
    ("flags", ctypes.c_uint),
    ("ioctl", c_void_p),
    ("poll", c_void_p),
    ("write_buf", c_void_p),
    ("read_buf", c_void_p),
    ("flock", c_void_p),
    ("fallocate", c_void_p),
]


class FuseOperations(ctypes.Structure):
    _fields_ = _FIELDS


def _load_libfuse():
    for name in ("libfuse.so.2", ctypes.util.find_library("fuse")):
        if not name:
            continue
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


class FuseContext(ctypes.Structure):
    _fields_ = [
        ("fuse", c_void_p),
        ("uid", ctypes.c_uint32),
        ("gid", ctypes.c_uint32),
        ("pid", ctypes.c_int32),
        ("private_data", c_void_p),
        ("umask", ctypes.c_uint32),
    ]


class LizardFuse:
    """Bridges libfuse callbacks to the async Client."""

    def __init__(self, master_addrs: list[tuple[str, int]], encoder=None):
        self.libfuse = None  # set by mount(); enables caller identity
        self.loop = asyncio.new_event_loop()
        # encoder None: the client's default, the card's encoder
        self.client = Client("", 0, master_addrs=master_addrs, encoder=encoder)
        self._loop_thread = threading.Thread(
            target=self.loop.run_forever, daemon=True
        )
        # open-time snapshots of special-inode content so piecewise
        # kernel reads see a consistent document (no torn .oplog)
        self._special_snap: dict[bytes, bytes] = {}
        # direct C read path: libfuse callback threads call liz_read
        # without a hop through the asyncio loop (latency path; see
        # client/native_client.py)
        from lizardfs_tpu_torch.client import native_client

        self._native_reads = (
            native_client.NativeReadPool(
                lambda: self.client.current_master_addr
            )
            if native_client.available() else None
        )

    def start(self) -> None:
        self._loop_thread.start()
        self._run(self.client.connect(info="fuse-mount"))
        # local master proxy (masterproxy.cc analog): tools inside the
        # mount reach the master via the address in .masterinfo
        from lizardfs_tpu_torch.client.masterproxy import MasterProxy

        self.proxy = MasterProxy(lambda: self.client.current_master_addr)
        self._run(self.proxy.start())

    def _run(self, coro, timeout: float = 60.0):
        # capture the kernel caller's pid HERE (fuse_get_context is only
        # valid on the callback thread) and carry it into the coroutine:
        # the client throttles IO under the caller's cgroup limit group
        # (reference: src/mount/io_limit_group.cc classification)
        pid = self._caller_pid()

        async def _with_caller():
            from lizardfs_tpu_torch.client.client import IO_CALLER_PID

            token = IO_CALLER_PID.set(pid)
            try:
                return await coro
            finally:
                IO_CALLER_PID.reset(token)

        return asyncio.run_coroutine_threadsafe(
            _with_caller(), self.loop
        ).result(timeout)

    def _caller_pid(self) -> int | None:
        if self.libfuse is None:
            return None
        try:
            ctx = self.libfuse.fuse_get_context()
            if ctx:
                return int(ctx.contents.pid) or None
        except Exception:  # noqa: BLE001
            pass
        return None

    # --- helpers ----------------------------------------------------------

    def _resolve(self, path: bytes) -> m.Attr:
        return self._run(self.client.resolve(path.decode()))

    def _resolve_parent(self, path: bytes):
        return self._run(self.client.resolve_parent(path.decode()))

    def _caller(self) -> tuple[int, list[int]]:
        """Kernel caller identity from fuse_get_context: uid + primary
        gid + supplementary groups (fuse_getgroups, best effort)."""
        if self.libfuse is None:
            return 0, [0]
        try:
            ctx = self.libfuse.fuse_get_context()
            if not ctx:
                return 0, [0]
            c = ctx.contents
            gids = [int(c.gid)]
            try:
                arr = (ctypes.c_uint32 * 32)()
                n = self.libfuse.fuse_getgroups(32, arr)
                if 0 < n <= 32:
                    for g in arr[:n]:
                        if int(g) not in gids:
                            gids.append(int(g))
            except Exception:  # noqa: BLE001
                pass
            return int(c.uid), gids
        except Exception:  # noqa: BLE001
            pass
        return 0, [0]

    @staticmethod
    def _errno(e: Exception) -> int:
        if isinstance(e, st.StatusError):
            return -{
                st.ENOENT: errno.ENOENT, st.EEXIST: errno.EEXIST,
                st.EACCES: errno.EACCES, st.EPERM: errno.EPERM,
                st.ENOTDIR: errno.ENOTDIR, st.EISDIR: errno.EISDIR,
                st.ENOTEMPTY: errno.ENOTEMPTY, st.EINVAL: errno.EINVAL,
                st.QUOTA_EXCEEDED: errno.EDQUOT, st.ENOATTR: errno.ENODATA,
                st.NAME_TOO_LONG: errno.ENAMETOOLONG,
            }.get(e.code, errno.EIO)
        return -errno.EIO

    def _fill_stat(self, attr: m.Attr, out) -> None:
        ctypes.memset(ctypes.byref(out), 0, ctypes.sizeof(out))
        kind = {
            m.FTYPE_FILE: stat_mod.S_IFREG,
            m.FTYPE_DIR: stat_mod.S_IFDIR,
            m.FTYPE_SYMLINK: stat_mod.S_IFLNK,
        }.get(attr.ftype, stat_mod.S_IFREG)
        out.st_ino = attr.inode
        out.st_mode = kind | attr.mode
        out.st_nlink = max(attr.nlink, 1)
        out.st_uid = attr.uid
        out.st_gid = attr.gid
        out.st_size = attr.length
        out.st_blksize = MFSBLOCKSIZE
        out.st_blocks = (attr.length + 511) // 512
        out.st_atim.tv_sec = attr.atime
        out.st_mtim.tv_sec = attr.mtime
        out.st_ctim.tv_sec = attr.ctime

    # --- special inodes (.oplog / .stats / .masterinfo analogs,
    #     src/mount/special_inode*.cc) ----------------------------------

    def _special_content(self, path: bytes) -> bytes | None:
        name = path.decode()
        if name == "/.stats":
            lines = [
                f"{op}: {count}"
                for op, count in sorted(self.client.op_counters.items())
            ]
            lines.append(f"cache_hits: {self.client.cache.hits}")
            lines.append(f"cache_misses: {self.client.cache.misses}")
            return ("\n".join(lines) + "\n").encode()
        if name == "/.oplog":
            lines = [
                f"{ts:.3f} {op}" for ts, op, _ in list(self.client.oplog)
            ]
            return ("\n".join(lines) + "\n").encode()
        if name == "/.masterinfo":
            addr = self.client.current_master_addr
            proxy = getattr(self, "proxy", None)
            return (
                f"master: {addr[0]}:{addr[1]}\n"
                f"masterproxy: 127.0.0.1:{proxy.port if proxy else 0}\n"
                f"session: {self.client.session_id}\n"
            ).encode()
        return None

    # --- operations -------------------------------------------------------

    def build_operations(self) -> FuseOperations:
        ops = FuseOperations()
        keep = self._keepalive = []

        def wrap(name, fn):
            cb_type = dict(_FIELDS)[name]

            def guarded(*args):
                try:
                    return fn(*args)
                except Exception as e:  # noqa: BLE001
                    return self._errno(e)

            cb = cb_type(guarded)
            keep.append(cb)
            setattr(ops, name, cb)

        def op_getattr(path, out):
            special = self._special_content(path)
            if special is not None:
                ctypes.memset(
                    ctypes.byref(out.contents), 0, ctypes.sizeof(Stat)
                )
                out.contents.st_mode = stat_mod.S_IFREG | 0o444
                out.contents.st_nlink = 1
                out.contents.st_size = len(special)
                out.contents.st_blksize = MFSBLOCKSIZE
                return 0
            self._fill_stat(self._resolve(path), out.contents)
            return 0

        def op_fgetattr(path, out, fi):
            # by HANDLE, not path: fstat(fd) must work on an
            # unlinked-but-open (sustained) file whose name is gone
            inode = fi.contents.fh if fi else 0
            if inode:
                self._fill_stat(
                    self._run(self.client.getattr(inode)), out.contents
                )
                return 0
            return op_getattr(path, out)

        def op_readdir(path, buf, filler, offset, fi):
            uid, gids = self._caller()
            node = self._resolve(path)
            filler(buf, b".", None, 0)
            filler(buf, b"..", None, 0)
            for entry in self._run(
                self.client.readdir(node.inode, uid=uid, gids=gids)
            ):
                filler(buf, entry.name.encode(), None, 0)
            return 0

        def op_mkdir(path, mode):
            uid, gids = self._caller()
            parent, name = self._resolve_parent(path)
            self._run(
                self.client.mkdir(
                    parent.inode, name, mode & 0o7777, uid=uid, gid=gids[0]
                )
            )
            return 0

        def op_rmdir(path):
            uid, gids = self._caller()
            parent, name = self._resolve_parent(path)
            self._run(self.client.rmdir(parent.inode, name, uid=uid, gids=gids))
            return 0

        def op_create(path, mode, fi):
            uid, gids = self._caller()
            parent, name = self._resolve_parent(path)
            attr = self._run(
                self.client.create(
                    parent.inode, name, mode & 0o7777, uid=uid, gid=gids[0]
                )
            )
            # the create handle is an open handle (kernel will send a
            # matching release)
            self._run(self.client.open(attr.inode))
            fi.contents.fh = attr.inode
            return 0

        def op_open(path, fi):
            special = self._special_content(path)
            if special is not None:
                self._special_snap[bytes(path)] = special
                fi.contents.fh = 0
                return 0
            node = self._resolve(path)
            # enforce at open like default_permissions: read or write
            # intent from O_ACCMODE against mode bits + ACLs
            uid, gids = self._caller()
            if uid != 0:
                accmode = fi.contents.flags & 3  # O_RDONLY/O_WRONLY/O_RDWR
                want = {0: 4, 1: 2, 2: 6}.get(accmode, 4)
                ok = self._run(self.client.access(node.inode, uid, gids, want))
                if not ok:
                    return -errno.EACCES
            # register the handle: the file now survives unlink until
            # op_release (sustained files)
            self._run(self.client.open(node.inode))
            fi.contents.fh = node.inode
            return 0

        def op_unlink(path):
            uid, gids = self._caller()
            parent, name = self._resolve_parent(path)
            self._run(
                self.client.unlink(parent.inode, name, uid=uid, gids=gids)
            )
            return 0

        def op_rename(old, new):
            uid, gids = self._caller()
            ps, ns = self._resolve_parent(old)
            pd, nd = self._resolve_parent(new)
            self._run(
                self.client.rename(
                    ps.inode, ns, pd.inode, nd, uid=uid, gids=gids
                )
            )
            return 0

        def op_link(target, link):
            uid, gids = self._caller()
            t = self._resolve(target)
            parent, name = self._resolve_parent(link)
            self._run(
                self.client.link(
                    t.inode, parent.inode, name, uid=uid, gids=gids
                )
            )
            return 0

        def op_symlink(target, link):
            uid, gids = self._caller()
            parent, name = self._resolve_parent(link)
            self._run(self.client.symlink(
                parent.inode, name, target.decode(), uid=uid,
                gid=gids[0] if gids else 0,
            ))
            return 0

        def op_readlink(path, buf, size):
            node = self._resolve(path)
            target = self._run(self.client.readlink(node.inode)).encode()[: size - 1]
            ctypes.memmove(buf, target + b"\0", len(target) + 1)
            return 0

        def op_read(path, buf, size, offset, fi):
            special = self._special_snap.get(bytes(path))
            if special is None:
                special = self._special_content(path)
            if special is not None:
                piece = special[offset : offset + size]
                ctypes.memmove(buf, piece, len(piece))
                return len(piece)
            inode = fi.contents.fh or self._resolve(path).inode
            data = None
            # the native pool cannot classify callers or pace, so it
            # stands down while ANY cluster IO limit is active — every
            # byte must pass the client's group throttle
            if (
                self._native_reads is not None
                and not self.client.io_limits_active
            ):
                data = self._native_reads.read(inode, offset, size)
            if data is None:  # striped/degraded or pool busy: planner path
                data = self._run(self.client.read_file(inode, offset, size))
            ctypes.memmove(buf, data, len(data))
            return len(data)

        def op_write(path, buf, size, offset, fi):
            inode = fi.contents.fh or self._resolve(path).inode
            data = ctypes.string_at(buf, size)
            self._run(self.client.pwrite(inode, offset, data))
            return size

        def op_truncate(path, length):
            uid, gids = self._caller()
            node = self._resolve(path)
            self._run(
                self.client.truncate(node.inode, length, uid=uid, gids=gids)
            )
            return 0

        def op_ftruncate(path, length, fi):
            # by HANDLE: ftruncate(fd) on a sustained file has no path
            inode = fi.contents.fh if fi else 0
            if inode:
                uid, gids = self._caller()
                self._run(
                    self.client.truncate(inode, length, uid=uid, gids=gids)
                )
                return 0
            return op_truncate(path, length)

        def op_chmod(path, mode):
            cuid, cgids = self._caller()
            node = self._resolve(path)
            self._run(
                self.client.setattr(
                    node.inode, 1, mode=mode & 0o7777,
                    caller_uid=cuid, caller_gids=cgids,
                )
            )
            return 0

        def op_chown(path, uid, gid):
            cuid, cgids = self._caller()
            node = self._resolve(path)
            mask = (2 if uid != 0xFFFFFFFF else 0) | (4 if gid != 0xFFFFFFFF else 0)
            self._run(
                self.client.setattr(
                    node.inode, mask, uid=uid, gid=gid,
                    caller_uid=cuid, caller_gids=cgids,
                )
            )
            return 0

        def op_utimens(path, times):
            node = self._resolve(path)
            atime = times[0].tv_sec if times else 0
            mtime = times[1].tv_sec if times else 0
            self._run(
                self.client.setattr(node.inode, 8 | 16, atime=atime, mtime=mtime)
            )
            return 0

        statfs_cache = {"t": 0.0, "v": (1 << 30 << 16, 1 << 29 << 16)}

        def op_statfs(path, out):
            ctypes.memset(ctypes.byref(out.contents), 0, ctypes.sizeof(StatVfs))
            out.contents.f_bsize = MFSBLOCKSIZE
            out.contents.f_frsize = MFSBLOCKSIZE
            # desktop tools poll statvfs aggressively; one master RPC
            # per few seconds, stale-on-error
            now = time.monotonic()
            if now - statfs_cache["t"] > 5.0:
                try:
                    statfs_cache["v"] = self._run(self.client.statfs())
                    statfs_cache["t"] = now
                except Exception:
                    statfs_cache["t"] = now - 4.0  # retry soon, serve stale
            total, avail = statfs_cache["v"]
            out.contents.f_blocks = total // MFSBLOCKSIZE
            out.contents.f_bfree = avail // MFSBLOCKSIZE
            out.contents.f_bavail = avail // MFSBLOCKSIZE
            out.contents.f_namemax = 255
            return 0

        def op_access(path, amode):
            self._resolve(path)
            return 0

        def op_flush(path, fi):
            return 0

        def op_release(path, fi):
            self._special_snap.pop(bytes(path), None)
            inode = fi.contents.fh
            if inode:
                try:
                    self._run(self.client.release(inode), timeout=10.0)
                except Exception:  # noqa: BLE001 — release is best effort
                    pass
            return 0

        def op_fsync(path, datasync, fi):
            return 0

        def op_setxattr(path, name, value, size, flags):
            uid, gids = self._caller()
            node = self._resolve(path)
            raw = ctypes.string_at(value, size)
            self._run(self.client.set_xattr(
                node.inode, name.decode(), raw, uid=uid, gids=gids))
            return 0

        def op_getxattr(path, name, value, size):
            uid, gids = self._caller()
            node = self._resolve(path)
            data = self._run(self.client.get_xattr(
                node.inode, name.decode(), uid=uid, gids=gids))
            if size == 0:
                return len(data)
            if size < len(data):
                return -errno.ERANGE
            ctypes.memmove(value, data, len(data))
            return len(data)

        def op_listxattr(path, buf, size):
            node = self._resolve(path)
            names = self._run(self.client.list_xattr(node.inode))
            blob = b"".join(n.encode() + b"\0" for n in names)
            if size == 0:
                return len(blob)
            if size < len(blob):
                return -errno.ERANGE
            ctypes.memmove(buf, blob, len(blob))
            return len(blob)

        def op_removexattr(path, name):
            uid, gids = self._caller()
            node = self._resolve(path)
            self._run(self.client.remove_xattr(
                node.inode, name.decode(), uid=uid, gids=gids))
            return 0

        for name, fn in (
            ("getattr", op_getattr), ("fgetattr", op_fgetattr),
            ("readdir", op_readdir), ("mkdir", op_mkdir), ("rmdir", op_rmdir),
            ("create", op_create), ("open", op_open), ("unlink", op_unlink),
            ("rename", op_rename), ("link", op_link), ("symlink", op_symlink),
            ("readlink", op_readlink), ("read", op_read), ("write", op_write),
            ("truncate", op_truncate), ("ftruncate", op_ftruncate),
            ("chmod", op_chmod), ("chown", op_chown), ("utimens", op_utimens),
            ("statfs", op_statfs), ("access", op_access), ("flush", op_flush),
            ("release", op_release), ("fsync", op_fsync),
            ("setxattr", op_setxattr), ("getxattr", op_getxattr),
            ("listxattr", op_listxattr), ("removexattr", op_removexattr),
        ):
            wrap(name, fn)
        return ops


def mount(master_addrs: list[tuple[str, int]], mountpoint: str,
          foreground: bool = True, extra_args: list[str] | None = None) -> int:
    lib = _load_libfuse()
    if lib is None:
        print("error: libfuse2 not found", file=sys.stderr)
        return 1
    lib.fuse_get_context.restype = ctypes.POINTER(FuseContext)
    bridge = LizardFuse(master_addrs)
    bridge.libfuse = lib
    bridge.start()
    ops = bridge.build_operations()
    argv_list = [b"lizardfs-fuse", mountpoint.encode()]
    if foreground:
        argv_list.append(b"-f")
    argv_list += [a.encode() for a in (extra_args or [])]
    argv = (ctypes.c_char_p * len(argv_list))(*argv_list)
    lib.fuse_main_real.argtypes = [
        c_int, ctypes.POINTER(c_char_p), ctypes.POINTER(FuseOperations),
        c_size_t, c_void_p,
    ]
    try:
        return lib.fuse_main_real(
            len(argv_list), argv, ctypes.byref(ops), ctypes.sizeof(ops), None
        )
    finally:
        if bridge._native_reads is not None:
            bridge._native_reads.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="lizardfs-fuse", description=__doc__)
    p.add_argument("--master", default="127.0.0.1:9420")
    p.add_argument("mountpoint")
    p.add_argument("-o", dest="options", default="", help="fuse options")
    args = p.parse_args(argv)
    addrs = []
    for item in args.master.split(","):
        host, _, port = item.strip().rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    extra = ["-o", args.options] if args.options else []
    return mount(addrs, args.mountpoint, extra_args=extra)


if __name__ == "__main__":
    sys.exit(main())
