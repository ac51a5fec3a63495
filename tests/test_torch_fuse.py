"""The port's FUSE mount and master proxy against the JAX package's, on
the CPU.

* Source: ``client/masterproxy.py`` is a verbatim copy (the package name
  changed in imports). ``client/fuse_mount.py`` differs only in
  ``LizardFuse``'s ``encoder`` keyword, which it hands to its
  ``Client``; the native read pool, the ctypes layer, ``mount()`` and
  ``main()`` are the reference's.
* Operations: a port cluster with a port ``LizardFuse`` (its client on
  ``CudaChunkEncoder(device="cpu")``) and a JAX cluster with the JAX
  ``LizardFuse`` are driven through the same ctypes callbacks, called
  directly from a worker thread (never from the cluster's event loop,
  which serves the bridge's requests), with no kernel mount: the
  operations of ``tests/test_fuse.py`` (mkdir, create, write, flush,
  release, open, read, getattr, readdir, rename, symlink, readlink,
  setxattr, getxattr, truncate, unlink and the special inodes) and a
  file written in pieces at the goal under test and read back; then one
  master call through the master proxy's port named in ``.masterinfo``;
  then a holder of a data part of chunk 0 stops and the file is read
  again through the callbacks (recovery). Both give the same return
  codes, stat fields, names and read bytes and the same part files by
  (chunk id, part id), at ec(3,2) on six servers and at the shipped
  ec(8,4) on thirteen.
* Masks: the stat times (wall clock); the contents of ``.stats``,
  ``.oplog`` and ``.masterinfo`` are checked for their fields, not
  compared, as they carry counters of the run, ports and session ids.
* A kernel mount, as ``tests/test_fuse.py`` makes one, of the port's
  ``main()`` with its client on the CPU, skipped where the host has no
  ``/dev/fuse`` or the mount does not come up.

Both mounts' native read pools (the C client) are set aside here, so
that both read through their planner path; the pool is compared in
``tests/test_torch_native_read_pool.py``.
"""

import asyncio
import ctypes
import os
import subprocess
import sys

import pytest

from lizardfs_tpu.client import native_client as ref_native_client
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuChunkEncoder
from tests.test_torch_client import (  # noqa: F401 (autouse fixtures)
    ENCODER, GOALS, ROOT, Cluster, asyncio_jax_client, payload, pkgs_of, run, two_threads)
from tests.test_torch_master import assert_copy, assert_departs, mod

GEOMETRY = {"ec32": (6, 3, 5), "ec84": (13, 8, 12)}  # servers, data parts, parts
SIZE = 9 * 65536 + 123
WRITE_PIECE = 2 * 65536
READ_PIECE = 200_000
STAT_FIELDS = ("st_ino", "st_mode", "st_nlink", "st_uid", "st_gid", "st_size", "st_blksize",
               "st_blocks")
_REFERENCE: dict = {}


@pytest.fixture(autouse=True)
def no_native_reads(monkeypatch):
    """Both mounts' native read pools (the C client) set aside."""
    monkeypatch.setattr(ref_native_client, "_lib", None)
    monkeypatch.setattr(mod("port", "client.native_client"), "_lib", None)


def test_master_proxy_is_a_copy():
    assert_copy("client/masterproxy.py")


def test_mount_departs_only_by_its_native_reads_and_encoder():
    """The mount is the JAX package's, its native read pool included, but
    for ``LizardFuse``'s ``encoder`` keyword, which it hands to its
    ``Client``."""
    removed = [
        "def __init__(self, master_addrs: list[tuple[str, int]]):",
        'self.client = Client("", 0, master_addrs=master_addrs)',
    ]
    added = [
        "def __init__(self, master_addrs: list[tuple[str, int]], encoder=None):",
        "# encoder None: the client's default, the card's encoder",
        'self.client = Client("", 0, master_addrs=master_addrs, encoder=encoder)',
    ]
    assert_departs("client/fuse_mount.py", removed, added)


def test_mount_without_an_encoder_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod("port", "client.fuse_mount").LizardFuse([("127.0.0.1", 1)])


class Mount:
    """A ``LizardFuse`` bridge of one package, driven through its ctypes
    operations. Every method blocks on the bridge's own loop, so call
    them from a worker thread, never from the cluster's loop."""

    def __init__(self, pkg: str, master_port: int):
        self.fm = mod(pkg, "client.fuse_mount")
        self.pool = mod(pkg, "core.conn_pool").GLOBAL_POOL
        self.fuse = self.fm.LizardFuse([("127.0.0.1", master_port)],
                                       **({"encoder": ENCODER} if pkg == "port" else {}))
        self.ops = None

    def start(self) -> None:
        self.fuse.start()
        self.ops = self.fuse.build_operations()

    def close(self) -> None:
        """Stop the proxy, close the client and the pool on the bridge's
        loop, then stop that loop."""
        fuse = self.fuse

        async def down():
            if hasattr(fuse, "proxy"):
                await fuse.proxy.stop()
            await fuse.client.close()
            self.pool.close_all()

        try:
            if self.ops is not None:
                fuse._run(down(), timeout=10.0)
        finally:
            fuse.loop.call_soon_threadsafe(fuse.loop.stop)
            fuse._loop_thread.join(10.0)
            fuse.loop.close()

    def file_info(self, flags: int = 0):
        fi = self.fm.FuseFileInfo()
        fi.flags = flags
        return fi

    def stat(self, path: bytes) -> tuple:
        st = self.fm.Stat()
        rc = self.ops.getattr(path, ctypes.pointer(st))
        return rc, {name: getattr(st, name) for name in STAT_FIELDS}

    def write(self, path: bytes, fi, data: bytes, offset: int = 0, piece: int = WRITE_PIECE):
        rcs = []
        for off in range(0, len(data), piece):
            buf = ctypes.create_string_buffer(data[off:off + piece], len(data[off:off + piece]))
            rcs.append(self.ops.write(path, ctypes.addressof(buf), len(buf), offset + off,
                                      ctypes.pointer(fi)))
        return rcs

    def read(self, path: bytes, fi, size: int, offset: int = 0, piece: int = READ_PIECE) -> bytes:
        out = b""
        for off in range(offset, offset + size, piece):
            n = min(piece, offset + size - off)
            buf = ctypes.create_string_buffer(n)
            rc = self.ops.read(path, ctypes.addressof(buf), n, off, ctypes.pointer(fi))
            assert rc >= 0, rc
            out += buf.raw[:rc]
        return out

    def readdir(self, path: bytes) -> tuple:
        names = []

        def fill(buf, name, st, off):
            names.append(name)
            return 0

        rc = self.ops.readdir(path, None, self.fm.FILL_DIR_T(fill), 0,
                              ctypes.pointer(self.file_info()))
        return rc, names

    def special(self, path: bytes) -> str:
        fi = self.file_info()
        assert self.ops.open(path, ctypes.pointer(fi)) == 0
        text = self.read(path, fi, 1 << 16).decode()
        self.ops.release(path, ctypes.pointer(fi))
        return text

    def invalidate(self, inode: int) -> None:
        async def drop():
            self.fuse.client.cache.invalidate(inode)

        self.fuse._run(drop())


def operations(mnt: Mount, data: bytes) -> tuple[list, int, int]:
    """The operations of ``tests/test_fuse.py`` and a file written at the
    root's goal; returns what they gave, the file's inode and the proxy's
    port."""
    ops, out = mnt.ops, []
    out.append(("mkdir", ops.mkdir(b"/dir", 0o755)))
    fi = mnt.file_info(os.O_WRONLY)
    out.append(("create", ops.create(b"/data.bin", 0o644, ctypes.pointer(fi))))
    inode = fi.fh
    out.append(("write", mnt.write(b"/data.bin", fi, data)))
    out.append(("flush", ops.flush(b"/data.bin", ctypes.pointer(fi))))
    out.append(("release", ops.release(b"/data.bin", ctypes.pointer(fi))))
    fi = mnt.file_info(os.O_RDONLY)
    out.append(("open", ops.open(b"/data.bin", ctypes.pointer(fi)), fi.fh == inode))
    out.append(("read back", mnt.read(b"/data.bin", fi, len(data)) == data))
    out.append(("release", ops.release(b"/data.bin", ctypes.pointer(fi))))
    out.append(("getattr", mnt.stat(b"/data.bin")))
    hello = b"hello fuse world\n" * 1000
    fi = mnt.file_info(os.O_RDWR)
    out.append(("create", ops.create(b"/dir/hello.txt", 0o644, ctypes.pointer(fi))))
    out.append(("write", mnt.write(b"/dir/hello.txt", fi, hello)))
    out.append(("read", mnt.read(b"/dir/hello.txt", fi, len(hello)) == hello))
    out.append(("release", ops.release(b"/dir/hello.txt", ctypes.pointer(fi))))
    out.append(("rename", ops.rename(b"/dir/hello.txt", b"/renamed.txt")))
    out.append(("getattr", mnt.stat(b"/renamed.txt")))
    out.append(("missing", mnt.stat(b"/dir/hello.txt")[0]))
    out.append(("symlink", ops.symlink(b"/renamed.txt", b"/slink")))
    buf = ctypes.create_string_buffer(256)
    out.append(("readlink", ops.readlink(b"/slink", ctypes.addressof(buf), 256), buf.value))
    value = ctypes.create_string_buffer(b"v", 1)
    out.append(("setxattr", ops.setxattr(b"/renamed.txt", b"user.k", ctypes.addressof(value), 1, 0)))
    got = ctypes.create_string_buffer(16)
    rc = ops.getxattr(b"/renamed.txt", b"user.k", ctypes.addressof(got), 16)
    out.append(("getxattr", rc, got.raw[:max(rc, 0)]))
    fi = mnt.file_info(os.O_RDWR)
    out.append(("open", ops.open(b"/renamed.txt", ctypes.pointer(fi))))
    out.append(("pwrite", mnt.write(b"/renamed.txt", fi, b"FUSE!", offset=5)))
    out.append(("read", mnt.read(b"/renamed.txt", fi, 17)))
    out.append(("release", ops.release(b"/renamed.txt", ctypes.pointer(fi))))
    out.append(("truncate", ops.truncate(b"/renamed.txt", 10), mnt.stat(b"/renamed.txt")))
    out.append(("readdir", mnt.readdir(b"/")))
    out.append(("unlink", ops.unlink(b"/slink"), ops.rmdir(b"/dir"), mnt.readdir(b"/")))
    stats = mnt.special(b"/.stats")
    info = mnt.special(b"/.masterinfo")
    assert "CltomaCreate" in stats and "cache_hits" in stats, stats
    assert "master: 127.0.0.1" in info and "session:" in info, info
    assert "CltomaLookup" in mnt.special(b"/.oplog")
    proxy = next(line for line in info.splitlines() if line.startswith("masterproxy:"))
    return out, inode, int(proxy.rpartition(":")[2])


def _session(root, kind: str, goal: str):
    n_cs, data_parts, _ = GEOMETRY[goal]
    data = payload(SIZE, SIZE)
    pkg = pkgs_of(kind)["client"]

    async def go():
        cluster = Cluster(root / f"{kind}-{goal}", n_cs=n_cs, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        mnt = Mount(pkg, cluster.master.port)
        try:
            admin = await cluster.client()
            await admin.setgoal(1, GOALS[goal])
            await asyncio.to_thread(mnt.start)
            out, inode, proxy_port = await asyncio.to_thread(operations, mnt, data)
            # one master call through the mount's proxy
            tool = mod(pkg, "client.client").Client(
                "127.0.0.1", proxy_port, encoder=ENCODER if pkg == "port" else RefCpuChunkEncoder())
            await tool.connect()
            try:
                attr = await tool.lookup(1, "data.bin")
                out.append(("through the proxy", attr.inode == inode, attr.length))
            finally:
                await tool.close()
            parts = cluster.live_parts()
            out.append(("chunk 0 parts", await cluster.stop_data_holder(inode, data_parts)))
            await asyncio.to_thread(mnt.invalidate, inode)

            def read_degraded():
                fi = mnt.file_info(os.O_RDONLY)
                assert mnt.ops.open(b"/data.bin", ctypes.pointer(fi)) == 0
                try:
                    return mnt.read(b"/data.bin", fi, SIZE)
                finally:
                    mnt.ops.release(b"/data.bin", ctypes.pointer(fi))

            degraded = await asyncio.to_thread(read_degraded)
            return out, degraded, parts
        finally:
            await asyncio.to_thread(mnt.close)
            await cluster.stop()

    return run(go())


def reference(root, goal: str):
    if goal not in _REFERENCE:
        _REFERENCE[goal] = _session(root, "jax", goal)
    return _REFERENCE[goal]


@pytest.mark.parametrize("goal", sorted(GEOMETRY))
def test_operations_match_reference(tmp_path, goal):
    out, degraded, parts = _session(tmp_path, "port", goal)
    ref_out, ref_degraded, ref_parts = reference(tmp_path, goal)
    assert ("read back", True) in out and ("chunk 0 parts", GEOMETRY[goal][2]) in out
    assert ("through the proxy", True, SIZE) in out
    assert ("read", b"helloFUSE! world\n") in out
    assert out == ref_out
    assert degraded == ref_degraded == payload(SIZE, SIZE)
    assert parts == ref_parts and parts


# --- a kernel mount -------------------------------------------------------------

# the port's mount entry point with its client on the CPU
LAUNCH = """import sys
from lizardfs_tpu_torch.client import fuse_mount
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder


class OnTheCpu(fuse_mount.LizardFuse):
    def __init__(self, master_addrs):
        super().__init__(master_addrs, encoder=CudaChunkEncoder(device="cpu"))


fuse_mount.LizardFuse = OnTheCpu
sys.exit(fuse_mount.main(sys.argv[1:]))
"""


def test_kernel_mount_end_to_end(tmp_path):
    """``tests/test_fuse.py``'s kernel mount, through the port's
    ``main()`` on a port cluster."""
    if not os.path.exists("/dev/fuse"):
        pytest.skip("no /dev/fuse")

    async def go():
        cluster = Cluster(tmp_path, n_cs=5)
        await cluster.start()
        mnt = tmp_path / "mnt"
        mnt.mkdir()
        proc = subprocess.Popen(
            [sys.executable, "-c", LAUNCH, "--master", f"127.0.0.1:{cluster.master.port}",
             str(mnt)],
            env=dict(os.environ, PYTHONPATH=str(ROOT)), stderr=subprocess.PIPE)
        try:
            # every syscall on the mount point runs off this loop, which
            # serves the mount's requests
            for _ in range(100):
                await asyncio.sleep(0.2)
                if await asyncio.to_thread(os.path.ismount, mnt):
                    break
            else:
                proc.terminate()
                err = (await asyncio.to_thread(proc.stderr.read)).decode()[:500]
                pytest.skip(f"mount did not come up (no privileges?): {err}")

            def work():
                os.mkdir(mnt / "dir")
                data = b"hello fuse world\n" * 1000
                with open(mnt / "dir" / "hello.txt", "wb") as f:
                    f.write(data)
                with open(mnt / "dir" / "hello.txt", "rb") as f:
                    assert f.read() == data
                os.rename(mnt / "dir" / "hello.txt", mnt / "renamed.txt")
                assert os.stat(mnt / "renamed.txt").st_size == len(data)
                os.symlink("/renamed.txt", mnt / "slink")
                assert os.readlink(mnt / "slink") == "/renamed.txt"
                os.setxattr(mnt / "renamed.txt", b"user.k", b"v")
                assert os.getxattr(mnt / "renamed.txt", b"user.k") == b"v"
                with open(mnt / "renamed.txt", "r+b") as f:
                    f.seek(5)
                    f.write(b"FUSE!")
                with open(mnt / "renamed.txt", "rb") as f:
                    assert f.read(17) == b"helloFUSE! world\n"
                os.truncate(mnt / "renamed.txt", 10)
                assert os.stat(mnt / "renamed.txt").st_size == 10
                assert sorted(os.listdir(mnt)) == ["dir", "renamed.txt", "slink"]
                stats = open(mnt / ".stats").read()
                assert "CltomaCreate" in stats and "cache_hits" in stats
                info = open(mnt / ".masterinfo").read()
                assert "master: 127.0.0.1" in info and "session:" in info
                assert "CltomaLookup" in open(mnt / ".oplog").read()

            await asyncio.to_thread(work)
        finally:
            await asyncio.to_thread(subprocess.run, ["fusermount", "-u", str(mnt)], check=False)
            try:
                await asyncio.to_thread(proc.wait, 10)
            except subprocess.TimeoutExpired:
                proc.kill()
            await cluster.stop()

    run(go())
