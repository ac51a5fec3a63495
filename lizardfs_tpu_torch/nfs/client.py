"""Minimal NFSv3 wire client (RFC 1813 XDR over ONC-RPC).

Speaks real wire format against any NFS3 server, primarily this
package's gateway. Used three ways: the gateway's e2e tests (both
directions of the codec exercised against the spec, not against
itself), the NFS throughput bench row, and scripted multi-gateway
drives (see doc/migration.md "NFS scale-out"). Reference analog: the
Ganesha FSAL test clients (reference: src/nfs-ganesha/).
"""

from __future__ import annotations

from lizardfs_tpu_torch.nfs import rpc
from lizardfs_tpu_torch.nfs import server as nfs
from lizardfs_tpu_torch.nfs.xdr import Packer


class Nfs3Client:
    """Minimal NFS3 wire client for the tests."""

    def __init__(self, host: str, port: int, uid: int = 0, gid: int = 0):
        self.rpc = rpc.RpcClient(
            host, port, rpc.Credential(uid=uid, gid=gid, machine="test")
        )

    async def __aenter__(self):
        # lint: waive(unbounded-await): delegates to RpcClient.connect, whose dial is wait_for-bounded at 5 s
        await self.rpc.connect()
        return self

    async def __aexit__(self, *exc):
        await self.rpc.close()

    async def mnt(self, path: str = "/") -> bytes:
        u = await self.rpc.call(nfs.PROG_MOUNT, 3, 1, Packer().string(path).bytes())
        assert u.u32() == nfs.NFS3_OK
        fh = u.opaque(64)
        nflavors = u.u32()
        flavors = [u.u32() for _ in range(nflavors)]
        assert rpc.AUTH_SYS in flavors
        return fh

    async def call(self, proc: int, args: bytes):
        return await self.rpc.call(nfs.PROG_NFS, 3, proc, args)

    @staticmethod
    def skip_post_op(u):
        if u.boolean():
            u.fixed(84)

    @staticmethod
    def read_fattr(u) -> dict:
        ftype, mode, nlink, uid, gid = (u.u32() for _ in range(5))
        size, used = u.u64(), u.u64()
        u.u32(), u.u32(), u.u64()
        fileid = u.u64()
        times = [(u.u32(), u.u32()) for _ in range(3)]
        return dict(ftype=ftype, mode=mode, nlink=nlink, uid=uid, gid=gid,
                    size=size, fileid=fileid, times=times)

    @staticmethod
    def skip_wcc(u):
        if u.boolean():
            u.fixed(24)
        Nfs3Client.skip_post_op(u)

    async def lookup(self, dirfh: bytes, name: str):
        u = await self.call(3, Packer().opaque(dirfh).string(name).bytes())
        code = u.u32()
        if code != nfs.NFS3_OK:
            return code, None, None
        fh = u.opaque(64)
        attr = None
        if u.boolean():
            attr = self.read_fattr(u)
        return nfs.NFS3_OK, fh, attr

    async def getattr(self, fh: bytes) -> dict:
        u = await self.call(1, Packer().opaque(fh).bytes())
        assert u.u32() == nfs.NFS3_OK
        return self.read_fattr(u)

    async def mkdir(self, dirfh: bytes, name: str, mode: int = 0o755) -> bytes:
        args = (Packer().opaque(dirfh).string(name)
                .boolean(True).u32(mode)  # mode
                .boolean(False).boolean(False).boolean(False)  # uid/gid/size
                .u32(0).u32(0)  # atime/mtime: don't change
                .bytes())
        u = await self.call(9, args)
        assert u.u32() == nfs.NFS3_OK
        assert u.boolean()
        return u.opaque(64)

    async def create(self, dirfh: bytes, name: str, mode: int = 0o644,
                     how: int = 0, verf: bytes = b"\x00" * 8):
        p = Packer().opaque(dirfh).string(name).u32(how)
        if how == 2:
            p.fixed(verf)
        else:
            (p.boolean(True).u32(mode)
             .boolean(False).boolean(False).boolean(False)
             .u32(0).u32(0))
        u = await self.call(8, p.bytes())
        code = u.u32()
        if code != nfs.NFS3_OK:
            return code, None
        assert u.boolean()
        return nfs.NFS3_OK, u.opaque(64)

    async def write(self, fh: bytes, offset: int, data: bytes,
                    expect=nfs.NFS3_OK, stable: int = 2) -> int:
        """stable: 0 UNSTABLE (gathered server-side, COMMIT required),
        1 DATA_SYNC, 2 FILE_SYNC (default: durable before reply)."""
        args = (Packer().opaque(fh).u64(offset).u32(len(data)).u32(stable)
                .opaque(data).bytes())
        u = await self.call(7, args)
        code = u.u32()
        assert code == expect, f"WRITE -> {code}"
        if code != nfs.NFS3_OK:
            return 0
        self.skip_wcc(u)
        n = u.u32()
        committed = u.u32()
        # the server may commit MORE strictly than asked, never less
        assert committed >= (2 if stable == 2 else 0)
        return n

    async def commit(self, fh: bytes, offset: int = 0, count: int = 0) -> bytes:
        """COMMIT gathered UNSTABLE writes; returns the write verifier
        (a changed verifier between writes and commit means the server
        rebooted and the client must resend)."""
        u = await self.call(
            21, Packer().opaque(fh).u64(offset).u32(count).bytes()
        )
        assert u.u32() == nfs.NFS3_OK
        self.skip_wcc(u)
        return u.fixed(8)

    async def setattr(self, fh: bytes, mode: int | None = None,
                      size: int | None = None,
                      guard_ctime: int | None = None) -> int:
        """SETATTR (proc 2); returns the NFS3 status (callers assert).
        ``guard_ctime`` packs the sattrguard3 compare-and-set."""
        p = Packer().opaque(fh)
        p.boolean(mode is not None)
        if mode is not None:
            p.u32(mode)
        p.boolean(False).boolean(False)  # uid/gid unchanged
        p.boolean(size is not None)
        if size is not None:
            p.u64(size)
        p.u32(0).u32(0)  # atime/mtime: DONT_CHANGE
        p.boolean(guard_ctime is not None)
        if guard_ctime is not None:
            p.u32(guard_ctime).u32(0)
        u = await self.call(2, p.bytes())
        return u.u32()

    async def fsinfo(self, fh: bytes) -> dict:
        """FSINFO (proc 19): the server's transfer-size preferences —
        real kernel clients size rsize/wsize from these, so bulk
        drivers should too."""
        u = await self.call(19, Packer().opaque(fh).bytes())
        assert u.u32() == nfs.NFS3_OK
        self.skip_post_op(u)
        rtmax, rtpref, _rtmult = u.u32(), u.u32(), u.u32()
        wtmax, wtpref, _wtmult = u.u32(), u.u32(), u.u32()
        return {"rtmax": rtmax, "rtpref": rtpref,
                "wtmax": wtmax, "wtpref": wtpref}

    async def read(self, fh: bytes, offset: int, count: int) -> tuple[bytes, bool]:
        u = await self.call(6, Packer().opaque(fh).u64(offset).u32(count).bytes())
        assert u.u32() == nfs.NFS3_OK
        self.skip_post_op(u)
        n = u.u32()
        eof = u.boolean()
        data = u.opaque(1 << 22)
        assert len(data) == n
        return data, eof

    async def readdir(self, dirfh: bytes, plus: bool = False,
                      maxcount: int = 4096) -> list[str]:
        names, cookie, verf = [], 0, b"\x00" * 8
        while True:
            p = Packer().opaque(dirfh).u64(cookie).fixed(verf)
            if plus:
                p.u32(1 << 16)
            p.u32(maxcount)
            u = await self.call(17 if plus else 16, p.bytes())
            assert u.u32() == nfs.NFS3_OK
            self.skip_post_op(u)
            verf = u.fixed(8)  # cookieverf
            got = 0
            while u.boolean():
                u.u64()  # fileid
                names.append(u.string(255))
                cookie = u.u64()
                if plus:
                    self.skip_post_op(u)
                    if u.boolean():
                        u.opaque(64)
                got += 1
            if u.boolean() or got == 0:  # eof
                return names

