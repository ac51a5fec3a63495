"""NFSv3 + MOUNT3 gateway server (RFC 1813) backed by the cluster client.

Role parity with the reference's NFS-Ganesha FSAL
(src/nfs-ganesha/main.c, handle.c, export.c ~4.2k LoC): expose the
filesystem to standard NFS clients with per-RPC AUTH_SYS identity
enforced by the master. Instead of plugging into an external Ganesha
daemon, the gateway embeds the protocol server itself: one asyncio
process, one cluster ``Client`` connection shared by all NFS consumers
(identity travels per-call, like Ganesha's op_ctx credentials).

File handles are stable ``b"LZFH" + u32 inode`` — the master's inode
space is flat and persistent, so handles survive gateway restarts (the
FSAL's wire-handle round-trip, src/nfs-ganesha/handle.c
lzfs_fsal_wire_to_host analog).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import secrets
import struct
import time

from lizardfs_tpu_torch.client.cache import ReadaheadAdviser
from lizardfs_tpu_torch.client.client import Client
from lizardfs_tpu_torch.constants import EATTR_NOENTRYCACHE, MFSBLOCKSIZE
from lizardfs_tpu_torch.nfs import rpc
from lizardfs_tpu_torch.nfs.xdr import Packer, Unpacker
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import accounting
from lizardfs_tpu_torch.runtime import profiler as profmod
from lizardfs_tpu_torch.runtime import retry as retrymod
from lizardfs_tpu_torch.runtime import slo as slomod
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.metrics import Metrics
from lizardfs_tpu_torch.runtime.tweaks import Tweaks

log = logging.getLogger("lizardfs.nfs")

PROG_PORTMAP, PROG_NFS, PROG_MOUNT = 100000, 100003, 100005
ROOT_INODE = 1

# NFS3 status codes (RFC 1813 §2.6)
NFS3_OK = 0
NFS3ERR_PERM = 1
NFS3ERR_NOENT = 2
NFS3ERR_IO = 5
NFS3ERR_NXIO = 6
NFS3ERR_ACCES = 13
NFS3ERR_EXIST = 17
NFS3ERR_NOTDIR = 20
NFS3ERR_ISDIR = 21
NFS3ERR_INVAL = 22
NFS3ERR_FBIG = 27
NFS3ERR_NOSPC = 28
NFS3ERR_ROFS = 30
NFS3ERR_MLINK = 31
NFS3ERR_NAMETOOLONG = 63
NFS3ERR_NOTEMPTY = 66
NFS3ERR_DQUOT = 69
NFS3ERR_STALE = 70
NFS3ERR_BADHANDLE = 10001
NFS3ERR_NOT_SYNC = 10002
NFS3ERR_BAD_COOKIE = 10003
NFS3ERR_NOTSUPP = 10004
NFS3ERR_TOOSMALL = 10005
NFS3ERR_SERVERFAULT = 10006
# RFC 1813 §2.6: "the server initiated the request, but was not able
# to complete it in a timely fashion ... retry later" — the jukebox
# (near-line media) delay code every NFS client honors with backoff.
# QoS fair-share sheds (st.BUSY) map here: back off, retry, never fail.
NFS3ERR_JUKEBOX = 10008

_STATUS_MAP = {
    st.OK: NFS3_OK,
    st.EPERM: NFS3ERR_PERM,
    st.ENOENT: NFS3ERR_NOENT,
    st.EACCES: NFS3ERR_ACCES,
    st.EEXIST: NFS3ERR_EXIST,
    st.EINVAL: NFS3ERR_INVAL,
    st.ENOTDIR: NFS3ERR_NOTDIR,
    st.EISDIR: NFS3ERR_ISDIR,
    st.ENOSPC: NFS3ERR_NOSPC,
    st.EIO: NFS3ERR_IO,
    st.ENOTEMPTY: NFS3ERR_NOTEMPTY,
    st.QUOTA_EXCEEDED: NFS3ERR_DQUOT,
    st.NAME_TOO_LONG: NFS3ERR_NAMETOOLONG,
    st.EROFS: NFS3ERR_ROFS,
    st.NO_CHUNK: NFS3ERR_STALE,
    st.BUSY: NFS3ERR_JUKEBOX,
}

# ftype (proto) -> NF3 type
_NF3 = {m.FTYPE_FILE: 1, m.FTYPE_DIR: 2, m.FTYPE_SYMLINK: 5}

# ACCESS3 request bits
ACCESS3_READ = 0x01
ACCESS3_LOOKUP = 0x02
ACCESS3_MODIFY = 0x04
ACCESS3_EXTEND = 0x08
ACCESS3_DELETE = 0x10
ACCESS3_EXECUTE = 0x20


class _NfsError(Exception):
    def __init__(self, code: int):
        self.code = code


def _nfs_code(e: st.StatusError) -> int:
    return _STATUS_MAP.get(e.code, NFS3ERR_IO)


def fh_pack(inode: int) -> bytes:
    return struct.pack(">4sI", b"LZFH", inode)


def fh_unpack(handle: bytes) -> int:
    if len(handle) != 8 or handle[:4] != b"LZFH":
        raise _NfsError(NFS3ERR_BADHANDLE)
    return struct.unpack(">I", handle[4:])[0]


def _pack_fattr3(p: Packer, a: m.Attr) -> None:
    p.u32(_NF3.get(a.ftype, 1))
    p.u32(a.mode & 0o7777)
    p.u32(max(a.nlink, 1))
    p.u32(a.uid).u32(a.gid)
    p.u64(a.length)
    p.u64((a.length + MFSBLOCKSIZE - 1) // MFSBLOCKSIZE * MFSBLOCKSIZE)
    p.u32(0).u32(0)  # rdev
    p.u64(0x4C5A4653)  # fsid ("LZFS")
    p.u64(a.inode)
    p.u32(a.atime).u32(0)
    p.u32(a.mtime).u32(0)
    p.u32(a.ctime).u32(0)


def _post_op_attr(p: Packer, a: m.Attr | None) -> None:
    if a is None:
        p.boolean(False)
    else:
        p.boolean(True)
        _pack_fattr3(p, a)


def _wcc_data(p: Packer, post: m.Attr | None) -> None:
    p.boolean(False)  # pre_op_attr: not tracked
    _post_op_attr(p, post)


class _Sattr3:
    """Decoded sattr3: which attributes a SETATTR/CREATE wants to set."""

    def __init__(self, u: Unpacker):
        self.mode = u.u32() if u.boolean() else None
        self.uid = u.u32() if u.boolean() else None
        self.gid = u.u32() if u.boolean() else None
        self.size = u.u64() if u.boolean() else None
        how = u.u32()  # atime
        self.atime = None
        if how == 1:
            self.atime = int(time.time())
        elif how == 2:
            self.atime = u.u32()
            u.u32()
        how = u.u32()  # mtime
        self.mtime = None
        if how == 1:
            self.mtime = int(time.time())
        elif how == 2:
            self.mtime = u.u32()
            u.u32()

    def set_mask(self) -> tuple[int, dict]:
        mask, kw = 0, {}
        if self.mode is not None:
            mask |= 1
            kw["mode"] = self.mode & 0o7777
        if self.uid is not None:
            mask |= 2
            kw["uid"] = self.uid
        if self.gid is not None:
            mask |= 4
            kw["gid"] = self.gid
        if self.atime is not None:
            mask |= 8
            kw["atime"] = self.atime
        if self.mtime is not None:
            mask |= 16
            kw["mtime"] = self.mtime
        return mask, kw


class _WriteGather:
    """Write-behind buffer for one inode's UNSTABLE writes.

    Sequential 64 KiB WRITEs coalesce into contiguous runs that flush
    as few large pwrites (one striped RMW per run instead of one per
    wire op). The analog of knfsd/Ganesha write gathering; COMMIT and
    any dependent read/attr op force the flush (RFC 1813 §3.3.7/21).
    """

    def __init__(self) -> None:
        self.segs: list[tuple[int, bytearray]] = []  # sorted, disjoint
        self.nbytes = 0
        self.last_add = 0.0

    def try_add(self, offset: int, data: bytes) -> bool:
        """Append/merge; False when the write overlaps existing segments
        (caller flushes first — overlap means a retransmit or random
        rewrite, both rare)."""
        self.last_add = time.monotonic()
        new_end = offset + len(data)
        # overlap check FIRST, against every segment: a merge that runs
        # a segment over a later one would flush stale bytes on top of
        # newer ones
        for start, buf in self.segs:
            if offset < start + len(buf) and new_end > start:
                return False
        for i, (start, buf) in enumerate(self.segs):
            end = start + len(buf)
            if offset == end:
                buf.extend(data)
                # merge with the next segment if we just bridged the gap
                if (i + 1 < len(self.segs)
                        and start + len(buf) == self.segs[i + 1][0]):
                    buf.extend(self.segs[i + 1][1])
                    del self.segs[i + 1]
                self.nbytes += len(data)
                return True
            if new_end == start:
                self.segs[i] = (offset, bytearray(data) + buf)
                self.nbytes += len(data)
                return True
        self.segs.append((offset, bytearray(data)))
        self.segs.sort(key=lambda s: s[0])
        self.nbytes += len(data)
        return True

    @property
    def end(self) -> int:
        return max((s + len(b) for s, b in self.segs), default=0)


class NfsGateway:
    """One process serving MOUNT3 + NFS3 (and a local portmapper view).

    ``exports`` maps export path -> cluster path ("/" by default). The
    master still enforces its own exports/session ACLs on every op via
    the per-RPC AUTH_SYS identity.
    """

    def __init__(
        self,
        master_host: str,
        master_port: int,
        host: str = "127.0.0.1",
        port: int = 0,
        exports: dict[str, str] | None = None,
        encoder=None,
    ) -> None:
        # one gateway-local registry shared with the embedded Client:
        # the write window's depth/credit/coalesce series land next to
        # the gateway's SLO gauges, so whatever scrapes this registry
        # sees the whole write-path story (the client would otherwise
        # hold them in a private registry nothing exports)
        self.metrics = Metrics()
        self.client = Client(master_host, master_port, metrics=self.metrics,
                             encoder=encoder)
        self.rpc = rpc.RpcServer(host, port)
        self.exports = exports or {"/": "/"}
        self.write_verf = secrets.token_bytes(8)
        self._mounts: set[tuple[str, str]] = set()
        # export-root inodes, resolved at MNT time: ".." clamps here so
        # a mount can't walk above its export (master-side subtree
        # sessions clamp too when the gateway session itself is rooted).
        # Like knfsd's default no_subtree_check, handles *guessed* for
        # inodes outside an export are not rejected — use master-side
        # subtree exports for hard isolation.
        self._export_roots: set[int] = set()
        # UNSTABLE write gathering: inode -> buffered segments; flushed
        # on COMMIT / stable writes / dependent ops / idle timer / size
        # caps. Serialized per inode so a flush never races an add.
        self._gather: dict[int, _WriteGather] = {}
        self._gather_locks: dict[int, asyncio.Lock] = {}
        self._gather_total = 0  # bytes buffered across all inodes
        self._gather_task: asyncio.Task | None = None
        self.GATHER_FLUSH_BYTES = 8 * 2**20     # per inode
        self.GATHER_TOTAL_BYTES = 64 * 2**20    # whole gateway
        self.GATHER_IDLE_S = 1.0
        # server-side readahead (r04 weak #3: cold per-READ path read at
        # half the gateway's own write speed): per-inode sequentiality
        # detector + one buffered span ahead of the stream, refilled
        # under a per-inode lock so 8 pipelined 64 KiB READs cost one
        # back-end fetch, not 8. Coherence: an invalidate-listener on
        # the client's BlockCache drops the span on ANY invalidation
        # (local write/truncate or master push from another gateway's
        # mutation) + a TTL backstop mirroring the BlockCache's.
        self._ra: dict[int, list] = {}  # inode -> [adviser, off, buf, ts]
        self._ra_locks: dict[int, asyncio.Lock] = {}
        self._ra_epoch: dict[int, int] = {}  # bumped by every drop
        # sequentiality detectors OUTLIVE the spans: a write invalidates
        # cached bytes, not the fact that the reader is streaming
        self._ra_advisers: dict[int, ReadaheadAdviser] = {}
        self.RA_WINDOW_MAX = 4 * 2**20   # per inode
        self.RA_TOTAL_BYTES = 64 * 2**20  # whole gateway
        self.RA_TTL_S = 1.0
        self._ra_total = 0
        # access/attr decision caches: without them every wire READ or
        # WRITE pays 1-2 master RPCs (access + getattr) — kernel NFS
        # servers/clients cache both far longer than this TTL. Both are
        # dropped per inode by (a) the invalidate listener (local
        # writes + master pushes — the master pushes on metadata
        # mutations too: chmod/setattr/seteattr/ACL changes via ANY
        # session revoke these caches promptly) and (b) _meta_dirty()
        # after every metadata-mutating proc THIS gateway serves;
        # the TTL remains the backstop for sessions whose watch
        # subscription on the inode has expired master-side.
        self._access_cache: dict[int, dict[tuple, tuple[bool, float]]] = {}
        self._access_cache_n = 0
        self._attr_cache: dict[int, tuple[object, float]] = {}
        # META_TTL_S is the operator-tunable consistency knob (ADVICE
        # r05 item 4): the master now pushes invalidations on metadata
        # mutations too (chmod/setattr/seteattr/ACLs), so cross-gateway
        # revocation is push-prompt for watched inodes; the TTL bounds
        # staleness only when the watch subscription expired. Still a
        # runtime tweak so operators can trade residual lag against
        # master RPC load without a restart; 0 disables the caches.
        # See doc/operations.md.
        self.tweaks = Tweaks()
        self._meta_ttl = self.tweaks.register("meta_ttl_s", 1.0)
        self.client.cache.add_invalidate_listener(self._on_invalidate)
        # NFS joins the trace domain: every dispatched proc begins (or
        # joins) a trace at the wire boundary, so the id propagates
        # through the shared Client into master RPCs and the data
        # plane — the last anonymous entry point closed. The op's
        # boundary span lands in the client's ring under role "nfs".
        # The "nfs" SLO class accounts per-proc latency; the registry
        # (self.metrics, created up top and shared with the Client) is
        # gateway-local (no admin port on the gateway), the flight
        # recorder's slowops stay queryable in-process.
        self.slo = slomod.SloEngine(
            self.metrics, role="nfs",
            span_source=self.client.trace_ring.dump,
        )
        # per-session protocol-op accounting (runtime/accounting.py):
        # every NFS proc charges the gateway's cluster session under an
        # "nfs_<proc>" class; the top-K summary is pushed to the master
        # (CltomaSessionStats) so `lizardfs-admin top` names what this
        # front door is doing. The embedded Client's own session_ops
        # (logical read/write) share the same registry.
        self.session_ops = accounting.SessionOps(
            self.metrics, "nfs", max_sessions=8
        )
        self.stats_push_interval_s = 5.0
        self._stats_task: asyncio.Task | None = None
        # always-on sampling profiler (runtime/profiler.py; the
        # process-wide shared instance), dumped at GET /profile on the
        # HTTP observability listener
        self.profiler = profmod.process_profiler(role="nfs")
        self.slo.profiler = self.profiler
        self.slo.recorder.profile_source = self.profiler.collapsed
        # HTTP observability endpoint (the S3 gateway serves /metrics +
        # /healthz on its protocol port; NFS can't — the wire speaks
        # ONC-RPC — so a sibling listener owns them). http_port=0
        # binds an ephemeral port (read it back after start()); None
        # disables the listener.
        self.http_host = host
        self.http_port: int | None = 0
        self._http_server: asyncio.Server | None = None

    @property
    def port(self) -> int:
        return self.rpc.port

    # kept as an attribute-style accessor for existing call sites and
    # tests; assignment routes through the tweak so `tweaks`/`META_TTL_S`
    # can never disagree
    @property
    def META_TTL_S(self) -> float:
        return float(self._meta_ttl.value)

    @META_TTL_S.setter
    def META_TTL_S(self, value: float) -> None:
        self._meta_ttl.value = float(value)

    def _lock_entry(self, inode: int) -> list:
        # [lock, refcount] — dropped when nobody holds or awaits it
        # (same pattern as the client's per-chunk write locks)
        e = self._gather_locks.get(inode)
        if e is None:
            e = self._gather_locks[inode] = [asyncio.Lock(), 0]
        return e

    async def _flush_locked(self, inode: int) -> None:
        """Write out the inode's gathered segments; caller holds its
        gather lock. On failure the unwritten segments are RE-QUEUED —
        the server has acked these bytes as UNSTABLE, and dropping them
        while write_verf stays unchanged would make the client discard
        its only copy (RFC 1813 verifier contract)."""
        g = self._gather.pop(inode, None)
        if g is None:
            return
        self._gather_total -= g.nbytes
        for i, (start, buf) in enumerate(g.segs):
            try:
                await self.client.pwrite(inode, start, bytes(buf))
            except Exception:
                requeue = _WriteGather()
                requeue.segs = g.segs[i:]  # current run is idempotent
                requeue.nbytes = sum(len(b) for _, b in requeue.segs)
                requeue.last_add = time.monotonic()
                self._gather[inode] = requeue
                self._gather_total += requeue.nbytes
                raise

    async def _flush_inode(self, inode: int) -> None:
        """Write out an inode's gathered UNSTABLE segments (no-op when
        nothing is buffered)."""
        if inode not in self._gather:
            return
        e = self._lock_entry(inode)
        e[1] += 1
        try:
            async with e[0]:
                await self._flush_locked(inode)
        finally:
            e[1] -= 1
            if e[1] == 0 and self._gather_locks.get(inode) is e:
                del self._gather_locks[inode]

    async def _flush_all(self) -> None:
        for inode in list(self._gather):
            await self._flush_inode(inode)

    async def _gather_sweep(self) -> None:
        """Bound the write-behind window: idle inodes flush after
        GATHER_IDLE_S even without a COMMIT. The task must survive ANY
        flush error (a dead master connection raises ConnectionError,
        not StatusError) — data stays queued and retries next tick."""
        while True:
            await asyncio.sleep(self.GATHER_IDLE_S / 2)
            now = time.monotonic()
            for inode, g in list(self._gather.items()):
                if now - g.last_add >= self.GATHER_IDLE_S:
                    try:
                        await self._flush_inode(inode)
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001
                        log.exception("idle flush failed for %d", inode)
            # readahead hygiene: expire stale spans, then drop idle
            # per-inode locks/epochs (an unlocked inode with no span
            # needs neither — the next READ recreates both)
            for inode, e in list(self._ra.items()):
                if now - e[3] > self.RA_TTL_S:
                    self._ra_drop(inode)
            for inode, lock in list(self._ra_locks.items()):
                if not lock.locked() and inode not in self._ra:
                    del self._ra_locks[inode]
                    self._ra_epoch.pop(inode, None)
                    self._ra_advisers.pop(inode, None)

    async def start(self) -> None:
        # unified RetryPolicy: a gateway racing master startup (or an
        # election) retries under one 30 s end-to-end budget instead of
        # dying on the first refused connect; every dial the nested
        # Client.connect makes inherits the same deadline
        await retrymod.RetryPolicy(
            attempts=10, base_delay=0.2, max_delay=2.0, deadline=30.0,
        ).run(
            lambda: self.client.connect(info="nfs-gateway"),
            what="nfs gateway master connect", log=log,
        )
        self._gather_task = asyncio.ensure_future(self._gather_sweep())
        for target in self.exports.values():
            # pre-resolve export roots: clients reusing cached handles
            # after a gateway restart never re-MNT
            try:
                root = await self.client.resolve(target)
                self._export_roots.add(root.inode)
            except st.StatusError:
                pass  # export target may be created later; MNT re-resolves
        self.rpc.register(PROG_MOUNT, 3, self._mount_dispatch)
        self.rpc.register(PROG_NFS, 3, self._nfs_dispatch)
        self.rpc.register(PROG_PORTMAP, 2, self._portmap_dispatch)
        await self.rpc.start()
        if self.http_port is not None:
            self._http_server = await asyncio.start_server(
                self._http_conn, self.http_host, self.http_port
            )
            self.http_port = self._http_server.sockets[0].getsockname()[1]
            log.info("nfs observability endpoint on port %d", self.http_port)
        self.profiler.start()  # no-op under LZ_PROF=0
        self._stats_task = asyncio.ensure_future(self._stats_push_loop())
        log.info("nfs gateway on port %d", self.port)

    async def stop(self) -> None:
        for task in (self._gather_task, self._stats_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self.profiler.stop()
        if self._http_server is not None:
            self._http_server.close()
            try:
                await asyncio.wait_for(self._http_server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass
        try:
            await self._flush_all()
        except Exception:  # noqa: BLE001 — still stop cleanly
            log.exception("final gather flush failed")
        await self.rpc.stop()
        await self.client.close()

    # --- HTTP observability endpoint (/metrics, /healthz, /profile) ------

    def _stats_doc(self) -> dict:
        """The workload summary pushed to the master and served at
        /top: protocol-op mix (this gateway's SessionOps) + the logical
        data-op view the embedded Client accounts."""
        return {
            "role": "nfs",
            "endpoint": f"{self.rpc.host}:{self.port}",
            "http_port": self.http_port,
            "protocol": self.session_ops.top(8),
            "data": self.client.session_ops.top(8),
        }

    def _healthz_doc(self) -> dict:
        return {
            "role": "nfs",
            "status": self.slo.status() if slomod.enabled() else "ok",
            "slo": self.slo.snapshot() if slomod.enabled() else {},
            "slow_ops": len(self.slo.recorder.slowops()),
            "session": self.client.session_id,
            "mounts": len(self._mounts),
        }

    async def _http_conn(self, reader, writer) -> None:
        """Minimal one-shot HTTP/1.0-style server: GET /metrics (the
        Prometheus scrape surface the S3 gateway already has),
        /healthz (probe JSON), /profile (collapsed flamegraph stacks),
        /top (this gateway's per-session summary)."""
        import json as _json

        try:
            line = await retrymod.bounded_wait(reader.readline(), 10.0)
            try:
                method, target, _ = line.decode("ascii").split(" ", 2)
            except (UnicodeDecodeError, ValueError):
                return
            while True:  # drain headers
                hl = await retrymod.bounded_wait(reader.readline(), 10.0)
                if hl in (b"\r\n", b"\n", b""):
                    break
            path = target.split("?", 1)[0]
            code, ctype, body = 404, "text/plain", b"not found\n"
            if method == "GET" and path == "/metrics":
                code, ctype, body = (
                    200, "text/plain; version=0.0.4; charset=utf-8",
                    self.metrics.to_prometheus().encode(),
                )
            elif method == "GET" and path == "/healthz":
                code, ctype, body = (
                    200, "application/json",
                    _json.dumps(self._healthz_doc()).encode(),
                )
            elif method == "GET" and path == "/profile":
                doc = self.profiler.snapshot()
                doc["role"] = "nfs"  # process-wide sampler, this surface
                doc["collapsed"] = self.profiler.collapsed()
                code, ctype, body = (
                    200, "application/json", _json.dumps(doc).encode(),
                )
            elif method == "GET" and path == "/top":
                code, ctype, body = (
                    200, "application/json",
                    _json.dumps(self._stats_doc()).encode(),
                )
            writer.write(
                (
                    f"HTTP/1.1 {code} {'OK' if code == 200 else 'NF'}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode("latin-1") + body
            )
            await asyncio.wait_for(writer.drain(), 10.0)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.TimeoutError):
            pass
        finally:
            await retrymod.close_writer(writer, swallow_cancel=True)

    def _stats_push_loop(self):
        """The shared gateway push contract (CltomaSessionStats every
        few seconds — runtime/accounting.py owns the loop so the NFS
        and S3 gateways cannot drift apart on it)."""
        return accounting.gateway_stats_push_loop(
            self.client, self._stats_doc, self.stats_push_interval_s, log
        )

    # --- portmapper (RFC 1833 v2): just enough for clients probing us ----

    async def _portmap_dispatch(
        self, proc: int, cred: rpc.Credential, u: Unpacker
    ) -> bytes:
        if proc == 0:
            return b""
        if proc == 3:  # GETPORT
            prog, _vers = u.u32(), u.u32()
            port = self.port if prog in (PROG_NFS, PROG_MOUNT) else 0
            return Packer().u32(port).bytes()
        raise rpc.ProcUnavail

    # --- MOUNT3 ----------------------------------------------------------

    async def _mount_dispatch(
        self, proc: int, cred: rpc.Credential, u: Unpacker
    ) -> bytes:
        if proc == 0:  # NULL
            return b""
        if proc == 1:  # MNT
            path = u.string()
            target = self.exports.get(path) or self.exports.get(
                path.rstrip("/") or "/"
            )
            p = Packer()
            if target is None:
                return p.u32(NFS3ERR_NOENT).bytes()
            try:
                attr = await self.client.resolve(target)
            except st.StatusError as e:
                return p.u32(_nfs_code(e)).bytes()
            self._mounts.add((cred.machine, path))
            self._export_roots.add(attr.inode)
            p.u32(NFS3_OK).opaque(fh_pack(attr.inode))
            p.u32(1).u32(rpc.AUTH_SYS)  # auth flavors
            return p.bytes()
        if proc == 3:  # UMNT
            path = u.string()
            self._mounts.discard((cred.machine, path))
            return b""
        if proc == 4:  # UMNTALL
            self._mounts = {mt for mt in self._mounts if mt[0] != cred.machine}
            return b""
        if proc == 5:  # EXPORT
            p = Packer()
            for path in self.exports:
                p.boolean(True).string(path).boolean(False)  # no group list
            p.boolean(False)
            return p.bytes()
        raise rpc.ProcUnavail

    # --- NFS3 ------------------------------------------------------------

    async def _nfs_dispatch(
        self, proc: int, cred: rpc.Credential, u: Unpacker
    ) -> bytes:
        handler = self._PROCS.get(proc)
        if handler is None:
            raise rpc.ProcUnavail
        # trace boundary: the NFS proc is the request's root — the id
        # issued here rides every client->master RPC and data-plane
        # frame this op triggers (tracing.begin joins a caller-held
        # trace, which never exists on a fresh RPC task)
        tid, fresh = tracing.begin()
        name = "nfs_" + handler.__name__.removeprefix("_proc_")
        t0 = time.perf_counter()
        try:
            return await handler(self, cred, u)
        except _NfsError as e:
            return self._plain_error(proc, e.code)
        except st.StatusError as e:
            return self._plain_error(proc, _nfs_code(e))
        finally:
            t1 = time.perf_counter()
            dt = t1 - t0
            self.client.trace_ring.record(tid, name, t0, t1, role="nfs")
            self.slo.observe("nfs", dt, trace_id=tid, name=name)
            # per-session protocol accounting: the proc charged to this
            # gateway's cluster session, pushed to the master's `top`
            self.session_ops.record(
                self.client.session_id, name, dt, trace_id=tid
            )
            tracing.end(fresh)

    def _plain_error(self, proc: int, code: int) -> bytes:
        """Error reply with empty/absent optional attr fields, shaped per
        procedure class (most carry post_op_attr; dir-modifying ops carry
        wcc_data; RENAME/LINK carry two)."""
        p = Packer().u32(code)
        if proc in (7, 8, 9, 10, 11, 12, 13, 21):  # wcc_data
            _wcc_data(p, None)
        elif proc == 14:  # RENAME: two wcc_data
            _wcc_data(p, None)
            _wcc_data(p, None)
        elif proc == 15:  # LINK: post_op_attr + wcc_data
            p.boolean(False)
            _wcc_data(p, None)
        elif proc != 0:
            p.boolean(False)  # post_op_attr absent
        return p.bytes()

    def _meta_dirty(self, *inodes: int) -> None:
        """Drop cached attr/access decisions for inodes whose metadata
        a proc just mutated (setattr, create/remove in a parent, ...):
        the mutating reply's post-op attrs and any guarded follow-up
        must see post-mutation state, not a TTL-stale snapshot."""
        for inode in inodes:
            self._attr_cache.pop(inode, None)
            dropped = self._access_cache.pop(inode, None)
            if dropped:
                self._access_cache_n -= len(dropped)

    def _on_invalidate(self, inode: int) -> None:
        self._ra_drop(inode)
        self._meta_dirty(inode)

    async def _attr(self, inode: int) -> m.Attr:
        e = self._attr_cache.get(inode)
        if (
            e is not None
            and time.monotonic() - e[1] <= self.META_TTL_S
            # serve-time flag check: a snapshot cached BEFORE a
            # seteattr flagged the inode must stop being served now,
            # not at TTL expiry
            and not (
                self.client._eattr.get(inode, 0) & EATTR_NOENTRYCACHE
            )
        ):
            return e[0]
        attr = await self.client.getattr(inode)
        if attr.eattr & EATTR_NOENTRYCACHE:
            # the inode opted out of entry caching: serve fresh, keep
            # any stale cached snapshot from resurfacing
            self._attr_cache.pop(inode, None)
            return attr
        self._attr_cache[inode] = (attr, time.monotonic())
        if len(self._attr_cache) > 65536:
            self._attr_cache.clear()  # crude bound; refills on demand
        return attr

    async def _attr_opt(self, inode: int) -> m.Attr | None:
        try:
            return await self._attr(inode)
        except st.StatusError:
            return None

    async def _access(self, inode: int, cred, mask: int) -> bool:
        # entry-cache opt-out covers access decisions too. The flag
        # comes from the client's _eattr map (fed by every attr reply;
        # NFS procs fetch post-op attrs constantly, so it is hot for
        # any inode a client touches) — checked BEFORE serving so
        # decisions cached before a seteattr stop being served, and
        # any stale sub-cache is dropped on the spot
        if self.client._eattr.get(inode, 0) & EATTR_NOENTRYCACHE:
            dropped = self._access_cache.pop(inode, None)
            if dropped:
                self._access_cache_n -= len(dropped)
            return await self.client.access(
                inode, cred.uid, cred.all_gids, mask
            )
        sub = self._access_cache.get(inode)
        key = (cred.uid, tuple(cred.all_gids), mask)
        now = time.monotonic()
        if sub is not None:
            e = sub.get(key)
            if e is not None and now - e[1] <= self.META_TTL_S:
                return e[0]
        ok = await self.client.access(inode, cred.uid, cred.all_gids, mask)
        if sub is None:
            sub = self._access_cache.setdefault(inode, {})
        if key not in sub:
            self._access_cache_n += 1
        sub[key] = (ok, now)
        if self._access_cache_n > 65536:
            self._access_cache.clear()
            self._access_cache_n = 0
        return ok

    # Each proc_* returns the XDR result body (success or mapped error).

    async def _proc_null(self, cred, u) -> bytes:
        return b""

    async def _proc_getattr(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        await self._flush_inode(inode)  # size must reflect gathered writes
        try:
            attr = await self._attr(inode)
        except st.StatusError as e:
            return Packer().u32(_nfs_code(e)).bytes()
        p = Packer().u32(NFS3_OK)
        _pack_fattr3(p, attr)
        return p.bytes()

    async def _proc_setattr(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        # ordering: a truncate must not race gathered writes (and the
        # ctime guard below must see post-flush attrs)
        await self._flush_inode(inode)
        sattr = _Sattr3(u)
        if u.boolean():  # sattrguard3: compare-and-set on ctime
            guard_ctime = u.u32()
            u.u32()  # nsec (server ctimes are whole seconds)
            # guard reads bypass the TTL cache: compare-and-set against
            # a stale ctime would let a lost-update race through
            self._meta_dirty(inode)
            current = await self._attr(inode)
            if current.ctime != guard_ctime:
                p = Packer().u32(NFS3ERR_NOT_SYNC)
                _wcc_data(p, current)
                return p.bytes()
        if sattr.size is not None:
            await self.client.truncate(
                inode, sattr.size, uid=cred.uid, gids=cred.all_gids
            )
        mask, kw = sattr.set_mask()
        attr = None
        if mask:
            attr = await self.client.setattr(
                inode, mask, caller_uid=cred.uid,
                caller_gids=cred.all_gids, **kw,
            )
            self._meta_dirty(inode)  # mode/owner changed: access too
        else:
            attr = await self._attr_opt(inode)
        p = Packer().u32(NFS3_OK)
        _wcc_data(p, attr)
        return p.bytes()

    async def _proc_lookup(self, cred, u) -> bytes:
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        p = Packer()
        try:
            if name == "." or (name == ".." and parent in self._export_roots):
                # ".." clamps at the export root: no walking above a mount
                attr = await self._attr(parent)
            elif name == "..":
                # the master resolves ".." itself (session-root aware)
                attr = await self.client.lookup(
                    parent, "..", uid=cred.uid, gids=cred.all_gids
                )
            else:
                attr = await self.client.lookup(
                    parent, name, uid=cred.uid, gids=cred.all_gids
                )
        except st.StatusError as e:
            p.u32(_nfs_code(e))
            _post_op_attr(p, await self._attr_opt(parent))
            return p.bytes()
        p.u32(NFS3_OK).opaque(fh_pack(attr.inode))
        _post_op_attr(p, attr)
        _post_op_attr(p, await self._attr_opt(parent))
        return p.bytes()

    async def _proc_access(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        want = u.u32()
        attr = await self._attr(inode)
        granted = 0
        checks = (
            (ACCESS3_READ, 4),
            (ACCESS3_LOOKUP | ACCESS3_EXECUTE, 1),
            (ACCESS3_MODIFY | ACCESS3_EXTEND | ACCESS3_DELETE, 2),
        )
        for bits, mask in checks:
            if want & bits and await self._access(inode, cred, mask):
                granted |= want & bits
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, attr)
        p.u32(granted)
        return p.bytes()

    async def _proc_readlink(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        target = await self.client.readlink(inode)
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, await self._attr_opt(inode))
        p.string(target)
        return p.bytes()

    def _ra_drop(self, inode: int) -> None:
        """Invalidate-listener + local eviction: drop an inode's
        readahead span (runs synchronously on the loop thread, so it is
        ordered against _ra_read's store)."""
        e = self._ra.pop(inode, None)
        if e is not None:
            self._ra_total -= len(e[2])
        # epoch entries only matter to a reader mid-fetch (one holds
        # the inode's lock); bumping for never-read inodes would leak
        # one dict entry per written file forever
        if inode in self._ra_locks:
            self._ra_epoch[inode] = self._ra_epoch.get(inode, 0) + 1

    async def _ra_read(self, inode: int, offset: int, count: int) -> bytes:
        """READ through the per-inode readahead span: sequential
        streams fetch up to RA_WINDOW_MAX ahead in one back-end read
        and serve the following READs from memory; non-sequential
        offsets reset the window to zero and bypass buffering entirely
        (adviser semantics: client/cache.py ReadaheadAdviser)."""
        lock = self._ra_locks.get(inode)
        if lock is None:
            lock = self._ra_locks[inode] = asyncio.Lock()
        async with lock:
            adviser = self._ra_advisers.get(inode)
            if adviser is None:
                adviser = self._ra_advisers[inode] = ReadaheadAdviser(
                    max_window=self.RA_WINDOW_MAX
                )
            e = self._ra.get(inode)
            if e is not None:
                _adv, off, buf, ts = e
                if (
                    time.monotonic() - ts <= self.RA_TTL_S
                    and off <= offset
                    and offset + count <= off + len(buf)
                ):
                    adviser.advise(offset, count)  # keep the stream hot
                    lo = offset - off
                    return bytes(buf[lo: lo + count])
            extra = adviser.advise(offset, count)
            if extra:
                epoch = self._ra_epoch.get(inode, 0)
                data = await self.client.read_file(
                    inode, offset, count + extra
                )
                self._ra_drop(inode)
                if (len(data) > count
                        and self._ra_epoch.get(inode, 0) == epoch + 1):
                    # store only if no invalidation raced the fetch
                    # (the +1 is our own _ra_drop above) — mirroring
                    # the BlockCache's revoked-put refusal
                    self._ra[inode] = [
                        adviser, offset, bytes(data), time.monotonic()
                    ]
                    self._ra_total += len(data)
                    while self._ra_total > self.RA_TOTAL_BYTES and self._ra:
                        oldest = min(self._ra, key=lambda i: self._ra[i][3])
                        self._ra_drop(oldest)
                return bytes(data[:count])
        # non-sequential miss: nothing to buffer — read OUTSIDE the
        # lock so random READs of one file keep their pipeline
        # concurrency instead of serializing on the adviser
        data = await self.client.read_file(inode, offset, count)
        return bytes(data[:count])

    async def _proc_read(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        offset, count = u.u64(), u.u32()
        count = min(count, 1 << 20)
        await self._flush_inode(inode)  # read-your-own-UNSTABLE-writes
        attr = await self._attr(inode)
        if attr.ftype == m.FTYPE_DIR:
            raise _NfsError(NFS3ERR_ISDIR)
        if not await self._access(inode, cred, 4):
            raise _NfsError(NFS3ERR_ACCES)
        data = await self._ra_read(inode, offset, count)
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, attr)
        p.u32(len(data))
        p.boolean(offset + len(data) >= attr.length)  # eof
        p.opaque(data)
        return p.bytes()

    async def _proc_write(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        offset, count = u.u64(), u.u32()
        stable = u.u32()  # 0 UNSTABLE, 1 DATA_SYNC, 2 FILE_SYNC
        data = u.opaque(1 << 22)[:count]
        if not await self._access(inode, cred, 2):
            raise _NfsError(NFS3ERR_ACCES)
        if stable == 0:
            # write gathering: buffer UNSTABLE writes and flush them as
            # few large pwrites (sequential 64 KiB wire ops would each
            # pay a full striped read-modify-write otherwise); COMMIT /
            # stable writes / dependent ops / the idle sweep flush
            e = self._lock_entry(inode)
            e[1] += 1
            try:
                async with e[0]:
                    g = self._gather.get(inode)
                    if g is None:
                        g = self._gather[inode] = _WriteGather()
                    if not g.try_add(offset, data):
                        # overlap (retransmit/random rewrite): flush,
                        # then start a fresh gather with this write
                        await self._flush_locked(inode)
                        g = self._gather[inode] = _WriteGather()
                        g.try_add(offset, data)
                    self._gather_total += len(data)
                    if g.nbytes >= self.GATHER_FLUSH_BYTES:
                        await self._flush_locked(inode)
            finally:
                e[1] -= 1
                if e[1] == 0 and self._gather_locks.get(inode) is e:
                    del self._gather_locks[inode]
            # gateway-wide memory cap: flush the LARGEST gathers (not
            # this possibly-tiny one) until under budget — done outside
            # this inode's lock to keep lock acquisition one-at-a-time
            while self._gather_total >= self.GATHER_TOTAL_BYTES:
                biggest = max(
                    self._gather, key=lambda i: self._gather[i].nbytes,
                    default=None,
                )
                if biggest is None:
                    break
                await self._flush_inode(biggest)
            attr = await self._attr_opt(inode)
            if attr is not None and inode in self._gather:
                # advisory post-attr: reflect the buffered tail so the
                # client's size view stays monotonic pre-flush
                attr.length = max(attr.length, self._gather[inode].end)
            p = Packer().u32(NFS3_OK)
            _wcc_data(p, attr)
            p.u32(len(data))
            p.u32(0)  # committed = UNSTABLE: client must COMMIT
            p.fixed(self.write_verf)
            return p.bytes()
        await self._flush_inode(inode)  # ordering vs earlier UNSTABLE
        await self.client.pwrite(inode, offset, data)
        p = Packer().u32(NFS3_OK)
        _wcc_data(p, await self._attr_opt(inode))
        p.u32(len(data))
        p.u32(2)  # committed = FILE_SYNC
        p.fixed(self.write_verf)
        return p.bytes()

    async def _proc_create(self, cred, u) -> bytes:
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        how = u.u32()  # 0 UNCHECKED, 1 GUARDED, 2 EXCLUSIVE
        verf = None
        if how in (0, 1):
            sattr = _Sattr3(u)
            mode = sattr.mode if sattr.mode is not None else 0o644
        else:
            # EXCLUSIVE: stash the verifier in atime/mtime (RFC 1813
            # §3.3.8) so a retransmitted create is recognized as ours
            verf = struct.unpack(">II", u.fixed(8))
            mode = 0o644
        try:
            attr = await self.client.create(
                parent, name, mode=mode, uid=cred.uid, gid=cred.gid
            )
            if verf is not None:
                attr = await self.client.setattr(
                    attr.inode, 8 | 16, atime=verf[0], mtime=verf[1],
                    caller_uid=cred.uid, caller_gids=cred.all_gids,
                )
        except st.StatusError as e:
            retryable = False
            if e.code == st.EEXIST and how != 1:
                attr = await self.client.lookup(
                    parent, name, uid=cred.uid, gids=cred.all_gids
                )
                retryable = (
                    how == 0
                    or (attr.atime, attr.mtime) == verf  # our retransmit
                )
            if not retryable:
                p = Packer().u32(_nfs_code(e))
                _wcc_data(p, await self._attr_opt(parent))
                return p.bytes()
        self._meta_dirty(parent)
        p = Packer().u32(NFS3_OK)
        p.boolean(True).opaque(fh_pack(attr.inode))
        _post_op_attr(p, attr)
        _wcc_data(p, await self._attr_opt(parent))
        return p.bytes()

    async def _proc_mkdir(self, cred, u) -> bytes:
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        sattr = _Sattr3(u)
        mode = sattr.mode if sattr.mode is not None else 0o755
        try:
            attr = await self.client.mkdir(
                parent, name, mode=mode, uid=cred.uid, gid=cred.gid
            )
        except st.StatusError as e:
            p = Packer().u32(_nfs_code(e))
            _wcc_data(p, await self._attr_opt(parent))
            return p.bytes()
        self._meta_dirty(parent)
        p = Packer().u32(NFS3_OK)
        p.boolean(True).opaque(fh_pack(attr.inode))
        _post_op_attr(p, attr)
        _wcc_data(p, await self._attr_opt(parent))
        return p.bytes()

    async def _proc_symlink(self, cred, u) -> bytes:
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        _Sattr3(u)  # symlink attrs: mode is fixed 0777
        target = u.string(4096)
        attr = await self.client.symlink(
            parent, name, target, uid=cred.uid, gid=cred.gid
        )
        self._meta_dirty(parent)
        p = Packer().u32(NFS3_OK)
        p.boolean(True).opaque(fh_pack(attr.inode))
        _post_op_attr(p, attr)
        _wcc_data(p, await self._attr_opt(parent))
        return p.bytes()

    async def _proc_mknod(self, cred, u) -> bytes:
        raise _NfsError(NFS3ERR_NOTSUPP)

    async def _proc_remove(self, cred, u) -> bytes:
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        # flush the victim's gathered writes first: local-fs unlink
        # ordering (data lands, THEN the name goes — the client's
        # sillyrename pattern for unlink-while-open depends on it)
        try:
            victim = await self.client.lookup(
                parent, name, uid=cred.uid, gids=cred.all_gids
            )
            await self._flush_inode(victim.inode)
        except st.StatusError:
            pass
        await self.client.unlink(parent, name, uid=cred.uid, gids=cred.all_gids)
        self._meta_dirty(parent)
        p = Packer().u32(NFS3_OK)
        _wcc_data(p, await self._attr_opt(parent))
        return p.bytes()

    async def _proc_rmdir(self, cred, u) -> bytes:
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        await self.client.rmdir(parent, name, uid=cred.uid, gids=cred.all_gids)
        self._meta_dirty(parent)
        p = Packer().u32(NFS3_OK)
        _wcc_data(p, await self._attr_opt(parent))
        return p.bytes()

    async def _proc_rename(self, cred, u) -> bytes:
        psrc = fh_unpack(u.opaque(64))
        nsrc = u.string(255)
        pdst = fh_unpack(u.opaque(64))
        ndst = u.string(255)
        await self.client.rename(
            psrc, nsrc, pdst, ndst, uid=cred.uid, gids=cred.all_gids
        )
        self._meta_dirty(psrc, pdst)
        p = Packer().u32(NFS3_OK)
        _wcc_data(p, await self._attr_opt(psrc))
        _wcc_data(p, await self._attr_opt(pdst))
        return p.bytes()

    async def _proc_link(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        parent = fh_unpack(u.opaque(64))
        name = u.string(255)
        attr = await self.client.link(
            inode, parent, name, uid=cred.uid, gids=cred.all_gids
        )
        self._meta_dirty(parent, inode)  # nlink changed on the target
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, attr)
        _wcc_data(p, await self._attr_opt(parent))
        return p.bytes()

    async def _readdir_common(self, cred, u, plus: bool) -> bytes:
        inode = fh_unpack(u.opaque(64))
        cookie = u.u64()
        client_verf = u.fixed(8)
        if plus:
            u.u32()  # dircount
        maxcount = min(u.u32(), 1 << 20)
        entries = await self.client.readdir(
            inode, uid=cred.uid, gids=cred.all_gids
        )
        dir_attr = await self._attr_opt(inode)
        if inode in self._export_roots:
            dotdot: tuple[int, m.Attr | None] = (inode, dir_attr)
        else:
            try:
                parent = await self.client.lookup(
                    inode, "..", uid=cred.uid, gids=cred.all_gids
                )
                dotdot = (parent.inode, parent)
            except st.StatusError:
                dotdot = (inode, dir_attr)
        listing: list[tuple[str, int, m.Attr | None]] = [
            (".", inode, dir_attr),
            ("..", *dotdot),
        ]
        for e in sorted(entries, key=lambda e: e.name):
            listing.append((e.name, e.inode, None))
        # cookieverf = digest of the listing: cookies are positions in
        # this snapshot, so a changed directory invalidates them
        # (RFC 1813 BAD_COOKIE) instead of silently skipping entries
        h = hashlib.blake2b(digest_size=8)
        for name, ino, _ in listing:
            h.update(name.encode("utf-8", "surrogateescape"))
            h.update(struct.pack(">I", ino))
        verf = h.digest()
        start = int(cookie)
        if start and client_verf != verf:
            raise _NfsError(NFS3ERR_BAD_COOKIE)
        if plus and start < len(listing):
            # batch the per-entry attrs this window could need (bounded
            # by what maxcount can fit: >= 44 bytes/entry on the wire)
            window = listing[start : start + max(maxcount // 44, 1)]
            fetched = await asyncio.gather(
                *(self._attr_opt(ino) for _, ino, attr in window
                  if attr is None)
            )
            it = iter(fetched)
            listing[start : start + len(window)] = [
                (name, ino, attr if attr is not None else next(it))
                for name, ino, attr in window
            ]
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, dir_attr)
        p.fixed(verf)  # cookieverf
        body = Packer()
        used, i, budget = 0, start, maxcount - 64
        while i < len(listing):
            name, ino, attr = listing[i]
            e = Packer()
            e.boolean(True).u64(ino).string(name).u64(i + 1)
            if plus:
                _post_op_attr(e, attr)
                e.boolean(True).opaque(fh_pack(ino))
            chunk = e.bytes()
            if used + len(chunk) > budget:
                break  # window full; zero progress -> TOOSMALL below
            used += len(chunk)
            body.raw(chunk)
            i += 1
        if i == start and start < len(listing):
            raise _NfsError(NFS3ERR_TOOSMALL)
        body.boolean(False)  # no more entries in this reply
        body.boolean(i >= len(listing))  # eof
        p.raw(body.bytes())
        return p.bytes()

    async def _proc_readdir(self, cred, u) -> bytes:
        return await self._readdir_common(cred, u, plus=False)

    async def _proc_readdirplus(self, cred, u) -> bytes:
        return await self._readdir_common(cred, u, plus=True)

    async def _proc_fsstat(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        total, avail = await self.client.statfs()
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, await self._attr_opt(inode))
        p.u64(total).u64(avail).u64(avail)
        p.u64(1 << 31).u64(1 << 31).u64(1 << 31)  # file slots: unbounded
        p.u32(0)  # invarsec
        return p.bytes()

    async def _proc_fsinfo(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, await self._attr_opt(inode))
        p.u32(1 << 20).u32(1 << 20).u32(MFSBLOCKSIZE)  # rtmax/rtpref/rtmult
        p.u32(1 << 20).u32(1 << 20).u32(MFSBLOCKSIZE)  # wtmax/wtpref/wtmult
        p.u32(1 << 16)  # dtpref
        p.u64((1 << 63) - 1)  # maxfilesize
        p.u32(0).u32(1)  # time_delta
        p.u32(0x1 | 0x2 | 0x8 | 0x10)  # LINK|SYMLINK|HOMOGENEOUS|CANSETTIME
        return p.bytes()

    async def _proc_pathconf(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        p = Packer().u32(NFS3_OK)
        _post_op_attr(p, await self._attr_opt(inode))
        p.u32(65535)  # linkmax
        p.u32(255)  # name_max
        p.boolean(True)  # no_trunc
        p.boolean(True)  # chown_restricted
        p.boolean(False)  # case_insensitive
        p.boolean(True)  # case_preserving
        return p.bytes()

    async def _proc_commit(self, cred, u) -> bytes:
        inode = fh_unpack(u.opaque(64))
        u.u64()
        u.u32()  # offset, count: flushing the whole inode covers any range
        await self._flush_inode(inode)
        p = Packer().u32(NFS3_OK)
        _wcc_data(p, await self._attr_opt(inode))
        p.fixed(self.write_verf)
        return p.bytes()

    _PROCS = {
        0: _proc_null,
        1: _proc_getattr,
        2: _proc_setattr,
        3: _proc_lookup,
        4: _proc_access,
        5: _proc_readlink,
        6: _proc_read,
        7: _proc_write,
        8: _proc_create,
        9: _proc_mkdir,
        10: _proc_symlink,
        11: _proc_mknod,
        12: _proc_remove,
        13: _proc_rmdir,
        14: _proc_rename,
        15: _proc_link,
        16: _proc_readdir,
        17: _proc_readdirplus,
        18: _proc_fsstat,
        19: _proc_fsinfo,
        20: _proc_pathconf,
        21: _proc_commit,
    }


async def main(argv: list[str] | None = None) -> None:
    """``python -m lizardfs_tpu_torch.nfs.server HOST:PORT [--port N]``"""
    import argparse

    ap = argparse.ArgumentParser(description="LizardFS-TPU NFSv3 gateway")
    ap.add_argument("master", help="master HOST:PORT")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=2049)
    ap.add_argument("--export", action="append", default=None,
                    help="EXPORT=CLUSTERPATH (repeatable; default /=/)")
    ap.add_argument("--http-port", type=int, default=0,
                    help="observability endpoint (/metrics /healthz "
                         "/profile /top); 0 = ephemeral, -1 = disabled")
    args = ap.parse_args(argv)
    mhost, mport = args.master.rsplit(":", 1)
    exports = {"/": "/"}
    if args.export:
        exports = dict(e.split("=", 1) for e in args.export)
    gw = NfsGateway(mhost, int(mport), host=args.host, port=args.port,
                    exports=exports)
    gw.http_port = None if args.http_port < 0 else args.http_port
    await gw.start()
    try:
        # lint: waive(unbounded-await): the gateway process parks here until killed by design
        await asyncio.Event().wait()
    finally:
        await gw.stop()


if __name__ == "__main__":
    asyncio.run(main())
