"""ONC-RPC v2 (RFC 5531) over TCP with record marking, on asyncio.

Carries the MOUNT3/NFS3 programs of the gateway. The server side is a
program registry: ``(prog, vers) -> async handler(proc, cred, Unpacker)
-> bytes``. AUTH_SYS (flavor 1) credentials are parsed into
:class:`Credential` and become the per-call identity the NFS layer
forwards to the cluster client — same role as Ganesha's op_ctx creds in
the reference FSAL (src/nfs-ganesha/handle.c uses op_ctx->creds for
every op).
"""

from __future__ import annotations

import asyncio
import logging
import struct
from dataclasses import dataclass, field

from lizardfs_tpu_torch.nfs.xdr import Packer, Unpacker, XdrError
from lizardfs_tpu_torch.runtime.retry import bounded_wait, close_writer, \
    spawn_detached

log = logging.getLogger("lizardfs.nfs.rpc")

RPC_VERSION = 2
CALL, REPLY = 0, 1
MSG_ACCEPTED, MSG_DENIED = 0, 1
# accept_stat
SUCCESS, PROG_UNAVAIL, PROG_MISMATCH, PROC_UNAVAIL, GARBAGE_ARGS, SYSTEM_ERR = (
    0, 1, 2, 3, 4, 5,
)
# auth flavors
AUTH_NONE, AUTH_SYS = 0, 1

MAX_RECORD = 1 << 22  # 4 MiB: caps rsize/wsize plus headroom


@dataclass
class Credential:
    uid: int = 0
    gid: int = 0
    gids: list[int] = field(default_factory=list)
    machine: str = ""

    @property
    def all_gids(self) -> list[int]:
        out = [self.gid] + [g for g in self.gids if g != self.gid]
        return out


def parse_auth_sys(body: bytes) -> Credential:
    u = Unpacker(body)
    u.u32()  # stamp
    machine = u.string(255)
    uid = u.u32()
    gid = u.u32()
    n = u.u32()
    if n > 16:
        raise XdrError(f"too many aux gids: {n}")
    gids = [u.u32() for _ in range(n)]
    return Credential(uid=uid, gid=gid, gids=gids, machine=machine)


async def read_record(reader: asyncio.StreamReader) -> bytes:
    """One RPC record: fragments with a last-fragment marker bit.

    Reads are ambient-deadline-bounded (``bounded_wait`` with no cap):
    the gateway's server loop parks on the next request by design (no
    ambient budget), and the client pump runs detached (deadline-free
    — its budget lives on each ``call()``'s bounded reply wait)."""
    chunks: list[bytes] = []
    total = 0
    while True:
        hdr = await bounded_wait(reader.readexactly(4))
        (word,) = struct.unpack(">I", hdr)
        last, flen = bool(word & 0x80000000), word & 0x7FFFFFFF
        total += flen
        if total > MAX_RECORD:
            raise XdrError(f"RPC record too long: {total}")
        chunks.append(await bounded_wait(reader.readexactly(flen)))
        if last:
            return b"".join(chunks)


def frame_record(payload: bytes) -> bytes:
    return struct.pack(">I", 0x80000000 | len(payload)) + payload


def _reply_header(xid: int) -> Packer:
    p = Packer()
    p.u32(xid).u32(REPLY).u32(MSG_ACCEPTED)
    p.u32(AUTH_NONE).u32(0)  # verifier
    return p


def accepted_reply(xid: int, result: bytes) -> bytes:
    return _reply_header(xid).u32(SUCCESS).raw(result).bytes()


def error_reply(xid: int, accept_stat: int) -> bytes:
    return _reply_header(xid).u32(accept_stat).bytes()


class RpcServer:
    """TCP ONC-RPC server dispatching to registered program handlers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self.host, self.port = host, port
        self._programs: dict[tuple[int, int], object] = {}
        self._server: asyncio.AbstractServer | None = None

    def register(self, prog: int, vers: int, handler) -> None:
        """handler: async (proc: int, cred: Credential, args: Unpacker) -> bytes.
        Raise ProcUnavail to signal an unknown procedure."""
        self._programs[(prog, vers)] = handler

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                # 3.12+ wait_closed also waits for live handlers; a
                # client parked in read_record must not wedge (or, past
                # the cap, crash) gateway teardown
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass
            self._server = None

    async def _serve_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        """NFS clients multiplex many outstanding ops on one TCP
        connection; dispatch each record as its own task (replies may
        reorder — xids pair them) and serialize only the writes."""
        peer = writer.get_extra_info("peername")
        wlock = asyncio.Lock()
        inflight: set[asyncio.Task] = set()

        async def run_one(record: bytes) -> None:
            try:
                reply = await self._dispatch(record)
                if reply is None:
                    return
                async with wlock:
                    writer.write(frame_record(reply))
                    # ambient-bounded: gateway ops run under the
                    # cluster client's deadlines; a reply to a wedged
                    # NFS client charges that budget, not forever
                    await bounded_wait(writer.drain())
            except (ConnectionError, OSError):
                pass  # peer went away mid-reply
            except XdrError as e:
                log.warning("nfs rpc: bad record from %s: %s", peer, e)

        try:
            while True:
                try:
                    record = await read_record(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    return
                task = asyncio.ensure_future(run_one(record))
                inflight.add(task)
                task.add_done_callback(inflight.discard)
                if len(inflight) >= 64:  # backpressure: stop reading
                    # lint: waive(unbounded-await): parks on our OWN dispatch tasks, each bounded by the cluster client's op deadlines — a cap here would drop records instead of applying backpressure
                    _, pending = await asyncio.wait(
                        inflight, return_when=asyncio.FIRST_COMPLETED
                    )
        except XdrError as e:
            log.warning("nfs rpc: dropping %s: %s", peer, e)
        except Exception:
            log.exception("nfs rpc: connection error from %s", peer)
        finally:
            for t in inflight:
                t.cancel()
            await close_writer(writer)

    async def _dispatch(self, record: bytes) -> bytes | None:
        u = Unpacker(record)
        xid = u.u32()
        if u.u32() != CALL:
            return None  # ignore stray replies
        if u.u32() != RPC_VERSION:
            # RPC_MISMATCH denial
            p = Packer()
            p.u32(xid).u32(REPLY).u32(MSG_DENIED).u32(0).u32(2).u32(2)
            return p.bytes()
        prog, vers, proc = u.u32(), u.u32(), u.u32()
        cred_flavor = u.u32()
        cred_body = u.opaque(400)
        u.u32()  # verf flavor
        u.opaque(400)  # verf body
        if cred_flavor == AUTH_SYS:
            cred = parse_auth_sys(cred_body)
        else:
            # no credential != root: anonymous callers run as nobody
            cred = Credential(uid=65534, gid=65534)
        handler = self._programs.get((prog, vers))
        if handler is None:
            return error_reply(xid, PROG_UNAVAIL)
        try:
            result = await handler(proc, cred, u)
        except ProcUnavail:
            return error_reply(xid, PROC_UNAVAIL)
        except XdrError:
            return error_reply(xid, GARBAGE_ARGS)
        except Exception:
            log.exception("nfs rpc: handler error prog=%d proc=%d", prog, proc)
            return error_reply(xid, SYSTEM_ERR)
        return accepted_reply(xid, result)


class ProcUnavail(Exception):
    pass


class RpcClient:
    """Minimal ONC-RPC TCP client (tests + in-repo tooling)."""

    def __init__(self, host: str, port: int, cred: Credential | None = None):
        self.host, self.port = host, port
        self.cred = cred or Credential()
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._xid = 1
        # xid-demuxed reply pump: real kernel clients keep MANY calls
        # outstanding on one connection (wsize/rsize deep pipelines);
        # serial request/response here would make every benchmark and
        # multi-gateway drive understate the gateway by the RTT count
        self._pending: dict[int, asyncio.Future] = {}
        self._pump_task: asyncio.Task | None = None
        self._pump_dead = False
        # serialize write+drain: concurrent drain() waiters crash on
        # Python < 3.12 (FlowControlMixin asserts a single waiter)
        self._send_lock: asyncio.Lock | None = None

    async def connect(self) -> None:
        # dial bound like every other dial in the tree (gateway startup
        # additionally retries under a 30 s RetryPolicy budget)
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), 5.0
        )
        self._pump_dead = False
        self._send_lock = asyncio.Lock()
        # detached: the pump outlives any RetryPolicy attempt that
        # dialed this connection — read_record is ambient-deadline-
        # bounded now, and a pump that inherited the attempt's budget
        # would start timing out the moment the budget expired
        self._pump_task = spawn_detached(self._pump())

    async def _pump(self) -> None:
        try:
            while True:
                record = await read_record(self._reader)
                u = Unpacker(record)
                rxid = u.u32()
                fut = self._pending.pop(rxid, None)
                if fut is not None and not fut.done():
                    fut.set_result(u)
        except (asyncio.CancelledError, Exception) as e:  # noqa: BLE001
            # flag FIRST: a call() registering after this cleanup must
            # fail fast instead of awaiting a future nobody will resolve
            self._pump_dead = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError(f"rpc link lost: {e!r}"))
            self._pending.clear()
            if isinstance(e, asyncio.CancelledError):
                raise

    async def close(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except (asyncio.CancelledError, ConnectionError):
                pass
            self._pump_task = None
        if self._writer is not None:
            await close_writer(self._writer)
            self._writer = None

    def _cred_bytes(self) -> bytes:
        c = Packer()
        c.u32(0).string(self.cred.machine or "pyclient")
        c.u32(self.cred.uid).u32(self.cred.gid)
        c.u32(len(self.cred.gids))
        for g in self.cred.gids:
            c.u32(g)
        return c.bytes()

    async def call(self, prog: int, vers: int, proc: int, args: bytes) -> Unpacker:
        assert self._writer is not None, "not connected"
        if self._pump_dead:
            raise ConnectionError("rpc link lost")
        self._xid += 1
        xid = self._xid
        fut = asyncio.get_running_loop().create_future()
        self._pending[xid] = fut
        p = Packer()
        p.u32(xid).u32(CALL).u32(RPC_VERSION)
        p.u32(prog).u32(vers).u32(proc)
        p.u32(AUTH_SYS).opaque(self._cred_bytes())
        p.u32(AUTH_NONE).u32(0)
        p.raw(args)
        try:
            async with self._send_lock:
                self._writer.write(frame_record(p.bytes()))
                await bounded_wait(self._writer.drain())
            # bounded reply wait: the pump is detached (deadline-free
            # by design), so the budget must live HERE — a gateway
            # that consumes the request and never answers charges the
            # caller min(ambient deadline, 30 s), not forever
            u = await bounded_wait(fut, 30.0)
        finally:
            self._pending.pop(xid, None)
        if u.u32() != REPLY:
            raise XdrError("bad RPC reply header")
        if u.u32() != MSG_ACCEPTED:
            raise XdrError("RPC call denied")
        u.u32()
        u.opaque(400)  # verifier
        stat = u.u32()
        if stat != SUCCESS:
            raise XdrError(f"RPC accept_stat {stat}")
        return u
