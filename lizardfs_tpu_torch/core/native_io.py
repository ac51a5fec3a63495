"""Native bulk-IO bindings: whole data-plane exchanges in C++.

The asyncio stack stays in charge of control flow, plans, and retries;
when a read or write moves enough bytes, the piece loop (framing, CRC,
scatter) runs in ``native/io_native.cpp`` over a blocking socket from a
worker thread, with the GIL released. This is the native runtime layer
for the data path — the Python per-piece path remains as the portable
fallback and handles small requests where thread hop latency would
dominate.
"""

from __future__ import annotations

import asyncio
import ctypes
import functools
import os
import socket
import struct
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lizardfs_tpu_torch.core import native as _native_lib
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import accounting, tracing

# exchanges smaller than this stay on the asyncio path
NATIVE_READ_THRESHOLD = 128 * 1024
NATIVE_WRITE_THRESHOLD = 128 * 1024

_lib = _native_lib._load()
if _lib is not None:
    try:
        _lib.lz_read_part.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib.lz_read_part.restype = ctypes.c_int
        _lib.lz_read_part_bulk.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib.lz_read_part_bulk.restype = ctypes.c_int
        _lib.lz_write_part.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ]
        _lib.lz_write_part.restype = ctypes.c_int
        _lib.lz_write_part_bulk.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ]
        _lib.lz_write_part_bulk.restype = ctypes.c_int
        _lib.lz_load_read.argtypes = [
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib.lz_load_read.restype = ctypes.c_int
        _lib.lz_stream_read.argtypes = [
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
        ]
        _lib.lz_stream_read.restype = ctypes.c_int
        try:
            _lib.lz_read_parts_gather.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_uint32,
            ]
            _lib.lz_read_parts_gather.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: the whole-stripe fast path stays off
        try:
            _lib.lz_write_parts_scatter.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64, ctypes.c_uint32,
            ]
            _lib.lz_write_parts_scatter.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: multi-part write fast path stays off
        try:
            _lib.lz_trace_set.argtypes = [ctypes.c_uint64]
            _lib.lz_trace_set.restype = None
        except AttributeError:
            pass  # stale .so: native requests stay untraced
        try:
            _lib.lz_session_set.argtypes = [ctypes.c_uint64]
            _lib.lz_session_set.restype = None
        except AttributeError:
            pass  # stale .so: native requests stay session-less
        try:
            _lib.lz_write_parts_scatterv.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ]
            _lib.lz_write_parts_scatterv.restype = ctypes.c_int
            _lib.lz_write_collect_acks.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ]
            _lib.lz_write_collect_acks.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: the windowed/vectored write path stays off
        try:
            _lib.lz_shm_write_descs.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
            ]
            _lib.lz_shm_write_descs.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: the shm-ring send path stays off
    except AttributeError:
        _lib = None


def available() -> bool:
    return _lib is not None


class NativeIOError(Exception):
    def __init__(self, code: int, what: str):
        self.code = code
        names = {-1: "socket error", -2: "protocol violation", -3: "CRC mismatch"}
        msg = names.get(code, f"status {st.name(code) if code > 0 else code}")
        super().__init__(f"native {what}: {msg}")


class _SocketPool:
    """Thread-safe pool of blocking sockets keyed by address."""

    def __init__(self, max_idle: int = 4):
        self.max_idle = max_idle
        self._lock = threading.Lock()
        self._idle: dict[tuple[str, int], list[socket.socket]] = {}

    def acquire(self, addr: tuple[str, int]) -> socket.socket:
        with self._lock:
            bucket = self._idle.get(addr)
            if bucket:
                return bucket.pop()
        return _blocking_socket(addr, 30.0)

    def try_acquire(self, addr: tuple[str, int]):
        """Pop an idle socket or return None — never dials."""
        with self._lock:
            bucket = self._idle.get(addr)
            if bucket:
                return bucket.pop()
        return None

    def release(self, addr: tuple[str, int], sock: socket.socket) -> None:
        with self._lock:
            bucket = self._idle.setdefault(addr, [])
            if len(bucket) < self.max_idle:
                bucket.append(sock)
                return
        shm_ring_drop(sock)
        sock.close()

    def discard(self, sock: socket.socket) -> None:
        shm_ring_drop(sock)
        sock.close()


# --- same-host shared-memory part rings (native/shm_ring.h) ----------------
#
# One memfd payload segment per data-plane connection, negotiated over
# the abstract-UDS fast path via a CltocsShmInit frame carrying the fd
# as SCM_RIGHTS (the SO_PEERCRED gate already vetted the peer).  After
# the handshake, encoded parts land straight in the mapped arena and
# "sending" a part is one tiny CltocsShmWritePart descriptor frame —
# the per-byte socket copy is gone.  The CLIENT owns allocation: a
# classic FIFO ring (regions freed in ack-collection order), so the
# server only ever reads ranges named by descriptors.
#
# Rings ride the pooled socket they were negotiated on (keyed weakly by
# the socket object), so back-to-back chunk writes reuse one segment
# instead of re-negotiating per chunk.  LZ_SHM_RING=0 kills the whole
# path; LZ_SHM_RING_MB sizes segments (default 16).

SHM_MEMFD_NAME = "lzshm"  # grep-able in /proc/<pid>/maps (leak tests)


def shm_ring_enabled() -> bool:
    from lizardfs_tpu_torch.constants import env_flag

    return env_flag("LZ_SHM_RING")


def uds_disabled() -> bool:
    """LZ_NO_UDS operational kill switch for the same-host UDS fast
    path (default: UDS stays on). Four-spelling parity like every
    other switch — LZ_NO_UDS=0/off/false/no means "not disabled"; the
    old bare-truthiness read treated ``0`` as set-and-therefore-kill
    (spelling-parity inversion, now linted away). wire.h uds_enabled()
    mirrors these spellings C-side."""
    from lizardfs_tpu_torch.constants import env_flag

    return env_flag("LZ_NO_UDS", default=False)


def shm_seg_bytes() -> int:
    from lizardfs_tpu_torch.constants import MFSBLOCKSIZE

    try:
        mb = float(os.environ.get("LZ_SHM_RING_MB", "16"))
    except ValueError:
        mb = 16.0
    nbytes = int(mb * 2**20)
    nbytes = max(MFSBLOCKSIZE, min(nbytes, 1 << 30))
    return (nbytes // MFSBLOCKSIZE) * MFSBLOCKSIZE


def parts_shm_available() -> bool:
    """Shm-ring descriptor sends: the windowed path's copy-free rung."""
    return (
        _lib is not None
        and hasattr(_lib, "lz_shm_write_descs")
        and hasattr(_lib, "lz_write_collect_acks")
        and hasattr(os, "memfd_create")
    )


class ShmRing:
    """Client side of one connection's memfd payload ring.

    A FIFO bump allocator over a raw arena: :meth:`alloc` hands out
    contiguous regions (wrapping past the end wastes the tail, charged
    to the allocation that wrapped), :meth:`free` returns the oldest
    allocation's cost.  Correct because frees happen strictly in alloc
    order — acks are FIFO per connection and the windowed client
    collects segments oldest-first."""

    def __init__(self, size: int):
        import mmap as _mmap

        self.size = size
        self.memfd = os.memfd_create(SHM_MEMFD_NAME, 0)
        try:
            os.ftruncate(self.memfd, size)
            self.mm = _mmap.mmap(self.memfd, size)
        except BaseException:
            os.close(self.memfd)
            raise
        try:
            # forked children (the master's image-dump fork being the
            # in-process-cluster case) have no use for the arena, and
            # copying PTEs for every touched ring page would tax every
            # fork the process makes — exclude the mapping outright
            self.mm.madvise(_mmap.MADV_DONTFORK)
        except (AttributeError, OSError):
            pass  # pre-3.8 mmap or exotic kernel: fork just pays PTEs
        self.arr = np.frombuffer(self.mm, dtype=np.uint8)
        self._head = 0
        self._used = 0
        self._closed = False

    def alloc(self, nbytes: int):
        """-> (offset, cost) or None when the ring cannot fit it."""
        if nbytes <= 0 or nbytes > self.size:
            return None
        pad = 0
        if self._head + nbytes > self.size:
            pad = self.size - self._head  # wasted tail, freed with us
        if self._used + pad + nbytes > self.size:
            return None
        off = 0 if pad else self._head
        self._head = (off + nbytes) % self.size
        self._used += pad + nbytes
        return off, pad + nbytes

    def free(self, cost: int) -> None:
        self._used -= cost

    def unalloc(self, off: int, cost: int, nbytes: int) -> None:
        """LIFO undo of the NEWEST allocation (staging rollback).

        ``free`` retires the OLDEST allocation — using it to roll back
        the newest would advance the implied tail instead of retracting
        the head, leaving a hole the accounting no longer covers, and a
        later alloc could hand out a region overlapping a sent-but-
        unacked segment's live bytes.  Undo restores the exact
        pre-alloc head: ``cost - nbytes`` is the wrap pad the
        allocation charged, so the head it advanced from is
        ``off - pad`` (mod size)."""
        self._head = (off - (cost - nbytes)) % self.size
        self._used -= cost

    def view(self, off: int, nbytes: int) -> np.ndarray:
        return self.arr[off : off + nbytes]

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.arr = None
        try:
            self.mm.close()
        except BufferError:
            # a caller still holds an arena view; the mapping is freed
            # when the last view dies (the memfd below is closed now, so
            # nothing else can map it)
            pass
        try:
            os.close(self.memfd)
        except OSError:
            pass

    def __del__(self):  # noqa: D105 — last-resort fd hygiene
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


# ring negotiated on a socket, surviving pool round trips (a pooled
# connection keeps its server-side mapping, so the next session skips
# the handshake); entries die with the socket object
_SOCK_RINGS: "weakref.WeakKeyDictionary[socket.socket, ShmRing]" = (
    weakref.WeakKeyDictionary()
)


def shm_ring_of(sock: socket.socket) -> "ShmRing | None":
    return _SOCK_RINGS.get(sock)


def shm_ring_drop(sock) -> None:
    """Release a socket's ring (called wherever the socket leaves the
    reuse cycle — pool discard/overflow, session close)."""
    ring = _SOCK_RINGS.pop(sock, None)
    if ring is not None:
        ring.close()


def shm_ring_capable(sock: socket.socket) -> bool:
    """Is this a same-host data connection a ring may ride?  Abstract-
    UDS connections qualify outright (SO_PEERCRED gate).  Loopback TCP
    also qualifies: pure-Python chunkservers have no UDS listener, so
    their demux's only reachable transport is 127.0.0.1 — the server
    still enforces the same-uid gate through its /proc/<pid>/fd open,
    and a native server just refuses ShmInit on TCP (the connection
    stays on the socket-copy path)."""
    if sock.family == socket.AF_UNIX:
        return True
    try:
        peer = sock.getpeername()
    except OSError:
        return False
    return (
        isinstance(peer, tuple)
        and bool(peer)
        and peer[0] in ("127.0.0.1", "::1")
    )


def shm_ring_handshake(sock: socket.socket) -> "ShmRing | None":
    """Negotiate (or reuse) a ring on a same-host data connection.

    On a unix socket the memfd rides the CltocsShmInit frame as
    SCM_RIGHTS ancillary data; on loopback TCP (asyncio chunkserver)
    the frame goes bare and the server maps /proc/<pid>/fd/<n>
    instead.  Any refusal leaves the connection on the socket-copy
    path. Raises on socket errors (a server that predates the frame
    closes the connection — the caller treats that like any other
    failed exchange)."""
    ring = _SOCK_RINGS.get(sock)
    if ring is not None:
        return ring
    size = shm_seg_bytes()
    ring = ShmRing(size)
    try:
        frame = framing.encode(m.CltocsShmInit(
            req_id=1, pid=os.getpid(), mem_fd=ring.memfd, seg_size=size,
        ))
        if sock.family == socket.AF_UNIX:
            sock.sendmsg(
                [frame],
                [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                  struct.pack("i", ring.memfd))],
            )
        else:
            sock.sendall(frame)
        reply = _recv_message(sock)
    except BaseException:
        ring.close()
        raise
    if (
        not isinstance(reply, m.CstoclWriteStatus)
        or reply.status != st.OK
    ):
        ring.close()
        return None
    _SOCK_RINGS[sock] = ring
    return ring


POOL = _SocketPool()

# Connections that negotiated a shm ring are pooled SEPARATELY: their
# server side lives on the epoll proactor, which serves the write-
# session protocol (descriptors + bulk frames + init/end) but not the
# read plane — reads and legacy per-part writes must keep drawing from
# the plain POOL so they never land on a proactor-owned connection.
RING_POOL = _SocketPool()

# observability + contract pin: how many data-plane connections took the
# same-host unix-socket fast path (tests assert this moves, so a silent
# name-format drift between here and native/wire.h fails loudly)
UDS_CONNECTS = 0
_UDS_COUNT_LOCK = threading.Lock()  # incremented from executor threads

# Dedicated executor: native IO calls block for a full network exchange.
# Sharing asyncio's default to_thread pool would let a burst of bulk
# transfers starve unrelated to_thread work (e.g. an in-process
# chunkserver's disk jobs — whose acks these very calls wait on).
EXECUTOR = ThreadPoolExecutor(max_workers=32, thread_name_prefix="native-io")

# Server-side serving gets its own pool: in-process clusters (tests,
# benches) have client exchanges above PARKED in EXECUTOR threads
# waiting on the very responses these serve calls produce — sharing one
# pool would deadlock at saturation.
SERVE_EXECUTOR = ThreadPoolExecutor(
    max_workers=16, thread_name_prefix="native-serve"
)


_prestarted = False


def prestart_executors() -> None:
    """Spawn every pool thread up front. ThreadPoolExecutor creates
    threads lazily inside submit(), and Thread.start() BLOCKS until the
    new thread's bootstrap runs — under GIL pressure (busy encode/IO
    threads) that wait was measured at 150-600 ms ON THE EVENT LOOP
    during EC write fan-out. Pre-started threads make submit() a pure
    enqueue.

    Runs once per process, at the FIRST daemon/client startup (while
    the pools are quiet — parking tasks in an already-busy shared pool
    would queue behind live work and head-of-line-block it); later
    callers no-op. The spawn/join phase itself runs on a helper daemon
    thread: Thread.start() × 48 workers can take seconds on a loaded
    single-core box, and the caller is usually ON the event loop
    (connect/failover) — the very stall this function exists to avoid."""
    global _prestarted
    if _prestarted:
        return
    _prestarted = True
    import threading

    threading.Thread(
        target=_prestart_blocking, name="lz-prestart", daemon=True
    ).start()


def _prestart_blocking() -> None:
    import threading

    for pool in (EXECUTOR, SERVE_EXECUTOR):
        # park one task per worker: a parked thread is not idle, so
        # every submit() spawns a fresh thread until the pool is full
        release = threading.Event()
        started = threading.Semaphore(0)

        def _parked(started=started, release=release):
            started.release()
            release.wait(10.0)

        try:
            futs = [
                pool.submit(_parked)
                for _ in range(pool._max_workers)  # noqa: SLF001
            ]
        except RuntimeError:
            continue  # pool already shut down
        deadline_ok = all(started.acquire(timeout=2.0) for _ in futs)
        release.set()
        if not deadline_ok:
            # partial spawn (loaded box): fine — whatever started stays
            return
# native serves in flight above this fall back to the asyncio path, so
# stalled slow-draining clients (which may legally pin a serve thread
# until their deadline) cannot head-of-line-block healthy readers. The
# counter is process-global like the executor it guards (an in-process
# cluster runs several chunkservers on one pool).
SERVE_CONCURRENCY_LIMIT = 12
active_serves = 0


def serve_slot_available() -> bool:
    return active_serves < SERVE_CONCURRENCY_LIMIT


def serve_slot_acquire() -> None:
    global active_serves
    active_serves += 1


def serve_slot_release() -> None:
    global active_serves
    active_serves -= 1


class Hop:
    """One off-loop hop of a request: ``fn(*args)`` submitted at once to
    ``executor`` (None: the loop's default) with the caller's trace id
    AND wire session carried into the thread, captured HERE, in the
    calling task, because neither contextvars nor the task's session
    scope reach an executor thread. Four ``perf_counter`` stamps time
    it: ``submitted`` on the loop, ``started`` and ``returned`` in the
    thread, and the resume, which :meth:`charge` takes on the loop when
    the awaiting coroutine runs again. Sites that need the raw future
    (shield/abort-cell patterns) await ``future`` themselves and call
    :meth:`charge` once it succeeded."""

    __slots__ = ("future", "submitted", "started", "returned")

    def __init__(self, executor, fn, *args):
        trace_id = tracing.current_trace_id()
        session = accounting.wire_session() if trace_id else 0
        self.started = self.returned = 0.0
        self.submitted = time.perf_counter()
        self.future = asyncio.get_running_loop().run_in_executor(
            executor,
            functools.partial(self._call, trace_id, session, fn, *args),
        )

    def _call(self, trace_id, session, fn, *args):
        self.started = time.perf_counter()
        try:
            if trace_id:
                return _traced_call(trace_id, session, fn, *args)
            return fn(*args)
        finally:
            self.returned = time.perf_counter()

    def charge(self, phase: str) -> None:
        """Charge the finished hop to ``phase`` of the ambient read
        (runtime/tracing.py :func:`charge_hop`)."""
        tracing.charge_hop(phase, self.submitted, self.started, self.returned)


async def run(fn, *args):
    """Run a blocking native-IO function on the dedicated executor, with
    the caller's request trace id installed as the C side's
    thread-local (lz_trace_set) for the duration of the call, so the
    native request builders tag their frames with the trace of the
    request they serve."""
    return await Hop(EXECUTOR, fn, *args).future


async def run_hop(phase: str, executor, fn, *args):
    """``fn(*args)`` as a :class:`Hop` on ``executor``, charged to the
    ambient read's ``phase`` when it returns."""
    hop = Hop(executor, fn, *args)
    out = await hop.future
    hop.charge(phase)
    return out


# worker-thread trace id: read by the python-framed handshakes
# (_send_write_init) the same way the C builders read lz_trace_set
_TRACE_TL = threading.local()


def _thread_trace_id() -> int:
    return getattr(_TRACE_TL, "trace_id", 0)


def _traced_call(trace_id, session_id, fn, *args):
    _TRACE_TL.trace_id = trace_id
    has_c = _lib is not None and hasattr(_lib, "lz_trace_set")
    # the caller's session rides next to the trace (per-session op
    # accounting on the chunkserver); a stale .so simply lacks the
    # setter and frames stay session-less
    has_sess = _lib is not None and hasattr(_lib, "lz_session_set")
    if has_c:
        _lib.lz_trace_set(trace_id)
    if has_sess:
        _lib.lz_session_set(session_id)
    try:
        return fn(*args)
    finally:
        # pooled executor threads serve many requests — never leak a
        # trace id into the next one
        _TRACE_TL.trace_id = 0
        if has_c:
            _lib.lz_trace_set(0)
        if has_sess:
            _lib.lz_session_set(0)


async def run_serve(fn, *args):
    """Run a blocking server-side serve function on its own executor."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        SERVE_EXECUTOR, functools.partial(fn, *args)
    )


def _blocking_socket(addr: tuple[str, int], io_timeout: float) -> socket.socket:
    """Connect and return a socket whose fd is BLOCKING (a Python-level
    timeout makes the fd non-blocking, which breaks the C send/recv
    loops); IO deadlines are enforced by the kernel via SO_*TIMEO.

    Same-host addresses first try the data plane's abstract unix
    listener (``\\0lzfs-data-<advertised-host>-<port>``, bound by
    lz_serve_start — KEEP IN SYNC with serve_native.cpp
    uds_data_addr; the contract is pinned by
    test_fast_paths.py::test_uds_fast_path_engages): ~2.5x less
    per-byte CPU than loopback TCP on the measured boxes. The name
    embeds the host STRING the server advertised, so a port forward to
    a remote server never aliases to a local listener. Absent listener
    (asyncio data plane, remote host, LZ_NO_UDS set) falls back to TCP
    transparently."""
    global UDS_CONNECTS
    sock = None
    if (
        addr[0] in ("127.0.0.1", "localhost")  # exactly wire.h uds_host()
        # operational kill-switch, default off; env_flag gives it the
        # four-spelling parity the bare truthiness read lacked
        # (LZ_NO_UDS=0 used to DISABLE the fast path)
        and not uds_disabled()
    ):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.settimeout(5.0)
            s.connect(f"\0lzfs-data-{addr[0]}-{addr[1]}")
            # abstract names bypass filesystem permissions: verify the
            # peer is OUR uid (or root) via SO_PEERCRED before trusting
            # it with chunk data — anything else could be an impostor
            # that bound the name first
            pid_uid_gid = s.getsockopt(
                socket.SOL_SOCKET, socket.SO_PEERCRED, struct.calcsize("3i")
            )
            _pid, uid, _gid = struct.unpack("3i", pid_uid_gid)
            if uid not in (os.geteuid(), 0):
                raise OSError("unix listener owned by another uid")
            s.settimeout(None)
            sock = s
            with _UDS_COUNT_LOCK:
                UDS_CONNECTS += 1
        except OSError:
            s.close()
    if sock is None:
        sock = socket.create_connection(addr, timeout=30.0)
        sock.settimeout(None)  # back to a blocking fd
    tv = struct.pack("ll", int(io_timeout), 0)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
    if sock.family != socket.AF_UNIX:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # deep buffers cut syscall/context-switch count for bulk streams
    for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, 4 * 1024 * 1024)
        except OSError:
            pass
    return sock


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        piece = sock.recv(n - len(out))
        if not piece:
            raise ConnectionError("peer closed")
        out += piece
    return bytes(out)


def _recv_message(sock: socket.socket):
    header = _recv_exact(sock, 8)
    msg_type, length = struct.unpack(">II", header)
    payload = _recv_exact(sock, length)
    return framing.decode(msg_type, payload)


def abort_read(cell: dict) -> None:
    """Kill an in-flight read_part_blocking from another thread: the
    executor thread is uninterruptible inside the C exchange, but a
    socket shutdown makes its recv fail immediately. Used before
    retrying a read whose thread may still be scattering into a shared
    destination buffer."""
    cell["aborted"] = True
    sock = cell.get("sock")
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


def read_part_blocking(
    addr: tuple[str, int],
    chunk_id: int,
    version: int,
    part_id: int,
    offset: int,
    size: int,
    out: np.ndarray,
    cell: dict | None = None,
) -> None:
    """Fill ``out[:size]`` with the requested range (called via
    asyncio.to_thread). Retries once on a stale pooled socket.

    Block-aligned requests use the bulk exchange (one reply frame,
    receiver-verified CRCs, server sendfile) — the fast path; unaligned
    ones fall back to the per-piece protocol.  ``cell`` (optional dict)
    publishes the live socket so abort_read() can cancel the exchange."""
    from lizardfs_tpu_torch.constants import MFSBLOCKSIZE

    assert out.flags.c_contiguous and out.nbytes >= size
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    fn = (_lib.lz_read_part_bulk if offset % MFSBLOCKSIZE == 0
          else _lib.lz_read_part)
    for attempt in (0, 1):
        # second attempt dials fresh: the pool may hold several sockets
        # staled by the same server restart
        sock = POOL.acquire(addr) if attempt == 0 else _blocking_socket(addr, 30.0)
        if cell is not None:
            cell["sock"] = sock
            if cell.get("aborted"):
                POOL.discard(sock)
                raise NativeIOError(-1, "read (aborted)")
        rc = fn(
            sock.fileno(), chunk_id, version, part_id, offset, size, ptr
        )
        if cell is not None:
            cell.pop("sock", None)
        if rc == 0:
            POOL.release(addr, sock)
            return
        POOL.discard(sock)
        if rc == -1 and attempt == 0 and not (cell or {}).get("aborted"):
            continue  # stale pooled socket: retry on a fresh connection
        raise NativeIOError(rc, "read")


def write_part_blocking(
    addr: tuple[str, int],
    chunk_id: int,
    version: int,
    part_id: int,
    chain: list,
    payload: bytes | np.ndarray,
    part_offset: int,
    cell: dict | None = None,
) -> None:
    """Full write exchange: WriteInit handshake (Python framing), bulk
    WriteData streaming + acks (native), WriteEnd handshake. ``cell``
    publishes the live socket so abort_write() can cancel the exchange
    (the executor thread is otherwise unkillable while it streams from
    the caller's buffer); ``cell["finished"]`` is set when this thread
    has stopped touching ``payload``."""
    sock = _blocking_socket(addr, 60.0)
    if cell is not None:
        cell["sock"] = sock
        if cell.get("aborted"):
            sock.close()
            cell["finished"] = True
            raise NativeIOError(-1, "write (aborted)")
    try:
        sock.sendall(
            framing.encode(
                m.CltocsWriteInit(
                    req_id=1, chunk_id=chunk_id, version=version,
                    part_id=part_id, chain=chain, create=False,
                    trace_id=_thread_trace_id(),
                    session_id=accounting.wire_session(),
                )
            )
        )
        init = _recv_message(sock)
        if not isinstance(init, m.CstoclWriteStatus) or init.status != st.OK:
            raise st.StatusError(getattr(init, "status", st.EIO), "write init")
        buf = (payload if isinstance(payload, np.ndarray)
               else np.frombuffer(payload, dtype=np.uint8))
        if not buf.flags.c_contiguous:
            buf = np.ascontiguousarray(buf)
        from lizardfs_tpu_torch.constants import MFSBLOCKSIZE

        fn = (_lib.lz_write_part_bulk if part_offset % MFSBLOCKSIZE == 0
              else _lib.lz_write_part)
        rc = fn(
            sock.fileno(), chunk_id,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf), part_offset, 1,
        )
        if rc != 0:
            raise NativeIOError(rc, "write")
        sock.sendall(framing.encode(m.CltocsWriteEnd(req_id=0, chunk_id=chunk_id)))
        end = _recv_message(sock)
        if not isinstance(end, m.CstoclWriteStatus) or end.status != st.OK:
            raise st.StatusError(getattr(end, "status", st.EIO), "write end")
    finally:
        sock.close()
        if cell is not None:
            cell.pop("sock", None)
            cell["finished"] = True


def _n_pieces(offset: int, size: int) -> int:
    from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
    return (offset + size - 1) // MFSBLOCKSIZE - offset // MFSBLOCKSIZE + 1


def load_read_blocking(
    path: str, offset: int, size: int, data_len: int
) -> tuple[int, np.ndarray, np.ndarray]:
    """Server side, phase 1: load + CRC-verify one part range.

    Runs with the chunk-file lock held (caller's job). OSError from a
    vanished file propagates — the caller maps it to a status frame.
    Returns ``(status, data, piece_crcs)``.
    """
    buf = np.empty(size, dtype=np.uint8)
    crcs = np.empty(_n_pieces(offset, size), dtype=np.uint32)
    file_fd = os.open(path, os.O_RDONLY)
    try:
        rc = _lib.lz_load_read(
            file_fd, offset, size, data_len,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
    finally:
        os.close(file_fd)
    return rc, buf, crcs


def stream_read_blocking(
    sock_fd: int,
    chunk_id: int,
    req_id: int,
    offset: int,
    size: int,
    data: np.ndarray,
    crcs: np.ndarray,
) -> int:
    """Server side, phase 2: stream loaded pieces on the asyncio socket.

    ``sock_fd`` is non-blocking — the C side polls on EAGAIN. The caller
    passes a dup'd fd and THIS function owns it: the connection task may
    be cancelled (and the transport's fd closed and reused) while this
    thread is still sending, so the thread must work on its own fd and
    close it here. The caller must have flushed the asyncio write buffer
    and be the only writer on the connection until this returns.
    Returns 0, or -1 if the socket died mid-stream.
    """
    # absolute deadline: 30 s of grace plus a 512 KiB/s floor rate, so a
    # stalled client cannot pin a serve thread indefinitely
    max_ms = 30_000 + size // 512
    try:
        return _lib.lz_stream_read(
            sock_fd, chunk_id, req_id, offset, size,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            crcs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), max_ms,
        )
    finally:
        os.close(sock_fd)


class _PartReq(ctypes.Structure):
    _fields_ = [
        ("fd", ctypes.c_int),
        ("chunk_id", ctypes.c_uint64),
        ("version", ctypes.c_uint32),
        ("part_id", ctypes.c_uint32),
        ("rc", ctypes.c_int32),
    ]


def parts_gather_available() -> bool:
    return _lib is not None and hasattr(_lib, "lz_read_parts_gather")


def read_parts_gather_blocking(
    addrs: list[tuple[str, int]],
    chunk_id: int,
    version: int,
    part_ids: list[int],
    offset: int,
    region_blocks: int,
    out: np.ndarray,
    cell: dict | None = None,
) -> None:
    """Read ``region_blocks`` 64 KiB chunk blocks spread over d data
    parts (all starting at part-local ``offset``) in ONE poll-driven
    native exchange, de-interleaving straight into ``out`` (block j of
    part i -> out[(j*d+i)*64Ki : ...]). The whole-chunk EC read fast
    path: one executor thread and one C call replace d of each. Raises
    NativeIOError with the first failing part's code; the caller falls
    back to the wave executor (which handles recovery)."""
    from lizardfs_tpu_torch.constants import MFSBLOCKSIZE

    d = len(addrs)
    assert d == len(part_ids) and out.flags.c_contiguous
    assert out.nbytes >= region_blocks * MFSBLOCKSIZE
    # attempt 0 uses pooled sockets; a socket-level failure (-1) retries
    # once with fresh dials — the pool may hold connections staled by a
    # server restart (mirrors read_part_blocking's retry)
    for attempt in (0, 1):
        reqs = (_PartReq * d)()
        socks = []
        try:
            for i, addr in enumerate(addrs):
                s = (POOL.acquire(addr) if attempt == 0
                     else _blocking_socket(addr, 30.0))
                socks.append((addr, s))
                reqs[i].fd = s.fileno()
                reqs[i].chunk_id = chunk_id
                reqs[i].version = version
                reqs[i].part_id = part_ids[i]
                reqs[i].rc = 0
            if cell is not None:
                cell["socks"] = [s for _, s in socks]
                if cell.get("aborted"):
                    raise NativeIOError(-1, "parts gather (aborted)")
            rc = _lib.lz_read_parts_gather(
                ctypes.cast(reqs, ctypes.c_void_p), d, offset,
                region_blocks,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                120_000,
            )
            if cell is not None:
                cell.pop("socks", None)
            if rc == 0:
                for addr, s in socks:
                    POOL.release(addr, s)
                socks.clear()
                return
            bad = next((int(r.rc) for r in reqs if r.rc != 0), -1)
            if (
                attempt == 0 and bad == -1
                and not (cell is not None and cell.get("aborted"))
            ):
                continue  # stale pooled socket: redial everything once
            raise NativeIOError(bad, "parts gather")
        finally:
            for _, s in socks:
                POOL.discard(s)


def abort_parts_gather(cell: dict) -> None:
    """Kill an in-flight read_parts_gather_blocking from another thread
    (socket shutdowns make its recvs fail immediately)."""
    cell["aborted"] = True
    for sock in cell.get("socks", ()):
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    sock = cell.get("sock")
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass


# write-side aborts use the same cell shape ("sock"/"socks" + "aborted");
# a cancelled write task must kill its executor thread's exchange before
# the staging buffer the thread streams from can be reused
abort_write = abort_parts_gather
abort_parts_scatter = abort_parts_gather


def parts_scatter_available() -> bool:
    return _lib is not None and hasattr(_lib, "lz_write_parts_scatter")


def parts_scatterv_available() -> bool:
    """Vectored + windowed scatter writes (lz_write_parts_scatterv /
    lz_write_collect_acks): required by the adaptive write window."""
    return (
        _lib is not None
        and hasattr(_lib, "lz_write_parts_scatterv")
        and hasattr(_lib, "lz_write_collect_acks")
    )


# lz_write_parts_scatterv flags (keep in sync with io_native.cpp)
SCATTER_NO_ACK = 1


# shared building blocks of the two scatter-write paths (the one-shot
# write_parts_scatter_blocking and the multi-segment PartsScatterSession):
# a protocol change lands in exactly one place


def _send_write_init(sock: socket.socket, chunk_id: int, version: int,
                     part_id: int) -> None:
    sock.sendall(framing.encode(m.CltocsWriteInit(
        req_id=1, chunk_id=chunk_id, version=version,
        part_id=part_id, chain=[], create=False,
        trace_id=_thread_trace_id(),
        session_id=accounting.wire_session(),
    )))


def _recv_write_init_acks(socks: list[socket.socket]) -> None:
    """Collect one WriteInit ack per socket (inits were sent for ALL
    sockets first — serialized request/response would pay n round
    trips instead of ~1); raises NativeIOError on a refusal."""
    for s in socks:
        init = _recv_message(s)
        if not isinstance(init, m.CstoclWriteStatus) or init.status != st.OK:
            raise NativeIOError(getattr(init, "status", -2), "write init")


def _marshal_part_reqs(
    fds: list[int], chunk_id: int, write_id: int, part_ids: list[int],
    payloads: list[np.ndarray], lengths: list[int],
):
    """-> (reqs, ptrs, lens) ctypes arrays for lz_write_parts_scatter.
    The req's ``version`` slot carries the bulk frame's write_id."""
    n = len(fds)
    reqs = (_PartReq * n)()
    ptrs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_uint64 * n)()
    for i in range(n):
        buf = payloads[i]
        assert buf.flags.c_contiguous and buf.nbytes >= lengths[i]
        reqs[i].fd = fds[i]
        reqs[i].chunk_id = chunk_id
        reqs[i].version = write_id
        reqs[i].part_id = part_ids[i]
        reqs[i].rc = 0
        ptrs[i] = buf.ctypes.data_as(ctypes.c_void_p).value
        lens[i] = lengths[i]
    return reqs, ptrs, lens


def _write_end_handshake(socks: list[socket.socket], chunk_id: int) -> None:
    for s in socks:
        s.sendall(framing.encode(
            m.CltocsWriteEnd(req_id=0, chunk_id=chunk_id)
        ))
    for s in socks:
        end = _recv_message(s)
        if not isinstance(end, m.CstoclWriteStatus) or end.status != st.OK:
            raise NativeIOError(getattr(end, "status", -2), "write end")


class PartsScatterSession:
    """Pipelined multi-segment part writes over persistent connections.

    The write-path building block of the client's double-buffered stripe
    pipeline: ``open()`` dials every part's holder once and runs the
    WriteInit handshakes; ``send_segment()`` streams one slot-aligned
    segment of every part (one poll-driven ``lz_write_parts_scatter``
    call: bulk frame + ack per part, per-block CRCs computed in C);
    ``finish()`` runs the WriteEnd handshakes. One handshake pair per
    part per *chunk* instead of per segment — the per-segment cost is
    only the bulk frames themselves, so encode(i+1) can overlap
    send(i) without paying n extra round trips per segment.

    Every method is blocking (call via :func:`run`). Any failure leaves
    the sockets closed and the exchange dead; the caller falls back to
    the serial write path (a full-part rewrite heals torn segments).
    ``cell`` follows the abort contract of write_parts_scatter_blocking:
    abort_write(cell) from another thread kills the exchange,
    ``cell["finished"]`` marks when no thread reads the payloads anymore.
    """

    def __init__(
        self,
        addrs: list[tuple[str, int]],
        chunk_id: int,
        version: int,
        part_ids: list[int],
        cell: dict | None = None,
        share_connections: bool = False,
    ):
        assert len(addrs) == len(part_ids)
        self.addrs = addrs
        self.chunk_id = chunk_id
        self.version = version
        self.part_ids = part_ids
        self.cell = cell if cell is not None else {}
        # share_connections: parts that target the same chunkserver
        # ride ONE connection (the windowed/vectored path demuxes them
        # with part-addressed 1215 frames server-side). The legacy
        # barrier path keeps one socket per part — its 1214 frames
        # carry no part id, so a shared connection cannot demux them.
        self.share = share_connections
        if share_connections:
            self.unique_addrs: list[tuple[str, int]] = []
            self._conn_of: list[int] = []
            index: dict[tuple[str, int], int] = {}
            for addr in addrs:
                if addr not in index:
                    index[addr] = len(self.unique_addrs)
                    self.unique_addrs.append(addr)
                self._conn_of.append(index[addr])
        else:
            self.unique_addrs = list(addrs)
            self._conn_of = list(range(len(addrs)))
        self._socks: list[socket.socket] = []
        # write_id -> live part indices of an unacked windowed segment
        self._pending: dict[int, list[int]] = {}
        # shm rings per connection (None = socket-copy path for that
        # conn) + staged ring regions per in-flight write_id:
        # write_id -> list of (part_index, conn_index, off, cost, view)
        self._rings: list[ShmRing | None] = []
        self._ring_staged: dict[int, list[tuple]] = {}
        # folded into Client.metrics by the owner after the chunk write
        self.ring_stats = {
            "segments_mapped": 0, "desc_parts": 0, "full_waits": 0,
            "fallbacks": 0,
        }

    def _sock_of(self, part_index: int) -> socket.socket:
        return self._socks[self._conn_of[part_index]]

    def _ring_eligible(self) -> bool:
        return self.share and shm_ring_enabled() and parts_shm_available()

    def open(self) -> None:
        self.cell["submitted"] = True
        ring_mode = self._ring_eligible()
        for attempt in (0, 1):
            try:
                for addr in self.unique_addrs:
                    # pooled sockets first (the write hot path dials
                    # d+m connections per chunk — churn that the pool
                    # exists to absorb); ring-negotiated connections
                    # live in their own pool (their server side is the
                    # proactor) and are only reused by ring-eligible
                    # sessions. A stale pooled connection (server
                    # restart) fails the init handshake and retries
                    # once with fresh dials, mirroring
                    # _write_parts_scatter
                    s = None
                    if attempt == 0 and ring_mode:
                        s = RING_POOL.try_acquire(addr)
                    if s is None:
                        s = (POOL.acquire(addr) if attempt == 0
                             else _blocking_socket(addr, 60.0))
                    self._socks.append(s)
                for i in range(len(self.part_ids)):
                    _send_write_init(
                        self._sock_of(i), self.chunk_id, self.version,
                        self.part_ids[i],
                    )
                self.cell["socks"] = list(self._socks)
                if self.cell.get("aborted"):
                    raise NativeIOError(-1, "scatter session (aborted)")
                # one ack per part, read from its connection in init
                # order (a connection answers its inits FIFO, so the
                # global part order is safe to follow)
                _recv_write_init_acks(
                    [self._sock_of(i) for i in range(len(self.part_ids))]
                )
                self._setup_rings()
                return
            except (ConnectionError, OSError, st.StatusError):
                for s in self._socks:
                    POOL.discard(s)
                self._socks.clear()
                self.cell.pop("socks", None)
                if attempt == 1 or self.cell.get("aborted"):
                    self.cell["finished"] = True
                    raise
            except BaseException:
                self.close()
                raise

    # --- shm-ring staging (native/shm_ring.h) -------------------------

    def _setup_rings(self) -> None:
        """Negotiate a memfd ring per shared connection where the
        same-host fast path applies. Only the windowed/shared mode uses
        rings (the legacy per-part barrier path keeps its wire shape);
        any per-connection failure just leaves that connection on the
        socket-copy path — never fails the session."""
        self._rings = [None] * len(self._socks)
        if not self._ring_eligible():
            return
        for ci, sock in enumerate(self._socks):
            if not shm_ring_capable(sock):
                continue  # same-host connections only
            try:
                had = shm_ring_of(sock) is not None
                ring = shm_ring_handshake(sock)
            except (ConnectionError, OSError):
                # a peer predating the frame kills the connection; the
                # session keeps running and the next exchange on the
                # dead socket fails into the ordinary fallback chain
                continue
            self._rings[ci] = ring
            if ring is not None and not had:
                self.ring_stats["segments_mapped"] += 1

    def ring_ready(self) -> bool:
        """True when EVERY connection negotiated a ring — segment
        staging is all-or-nothing so one encode pass targets one kind
        of memory (mixed ring/socket conns take the scatterv path)."""
        return bool(self._rings) and all(
            r is not None for r in self._rings
        )

    def ring_stage(self, write_id: int, lengths: list[int],
                   widths: list[int] | None = None):
        """Allocate this segment's per-part regions in the rings and
        return arena views to encode/copy into (None entries for parts
        skipped this segment), or None when any ring is full — the
        caller reaps acks (freeing regions) and retries, or falls back
        to the socket-copy send for this segment.

        ``widths[i]`` (>= ``lengths[i]``, default equal) sizes the
        allocation and the returned view: an encoder that produces the
        full padded segment width needs the whole region writable even
        when only the part's live ``lengths[i]`` bytes go on the wire
        (ragged tail segments)."""
        if not self.ring_ready():
            return None
        staged: list[tuple] = []
        views: list = [None] * len(self.part_ids)
        for i, length in enumerate(lengths):
            if length <= 0:
                continue
            width = max(length, widths[i]) if widths is not None else length
            ci = self._conn_of[i]
            ring = self._rings[ci]
            got = ring.alloc(width)
            if got is None:
                for _i, _ci, _off, cost, _v in reversed(staged):
                    self._rings[_ci].unalloc(_off, cost, _v.nbytes)
                self.ring_stats["full_waits"] += 1
                return None
            off, cost = got
            view = ring.view(off, width)
            staged.append((i, ci, off, cost, view))
            views[i] = view
        self._ring_staged[write_id] = staged
        return views

    def ring_unstage(self, write_id: int) -> None:
        """Roll back a staged-but-never-sent segment (encode failure).

        Valid because staging/sending are serialized per session, so a
        just-staged segment's regions are strictly the ring's newest —
        the LIFO precondition of :meth:`ShmRing.unalloc`."""
        for _i, ci, _off, cost, _v in reversed(
            self._ring_staged.pop(write_id, ())
        ):
            self._rings[ci].unalloc(_off, cost, _v.nbytes)

    def _ring_send_descs(self, staged, payloads, lengths, part_offset,
                         write_id):
        """Move + describe one staged segment: entries whose payload
        still lives outside the arena (data rows) get their one GIL-free
        memcpy in C; entries encoded straight into the arena (parity —
        payload IS the staged view) move zero bytes."""
        n = len(staged)
        reqs = (_PartReq * n)()
        srcs = (ctypes.c_void_p * n)()
        dsts = (ctypes.c_void_p * n)()
        lens = (ctypes.c_uint64 * n)()
        offs = (ctypes.c_uint64 * n)()
        for j, (i, _ci, off, _cost, view) in enumerate(staged):
            src = payloads[i]
            assert src.flags.c_contiguous and src.nbytes >= lengths[i]
            reqs[j].fd = self._sock_of(i).fileno()
            reqs[j].chunk_id = self.chunk_id
            reqs[j].version = write_id
            reqs[j].part_id = self.part_ids[i]
            reqs[j].rc = 0
            srcs[j] = src.ctypes.data_as(ctypes.c_void_p).value
            dsts[j] = view.ctypes.data_as(ctypes.c_void_p).value
            lens[j] = lengths[i]
            offs[j] = off
        rc = _lib.lz_shm_write_descs(
            ctypes.cast(reqs, ctypes.c_void_p), n, srcs, dsts, lens,
            offs, part_offset, 120_000, SCATTER_NO_ACK,
        )
        if rc != 0:
            bad = next((int(r.rc) for r in reqs if r.rc != 0), -1)
            raise NativeIOError(bad, "shm descriptor send")
        self.ring_stats["desc_parts"] += n

    def send_segment(
        self,
        payloads: list[np.ndarray],
        lengths: list[int],
        part_offset: int,
        write_id: int,
    ) -> None:
        """Stream ``payloads[i][:lengths[i]]`` at ``part_offset`` within
        every live part and wait for every ack (the barrier path). A
        zero length skips that part this segment (tail segments cover
        fewer parts)."""
        assert self._socks, "session not open"
        n = len(self.part_ids)
        assert n == len(payloads) == len(lengths)
        live = [i for i in range(n) if lengths[i] > 0]
        if not live:
            return
        try:
            if self.cell.get("aborted"):
                raise NativeIOError(-1, "scatter session (aborted)")
            reqs, ptrs, lens = _marshal_part_reqs(
                [self._sock_of(i).fileno() for i in live],
                self.chunk_id, write_id,
                [self.part_ids[i] for i in live],
                [payloads[i] for i in live],
                [lengths[i] for i in live],
            )
            if self.share:
                # shared connections need part-addressed frames (and a
                # duplicate-fd-aware send loop): the vectored call
                rc = _lib.lz_write_parts_scatterv(
                    ctypes.cast(reqs, ctypes.c_void_p), len(live), ptrs,
                    lens, part_offset, 120_000, 0,
                )
            else:
                rc = _lib.lz_write_parts_scatter(
                    ctypes.cast(reqs, ctypes.c_void_p), len(live), ptrs,
                    lens, part_offset, 120_000,
                )
            if rc != 0:
                bad = next((int(r.rc) for r in reqs if r.rc != 0), -1)
                raise NativeIOError(bad, "scatter session segment")
        except BaseException:
            self.close()
            raise

    def send_segment_window(
        self,
        payloads: list[np.ndarray],
        lengths: list[int],
        part_offset: int,
        write_id: int,
    ) -> None:
        """Windowed send: stream one segment's part-addressed bulk
        frames (vectored sendmsg, header+payload in one syscall per
        socket pass) WITHOUT waiting for acks — collect them later via
        :meth:`collect_acks`. The caller bounds how many segments ride
        unacknowledged (the adaptive write window's credits)."""
        assert self._socks, "session not open"
        n = len(self.part_ids)
        assert n == len(payloads) == len(lengths)
        staged = self._ring_staged.get(write_id)
        if staged is not None:
            if not staged:  # fully dead segment (ragged tail)
                self._ring_staged.pop(write_id, None)
                self._pending[write_id] = []
                return
            # staged segment: payloads move into the arena with at most
            # one GIL-free memcpy each (zero for parity, which the
            # caller encoded straight into its staged view), then tiny
            # descriptors ship instead of megabytes
            try:
                if self.cell.get("aborted"):
                    raise NativeIOError(-1, "scatter session (aborted)")
                self._ring_send_descs(staged, payloads, lengths,
                                      part_offset, write_id)
                self._pending[write_id] = [e[0] for e in staged]
            except BaseException:
                self.close()
                raise
            return
        live = [i for i in range(n) if lengths[i] > 0]
        if not live:
            self._pending[write_id] = []
            return
        if self.ring_ready():
            # rings are up but this segment didn't fit (or wasn't
            # staged): socket-copy send, counted as a fallback
            self.ring_stats["fallbacks"] += 1
        try:
            if self.cell.get("aborted"):
                raise NativeIOError(-1, "scatter session (aborted)")
            reqs, ptrs, lens = _marshal_part_reqs(
                [self._sock_of(i).fileno() for i in live],
                self.chunk_id, write_id,
                [self.part_ids[i] for i in live],
                [payloads[i] for i in live],
                [lengths[i] for i in live],
            )
            rc = _lib.lz_write_parts_scatterv(
                ctypes.cast(reqs, ctypes.c_void_p), len(live), ptrs, lens,
                part_offset, 120_000, SCATTER_NO_ACK,
            )
            if rc != 0:
                bad = next((int(r.rc) for r in reqs if r.rc != 0), -1)
                raise NativeIOError(bad, "windowed segment send")
            self._pending[write_id] = live
        except BaseException:
            self.close()
            raise

    def collect_acks(self, write_id: int) -> None:
        """Collect one segment's outstanding acks (sent via
        :meth:`send_segment_window`). Segments must be collected in
        send order — acks are FIFO per connection (and so are ring
        region frees, which keeps the FIFO arena allocator exact)."""
        live = self._pending.pop(write_id, None)
        staged = self._ring_staged.pop(write_id, None)
        if not live:
            return
        try:
            if self.cell.get("aborted"):
                raise NativeIOError(-1, "scatter session (aborted)")
            n = len(live)
            reqs = (_PartReq * n)()
            for j, i in enumerate(live):
                reqs[j].fd = self._sock_of(i).fileno()
                reqs[j].chunk_id = self.chunk_id
                reqs[j].version = write_id
                reqs[j].part_id = self.part_ids[i]
                reqs[j].rc = 0
            rc = _lib.lz_write_collect_acks(
                ctypes.cast(reqs, ctypes.c_void_p), n, 120_000
            )
            if rc != 0:
                bad = next((int(r.rc) for r in reqs if r.rc != 0), -1)
                raise NativeIOError(bad, "windowed segment ack")
            if staged:
                # the server acked: it is done reading these regions
                for _i, ci, _off, cost, _v in staged:
                    self._rings[ci].free(cost)
        except BaseException:
            self.close()
            raise

    def finish(self) -> None:
        try:
            # the windowed caller collects every segment before
            # finishing; a leftover here means an unacked segment and
            # the End status below would desync — refuse
            if self._pending:
                raise NativeIOError(-2, "finish with unacked segments")
            # one WriteEnd per CONNECTION: the server seals every part
            # session of the chunk on that connection and answers once
            _write_end_handshake(self._socks, self.chunk_id)
        except BaseException:
            self.close()
            raise
        # clean end: the sockets sit in the same reusable protocol
        # state the one-shot scatter path pools — release, don't close.
        # Ring-negotiated connections go to THEIR pool (the server side
        # is the proactor; only ring-eligible sessions may reuse them)
        for addr, s in zip(self.unique_addrs, self._socks):
            pool = RING_POOL if shm_ring_of(s) is not None else POOL
            pool.release(addr, s)
        self._socks.clear()
        self.cell.pop("socks", None)
        self.cell["finished"] = True

    def close(self) -> None:
        for s in self._socks:
            shm_ring_drop(s)  # dead socket: its segment dies with it
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()
        self._rings = []
        self._ring_staged.clear()
        self.cell.pop("socks", None)
        self.cell["finished"] = True


def write_parts_scatter_blocking(
    addrs: list[tuple[str, int]],
    chunk_id: int,
    version: int,
    part_ids: list[int],
    payloads: list[np.ndarray],
    lengths: list[int],
    part_offset: int = 0,
    cell: dict | None = None,
) -> None:
    """Write n whole parts (one bulk frame + ack each) in ONE
    poll-driven native exchange — the write-path mirror of
    read_parts_gather_blocking: one executor thread and one C call
    (which also runs the per-block CRC pass) replace n of each. The
    WriteInit/WriteEnd handshakes stay in Python framing (they carry
    the variable-length chain list). Raises NativeIOError on the first
    failing part; the caller falls back to per-part writes. ``cell``
    publishes the live sockets so abort_parts_scatter() can kill the
    exchange from another thread; ``cell["finished"]`` marks when this
    thread has stopped reading from ``payloads``."""
    n = len(addrs)
    assert n == len(part_ids) == len(payloads) == len(lengths)
    try:
        _write_parts_scatter(
            addrs, chunk_id, version, part_ids, payloads, lengths,
            part_offset, cell,
        )
    finally:
        if cell is not None:
            cell.pop("socks", None)
            cell["finished"] = True


def _write_parts_scatter(
    addrs, chunk_id, version, part_ids, payloads, lengths,
    part_offset, cell,
) -> None:
    n = len(addrs)
    for attempt in (0, 1):
        socks: list[tuple[tuple[str, int], socket.socket]] = []
        try:
            for i, addr in enumerate(addrs):
                s = (POOL.acquire(addr) if attempt == 0
                     else _blocking_socket(addr, 60.0))
                socks.append((addr, s))
                _send_write_init(s, chunk_id, version, part_ids[i])
            if cell is not None:
                cell["socks"] = [s for _, s in socks]
                if cell.get("aborted"):
                    raise NativeIOError(-1, "parts scatter (aborted)")
            _recv_write_init_acks([s for _, s in socks])
            reqs, ptrs, lens = _marshal_part_reqs(
                [s.fileno() for _, s in socks], chunk_id, 1, part_ids,
                payloads, lengths,
            )
            rc = _lib.lz_write_parts_scatter(
                ctypes.cast(reqs, ctypes.c_void_p), n, ptrs, lens,
                part_offset, 120_000,
            )
            if rc == 0:
                _write_end_handshake([s for _, s in socks], chunk_id)
                for addr, s in socks:
                    POOL.release(addr, s)
                socks.clear()
                return
            bad = next((int(r.rc) for r in reqs if r.rc != 0), -1)
            if attempt == 0 and bad == -1 and not (
                cell is not None and cell.get("aborted")
            ):
                continue  # stale pooled sockets: redial everything once
            raise NativeIOError(bad, "parts scatter write")
        except (ConnectionError, OSError, st.StatusError):
            if attempt == 0 and not (
                cell is not None and cell.get("aborted")
            ):
                continue  # redial once (pool may hold staled sockets)
            raise
        finally:
            for _, s in socks:
                POOL.discard(s)
