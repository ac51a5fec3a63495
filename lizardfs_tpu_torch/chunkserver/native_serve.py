"""Lifecycle wrapper for the native C++ data-plane server.

``native/serve_native.cpp`` runs the chunkserver's data hot path —
accept loop, frame parsing, block IO with CRC maintenance, write-chain
forwarding — entirely in C++ threads (the network_worker_thread.cc
analog; reference src/chunkserver/network_worker_thread.cc:402-755).
The asyncio ``ChunkServer`` starts one listener here, registers its port
with the master as ``data_port``, and the master hands that address out
in part locations; the asyncio server on the control port remains the
portable fallback and the control plane.

Coherence with the Python ``ChunkStore``:
  * part files are created/deleted/versioned by the Python store on
    master commands; the C++ plane resolves paths per request, so
    renames (set_version) and deletes take effect immediately,
  * block reads/writes on BOTH planes take an ``flock`` on the chunk
    file (shared/exclusive), so the chunk tester never sees torn blocks.
"""

from __future__ import annotations

import ctypes

from lizardfs_tpu_torch.core import native as _native_lib

_lib = _native_lib._load()
if _lib is not None:
    try:
        _lib.lz_serve_start.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int
        ]
        _lib.lz_serve_start.restype = ctypes.c_int
        _lib.lz_serve_port.argtypes = [ctypes.c_int]
        _lib.lz_serve_port.restype = ctypes.c_int
        _lib.lz_serve_stop.argtypes = [ctypes.c_int]
        _lib.lz_serve_stop.restype = None
        _lib.lz_serve_stats.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)
        ]
        _lib.lz_serve_stats.restype = None
        try:
            _lib.lz_serve_stats2.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)
            ]
            _lib.lz_serve_stats2.restype = None
            _lib.lz_serve_trace.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
            ]
            _lib.lz_serve_trace.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: per-op timing/trace channel stays off
        try:
            _lib.lz_serve_trace2.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
            ]
            _lib.lz_serve_trace2.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: session attribution rides trace as 0
        try:
            _lib.lz_serve_trace3.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
            ]
            _lib.lz_serve_trace3.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so: queue-wait slot drains as 0
        try:
            _lib.lz_serve_shm_stats.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)
            ]
            _lib.lz_serve_shm_stats.restype = None
        except AttributeError:
            pass  # stale .so: shm ring counters stay off
        try:
            _lib.lz_serve_qos_set.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ]
            _lib.lz_serve_qos_set.restype = ctypes.c_int
            _lib.lz_serve_qos_deferrals.argtypes = [ctypes.c_int]
            _lib.lz_serve_qos_deferrals.restype = ctypes.c_uint64
        except AttributeError:
            pass  # stale .so: native plane stays unpaced (QoS fails open)
    except AttributeError:
        _lib = None


# lz_serve_trace3 flattens one op to 10 u64 slots (lz_serve_trace2
# serves 9, eliding queue_us; the legacy lz_serve_trace serves 8, also
# eliding session_id) — keep in sync with serve_native.cpp TraceOp
TRACE_OP_SLOTS = 10
_TRACE_KINDS = {1: "cs_read", 2: "cs_read_bulk", 4: "cs_write_bulk",
                5: "cs_write_shm"}


def available() -> bool:
    return _lib is not None


class DataPlaneServer:
    """One native data-plane listener bound to a set of data folders."""

    def __init__(self, folders: list[str], host: str = "127.0.0.1",
                 port: int = 0):
        if _lib is None:
            raise RuntimeError("native serve library unavailable")
        blob = "\n".join(folders).encode()
        self._handle = _lib.lz_serve_start(blob, host.encode(), port)
        if self._handle < 0:
            raise RuntimeError("lz_serve_start failed")
        self.port = _lib.lz_serve_port(self._handle)

    def stats(self) -> dict[str, int]:
        """v1 counters plus, when the .so exports stats v2, per-op
        accumulated disk/net microseconds per direction — the native
        per-op counters folded into the chunkserver's Metrics registry."""
        if hasattr(_lib, "lz_serve_stats2"):
            out = (ctypes.c_uint64 * 8)()
            _lib.lz_serve_stats2(self._handle, out)
            return {
                "bytes_read": out[0],
                "bytes_written": out[1],
                "read_ops": out[2],
                "write_ops": out[3],
                "read_disk_us": out[4],
                "read_net_us": out[5],
                "write_disk_us": out[6],
                "write_net_us": out[7],
            }
        out = (ctypes.c_uint64 * 4)()
        _lib.lz_serve_stats(self._handle, out)
        return {
            "bytes_read": out[0],
            "bytes_written": out[1],
            "read_ops": out[2],
            "write_ops": out[3],
        }

    def shm_stats(self) -> dict[str, int]:
        """Shared-memory ring plane counters (shm_ring.h proactor):
        segments mapped, descriptor ops landed, payload bytes moved via
        ring, and currently active mappings. Zeros on a stale .so."""
        if not hasattr(_lib, "lz_serve_shm_stats") or self._handle < 0:
            return {"segments_mapped": 0, "desc_ops": 0, "bytes": 0,
                    "active_segments": 0}
        out = (ctypes.c_uint64 * 4)()
        _lib.lz_serve_shm_stats(self._handle, out)
        return {
            "segments_mapped": out[0],
            "desc_ops": out[1],
            "bytes": out[2],
            "active_segments": out[3],
        }

    def trace_ops(self, max_ops: int = 1024) -> list[dict]:
        """Drain the native per-op trace ring: one dict per traced op
        with CLOCK_REALTIME second bounds (t0/t1), accumulated disk/net
        microseconds, the originating session id, and (trace3 .so) the
        op's QoS queue-wait microseconds, ready to fold into a
        SpanRing + per-session accounting."""
        if self._handle < 0:
            return []
        # version-skew tolerant drain: prefer the 10-slot channel (adds
        # queue_us), then the 9-slot one (session_id), then the legacy
        # 8-slot one on a stale .so
        if hasattr(_lib, "lz_serve_trace3"):
            slots, fn = TRACE_OP_SLOTS, _lib.lz_serve_trace3
        elif hasattr(_lib, "lz_serve_trace2"):
            slots, fn = 9, _lib.lz_serve_trace2
        elif hasattr(_lib, "lz_serve_trace"):
            slots, fn = 8, _lib.lz_serve_trace
        else:
            return []
        out = (ctypes.c_uint64 * (slots * max_ops))()
        n = fn(self._handle, out, max_ops)
        ops = []
        for i in range(n):
            s = out[slots * i : slots * (i + 1)]
            ops.append({
                "name": _TRACE_KINDS.get(int(s[0]), f"cs_op_{int(s[0])}"),
                "trace_id": int(s[1]),
                "chunk_id": int(s[2]),
                "bytes": int(s[3]),
                "t0": s[4] / 1e6,
                "t1": s[5] / 1e6,
                "disk_us": int(s[6]),
                "net_us": int(s[7]),
                "session_id": int(s[8]) if slots > 8 else 0,
                "queue_us": int(s[9]) if slots > 9 else 0,
            })
        return ops

    def qos_set(self, budgets: dict[int, int]) -> bool:
        """Replace the native plane's per-session byte-rate budget
        table (multi-tenant QoS; master-pushed via heartbeat acks).
        The epoll proactor defers over-budget descriptor drains and
        the threaded read/write paths pace with bounded sleeps. Returns
        False on a stale .so — the native plane then simply stays
        unpaced (QoS fails open, never into a lockout)."""
        if not hasattr(_lib, "lz_serve_qos_set") or self._handle < 0:
            return False
        n = len(budgets)
        sids = (ctypes.c_uint64 * max(n, 1))(*budgets.keys())
        bps = (ctypes.c_uint64 * max(n, 1))(*budgets.values())
        return _lib.lz_serve_qos_set(self._handle, sids, bps, n) == 0

    def qos_deferrals(self) -> int:
        """Data-plane ops paced/deferred by the QoS budgets."""
        if not hasattr(_lib, "lz_serve_qos_deferrals") or self._handle < 0:
            return 0
        return int(_lib.lz_serve_qos_deferrals(self._handle))

    def stop(self) -> None:
        if self._handle >= 0:
            _lib.lz_serve_stop(self._handle)
            self._handle = -1
