"""ctypes binding to liblizardfs_client.so for latency-critical paths.

The FUSE mount routes kernel reads through this pool: the libfuse
callback thread calls ``liz_read`` directly (ctypes drops the GIL for
the duration), so a cached small read costs one C call + one TCP round
trip to the chunkserver's native data plane — no hop through the
mount's asyncio loop thread. This is the analog of the reference FUSE
client's in-process C read path (src/mount/readdata.cc): Python stays
in control of sessions/metadata, C moves the bytes.

Handles serialize internally (one mutex per liz_t), so the pool holds
several and hands them out round-robin; a busy pool falls back to the
asyncio path rather than queueing.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading

from lizardfs_tpu_torch.core import native

# the port's build of the C client (core/native.py), built at first use
_LIB_PATH = str(native.build(native.CLIENT))

_lib = None
try:
    if os.path.exists(_LIB_PATH):
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.liz_init.restype = ctypes.c_void_p
        _lib.liz_init.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_char_p]
        _lib.liz_destroy.argtypes = [ctypes.c_void_p]
        _lib.liz_set_identity.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                          ctypes.c_uint32]
        _lib.liz_read.restype = ctypes.c_int64
        _lib.liz_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_char_p,
        ]
except OSError:
    _lib = None


def available() -> bool:
    return _lib is not None


class NativeReadPool:
    """A small pool of C client handles for direct-thread reads."""

    def __init__(self, addr_fn, password: str = "", size: int = 4):
        # addr_fn: () -> (host, port) of the CURRENT master, so handles
        # created after a failover reach the new active
        self.addr_fn = addr_fn
        self.password = password
        self.size = size
        self._handles: queue.SimpleQueue = queue.SimpleQueue()
        self._created = 0
        self._lock = threading.Lock()
        self._dead = False

    def _acquire(self):
        try:
            return self._handles.get_nowait()
        except queue.Empty:
            pass
        with self._lock:
            if self._created >= self.size or self._dead:
                return None
            self._created += 1
        try:
            host, port = self.addr_fn()
        except Exception:  # noqa: BLE001 — not connected yet
            host = None
        if not host:
            with self._lock:
                self._created -= 1
            return None
        h = _lib.liz_init(
            host.encode(), int(port),
            self.password.encode() if self.password else None,
        )
        if not h:
            with self._lock:
                self._created -= 1
            return None
        return h

    def read(self, inode: int, offset: int, size: int) -> bytes | None:
        """One direct read; None = path unavailable (caller falls back)."""
        if _lib is None or self._dead or size <= 0:
            return None
        h = self._acquire()
        if h is None:
            return None
        buf = ctypes.create_string_buffer(size)
        n = _lib.liz_read(h, inode, offset, size, buf)
        if n == -1:
            # connection-level failure (master failover, dead link):
            # retire the handle; a fresh one targets the current master
            _lib.liz_destroy(h)
            with self._lock:
                self._created -= 1
            return None
        self._handles.put(h)
        if n < 0:
            # striped/degraded file or a status error: the asyncio
            # planner path handles recovery
            return None
        return buf.raw[:n]

    def close(self) -> None:
        self._dead = True
        while True:
            try:
                h = self._handles.get_nowait()
            except queue.Empty:
                break
            _lib.liz_destroy(h)
