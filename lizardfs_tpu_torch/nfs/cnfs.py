"""ctypes binding to the native C NFSv3 client (liblizardfs_client.so).

The non-Python measuring client for the NFS gateway (VERDICT: the
gateway had only ever been measured with the asyncio wire client, so
server cost and measuring-client cost were confounded). The whole RPC
stack — ONC-RPC record marking, AUTH_SYS, NFS3 XDR — lives in C
(native/client_native.cpp); Python only marshals buffers, and ctypes
drops the GIL for the duration of each blocking call, so a bench can
drive the gateway from a worker thread without the client's event loop
in the measurement.
"""

from __future__ import annotations

import ctypes
import os

from lizardfs_tpu_torch.core import native

# LZ_CLIENT_SO: alternate library path, mirroring LZ_NATIVE_SO — the
# sanitizer matrix (`make sanitize`) points it at the ASan+UBSan build
# so the C NFS client runs instrumented under the real Python gateway;
# else the port's build of the C client (core/native.py)
_LIB_PATH = os.environ.get("LZ_CLIENT_SO") or str(native.build(native.CLIENT))

_lib = None
try:
    if os.path.exists(_LIB_PATH):
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.liz_nfs_connect.restype = ctypes.c_void_p
        _lib.liz_nfs_connect.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ]
        _lib.liz_nfs_close.argtypes = [ctypes.c_void_p]
        _fh = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
        _lib.liz_nfs_mount.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        for fn in (_lib.liz_nfs_lookup, _lib.liz_nfs_create):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint32),
            ]
        _lib.liz_nfs_read.restype = ctypes.c_int64
        _lib.liz_nfs_read.argtypes = _fh + [
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_char_p,
        ]
        _lib.liz_nfs_write.restype = ctypes.c_int64
        _lib.liz_nfs_write.argtypes = _fh + [
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int,
        ]
        _lib.liz_nfs_commit.argtypes = _fh
except (OSError, AttributeError):
    # unloadable .so, or one built before liz_nfs_* existed (ctypes
    # raises AttributeError for a missing symbol): the C row just
    # doesn't run
    _lib = None


def available() -> bool:
    """True when the .so exists and exports the NFS client symbols."""
    return _lib is not None and hasattr(_lib, "liz_nfs_connect")


class CNfs3Error(OSError):
    pass


class CNfs3Client:
    """Blocking NFS3 client over one TCP connection — all wire work in
    C. Use from a worker thread (calls block; the GIL is released)."""

    def __init__(self, host: str, port: int, uid: int = 0, gid: int = 0):
        if not available():
            raise CNfs3Error("liblizardfs_client.so missing liz_nfs_*")
        self._h = _lib.liz_nfs_connect(host.encode(), port, uid, gid)
        if not self._h:
            raise CNfs3Error(f"cannot connect to {host}:{port}")

    def close(self) -> None:
        if self._h:
            _lib.liz_nfs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _fh_call(self, fn, *args) -> bytes:
        out = ctypes.create_string_buffer(64)
        n = ctypes.c_uint32(0)
        rc = fn(self._h, *args, out, ctypes.byref(n))
        if rc != 0:
            raise CNfs3Error(f"nfs error {rc}")
        return out.raw[: n.value]

    def mnt(self, path: str = "/") -> bytes:
        return self._fh_call(_lib.liz_nfs_mount, path.encode())

    def lookup(self, dirfh: bytes, name: str) -> bytes:
        return self._fh_call(
            _lib.liz_nfs_lookup, dirfh, len(dirfh), name.encode()
        )

    def create(self, dirfh: bytes, name: str) -> bytes:
        return self._fh_call(
            _lib.liz_nfs_create, dirfh, len(dirfh), name.encode()
        )

    def write(self, fh: bytes, offset: int, data: bytes,
              stable: int = 0) -> int:
        n = _lib.liz_nfs_write(
            self._h, fh, len(fh), offset, len(data), data, stable
        )
        if n < 0:
            raise CNfs3Error(f"nfs write error {n}")
        return int(n)

    def read(self, fh: bytes, offset: int, count: int) -> bytes:
        buf = ctypes.create_string_buffer(count)
        n = _lib.liz_nfs_read(self._h, fh, len(fh), offset, count, buf)
        if n < 0:
            raise CNfs3Error(f"nfs read error {n}")
        return buf.raw[: int(n)]

    def commit(self, fh: bytes) -> None:
        rc = _lib.liz_nfs_commit(self._h, fh, len(fh))
        if rc != 0:
            raise CNfs3Error(f"nfs commit error {rc}")
