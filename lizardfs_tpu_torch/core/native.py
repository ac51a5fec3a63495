"""The native C++ data plane's libraries, built from ``native/``, and
their host stripe helpers.

The port builds its own copies of the two libraries ``native/Makefile``
makes, from the unchanged sources, with the Makefile's source lists and
flags, at first use:

* the data plane (``ec_native.cpp io_native.cpp serve_native.cpp``):
  the chunkserver's listener (``chunkserver/native_serve.py``), the
  client's part exchanges and shared-memory ring (``core/native_io.py``)
  and the stripe helpers below;
* the C client (``client_native.cpp io_native.cpp ec_native.cpp``): the
  FUSE mount's read pool (``client/native_client.py``) and the C NFSv3
  measuring client (``nfs/cnfs.py``).

Each library goes into ``ops/build/`` (listed in ``.gitignore``), named
by a hash of its sources, the headers and the flags. The build compiles
the sources in parallel under a file lock and renames its output into
place, so processes that start together build once. A failed build
raises with the compiler's message. The ``.so`` files that
``make -C native`` leaves in ``native/`` are never loaded nor written:
they may predate the sources, and other processes may have them mapped.
``LZ_NATIVE_SO`` and ``LZ_CLIENT_SO`` load another build instead (the
sanitizer builds of ``native/Makefile``).

The CPU GF(2^8) and CRC bindings of the libraries, and an encoder over
them, are left out: the port's encoder runs on the card
(``core/encoder.py``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "build"
CXX = "g++"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")  # native/Makefile:2
DATA_PLANE = "libec_native"
CLIENT = "liblizardfs_client"
SOURCES = {  # native/Makefile:8-14
    DATA_PLANE: ("ec_native.cpp", "io_native.cpp", "serve_native.cpp"),
    CLIENT: ("client_native.cpp", "io_native.cpp", "ec_native.cpp"),
}


def library_path(name: str) -> Path:
    """Where ``name``'s build goes: named by a hash of its sources, every
    header of ``native/`` and the flags."""
    h = hashlib.sha256(" ".join((CXX, *CXXFLAGS)).encode())
    for src in (*SOURCES[name], *sorted(p.name for p in NATIVE_DIR.glob("*.h"))):
        h.update(src.encode())
        h.update((NATIVE_DIR / src).read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Build library ``name`` (a key of :data:`SOURCES`) unless it exists;
    return its path. Raises ``RuntimeError`` with the compiler's message
    when a step fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = Path(tempfile.mkdtemp(prefix=f"{name}.", dir=BUILD_DIR))
        try:
            objs = [tmp / f"{Path(src).stem}.o" for src in SOURCES[name]]
            compiles = [
                ([CXX, *CXXFLAGS, "-c", "-o", str(obj), str(NATIVE_DIR / src)], obj)
                for src, obj in zip(SOURCES[name], objs)
            ]
            procs = [
                (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd, _ in compiles
            ]
            for cmd, proc in procs:
                output = proc.communicate()[0]
                _check(cmd, proc.returncode, output)
            lib = tmp / out.name
            cmd = [CXX, *CXXFLAGS, "-shared", "-o", str(lib), *map(str, objs), "-lpthread"]
            res = subprocess.run(cmd, capture_output=True, text=True)
            _check(cmd, res.returncode, res.stdout + res.stderr)
            os.replace(lib, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def _check(cmd: list[str], rc: int, output: str) -> None:
    if rc:
        raise RuntimeError(f"native build failed: {' '.join(cmd)} ({rc}):\n{output}")


def _load() -> ctypes.CDLL:
    """The data plane library: ``LZ_NATIVE_SO`` when set, else the port's
    build (built first if needed), with the stripe helpers' signatures."""
    path = os.environ.get("LZ_NATIVE_SO") or str(build(DATA_PLANE))
    lib = ctypes.CDLL(os.path.abspath(path))
    lib.lz_stripe_scatter.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.lz_stripe_scatter.restype = None
    lib.lz_stripe_gather.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint32,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.lz_stripe_gather.restype = None
    return lib


_lib = _load()


def available() -> bool:
    return _lib is not None


def _ptr_array(arrays: list[np.ndarray]) -> ctypes.Array:
    ptrs = (ctypes.c_void_p * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p).value
    return ptrs


def stripe_helpers_available() -> bool:
    return _lib is not None and hasattr(_lib, "lz_stripe_scatter")


def stripe_scatter(
    data: np.ndarray, d: int, blocks_per_part: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """(nbytes,) chunk bytes -> (d, part_len) zero-padded part streams
    in one contiguous buffer, via the GIL-free native kernel. ``out``
    lets hot paths reuse a staging buffer (a fresh 64 MiB allocation
    pays its page faults inside the copy)."""
    assert stripe_helpers_available()
    part_len = blocks_per_part * MFSBLOCKSIZE
    if out is None:
        out = np.empty((d, part_len), dtype=np.uint8)
    assert (
        out.flags.c_contiguous and out.dtype == np.uint8
        and out.shape == (d, part_len)
    )
    data = np.ascontiguousarray(data, dtype=np.uint8)
    _lib.lz_stripe_scatter(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        data.shape[0], d, blocks_per_part,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def stripe_gather(
    parts: list[np.ndarray], nbytes: int, out: np.ndarray | None = None
) -> np.ndarray:
    """d part streams (each contiguous, long enough to cover its share
    of ``nbytes``) -> (nbytes,) chunk bytes, no intermediate stacking."""
    assert stripe_helpers_available()
    srcs = [np.ascontiguousarray(p, dtype=np.uint8) for p in parts]
    if out is None:
        out = np.empty(nbytes, dtype=np.uint8)
    assert out.flags.c_contiguous and out.shape[0] >= nbytes
    _lib.lz_stripe_gather(
        _ptr_array(srcs), len(srcs), nbytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out
