"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

The sources have a plain C interface and include no PyTorch header, so
one ``nvcc`` call builds them in seconds. The library goes
into ``build/`` beside this file (listed in ``.gitignore``), named by a
hash of the sources and the flags, and is built at first use:
importing this module builds nothing. ``-Xptxas -v`` makes the build
report each kernel's registers, shared memory and spills; :func:`build`
passes that report through to standard error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LOCK = threading.Lock()  # one build at a time in a process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit is"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libec_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources into the shared library; a no-op when it exists.
    Threads of one process build once (the temporary file is named by the
    process); processes each build their own and the last rename wins."""
    with _LOCK:
        return _build()


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}")
    sys.stderr.write(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    signatures = {
        "lz_resident": [i32, i32, i32, i32, i32],
        "lz_gf_apply": [ptr, ptr, ptr, i32, i32, i64, i32, i32, i32, ptr],
        "lz_block_crcs": [ptr, i64, i32, i32, i32, i32, ptr, ptr, i32, ptr, u32, i32, ptr, ptr,
                          ptr],
        "lz_fused_encode_crc": [
            ptr, ptr, i32, i32, i64, i32, i32, i32, ptr, ptr, i32, ptr, u32, i32,
            ptr, ptr, ptr, ptr, ptr, ptr,
        ],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
