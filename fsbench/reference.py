"""The plain reference: what the cluster should answer, worked out from
the benchmark's own inputs with numpy alone, and where LizardFS's chunk
format puts a chunk's parts. It imports nothing of the program.

* A read of a data set's file answers the bytes that were written there:
  file ``f`` of ``file_bytes`` holds bytes ``[f * file_bytes, (f + 1) *
  file_bytes)`` of the input pool.
* Chunks are 64 MiB of 64 KiB blocks; a part id is ``slice_type * 64 +
  part`` (``slice_traits.h``); a chunkserver stores a part as
  ``<folder>/<chunk id & 0xFF>/chunk_<id>_P<part id>_<version>.liz``.
"""

from __future__ import annotations

import os

import numpy as np

BLOCK = 64 * 1024
CHUNK = BLOCK * 1024


def expected(pool: np.ndarray, file_bytes: int, f: int, offset: int, size: int) -> np.ndarray:
    """The bytes a read of ``size`` at ``offset`` of file ``f`` answers."""
    base = f * file_bytes + offset
    return pool[base:base + min(size, file_bytes - offset)]


def ec_part(part_id: int) -> int:
    """The part's index in its stripe: data parts first, then parity."""
    return part_id % 64


def part_path(folder: str, chunk_id: int, pid: int, version: int) -> str:
    return os.path.join(
        folder, f"{chunk_id & 0xFF:02X}",
        f"chunk_{chunk_id:016X}_P{pid:08X}_{version:08X}.liz",
    )
