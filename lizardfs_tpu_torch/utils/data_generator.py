"""Deterministic offset-addressable data generator.

The port's copy of the JAX package's ``utils/data_generator.py`` (tests pin the two
together).

The reference validates file contents with generators whose byte at
offset i is a pure function of i (reference: utils/data_generator.h),
so any range can be checked without storing the original. Same idea:
byte(i) = low byte of a Weyl-sequence mix of the 64-bit offset.
"""

from __future__ import annotations

import numpy as np

_MUL = np.uint64(0x9E3779B97F4A7C15)


def generate(offset: int, size: int) -> np.ndarray:
    """Deterministic uint8 array for [offset, offset+size)."""
    idx = np.arange(offset, offset + size, dtype=np.uint64)
    x = idx * _MUL
    x ^= x >> np.uint64(29)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(32)
    return (x & np.uint64(0xFF)).astype(np.uint8)


def validate(offset: int, data: np.ndarray) -> bool:
    return bool(np.array_equal(np.asarray(data, dtype=np.uint8), generate(offset, len(data))))
