"""The benchmark's inputs: bytes made from ``--seed``.

Byte ``i`` of a seed's stream is a pure function of ``i`` and the seed
(a Weyl-sequence mix of the 64-bit offset, the idea of the reference's
``utils/data_generator.h``), so any range can be made anew on the host
to check it. The card makes the bulk of it in one call
(:func:`stream_torch`); :func:`stream_numpy` is the same function on the
host, which the tests hold it to.
"""

from __future__ import annotations

import numpy as np

_MUL = 0x9E3779B97F4A7C15
_MIX = 0xBF58476D1CE4E5B9
_MASK64 = (1 << 64) - 1


def base_offset(seed: int) -> int:
    """Where a seed's stream starts in the generator's 2**64 offsets:
    seeds 2**24 apart or less never share a byte of a stream shorter than
    2**40 bytes."""
    return (int(seed) * (1 << 40)) & _MASK64


def stream_numpy(seed: int, offset: int, size: int) -> np.ndarray:
    """Bytes ``[offset, offset + size)`` of ``seed``'s stream."""
    start = (base_offset(seed) + offset) & _MASK64
    idx = np.arange(size, dtype=np.uint64) + np.uint64(start)
    x = idx * np.uint64(_MUL)
    x ^= x >> np.uint64(29)
    x *= np.uint64(_MIX)
    x ^= x >> np.uint64(32)
    return (x & np.uint64(0xFF)).astype(np.uint8)


def _signed(v: int) -> int:
    v &= _MASK64
    return v - (1 << 64) if v >= 1 << 63 else v


def stream_torch(seed: int, offset: int, size: int, device) -> "torch.Tensor":
    """:func:`stream_numpy` computed on ``device`` in int64 (the same bits:
    products wrap, and a right shift is made logical by a mask)."""
    import torch

    start = _signed(base_offset(seed) + offset)
    x = torch.arange(size, dtype=torch.int64, device=device).add_(start)
    x.mul_(_signed(_MUL))
    x.bitwise_xor_((x >> 29) & ((1 << 35) - 1))
    x.mul_(_signed(_MIX))
    x.bitwise_xor_((x >> 32) & ((1 << 32) - 1))
    return (x & 0xFF).to(torch.uint8)


def make_pool(seed: int, size: int, device, chunk: int = 1 << 24) -> np.ndarray:
    """``size`` bytes of ``seed``'s stream in host memory, made on
    ``device`` in calls of ``chunk`` bytes (bounding the int64 temporaries
    to a few hundred MiB)."""
    out = np.empty(size, dtype=np.uint8)
    for a in range(0, size, chunk):
        b = min(a + chunk, size)
        out[a:b] = stream_torch(seed, a, b - a, device).cpu().numpy()
    return out
