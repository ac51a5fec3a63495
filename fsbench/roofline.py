"""The yardstick of the kernels: the card's published peaks and the bytes
each call through the encoder seam needs, counted from its arguments.

Every recovery through the seam is a GF apply, bound by memory: it reads
each input row once and writes each output row once, one GF multiply-add
a byte of input and output row, far under the FLOP peak. So its least time is its
bytes over the card's memory rate. The count is the algorithm's, whatever
the implementation stages: ``recover`` needs k survivors, however many it
is handed.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM5 80 GB (700 W): HBM3 rate in bytes/s
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def peak_bytes_per_s(kind: str) -> float:
    return PEAK_BYTES_PER_S.get(kind, PEAK_BYTES_PER_S[DEFAULT_KIND])


def recover_bytes(k: int, available: int, wanted: int, row_bytes: int) -> int:
    """A recovery of ``wanted`` rows from ``available`` non-elided rows:
    k survivors read (fewer where fewer are not zeros), the rows recovered
    written."""
    return (min(k, available) + wanted) * row_bytes


def bound_s(nbytes: int, kind: str) -> float:
    return nbytes / peak_bytes_per_s(kind)
