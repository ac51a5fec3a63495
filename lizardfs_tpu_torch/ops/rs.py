"""Golden (numpy/CPU) Reed-Solomon codec over GF(2^8).

Byte-level mirror of the reference's ``ReedSolomon<MAXK, MAXM>`` class
(reference: src/common/reed_solomon.h:41-369): ``encode`` computes m parity
parts from k data parts, ``recover`` rebuilds any subset of missing parts
from any k available parts. ``None`` input parts are treated as all-zero
(and elided from the computation, reed_solomon.h:140-145, 202-212). The
reference's NULL-output-fragment elision is expressed here by simply
omitting unneeded indices from ``wanted``.

Data parts are 1-D uint8 arrays of equal length. This path is the
correctness oracle for the CUDA kernels and the engine of the port's
``CpuChunkEncoder``.
"""

from __future__ import annotations

import numpy as np

from lizardfs_tpu_torch.ops import gf256


def _apply(matrix: np.ndarray, parts: list[np.ndarray]) -> list[np.ndarray]:
    """out[i] = XOR_j matrix[i, j] * parts[j] over GF(2^8), vectorized.

    Equivalent to ISA-L ``ec_encode_data`` with tables from ``matrix``.
    """
    if not parts:
        size = 0
    else:
        size = parts[0].shape[0]
    rows = matrix.shape[0]
    out = [np.zeros(size, dtype=np.uint8) for _ in range(rows)]
    for j, part in enumerate(parts):
        col = matrix[:, j]
        for i in range(rows):
            c = int(col[i])
            if c == 0:
                continue
            if c == 1:
                out[i] ^= part
            else:
                out[i] ^= gf256.GF_MUL_TABLE[c][part]
    return out


def encode(k: int, m: int, data_parts: list[np.ndarray | None]) -> list[np.ndarray]:
    """Compute the m parity parts of RS(k, m) from the k data parts.

    ``data_parts[i] is None`` means part i is all zeros (elided).
    Mirrors ``ReedSolomon::encode`` (reed_solomon.h:134-155).
    """
    if len(data_parts) != k:
        raise ValueError(f"expected {k} data parts, got {len(data_parts)}")
    nonzero = [i for i, p in enumerate(data_parts) if p is not None]
    if not nonzero:
        # the reference requires at least one non-zero input part
        # (reed_solomon.h:192 assert)
        raise ValueError("at least one data part must be non-None")
    sizes = {p.shape[0] for p in data_parts if p is not None}
    if len(sizes) > 1:
        raise ValueError("all parts must have equal size")
    mat = gf256.encoding_matrix(k, m)
    mat = gf256.reduce_columns(mat, nonzero)
    parts = [np.asarray(data_parts[i], dtype=np.uint8) for i in nonzero]
    return _apply(mat, parts)


def recover(
    k: int,
    m: int,
    parts: dict[int, np.ndarray | None],
    wanted: list[int],
) -> dict[int, np.ndarray]:
    """Recover ``wanted`` part indices from available ``parts``.

    ``parts`` maps global part index (0..k+m-1, data first) to its bytes;
    a present key with value ``None`` means "available and all-zero"
    (elided from computation but still counted as available, matching
    reed_solomon.h:77-80,103-110). Any k available parts suffice; if all
    k data parts are available this reduces to (re-)encoding parity
    (reed_solomon.h:113-117).
    """
    used, mat = gf256.recovery_selection(k, m, list(parts.keys()), wanted)
    nonzero_pos = [j for j, i in enumerate(used) if parts[i] is not None]
    if not nonzero_pos:
        raise ValueError("at least one available part must be non-None")
    mat = gf256.reduce_columns(mat, nonzero_pos)
    in_parts = [np.asarray(parts[used[j]], dtype=np.uint8) for j in nonzero_pos]
    out = _apply(mat, in_parts)
    return {w: out[i] for i, w in enumerate(wanted)}


def xor_parity(parts: list[np.ndarray]) -> np.ndarray:
    """XOR parity over equal-length parts (reference block_xor semantics,
    src/common/block_xor.cc:47-62)."""
    out = np.zeros_like(parts[0])
    for p in parts:
        out ^= p
    return out
