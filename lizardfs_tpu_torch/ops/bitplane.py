"""Bit-plane expansion of GF(2^8) matrices (host-side, numpy).

A GF(2^8) multiply by a constant c is GF(2)-linear in the operand's bits:
it is an 8x8 binary matrix B_c with column j = bits of ``c * 2^j``. An RS
encode by an (m, k) GF matrix M is therefore an (8m, 8k) binary matrix
over GF(2) applied to bit-sliced data. This module builds those expanded
binary matrices; :mod:`lizardfs_tpu_torch.ops.torch_ec` applies them as a
bit-plane matmul and the CUDA kernels (``ops/csrc/ec_kernels.cu``) turn
them into split-nibble lookup tables.
"""

from __future__ import annotations

import numpy as np

from lizardfs_tpu_torch.ops import gf256


def expand_gf_matrix(m: np.ndarray) -> np.ndarray:
    """Expand an (w, r) GF(2^8) matrix to its (8w, 8r) GF(2) bit-plane form.

    Block (i, j) is the 8x8 binary matrix of multiplication by m[i, j]:
    entry (rr, cc) = bit rr of gf_mul(m[i, j], 1 << cc).
    """
    m = np.asarray(m, dtype=np.uint8)
    w, r = m.shape
    basis = (1 << np.arange(8, dtype=np.uint8))  # 2^cc
    # prod[i, j, cc] = m[i, j] * 2^cc in GF(2^8)
    prod = gf256.GF_MUL_TABLE[m[:, :, None], basis[None, None, :]]
    # bits[i, j, cc, rr] = bit rr of prod
    bits = (prod[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    # -> [i, rr, j, cc] -> (8w, 8r)
    # the reshape is a strided view when w == 1: copy to C order so the
    # matrix can go to a kernel as it is
    out = bits.transpose(0, 3, 1, 2).reshape(8 * w, 8 * r)
    return np.ascontiguousarray(out, dtype=np.int8)
