"""GF(2^8) arithmetic and Reed-Solomon matrix machinery (numpy, host-side).

This is the *golden* CPU implementation of the field math used by the
erasure-coding data plane. It is numerically identical to the reference's
codec (reference: src/common/galois_field_isal.cc, src/common/reed_solomon.h):

  * field GF(2^8) with reduction polynomial 0x11d (same as Intel ISA-L),
  * log/exp tables with generator 2,
  * Vandermonde generator matrix (``gen_rs_matrix``) for small parity
    counts, Cauchy-1 matrix (``gen_cauchy1_matrix``) for m >= 5 or
    (m == 4 and k > 20) — the selection rule at reed_solomon.h:168-172,
  * Gauss-Jordan inversion over the field,
  * zero-input column elision and needed-output row selection semantics of
    ``ReedSolomon::createEncodingMatrix`` / ``createRecoveryMatrix``.

Everything here is small host-side matrix work (k, m <= 32); the bulk data
path applies these matrices either with the vectorized numpy kernel in
:mod:`lizardfs_tpu_torch.ops.rs`, the plain PyTorch bit-plane path in
:mod:`lizardfs_tpu_torch.ops.torch_ec`, or the CUDA kernels behind
:mod:`lizardfs_tpu_torch.ops.cuda_ec`.
"""

from __future__ import annotations

import functools

import numpy as np

from lizardfs_tpu_torch.constants import GF_POLY


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """Build log/exp tables for GF(2^8) with generator 2, poly 0x11d."""
    exp = np.zeros(256, dtype=np.uint8)  # exp[i] = 2^i; exp[255] aliases exp[0] (gf_inv(1) reads it)
    log = np.zeros(256, dtype=np.uint8)  # log[x] for x != 0; log[0] meaningless
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255] = exp[0]  # convenience wrap (2^255 == 2^0)
    return log, exp


GF_LOG, GF_EXP = _build_tables()

# Full 256x256 multiplication table; 64 KiB, used to vectorize the golden
# data path and to generate bit-plane matrices.
def _build_mul_table() -> np.ndarray:
    logs = GF_LOG.astype(np.int32)
    s = logs[:, None] + logs[None, :]
    s = np.where(s > 254, s - 255, s)
    t = GF_EXP[s]
    t[0, :] = 0
    t[:, 0] = 0
    return t.astype(np.uint8)


GF_MUL_TABLE = _build_mul_table()


def gf_mul(a, b):
    """Multiply in GF(2^8); accepts scalars or numpy arrays (broadcasting)."""
    return GF_MUL_TABLE[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]


def gf_inv(a: int) -> int:
    """Multiplicative inverse; gf_inv(0) == 0 by ISA-L convention."""
    if a == 0:
        return 0
    return int(GF_EXP[255 - int(GF_LOG[a])])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gen_rs_matrix(rows: int, k: int) -> np.ndarray:
    """Vandermonde-style generator matrix, shape (rows, k).

    Identity on the first k rows; parity row r (0-based among parity rows)
    has entries gen^j where gen = 2^r, matching ISA-L ``gf_gen_rs_matrix``
    (reference: src/common/galois_field_isal.cc:53-69).
    """
    a = np.zeros((rows, k), dtype=np.uint8)
    for i in range(k):
        a[i, i] = 1
    gen = 1
    for i in range(k, rows):
        p = 1
        for j in range(k):
            a[i, j] = p
            p = int(gf_mul(p, gen))
        gen = int(gf_mul(gen, 2))
    return a


def gen_cauchy1_matrix(rows: int, k: int) -> np.ndarray:
    """Cauchy generator matrix, shape (rows, k): identity top, then
    a[i, j] = inv(i ^ j) (reference: galois_field_isal.cc:71-85)."""
    a = np.zeros((rows, k), dtype=np.uint8)
    for i in range(k):
        a[i, i] = 1
    for i in range(k, rows):
        for j in range(k):
            a[i, j] = gf_inv(i ^ j)
    return a


@functools.lru_cache(maxsize=None)
def rs_generator_matrix(k: int, m: int) -> np.ndarray:
    """(k+m, k) generator matrix with the reference's Vandermonde/Cauchy
    selection rule (reed_solomon.h:168-172). Cached per (k, m)."""
    if m >= 5 or (m == 4 and k > 20):
        a = gen_cauchy1_matrix(k + m, k)
    else:
        a = gen_rs_matrix(k + m, k)
    a.setflags(write=False)
    return a


def gf_invert_matrix(mat: np.ndarray) -> np.ndarray:
    """Invert an (n, n) matrix over GF(2^8) by Gauss-Jordan elimination.

    Raises ValueError if singular. Pivot/elimination order matches the
    reference (galois_field_isal.cc:87-139) — with exact arithmetic the
    result is order-independent, but we mirror it anyway.
    """
    n = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    out = np.eye(n, dtype=np.uint8)
    for i in range(n):
        if a[i, i] == 0:
            for j in range(i + 1, n):
                if a[j, i]:
                    a[[i, j]] = a[[j, i]]
                    out[[i, j]] = out[[j, i]]
                    break
            else:
                raise ValueError("singular matrix in GF(2^8) inversion")
        piv = gf_inv(int(a[i, i]))
        a[i] = gf_mul(a[i], piv)
        out[i] = gf_mul(out[i], piv)
        for j in range(n):
            if j == i:
                continue
            f = int(a[j, i])
            if f:
                a[j] ^= gf_mul(f, a[i])
                out[j] ^= gf_mul(f, out[i])
    return out


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): XOR-accumulated gf_mul."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    # products[i, j, l] = a[i, l] * b[l, j]
    prod = GF_MUL_TABLE[a[:, None, :], b.T[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=2)


def encoding_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) matrix computing all parity parts from all data parts."""
    return rs_generator_matrix(k, m)[k:, :]


def recovery_matrix(
    k: int,
    m: int,
    available: list[int],
    wanted: list[int],
) -> np.ndarray:
    """Matrix computing ``wanted`` parts from ``available`` parts.

    Parts are globally indexed 0..k+m-1 (data first, then parity). Exactly
    k available parts must be given (any k suffice). Mirrors
    ``ReedSolomon::createRecoveryMatrix`` (reed_solomon.h:229-281):
    invert the k rows of the generator matrix for the available parts,
    then (for wanted parity parts) multiply by the wanted generator rows;
    wanted data parts select rows of the inverse directly.

    Returns shape (len(wanted), k); columns ordered by ascending available
    part index (the caller feeds parts in that order).
    """
    if len(available) != k:
        raise ValueError(f"need exactly {k} available parts, got {len(available)}")
    gen = rs_generator_matrix(k, m)
    avail = sorted(available)
    sub = gen[avail, :]  # (k, k) computes available parts from data parts
    decode = gf_invert_matrix(sub)  # computes data parts from available parts
    wanted = list(wanted)
    if all(w < k for w in wanted):
        # recover_only_data path: select rows of the inverse.
        return decode[wanted, :]
    need_rows = gen[wanted, :]  # (w, k) computes wanted parts from data parts
    return gf_matmul(need_rows, decode)


def recovery_selection(
    k: int, m: int, available: list[int], wanted: list[int]
) -> tuple[list[int], np.ndarray]:
    """Choose which available parts to read and the matrix to apply.

    The single source of truth for the reference's recover-dispatch rule
    (reed_solomon.h:97-117): if all k data parts are available, wanted
    (parity) parts are re-encoded straight from data; otherwise the first
    k available parts feed an inverted recovery matrix. Returns
    (used_part_indices, (len(wanted), k) GF matrix over those parts).
    Both the CPU and CUDA backends derive their kernels from this helper,
    keeping them byte-identical by construction.
    """
    avail = sorted(available)
    data_avail = [i for i in avail if i < k]
    if len(data_avail) == k:
        return data_avail, rs_generator_matrix(k, m)[list(wanted), :]
    if len(avail) < k:
        raise ValueError(f"need {k} parts to recover, have {len(avail)}")
    used = avail[:k]
    return used, recovery_matrix(k, m, used, list(wanted))


def reduce_columns(matrix: np.ndarray, nonzero_inputs: list[int]) -> np.ndarray:
    """Drop columns whose inputs are known-zero (zero-part elision,
    reed_solomon.h:202-212). ``nonzero_inputs`` indexes into the matrix's
    column order."""
    return matrix[:, sorted(nonzero_inputs)]
