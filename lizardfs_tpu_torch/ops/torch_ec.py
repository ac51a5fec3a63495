"""Plain PyTorch versions of the erasure-coding kernels' functions.

Counterpart of the JAX package's ``ops/jax_ec.py``, in the same
formulation: a GF(2^8) matrix apply is a bit-plane GF(2) matmul followed
by ``& 1``, and a block CRC32 is a sub-block matmul plus a log-tree of
32x32 shift-matrix folds (:mod:`lizardfs_tpu_torch.ops.crc32`). These
functions run on any device. The kernel wrappers in
:mod:`lizardfs_tpu_torch.ops.cuda_ec` use them for CPU tensors, the CPU
tests hold them against the JAX package, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.

Conventions:

* byte streams are ``torch.uint8`` tensors, parts along dim 0;
* bit-plane matrices are ``torch.int8`` 0/1 tensors of shape (8w, 8r);
* CRC32 values travel as ``torch.int32`` tensors holding the uint32 bit
  pattern (PyTorch's uint32 support is thin); :func:`crc_words_to_numpy`
  and :func:`crc_words_from_numpy` convert at the numpy boundary.

Matmuls run in float32 on 0/1 operands: every partial sum is an integer
of at most 512, which float32 holds exactly (and so does TF32, whose
inputs here are exactly 0 or 1 and whose accumulation is float32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.ops import bitplane, crc32, gf256

# Sub-block size of the CRC matmul stage, as in the JAX package.
CRC_SUBBLOCK = 64
# Blocks per CRC matmul batch: bounds the float32 bit-plane temporary
# (256 x 64 KiB blocks -> 512 MiB) on large inputs.
_CRC_ROWS_PER_BATCH = 256
# Columns per GF matmul batch: bounds the float32 bit-plane temporary
# (8r x 64 Ki x 4 bytes, 8 MiB at r = 32) where a whole part's would take
# gigabytes (a rebuild's 22 MiB parts at r = 3: 2 GiB).
_GF_COLUMNS_PER_BATCH = 1 << 16


def is_block_size(block_size: int) -> bool:
    """Whether the CRC functions take blocks of ``block_size`` bytes: a
    power-of-two count of 64-byte sub-blocks (the constraint of the JAX
    package's ``block_crcs``)."""
    nsub = block_size // CRC_SUBBLOCK
    return block_size > 0 and block_size % CRC_SUBBLOCK == 0 and nsub & (nsub - 1) == 0


def check_block_size(block_size: int) -> None:
    """Raise unless :func:`is_block_size`."""
    if not is_block_size(block_size):
        raise ValueError(
            f"block_size={block_size} must be 64 bytes times a power of two"
        )


def crc_words(values: torch.Tensor) -> torch.Tensor:
    """int64 CRC values in [0, 2^32) -> int32 tensor of the same bits."""
    return torch.where(values >= 2**31, values - 2**32, values).to(torch.int32)


def crc_words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 CRC bit patterns -> numpy uint32 (copies off the device)."""
    return t.detach().cpu().numpy().view(np.uint32)


def crc_words_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy CRC values -> int32 tensor of the same bits (on the CPU)."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
    )


def _unpack_bits_rows(parts: torch.Tensor) -> torch.Tensor:
    """(r, N) uint8 -> (8r, N) float32 bit-planes; row j*8+b is bit b of part j."""
    r, n = parts.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=parts.device).view(1, 8, 1)
    bits = (parts.unsqueeze(1) >> shifts) & 1
    return bits.reshape(8 * r, n).to(torch.float32)


def _pack_bits_rows(bits: torch.Tensor) -> torch.Tensor:
    """(8w, N) int {0,1} -> (w, N) uint8, inverse of :func:`_unpack_bits_rows`."""
    w8, n = bits.shape
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device)).view(1, 8, 1)
    return (bits.view(w8 // 8, 8, n) * weights).sum(dim=1).to(torch.uint8)


def apply_gf_bitmatrix(bigm: torch.Tensor, parts: torch.Tensor) -> torch.Tensor:
    """Apply an expanded (8w, 8r) GF(2) matrix to (r, N) byte parts -> (w, N).

    The core primitive behind both encode and recover.
    """
    mat = bigm.to(torch.float32)
    out = torch.empty((bigm.shape[0] // 8, parts.shape[1]), dtype=torch.uint8,
                      device=parts.device)
    for start in range(0, parts.shape[1], _GF_COLUMNS_PER_BATCH):
        cols = slice(start, start + _GF_COLUMNS_PER_BATCH)
        acc = mat @ _unpack_bits_rows(parts[:, cols])
        out[:, cols] = _pack_bits_rows(acc.to(torch.int32) & 1)
    return out


# The JAX package jits apply_gf_bitmatrix under this name; PyTorch runs
# eagerly, so the two names are one function here.
apply_gf = apply_gf_bitmatrix


def _float_matrix(mat: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A 0/1 numpy matrix as float32 on ``dev`` (copied: the cached
    matrices are read-only)."""
    return torch.tensor(mat, dtype=torch.float32, device=dev)


def _crc_tree(partial: torch.Tensor, level_mats) -> torch.Tensor:
    """Merge (B, n, 32) sub-block registers down to (B, 32)."""
    b = partial.shape[0]
    for mat in level_mats:
        mat_t = _float_matrix(mat, partial.device).T
        partial = partial.reshape(b, -1, 2, 32)
        left = (partial[:, :, 0, :].to(torch.float32) @ mat_t).to(torch.int32) & 1
        partial = left ^ partial[:, :, 1, :]
    return partial.reshape(b, 32)


def block_crcs(blocks: torch.Tensor, block_size: int = MFSBLOCKSIZE) -> torch.Tensor:
    """CRC32 of each row of a (B, block_size) uint8 tensor -> (B,) int32 bits.

    Matmul + tree formulation of the reference's per-block ``mycrc32``.
    """
    check_block_size(block_size)
    if blocks.shape[1] != block_size:
        raise ValueError(f"rows of {blocks.shape[1]} bytes, block_size={block_size}")
    c_sub, levels, k_const = crc32.block_crc_matrices(block_size, CRC_SUBBLOCK)
    dev = blocks.device
    c_sub_t = _float_matrix(c_sub, dev).T  # (512, 32)
    nsub = block_size // CRC_SUBBLOCK
    shifts = torch.arange(8, dtype=torch.uint8, device=dev).view(1, 1, 8)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=dev)
    out = []
    for rows in blocks.split(_CRC_ROWS_PER_BATCH):
        b = rows.shape[0]
        bits = ((rows.unsqueeze(2) >> shifts) & 1).reshape(b, nsub, 8 * CRC_SUBBLOCK)
        partial = (bits.to(torch.float32) @ c_sub_t).to(torch.int32) & 1
        reg = _crc_tree(partial, levels)
        out.append((reg.to(torch.int64) * weights).sum(dim=1) ^ int(k_const))
    if not out:
        return torch.empty(0, dtype=torch.int32, device=dev)
    return crc_words(torch.cat(out))


def fused_encode_crc(
    bigm: torch.Tensor, data: torch.Tensor, block_size: int = MFSBLOCKSIZE
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Encode parity and checksum every block of data and parity.

    Args:
      bigm: (8m, 8k) expanded encoding matrix (int8).
      data: (k, N) uint8 data parts, N a multiple of block_size.
    Returns:
      (parity (m, N) uint8, data_crcs (k, N/bs) int32,
       parity_crcs (m, N/bs) int32).
    """
    k, n = data.shape
    m = bigm.shape[0] // 8
    nb = n // block_size
    parity = apply_gf_bitmatrix(bigm, data)
    data_crcs = block_crcs(data.reshape(k * nb, block_size), block_size)
    parity_crcs = block_crcs(parity.reshape(m * nb, block_size), block_size)
    return parity, data_crcs.reshape(k, nb), parity_crcs.reshape(m, nb)


def fused_decode_verify(
    bigm_rec: torch.Tensor,
    survivors: torch.Tensor,
    expected_crcs: torch.Tensor,
    block_size: int = MFSBLOCKSIZE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reconstruct the r lost parts from k survivors and verify their CRCs.

    ``bigm_rec`` is the (8r, 8k) recovery matrix; ``expected_crcs`` the
    stored (r, N/bs) block CRCs of the lost parts (int32 bits). Returns
    (recovered (r, N) uint8, crcs (r, N/bs) int32, ok (r, N/bs) bool).
    """
    r = bigm_rec.shape[0] // 8
    n = survivors.shape[1]
    recovered = apply_gf_bitmatrix(bigm_rec, survivors)
    crcs = block_crcs(recovered.reshape(r * (n // block_size), block_size), block_size)
    crcs = crcs.reshape(r, n // block_size)
    return recovered, crcs, crcs == expected_crcs


def xor_reduce(parts: torch.Tensor) -> torch.Tensor:
    """(r, N) uint8 -> (N,) XOR parity (the xor2..xor9 goal family)."""
    out = parts[0].clone()
    for row in parts[1:]:
        out ^= row
    return out


# ---------------------------------------------------------------------------
# Host-side matrix preparation, cached per geometry as in the JAX package.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def encoding_bitmatrix(k: int, m: int) -> np.ndarray:
    """Expanded (8m, 8k) encode matrix for RS(k, m)."""
    return bitplane.expand_gf_matrix(gf256.encoding_matrix(k, m))


@functools.lru_cache(maxsize=1024)
def recovery_bitmatrix(
    k: int, m: int, available: tuple[int, ...], wanted: tuple[int, ...]
) -> np.ndarray:
    """Expanded recovery matrix computing ``wanted`` from ``available``,
    with the part selection of :func:`gf256.recovery_selection`."""
    _, mat = gf256.recovery_selection(k, m, list(available), list(wanted))
    return bitplane.expand_gf_matrix(mat)
