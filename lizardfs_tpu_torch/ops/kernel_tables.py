"""Host-built tables of the fused encode + CRC kernel (``csrc/ec_kernels.cu``).

Every table the fused kernel and its CRC fold read is built here with
numpy, once per matrix or shift amount, and copied to the card by
:mod:`lizardfs_tpu_torch.ops.cuda_ec`. Each CTA then copies them into
shared memory with 16-byte loads; no CTA derives a table itself.

* :func:`packed_gf_tables`: for each group of four output rows and each
  input row j, 16 ``lo`` words and 16 ``hi`` words in one aligned run of
  32. Byte g of ``lo[n]`` is the GF(2^8) product of output row 4q+g's
  coefficient for row j with the nibble n, of ``hi[n]`` the same with
  n << 4. One 32-bit lookup pair then serves four output rows.
* :func:`crc_slicing_tables`: the slicing-by-8 CRC32 tables.
* :func:`shift_nibble_tables`: S^n (the raw CRC register shifted by n
  zero bytes, :func:`crc32.shift_matrix`) as 8 tables of 16 words,
  ``N[q][x] = S^n (x << 4q)``, so that S^n v is the XOR of 8 lookups.

All tables are uint32 arrays; the wrapper hands them to the card as
int32 tensors of the same bits.
"""

from __future__ import annotations

import functools

import numpy as np

from lizardfs_tpu_torch.ops import crc32

ROWS_PER_GROUP = 4  # output rows packed into one 32-bit table word
WORDS_PER_ROW = 32  # 16 lo + 16 hi words per (group, input row)
NIBBLES = 8  # nibbles of a 32-bit CRC register


def nibble_products(bigm: np.ndarray) -> np.ndarray:
    """(w, r, 2, 16) uint8 products from an (8w, 8r) bit-plane matrix.

    ``[i, j, 0, n]`` is output i's coefficient for input j times the byte
    n, ``[i, j, 1, n]`` times n << 4: the XOR of the matrix's column
    bytes that the set bits of the nibble select.
    """
    bits = np.asarray(bigm, dtype=np.uint8) & 1
    w8, r8 = bits.shape
    if w8 % 8 or r8 % 8:
        raise ValueError(f"bit-plane matrix shape {bits.shape} is not (8w, 8r)")
    w, r = w8 // 8, r8 // 8
    planes = bits.reshape(w, 8, r, 8)  # [i, output bit, j, input bit]
    weights = (1 << np.arange(8, dtype=np.uint8)).reshape(1, 8, 1, 1)
    colbytes = (planes * weights).sum(axis=1, dtype=np.uint8)  # (w, r, 8)
    select = (np.arange(16)[:, None] >> np.arange(4)) & 1  # (16, 4)
    out = np.zeros((w, r, 2, 16), dtype=np.uint8)
    for half in range(2):
        cols = colbytes[:, :, 4 * half : 4 * half + 4]  # (w, r, 4)
        picked = cols[:, :, None, :] * select[None, None, :, :].astype(np.uint8)
        out[:, :, half, :] = np.bitwise_xor.reduce(picked, axis=-1)
    return out


def packed_gf_tables(bigm: np.ndarray) -> np.ndarray:
    """(ceil(w/4), r, 32) uint32 lookup tables for an (8w, 8r) matrix.

    Word ``[q, j, h * 16 + n]`` packs, in byte g, the product of output
    row 4q+g's coefficient for input row j with n (h = 0) or n << 4
    (h = 1). Rows past w in the last group are zero.
    """
    prods = nibble_products(bigm)
    w, r = prods.shape[:2]
    groups = -(-w // ROWS_PER_GROUP)
    padded = np.zeros((groups * ROWS_PER_GROUP, r, 2, 16), dtype=np.uint32)
    padded[:w] = prods
    padded = padded.reshape(groups, ROWS_PER_GROUP, r, WORDS_PER_ROW)
    shifts = (8 * np.arange(ROWS_PER_GROUP, dtype=np.uint32)).reshape(1, -1, 1, 1)
    return np.bitwise_or.reduce(padded << shifts, axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def crc_slicing_tables() -> np.ndarray:
    """(8, 256) uint32 slicing-by-8 tables: t[0] is the reflected byte
    table, t[s][i] = (t[s-1][i] >> 8) ^ t[0][t[s-1][i] & 0xff]."""
    t = np.zeros((8, 256), dtype=np.uint32)
    t[0] = crc32._byte_table()  # the port's copy of the reference table
    for s in range(1, 8):
        prev = t[s - 1]
        t[s] = (prev >> 8) ^ t[0, prev & 0xFF]
    t.setflags(write=False)
    return t


def column_words(matrix: np.ndarray) -> np.ndarray:
    """A (32, c) GF(2) matrix as c column words (bit i of word c = M[i, c])."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    cols = (np.asarray(matrix, dtype=np.uint64) * weights[:, None]).sum(axis=0)
    return cols.astype(np.uint32)


@functools.lru_cache(maxsize=64)
def shift_nibble_tables(nbytes: int) -> np.ndarray:
    """(8, 16) uint32: ``[q, x]`` = S^nbytes applied to x << 4q, the XOR
    of the column words of the bits set in x."""
    cols = column_words(crc32.shift_matrix(nbytes)).reshape(NIBBLES, 4)
    select = ((np.arange(16)[:, None] >> np.arange(4)) & 1).astype(np.uint32)
    out = np.bitwise_xor.reduce(cols[:, None, :] * select[None, :, :], axis=-1)
    out = out.astype(np.uint32)
    out.setflags(write=False)
    return out
