"""CRC32 (zlib-compatible) golden path + GF(2) matrix machinery.

The reference checksums every 64 KiB block with CRC-32, polynomial
0xEDB88320 reflected, init/final xor 0xFFFFFFFF — exactly zlib's ``crc32``
(reference: src/common/crc.cc:113-151 ``mycrc32``), and concatenates block
CRCs with ``mycrc32_combine`` (crc.cc:207-224), the classic GF(2)
matrix-shift construction.

CRC over a message is *affine* over GF(2) in the message bits:

    crc(msg) = R(msg) xor K_L,   R linear,   K_L = crc(0^L)

and R decomposes over fixed-size sub-blocks:

    R(msg) = sum_i S_B^(n-1-i) @ (C_B @ bits(subblock_i))

with S_B the "shift by B zero bytes" 32x32 matrix and C_B the 32x(8B)
sub-block matrix. That decomposition lets the plain PyTorch path compute
all block CRCs of a chunk as one batched matmul plus a log-depth tree of
tiny 32x32 combines, and lets the CUDA kernels combine the registers of
independent spans with the same shift matrices. This module
builds those matrices (host-side, cached) and provides the golden
scalar/functional path used for verification.

Bit convention: bit i of a 32-bit CRC register maps to vector row i
(little-endian); byte bit j likewise.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

from lizardfs_tpu_torch.constants import CRC_POLY


def crc32(data: bytes | np.ndarray, crc: int = 0) -> int:
    """Golden CRC32, identical to the reference's ``mycrc32``."""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    return zlib.crc32(data, crc) & 0xFFFFFFFF


@functools.lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    """Standard reflected CRC-32 byte table (crc.cc:71-90)."""
    tab = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (CRC_POLY ^ (c >> 1)) if (c & 1) else (c >> 1)
        tab[i] = c
    return tab


def _bits32(x: int) -> np.ndarray:
    return np.array([(x >> i) & 1 for i in range(32)], dtype=np.uint8)


def _from_bits32(v: np.ndarray) -> int:
    return int(sum(int(b) << i for i, b in enumerate(v)))


def _raw_step(crc: int, byte: int) -> int:
    """One raw register update (no init/final xor): linear in (crc, byte)."""
    tab = _byte_table()
    return int(tab[(crc ^ byte) & 0xFF]) ^ (crc >> 8)


@functools.lru_cache(maxsize=1)
def shift_byte_matrix() -> np.ndarray:
    """S8: 32x32 GF(2) matrix advancing the raw register by one zero byte."""
    m = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        m[:, i] = _bits32(_raw_step(1 << i, 0))
    return m


@functools.lru_cache(maxsize=1)
def byte_in_matrix() -> np.ndarray:
    """U: 32x8 GF(2) matrix mapping one input byte's bits into the register."""
    m = np.zeros((32, 8), dtype=np.uint8)
    for j in range(8):
        m[:, j] = _bits32(_raw_step(0, 1 << j))
    return m


def _m2mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint32) @ b.astype(np.uint32) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _shift_pow2(level: int) -> np.ndarray:
    """S8^(2^level), by repeated squaring (bounded cache: level < 64)."""
    if level == 0:
        m = shift_byte_matrix()
    else:
        h = _shift_pow2(level - 1)
        m = _m2mul(h, h)
    m.setflags(write=False)
    return m


def shift_matrix(nbytes: int) -> np.ndarray:
    """S8^nbytes, composed from cached power-of-two squarings.

    Arbitrary lengths are composed on the fly (like the reference's
    mycrc32_combine loop, crc.cc:207-224) so long-running daemons don't
    accumulate a cache entry per distinct length.
    """
    result = np.eye(32, dtype=np.uint8)
    n = nbytes
    level = 0
    while n:
        if n & 1:
            result = _m2mul(_shift_pow2(level), result)
        n >>= 1
        level += 1
    result.setflags(write=False)
    return result


@functools.lru_cache(maxsize=None)
def subblock_matrix(nbytes: int) -> np.ndarray:
    """C_B: 32x(8*nbytes) matrix; R(subblock) = C_B @ bits(subblock).

    Column block for byte position p is S8^(B-1-p) @ U (byte 0 is
    processed first, so it is shifted the most).
    """
    u = byte_in_matrix()
    s8 = shift_byte_matrix()
    out = np.zeros((32, 8 * nbytes), dtype=np.uint8)
    v = u
    for p in range(nbytes - 1, -1, -1):
        out[:, 8 * p : 8 * p + 8] = v
        if p:
            v = _m2mul(s8, v)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=64)
def zeros_crc(nbytes: int) -> int:
    """K_L = crc32 of nbytes zero bytes (affine constant)."""
    # crc32(0^L) computed without materializing L bytes: K = (S8^L @ ones) ^ ones
    ones = _bits32(0xFFFFFFFF)
    v = (shift_matrix(nbytes).astype(np.uint32) @ ones & 1).astype(np.uint8)
    return _from_bits32(v ^ ones)


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concatenation: combine(crc(A), crc(B), len(B)) == crc(A+B).

    Identical semantics to ``mycrc32_combine`` (crc.cc:207-224): apply the
    "append len2 zero bytes" operator to crc1, xor crc2.
    """
    v = _bits32(crc1 & 0xFFFFFFFF)
    v = (shift_matrix(len2).astype(np.uint32) @ v & 1).astype(np.uint8)
    return (_from_bits32(v) ^ crc2) & 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def block_crc_matrices(
    block_size: int, subblock: int = 64
) -> tuple[np.ndarray, tuple[np.ndarray, ...], int]:
    """Matrices for the batched per-block CRC (plain PyTorch path).

    Returns (C_sub, level_mats, K):
      * C_sub: (32, 8*subblock) sub-block matrix,
      * level_mats: for each tree level l, the 32x32 shift applied to the
        left child when merging two groups of 2^l sub-blocks
        (= S8^(subblock * 2^l)),
      * K: affine constant = crc32 of block_size zero bytes.

    ``crc(block) = tree_reduce(C_sub @ bits(subblocks)) xor K``.
    """
    assert block_size % subblock == 0
    n = block_size // subblock
    assert n & (n - 1) == 0, "sub-block count must be a power of two"
    levels = []
    l = 0
    while (1 << l) < n:
        levels.append(shift_matrix(subblock * (1 << l)))
        l += 1
    return subblock_matrix(subblock), tuple(levels), zeros_crc(block_size)


def block_crcs_golden(blocks: np.ndarray) -> np.ndarray:
    """CRC32 of each row of a (n, block_size) uint8 array (golden path)."""
    return np.array(
        [crc32(blocks[i].tobytes()) for i in range(blocks.shape[0])], dtype=np.uint32
    )
