"""The host-built tables of the CUDA kernels, held against the JAX package
on the CPU.

The CUDA kernels themselves run only on the card (``chip_smoke.py``). What
they read is built here by ``lizardfs_tpu_torch.ops.kernel_tables``, and
their arithmetic is emulated in numpy step by step: packed GF lookups on
the vector and the byte path, the 4x4 byte transpose with the kernels'
``__byte_perm`` selectors, slicing-by-8 span registers, the nibble-table
CRC tree, the block CRC kernel's walk of slabs and the slab fold. The
emulation must give the bytes and CRCs of ``pallas_ec`` (interpret mode)
and ``jax_ec`` or the golden CRCs. Every value is an integer: the
tolerance is 0 everywhere.
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lizardfs_tpu.ops import crc32 as ref_crc32
from lizardfs_tpu.ops import gf256 as ref_gf256
from lizardfs_tpu.ops import jax_ec, pallas_ec
from lizardfs_tpu_torch.ops import crc32, cuda_ec, kernel_tables, torch_ec

VEC = 16  # bytes a thread takes of each row
THREADS = 256  # CTA size of the fused kernel at block sizes >= 4 KiB


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels in interpret mode, as tests/test_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _recovery(k, m, lost):
    have = [i for i in range(k + m) if i not in lost]
    used, mat = ref_gf256.recovery_selection(k, m, have, lost)
    return used, mat, jax_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost))


# (name, GF(2^8) matrix, its bit-plane expansion) for the tables test
def _matrix_case(name):
    if name == "rec(8,4)[3]":
        _, mat, bigm = _recovery(8, 4, [3])
        return mat, bigm
    k, m = {"ec(8,4)": (8, 4), "ec(5,7)": (5, 7), "ec(32,32)": (32, 32)}[name]
    return ref_gf256.encoding_matrix(k, m), jax_ec.encoding_bitmatrix(k, m)


@pytest.mark.parametrize("name", ["ec(8,4)", "ec(5,7)", "ec(32,32)", "rec(8,4)[3]"])
def test_packed_gf_tables_give_gf_products(name):
    mat, bigm = _matrix_case(name)
    w, r = mat.shape
    tabs = kernel_tables.packed_gf_tables(np.asarray(bigm))
    assert tabs.dtype == np.uint32 and tabs.shape == (-(-w // 4), r, 32)
    v = np.arange(256)
    words = tabs[:, :, v & 15] ^ tabs[:, :, 16 + (v >> 4)]  # (groups, r, 256)
    for i in range(4 * tabs.shape[0]):
        got = (words[i // 4] >> np.uint32(8 * (i % 4))) & 0xFF
        if i >= w:  # padding rows of the last group
            assert not got.any()
            continue
        want = np.array([ref_gf256.gf_mul(int(mat[i, j]), v) for j in range(r)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbytes", [16 << l for l in range(8)] + [4096])
def test_shift_nibble_tables_apply_the_shift(nbytes):
    tab = kernel_tables.shift_nibble_tables(nbytes)
    assert tab.dtype == np.uint32 and tab.shape == (8, 16)
    words = np.random.default_rng(nbytes).integers(0, 2**32, 64, dtype=np.uint64)
    got = _shift(tab, words.astype(np.uint32))
    bits = (words[:, None] >> np.arange(32, dtype=np.uint64)) & 1
    out = (ref_crc32.shift_matrix(nbytes).astype(np.uint64) @ bits.T) & 1  # (32, 64)
    want = (out * (np.uint64(1) << np.arange(32, dtype=np.uint64))[:, None]).sum(axis=0)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_crc_slicing_tables_give_span_registers():
    """Slicing-by-8 over a 16-byte span from a zero register gives the
    JAX package's sub-block map C_16 applied to the span's bits."""
    spans = np.random.default_rng(4).integers(0, 256, (32, VEC), dtype=np.uint8)
    got = _span_registers(spans.reshape(1, -1))[0]
    bits = np.unpackbits(spans, axis=1, bitorder="little").astype(np.uint64)
    out = (ref_crc32.subblock_matrix(VEC).astype(np.uint64) @ bits.T) & 1
    want = (out * (np.uint64(1) << np.arange(32, dtype=np.uint64))[:, None]).sum(axis=0)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


# ---------------------------------------------------------------------------
# numpy emulation of fused_encode_crc_kernel + crc_fold_kernel
# ---------------------------------------------------------------------------


def _byte_perm(x, y, selector):
    """CUDA's __byte_perm: byte i of the result is byte (selector >> 4i)
    & 7 of the eight bytes of (y, x)."""
    v = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros(x.shape, dtype=np.uint32)
    for i in range(4):
        src = (selector >> (4 * i)) & 7
        byte = (v >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * i)
    return out


def _transpose4(a):
    """The kernel's transpose4: byte p of out[g] = byte g of a[p]."""
    t0 = _byte_perm(a[0], a[1], 0x5140)
    t1 = _byte_perm(a[2], a[3], 0x5140)
    t2 = _byte_perm(a[0], a[1], 0x7362)
    t3 = _byte_perm(a[2], a[3], 0x7362)
    return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]


def _shift(tab, v):
    """shift_nibbles: XOR of 8 lookups, one per nibble of v."""
    out = np.zeros(v.shape, dtype=np.uint32)
    for q in range(8):
        out ^= tab[q][(v >> np.uint32(4 * q)) & 15]
    return out


def _span_registers(rows):
    """crc_raw16 from a zero register: (R, N) bytes -> (R, N/16) registers."""
    t = kernel_tables.crc_slicing_tables()
    w = np.ascontiguousarray(rows).view("<u4").reshape(rows.shape[0], -1, 4)
    crc = np.zeros(w.shape[:2], dtype=np.uint32)
    for lo, hi in ((w[..., 0], w[..., 1]), (w[..., 2], w[..., 3])):
        lo = lo ^ crc
        crc = (t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF]
               ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
               ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24])
    return crc


def _packed_apply(bigm, data, vec=True):
    """Output rows through packed lookups: the vector path (16 accumulator
    words per 16-byte unit, then the byte transpose) or the byte path (one
    accumulator word per byte; output row 4q+g takes its byte g)."""
    tabs = kernel_tables.packed_gf_tables(bigm)
    w = np.asarray(bigm).shape[0] // 8
    k, n = data.shape
    if not vec:
        out = np.zeros((4 * tabs.shape[0], n), dtype=np.uint8)
        for q, group in enumerate(tabs):
            acc = np.zeros(n, dtype=np.uint32)
            for j in range(k):
                acc ^= group[j][data[j] & 15] ^ group[j][16 + (data[j] >> 4)]
            for g in range(4):
                out[4 * q + g] = (acc >> np.uint32(8 * g)) & 0xFF
        return out[:w]
    x = data.reshape(k, n // VEC, VEC)
    out = np.zeros((4 * tabs.shape[0], n // VEC, VEC), dtype=np.uint8)
    for q, group in enumerate(tabs):
        acc = np.zeros((n // VEC, VEC), dtype=np.uint32)  # one word per byte position
        for j in range(k):
            acc ^= group[j][x[j] & 15] ^ group[j][16 + (x[j] >> 4)]
        rows = [np.zeros((n // VEC, 4), dtype=np.uint32) for _ in range(4)]
        for word in range(4):
            for g, col in enumerate(_transpose4([acc[:, 4 * word + p] for p in range(4)])):
                rows[g][:, word] = col
        for g in range(4):
            out[4 * q + g] = rows[g].astype("<u4").view(np.uint8)
    return out[:w].reshape(w, n)


def _block_crcs(rows, block_size):
    """Span registers -> per-CTA nibble-table tree -> slab fold -> ^ K."""
    threads = min(THREADS, block_size // VEC)
    levels = threads.bit_length() - 1
    slab = threads * VEC
    regs = _span_registers(rows).reshape(rows.shape[0], -1, threads)  # (R, slabs, T)
    for l in range(levels):
        regs = _shift(kernel_tables.shift_nibble_tables(VEC << l), regs[..., 0::2]) ^ regs[..., 1::2]
    regs = regs.reshape(rows.shape[0], -1, block_size // slab)  # (R, blocks, splits)
    fold = kernel_tables.shift_nibble_tables(slab)
    reg = np.zeros(regs.shape[:2], dtype=np.uint32)
    for s in range(regs.shape[2]):
        reg = _shift(fold, reg) ^ regs[..., s]
    return reg ^ np.uint32(crc32.zeros_crc(block_size))


BS = 8192


@pytest.mark.parametrize("k,m", [(8, 4), (5, 7)])
def test_emulated_fused_encode_crc_matches_pallas_and_jax(k, m, interpret_mode):
    data = np.random.default_rng(k * 10 + m).integers(0, 256, (k, 2 * BS), dtype=np.uint8)
    bigm = jax_ec.encoding_bitmatrix(k, m)
    want = [np.asarray(x) for x in pallas_ec.fused_encode_crc(bigm, data, BS)]
    for got, ref in zip(jax_ec.fused_encode_crc(bigm, data, BS), want):
        np.testing.assert_array_equal(np.asarray(got), ref)
    parity = _packed_apply(np.asarray(bigm), data)
    np.testing.assert_array_equal(parity, want[0])
    np.testing.assert_array_equal(_block_crcs(data, BS), want[1])
    np.testing.assert_array_equal(_block_crcs(parity, BS), want[2])


@pytest.mark.parametrize("k,m,lost", [(8, 4, [3]), (5, 7, [0, 6])])
def test_emulated_fused_decode_verify_matches_pallas(k, m, lost, interpret_mode):
    data = np.random.default_rng(k + m).integers(0, 256, (k, 2 * BS), dtype=np.uint8)
    bigm = jax_ec.encoding_bitmatrix(k, m)
    parity, dcrc, pcrc = (np.asarray(x) for x in jax_ec.fused_encode_crc(bigm, data, BS))
    allparts = np.concatenate([data, parity])
    stored = np.concatenate([dcrc, pcrc])[lost]
    used, _, rec_m = _recovery(k, m, lost)
    survivors = allparts[list(used)]
    w_rec, w_crcs, w_ok = (np.asarray(x) for x in pallas_ec.fused_decode_verify(
        np.asarray(rec_m), survivors, stored, BS))
    rec = _packed_apply(np.asarray(rec_m), survivors)
    crcs = _block_crcs(rec, BS)
    np.testing.assert_array_equal(rec, w_rec)
    np.testing.assert_array_equal(rec, allparts[lost])
    np.testing.assert_array_equal(crcs, w_crcs)
    np.testing.assert_array_equal(crcs == stored, w_ok)
    assert w_ok.all()


# ---------------------------------------------------------------------------
# numpy emulation of gf_apply_kernel and of block_crc_kernel + crc_fold_kernel
# ---------------------------------------------------------------------------

GF_N = 16384  # a multiple of the Pallas encode tile at every case below
MATRICES = ["ec(8,4)", "ec(5,7)", "ec(32,32)", "rec(8,4)[3]"]


@pytest.mark.parametrize("vec", [True, False], ids=["vec16", "bytes"])
@pytest.mark.parametrize("name", MATRICES)
def test_emulated_gf_apply_matches_pallas_and_jax(name, vec, interpret_mode):
    """Both paths of gf_apply_kernel: groups of four, of three (ec(5,7)),
    eight groups (ec(32,32)) and one row (a one-part rebuild)."""
    _, bigm = _matrix_case(name)
    bigm = np.asarray(bigm)
    data = np.random.default_rng(len(name)).integers(
        0, 256, (bigm.shape[1] // 8, GF_N), dtype=np.uint8)
    want = np.asarray(pallas_ec.encode(bigm, data))
    np.testing.assert_array_equal(np.asarray(jax_ec.apply_gf_bitmatrix(bigm, data)), want)
    np.testing.assert_array_equal(_packed_apply(bigm, data, vec), want)


@pytest.mark.parametrize("name", MATRICES)
def test_emulated_gf_apply_byte_path_takes_ragged_n(name):
    """The byte path at a length that is no multiple of 16 (the Pallas
    encode takes only whole tiles; jax_ec takes any length)."""
    _, bigm = _matrix_case(name)
    bigm = np.asarray(bigm)
    data = np.random.default_rng(4097).integers(
        0, 256, (bigm.shape[1] // 8, 4097), dtype=np.uint8)
    np.testing.assert_array_equal(
        _packed_apply(bigm, data, vec=False), np.asarray(jax_ec.apply_gf_bitmatrix(bigm, data)))


def _block_crc_kernel(blocks, block_size, steps, vecs, max_spans, grid=None):
    """block_crc_kernel's walk, then the fold: slabs of T (at most
    max_spans) spans of 16 * vecs bytes tile the blocks; a load covers THREADS spans (THREADS / T
    slabs) and a step `steps` loads; CTA b of `grid` takes steps b, b +
    grid, ... (fewer slabs at the end), folds each step's slabs in one
    nibble-table tree and writes one register per slab; the fold then
    runs per block."""
    span = VEC * vecs
    spans = min(max_spans, block_size // span)
    levels = spans.bit_length() - 1
    slab = spans * span
    per = steps * (THREADS // spans)
    flat = np.ascontiguousarray(blocks).reshape(-1)
    slabs = flat.size // slab
    nsteps = -(-slabs // per)
    grid = nsteps if grid is None else min(grid, nsteps)
    level_tabs = [kernel_tables.shift_nibble_tables(span << l) for l in range(levels)]
    regs_out = np.zeros(slabs, dtype=np.uint32)
    written = np.zeros(slabs, dtype=int)
    for b in range(grid):
        for c0 in range(b * per, slabs, grid * per):
            n = min(per, slabs - c0)
            vec_regs = _span_registers(flat[c0 * slab:(c0 + n) * slab].reshape(n * spans, span))
            regs = np.zeros(n * spans, dtype=np.uint32)  # chained over a span's vectors
            for v in range(vecs):
                regs = _shift(kernel_tables.shift_nibble_tables(VEC), regs) ^ vec_regs[:, v]
            regs = regs.reshape(n, spans)
            for tab in level_tabs:
                regs = _shift(tab, regs[:, 0::2]) ^ regs[:, 1::2]
            regs_out[c0:c0 + n] = regs[:, 0]
            written[c0:c0 + n] += 1
    assert (written == 1).all()
    per_block = regs_out.reshape(-1, block_size // slab)
    fold = kernel_tables.shift_nibble_tables(slab)
    reg = np.zeros(per_block.shape[0], dtype=np.uint32)
    for s in range(per_block.shape[1]):
        reg = _shift(fold, reg) ^ per_block[:, s]
    return reg ^ np.uint32(crc32.zeros_crc(block_size))


@pytest.mark.parametrize("bs,count,grid", [
    (64, 13, None),  # 4 threads a CTA, one slab a block, 13 slabs: no multiple of the step
    (64, 13, 1),  # one CTA walks every step
    (4096, 13, 2),
    (4096, 1, None),  # one block
    (65536, 3, 4),  # 16 slabs a block, 48 slabs over 4 CTAs
    (65536, 5, None),
])
def test_emulated_block_crcs_match_pallas_and_golden(bs, count, grid, interpret_mode):
    blocks = np.random.default_rng(bs + count).integers(0, 256, (count, bs), dtype=np.uint8)
    want = ref_crc32.block_crcs_golden(blocks)
    got = _block_crc_kernel(blocks, bs, cuda_ec._CRC_STEPS, cuda_ec._CRC_VECS, cuda_ec._CRC_SPANS,
                            grid)
    np.testing.assert_array_equal(got, want)
    if bs >= 128:  # the Pallas block_crcs takes 128-byte sub-blocks
        np.testing.assert_array_equal(np.asarray(pallas_ec.block_crcs(blocks, bs)), want)


def test_gf_tables_follow_the_matrix_tensor():
    """The wrapper's tables are built once per matrix tensor and rebuilt
    after the tensor is written in place."""
    bigm = torch.from_numpy(np.array(torch_ec.encoding_bitmatrix(8, 4)))
    first = cuda_ec._gf_tables_for(bigm)
    assert cuda_ec._gf_tables_for(bigm) is first
    np.testing.assert_array_equal(
        first.numpy().view(np.uint32), kernel_tables.packed_gf_tables(bigm.numpy()))
    bigm.copy_(torch.from_numpy(np.array(torch_ec.encoding_bitmatrix(8, 4)[::-1])))
    second = cuda_ec._gf_tables_for(bigm)
    np.testing.assert_array_equal(
        second.numpy().view(np.uint32), kernel_tables.packed_gf_tables(bigm.numpy()))
    assert not torch.equal(first, second)
    key = id(bigm)
    del bigm
    assert key not in cuda_ec._MATRIX_TABLES
