"""The PyTorch port's ops against the JAX package, on the CPU, byte-exact.

* The port's own copies of the numpy modules (gf256, bitplane, crc32,
  rs) give the same tables and matrices as the JAX package's.
* The plain PyTorch versions in ``torch_ec`` (which the kernel wrappers
  in ``cuda_ec`` run on CPU tensors) give the same bytes as ``jax_ec``
  and as the Pallas kernels in interpret mode.

Every output is an integer: the tolerance is 0 everywhere.
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lizardfs_tpu import constants as ref_constants
from lizardfs_tpu.ops import bitplane as ref_bitplane
from lizardfs_tpu.ops import crc32 as ref_crc32
from lizardfs_tpu.ops import gf256 as ref_gf256
from lizardfs_tpu.ops import jax_ec
from lizardfs_tpu.ops import pallas_ec
from lizardfs_tpu.ops import rs as ref_rs
from lizardfs_tpu_torch import constants, params
from lizardfs_tpu_torch.models import flagship
from lizardfs_tpu_torch.ops import bitplane, crc32, cuda_ec, gf256, kernel_tables, rs, torch_ec

GEOMETRIES = [(2, 1), (3, 2), (4, 2), (8, 2), (8, 4), (20, 4), (21, 4), (10, 5), (32, 32)]


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels in interpret mode, as tests/test_pallas.py does."""
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _crcs(t: torch.Tensor) -> np.ndarray:
    return torch_ec.crc_words_to_numpy(t)


def test_constants_match_reference():
    for name in ("MFSBLOCKSIZE", "MFSBLOCKSINCHUNK", "MFSCHUNKSIZE", "MFSHDRSIZE", "CRC_POLY",
                 "GF_POLY", "EC_MIN_DATA", "EC_MAX_DATA", "EC_MIN_PARITY",
                 "EC_MAX_PARITY", "XOR_MIN_LEVEL", "XOR_MAX_LEVEL", "MAX_FILE_SIZE",
                 "EATTR_NOOWNER", "EATTR_NOCACHE", "EATTR_NOENTRYCACHE", "EATTR_LIFECYCLE",
                 "EATTR_NAMES", "S3_LIFECYCLE_XATTR", "OFF_SPELLINGS"):
        assert getattr(constants, name) == getattr(ref_constants, name), name


@pytest.mark.parametrize("name,var", [("shadow_reads_enabled", "LZ_SHADOW_READS"),
                                      ("qos_enabled", "LZ_QOS"), ("heat_enabled", "LZ_HEAT"),
                                      ("ha_enabled", "LZ_HA"),
                                      ("s3_lifecycle_enabled", "LZ_S3_LIFECYCLE")])
def test_kill_switches_match_reference(monkeypatch, name, var):
    for value in (None, "0", "off", "FALSE", "no", "1", "on", "yes"):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        assert getattr(constants, name)() == getattr(ref_constants, name)(), (var, value)


def test_gf_tables_match_reference():
    np.testing.assert_array_equal(gf256.GF_LOG, ref_gf256.GF_LOG)
    np.testing.assert_array_equal(gf256.GF_EXP, ref_gf256.GF_EXP)
    np.testing.assert_array_equal(gf256.GF_MUL_TABLE, ref_gf256.GF_MUL_TABLE)
    for a in (0, 1, 2, 29, 255):
        assert gf256.gf_inv(a) == ref_gf256.gf_inv(a)
        assert gf256.gf_pow(a, 7) == ref_gf256.gf_pow(a, 7)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_matrices_match_reference(k, m):
    np.testing.assert_array_equal(
        gf256.rs_generator_matrix(k, m), ref_gf256.rs_generator_matrix(k, m))
    enc = gf256.encoding_matrix(k, m)
    np.testing.assert_array_equal(enc, ref_gf256.encoding_matrix(k, m))
    np.testing.assert_array_equal(
        bitplane.expand_gf_matrix(enc), ref_bitplane.expand_gf_matrix(enc))
    np.testing.assert_array_equal(
        torch_ec.encoding_bitmatrix(k, m), jax_ec.encoding_bitmatrix(k, m))
    rng = np.random.default_rng(k * 100 + m)
    for _ in range(4):
        lost = sorted(rng.choice(k + m, size=int(rng.integers(1, m + 1)), replace=False).tolist())
        have = [i for i in range(k + m) if i not in lost]
        used, mat = gf256.recovery_selection(k, m, have, lost)
        ref_used, ref_mat = ref_gf256.recovery_selection(k, m, have, lost)
        assert used == ref_used
        np.testing.assert_array_equal(mat, ref_mat)
        np.testing.assert_array_equal(
            torch_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost)),
            jax_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost)))
        keep = sorted(rng.choice(k, size=max(1, k // 2), replace=False).tolist())
        np.testing.assert_array_equal(
            gf256.reduce_columns(mat, keep), ref_gf256.reduce_columns(mat, keep))


def test_crc_matrices_match_reference():
    np.testing.assert_array_equal(crc32.shift_byte_matrix(), ref_crc32.shift_byte_matrix())
    np.testing.assert_array_equal(crc32.byte_in_matrix(), ref_crc32.byte_in_matrix())
    np.testing.assert_array_equal(crc32.subblock_matrix(64), ref_crc32.subblock_matrix(64))
    for n in (1, 16, 64, 4096, 65536, 1_000_003):
        np.testing.assert_array_equal(crc32.shift_matrix(n), ref_crc32.shift_matrix(n))
        assert crc32.zeros_crc(n) == ref_crc32.zeros_crc(n)
    assert crc32.crc32_combine(0x1234, 0xBEEF, 777) == ref_crc32.crc32_combine(0x1234, 0xBEEF, 777)
    for bs in (4096, 8192, 65536):
        c, levels, kc = crc32.block_crc_matrices(bs, 64)
        rc, rlevels, rkc = ref_crc32.block_crc_matrices(bs, 64)
        np.testing.assert_array_equal(c, rc)
        assert kc == rkc and len(levels) == len(rlevels)
        for a, b in zip(levels, rlevels):
            np.testing.assert_array_equal(a, b)
    blocks = np.random.default_rng(9).integers(0, 256, (5, 4096), dtype=np.uint8)
    np.testing.assert_array_equal(
        crc32.block_crcs_golden(blocks), ref_crc32.block_crcs_golden(blocks))


@pytest.mark.parametrize("k,m", [(3, 2), (8, 4), (21, 4), (10, 5)])
def test_golden_codec_matches_reference(k, m):
    rng = np.random.default_rng(k + m)
    data = [rng.integers(0, 256, 1000, dtype=np.uint8) for _ in range(k)]
    data[1] = None
    parity = rs.encode(k, m, data)
    for a, b in zip(parity, ref_rs.encode(k, m, data)):
        np.testing.assert_array_equal(a, b)
    allparts = data + parity
    lost = sorted(rng.choice(k + m, size=m, replace=False).tolist())
    avail = {i: allparts[i] for i in range(k + m) if i not in lost}
    got, want = rs.recover(k, m, avail, lost), ref_rs.recover(k, m, avail, lost)
    for i in lost:
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(
        rs.xor_parity(parity), ref_rs.xor_parity(parity))


@pytest.mark.parametrize("k,m", [(3, 2), (8, 4)])
def test_encode_matches_jax_and_pallas(k, m, interpret_mode):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(k, 2 * 16384), dtype=np.uint8)
    ref_bigm = jax_ec.encoding_bitmatrix(k, m)
    want = np.asarray(pallas_ec.encode(ref_bigm, data))
    np.testing.assert_array_equal(np.asarray(jax_ec.apply_gf(ref_bigm, data)), want)
    bigm = params.from_reference({"bigm": ref_bigm}, "cpu")["bigm"]
    assert bigm.dtype == torch.int8
    np.testing.assert_array_equal(cuda_ec.encode(bigm, _t(data)).numpy(), want)
    own = _t(torch_ec.encoding_bitmatrix(k, m))
    np.testing.assert_array_equal(torch_ec.apply_gf(own, _t(data)).numpy(), want)


def test_encode_any_length_matches_jax():
    """The port takes any N (degraded reads pass arbitrary slices)."""
    rng = np.random.default_rng(1)
    k, m, n = 8, 4, 1001
    data = rng.integers(0, 256, size=(k, n), dtype=np.uint8)
    bigm = jax_ec.encoding_bitmatrix(k, m)
    got = cuda_ec.encode(_t(bigm), _t(data)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ec.apply_gf(bigm, data)))
    np.testing.assert_array_equal(got, np.stack(ref_rs.encode(k, m, list(data))))


@pytest.mark.parametrize("bs,nblocks", [(4096, 18), (8192, 5), (65536, 2)])
def test_block_crcs_match_jax_and_pallas(bs, nblocks, interpret_mode):
    rng = np.random.default_rng(bs + nblocks)
    blocks = rng.integers(0, 256, size=(nblocks, bs), dtype=np.uint8)
    want = ref_crc32.block_crcs_golden(blocks)
    np.testing.assert_array_equal(np.asarray(jax_ec.block_crcs(blocks, bs)), want)
    np.testing.assert_array_equal(np.asarray(pallas_ec.block_crcs(blocks, bs)), want)
    np.testing.assert_array_equal(_crcs(cuda_ec.block_crcs(_t(blocks), bs)), want)


def test_block_size_rules():
    for bad in (0, 100, 192, 4096 + 64):
        with pytest.raises(ValueError):
            torch_ec.check_block_size(bad)
    with pytest.raises(ValueError):
        cuda_ec.block_crcs(torch.zeros((2, 4096), dtype=torch.uint8), 8192)


@pytest.mark.parametrize("k,m,bs,nb", [(8, 4, 8192, 4), (3, 2, 65536, 3)])
def test_fused_matches_jax_and_pallas(k, m, bs, nb, interpret_mode):
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=(k, nb * bs), dtype=np.uint8)
    ref_bigm = jax_ec.encoding_bitmatrix(k, m)
    wp, wd, wc = (np.asarray(x) for x in pallas_ec.fused_encode_crc(ref_bigm, data, bs))
    for got, want in zip(jax_ec.fused_encode_crc(ref_bigm, data, bs), (wp, wd, wc)):
        np.testing.assert_array_equal(np.asarray(got), want)
    bigm = params.from_reference({"bigm": ref_bigm}, "cpu")["bigm"]
    p, dc, pc = cuda_ec.fused_encode_crc(bigm, _t(data), bs)
    np.testing.assert_array_equal(p.numpy(), wp)
    np.testing.assert_array_equal(_crcs(dc), wd)
    np.testing.assert_array_equal(_crcs(pc), wc)
    # the flagship step, fed the JAX package's matrix
    step = flagship.make_single_chip_step(k, m, bs, device="cpu", bigm=bigm)
    sp, sd, sc = step(data)
    np.testing.assert_array_equal(sp.numpy(), wp)
    np.testing.assert_array_equal(_crcs(sd), wd)
    np.testing.assert_array_equal(_crcs(sc), wc)


def test_fused_decode_verify_matches_pallas(interpret_mode):
    """Reconstruct and CRC-verify lost parts; a corrupted expectation
    trips ``ok`` at that block only (tests/test_pallas.py:78-105)."""
    rng = np.random.default_rng(6)
    k, m, bs, nb = 4, 2, 8192, 2
    data = rng.integers(0, 256, size=(k, nb * bs), dtype=np.uint8)
    bigm = jax_ec.encoding_bitmatrix(k, m)
    parity, dcrc, _ = pallas_ec.fused_encode_crc(bigm, data, bs)
    allparts = np.concatenate([data, np.asarray(parity)], axis=0)
    lost = [1, 3]
    have = [i for i in range(k + m) if i not in lost]
    used, _ = ref_gf256.recovery_selection(k, m, have, lost)
    ref_rec = jax_ec.recovery_bitmatrix(k, m, tuple(used), tuple(lost))
    survivors = allparts[list(used)]
    want_crcs = np.asarray(dcrc)[lost]
    w_rec, w_crcs, w_ok = (np.asarray(x) for x in pallas_ec.fused_decode_verify(
        np.asarray(ref_rec), survivors, want_crcs, bs))
    t = params.from_reference({"rec": ref_rec, "crcs": want_crcs}, "cpu")
    assert t["crcs"].dtype == torch.int32
    rec, crcs, ok = cuda_ec.fused_decode_verify(t["rec"], _t(survivors), t["crcs"], bs)
    np.testing.assert_array_equal(rec.numpy(), w_rec)
    np.testing.assert_array_equal(rec.numpy(), data[lost])
    np.testing.assert_array_equal(_crcs(crcs), w_crcs)
    np.testing.assert_array_equal(ok.numpy(), w_ok)
    assert bool(ok.all())
    bad = want_crcs.copy()
    bad[0, 0] ^= 1
    _, _, w_ok2 = pallas_ec.fused_decode_verify(np.asarray(ref_rec), survivors, bad, bs)
    _, _, ok2 = cuda_ec.fused_decode_verify(
        t["rec"], _t(survivors), torch_ec.crc_words_from_numpy(bad), bs)
    np.testing.assert_array_equal(ok2.numpy(), np.asarray(w_ok2))
    assert not bool(ok2[0, 0]) and int(ok2.sum()) == ok2.numel() - 1
    # the reconstruct step, fed the JAX package's recovery matrix
    step = flagship.make_reconstruct_step(
        k, m, have, lost, bs, device="cpu", bigm_rec=t["rec"])
    assert step.used == used
    s_rec, s_crcs, s_ok = step(survivors, want_crcs)
    np.testing.assert_array_equal(s_rec.numpy(), data[lost])
    np.testing.assert_array_equal(_crcs(s_crcs), w_crcs)
    assert bool(s_ok.all())


def test_xor_reduce_matches_jax():
    parts = np.random.default_rng(5).integers(0, 256, (4, 777), dtype=np.uint8)
    np.testing.assert_array_equal(
        torch_ec.xor_reduce(_t(parts)).numpy(), np.asarray(jax_ec.xor_reduce(parts)))


def test_crc_words_round_trip():
    values = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
    words = torch_ec.crc_words_from_numpy(values)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(torch_ec.crc_words_to_numpy(words), values)
    np.testing.assert_array_equal(
        torch_ec.crc_words(torch.from_numpy(values.astype(np.int64))).numpy(),
        values.view(np.int32))


def test_shift_columns_apply_the_matrix():
    """The 32-word column form of a shift matrix, from which the kernels'
    nibble tables of the shift are built, applies it."""
    mat = crc32.shift_matrix(4096)
    cols = kernel_tables.column_words(mat)
    v = 0x89ABCDEF
    bits = np.array([(v >> i) & 1 for i in range(32)], dtype=np.uint32)
    want = (mat.astype(np.uint32) @ bits) & 1
    got = 0
    for c in range(32):
        if (v >> c) & 1:
            got ^= int(cols[c])
    assert got == sum(int(b) << i for i, b in enumerate(want))


@pytest.mark.parametrize("lost", [[0], [2, 5]])
def test_recovery_bitmatrix_is_contiguous(lost):
    """A single wanted part expands to a strided view in numpy; the port
    hands kernels C-ordered matrices."""
    k, m = 8, 4
    have = [i for i in range(k + m) if i not in lost]
    mat = torch_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost))
    assert mat.flags.c_contiguous
    np.testing.assert_array_equal(
        mat, jax_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost)))
    data = np.random.default_rng(3).integers(0, 256, (k, 4096), dtype=np.uint8)
    allparts = np.concatenate([data, np.stack(ref_rs.encode(k, m, list(data)))])
    step = flagship.make_reconstruct_step(k, m, have, lost, 4096, device="cpu")
    want = ref_crc32.block_crcs_golden(allparts[lost]).reshape(len(lost), 1)
    rec, _, ok = step(allparts[step.used], want)
    np.testing.assert_array_equal(rec.numpy(), allparts[lost])
    assert bool(ok.all())


def _offset_rows(rows: np.ndarray, offset: int) -> torch.Tensor:
    """``rows`` as a view ``buf[offset:].view(rows.shape)`` of a larger
    buffer: a tensor that starts off a 16-byte boundary."""
    buf = torch.zeros(rows.size + offset, dtype=torch.uint8)
    view = buf[offset:].view(rows.shape)
    view.copy_(torch.from_numpy(rows))
    return view


@pytest.mark.parametrize("offset", [1, 4, 15])
def test_crc_wrappers_take_any_offset(offset):
    """block_crcs and both fused wrappers on buf[offset:].view(B, bs)
    give the golden CRCs and the JAX package's results."""
    rng = np.random.default_rng(offset)
    k, m, bs, nb = 4, 2, 4096, 3
    blocks = rng.integers(0, 256, (5, bs), dtype=np.uint8)
    view = _offset_rows(blocks, offset)
    assert view.data_ptr() % 16 == offset % 16
    want = ref_crc32.block_crcs_golden(blocks)
    np.testing.assert_array_equal(_crcs(cuda_ec.block_crcs(view, bs)), want)
    np.testing.assert_array_equal(np.asarray(jax_ec.block_crcs(blocks, bs)), want)

    data = rng.integers(0, 256, (k, nb * bs), dtype=np.uint8)
    bigm = _t(torch_ec.encoding_bitmatrix(k, m))
    wp, wd, wc = (np.asarray(x) for x in jax_ec.fused_encode_crc(
        jax_ec.encoding_bitmatrix(k, m), data, bs))
    p, dc, pc = cuda_ec.fused_encode_crc(bigm, _offset_rows(data, offset), bs)
    np.testing.assert_array_equal(p.numpy(), wp)
    np.testing.assert_array_equal(_crcs(dc), wd)
    np.testing.assert_array_equal(_crcs(pc), wc)

    allparts = np.concatenate([data, wp])
    lost = [0, 5]
    have = [i for i in range(k + m) if i not in lost]
    used, _ = gf256.recovery_selection(k, m, have, lost)
    rec_m = _t(torch_ec.recovery_bitmatrix(k, m, tuple(have), tuple(lost)))
    expected = torch_ec.crc_words_from_numpy(np.concatenate([wd, wc])[lost])
    rec, crcs, ok = cuda_ec.fused_decode_verify(
        rec_m, _offset_rows(allparts[used], offset), expected, bs)
    np.testing.assert_array_equal(rec.numpy(), allparts[lost])
    np.testing.assert_array_equal(_crcs(crcs), np.concatenate([wd, wc])[lost])
    assert bool(ok.all())
