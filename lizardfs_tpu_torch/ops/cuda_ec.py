"""Wrappers of the CUDA kernels in ``csrc/ec_kernels.cu``.

Counterpart of the JAX package's ``ops/pallas_ec.py``: the same four
functions, names and contracts (``encode``, ``block_crcs``,
``fused_encode_crc``, ``fused_decode_verify``), without the Pallas
tiling knobs. Each wrapper checks device, dtype, shape and contiguity,
then:

* on CUDA tensors launches its kernel on the current stream, raises if
  the launch returns an error, and adds one to ``LAUNCHES[name]``;
* on CPU tensors runs the plain version from
  :mod:`lizardfs_tpu_torch.ops.torch_ec`.

Nothing falls back from one to the other. CRC32 values are ``int32``
tensors holding the uint32 bits (see ``torch_ec``).
"""

from __future__ import annotations

import functools
import threading
import weakref

import numpy as np
import torch

from lizardfs_tpu_torch.constants import EC_MAX_DATA, EC_MAX_PARITY, MFSBLOCKSIZE
from lizardfs_tpu_torch.ops import _build, crc32, kernel_tables, torch_ec

# Kernel launches per wrapper, counted where each launches its kernel: one
# per wrapper call that reached the card. The two fused wrappers launch two
# kernels per call (the fused pass and its CRC fold) and count the call once.
LAUNCHES = {
    "encode": 0,
    "block_crcs": 0,
    "fused_encode_crc": 0,
    "fused_decode_verify": 0,
}
_LAUNCHES_LOCK = threading.Lock()  # encoders launch from worker threads

_CRC_THREADS = 256  # CTA size of the CRC kernels (a power of two)
_GF_THREADS = 256  # CTA size of the GF apply kernel
# loads a step and 16-byte vectors a span of the block CRC kernel (its
# kCrcSteps and kCrcVecs, which the launcher checks), and spans a slab
_CRC_STEPS, _CRC_VECS = 4, 2
_CRC_SPANS = 128
_VEC = 16  # bytes a thread loads per row and step
# kernel ids of lz_resident (csrc/ec_kernels.cu: KernelId)
_FUSED, _GF_APPLY_VEC, _GF_APPLY_BYTE, _BLOCK_CRC = range(4)


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    """One more launch of ``name``'s kernel (called where it launches)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller
    names another. Without a card only an explicit CPU device works."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev


def _check(t, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % _VEC == 0


def _vector_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for rows that start off a 16-byte boundary (a view such
    as ``buf[1:].view(B, bs)``) an aligned copy: the CRC kernels load 16
    bytes at a time."""
    return t if _aligned(t) else t.clone()


def _gf_dims(bigm: torch.Tensor, parts: torch.Tensor) -> tuple[int, int]:
    _check(bigm, "bigm", torch.int8, 2)
    _check(parts, "data", torch.uint8, 2)
    w8, r8 = bigm.shape
    r = parts.shape[0]
    if w8 % 8 or w8 == 0 or r8 != 8 * r or r == 0:
        raise ValueError(f"bigm {tuple(bigm.shape)} does not apply to {r} parts")
    w = w8 // 8
    if w > max(EC_MAX_DATA, EC_MAX_PARITY) or r > max(EC_MAX_DATA, EC_MAX_PARITY):
        raise ValueError(f"matrix of {w}x{r} parts exceeds the EC bounds")
    return w, r


def _words(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint32 table as an int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.array(table, dtype=np.uint32).view(np.int32)).to(device)


@functools.lru_cache(maxsize=8)
def _crc_table(device: torch.device) -> torch.Tensor:
    """(8, 256) slicing-by-8 CRC tables on ``device``."""
    return _words(kernel_tables.crc_slicing_tables(), device)


@functools.lru_cache(maxsize=64)
def _shift_nibble_table(nbytes: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """(len(nbytes), 8, 16) nibble tables of S^n for each n, on ``device``."""
    return _words(np.stack([kernel_tables.shift_nibble_tables(n) for n in nbytes]), device)


@functools.lru_cache(maxsize=256)
def _gf_table(matrix: bytes, shape: tuple[int, int], device: torch.device) -> torch.Tensor:
    """Packed GF tables of a bit-plane matrix given by its bytes, on ``device``."""
    bigm = np.frombuffer(matrix, dtype=np.int8).reshape(shape)
    return _words(kernel_tables.packed_gf_tables(bigm), device)


# Packed GF tables of the matrix tensors the GF wrappers were given:
# id(tensor) -> (weak reference, version counter, table). A matrix on the
# card is read back (which waits for the card) only the first time it is
# seen and after it was written in place.
_MATRIX_TABLES: dict[int, tuple[weakref.ref, int, torch.Tensor]] = {}


def _gf_tables_for(bigm: torch.Tensor) -> torch.Tensor:
    key = id(bigm)
    hit = _MATRIX_TABLES.get(key)
    if hit is not None and hit[0]() is bigm and hit[1] == bigm._version:
        return hit[2]
    host = bigm.cpu().numpy()
    table = _gf_table(host.tobytes(), host.shape, bigm.device)
    ref = weakref.ref(bigm, lambda _ref: _MATRIX_TABLES.pop(key, None))
    _MATRIX_TABLES[key] = (ref, bigm._version, table)
    return table


@functools.lru_cache(maxsize=256)
def _resident(kernel: int, threads: int, rows_in: int, rows_out: int, levels: int,
              device: torch.device) -> int:
    """CTAs of one kernel that fit on ``device`` at once for this shape
    (``lz_resident``), asked once per shape and device, so that a call
    runs no occupancy query."""
    with torch.cuda.device(device):
        resident = _build.library().lz_resident(kernel, threads, rows_in, rows_out, levels)
    if resident < 0:
        raise RuntimeError(f"occupancy query of kernel {kernel} failed: error {-resident}")
    return resident


def encode(bigm: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix apply: (r, N) uint8 -> (w, N) uint8 for an (8w, 8r)
    bit-plane matrix; encode or recover, as the matrix says. Any N."""
    w, r = _gf_dims(bigm, data)
    if not _on_card(bigm, data):
        return torch_ec.apply_gf_bitmatrix(bigm, data)
    n = data.shape[1]
    out = torch.empty((w, n), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    vec = n % _VEC == 0 and _aligned(data)
    resident = _resident(_GF_APPLY_VEC if vec else _GF_APPLY_BYTE, _GF_THREADS, r, w, 0,
                         data.device)
    gf_tabs = _gf_tables_for(bigm)
    lib = _build.library()
    with torch.cuda.device(data.device):
        _launch("gf_apply", lib.lz_gf_apply, gf_tabs.data_ptr(), data.data_ptr(),
                out.data_ptr(), w, r, n, int(vec), _GF_THREADS, resident, _stream(data))
    _count("encode")
    return out


@functools.lru_cache(maxsize=64)
def _crc_plan(block_size: int, span: int, spans: int, device: torch.device) -> tuple:
    """What the CRC kernels and the fold take for block_size blocks cut
    into slabs of up to ``spans`` spans of ``span`` bytes on ``device``,
    worked out once: (spans a slab, slabs a block, levels, CRC tables,
    level shift tables, slab shift table, K). block_size = 64 * 2^a, so
    a slab is a whole number of spans and a block a whole number of
    slabs."""
    spans = min(spans, block_size // span)
    slab = spans * span
    levels = spans.bit_length() - 1
    return (spans, block_size // slab, levels, _crc_table(device),
            _shift_nibble_table(tuple(span << l for l in range(levels)), device),
            _shift_nibble_table((slab,), device), crc32.zeros_crc(block_size))


def block_crcs(blocks: torch.Tensor, block_size: int = MFSBLOCKSIZE) -> torch.Tensor:
    """CRC32 of each row of a (B, block_size) uint8 tensor -> (B,) int32 bits."""
    _check(blocks, "blocks", torch.uint8, 2)
    torch_ec.check_block_size(block_size)
    if blocks.shape[1] != block_size:
        raise ValueError(f"rows of {blocks.shape[1]} bytes, block_size={block_size}")
    if not _on_card(blocks):
        return torch_ec.block_crcs(blocks, block_size)
    nblocks = blocks.shape[0]
    dev = blocks.device
    out = torch.empty(nblocks, dtype=torch.int32, device=dev)
    if nblocks == 0:
        return out
    blocks = _vector_rows(blocks)
    _, splits, levels, crc_tab, level_tabs, slab_tab, k_const = (
        _crc_plan(block_size, _CRC_VECS * _VEC, _CRC_SPANS, dev))
    resident = _resident(_BLOCK_CRC, _CRC_THREADS, _CRC_STEPS, _CRC_VECS, levels, dev)
    regs = torch.empty(nblocks * splits, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _launch("block_crc", lib.lz_block_crcs, blocks.data_ptr(), nblocks, _CRC_THREADS,
                splits, _CRC_STEPS, _CRC_VECS, crc_tab.data_ptr(), level_tabs.data_ptr(),
                levels, slab_tab.data_ptr(), k_const, resident, regs.data_ptr(), out.data_ptr(),
                _stream(blocks))
    _count("block_crcs")
    return out


def _fused_checks(bigm, data, block_size) -> tuple[int, int, int]:
    w, r = _gf_dims(bigm, data)
    torch_ec.check_block_size(block_size)
    n = data.shape[1]
    if n % block_size or n == 0:
        raise ValueError(f"N={n} is not a positive multiple of block_size={block_size}")
    return w, r, n // block_size


def _fused_launch(bigm, data, block_size, expected=None):
    """Launch the fused kernel and the fold, with one library call. With
    ``expected`` (the lost parts' stored CRCs) the input rows' CRCs are
    skipped and the fold compares; returns (out rows, crcs of all rows or
    of the outputs, ok)."""
    data = _vector_rows(data)
    w, (r, n) = bigm.shape[0] // 8, data.shape
    nb = n // block_size
    dev = data.device
    threads, splits, levels, crc_tab, level_tabs, slab_tab, k_const = (
        _crc_plan(block_size, _VEC, _CRC_THREADS, dev))
    resident = _resident(_FUSED, threads, r, w, levels, dev)
    gf_tabs = _gf_tables_for(bigm)
    crc_inputs = expected is None
    rows = r + w
    folded = rows if crc_inputs else w
    out = torch.empty((w, n), dtype=torch.uint8, device=dev)
    regs = torch.empty((rows, nb, splits), dtype=torch.int32, device=dev)
    crcs = torch.empty((folded, nb), dtype=torch.int32, device=dev)
    ok = None if crc_inputs else torch.empty((w, nb), dtype=torch.bool, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        _launch("fused_encode_crc", lib.lz_fused_encode_crc, gf_tabs.data_ptr(),
                data.data_ptr(), r, w, n, block_size, threads, splits,
                crc_tab.data_ptr(), level_tabs.data_ptr(), levels, slab_tab.data_ptr(),
                k_const, resident, out.data_ptr(), regs.data_ptr(), crcs.data_ptr(),
                None if crc_inputs else expected.data_ptr(),
                None if crc_inputs else ok.data_ptr(), _stream(data))
    return out, crcs, ok


def fused_encode_crc(
    bigm: torch.Tensor, data: torch.Tensor, block_size: int = MFSBLOCKSIZE
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-pass RS encode + per-block CRC32.

    (k, N) uint8 -> (parity (m, N) uint8, dcrc (k, nb) int32,
    pcrc (m, nb) int32), N a multiple of block_size.
    """
    _fused_checks(bigm, data, block_size)
    if not _on_card(bigm, data):
        return torch_ec.fused_encode_crc(bigm, data, block_size)
    k = data.shape[0]
    parity, crcs, _ = _fused_launch(bigm, data, block_size)
    _count("fused_encode_crc")
    return parity, crcs[:k], crcs[k:]


def fused_decode_verify(
    bigm_rec: torch.Tensor,
    survivors: torch.Tensor,
    expected_crcs: torch.Tensor,
    block_size: int = MFSBLOCKSIZE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused reconstruct + CRC verify of the recovered parts.

    ``bigm_rec`` (8r, 8k) maps the k survivor rows to the r lost parts;
    ``expected_crcs`` (r, nb) int32 are their stored block CRCs. Returns
    (recovered (r, N) uint8, crcs (r, nb) int32, ok (r, nb) bool).
    """
    r, _k, nb = _fused_checks(bigm_rec, survivors, block_size)
    _check(expected_crcs, "expected_crcs", torch.int32, 2)
    if tuple(expected_crcs.shape) != (r, nb):
        raise ValueError(f"expected_crcs {tuple(expected_crcs.shape)}, want {(r, nb)}")
    if not _on_card(bigm_rec, survivors, expected_crcs):
        return torch_ec.fused_decode_verify(bigm_rec, survivors, expected_crcs, block_size)
    out = _fused_launch(bigm_rec, survivors, block_size, expected_crcs)
    _count("fused_decode_verify")
    return out

