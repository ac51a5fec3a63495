"""Flagship steps: the chunk write and rebuild compute as one call each.

* :func:`make_single_chip_step` — fused ec(k,m) encode + per-block CRC32
  of a chunk (BASELINE config 3 at ec(8,4) over a 64 MiB chunk: 1024
  data blocks + 512 parity blocks), through the fused CUDA kernel.
* :func:`make_reconstruct_step` — rebuild of lost parts from k survivors
  with a CRC verify of the rebuilt blocks (BASELINE config 4), through
  the fused kernel driven by a recovery matrix.
* :func:`make_multichip_step` and :func:`make_multichip_reconstruct_step`
  — wide-stripe ec(32,8) encode and rebuild with the stripe axis split
  over a mesh of devices and the outputs block-sharded (BASELINE config
  5), through the GF apply and block CRC kernels on each device.

Both take an explicit bit-plane matrix where the caller has one (for
example the JAX package's, through :func:`lizardfs_tpu_torch.params.from_reference`).
"""

from __future__ import annotations

import numpy as np
import torch

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.ops import cuda_ec, gf256, torch_ec
from lizardfs_tpu_torch.parallel import recovery, sharded


def _matrix(bigm, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(bigm).to(device=dev, dtype=torch.int8).contiguous()


def _bytes(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=torch.uint8).contiguous()


def make_single_chip_step(
    k: int, m: int, block_size: int = MFSBLOCKSIZE, device=None, bigm=None
):
    """Returns fn(data (k, N) uint8) -> (parity, dcrc, pcrc) on ``device``
    (default ``cuda:0``); CRCs are int32 tensors of the uint32 bits."""
    dev = cuda_ec.resolve_device(device)
    mat = _matrix(torch_ec.encoding_bitmatrix(k, m) if bigm is None else bigm, dev)

    def step(data):
        return cuda_ec.fused_encode_crc(mat, _bytes(data, dev), block_size)

    return step


def make_reconstruct_step(
    k: int,
    m: int,
    available: list[int],
    wanted: list[int],
    block_size: int = MFSBLOCKSIZE,
    device=None,
    bigm_rec=None,
):
    """Returns fn(survivors (k, N), expected (r, nb)) -> (recovered (r, N),
    crcs (r, nb), ok (r, nb)) rebuilding ``wanted`` from the parts
    ``fn.used`` (chosen among ``available`` by gf256.recovery_selection,
    in that order). ``expected`` holds the stored CRCs of the wanted
    parts (numpy uint32 or int32 tensor)."""
    dev = cuda_ec.resolve_device(device)
    used, _ = gf256.recovery_selection(k, m, list(available), list(wanted))
    if bigm_rec is None:
        bigm_rec = torch_ec.recovery_bitmatrix(
            k, m, tuple(sorted(available)), tuple(wanted)
        )
    mat = _matrix(bigm_rec, dev)

    def step(survivors, expected):
        if isinstance(expected, np.ndarray):
            expected = torch_ec.crc_words_from_numpy(expected)
        return cuda_ec.fused_decode_verify(
            mat, _bytes(survivors, dev), expected.to(dev).contiguous(), block_size
        )

    step.used = used
    return step


def make_multichip_step(
    mesh, k: int = 32, m: int = 8, block_size: int = MFSBLOCKSIZE
):
    """Wide-stripe sharded encode+CRC step over ``mesh`` (see parallel.sharded)."""
    return sharded.sharded_encode_with_crcs(mesh, k, m, block_size)


def make_multichip_reconstruct_step(
    mesh, k: int, m: int, available: list[int], wanted: list[int],
    block_size: int = MFSBLOCKSIZE,
):
    """Mesh-sharded rebuild of ``wanted`` lost parts from survivors (see
    parallel.recovery)."""
    return recovery.sharded_reconstruct_with_crcs(
        mesh, k, m, available, wanted, block_size
    )


def example_chunk(k: int, nbytes_per_part: int, seed: int = 0) -> np.ndarray:
    """Deterministic example data (k, nbytes_per_part) uint8."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(k, nbytes_per_part), dtype=np.uint8)
