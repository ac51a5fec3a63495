"""Mesh-sharded wide-stripe reconstruction: rebuild lost parts over the
devices of a mesh.

Counterpart of the JAX package's ``parallel/recovery.py``: the step of
:mod:`lizardfs_tpu_torch.parallel.sharded` driven by the recovery
bit-matrix instead of the generator. The k survivors chosen by
:func:`gf256.recovery_selection` (the rule every backend shares, so the
mesh, the card and the CPU give the same bytes) are split over the
stripe axis, each device applies its column slice of the (8w, 8k)
recovery matrix, the partials are XORed by block range on their owners,
and each owner checksums its rebuilt blocks for the caller to compare
with the stored CRCs of the lost parts.

``LZ_SHARDED_RECOVERY=0`` (or any off spelling) is the subsystem's kill
switch: :func:`enabled` is false, the sharded encoder refuses to build
and a live one rebuilds on one card.
"""

from __future__ import annotations

import numpy as np

from lizardfs_tpu_torch.constants import env_flag
from lizardfs_tpu_torch.ops import gf256, torch_ec
from lizardfs_tpu_torch.parallel.sharded import MeshApply, dims, stripe_block_grid


def enabled() -> bool:
    """The subsystem kill switch (``LZ_SHARDED_RECOVERY=0`` disables)."""
    return env_flag("LZ_SHARDED_RECOVERY")


def sharded_reconstruct_with_crcs(
    mesh, k: int, m: int, available: list[int], wanted: list[int],
    block_size: int,
):
    """Build a mesh-sharded reconstruct+CRC step.

    Parts are globally indexed 0..k+m-1 (data first). ``available`` are
    the live part indices (>= k of them), ``wanted`` the lost ones (up to
    m). Returns ``run(survivors)`` where ``survivors`` is (k,
    nb*block_size) holding the **used** parts (``run.used``, the
    selection rule's choice, ascending) stacked in that order (or a list
    of those rows); outputs
    are ShardedArrays (recovered (w, nb, block_size) block-sharded, crcs
    (w, nb)), byte-identical to the single-device recover for any
    erasure pattern. nb and k must divide the mesh like the encode step.
    """
    grid = stripe_block_grid(mesh)
    n_stripe, n_block = grid.shape
    if k % n_stripe:
        raise ValueError(f"k={k} not divisible by stripe axis {n_stripe}")
    used, _ = gf256.recovery_selection(k, m, list(available), list(wanted))
    # (8w, 8k) over the used parts, ascending
    bigm = torch_ec.recovery_bitmatrix(k, m, tuple(used), tuple(wanted))
    step = MeshApply(mesh, bigm, block_size, crc_inputs=False)

    def run(survivors):
        rows, nbytes = dims(survivors)
        if rows != k:
            raise ValueError(f"need the {k} used parts stacked, got {rows}")
        nb = nbytes // block_size
        if nbytes % block_size or nb % (n_stripe * n_block):
            raise ValueError(
                f"part bytes must be nb*{block_size} with nb divisible "
                f"by mesh extent {n_stripe * n_block}; got {nbytes}"
            )
        return tuple(step(survivors))

    run.used = used
    return run


def sharded_reconstruct_verify(
    mesh, k: int, m: int, available: list[int], wanted: list[int],
    survivors_by_part: dict[int, np.ndarray], block_size: int,
    expected_crcs: np.ndarray | None = None,
):
    """One-shot reconstruct + post-rebuild CRC verify.

    ``survivors_by_part`` maps live global part index -> byte stream;
    ``expected_crcs`` (w, nb) are the stored per-block CRCs of the lost
    parts. Returns (recovered (w, N) np.uint8, crcs (w, nb) np.uint32,
    ok bool): ``ok`` is True when every rebuilt block checksums to its
    stored CRC (or no expectation was given).
    """
    run = sharded_reconstruct_with_crcs(mesh, k, m, available, wanted, block_size)
    rec, rcrc = run([np.asarray(survivors_by_part[i], dtype=np.uint8) for i in run.used])
    rec_np = rec.gather().reshape(len(wanted), -1)
    rcrc_np = rcrc.gather()
    ok = True
    if expected_crcs is not None:
        ok = bool(np.array_equal(rcrc_np, np.asarray(expected_crcs, np.uint32)))
    return rec_np, rcrc_np, ok
