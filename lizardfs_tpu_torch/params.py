"""State carried across from the JAX package.

The port's state is host-side matrices: the bit-plane GF matrices
(``jax_ec.encoding_bitmatrix`` / ``recovery_bitmatrix``) and the CRC
matrices (``crc32.block_crc_matrices``, ``crc32.shift_matrix``).
:func:`from_reference` turns such numpy arrays, made by either package,
into the port's device tensors, so that both packages can be fed the
same matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from lizardfs_tpu_torch.ops import cuda_ec


def from_reference(arrays: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """Numpy arrays -> tensors on ``device`` (default ``cuda:0``).

    int8 and uint8 arrays keep their dtype (bit-plane matrices are int8
    0/1, CRC matrices uint8 0/1); uint32 arrays (CRC values) become int32
    tensors of the same bits, the port's CRC convention.
    """
    dev = cuda_ec.resolve_device(device)
    out = {}
    for name, arr in arrays.items():
        a = np.array(arr, order="C")  # a writable copy
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        elif a.dtype not in (np.int8, np.uint8):
            raise TypeError(f"{name}: unsupported dtype {a.dtype}")
        out[name] = torch.from_numpy(a).to(dev)
    return out
