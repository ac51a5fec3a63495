"""Entry point of the port: the flagship step with example arguments.

``entry()`` returns the fused ec(8,4) Reed-Solomon encode + per-block
CRC32 step (the chunkserver write-path compute) and small example data
on ``device`` (default ``cuda:0``), like the JAX package's
``__graft_entry__.entry``.
"""

from __future__ import annotations

import torch

from lizardfs_tpu_torch.models import flagship
from lizardfs_tpu_torch.ops import cuda_ec


def entry(device=None):
    dev = cuda_ec.resolve_device(device)
    k, m = 8, 4
    block_size = 4096  # small blocks: a quick first-call check
    nb = 4
    data = torch.from_numpy(flagship.example_chunk(k, nb * block_size)).to(dev)
    fn = flagship.make_single_chip_step(k, m, block_size, device=dev)
    return fn, (data,)
