"""PyTorch/CUDA port of the lizardfs-tpu erasure-coding data plane.

The package mirrors the layout of :mod:`lizardfs_tpu` (``ops/``,
``core/``, ``utils/``, ``models/``, ``parallel/``, ``chunkserver/``,
``master/``, ``client/``, ``proto/``, ``runtime/``) and imports nothing
from it. This module imports nothing at all, so that the master, which
loads no torch, can fork. Entry points run on ``cuda:0`` unless the
caller passes ``device="cpu"``; on a CPU tensor every kernel wrapper
runs its plain PyTorch version.
"""
