"""Entry points of the port: the flagship step with example arguments,
and the multi-device dry run.

``entry()`` returns the fused ec(8,4) Reed-Solomon encode + per-block
CRC32 step (the chunkserver write-path compute) and small example data
on ``device`` (default ``cuda:0``), like the JAX package's
``__graft_entry__.entry``.

``dryrun_multichip(n)`` builds a mesh of n devices (``cuda:0..n-1``
unless ``devices`` names others), runs the wide-stripe encode+CRC step
over it, then kills one part and rebuilds it over the same mesh, and
holds both against the golden CPU codec, like the JAX package's
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import numpy as np
import torch

from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder
from lizardfs_tpu_torch.models import flagship
from lizardfs_tpu_torch.ops import cuda_ec
from lizardfs_tpu_torch.parallel.sharded import make_mesh, make_mesh_2d


def entry(device=None):
    dev = cuda_ec.resolve_device(device)
    k, m = 8, 4
    block_size = 4096  # small blocks: a quick first-call check
    nb = 4
    data = torch.from_numpy(flagship.example_chunk(k, nb * block_size)).to(dev)
    fn = flagship.make_single_chip_step(k, m, block_size, device=dev)
    return fn, (data,)


def dryrun_multichip(
    n_devices: int, *, block_size: int = 64 * 1024, min_logical_mib: int = 64,
    devices=None,
) -> dict:
    """Both multi-device legs (wide-stripe encode+CRC, then kill-one-part
    reconstruct+verify) at full shapes by default: ec(32,8) over a 64
    MiB logical chunk of 64 KiB blocks on an 8-device mesh. The keyword
    overrides let the CPU tests run the same code on a small mesh.
    Raises on any mismatch; returns what it ran: the mesh, k, m,
    block_size, nb, the killed part and all k + m parts (golden)."""
    if devices is None:
        cuda_ec.resolve_device()  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    # 2-D mesh when possible: stripe axis (parts of one stripe joined by
    # the exchange) x block axis (disjoint block ranges, no communication)
    if n_devices >= 4 and n_devices % 2 == 0:
        n_stripe, n_block = n_devices // 2, 2
        mesh = make_mesh_2d(n_stripe, n_block, devices)
    else:
        n_stripe, n_block = n_devices, 1
        mesh = make_mesh(devices)

    # widest stripe geometry that divides the mesh: k parts over the
    # stripe axis, m = 8 parity, nb blocks rounded up to the mesh's quantum
    k = max(n_stripe * max(1, 32 // n_stripe), 2)
    m = 8
    nb_min = -(-(min_logical_mib * 2**20) // (k * block_size))
    quantum = max(n_stripe * n_block, 2 * n_block)
    nb = -(-nb_min // quantum) * quantum
    data = flagship.example_chunk(k, nb * block_size)

    step = flagship.make_multichip_step(mesh, k, m, block_size)
    parity, dcrc, pcrc = (a.gather() for a in step(data))
    want, want_dcrc, want_pcrc = CpuChunkEncoder().encode_with_checksums(
        k, m, data, block_size=block_size
    )
    _require(np.array_equal(parity.reshape(m, -1), want), "sharded parity = golden")
    _require(np.array_equal(dcrc, want_dcrc), "sharded data CRCs = golden")
    _require(np.array_equal(pcrc, want_pcrc), "sharded parity CRCs = golden")

    # leg 2: kill a data part mid-stripe and rebuild it over the same
    # mesh, then check its bytes and its block CRCs against leg 1
    kill = k // 2
    available = [i for i in range(k + m) if i != kill]
    rec_step = flagship.make_multichip_reconstruct_step(
        mesh, k, m, available, [kill], block_size
    )
    all_parts = np.concatenate([data, parity.reshape(m, -1)])
    rec, rcrc = (a.gather() for a in rec_step(all_parts[rec_step.used]))
    _require(np.array_equal(rec.reshape(-1), data[kill]), f"rebuilt part {kill} = golden")
    _require(np.array_equal(rcrc[0], want_dcrc[kill]), f"CRCs of rebuilt part {kill}")
    print(
        f"dryrun_multichip OK: ec({k},{m}) wide-stripe encode and "
        f"reconstruct over a {n_devices}-device mesh {mesh.shape} (part "
        f"{kill} killed, rebuilt byte-identical, CRCs verified)"
    )
    return {"mesh": mesh, "k": k, "m": m, "block_size": block_size, "nb": nb,
            "kill": kill, "parts": all_parts}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what} failed")
