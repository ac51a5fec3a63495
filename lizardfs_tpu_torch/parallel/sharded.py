"""Wide-stripe erasure coding sharded over a mesh of devices.

Counterpart of the JAX package's ``parallel/sharded.py``, with its layout
and its checks. As there, one process drives the whole mesh (the
reference runs one program over it through ``shard_map``); here the mesh
is an explicit grid of torch devices and each step is plain host code
around the kernel wrappers:

  * the data parts are split over mesh axis "stripe" (k/n parts a
    device) and, on a 2-D mesh, their block range over axis "block";
  * each device applies its contiguous column slice of the bit-plane
    matrix to its parts with ``cuda_ec.encode`` (on its own stream): a
    GF(2^8) partial of the output rows over its block range;
  * the partial is cut into one block range per device of the stripe
    axis, each range goes to its owner with ``Tensor.to`` (a peer copy
    between cards), and the owner XORs the ranges it receives. GF(2^8)
    addition is XOR, so this is the reference's ``psum_scatter`` then
    ``& 1`` (``sharded.py:98-103`` of the JAX package), moving the output
    bytes instead of int32 bit sums; NCCL has no XOR reduction;
  * ``cuda_ec.block_crcs`` checksums each owner's output range and each
    device's own data.

Outputs keep the reference's out-specs: parity (m, nb, bs) block-sharded
over (block, stripe), data CRCs (k, nb) by part over stripe and by block
over block, parity CRCs (m, nb) block-sharded. A step returns them as
:class:`ShardedArray` s, whose shards live on the devices those specs
name and whose :meth:`ShardedArray.gather` gives the host array.

On a mesh whose entries are one device (the CPU in the tests) ``to``
returns the tensor itself, not a copy: the exchange therefore never
writes in place into what it received.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lizardfs_tpu_torch.ops import cuda_ec, torch_ec


AXES = ("stripe", "block")


class Mesh:
    """An ordered grid of torch devices: ``devices`` is an object array of
    shape (stripe,) or (stripe, block). Axis "stripe" splits the parts of
    a stripe, axis "block" (2-D only) their block ranges."""

    def __init__(self, devices, shape: tuple[int, ...]):
        grid = np.empty(len(devices), dtype=object)
        grid[:] = [torch.device(d) for d in devices]
        self.devices = grid.reshape(shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _default_devices() -> list[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "no CUDA device: a mesh defaults to every visible card; pass "
            "devices (for example ['cpu'] * n) to build one without a card"
        )
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible CUDA device)."""
    devices = list(devices) if devices is not None else _default_devices()
    return Mesh(devices, (len(devices),))


def make_mesh_2d(stripe: int, block: int, devices=None) -> Mesh:
    """2-D mesh: stripe-parallel x block-parallel (parts of one stripe
    spread over the stripe axis and joined by the exchange; disjoint
    block ranges over the block axis, with no communication)."""
    devices = list(devices) if devices is not None else _default_devices()
    if stripe * block != len(devices):
        raise ValueError(
            f"mesh {stripe}x{block} needs {stripe * block} devices, "
            f"have {len(devices)}"
        )
    return Mesh(devices, (stripe, block))


class Shard(NamedTuple):
    """One device's piece of a :class:`ShardedArray`: ``index`` says where
    ``data`` (on that device) sits in the global array."""

    index: tuple[slice, ...]
    data: torch.Tensor


class ShardedArray:
    """A global array held as shards on a mesh's devices, each element on
    exactly one. CRC arrays hold int32 bits on the devices and gather to
    numpy uint32, byte arrays to uint8."""

    def __init__(self, shape: tuple[int, ...], shards: list[Shard], crc: bool = False):
        self.shape = tuple(shape)
        self.shards = shards
        self.crc = crc

    def gather(self) -> np.ndarray:
        dtype = np.uint32 if self.crc else np.uint8
        if len(self.shards) == 1:  # one device holds it all: no second copy
            return _to_host(self.shards[0].data).view(dtype).reshape(self.shape)
        out = np.empty(self.shape, dtype)
        for shard in self.shards:
            host = _to_host(shard.data)
            out[shard.index] = host.view(np.uint32) if self.crc else host
        return out


def stripe_block_grid(mesh: Mesh) -> np.ndarray:
    """The mesh as a (stripe, block) grid; a 1-D mesh has one block column."""
    return mesh.devices.reshape(mesh.devices.shape[0], -1)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, copied off a card through a pinned buffer."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def dims(parts) -> tuple[int, int]:
    """(rows, bytes a row) of a (rows, N) array or tensor or a list of rows."""
    return len(parts), len(parts[0])


def _to_device(parts, rows: slice, cols: slice, dev: torch.device) -> torch.Tensor:
    """``parts[rows, cols]`` as a contiguous uint8 tensor on ``dev``. A
    tensor is sliced and moved; numpy rows are copied once into a pinned
    buffer (on a card) that is uploaded without waiting."""
    if isinstance(parts, torch.Tensor):
        return parts[rows, cols].to(dev).contiguous()
    selected = parts[rows]
    pinned = dev.type == "cuda"
    host = torch.empty((len(selected), cols.stop - cols.start), dtype=torch.uint8,
                       pin_memory=pinned)
    staged = host.numpy()
    for i, row in enumerate(selected):
        staged[i] = row[cols]
    return host.to(dev, non_blocking=True) if pinned else host


class MeshApply:
    """One GF matrix applied over a mesh: ``(8w, 8r)`` ``bigm`` to r input
    rows split over the stripe axis, output rows block-sharded over
    (block, stripe), with block CRCs of the outputs and optionally of the
    inputs. The column slice of each device is uploaded once, contiguous,
    so the kernels' table cache (kept per matrix tensor) reads it once."""

    def __init__(self, mesh: Mesh, bigm: np.ndarray, block_size: int, crc_inputs: bool):
        torch_ec.check_block_size(block_size)
        self.grid = stripe_block_grid(mesh)
        n_stripe, _ = self.grid.shape
        self.w, self.r = bigm.shape[0] // 8, bigm.shape[1] // 8
        self.r_loc = self.r // n_stripe
        self.block_size = block_size
        self.crc_inputs = crc_inputs
        cols = 8 * self.r_loc
        self.mats = {
            pos: torch.from_numpy(
                np.ascontiguousarray(bigm[:, cols * pos[0]:cols * (pos[0] + 1)])
            ).to(dev)
            for pos, dev in np.ndenumerate(self.grid)
        }

    def __call__(self, parts):
        """``parts``: the r input rows, a (r, N) array or tensor or a list
        of r equal-length numpy rows."""
        n_stripe, n_block = self.grid.shape
        w, r_loc, bs = self.w, self.r_loc, self.block_size
        nbytes = dims(parts)[1]
        nb = nbytes // bs
        n_loc = nbytes // n_block  # bytes of a device's block range
        nb_loc = nb // n_block
        nb_own = nb_loc // n_stripe  # blocks an owner gets in the exchange
        local = {}
        partials = {}
        for (s, b), dev in np.ndenumerate(self.grid):
            local[s, b] = _to_device(parts, slice(r_loc * s, r_loc * (s + 1)),
                                     slice(n_loc * b, n_loc * (b + 1)), dev)
            partials[s, b] = cuda_ec.encode(self.mats[s, b], local[s, b])
        out_shards, crc_shards = [], []
        for (t, b), owner in np.ndenumerate(self.grid):
            acc = None
            for s in range(n_stripe):
                piece = partials[s, b].view(w, n_stripe, nb_own * bs)[:, t].to(owner)
                acc = piece if acc is None else acc ^ piece  # out of place
            out = acc.contiguous().view(w, nb_own, bs)
            crcs = cuda_ec.block_crcs(out.view(w * nb_own, bs), bs).view(w, nb_own)
            blocks = slice(nb_own * (n_stripe * b + t), nb_own * (n_stripe * b + t + 1))
            out_shards.append(Shard((slice(None), blocks, slice(None)), out))
            crc_shards.append(Shard((slice(None), blocks), crcs))
        result = [ShardedArray((w, nb, bs), out_shards),
                  ShardedArray((w, nb), crc_shards, crc=True)]
        if self.crc_inputs:
            in_shards = []
            for (s, b), rows in local.items():
                crcs = cuda_ec.block_crcs(rows.view(r_loc * nb_loc, bs), bs)
                index = (slice(r_loc * s, r_loc * (s + 1)), slice(nb_loc * b, nb_loc * (b + 1)))
                in_shards.append(Shard(index, crcs.view(r_loc, nb_loc)))
            result.append(ShardedArray((self.r, nb), in_shards, crc=True))
        return result


def sharded_encode_with_crcs(mesh: Mesh, k: int, m: int, block_size: int):
    """Build a wide-stripe encode+CRC step over ``mesh``.

    Returns ``run(data)`` where data is (k, nb*block_size) uint8 (numpy,
    a list of k numpy rows, or a tensor on any device); outputs are
    ShardedArrays (parity (m, nb, block_size) block-sharded, data_crcs
    (k, nb), parity_crcs (m, nb)). nb and k must be divisible by the mesh
    size.
    """
    grid = stripe_block_grid(mesh)
    n_stripe, n_block = grid.shape
    if k % n_stripe:
        raise ValueError(f"k={k} not divisible by stripe axis {n_stripe}")
    step = MeshApply(mesh, torch_ec.encoding_bitmatrix(k, m), block_size, crc_inputs=True)

    def run(data):
        rows, nbytes = dims(data)
        nb = nbytes // block_size
        if nbytes % block_size or nb % (n_stripe * n_block):
            raise ValueError(
                f"data bytes per part must be nb*{block_size} with nb "
                f"divisible by mesh extent {n_stripe * n_block}; got "
                f"{nbytes}"
            )
        if rows != k:
            raise ValueError(f"need the {k} data parts stacked, got {rows}")
        parity, pcrc, dcrc = step(data)
        return parity, dcrc, pcrc

    return run
