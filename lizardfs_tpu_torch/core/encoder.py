"""The ChunkEncoder boundary of the port: the seam between the file
system and the erasure-coding compute.

Counterpart of the JAX package's ``core/encoder.py`` with two backends:

  * ``CpuChunkEncoder`` — the numpy golden path
    (:mod:`lizardfs_tpu_torch.ops.rs`), byte-identical to the reference's
    ISA-L/galois_field codec; the correctness oracle.
  * ``CudaChunkEncoder`` — the CUDA kernels behind
    :mod:`lizardfs_tpu_torch.ops.cuda_ec`, with pinned host staging.
  * ``ShardedCudaChunkEncoder`` — ``CudaChunkEncoder`` whose ``recover``
    rides a mesh of cards (:mod:`lizardfs_tpu_torch.parallel.recovery`)
    where the geometry divides it.

Parts are equal-length 1-D uint8 numpy arrays; part indices are global:
0..k-1 data, k..k+m-1 parity.
"""

from __future__ import annotations

import abc
import threading

import numpy as np
import torch

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.ops import crc32, cuda_ec, gf256, rs, torch_ec
from lizardfs_tpu_torch.parallel import recovery, sharded

_MATRIX_CACHE = 256  # device matrices an encoder keeps (oldest dropped first)
_STEP_CACHE = 64  # mesh rebuild steps a sharded encoder keeps (then cleared)


class ChunkEncoder(abc.ABC):
    """EC compute backend interface."""

    name: str

    @abc.abstractmethod
    def encode(
        self, k: int, m: int, data_parts: list[np.ndarray | None]
    ) -> list[np.ndarray]:
        """Compute the m parity parts from the k data parts (None = zeros)."""

    @abc.abstractmethod
    def recover(
        self,
        k: int,
        m: int,
        parts: dict[int, np.ndarray | None],
        wanted: list[int],
    ) -> dict[int, np.ndarray]:
        """Recover ``wanted`` global part indices from any >=k available parts."""

    @abc.abstractmethod
    def checksum(self, blocks: np.ndarray) -> np.ndarray:
        """CRC32 of each row of a (n, block_size) uint8 array -> (n,) uint32."""

    @abc.abstractmethod
    def encode_with_checksums(
        self, k: int, m: int, data: np.ndarray, block_size: int = MFSBLOCKSIZE
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fused parity + per-block CRCs of data and parity.

        data: (k, N) with N a multiple of block_size. Returns
        (parity (m, N), data_crcs (k, N//bs), parity_crcs (m, N//bs)).
        """

    def xor_parity(self, parts: list[np.ndarray]) -> np.ndarray:
        """XOR parity (xor2..xor9 goals)."""
        return rs.xor_parity(parts)

    def encode_into(
        self,
        k: int,
        m: int,
        data_parts: list[np.ndarray],
        out: list[np.ndarray],
    ) -> None:
        """``encode`` writing the m parity streams into caller buffers
        (m contiguous uint8 arrays, each the length of a data part)."""
        parity = self.encode(k, m, data_parts)
        for dst, src in zip(out, parity):
            np.copyto(dst, src)

    def xor_parity_into(self, parts: list[np.ndarray], out: np.ndarray) -> None:
        """``xor_parity`` writing into a caller buffer (see encode_into)."""
        np.copyto(out, parts[0])
        for p in parts[1:]:
            np.bitwise_xor(out, p, out=out)


class CpuChunkEncoder(ChunkEncoder):
    """Golden numpy backend (reference-identical bytes)."""

    name = "cpu"

    def encode(self, k, m, data_parts):
        return rs.encode(k, m, data_parts)

    def recover(self, k, m, parts, wanted):
        return rs.recover(k, m, parts, wanted)

    def checksum(self, blocks):
        return crc32.block_crcs_golden(np.ascontiguousarray(blocks))

    def encode_with_checksums(self, k, m, data, block_size=MFSBLOCKSIZE):
        nb = data.shape[1] // block_size
        parity = np.stack(rs.encode(k, m, list(data)))
        data_crcs = self.checksum(data.reshape(k * nb, block_size)).reshape(k, nb)
        parity_crcs = self.checksum(parity.reshape(m * nb, block_size)).reshape(m, nb)
        return parity, data_crcs, parity_crcs


def _columns(bigm: np.ndarray, keep: list[int]) -> np.ndarray:
    """Zero-part elision on a bit-plane matrix: keep the 8 columns of
    each listed input (encoder.py:178-209 of the JAX package)."""
    cols = np.concatenate([np.arange(8 * i, 8 * i + 8) for i in keep])
    return bigm[:, cols]


class CudaChunkEncoder(ChunkEncoder):
    """The CUDA kernels behind the encoder surface.

    ``encode``/``recover`` run the GF apply kernel, ``checksum`` the
    block CRC kernel, ``encode_with_checksums`` the fused kernel. Inputs
    go to the card through pinned host buffers and results come back the
    same way. ``device`` defaults to ``cuda:0``; ``device="cpu"`` runs
    every method through the kernels' plain PyTorch versions (tests).

    One encoder serves concurrent threads (the client encodes each chunk
    of a write in ``asyncio.to_thread``): the matrix cache is guarded by
    a lock, and each call stages, launches and fetches on its thread's
    current stream, whose copies back to the host wait for the kernel.
    """

    name = "cuda"

    def __init__(self, device=None):
        self.device = cuda_ec.resolve_device(device)
        self._pinned = self.device.type == "cuda"
        # device copies of the bit-plane matrices, by shape and bytes: the
        # kernels' table cache is kept per matrix tensor, so a matrix
        # uploaded once is read back once
        self._matrices: dict[tuple, torch.Tensor] = {}
        self._matrices_lock = threading.Lock()

    def _stage(self, rows) -> torch.Tensor:
        """Equal-length 1-D byte arrays -> one (len(rows), N) uint8 tensor
        on the device, copied through a pinned host buffer."""
        n = len(rows[0])
        host = torch.empty((len(rows), n), dtype=torch.uint8, pin_memory=self._pinned)
        h = host.numpy()
        for i, row in enumerate(rows):
            if len(row) != n:
                raise ValueError("all parts must have equal size")
            h[i] = row
        return host.to(self.device, non_blocking=True) if self._pinned else host

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        if not self._pinned:
            return t.numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host.numpy()

    def _fetch_crcs(self, t: torch.Tensor) -> np.ndarray:
        return self._fetch(t).view(np.uint32)

    def _matrix(self, bigm: np.ndarray) -> torch.Tensor:
        bigm = np.ascontiguousarray(bigm)
        key = (bigm.shape, bigm.tobytes())
        with self._matrices_lock:
            t = self._matrices.get(key)
            if t is None:
                if len(self._matrices) >= _MATRIX_CACHE:
                    self._matrices.pop(next(iter(self._matrices)))
                t = self._matrices[key] = torch.from_numpy(bigm).to(self.device)
        return t

    def _encode(self, k, m, data_parts) -> torch.Tensor:
        if len(data_parts) != k:
            raise ValueError(f"expected {k} data parts, got {len(data_parts)}")
        nonzero = [i for i, p in enumerate(data_parts) if p is not None]
        if not nonzero:
            raise ValueError("at least one data part must be non-None")
        bigm = torch_ec.encoding_bitmatrix(k, m)
        if len(nonzero) < k:
            bigm = _columns(bigm, nonzero)
        data = self._stage([data_parts[i] for i in nonzero])
        return cuda_ec.encode(self._matrix(bigm), data)

    def encode(self, k, m, data_parts):
        return list(self._fetch(self._encode(k, m, data_parts)))

    def encode_into(self, k, m, data_parts, out):
        parity = self._encode(k, m, data_parts)
        for dst, row in zip(out, parity):
            torch.from_numpy(dst).copy_(row)

    def recover(self, k, m, parts, wanted):
        used, _ = gf256.recovery_selection(k, m, list(parts.keys()), wanted)
        bigm = torch_ec.recovery_bitmatrix(k, m, tuple(used), tuple(wanted))
        nonzero_pos = [j for j, i in enumerate(used) if parts[i] is not None]
        if not nonzero_pos:
            raise ValueError("at least one available part must be non-None")
        if len(nonzero_pos) < len(used):
            bigm = _columns(bigm, nonzero_pos)
        data = self._stage([parts[used[j]] for j in nonzero_pos])
        out = self._fetch(cuda_ec.encode(self._matrix(bigm), data))
        return {w: out[i] for i, w in enumerate(wanted)}

    def checksum(self, blocks):
        blocks = np.asarray(blocks, dtype=np.uint8)
        crcs = cuda_ec.block_crcs(self._stage(blocks), blocks.shape[1])
        return self._fetch_crcs(crcs)

    def encode_with_checksums(self, k, m, data, block_size=MFSBLOCKSIZE):
        bigm = self._matrix(torch_ec.encoding_bitmatrix(k, m))
        parity, dcrc, pcrc = cuda_ec.fused_encode_crc(bigm, self._stage(data), block_size)
        return self._fetch(parity), self._fetch_crcs(dcrc), self._fetch_crcs(pcrc)

    def xor_parity(self, parts):
        return self._fetch(torch_ec.xor_reduce(self._stage(parts)))

    def xor_parity_into(self, parts, out):
        torch.from_numpy(out).copy_(torch_ec.xor_reduce(self._stage(parts)))


class MeshUnavailable(RuntimeError):
    """The sharded encoder's refusal: its switch is off
    (``LZ_SHARDED_RECOVERY=0``) or fewer than two cards are visible.
    Callers that fall back to one card catch this type only, so a
    kernel's build or launch error still surfaces."""


class ShardedCudaChunkEncoder(CudaChunkEncoder):
    """Mesh-sharded wide-stripe backend, the counterpart of the JAX
    package's ``ShardedTpuChunkEncoder``: ``recover`` rides the mesh
    (parallel/recovery.py) whenever the geometry divides it and runs
    ``CudaChunkEncoder.recover`` on the mesh's first device otherwise;
    every other method runs on that device. ``recovers`` counts the calls
    that took each path. ``LZ_SHARDED_RECOVERY=0`` kills it: the
    constructor refuses, and a live instance rebuilds on one card (the
    switch is read at call time).

    With no mesh it needs two or more cards and builds :func:`make_mesh`
    over all of them; an explicit mesh of any size is taken as it is. The
    constructor's two refusals (switch off, fewer than two cards) raise
    :class:`MeshUnavailable`.
    """

    name = "sharded"

    def __init__(self, mesh=None):
        if not recovery.enabled():
            raise MeshUnavailable("sharded recovery disabled (LZ_SHARDED_RECOVERY=0)")
        if mesh is None:
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if cards < 2:
                raise MeshUnavailable(f"mesh-sharded recovery needs >= 2 cards, have {cards}")
            mesh = sharded.make_mesh()
        super().__init__(mesh.devices.flat[0])
        self.mesh = mesh
        self.recovers = {"mesh": 0, "card": 0}
        # rebuild steps (their per-device matrices and tables) by geometry
        # and erasure pattern: a replicator's steady state is a handful
        self._rec_steps: dict[tuple, object] = {}

    def _mesh_recover_step(self, k, m, avail, wanted, block_size):
        key = (k, m, avail, wanted, block_size)
        step = self._rec_steps.get(key)
        if step is None:
            step = recovery.sharded_reconstruct_with_crcs(
                self.mesh, k, m, list(avail), list(wanted), block_size)
            if len(self._rec_steps) > _STEP_CACHE:
                self._rec_steps.clear()
            self._rec_steps[key] = step
        return step

    def recover(self, k, m, parts, wanted):
        nbytes = next((len(p) for p in parts.values() if p is not None), 0)
        # the mesh path needs: the kill switch open, k parts dividing the
        # mesh, the bytes dividing it into blocks the CRC takes (64 x 2^a;
        # the JAX package's guard asks only for a multiple of 64), and no
        # elided (None) inputs
        n = self.mesh.size
        block = nbytes // n
        if (
            not recovery.enabled()
            or k % n
            or nbytes % n
            or not torch_ec.is_block_size(block)
            or any(p is None for p in parts.values())
        ):
            self.recovers["card"] += 1
            return super().recover(k, m, parts, wanted)
        wanted = list(wanted)
        step = self._mesh_recover_step(k, m, tuple(sorted(parts)), tuple(wanted), block)
        rec, _crcs = step([np.asarray(parts[i]) for i in step.used])
        out = rec.gather().reshape(len(wanted), -1)
        self.recovers["mesh"] += 1
        return {w: out[i] for i, w in enumerate(wanted)}


# One encoder per (name, device), as the JAX package keeps one per name:
# an encoder's device matrices, and so the kernels' tables, outlive a call.
_ENCODERS: dict[tuple, ChunkEncoder] = {}


def get_encoder(name: str | None = None, device=None) -> ChunkEncoder:
    """Encoder by name, one object per (name, device): "cpu" (numpy
    golden), "cuda" (the kernels on ``device``, default ``cuda:0``) or
    "sharded" (:class:`ShardedCudaChunkEncoder` over every card). None or
    "auto" without a device tries "sharded" (two or more cards, switch
    open) and then "cuda"; nothing lands on the CPU unless asked to. Only
    "cuda" and "auto" take a device."""
    if name in (None, "auto"):
        if device is None:
            try:
                return get_encoder("sharded")
            except MeshUnavailable:
                pass
        name = "cuda"
    if name not in ("cpu", "cuda", "sharded"):
        raise ValueError(f"unknown encoder backend {name!r}")
    if device is not None and name != "cuda":
        raise ValueError(f"encoder backend {name!r} takes no device, got {device!r}")
    key = (name, cuda_ec.resolve_device(device) if name == "cuda" else None)
    if key not in _ENCODERS:
        _ENCODERS[key] = (
            CudaChunkEncoder(key[1]) if name == "cuda"
            else CpuChunkEncoder() if name == "cpu"
            else ShardedCudaChunkEncoder()
        )
    return _ENCODERS[key]
