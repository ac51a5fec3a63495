"""Chunk <-> part striping math.

How chunk bytes map onto slice parts (the layout contract shared by the
client write path, the chunkserver replicator, and the read plans):

  * blocks of 64 KiB are striped round-robin over the d data parts
    (block i of the chunk lands in data part i % d at block i // d),
  * xorN slices store data in parts 1..N and the per-stripe XOR parity
    in part 0; ec(k,m) stores data in parts 0..k-1, RS parity in parts
    k..k+m-1,
  * parity is computed over zero-padded 64 KiB blocks; part byte lengths
    follow geometry.chunk_length_to_part_length.

Reference behavior: src/mount/chunk_writer.cc:365-398 (parity from
stripes), src/common/slice_traits.h:311-349 (lengths).
"""

from __future__ import annotations

import numpy as np

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.core.encoder import ChunkEncoder, get_encoder


def padded_data_parts(
    data: np.ndarray, d: int, out: np.ndarray | None = None
) -> tuple[list[np.ndarray], int]:
    """Split chunk bytes into d zero-padded equal part streams.

    Returns (parts, part_len) where part_len covers ceil(blocks/d) blocks.
    One native (GIL-free) or vectorized-numpy pass — this runs on every
    EC/xor chunk write, so a per-block Python loop here throttled the
    whole write pipeline. ``out`` (C-contiguous uint8 of shape
    (d, part_len)) receives the streams, and the parts are its rows.
    """
    nbytes = data.shape[0]
    nblocks = (nbytes + MFSBLOCKSIZE - 1) // MFSBLOCKSIZE
    blocks_per_part = (nblocks + d - 1) // d
    part_len = blocks_per_part * MFSBLOCKSIZE
    stacked = np.empty((d, part_len), dtype=np.uint8) if out is None else out
    if stacked.shape != (d, part_len) or not stacked.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous of shape {(d, part_len)}")
    from lizardfs_tpu_torch.core import native

    if native.stripe_helpers_available():
        native.stripe_scatter(data, d, blocks_per_part, out=stacked)
        return list(stacked), part_len
    # numpy fallback: pad to the full stripe grid, then one strided copy
    # block i -> part i%d, slot i//d
    full = np.zeros(d * blocks_per_part * MFSBLOCKSIZE, dtype=np.uint8)
    full[:nbytes] = data
    grid = full.reshape(blocks_per_part, d, MFSBLOCKSIZE)
    stacked.reshape(d, blocks_per_part, MFSBLOCKSIZE)[...] = grid.transpose(1, 0, 2)
    return list(stacked), part_len


def split_chunk(
    data: np.ndarray,
    slice_type: geometry.SliceType,
    encoder: ChunkEncoder | None = None,
) -> dict[int, np.ndarray]:
    """Split chunk bytes into all parts of a slice (padded streams).

    Returned arrays are zero-padded to whole blocks; callers truncate to
    geometry.chunk_length_to_part_length for the on-wire/on-disk length.
    ``encoder`` defaults to the CUDA encoder on ``cuda:0``.
    """
    data = np.asarray(data, dtype=np.uint8)
    if slice_type.is_standard or slice_type.is_tape:
        return {0: data.copy()}
    enc = encoder or get_encoder()
    d = slice_type.data_parts
    parts, _ = padded_data_parts(data, d)
    if slice_type.is_xor:
        parity = enc.xor_parity(parts)
        out = {0: parity}
        for i, p in enumerate(parts):
            out[i + 1] = p
        return out
    assert slice_type.is_ec
    m = slice_type.parity_parts
    parity = enc.encode(d, m, parts)
    out = {i: p for i, p in enumerate(parts)}
    for j, p in enumerate(parity):
        out[d + j] = p
    return out


def part_length(
    slice_type: geometry.SliceType, part: int, chunk_length: int
) -> int:
    return geometry.chunk_length_to_part_length(
        geometry.ChunkPartType(slice_type, part), chunk_length
    )


def assemble_chunk(
    data_parts: dict[int, np.ndarray],
    slice_type: geometry.SliceType,
    chunk_length: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Reassemble chunk bytes from *data* part streams (inverse of
    split_chunk for the data portion). ``out``, when given, receives the
    bytes directly (must be C-contiguous uint8 of >= chunk_length)."""
    if slice_type.is_standard or slice_type.is_tape:
        piece = np.asarray(data_parts[0][:chunk_length])
        if out is None:
            return piece
        out[:chunk_length] = piece
        return out[:chunk_length]
    d = slice_type.data_parts
    first_data = 1 if slice_type.is_xor else 0
    nblocks = (chunk_length + MFSBLOCKSIZE - 1) // MFSBLOCKSIZE
    blocks_per_part = (nblocks + d - 1) // d
    part_len = blocks_per_part * MFSBLOCKSIZE
    from lizardfs_tpu_torch.core import native

    # each part must cover the slots the gather reads from it: part p's
    # last-used block is the largest i < nblocks with i % d == p
    def _covered(p: int) -> int:
        if nblocks <= p:
            return 0
        last_i = nblocks - 1 - ((nblocks - 1 - p) % d)
        slot = last_i // d
        tail = (
            chunk_length - last_i * MFSBLOCKSIZE
            if last_i == nblocks - 1
            else MFSBLOCKSIZE
        )
        return slot * MFSBLOCKSIZE + tail

    if (
        native.stripe_helpers_available()
        and out is not None
        and out.flags.c_contiguous
        and out.dtype == np.uint8
        and out.shape[0] >= chunk_length
        and all(
            data_parts[first_data + p].shape[0] >= _covered(p)
            and data_parts[first_data + p].flags.c_contiguous
            for p in range(d)
        )
    ):
        native.stripe_gather(
            [data_parts[first_data + p] for p in range(d)],
            chunk_length, out=out,
        )
        return out[:chunk_length]
    # numpy path: stack (d, slots, B), transpose to (slots, d, B) = block
    # order, flatten
    stacked = np.zeros((d, part_len), dtype=np.uint8)
    for p in range(d):
        src = data_parts[first_data + p]
        stacked[p, : min(part_len, src.shape[0])] = src[:part_len]
    grid = stacked.reshape(d, blocks_per_part, MFSBLOCKSIZE)
    flat = np.ascontiguousarray(grid.transpose(1, 0, 2)).reshape(-1)
    if out is not None:
        out[:chunk_length] = flat[:chunk_length]
        return out[:chunk_length]
    return flat[:chunk_length]
