"""Slice geometry: slice types, chunk part types, part-size math.

The subset of the JAX package's ``core/geometry.py`` that striping needs
(the goal grammar is not ported yet). Encodings are the reference's
(src/common/goal.h:108-166, src/common/chunk_part_type.h:143-198,
src/common/slice_traits.h):

  * slice type id: std=0, tape=1, xor2..xor9=2..9,
    ec(k,m) = 10 + 32*(k-2) + (m-1)  (k in [2,32], m in [1,32])
  * chunk part id: type_id * 64 + part_index
  * xor slices: part 0 is parity, parts 1..N are data
  * ec slices: parts 0..k-1 are data, k..k+m-1 are parity
"""

from __future__ import annotations

from dataclasses import dataclass

from lizardfs_tpu_torch.constants import (
    EC_MAX_DATA,
    EC_MAX_PARITY,
    EC_MIN_DATA,
    EC_MIN_PARITY,
    MFSBLOCKSIZE,
    XOR_MAX_LEVEL,
    XOR_MIN_LEVEL,
)

STANDARD = 0
TAPE = 1
XOR_FIRST = 2  # xor2
XOR_LAST = 9  # xor9
EC_FIRST = 10
EC_LAST = EC_FIRST + 31 * 32 - 1  # ec(32,32)

MAX_PARTS_PER_SLICE = 64  # chunk_part_type.h:145


class SliceType(int):
    """A slice type id with geometry accessors."""

    @property
    def is_standard(self) -> bool:
        return self == STANDARD

    @property
    def is_tape(self) -> bool:
        return self == TAPE

    @property
    def is_xor(self) -> bool:
        return XOR_FIRST <= self <= XOR_LAST

    @property
    def is_ec(self) -> bool:
        return EC_FIRST <= self <= EC_LAST

    @property
    def xor_level(self) -> int:
        if not self.is_xor:
            raise ValueError(f"{self!r} is not an xor slice")
        return self - XOR_FIRST + XOR_MIN_LEVEL

    @property
    def data_parts(self) -> int:
        """Number of data parts (slice_traits.h:227-235)."""
        if self.is_xor:
            return self.xor_level
        if self.is_ec:
            return EC_MIN_DATA + (self - EC_FIRST) // 32
        return 1

    @property
    def parity_parts(self) -> int:
        if self.is_xor:
            return 1
        if self.is_ec:
            return EC_MIN_PARITY + (self - EC_FIRST) % 32
        return 0

    @property
    def expected_parts(self) -> int:
        """Total parts in a full slice (goal.h:148-152)."""
        if self.is_ec:
            return self.data_parts + self.parity_parts
        if self.is_xor:
            return self.xor_level + 1
        return 1

    def __repr__(self) -> str:
        return f"SliceType({self.to_string()})"

    def to_string(self) -> str:
        if self.is_ec:
            return f"ec({self.data_parts},{self.parity_parts})"
        if self.is_xor:
            return f"xor{self.xor_level}"
        return {STANDARD: "std", TAPE: "tape"}.get(int(self), f"?{int(self)}")


def xor_type(level: int) -> SliceType:
    if not XOR_MIN_LEVEL <= level <= XOR_MAX_LEVEL:
        raise ValueError(f"xor level {level} out of range")
    return SliceType(XOR_FIRST + level - XOR_MIN_LEVEL)


def ec_type(k: int, m: int) -> SliceType:
    """ec(k,m) slice type id (slice_traits.h:148-151)."""
    if not (EC_MIN_DATA <= k <= EC_MAX_DATA and EC_MIN_PARITY <= m <= EC_MAX_PARITY):
        raise ValueError(f"ec({k},{m}) out of range")
    return SliceType(EC_FIRST + 32 * (k - EC_MIN_DATA) + (m - EC_MIN_PARITY))


@dataclass(frozen=True, order=True)
class ChunkPartType:
    """(slice type, part index) packed as id = type*64 + part."""

    type: SliceType
    part: int

    @property
    def id(self) -> int:
        return int(self.type) * MAX_PARTS_PER_SLICE + self.part

    @property
    def is_parity(self) -> bool:
        if self.type.is_xor:
            return self.part == 0  # xor parity is part 0
        if self.type.is_ec:
            return self.part >= self.type.data_parts
        return False

    @property
    def is_data(self) -> bool:
        return not self.is_parity

    @property
    def data_part_index(self) -> int:
        """Stripe position of a data part (xor data parts are 1-based)."""
        if self.type.is_xor:
            return self.part - 1
        return self.part

    def to_string(self) -> str:
        return f"{self.type.to_string()}:{self.part}"

    def __repr__(self) -> str:
        return f"ChunkPartType({self.to_string()})"


def chunk_length_to_part_length(cpt: ChunkPartType, chunk_length: int) -> int:
    """Byte length of a part given total chunk length
    (slice_traits.h:332-349)."""
    d = cpt.type.data_parts
    if d == 1:
        return chunk_length
    full_stripe = chunk_length // (d * MFSBLOCKSIZE)
    base_len = full_stripe * MFSBLOCKSIZE
    rest = chunk_length - base_len * d
    idx = cpt.data_part_index if cpt.is_data else 0
    part_rest = max(rest - idx * MFSBLOCKSIZE, 0)
    return base_len + min(part_rest, MFSBLOCKSIZE)


def required_parts_to_recover(t: SliceType) -> int:
    return t.data_parts
