"""Slice/goal geometry: slice types, chunk part types, part-size math,
and the goal grammar.

The port's copy of the JAX package's ``core/geometry.py`` (tests pin the
two together), after the reference's goal/slice model
(src/common/goal.h:108-166 slice-type ids,
src/common/chunk_part_type.h:143-198 part-id packing,
src/common/slice_traits.h part geometry). The wire/disk encodings are
kept identical so on-disk chunk names and protocol ids are compatible:

  * slice type id: std=0, tape=1, xor2..xor9=2..9,
    ec(k,m) = 10 + 32*(k-2) + (m-1)  (k in [2,32], m in [1,32])
  * chunk part id: type_id * 64 + part_index
  * xor slices: part 0 is parity, parts 1..N are data
  * ec slices: parts 0..k-1 are data, k..k+m-1 are parity

Everything here is a pure function over ints, with no state.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from lizardfs_tpu_torch.constants import (
    EC_MAX_DATA,
    EC_MAX_PARITY,
    EC_MIN_DATA,
    EC_MIN_PARITY,
    MFSBLOCKSINCHUNK,
    MFSBLOCKSIZE,
    XOR_MAX_LEVEL,
    XOR_MIN_LEVEL,
)

# --- slice type ids (goal.h:108-120) ---------------------------------------

STANDARD = 0
TAPE = 1
XOR_FIRST = 2  # xor2
XOR_LAST = 9  # xor9
EC_FIRST = 10
EC_LAST = EC_FIRST + 31 * 32 - 1  # ec(32,32)
TYPE_COUNT = EC_LAST + 1

MAX_PARTS_PER_SLICE = 64  # chunk_part_type.h:145


class SliceType(int):
    """A slice type id with geometry accessors."""

    def is_valid(self) -> bool:
        return STANDARD <= self < TYPE_COUNT

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

    @classmethod
    def from_id(cls, part_id: int) -> "ChunkPartType":
        return cls(
            SliceType(part_id // MAX_PARTS_PER_SLICE),
            part_id % MAX_PARTS_PER_SLICE,
        )

    def is_valid(self) -> bool:
        return self.type.is_valid() and 0 <= self.part < self.type.expected_parts

    # part-role accessors (slice_traits.h:213-295)
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

    @property
    def parity_part_index(self) -> int:
        if self.type.is_ec:
            return self.part - self.type.data_parts
        return 0

    def to_string(self) -> str:
        return f"{self.type.to_string()}:{self.part}"

    def __repr__(self) -> str:
        return f"ChunkPartType({self.to_string()})"


def standard_part() -> ChunkPartType:
    return ChunkPartType(SliceType(STANDARD), 0)


def number_of_blocks_in_part(cpt: ChunkPartType, blocks_in_chunk: int = MFSBLOCKSINCHUNK) -> int:
    """Blocks stored in a given part (slice_traits.h:311-316).

    Blocks are striped round-robin over data parts; parity parts are as
    long as the longest (first) data part.
    """
    d = cpt.type.data_parts
    idx = cpt.data_part_index if cpt.is_data else 0
    return (blocks_in_chunk + (d - idx - 1)) // d


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


def stripe_size(cpt: ChunkPartType) -> int:
    return cpt.type.data_parts


def required_parts_to_recover(t: SliceType) -> int:
    return t.data_parts


# --- goals ------------------------------------------------------------------

WILDCARD_LABEL = "_"
MAX_GOAL_NAME = 32
MAX_LABELS_PER_SLICE = 40
GOAL_ID_MIN, GOAL_ID_MAX = 1, 40  # reference goal id range (goal.h:40-44)

_NAME_RE = re.compile(r"^[A-Za-z0-9_]{1,32}$")


@dataclass(frozen=True)
class Slice:
    """One slice of a goal: a type plus per-part label->count maps.

    The reference stores, for every part, a map of labels to copy counts
    (goal.h Slice). For std slices there is one part whose label counts
    describe the desired copies; for xor/ec slices each part usually has
    exactly one label (possibly the wildcard).
    """

    type: SliceType
    part_labels: tuple[tuple[tuple[str, int], ...], ...]  # per part: ((label, count),...)

    @classmethod
    def make(cls, type_: SliceType, labels_per_part: list[dict[str, int]]) -> "Slice":
        return cls(
            type_,
            tuple(tuple(sorted(d.items())) for d in labels_per_part),
        )

    @property
    def size(self) -> int:
        return len(self.part_labels)

    def labels_of_part(self, part: int) -> dict[str, int]:
        return dict(self.part_labels[part])


@dataclass(frozen=True)
class Goal:
    """A named replication goal: a set of slices (goal.h Goal)."""

    name: str
    slices: tuple[Slice, ...]

    def expected_copies(self) -> int:
        """Chunkserver copies the goal wants (disk slices only — tape
        copies are whole-file archives, not chunk placements)."""
        total = 0
        for s in self.slices:
            if s.type.is_tape:
                continue
            for part in s.part_labels:
                total += sum(c for _, c in part)
        return total

    def disk_slice(self) -> "Slice | None":
        """The slice that places chunk parts on chunkservers."""
        for s in self.slices:
            if not s.type.is_tape:
                return s
        return None

    def tape_copies(self) -> int:
        """Archival copies requested from tape servers (goal.h tape
        labels; served by the matotsserv analog)."""
        return len(self.tape_labels())

    def tape_labels(self) -> list[str]:
        """One entry per requested tape copy: a named label means a
        server with that label; the wildcard means any tape server."""
        out: list[str] = []
        for s in self.slices:
            if s.type.is_tape:
                for part in s.part_labels:
                    for lab, c in part:
                        out.extend([lab] * c)
        return out


def default_goals() -> dict[int, Goal]:
    """Goals 1..5 default to N plain copies (reference behavior)."""
    out = {}
    for gid in range(GOAL_ID_MIN, 6):
        s = Slice.make(SliceType(STANDARD), [{WILDCARD_LABEL: gid}])
        out[gid] = Goal(str(gid), (s,))
    for gid in range(6, GOAL_ID_MAX + 1):
        s = Slice.make(SliceType(STANDARD), [{WILDCARD_LABEL: 1}])
        out[gid] = Goal(str(gid), (s,))
    return out


class GoalConfigError(ValueError):
    pass


def parse_goal_line(line: str) -> tuple[int, Goal] | None:
    """Parse one mfsgoals.cfg line: ``id name : slice [| slice ...]``
    where a slice is ``[$type[(k,m)]] [{ labels } | labels]``.

    Grammar per doc/mfsgoals.cfg.5.txt:47-98, extended with the
    reference's multi-slice goals (goal.h Goal = set of slices): a
    ``$tape`` slice after ``|`` requests archival copies from tape
    servers (matotsserv.cc) in addition to the disk slice. Returns None
    for blank or comment lines.
    """
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    m = re.match(r"^(\d+)\s+(\S+)\s*:\s*(.*)$", line)
    if not m:
        raise GoalConfigError(f"malformed goal line: {line!r}")
    gid = int(m.group(1))
    name = m.group(2)
    rest = m.group(3).strip()
    if not (GOAL_ID_MIN <= gid <= GOAL_ID_MAX):
        raise GoalConfigError(f"goal id {gid} out of range [1,40]")
    if not _NAME_RE.match(name):
        raise GoalConfigError(f"invalid goal name {name!r}")

    slices = tuple(
        _parse_slice_segment(seg.strip(), line) for seg in rest.split("|")
    )
    disk = [s for s in slices if not s.type.is_tape]
    tape = [s for s in slices if s.type.is_tape]
    if len(disk) != 1:
        raise GoalConfigError(
            f"goal needs exactly one disk slice (std/xor/ec): {line!r}"
        )
    if len(tape) > 1:
        raise GoalConfigError(f"at most one $tape slice per goal: {line!r}")
    if tape and slices[0].type.is_tape:
        raise GoalConfigError(f"disk slice must come first: {line!r}")
    return gid, Goal(name, slices)


def _parse_slice_segment(rest: str, line: str) -> Slice:
    type_ = SliceType(STANDARD)
    labels_str = rest
    tm = re.match(r"^\$(\w+)(?:\(\s*(\d+)\s*,\s*(\d+)\s*\))?\s*(.*)$", rest)
    if tm:
        tname = tm.group(1)
        if tname == "std":
            type_ = SliceType(STANDARD)
        elif tname == "tape":
            type_ = SliceType(TAPE)
        elif tname.startswith("xor"):
            try:
                type_ = xor_type(int(tname[3:]))
            except ValueError as e:
                raise GoalConfigError(str(e)) from None
        elif tname == "ec":
            if tm.group(2) is None:
                raise GoalConfigError(f"ec goal needs (k,m): {line!r}")
            try:
                type_ = ec_type(int(tm.group(2)), int(tm.group(3)))
            except ValueError as e:
                raise GoalConfigError(str(e)) from None
        else:
            raise GoalConfigError(f"unknown goal type ${tname}")
        labels_str = tm.group(4).strip()
        if labels_str:
            bm = re.match(r"^\{\s*([^}]*)\s*\}$", labels_str)
            if not bm:
                raise GoalConfigError(f"labels for typed goal must be braced: {line!r}")
            labels_str = bm.group(1).strip()

    labels = labels_str.split() if labels_str else []
    for lab in labels:
        if lab != WILDCARD_LABEL and not _NAME_RE.match(lab):
            raise GoalConfigError(f"invalid label {lab!r}")
    if len(labels) > MAX_LABELS_PER_SLICE:
        raise GoalConfigError("too many labels (max 40)")

    if type_.is_standard or type_.is_tape:
        # tape: each label = one archival copy on a matching tape server
        counts: dict[str, int] = {}
        for lab in labels or [WILDCARD_LABEL]:
            counts[lab] = counts.get(lab, 0) + 1
        if type_.is_tape:
            # copies are recorded per server label, so a repeated NAMED
            # label could never be satisfied; wildcards may repeat
            # (distinct servers carry distinct labels)
            dup = [lab for lab, c in counts.items()
                   if lab != WILDCARD_LABEL and c > 1]
            if dup:
                raise GoalConfigError(
                    f"repeated tape label {dup[0]!r}: {line!r}"
                )
        return Slice.make(type_, [counts])
    nparts = type_.expected_parts
    if labels and len(labels) > nparts:
        raise GoalConfigError(
            f"{type_.to_string()} takes at most {nparts} labels, got {len(labels)}"
        )
    per_part = []
    for i in range(nparts):
        lab = labels[i] if i < len(labels) else WILDCARD_LABEL
        per_part.append({lab: 1})
    return Slice.make(type_, per_part)


def load_goal_config(text: str) -> dict[int, Goal]:
    """Parse a whole mfsgoals.cfg; unspecified ids keep defaults."""
    goals = default_goals()
    for lineno, line in enumerate(text.splitlines(), 1):
        try:
            parsed = parse_goal_line(line)
        except GoalConfigError as e:
            raise GoalConfigError(f"line {lineno}: {e}") from None
        if parsed:
            gid, goal = parsed
            goals[gid] = goal
    return goals
