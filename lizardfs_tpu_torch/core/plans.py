"""Wave-scheduled read plans with EC/XOR recovery post-processing.

The port's copy of the JAX package's ``core/plans.py`` (tests pin the
two together), with one difference: a plan given no encoder recovers
through the card's, ``get_encoder()`` (resolved at the first recovery),
which raises without a card. Nothing lands on the CPU unless the caller
passes a CPU encoder (``CudaChunkEncoder(device="cpu")`` or
``CpuChunkEncoder()``, as the tests do). EC recovery reaches the GF
apply kernel through ``recover``; XOR recovery is plain tensor code
(``xor_parity``), as the reference's is.

Re-implementation of the reference's declarative read-plan machinery
(reference: src/common/read_plan.h:54-191, slice_read_plan.h:33-111,
ec_read_plan.h:33-147, xor_read_plan.h): a plan lists per-part read
operations grouped into **waves** (wave 0 = the minimal/cheapest set;
later waves are fallbacks fired on timeout or failure), plus a
post-process step that zero-pads short trailing parts and recovers
missing parts (RS via the ChunkEncoder boundary, or XOR).

The executor (client side) drives sockets and timeouts; everything here
is pure logic over an in-memory flat buffer, which keeps it testable the
same way the reference tests plans with an in-memory simulator
(src/unittests/plan_tester.h).

Parts within a plan are identified by their *slice part index* (one plan
always reads a single slice): for ec(k,m) parts 0..k-1 are data and
k..k+m-1 parity; for xorN part 0 is parity and 1..N are data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.core.encoder import ChunkEncoder, get_encoder


@dataclass
class ReadOp:
    """One read request to a chunkserver (read_plan.h:58-63)."""

    part: int  # slice part index
    request_offset: int
    request_size: int  # may be 0 for parts with no data in range
    buffer_offset: int
    wave: int


@dataclass
class RequestedPartInfo:
    """A part whose bytes the caller asked for (slice_read_plan.h:35-38)."""

    part: int
    size: int  # real bytes available in this part (<= buffer_part_size)


class SliceReadPlan:
    """Read plan for a set of parts of one slice.

    Buffer layout: requested parts first (each ``buffer_part_size``
    bytes, caller-visible result region), then any extra parts read only
    for potential recovery.
    """

    def __init__(
        self,
        slice_type: geometry.SliceType,
        requested_parts: list[RequestedPartInfo],
        buffer_part_size: int,
    ):
        self.slice_type = slice_type
        self.requested_parts = requested_parts
        self.buffer_part_size = buffer_part_size
        self.read_operations: list[ReadOp] = []

    @property
    def buffer_size(self) -> int:
        ops_end = max(
            (op.buffer_offset + self.buffer_part_size for op in self.read_operations),
            default=0,
        )
        return max(ops_end, len(self.requested_parts) * self.buffer_part_size)

    @property
    def result_size(self) -> int:
        return len(self.requested_parts) * self.buffer_part_size

    def is_reading_finished(self, available_parts: list[int]) -> bool:
        """Enough parts arrived to produce the result
        (slice_read_plan.h:47-65)."""
        if len(set(available_parts)) >= geometry.required_parts_to_recover(
            self.slice_type
        ):
            return True
        avail = set(available_parts)
        return all(info.part in avail for info in self.requested_parts)

    def is_finishing_possible(self, unreadable_parts: list[int]) -> bool:
        """Can the plan still succeed given these parts failed
        (slice_read_plan.h:71-88)."""
        if len(self.read_operations) - len(unreadable_parts) >= (
            geometry.required_parts_to_recover(self.slice_type)
        ):
            return True
        bad = set(unreadable_parts)
        return not any(info.part in bad for info in self.requested_parts)

    def postprocess_read(
        self, buffer: np.ndarray, available_parts: list[int]
    ) -> int:
        """Zero-pad short trailing parts (slice_read_plan.h:94-105)."""
        for i, info in enumerate(self.requested_parts):
            start = i * self.buffer_part_size + info.size
            end = (i + 1) * self.buffer_part_size
            buffer[start:end] = 0
        return self.result_size

    def postprocess(self, buffer: np.ndarray, available_parts: list[int]) -> np.ndarray:
        """Run post-processing; returns the caller-visible result view."""
        size = self.postprocess_read(buffer, available_parts)
        return buffer[:size]


class _RecoveringPlan(SliceReadPlan):
    """A slice plan that may recover parts through an encoder."""

    def __init__(self, slice_type, requested_parts, buffer_part_size, encoder=None):
        super().__init__(slice_type, requested_parts, buffer_part_size)
        self._given: ChunkEncoder | None = encoder

    @property
    def _encoder(self) -> ChunkEncoder:
        """The encoder given, else the card's (raises without a card)."""
        if self._given is None:
            self._given = get_encoder()
        return self._given


class ECReadPlan(_RecoveringPlan):
    """Slice plan with Reed-Solomon recovery (ec_read_plan.h:33-147)."""

    def __init__(self, slice_type, requested_parts, buffer_part_size, encoder=None):
        assert slice_type.is_ec
        super().__init__(slice_type, requested_parts, buffer_part_size, encoder)

    def postprocess_read(self, buffer, available_parts):
        super().postprocess_read(buffer, available_parts)
        avail = set(available_parts)
        if any(info.part not in avail for info in self.requested_parts):
            self._recover_parts(buffer, avail)
        return self.result_size

    def _recover_parts(self, buffer: np.ndarray, available: set[int]) -> None:
        """Rebuild missing requested parts from any k available ones
        (ec_read_plan.h:113-146). EC slice part indices are already the
        codec's global part indices."""
        k = self.slice_type.data_parts
        m = self.slice_type.parity_parts
        bps = self.buffer_part_size
        parts: dict[int, np.ndarray] = {}
        for op in self.read_operations:
            if op.part in available and op.part not in parts and len(parts) < k:
                parts[op.part] = buffer[op.buffer_offset : op.buffer_offset + bps]
        wanted = [
            info.part
            for info in self.requested_parts
            if info.part not in available
        ]
        recovered = self._encoder.recover(k, m, parts, wanted)
        for i, info in enumerate(self.requested_parts):
            if info.part in recovered:
                buffer[i * bps : (i + 1) * bps] = recovered[info.part]


class XorReadPlan(_RecoveringPlan):
    """Slice plan with XOR parity recovery (xor_read_plan.h:39-121).

    A xorN slice can lose at most one part; the missing part is the XOR
    of all the others.
    """

    def __init__(self, slice_type, requested_parts, buffer_part_size, encoder=None):
        assert slice_type.is_xor
        super().__init__(slice_type, requested_parts, buffer_part_size, encoder)

    def postprocess_read(self, buffer, available_parts):
        super().postprocess_read(buffer, available_parts)
        avail = set(available_parts)
        missing = [i for i in (info.part for info in self.requested_parts) if i not in avail]
        if not missing:
            return self.result_size
        assert len(missing) == 1, "xor slice can recover at most one part"
        bps = self.buffer_part_size
        sources = []
        for op in self.read_operations:
            if op.part in avail and op.part != missing[0]:
                sources.append(buffer[op.buffer_offset : op.buffer_offset + bps].copy())
        need = self.slice_type.xor_level  # N others required (N data + parity - 1)
        assert len(sources) >= need
        parity = self._encoder.xor_parity(sources[: need])
        for i, info in enumerate(self.requested_parts):
            if info.part == missing[0]:
                buffer[i * bps : (i + 1) * bps] = parity
        return self.result_size


def plan_for_standard(requested_size: int) -> SliceReadPlan:
    """Trivial plan for std (single-copy) chunk parts."""
    plan = SliceReadPlan(
        geometry.SliceType(geometry.STANDARD),
        [RequestedPartInfo(0, requested_size)],
        requested_size,
    )
    plan.read_operations.append(ReadOp(0, 0, requested_size, 0, 0))
    return plan


class SliceReadPlanner:
    """Builds a SliceReadPlan for requested parts of one slice, given
    which parts are available and per-part scores (higher = healthier).

    Mirrors src/common/slice_read_planner.{h,cc}: requested+available
    parts are read directly in wave 0; if a requested part is missing,
    the k best-scored other parts join wave 0 (recovery read) and
    whatever remains is scheduled as fallback waves.
    """

    def __init__(
        self,
        slice_type: geometry.SliceType,
        available_parts: list[int],
        scores: dict[int, float] | None = None,
        encoder: ChunkEncoder | None = None,
    ):
        self.slice_type = slice_type
        self.available = list(dict.fromkeys(available_parts))
        self.scores = scores or {}
        self.encoder = encoder

    def _score(self, part: int) -> float:
        return self.scores.get(part, 1.0)

    def is_readable(self, wanted_parts: list[int]) -> bool:
        avail = set(self.available)
        if all(p in avail for p in wanted_parts):
            return True
        k = geometry.required_parts_to_recover(self.slice_type)
        if self.slice_type.is_xor:
            # xor recovery needs every other part of the full slice
            missing = [p for p in wanted_parts if p not in avail]
            full = set(range(self.slice_type.expected_parts))
            return len(missing) == 1 and (full - {missing[0]}) <= avail
        return len(avail) >= k

    def build_plan(
        self,
        wanted_parts: list[int],
        first_block: int,
        block_count: int,
        part_sizes: dict[int, int] | None = None,
    ) -> SliceReadPlan:
        """part_sizes: byte length of each part (defaults to full parts)."""
        if not self.is_readable(wanted_parts):
            raise ValueError("not enough available parts to read/recover")
        bps = block_count * MFSBLOCKSIZE
        off = first_block * MFSBLOCKSIZE

        def psize(part: int) -> int:
            if part_sizes is None:
                return bps
            return max(0, min(part_sizes.get(part, 0) - off, bps))

        requested = [RequestedPartInfo(p, psize(p)) for p in wanted_parts]
        if self.slice_type.is_xor:
            plan = XorReadPlan(self.slice_type, requested, bps, self.encoder)
        elif self.slice_type.is_ec:
            plan = ECReadPlan(self.slice_type, requested, bps, self.encoder)
        else:
            plan = SliceReadPlan(self.slice_type, requested, bps)

        avail = set(self.available)
        wanted_avail = [p for p in wanted_parts if p in avail]
        missing = [p for p in wanted_parts if p not in avail]
        extras = sorted(
            (p for p in self.available if p not in wanted_parts),
            key=self._score,
            reverse=True,
        )

        # wave 0: requested parts we can read directly
        pos = {p: i for i, p in enumerate(wanted_parts)}
        for p in wanted_avail:
            plan.read_operations.append(
                ReadOp(p, off, psize(p), pos[p] * bps, 0)
            )
        extra_offset = len(wanted_parts) * bps
        wave = 0
        if missing:
            # recovery: enough extra parts in wave 0 to reach k sources
            k = geometry.required_parts_to_recover(self.slice_type)
            if self.slice_type.is_xor:
                k = self.slice_type.expected_parts - 1
            need = max(0, k - len(wanted_avail))
            for p in extras[:need]:
                plan.read_operations.append(
                    ReadOp(p, off, psize(p), extra_offset, 0)
                )
                extra_offset += bps
            extras = extras[need:]
        # remaining available parts become fallback waves
        for p in extras:
            wave += 1
            plan.read_operations.append(
                ReadOp(p, off, psize(p), extra_offset, wave)
            )
            extra_offset += bps
        return plan
