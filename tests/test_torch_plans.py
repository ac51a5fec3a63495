"""The port's read planning against the JAX package's, on the CPU.

The cases of ``tests/test_plans.py`` (an in-memory, wave-by-wave plan
simulator with failing parts) run through both planners on the same
deterministic chunk: the plans' read operations and the results must be
identical, with the port recovering through ``CudaChunkEncoder`` on the
CPU (the kernels' plain versions) and through the numpy golden encoder.
Also: the whole-chunk candidate ranking and the chunkserver health
scores on an injected clock. Every value is an integer or an exact
float: the tolerance is 0 everywhere.
"""

from dataclasses import dataclass

import numpy as np
import pytest

from lizardfs_tpu.core import chunk_planner as ref_chunk_planner
from lizardfs_tpu.core import cs_stats as ref_cs_stats
from lizardfs_tpu.core import geometry as ref_geometry
from lizardfs_tpu.core import plans as ref_plans
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuEncoder
from lizardfs_tpu.utils import data_generator as ref_data_generator
from lizardfs_tpu.utils import striping as ref_striping
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import chunk_planner, cs_stats, geometry, plans
from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder, CudaChunkEncoder
from lizardfs_tpu_torch.utils import data_generator, striping

CHUNK_LEN = 7 * MFSBLOCKSIZE + 12345  # 7.2 blocks: exercises padding
ENCODERS = {"cuda-on-cpu": lambda: CudaChunkEncoder(device="cpu"), "golden": CpuChunkEncoder}


class PlanSimulator:
    """Executes a plan wave by wave against in-memory parts (the pattern
    of tests/test_plans.py), for either package's modules."""

    def __init__(self, pkg, chunk_length, slice_type, encoder):
        self.pkg = pkg
        self.chunk = pkg["data_generator"].generate(0, chunk_length)
        self.slice_type = slice_type
        self.encoder = encoder
        self.parts = pkg["striping"].split_chunk(self.chunk, slice_type, encoder)
        self.part_sizes = {
            p: pkg["striping"].part_length(slice_type, p, chunk_length) for p in self.parts
        }

    def planner(self, available=None, scores=None):
        avail = available if available is not None else sorted(self.parts)
        return self.pkg["plans"].SliceReadPlanner(self.slice_type, avail, scores, self.encoder)

    def execute(self, plan, failing=()):
        buffer = np.zeros(plan.buffer_size, dtype=np.uint8)
        available: list[int] = []
        unreadable: list[int] = []
        max_wave = max((op.wave for op in plan.read_operations), default=0)
        for wave in range(max_wave + 1):
            for op in plan.read_operations:
                if op.wave != wave:
                    continue
                if op.part in failing:
                    unreadable.append(op.part)
                    if not plan.is_finishing_possible(unreadable):
                        raise IOError("plan cannot finish")
                    continue
                src = self.parts[op.part][: self.part_sizes[op.part]]
                chunk = src[op.request_offset : op.request_offset + op.request_size]
                buffer[op.buffer_offset : op.buffer_offset + len(chunk)] = chunk
                available.append(op.part)
            if plan.is_reading_finished(available):
                break
        else:
            raise IOError("waves exhausted without enough parts")
        return plan.postprocess(buffer, available)


PORT = {"plans": plans, "striping": striping, "data_generator": data_generator,
        "geometry": geometry}
REF = {"plans": ref_plans, "striping": ref_striping, "data_generator": ref_data_generator,
       "geometry": ref_geometry}


def _ops(plan) -> list[tuple]:
    return [(op.part, op.request_offset, op.request_size, op.buffer_offset, op.wave)
            for op in plan.read_operations]


def _both(type_name, encoder_name, chunk_length=CHUNK_LEN):
    st = geometry.ec_type(3, 2) if type_name == "ec(3,2)" else geometry.xor_type(3)
    port = PlanSimulator(PORT, chunk_length, st, ENCODERS[encoder_name]())
    ref = PlanSimulator(REF, chunk_length, ref_geometry.SliceType(int(st)), RefCpuEncoder())
    for p in ref.parts:
        np.testing.assert_array_equal(port.parts[p], ref.parts[p])
    return port, ref


def expected_result(sim, wanted_parts, first_block, block_count):
    bps = block_count * MFSBLOCKSIZE
    out = np.zeros(len(wanted_parts) * bps, dtype=np.uint8)
    off = first_block * MFSBLOCKSIZE
    for i, p in enumerate(wanted_parts):
        src = sim.parts[p][off : off + bps][: max(0, sim.part_sizes[p] - off)]
        out[i * bps : i * bps + len(src)] = src
    return out


# (slice type, available at planning, wanted, first block, blocks, failing)
CASES = {
    "ec-all-available": ("ec(3,2)", None, [0, 1, 2], 0, 3, ()),
    "xor-all-available": ("xor3", None, [1, 2, 3], 0, 3, ()),
    "ec-runtime-failure": ("ec(3,2)", None, [0, 1, 2], 0, 3, {0, 1}),
    "ec-known-missing": ("ec(3,2)", [0, 2, 3, 4], [0, 1, 2], 0, 3, ()),
    "xor-recovery": ("xor3", None, [1, 2, 3], 0, 3, {2}),
    "ec-parity-read": ("ec(3,2)", None, [3, 4], 0, 3, ()),
    "ec-parity-recompute": ("ec(3,2)", [0, 1, 2], [3, 4], 0, 3, ()),
    "ec-missing-and-failing": ("ec(3,2)", [0, 2, 3, 4], [0, 1, 2], 0, 3, {0}),
    "ec-offset-short-tail": ("ec(3,2)", [0, 2, 3, 4], [1, 2], 1, 2, ()),
    "ec-zero-size-ops": ("ec(3,2)", [1, 2, 3, 4], [0, 1, 2], 2, 1, ()),
    "xor-known-missing": ("xor3", [0, 1, 3], [1, 2, 3], 0, 3, ()),
    "xor-parity-rebuild": ("xor3", [1, 2, 3], [0], 1, 2, ()),
}


@pytest.mark.parametrize("encoder_name", sorted(ENCODERS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_cases_match_reference(case, encoder_name):
    type_name, available, wanted, first, count, failing = CASES[case]
    port, ref = _both(type_name, encoder_name)
    plan = port.planner(available).build_plan(wanted, first, count, port.part_sizes)
    ref_plan = ref.planner(available).build_plan(wanted, first, count, ref.part_sizes)
    assert type(plan).__name__ == type(ref_plan).__name__
    assert _ops(plan) == _ops(ref_plan)
    assert (plan.buffer_size, plan.result_size) == (ref_plan.buffer_size, ref_plan.result_size)
    assert [(r.part, r.size) for r in plan.requested_parts] == [
        (r.part, r.size) for r in ref_plan.requested_parts]
    got, want = port.execute(plan, failing), ref.execute(ref_plan, failing)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, expected_result(port, wanted, first, count))


@pytest.mark.parametrize("type_name,failing", [("xor3", {1, 2}), ("ec(3,2)", {0, 1, 2})])
def test_too_many_failures_is_fatal(type_name, failing):
    port, ref = _both(type_name, "cuda-on-cpu")
    wanted = [0, 1, 2] if type_name == "ec(3,2)" else [1, 2, 3]
    for sim in (port, ref):
        plan = sim.planner().build_plan(wanted, 0, 3, sim.part_sizes)
        with pytest.raises(IOError):
            sim.execute(plan, failing)


def test_unreadable_plans_refused_alike():
    port, ref = _both("xor3", "golden")
    for sim in (port, ref):
        planner = sim.planner(available=[0, 1])
        assert not planner.is_readable([2, 3])
        with pytest.raises(ValueError, match="not enough available parts"):
            planner.build_plan([2, 3], 0, 3, sim.part_sizes)


class _Recording(CudaChunkEncoder):
    """Records the sources each recover call is given, in order."""

    def __init__(self):
        super().__init__(device="cpu")
        self.calls = []

    def recover(self, k, m, parts, wanted):
        self.calls.append((list(parts), list(wanted)))
        return super().recover(k, m, parts, wanted)


class _RefRecording(RefCpuEncoder):
    def __init__(self):
        self.calls = []

    def recover(self, k, m, parts, wanted):
        self.calls.append((list(parts), list(wanted)))
        return super().recover(k, m, parts, wanted)


@pytest.mark.parametrize("scores", [None, {4: 0.1, 3: 0.9, 1: 0.5}, {3: 0.01}])
def test_recovery_sources_in_reference_order(scores):
    """The k sources of an EC recovery are the first available ones in
    read-operation order, as the reference picks them (the recovery
    matrix, and the encoder's matrix cache, depend on the choice)."""
    port, ref = _both("ec(3,2)", "golden")
    port.encoder, ref.encoder = _Recording(), _RefRecording()
    for sim in (port, ref):
        plan = sim.planner([1, 2, 3, 4], scores).build_plan([0, 1, 2], 0, 3, sim.part_sizes)
        sim.result = sim.execute(plan, failing={1})
    assert port.encoder.calls == ref.encoder.calls and len(port.encoder.calls) == 1
    np.testing.assert_array_equal(port.result, ref.result)


def test_unnamed_encoder_is_the_cards():
    """A plan given no encoder recovers through get_encoder(): without a
    card that raises, never lands on the CPU. A read that needs no
    recovery runs without an encoder."""
    port, _ = _both("ec(3,2)", "golden")
    planner = plans.SliceReadPlanner(port.slice_type, [0, 1, 2, 3, 4])
    plan = planner.build_plan([0, 1, 2], 0, 3, port.part_sizes)
    np.testing.assert_array_equal(port.execute(plan), expected_result(port, [0, 1, 2], 0, 3))
    for st, avail, wanted in ((port.slice_type, [1, 2, 3], [0]), (geometry.xor_type(3), [1, 2, 3], [0])):
        plan = plans.SliceReadPlanner(st, avail).build_plan(wanted, 0, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan.postprocess(np.zeros(plan.buffer_size, np.uint8), avail)


def test_plan_for_standard_matches_reference():
    plan, ref_plan = plans.plan_for_standard(12345), ref_plans.plan_for_standard(12345)
    assert _ops(plan) == _ops(ref_plan)
    buf = np.arange(12345, dtype=np.uint8)
    np.testing.assert_array_equal(plan.postprocess(buf.copy(), [0]),
                                  ref_plan.postprocess(buf.copy(), [0]))


@dataclass
class Addr:
    host: str
    port: int


@dataclass
class Loc:
    part_id: int
    addr: Addr


def _locations():
    """A chunk held as a std copy, an ec(3,2) slice missing part 4 with
    two copies of part 0, and an xor2 slice missing a data part."""
    ec, xor2 = geometry.ec_type(3, 2), geometry.xor_type(2)
    locs = [Loc(0, Addr("h0", 9000))]
    locs += [Loc(int(ec) * 64 + p, Addr(f"h{p + 1}", 9000 + p)) for p in range(4)]
    locs += [Loc(int(ec) * 64, Addr("h9", 9100))]
    locs += [Loc(int(xor2) * 64 + p, Addr("x", 9200 + p)) for p in (0, 1)]
    return locs


def _cands(cands) -> list[tuple]:
    return [(int(c.type), c.copies, c.complete, c.health, c.recovery_parts) for c in cands]


SCORES = {("h0", 9000): 0.2, ("h1", 9001): 0.9, ("h9", 9100): 0.4, ("x", 9201): 0.05}


@pytest.mark.parametrize("avoid", [set(), {("h0", 9000)}, {("h1", 9001)},
                                   {("h0", 9000), ("h1", 9001), ("h9", 9100), ("h2", 9001),
                                    ("x", 9200)}])
def test_candidates_match_reference(avoid):
    def score(addr):
        return SCORES.get(addr, 1.0)

    got = chunk_planner.candidates(_locations(), score, avoid)
    want = ref_chunk_planner.candidates(_locations(), score, avoid)
    assert _cands(got) == _cands(want) and got
    assert [c.sort_key() for c in got] == [c.sort_key() for c in want]


def test_chunkserver_stats_on_an_injected_clock():
    now = [100.0]
    port, ref = (mod.ChunkserverStats(clock=lambda: now[0]) for mod in (cs_stats, ref_cs_stats))
    a, b = ("h1", 1), ("h2", 2)
    script = [("fail", a, 0), ("fail", a, 1), ("fail", b, 5), ("ok", a, 10), ("ok", b, 45),
              ("fail", a, 0.5), ("ok", a, 200), ("ok", a, 1), ("fail", b, 0)]
    seen = []
    for what, addr, dt in script:
        now[0] += dt
        for stats in (port, ref):
            (stats.record_failure if what == "fail" else stats.record_success)(addr)
        seen.append((port.score(a), port.score(b), port.defects(a), port.defects(b)))
        assert seen[-1] == (ref.score(a), ref.score(b), ref.defects(a), ref.defects(b))
    assert seen[1][0] < seen[0][0] < 1.0 and seen[-1][1] < 1.0
    assert cs_stats.GLOBAL_STATS is not ref_cs_stats.GLOBAL_STATS
    assert cs_stats.GLOBAL_STATS.score(("nowhere", 0)) == 1.0
