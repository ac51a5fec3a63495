"""The port's geometry and goal grammar against the JAX package's, on the
CPU. Part ids and slice type ids are wire values, so every id of every
slice type is compared; goals are compared as plain tuples. The
tolerance is exact everywhere.
"""

import numpy as np
import pytest

from lizardfs_tpu.core import geometry as ref
from lizardfs_tpu.utils import striping as ref_striping
from lizardfs_tpu_torch import constants
from lizardfs_tpu_torch.core import geometry as g
from lizardfs_tpu_torch.utils import striping

BS = constants.MFSBLOCKSIZE

# slice type id groups: std, tape, xor2..xor9, and ec(k, *) for every k
TYPE_GROUPS = (
    [("std", [g.STANDARD]), ("tape", [g.TAPE])]
    + [(f"xor{n}", [int(g.xor_type(n))]) for n in range(2, 10)]
    + [(f"ec({k},*)", [int(g.ec_type(k, m)) for m in range(1, 33)]) for k in range(2, 33)]
)


def _part(cpt) -> tuple:
    out = [int(cpt.type), cpt.part, cpt.id, cpt.is_valid(), cpt.is_parity, cpt.is_data,
           cpt.data_part_index, cpt.parity_part_index, cpt.to_string(), repr(cpt)]
    if cpt.is_valid():
        out += [g.number_of_blocks_in_part(cpt) if isinstance(cpt, g.ChunkPartType)
                else ref.number_of_blocks_in_part(cpt)]
    return tuple(out)


def _slice_type(t) -> tuple:
    return (int(t), t.is_valid(), t.is_standard, t.is_tape, t.is_xor, t.is_ec,
            t.data_parts, t.parity_parts, t.expected_parts, t.to_string(), repr(t))


def test_slice_type_constants_match_reference():
    for name in ("STANDARD", "TAPE", "XOR_FIRST", "XOR_LAST", "EC_FIRST", "EC_LAST",
                 "TYPE_COUNT", "MAX_PARTS_PER_SLICE", "WILDCARD_LABEL", "MAX_GOAL_NAME",
                 "MAX_LABELS_PER_SLICE", "GOAL_ID_MIN", "GOAL_ID_MAX"):
        assert getattr(g, name) == getattr(ref, name), name
    for t in (-1, ref.TYPE_COUNT, ref.TYPE_COUNT + 5):
        assert g.SliceType(t).is_valid() is ref.SliceType(t).is_valid() is False


@pytest.mark.parametrize("group,type_ids", TYPE_GROUPS, ids=[n for n, _ in TYPE_GROUPS])
def test_every_part_id_matches_reference(group, type_ids):
    """from_id of every part id (64 a type) of each slice type of the
    group: fields, validity, roles and blocks per part."""
    for type_id in type_ids:
        assert _slice_type(g.SliceType(type_id)) == _slice_type(ref.SliceType(type_id))
        for part in range(g.MAX_PARTS_PER_SLICE):
            part_id = type_id * g.MAX_PARTS_PER_SLICE + part
            got, want = g.ChunkPartType.from_id(part_id), ref.ChunkPartType.from_id(part_id)
            assert got.id == part_id
            assert _part(got) == _part(want), part_id
            if got.is_valid():
                assert g.stripe_size(got) == ref.stripe_size(want)
            if got.type.is_xor:
                assert got.type.xor_level == want.type.xor_level


def test_xor_level_of_other_types_raises():
    with pytest.raises(ValueError, match="not an xor slice"):
        g.ec_type(3, 2).xor_level


def test_standard_part_and_part_type_order():
    assert (g.standard_part().id, g.standard_part().to_string()) == (
        ref.standard_part().id, ref.standard_part().to_string())
    ids = [int(g.ec_type(3, 2)) * 64 + p for p in (4, 0, 2)] + [int(g.xor_type(3)) * 64 + 1, 0]
    assert [c.id for c in sorted(map(g.ChunkPartType.from_id, ids))] == [
        c.id for c in sorted(map(ref.ChunkPartType.from_id, ids))]


SHORT_TYPES = [g.ec_type(3, 2), g.ec_type(8, 4), g.ec_type(5, 3), g.xor_type(3), g.xor_type(9),
               g.SliceType(g.STANDARD)]
LENGTHS = [0, 1, BS - 1, BS, BS + 1, 3 * BS, 3 * BS + 1000, 7 * BS + 12345, 17 * BS - 1,
           64 * 2**20 - 3 * BS - 1000, 64 * 2**20]


@pytest.mark.parametrize("st", SHORT_TYPES, ids=lambda t: t.to_string())
def test_part_lengths_of_short_chunks_match_reference(st):
    """part_length, chunk_length_to_part_length and blocks per part for
    chunks that do not stripe evenly (trailing parts are shorter)."""
    rst = ref.SliceType(int(st))
    for part in range(st.expected_parts):
        cpt, rcpt = g.ChunkPartType(st, part), ref.ChunkPartType(rst, part)
        for length in LENGTHS:
            want = ref_striping.part_length(rst, part, length)
            assert striping.part_length(st, part, length) == want, (part, length)
            assert g.chunk_length_to_part_length(cpt, length) == want
        for blocks in (0, 1, 2, 3, 7, 8, 9, 1000, 1021, 1022, 1024):
            assert (g.number_of_blocks_in_part(cpt, blocks)
                    == ref.number_of_blocks_in_part(rcpt, blocks)), (part, blocks)


def _goal(goal) -> tuple:
    return (goal.name, tuple((int(s.type), s.part_labels) for s in goal.slices),
            goal.expected_copies(), goal.tape_copies(), tuple(goal.tape_labels()),
            None if goal.disk_slice() is None else int(goal.disk_slice().type),
            tuple(s.size for s in goal.slices))


GOAL_LINES = [
    # doc/mfsgoals.cfg.5.txt examples, as in tests/test_geometry.py
    "3 3 : _ _ _",
    "8 not_important_file : _",
    "12 local_copy_on_mars : mars _",
    "15 default_xor3 : $xor3",
    "16 fast_read : $xor2 { ssd ssd hdd }",
    "18 first_ec : $ec(3,1)",
    "20 ec53_mixed : $ec(5,3) { hdd ssd hdd _ _ _ _ _ }",
    "15 x3 : $xor3",
    # the shipped goal and the multi-slice forms
    "10 fast : $ec(8,4)",
    "5 ec32 : $ec(3,2)",
    "12 wide : $ec(32,32)",
    "7 arch : _ _ | $tape",
    "9 arch2 : $ec(3,2) | $tape { _ _ }",
    "11 lab : $std { a b a }",
    "13 mixed : $ec( 4 , 2 ) {ssd}",
    "40 last : ssd hdd # trailing comment",
    "1 one : _",
]

BAD_LINES = [
    "0 zero : _",
    "41 hi : _",
    "3 bad name : _",
    "3 x : $xor1",
    "3 x : $xor10",
    "3 x : $ec(1,1)",
    "3 x : $ec(33,1)",
    "3 x : $ec",
    "3 x : $wat",
    "3 x : $xor2 ssd ssd",
    "nonsense",
    "3 x : $xor2 { a b c d }",
    "3 x : $tape",
    "3 x : $tape | _",
    "3 x : _ | $tape | $tape",
    "3 x : _ | _",
    "3 x : _ | $tape { a a }",
    "3 x : bad-label",
    "3 " + "n" * 33 + " : _",
]


@pytest.mark.parametrize("line", GOAL_LINES)
def test_goal_line_matches_reference(line):
    got, want = g.parse_goal_line(line), ref.parse_goal_line(line)
    assert got[0] == want[0]
    assert _goal(got[1]) == _goal(want[1])
    s, rs = got[1].slices[0], want[1].slices[0]
    assert [s.labels_of_part(p) for p in range(s.size)] == [
        rs.labels_of_part(p) for p in range(rs.size)]


@pytest.mark.parametrize("line", BAD_LINES)
def test_bad_goal_line_matches_reference(line):
    with pytest.raises(ref.GoalConfigError) as want:
        ref.parse_goal_line(line)
    with pytest.raises(g.GoalConfigError) as got:
        g.parse_goal_line(line)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("line", ["", "   ", "  # comment only", "#"])
def test_blank_goal_lines(line):
    assert g.parse_goal_line(line) is None and ref.parse_goal_line(line) is None


def test_goal_config_matches_reference():
    text = "\n".join(GOAL_LINES[8:]) + "\n# end\n"
    got, want = g.load_goal_config(text), ref.load_goal_config(text)
    assert sorted(got) == sorted(want) == list(range(1, 41))
    assert {i: _goal(v) for i, v in got.items()} == {i: _goal(v) for i, v in want.items()}
    assert {i: _goal(v) for i, v in g.default_goals().items()} == {
        i: _goal(v) for i, v in ref.default_goals().items()}
    assert int(got[10].disk_slice().type) == int(g.ec_type(8, 4))
    bad = "3 ok : _\n\n41 hi : _\n"
    with pytest.raises(ref.GoalConfigError) as want:
        ref.load_goal_config(bad)
    with pytest.raises(g.GoalConfigError) as got:
        g.load_goal_config(bad)
    assert str(got.value) == str(want.value) == "line 3: goal id 41 out of range [1,40]"


@pytest.mark.parametrize("length", [1, BS, 7 * BS + 12345, 9 * BS - 1, 21 * BS - 1000])
@pytest.mark.parametrize("d", [1, 3, 8])
def test_striping_into_caller_buffers_matches_reference(length, d):
    """padded_data_parts and assemble_chunk with and without ``out``
    give the reference's bytes; the generator is the reference's."""
    from lizardfs_tpu.utils import data_generator as ref_data_generator
    from lizardfs_tpu_torch.utils import data_generator

    data = data_generator.generate(length, length)
    np.testing.assert_array_equal(data, ref_data_generator.generate(length, length))
    assert data_generator.validate(length, data) and not data_generator.validate(length + 1, data)
    parts, part_len = striping.padded_data_parts(data, d)
    want, want_len = ref_striping.padded_data_parts(data, d)
    assert part_len == want_len
    out = np.full((d, part_len), 0xAB, np.uint8)
    into, _ = striping.padded_data_parts(data, d, out)
    for p in range(d):
        np.testing.assert_array_equal(parts[p], want[p])
        np.testing.assert_array_equal(into[p], want[p])
        assert np.shares_memory(into[p], out)
    st = g.ec_type(d, 1) if d > 1 else g.SliceType(g.STANDARD)
    by_part = dict(enumerate(parts)) if d > 1 else {0: data}
    rst = ref.SliceType(int(st))
    whole = ref_striping.assemble_chunk(by_part, rst, length)
    np.testing.assert_array_equal(whole, data)
    np.testing.assert_array_equal(striping.assemble_chunk(by_part, st, length), whole)
    buf = np.full(length + 7, 0xCD, np.uint8)
    got = striping.assemble_chunk(by_part, st, length, out=buf)
    np.testing.assert_array_equal(got, whole)
    assert np.shares_memory(got, buf) and (buf[length:] == 0xCD).all()
    with pytest.raises(ValueError, match="C-contiguous"):
        striping.padded_data_parts(data, d, np.empty((d, part_len + 1), np.uint8))
