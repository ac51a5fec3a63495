"""The port's chunk store, status codes and fault hooks against the JAX
package's, on the CPU.

The on-disk format is a wire format: a part written by either package's
store scans, reads and passes ``test_part`` in the other, and both write
the same file bytes. The in-process store cases of
``tests/test_chunkserver.py`` run on the port's store, with the same
error codes as the reference's. One armed ``disk_pread`` flip is caught
through the port's own fault rules, which leave the JAX package's rule
set untouched. Every value is exact.
"""

import os

import numpy as np
import pytest

from lizardfs_tpu.chunkserver import chunk_store as ref_store
from lizardfs_tpu.ops import crc32 as ref_crc
from lizardfs_tpu.proto import status as ref_st
from lizardfs_tpu.runtime import faults as ref_faults
from lizardfs_tpu_torch.chunkserver.chunk_store import (
    ChunkStore,
    ChunkStoreError,
    MultiStore,
    chunk_filename,
    parse_chunk_filename,
)
from lizardfs_tpu_torch.chunkserver import chunk_store as port_store
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.ops import crc32 as crc_mod
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import faults
from lizardfs_tpu_torch.utils import data_generator

PART = geometry.ChunkPartType(geometry.ec_type(3, 2), 1).id
STORES = {"port": port_store, "jax": ref_store}


@pytest.fixture
def clean_faults(monkeypatch):
    """Both packages' rule sets empty before and after (LZ_FAULTS unset)."""
    monkeypatch.delenv("LZ_FAULTS", raising=False)
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


def test_format_constants_match_reference():
    for name in ("MAGIC", "SIGNATURE_SIZE", "CRC_TABLE_SIZE", "HEADER_SIZE", "EMPTY_BLOCK_CRC"):
        assert getattr(port_store, name) == getattr(ref_store, name), name
    assert port_store._SIG.format == ref_store._SIG.format


def test_status_codes_match_reference():
    ints = {k: v for k, v in vars(ref_st).items() if isinstance(v, int) and not k.startswith("_")}
    assert {k: v for k, v in vars(st).items()
            if isinstance(v, int) and not k.startswith("_")} == ints
    for code in list(ints.values()) + [99]:
        assert st.name(code) == ref_st.name(code)


NAMES = [
    (0xDEADBEEF12345678, PART, 7),
    (0, 0, 0),
    (1, geometry.ChunkPartType(geometry.ec_type(32, 32), 63).id, 0xFFFFFFFF),
    (0xFFFFFFFFFFFFFFFF, geometry.ChunkPartType(geometry.xor_type(9), 0).id, 1),
]


@pytest.mark.parametrize("chunk_id,part_id,version", NAMES)
def test_filenames_match_reference(chunk_id, part_id, version):
    name = chunk_filename(chunk_id, part_id, version)
    assert name == ref_store.chunk_filename(chunk_id, part_id, version)
    assert parse_chunk_filename(name) == (chunk_id, part_id, version)
    legacy = f"chunk_{chunk_id:016X}_{version:08X}.liz"
    assert parse_chunk_filename(legacy) == ref_store.parse_chunk_filename(legacy)
    for bad in ("chunk_zz_7.liz", "foo.liz", name[:-4], name.replace("_P", "_Q")):
        assert parse_chunk_filename(bad) == ref_store.parse_chunk_filename(bad)


def _fill(mod, folder, chunk_id, version, part_id, data, sparse=()):
    """Create a part with ``mod``'s store and write ``data`` into it
    block by block (whole blocks and a short tail), skipping ``sparse``
    blocks."""
    store = mod.ChunkStore(str(folder))
    cf = store.create(chunk_id, version, part_id)
    for b in range(0, len(data), MFSBLOCKSIZE):
        if b // MFSBLOCKSIZE in sparse:
            continue
        piece = data[b : b + MFSBLOCKSIZE].tobytes()
        store.write(chunk_id, version, part_id, b // MFSBLOCKSIZE, 0, piece, ref_crc.crc32(piece))
    return store, cf


# (data length, sparse blocks, piece written at an offset inside block 1)
CONTENTS = {
    "two-blocks-and-a-tail": (2 * MFSBLOCKSIZE + 100, (), None),
    "one-block": (MFSBLOCKSIZE, (), None),
    "sparse-hole": (4 * MFSBLOCKSIZE, (1, 2), None),
    "piece-in-block": (3 * MFSBLOCKSIZE - 7, (), (1000, 333)),
}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("content", sorted(CONTENTS))
def test_parts_cross_read_between_packages(tmp_path, writer, content):
    """A part written by one package scans, reads and tests in the other;
    both packages write the same file bytes."""
    length, sparse, patch = CONTENTS[content]
    data = data_generator.generate(17, length)
    files = {}
    for name, mod in STORES.items():
        store, cf = _fill(mod, tmp_path / name, 0x1234, 5, PART, data, sparse)
        if patch is not None:
            off, size = patch
            piece = data_generator.generate(999, size).tobytes()
            store.write(0x1234, 5, PART, 1, off, piece, ref_crc.crc32(piece))
        files[name] = cf.path
    blobs = {name: open(path, "rb").read() for name, path in files.items()}
    assert blobs["port"] == blobs["jax"]
    assert os.path.basename(files["port"]) == os.path.basename(files["jax"])

    reader = STORES["jax" if writer == "port" else "port"]
    store = reader.ChunkStore(str(tmp_path / writer))
    [cf] = store.scan()
    assert (cf.chunk_id, cf.version, cf.part_id) == (0x1234, 5, PART)
    assert store.test_part(cf)
    size = 4 * MFSBLOCKSIZE
    pieces = store.read(0x1234, 5, PART, 0, size)
    other = STORES[writer].ChunkStore(str(tmp_path / writer))
    other.scan()
    assert pieces == other.read(0x1234, 5, PART, 0, size)
    got = np.concatenate([np.frombuffer(p, np.uint8) for _, p, _ in pieces])
    want = np.zeros(size, np.uint8)
    want[:length] = data
    for b in sparse:
        want[b * MFSBLOCKSIZE : (b + 1) * MFSBLOCKSIZE] = 0
    if patch is not None:
        off, n = patch
        want[MFSBLOCKSIZE + off : MFSBLOCKSIZE + off + n] = data_generator.generate(999, n)
    np.testing.assert_array_equal(got, want)
    for off, piece, crc in pieces:
        assert crc == crc_mod.crc32(piece)


def test_store_create_write_read(tmp_path):
    store = ChunkStore(str(tmp_path))
    store.create(1, 1, PART)
    data = data_generator.generate(0, 2 * MFSBLOCKSIZE + 100)
    for b in range(2):
        piece = data[b * MFSBLOCKSIZE : (b + 1) * MFSBLOCKSIZE].tobytes()
        store.write(1, 1, PART, b, 0, piece, crc_mod.crc32(piece))
    tail = data[2 * MFSBLOCKSIZE :].tobytes()
    store.write(1, 1, PART, 2, 0, tail, crc_mod.crc32(tail))
    pieces = store.read(1, 1, PART, 0, 2 * MFSBLOCKSIZE + 100)
    got = np.concatenate([np.frombuffer(p, dtype=np.uint8) for _, p, _ in pieces])
    np.testing.assert_array_equal(got, data)
    [(off, piece, crc)] = store.read(1, 1, PART, 1000, 500)
    assert off == 1000 and crc == crc_mod.crc32(piece)
    np.testing.assert_array_equal(np.frombuffer(piece, np.uint8), data[1000:1500])


def _error_code(fn):
    try:
        fn()
    except (ChunkStoreError, ref_store.ChunkStoreError) as e:
        return e.code, str(e)
    return None


@pytest.mark.parametrize("case", ["exists", "wrong-version", "no-chunk", "bad-crc", "past-end",
                                  "crosses-block", "negative-read", "read-past-part",
                                  "delete-missing"])
def test_store_errors_match_reference(tmp_path, case):
    results = []
    for name, mod in STORES.items():
        store = mod.ChunkStore(str(tmp_path / name))
        store.create(5, 3, PART)
        blocks = geometry.number_of_blocks_in_part(geometry.ChunkPartType.from_id(PART))
        fn = {
            "exists": lambda: store.create(5, 3, PART),
            "wrong-version": lambda: store.read(5, 99, PART, 0, 10),
            "no-chunk": lambda: store.read(6, 3, PART, 0, 10),
            "bad-crc": lambda: store.write(5, 3, PART, 0, 0, b"hello", 0),
            "past-end": lambda: store.write(5, 3, PART, blocks, 0, b"x", ref_crc.crc32(b"x")),
            "crosses-block": lambda: store.write(5, 3, PART, 0, MFSBLOCKSIZE - 1, b"xy",
                                                 ref_crc.crc32(b"xy")),
            "negative-read": lambda: store.read(5, 3, PART, -1, 10),
            "read-past-part": lambda: store.read(5, 3, PART, 0, blocks * MFSBLOCKSIZE + 1),
            "delete-missing": lambda: store.delete(5, 3, PART + 1),
        }[case]
        results.append(_error_code(fn))
    assert results[0] == results[1] and results[0] is not None
    expected = {"exists": st.EEXIST, "wrong-version": st.WRONG_VERSION, "no-chunk": st.NO_CHUNK,
                "bad-crc": st.CRC_ERROR, "past-end": st.INDEX_TOO_BIG, "crosses-block": st.EINVAL,
                "negative-read": st.EINVAL, "read-past-part": st.EINVAL,
                "delete-missing": st.NO_CHUNK}
    assert results[0][0] == expected[case]


def test_store_corruption_detected(tmp_path):
    store = ChunkStore(str(tmp_path))
    cf = store.create(9, 1, PART)
    block = data_generator.generate(0, MFSBLOCKSIZE).tobytes()
    store.write(9, 1, PART, 0, 0, block, crc_mod.crc32(block))
    with open(cf.path, "r+b") as f:
        f.seek(5 * 1024 + 100)
        f.write(b"\xff")
    with pytest.raises(ChunkStoreError) as e:
        store.read(9, 1, PART, 0, MFSBLOCKSIZE)
    assert e.value.code == st.CRC_ERROR
    assert store.test_part(cf) is False
    # the reference's store reads the same file the same way
    other = ref_store.ChunkStore(str(tmp_path))
    [rcf] = other.scan()
    assert other.test_part(rcf) is False


def test_store_scan_and_version_gc(tmp_path):
    store = ChunkStore(str(tmp_path))
    store.create(1, 1, PART)
    store.create(2, 1, PART)
    store.set_version(2, 1, 2, PART)
    # a stale older version of chunk 1 left behind is removed by the scan
    older = store._path_for(1, PART, 0)
    with open(store.get(1, PART).path, "rb") as f:
        sig = bytearray(f.read())
    sig[16:20] = (0).to_bytes(4, "big")
    with open(older, "wb") as f:
        f.write(sig)
    store2 = ChunkStore(str(tmp_path))
    byid = {(cf.chunk_id, cf.part_id): cf for cf in store2.scan()}
    assert byid[(1, PART)].version == 1 and byid[(2, PART)].version == 2
    assert not os.path.exists(older)


def test_store_truncate(tmp_path):
    store = ChunkStore(str(tmp_path))
    cf = store.create(3, 1, PART)
    data = data_generator.generate(0, 2 * MFSBLOCKSIZE)
    for b in range(2):
        piece = data[b * MFSBLOCKSIZE : (b + 1) * MFSBLOCKSIZE].tobytes()
        store.write(3, 1, PART, b, 0, piece, crc_mod.crc32(piece))
    store.truncate_part(3, 1, PART, MFSBLOCKSIZE + 10)
    pieces = store.read(3, 1, PART, 0, 2 * MFSBLOCKSIZE)
    got = np.concatenate([np.frombuffer(p, np.uint8) for _, p, _ in pieces])
    np.testing.assert_array_equal(got[: MFSBLOCKSIZE + 10], data[: MFSBLOCKSIZE + 10])
    assert (got[MFSBLOCKSIZE + 10 :] == 0).all()
    ref = ref_store.ChunkStore(str(tmp_path / "ref"))
    rcf = ref.create(3, 1, PART)
    for b in range(2):
        piece = data[b * MFSBLOCKSIZE : (b + 1) * MFSBLOCKSIZE].tobytes()
        ref.write(3, 1, PART, b, 0, piece, ref_crc.crc32(piece))
    ref.truncate_part(3, 1, PART, MFSBLOCKSIZE + 10)
    assert open(cf.path, "rb").read() == open(rcf.path, "rb").read()


def test_multistore_placement_and_ops(tmp_path):
    ms = MultiStore([str(tmp_path / "d0"), str(tmp_path / "d1")])
    for cid in range(8):
        ms.create(cid, 1, PART)
    assert len(ms.all_parts()) == 8
    block = data_generator.generate(0, MFSBLOCKSIZE).tobytes()
    ms.write(3, 1, PART, 0, 0, block, crc_mod.crc32(block))
    assert ms.read(3, 1, PART, 0, MFSBLOCKSIZE)[0][1] == block
    ms.set_version(3, 1, 2, PART)
    assert ms.get(3, PART).version == 2
    ms.duplicate(3, 2, PART, 100, 1)
    assert ms.get(100, PART) is not None
    assert ms.test_part(ms.get(100, PART))
    ms.delete(3, 2, PART)
    assert ms.get(3, PART) is None
    total, _used = ms.space()
    assert total > 0
    with pytest.raises(ChunkStoreError) as e:
        ms.read(3, 2, PART, 0, 1)
    assert e.value.code == st.NO_CHUNK
    ms2 = MultiStore([str(tmp_path / "d0"), str(tmp_path / "d1")])
    assert len(ms2.scan()) == 8  # 7 remaining + duplicate
    # the reference's multi-store scans the same folders alike
    ref_ms = ref_store.MultiStore([str(tmp_path / "d0"), str(tmp_path / "d1")])
    assert sorted((c.chunk_id, c.version, c.part_id) for c in ref_ms.scan()) == sorted(
        (c.chunk_id, c.version, c.part_id) for c in ms2.all_parts())


def test_store_multiple_parts_of_one_chunk(tmp_path):
    store = ChunkStore(str(tmp_path))
    p1 = geometry.ChunkPartType(geometry.ec_type(8, 4), 1).id
    p2 = geometry.ChunkPartType(geometry.ec_type(8, 4), 9).id
    store.create(5, 1, p1)
    store.create(5, 1, p2)
    blk1, blk2 = bytes([0x11]) * MFSBLOCKSIZE, bytes([0x22]) * MFSBLOCKSIZE
    store.write(5, 1, p1, 0, 0, blk1, crc_mod.crc32(blk1))
    store.write(5, 1, p2, 0, 0, blk2, crc_mod.crc32(blk2))
    [(_, d1, _c1)] = store.read(5, 1, p1, 0, MFSBLOCKSIZE)
    [(_, d2, _c2)] = store.read(5, 1, p2, 0, MFSBLOCKSIZE)
    assert d1[:1] == b"\x11" and d2[:1] == b"\x22"
    assert {(c.chunk_id, c.part_id) for c in ChunkStore(str(tmp_path)).scan()} == {(5, p1), (5, p2)}


@pytest.mark.parametrize("migrator", ["port", "jax"])
def test_store_legacy_filename_migration(tmp_path, migrator):
    """Old-format names (no part id) are renamed during the scan, by
    either package, from the signature's part id."""
    store = ChunkStore(str(tmp_path))
    cf = store.create(9, 3, PART)
    blk = bytes([0x7A]) * MFSBLOCKSIZE
    store.write(9, 3, PART, 0, 0, blk, crc_mod.crc32(blk))
    legacy = os.path.join(os.path.dirname(cf.path), f"chunk_{9:016X}_{3:08X}.liz")
    os.rename(cf.path, legacy)
    store2 = STORES[migrator].ChunkStore(str(tmp_path))
    [found] = store2.scan()
    assert found.part_id == PART and found.path != legacy
    assert os.path.basename(found.path) == chunk_filename(9, PART, 3)
    [(_, data, _c)] = store2.read(9, 3, PART, 0, MFSBLOCKSIZE)
    assert data[:1] == b"\x7a"


SPECS = [
    "seed=42; chunkserver:disk_pread flip,limit=1; client:frame_send:CltocsWrite* delay=40,p=0.25",
    "chunkserver:disk_pwrite error=CRC_ERROR,after=2",
    "*:dial:cs:127.0.0.1:9* drop,p=0.5,limit=3",
    "seed=7; chunkserver:disk_pread short",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_and_decisions_match_reference(spec, clean_faults):
    """The same spec parses to the same rules and, over the same calls,
    fires the same decisions with the same deterministic draws."""
    seed, rules = faults.parse_spec(spec)
    rseed, rrules = ref_faults.parse_spec(spec)
    assert seed == rseed and [r.to_dict() for r in rules] == [r.to_dict() for r in rrules]
    port_set, ref_set = faults.FaultSet(seed, rules), ref_faults.FaultSet(rseed, rrules)
    calls = [("chunkserver", "disk_pread", "00:1", ""), ("client", "frame_send", "CltocsWriteData", ""),
             ("chunkserver", "disk_pwrite", "00:1", ""), ("client", "dial", "cs", "127.0.0.1:9422")]
    fired = []
    for i in range(40):
        call = calls[i % len(calls)]
        a, b = port_set.match(*call), ref_set.match(*call)
        assert (a and a.text()) == (b and b.text())
        if a is not None:
            fired.append((a.rand_index(1 << 16), b.rand_index(1 << 16)))
    assert all(x == y for x, y in fired)
    for bad in ("chunkserver:disk_pread", "x:y wat", "x:y delay=0", "x:y error=NOPE", "x:y flip,q=1"):
        with pytest.raises(faults.FaultSpecError) as got:
            faults.parse_spec(bad)
        with pytest.raises(ref_faults.FaultSpecError) as want:
            ref_faults.parse_spec(bad)
        assert str(got.value) == str(want.value)


def test_armed_pread_flip_is_caught_by_the_port(tmp_path, clean_faults):
    """One armed disk_pread flip: the port's store hands back a piece that
    no longer matches its CRC (the receiver's check), once. The JAX
    package's rule set stays empty, and its store reads the file clean."""
    data = data_generator.generate(3, 3 * MFSBLOCKSIZE)
    store, _cf = _fill(port_store, tmp_path, 77, 1, PART, data)
    faults.arm("chunkserver:disk_pread flip,limit=1")
    assert faults.ACTIVE and not ref_faults.ACTIVE
    pieces = store.read(77, 1, PART, 0, 3 * MFSBLOCKSIZE)
    bad = [i for i, (_, p, c) in enumerate(pieces) if crc_mod.crc32(p) != c]
    assert len(bad) == 1
    got = np.concatenate([np.frombuffer(p, np.uint8) for _, p, _ in pieces])
    assert int(np.unpackbits(got ^ data).sum()) == 1
    assert faults.fired_total() == 1 and faults.describe()["events"][0]["site"] == "disk_pread"
    ref = ref_store.ChunkStore(str(tmp_path))
    ref.scan()
    assert all(ref_crc.crc32(p) == c for _, p, c in ref.read(77, 1, PART, 0, 3 * MFSBLOCKSIZE))
    # limit=1: the next read is clean
    assert all(crc_mod.crc32(p) == c for _, p, c in store.read(77, 1, PART, 0, 3 * MFSBLOCKSIZE))


@pytest.mark.parametrize("rule,code", [("chunkserver:disk_pwrite flip,limit=1", st.CRC_ERROR),
                                       ("chunkserver:disk_pwrite short,limit=1", st.CRC_ERROR),
                                       ("chunkserver:disk_pread error=NO_CHUNK", st.NO_CHUNK),
                                       ("chunkserver:disk_pwrite error", st.EIO)])
def test_armed_disk_faults(tmp_path, clean_faults, rule, code):
    """A write flip lands latent corruption (the next read and the tester
    catch it); a short write leaves a stale CRC slot; error rules raise
    the named status."""
    store = ChunkStore(str(tmp_path))
    cf = store.create(8, 1, PART)
    first = data_generator.generate(0, MFSBLOCKSIZE).tobytes()
    store.write(8, 1, PART, 0, 0, first, crc_mod.crc32(first))
    faults.arm(rule)
    block = data_generator.generate(5, MFSBLOCKSIZE).tobytes()
    with pytest.raises(ChunkStoreError) as e:
        store.write(8, 1, PART, 0, 0, block, crc_mod.crc32(block))
        store.read(8, 1, PART, 0, MFSBLOCKSIZE)
    assert e.value.code == code
    if "pwrite" in rule and code == st.CRC_ERROR:
        assert store.test_part(cf) is False
