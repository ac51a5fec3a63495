"""The port's multi-device steps on a CPU mesh against the JAX package's
on its 8-device CPU mesh (tests/conftest.py), byte-exact (tolerance 0).

Every entry of the port's mesh is the CPU device, so the kernel
wrappers run their plain versions and every exchange copy is the tensor
itself; the layout (which device holds which shard) is held against the
JAX package's shard for shard, and the gathered arrays against the JAX
outputs and the golden codec.
"""

import re
import sys
import threading
import time

import jax
import numpy as np
import pytest

from lizardfs_tpu import constants as ref_constants
from lizardfs_tpu.core.encoder import ShardedTpuChunkEncoder
from lizardfs_tpu.parallel import recovery as ref_recovery
from lizardfs_tpu.parallel import sharded as ref_sharded
from lizardfs_tpu_torch import constants
from lizardfs_tpu_torch.core import encoder as port_encoder
from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder, ShardedCudaChunkEncoder, get_encoder
from lizardfs_tpu_torch.entry import dryrun_multichip
from lizardfs_tpu_torch.models import flagship
from lizardfs_tpu_torch.parallel import recovery, sharded

BS = 512
cpu = CpuChunkEncoder()


def _port_mesh(stripe, block=None):
    if block is None:
        return sharded.make_mesh(["cpu"] * stripe)
    return sharded.make_mesh_2d(stripe, block, ["cpu"] * (stripe * block))


def _ref_mesh(stripe, block=None):
    devices = jax.devices()[: stripe * (block or 1)]
    if block is None:
        return ref_sharded.make_mesh(devices)
    return ref_sharded.make_mesh_2d(stripe, block, devices)


def _bounds(index, shape):
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


def _same_layout(port, ref, ref_mesh):
    """Shard for shard: the port's shard at each mesh position covers the
    index of the JAX shard on the device at that position, with its bytes;
    and the gathered arrays are equal."""
    ref_shards = {s.device: s for s in ref.addressable_shards}
    assert len(port.shards) == len(ref_shards) == ref_mesh.devices.size
    for shard, dev in zip(port.shards, ref_mesh.devices.flat):
        want = ref_shards[dev]
        assert _bounds(shard.index, port.shape) == _bounds(want.index, ref.shape)
        got = shard.data.numpy()
        np.testing.assert_array_equal(got.view(np.uint32) if port.crc else got,
                                      np.asarray(want.data))
    np.testing.assert_array_equal(port.gather(), np.asarray(ref))


def _data(seed, k, nb):
    return np.random.default_rng(seed).integers(0, 256, (k, nb * BS), dtype=np.uint8)


def _encode_all(k, m, data):
    parity, dcrc, pcrc = cpu.encode_with_checksums(k, m, data, block_size=BS)
    return np.concatenate([data, parity]), np.concatenate([dcrc, pcrc])


@pytest.mark.parametrize("k,m,mesh_shape", [
    (32, 8, (8,)), (16, 4, (8,)), (8, 8, (8,)), (8, 4, (4, 2)), (8, 4, (2, 4)), (8, 4, (8, 1)),
])
def test_sharded_encode_matches_jax(k, m, mesh_shape):
    nb = 16
    data = _data(k * m, k, nb)
    ref_mesh = _ref_mesh(*mesh_shape)
    got = sharded.sharded_encode_with_crcs(_port_mesh(*mesh_shape), k, m, BS)(data)
    want = ref_sharded.sharded_encode_with_crcs(ref_mesh, k, m, BS)(data)
    for port, ref in zip(got, want):
        _same_layout(port, ref, ref_mesh)
    golden = cpu.encode_with_checksums(k, m, data, block_size=BS)
    np.testing.assert_array_equal(got[0].gather().reshape(m, -1), golden[0])
    np.testing.assert_array_equal(got[1].gather(), golden[1])
    np.testing.assert_array_equal(got[2].gather(), golden[2])


def test_sharded_encode_takes_rows_tensors_and_arrays():
    import torch

    k, m = 8, 4
    data = _data(9, k, 8)
    run = flagship.make_multichip_step(_port_mesh(2, 2), k, m, BS)
    want = [a.gather() for a in run(data)]
    for given in (torch.from_numpy(data), list(data)):
        for a, b in zip(run(given), want):
            np.testing.assert_array_equal(a.gather(), b)


@pytest.mark.parametrize("k,m,seed,mesh_shape", [
    (32, 8, 0, (8,)), (16, 16, 1, (8,)), (8, 4, 2, (8,)), (8, 4, 3, (4, 2)), (8, 4, 4, (2, 4)),
])
def test_sharded_reconstruct_matches_jax(k, m, seed, mesh_shape):
    """Random erasures (data and parity mixed): the port's mesh rebuild
    against the JAX package's, shard for shard, and the rebuilt blocks
    checksum to the stored CRCs."""
    nb = 16
    rng = np.random.default_rng(seed)
    all_parts, all_crcs = _encode_all(k, m, _data(seed, k, nb))
    port_mesh, ref_mesh = _port_mesh(*mesh_shape), _ref_mesh(*mesh_shape)
    for _ in range(2):
        lost = sorted(int(i) for i in rng.choice(k + m, size=int(rng.integers(1, m + 1)),
                                                 replace=False))
        avail = [i for i in range(k + m) if i not in lost]
        run = flagship.make_multichip_reconstruct_step(port_mesh, k, m, avail, lost, BS)
        ref_run = ref_recovery.sharded_reconstruct_with_crcs(ref_mesh, k, m, avail, lost, BS)
        assert run.used == ref_run.used
        survivors = all_parts[run.used]
        for port, ref in zip(run(survivors), ref_run(survivors)):
            _same_layout(port, ref, ref_mesh)
        rec, crcs, ok = recovery.sharded_reconstruct_verify(
            port_mesh, k, m, avail, lost, {i: all_parts[i] for i in avail}, BS,
            expected_crcs=all_crcs[lost])
        assert ok, (k, m, lost)
        np.testing.assert_array_equal(rec, all_parts[lost])
        np.testing.assert_array_equal(crcs, all_crcs[lost])


@pytest.mark.parametrize("case", ["encode-k", "encode-nb", "rebuild-k", "rebuild-rows", "mesh-2d"])
def test_refusals_match_jax(case):
    """The reference's checks, with its messages."""
    mesh, ref_mesh = _port_mesh(8), _ref_mesh(8)
    calls = {
        "encode-k": lambda s, mm: s.sharded_encode_with_crcs(mm, 12, 4, BS),
        "encode-nb": lambda s, mm: s.sharded_encode_with_crcs(mm, 8, 4, BS)(_data(0, 8, 12)),
        "rebuild-k": lambda r, mm: r.sharded_reconstruct_with_crcs(mm, 12, 4, list(range(12)),
                                                                  [12], BS),
        "rebuild-rows": lambda r, mm: r.sharded_reconstruct_with_crcs(
            mm, 8, 4, list(range(1, 12)), [0], BS)(_data(0, 7, 8)),
        "mesh-2d": lambda s, _: s.make_mesh_2d(3, 2, (["cpu"] * 8 if s is sharded
                                                      else jax.devices())),
    }
    module = (sharded if case.startswith("encode") or case == "mesh-2d" else recovery)
    ref_module = {sharded: ref_sharded, recovery: ref_recovery}[module]
    with pytest.raises(ValueError) as want:
        calls[case](ref_module, ref_mesh)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        calls[case](module, mesh)


def test_mesh_defaults_to_the_cards():
    mesh = _port_mesh(4, 2)
    assert mesh.shape == {"stripe": 4, "block": 2} and mesh.size == 8
    assert [str(d) for d in mesh.devices.flat] == ["cpu"] * 8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def _parts_of(k, m, nbytes, seed, lost):
    data = np.random.default_rng(seed).integers(0, 256, (k, nbytes), dtype=np.uint8)
    allp = np.concatenate([data, np.stack(cpu.encode(k, m, list(data)))])
    return allp, {i: allp[i] for i in range(k + m) if i not in lost}


@pytest.mark.parametrize("k,m,nbytes,lost,mesh_shape,path", [
    (16, 4, 8 * BS, [0, 18], (8,), "mesh"),
    (8, 4, 8 * BS, [2, 9], (4, 2), "mesh"),
    (6, 2, 4 * BS, [1], (8,), "card"),  # k does not divide the mesh
    (16, 4, 8 * BS + 4, [3], (8,), "card"),  # bytes do not divide the mesh
    (4, 2, 384, [0], (2,), "card"),  # 192-byte blocks: no CRC block size
])
def test_sharded_encoder_recover(k, m, nbytes, lost, mesh_shape, path):
    """Byte-identical to the golden codec on either path, and counted on
    the path the reference's guard (plus the CRC block rule) picks."""
    allp, parts = _parts_of(k, m, nbytes, k + nbytes, lost)
    enc = ShardedCudaChunkEncoder(_port_mesh(*mesh_shape))
    got = enc.recover(k, m, parts, lost)
    want = cpu.recover(k, m, parts, lost)
    for w in lost:
        np.testing.assert_array_equal(got[w], want[w])
        np.testing.assert_array_equal(got[w], allp[w])
    assert enc.recovers == {"mesh": 0, "card": 0, path: 1}


def test_reference_guard_fault_is_routed_to_the_card():
    """The JAX package's sharded encoder sends 384-byte ec(4,2) parts on
    two devices to the mesh, where its CRC refuses 192-byte blocks; the
    port's guard keeps them on one device and gives the golden bytes."""
    allp, parts = _parts_of(4, 2, 384, 5, [0])
    ref_enc = ShardedTpuChunkEncoder(_ref_mesh(2), force_cpu=True)
    with pytest.raises(AssertionError, match="power of two"):
        ref_enc.recover(4, 2, parts, [0])
    got = ShardedCudaChunkEncoder(_port_mesh(2)).recover(4, 2, parts, [0])
    np.testing.assert_array_equal(got[0], allp[0])


def test_zero_parts_take_the_card_path():
    allp, parts = _parts_of(8, 4, 8 * BS, 6, [1])
    allp[3] = 0
    parts = {i: allp[i] for i in parts}
    parts[3] = None
    enc = ShardedCudaChunkEncoder(_port_mesh(8))
    got = enc.recover(8, 4, parts, [1])
    np.testing.assert_array_equal(got[1], cpu.recover(8, 4, parts, [1])[1])
    assert enc.recovers == {"mesh": 0, "card": 1}


@pytest.mark.parametrize("off", ["0", "off", "FALSE", "No"])
def test_kill_switch(monkeypatch, off):
    """LZ_SHARDED_RECOVERY off: the constructor refuses, a live instance
    rebuilds on one device (switch read per call) and byte-identical."""
    enc = ShardedCudaChunkEncoder(_port_mesh(8))
    allp, parts = _parts_of(8, 4, 8 * BS, 7, [3])
    monkeypatch.setenv("LZ_SHARDED_RECOVERY", off)
    assert not recovery.enabled()
    with pytest.raises(RuntimeError, match="disabled"):
        ShardedCudaChunkEncoder(_port_mesh(8))

    def poisoned(*args, **kwargs):
        raise AssertionError("mesh path used despite the kill switch")

    monkeypatch.setattr(enc, "_mesh_recover_step", poisoned)
    np.testing.assert_array_equal(enc.recover(8, 4, parts, [3])[3], allp[3])
    assert enc.recovers == {"mesh": 0, "card": 1}
    monkeypatch.setenv("LZ_SHARDED_RECOVERY", "1")
    with pytest.raises(AssertionError, match="kill switch"):
        enc.recover(8, 4, parts, [3])


def test_registry_without_cards():
    """No card: "sharded" and "cuda" refuse, and the auto ladder ends on
    "cuda"'s refusal, never on the CPU."""
    with pytest.raises(RuntimeError, match=">= 2 cards"):
        get_encoder("sharded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_encoder("auto")
    assert ("sharded", None) not in port_encoder._ENCODERS


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip_small_mesh(n, capsys):
    ran = dryrun_multichip(n, block_size=4096, min_logical_mib=1, devices=["cpu"] * n)
    assert ran["k"] == 32 and ran["m"] == 8 and ran["mesh"].size == n
    want = {"stripe": n} if n == 2 else {"stripe": n // 2, "block": 2}
    assert ran["mesh"].shape == want
    assert "dryrun_multichip OK: ec(32,8)" in capsys.readouterr().out


@pytest.mark.parametrize("value", [None, "", "0", "off", "OFF", "false", "False", "no", "NO",
                                   "1", "on", "yes", "true", "2"])
@pytest.mark.parametrize("default", [True, False])
def test_env_flag_matches_reference(monkeypatch, value, default):
    assert constants.OFF_SPELLINGS == ref_constants.OFF_SPELLINGS
    if value is None:
        monkeypatch.delenv("LZ_SHARDED_RECOVERY", raising=False)
    else:
        monkeypatch.setenv("LZ_SHARDED_RECOVERY", value)
    got = constants.env_flag("LZ_SHARDED_RECOVERY", default)
    assert got == ref_constants.env_flag("LZ_SHARDED_RECOVERY", default)
    assert recovery.enabled() == ref_recovery.enabled()


class SlowDict(dict):
    """A dict that yields the interpreter inside the steps a thread
    takes to check, read or store an entry, where an unguarded
    check-then-set or read-modify-write lets another thread in."""

    def __contains__(self, key):
        time.sleep(0.0005)
        return super().__contains__(key)

    def get(self, key, default=None):
        value = super().get(key, default)
        time.sleep(0.0005)
        return value

    def __setitem__(self, key, value):
        time.sleep(0.0005)
        super().__setitem__(key, value)


def test_sharded_encoder_under_threads(monkeypatch):
    """Every port client encodes and recovers from worker threads, and
    with two or more cards on one ``ShardedCudaChunkEncoder``: eight
    threads of ``recover`` (on the mesh and on one card) and ``encode``
    over a mesh of four, beside concurrent ``get_encoder("cpu")`` calls,
    get the golden bytes, count every recover once, build each rebuild
    step once, and share one registry object."""
    enc = ShardedCudaChunkEncoder(_port_mesh(4))
    enc.recovers = SlowDict(enc.recovers)
    enc._rec_steps = SlowDict()
    monkeypatch.setattr(port_encoder, "_ENCODERS", SlowDict())
    builds = []
    build = recovery.sharded_reconstruct_with_crcs

    def counted_build(mesh, k, m, avail, wanted, block_size):
        builds.append((k, m, tuple(avail), tuple(wanted), block_size))
        return build(mesh, k, m, avail, wanted, block_size)

    monkeypatch.setattr(recovery, "sharded_reconstruct_with_crcs", counted_build)
    # (k, m, bytes a part, lost): the mesh path, then the card path (k
    # does not divide the mesh, or the bytes do not)
    cases = [(8, 4, 4 * BS, [3]), (4, 2, 8 * BS, [0, 5]), (3, 2, 4 * BS, [1]),
             (8, 4, 4 * BS + 64, [2])]
    golden = {}
    for i, (k, m, nbytes, _) in enumerate(cases):
        data = np.random.default_rng(i).integers(0, 256, (k, nbytes), dtype=np.uint8)
        golden[i] = list(data) + cpu.encode(k, m, list(data))
    errors, registry = [], []
    start = threading.Barrier(8)

    def work(seed):
        start.wait()
        for j in range(6):
            i = (seed + j) % len(cases)
            k, m, _, lost = cases[i]
            parts = golden[i]
            try:
                registry.append(get_encoder("cpu"))
                for a, b in zip(enc.encode(k, m, parts[:k]), parts[k:]):
                    np.testing.assert_array_equal(a, b)
                avail = {p: parts[p] for p in range(k + m) if p not in lost}
                got = enc.recover(k, m, avail, lost)
                for p in lost:
                    np.testing.assert_array_equal(got[p], parts[p])
            except Exception as e:  # collected: a thread's failure fails the test
                errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(seed,)) for seed in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert enc.recovers["mesh"] + enc.recovers["card"] == 8 * 6
    assert enc.recovers["mesh"] > 0 and enc.recovers["card"] > 0
    assert sorted(builds) == sorted(set(builds)) and len(builds) == 2, builds
    assert len({id(e) for e in registry}) == 1 and len(registry) == 8 * 6
