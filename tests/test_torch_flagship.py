"""The port's slice end to end on the CPU: striping -> fused step -> lose
parts -> reconstruct step -> reassemble, against the JAX package's
flagship step (XLA path) and golden codec (byte-exact)."""

import numpy as np
import pytest
import torch

from lizardfs_tpu.core import geometry as ref_geometry
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuChunkEncoder
from lizardfs_tpu.models import flagship as ref_flagship
from lizardfs_tpu.ops import crc32 as ref_crc32
from lizardfs_tpu.utils import striping as ref_striping
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.core.encoder import CudaChunkEncoder
from lizardfs_tpu_torch.entry import entry
from lizardfs_tpu_torch.models import flagship
from lizardfs_tpu_torch.ops import cuda_ec, torch_ec
from lizardfs_tpu_torch.utils import striping

BS = 65536


def test_geometry_matches_reference():
    for k, m in ((2, 1), (8, 4), (32, 32)):
        t, rt = geometry.ec_type(k, m), ref_geometry.ec_type(k, m)
        assert int(t) == int(rt) and t.to_string() == rt.to_string()
        assert geometry.required_parts_to_recover(t) == ref_geometry.required_parts_to_recover(rt)
        for part in (0, k - 1, k + m - 1):
            cpt = geometry.ChunkPartType(t, part)
            rcpt = ref_geometry.ChunkPartType(rt, part)
            assert cpt.id == rcpt.id and cpt.is_parity == rcpt.is_parity
            for length in (0, 1000, BS * k + 5, 64 * 2**20):
                assert (geometry.chunk_length_to_part_length(cpt, length)
                        == ref_geometry.chunk_length_to_part_length(rcpt, length))
    x = geometry.xor_type(3)
    assert int(x) == int(ref_geometry.xor_type(3)) and x.expected_parts == 4


def test_whole_slice_ec_8_4():
    k, m = 8, 4
    length = 2 * k * BS - 1000  # two stripes, the last one short
    chunk = np.random.default_rng(11).integers(0, 256, length, dtype=np.uint8)
    st, rst = geometry.ec_type(k, m), ref_geometry.ec_type(k, m)
    enc = CudaChunkEncoder(device="cpu")
    parts = striping.split_chunk(chunk, st, enc)
    ref_parts = ref_striping.split_chunk(chunk, rst, RefCpuChunkEncoder())
    assert sorted(parts) == sorted(ref_parts)
    for i in parts:
        np.testing.assert_array_equal(parts[i], ref_parts[i])
        assert striping.part_length(st, i, length) == ref_striping.part_length(rst, i, length)

    # write: the fused step, held against the JAX flagship step
    data = np.stack([parts[i] for i in range(k)])
    parity, dcrc, pcrc = flagship.make_single_chip_step(k, m, BS, device="cpu")(data)
    w_parity, w_dcrc, w_pcrc = ref_flagship.make_single_chip_step(k, m, BS, use_pallas=False)(data)
    np.testing.assert_array_equal(parity.numpy(), np.asarray(w_parity))
    np.testing.assert_array_equal(torch_ec.crc_words_to_numpy(dcrc), np.asarray(w_dcrc))
    np.testing.assert_array_equal(torch_ec.crc_words_to_numpy(pcrc), np.asarray(w_pcrc))
    for j in range(m):
        np.testing.assert_array_equal(parity[j].numpy(), parts[k + j])
    stored = np.concatenate([np.asarray(w_dcrc), np.asarray(w_pcrc)])
    np.testing.assert_array_equal(
        stored, ref_crc32.block_crcs_golden(
            np.stack([parts[i] for i in range(k + m)]).reshape(-1, BS)).reshape(k + m, -1))

    # lose four parts (data and parity), rebuild them with a CRC verify
    lost = [0, 5, 9, 11]
    avail = [i for i in range(k + m) if i not in lost]
    step = flagship.make_reconstruct_step(k, m, avail, lost, BS, device="cpu")
    rec, crcs, ok = step(np.stack([parts[i] for i in step.used]), stored[lost])
    assert bool(ok.all())
    np.testing.assert_array_equal(torch_ec.crc_words_to_numpy(crcs), stored[lost])
    restored = {i: parts[i] for i in avail}
    for j, i in enumerate(lost):
        np.testing.assert_array_equal(rec[j].numpy(), parts[i])
        restored[i] = rec[j].numpy()

    # lose one data part, rebuild it through the encoder and re-checksum
    rec1 = enc.recover(k, m, {i: parts[i] for i in range(k + m) if i != 3}, [3])
    np.testing.assert_array_equal(enc.checksum(rec1[3].reshape(-1, BS)), stored[3])

    again = striping.assemble_chunk(restored, st, length)
    np.testing.assert_array_equal(again, chunk)
    np.testing.assert_array_equal(again, ref_striping.assemble_chunk(ref_parts, rst, length))


def test_xor_slice_matches_reference():
    chunk = np.random.default_rng(12).integers(0, 256, 3 * BS + 17, dtype=np.uint8)
    st, rst = geometry.xor_type(3), ref_geometry.xor_type(3)
    parts = striping.split_chunk(chunk, st, CudaChunkEncoder(device="cpu"))
    ref_parts = ref_striping.split_chunk(chunk, rst, RefCpuChunkEncoder())
    for i in ref_parts:
        np.testing.assert_array_equal(parts[i], ref_parts[i])
    np.testing.assert_array_equal(striping.assemble_chunk(parts, st, len(chunk)), chunk)


def test_entry_on_cpu_matches_jax_entry():
    fn, (data,) = entry(device="cpu")
    assert data.device.type == "cpu" and tuple(data.shape) == (8, 4 * 4096)
    parity, dcrc, pcrc = fn(data)
    want = ref_flagship.make_single_chip_step(8, 4, 4096, use_pallas=False)(data.numpy())
    np.testing.assert_array_equal(parity.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(torch_ec.crc_words_to_numpy(dcrc), np.asarray(want[1]))
    np.testing.assert_array_equal(torch_ec.crc_words_to_numpy(pcrc), np.asarray(want[2]))


def test_default_device_without_card_raises(monkeypatch):
    """Entry points run on the card; with none they raise, never fall
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship.make_single_chip_step(8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship.make_reconstruct_step(8, 4, list(range(1, 12)), [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        striping.split_chunk(np.zeros(BS, np.uint8), geometry.ec_type(8, 4))


def test_wrappers_refuse_mixed_devices():
    bigm = torch.from_numpy(torch_ec.encoding_bitmatrix(3, 2))
    with pytest.raises(ValueError):
        cuda_ec.encode(bigm, torch.zeros((3, 16), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        cuda_ec.encode(bigm, torch.zeros((3, 32), dtype=torch.uint8)[:, ::2])
    with pytest.raises(ValueError):
        cuda_ec.encode(bigm, torch.zeros((4, 16), dtype=torch.uint8))
