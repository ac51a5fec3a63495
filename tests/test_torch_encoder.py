"""The port's CudaChunkEncoder, on the CPU, against the JAX package's
golden CpuChunkEncoder, method by method (byte-exact)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuChunkEncoder
from lizardfs_tpu_torch.core import encoder as port_encoder
from lizardfs_tpu_torch.core.encoder import CpuChunkEncoder, CudaChunkEncoder, get_encoder
from lizardfs_tpu_torch.ops import torch_ec

ref = RefCpuChunkEncoder()


@pytest.fixture(scope="module")
def enc():
    return CudaChunkEncoder(device="cpu")


def _parts(rng, k, size):
    return [rng.integers(0, 256, size, dtype=np.uint8) for _ in range(k)]


@pytest.mark.parametrize("k,m", [(2, 1), (3, 2), (8, 4), (8, 5), (32, 8)])
def test_encode(enc, k, m):
    data = _parts(np.random.default_rng(0), k, 4096)
    for a, b in zip(enc.encode(k, m, data), ref.encode(k, m, data)):
        np.testing.assert_array_equal(a, b)


def test_encode_with_zero_elision(enc):
    k, m, size = 5, 3, 1024
    data = _parts(np.random.default_rng(1), k, size)
    data[1] = None
    data[4] = None
    for a, b in zip(enc.encode(k, m, data), ref.encode(k, m, data)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        enc.encode(k, m, [None] * k)


@pytest.mark.parametrize("k,m,size", [(3, 2, 1), (8, 4, 777), (8, 4, 4099), (32, 8, 2048)])
def test_recover_any_length(enc, k, m, size):
    rng = np.random.default_rng(size)
    data = _parts(rng, k, size)
    allparts = data + ref.encode(k, m, data)
    erased = sorted(rng.choice(k + m, size=m, replace=False).tolist())
    avail = {i: allparts[i] for i in range(k + m) if i not in erased}
    got = enc.recover(k, m, avail, erased)
    want = ref.recover(k, m, avail, erased)
    for i in erased:
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], allparts[i])


def test_recover_with_zero_parts(enc):
    """Available parts given as None are all-zero and elided."""
    k, m, size = 4, 2, 512
    rng = np.random.default_rng(7)
    data = _parts(rng, k, size)
    data[2] = np.zeros(size, np.uint8)
    allparts = data + ref.encode(k, m, data)
    avail = {i: allparts[i] for i in (1, 2, 3, 4, 5)}
    avail[2] = None
    got = enc.recover(k, m, avail, [0])
    np.testing.assert_array_equal(got[0], ref.recover(k, m, avail, [0])[0])
    np.testing.assert_array_equal(got[0], allparts[0])


def test_checksum(enc):
    rng = np.random.default_rng(3)
    for bs in (512, 65536):
        blocks = rng.integers(0, 256, size=(6, bs), dtype=np.uint8)
        got = enc.checksum(blocks)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, ref.checksum(blocks))


def test_encode_with_checksums(enc):
    k, m, bs, nb = 8, 4, 4096, 3
    data = np.random.default_rng(4).integers(0, 256, size=(k, nb * bs), dtype=np.uint8)
    got = enc.encode_with_checksums(k, m, data, block_size=bs)
    want = ref.encode_with_checksums(k, m, data, block_size=bs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[1].dtype == np.uint32 and got[2].dtype == np.uint32


def test_encode_into(enc):
    """Parity lands straight in row slices of one caller buffer."""
    k, m, size = 8, 4, 3000
    data = _parts(np.random.default_rng(5), k, size)
    send = np.zeros((m + 1, size), np.uint8)
    enc.encode_into(k, m, data, [send[i] for i in range(m)])
    np.testing.assert_array_equal(send[:m], np.stack(ref.encode(k, m, data)))
    assert not send[m].any()


def test_xor_parity(enc):
    parts = _parts(np.random.default_rng(6), 4, 777)
    np.testing.assert_array_equal(enc.xor_parity(parts), ref.xor_parity(parts))
    out = np.empty(777, np.uint8)
    enc.xor_parity_into(parts, out)
    np.testing.assert_array_equal(out, ref.xor_parity(parts))


def test_matrix_is_uploaded_once(enc):
    """One device copy per matrix, so that the kernels' packed tables
    (kept per matrix tensor) are built once and the matrix read back
    once."""
    bigm = np.array(torch_ec.encoding_bitmatrix(8, 4))
    first = enc._matrix(bigm)
    assert enc._matrix(bigm.copy()) is first
    other = enc._matrix(bigm[::-1])
    assert other is not first
    np.testing.assert_array_equal(other.numpy(), bigm[::-1])


def test_cpu_encoder_matches_reference():
    k, m, bs = 3, 2, 4096
    data = np.random.default_rng(8).integers(0, 256, (k, 2 * bs), dtype=np.uint8)
    for a, b in zip(CpuChunkEncoder().encode_with_checksums(k, m, data, bs),
                    ref.encode_with_checksums(k, m, data, bs)):
        np.testing.assert_array_equal(a, b)


def test_registry(monkeypatch):
    assert get_encoder("cpu").name == "cpu"
    with pytest.raises(ValueError):
        get_encoder("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_encoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_encoder.CudaChunkEncoder()


def test_registry_keeps_one_encoder_per_name_and_device():
    """get_encoder returns the same object for a (name, device) each time,
    so an encoder's device matrices (and the kernels' tables) outlive a
    call; different devices or names get different encoders."""
    assert get_encoder("cpu") is get_encoder("cpu")
    cuda_on_cpu = get_encoder("cuda", "cpu")
    assert get_encoder("cuda", torch.device("cpu")) is cuda_on_cpu
    assert isinstance(cuda_on_cpu, CudaChunkEncoder) and cuda_on_cpu.device.type == "cpu"
    assert cuda_on_cpu is not get_encoder("cpu")
    bigm = np.array(torch_ec.encoding_bitmatrix(8, 4))
    assert get_encoder("cuda", "cpu")._matrix(bigm) is cuda_on_cpu._matrix(bigm.copy())


@pytest.mark.parametrize("name", ["cpu", "sharded"])
def test_registry_refuses_a_device_for_a_backend_that_takes_none(name):
    """Only "cuda" (and "auto", which lands on it) runs on a named device:
    naming one for another backend raises instead of handing back that
    backend's one encoder."""
    with pytest.raises(ValueError, match="takes no device"):
        get_encoder(name, "cpu")


class SlowEvictions(dict):
    """A matrix cache that yields the interpreter between choosing the
    entry to evict and evicting it, where an unguarded cache lets another
    thread evict the same entry first."""

    def pop(self, key):
        time.sleep(0.001)
        return super().pop(key)


def test_concurrent_encodes_share_one_encoder(monkeypatch):
    """The client encodes the chunks of one write in worker threads on
    one encoder: eight threads encoding and recovering across geometries,
    with a one-matrix cache that evicts on every miss, get the golden
    bytes and no error."""
    monkeypatch.setattr(port_encoder, "_MATRIX_CACHE", 1)
    enc = CudaChunkEncoder(device="cpu")
    enc._matrices = SlowEvictions()
    geometries = [(k, m) for k in (2, 3, 4, 8) for m in (1, 2)]
    errors = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for i in range(6):
            k, m = geometries[(seed + i) % len(geometries)]
            data = _parts(rng, k, 64)
            try:
                parity = enc.encode(k, m, data)
                for a, b in zip(parity, ref.encode(k, m, data)):
                    np.testing.assert_array_equal(a, b)
                avail = {i: p for i, p in enumerate(data + parity) if i != 0}
                np.testing.assert_array_equal(enc.recover(k, m, avail, [0])[0], data[0])
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
