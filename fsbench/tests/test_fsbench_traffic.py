"""The inputs are a function of ``--seed``: the traffic generators and the
data stream."""

import numpy as np
import pytest
import torch

from fsbench import data, manifest, traffic

BIG_SEED = 3_000_000_019  # past 32 signed bits, as the driver's are


def _mix(name):
    return manifest.traffic(name)


@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in manifest.load()["workloads"]}))
def test_read_stream_is_the_seeds(mix):
    p = _mix(mix)
    assert p["kind"] == "closed_read"
    s1, s2 = traffic.ReadStream(p, BIG_SEED), traffic.ReadStream(p, BIG_SEED)
    a = [s1.next() for _ in range(5000)]
    assert a == [s2.next() for _ in range(5000)]
    s3 = traffic.ReadStream(p, BIG_SEED + 1)
    b = [s3.next() for _ in range(5000)]
    assert a != b
    # every seed: the same sizes, in another order
    assert sorted(n for *_, n in a[:4096]) == sorted(n for *_, n in b[:4096])
    for f, off, n in a:
        assert 0 <= f < p["files"] and p["size_min"] <= n <= p["size_max"]
        assert 0 <= off <= p["file_bytes"] - n


def test_keep_sample():
    a = traffic.keep_sample(BIG_SEED, 10000, 0.1)
    assert np.array_equal(a, traffic.keep_sample(BIG_SEED, 10000, 0.1))
    assert a[0] and 800 < a.sum() < 1200


@pytest.mark.parametrize("seed", [0, 1, BIG_SEED, 2**40 + 5])
def test_stream_torch_is_stream_numpy(seed):
    for off, n in [(0, 1000), (2**33 - 7, 300)]:
        t = data.stream_torch(seed, off, n, "cpu").numpy()
        assert np.array_equal(t, data.stream_numpy(seed, off, n))
    assert not np.array_equal(data.stream_numpy(seed, 0, 64), data.stream_numpy(seed + 1, 0, 64))


def test_pool_in_pieces():
    a = data.make_pool(BIG_SEED, 5000, "cpu", chunk=777)
    assert np.array_equal(a, data.stream_numpy(BIG_SEED, 0, 5000))


@pytest.mark.card
def test_stream_on_the_card(card):
    t = data.stream_torch(BIG_SEED, 12345, 1 << 20, card).cpu().numpy()
    assert np.array_equal(t, data.stream_numpy(BIG_SEED, 12345, 1 << 20))
    torch.cuda.synchronize()
