"""The erasure code's plain reference, ``fsbench/reference_rs.py``, against
field values, generator matrices and striping worked out by hand; and the
reference loads nothing of the program."""

import itertools
import json
import os
import subprocess
import sys

import pytest
import torch

from fsbench import reference_rs as rs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def carryless_mul(a: int, b: int) -> int:
    """The field's product by shifts and XORs, without the tables."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= 0x11D
    return out


def test_tables_are_the_field():
    for a in range(256):
        for b in (0, 1, 2, 3, 0x53, 0x8E, 0xCA, 0xFF, a):
            assert rs.mul(a, b) == carryless_mul(a, b)
        if a:
            assert carryless_mul(a, rs.inv(a)) == 1


@pytest.mark.parametrize("k,m,cauchy", [
    (8, 4, False), (20, 4, False), (21, 4, True), (32, 4, True),
    (3, 2, False), (32, 3, False), (2, 5, True), (32, 8, True),
])
def test_matrix_selection(k, m, cauchy):
    a = rs.generator_matrix(k, m)
    assert rs.uses_cauchy(k, m) == cauchy and len(a) == k + m
    assert a[:k] == [[int(i == j) for j in range(k)] for i in range(k)]
    if cauchy:
        # row k + r, column j: 1 / ((k + r) ^ j)
        assert all(carryless_mul(a[i][j], i ^ j) == 1 for i in range(k, k + m) for j in range(k))
    else:
        # parity row r: the powers of 2^r; the first is all ones
        assert a[k] == [1] * k
        for r in range(1, m):
            g = 1
            for _ in range(r):
                g = carryless_mul(g, 2)
            p = 1
            for j in range(k):
                assert a[k + r][j] == p
                p = carryless_mul(p, g)


def test_striping_by_hand():
    # ec(3,2) over 7 blocks and 100 bytes: part i holds blocks i, i+3, i+6
    block = rs.BLOCK
    n = 7 * block + 100
    chunk = (torch.arange(n) // block).to(torch.uint8)
    parts = rs.stripe(chunk, 3)
    assert [p.numel() for p in parts] == [3 * block, 2 * block + 100, 2 * block]
    assert [p[::block].tolist() for p in parts] == [[0, 3, 6], [1, 4, 7], [2, 5]]
    assert [rs.part_length(3, i, n) for i in range(5)] == [3 * block, 2 * block + 100,
                                                         2 * block, 3 * block, 3 * block]


@pytest.mark.parametrize("k,m", [(32, 8), (8, 4)])
def test_any_k_parts_give_back_the_stripe(k, m):
    """The code is MDS: every choice of k of the k + m parts tried (every
    one at (8,4), and at (32,8) those that drop the first, the last and
    every run of 8 consecutive parts, and 40 drawn at random) recovers
    the data parts."""
    gen = torch.Generator().manual_seed(k * 1000 + m)
    data = [torch.randint(0, 256, (96,), dtype=torch.uint8, generator=gen) for _ in range(k)]
    parts = dict(enumerate(data + rs.parity(data, k, m)))
    if k == 8:
        drops = list(itertools.combinations(range(k + m), m))
    else:
        drops = [tuple(range(s, s + m)) for s in range(k + 1)]
        rng = torch.Generator().manual_seed(7)
        drops += [tuple(torch.randperm(k + m, generator=rng)[:m].tolist()) for _ in range(40)]
    for drop in drops:
        kept = {i: p for i, p in parts.items() if i not in drop}
        assert all(torch.equal(a, b) for a, b in zip(rs.recover(k, m, kept), data)), drop


def test_parity_pads_short_parts_with_zeros():
    data = [torch.tensor([1, 2, 3], dtype=torch.uint8), torch.tensor([4], dtype=torch.uint8)]
    padded = [data[0], torch.tensor([4, 0, 0], dtype=torch.uint8)]
    assert all(torch.equal(a, b) for a, b in zip(rs.parity(data, 2, 2), rs.parity(padded, 2, 2)))
    # the first Vandermonde parity is the XOR of the data parts
    assert rs.parity(data, 2, 2)[0].tolist() == [1 ^ 4, 2, 3]


def test_the_reference_loads_nothing_of_the_program():
    """Whole top-level names compared, since the port's name begins with
    the JAX package's."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import fsbench.reference_rs\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    for bad in ("jax", "lizardfs_tpu", "lizardfs_tpu_torch"):
        assert bad not in tops, bad
    assert "torch" in tops
