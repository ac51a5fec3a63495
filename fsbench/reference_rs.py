"""The plain reference of LizardFS's erasure code: what the parts of a
chunk stored under ``$ec(k,m)`` hold, worked out in plain torch integer
ops on the CPU. It imports nothing of the program.

* GF(2^8) with the reduction polynomial 0x11D and generator 2 (ISA-L's
  field), multiplied by log/exp tables.
* The generator matrix as LizardFS chooses it (``reed_solomon.h``): the
  Cauchy matrix of ISA-L's ``gf_gen_cauchy1_matrix`` for m >= 5, or for
  m == 4 with k > 20; ISA-L's Vandermonde ``gf_gen_rs_matrix`` below
  that. Both are (k + m) x k, the identity on top.
* Striping (``slice_traits.h``): block j of a chunk's 64 KiB blocks goes
  to data part j % k, so a part holds its blocks in order, and a part's
  length is the chunk's whole stripe rows plus its share of the last,
  partial one.
* Parity: parity part r is the sum over the data parts, each zero-padded
  to the longest, of the matrix's row k + r times it.
* Recovery from any k parts: the inverse of their k rows of the matrix,
  applied to them (the code is MDS: any k of the k + m parts will do).
"""

from __future__ import annotations

import torch

POLY = 0x11D
BLOCK = 64 * 1024


def _tables() -> tuple[torch.Tensor, torch.Tensor]:
    """``exp`` over 0..509 (twice round, so a sum of two logs indexes it)
    and ``log`` over 0..255 (``log[0]`` unused)."""
    exp = [0] * 510
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return torch.tensor(exp, dtype=torch.int64), torch.tensor(log, dtype=torch.int64)


EXP, LOG = _tables()
_EXP, _LOG = EXP.tolist(), LOG.tolist()


def mul(a: int, b: int) -> int:
    """The product of two field elements."""
    return 0 if a == 0 or b == 0 else _EXP[_LOG[a] + _LOG[b]]


def inv(a: int) -> int:
    """The inverse of a nonzero field element."""
    return _EXP[255 - _LOG[a]]


def vandermonde(k: int, m: int) -> list[list[int]]:
    """``gf_gen_rs_matrix``: parity row r is 1, g, g^2, ... with g = 2^r."""
    rows = [[int(i == j) for j in range(k)] for i in range(k)]
    gen = 1
    for _ in range(m):
        row, p = [], 1
        for _ in range(k):
            row.append(p)
            p = mul(p, gen)
        rows.append(row)
        gen = mul(gen, 2)
    return rows


def cauchy1(k: int, m: int) -> list[list[int]]:
    """``gf_gen_cauchy1_matrix``: row i >= k, column j is 1 / (i ^ j)."""
    rows = [[int(i == j) for j in range(k)] for i in range(k)]
    rows += [[inv(i ^ j) for j in range(k)] for i in range(k, k + m)]
    return rows


def uses_cauchy(k: int, m: int) -> bool:
    """LizardFS's choice of matrix (``reed_solomon.h``)."""
    return m >= 5 or (m == 4 and k > 20)


def generator_matrix(k: int, m: int) -> list[list[int]]:
    return cauchy1(k, m) if uses_cauchy(k, m) else vandermonde(k, m)


def apply(rows: list[list[int]], parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each row of coefficients times the parts (uint8 tensors of one
    length), summed in the field: one uint8 tensor a row."""
    logs = [LOG[p.to(torch.int64)] for p in parts]
    zero = [p == 0 for p in parts]
    out = []
    for row in rows:
        acc = torch.zeros(parts[0].numel(), dtype=torch.int64)
        for c, lg, z in zip(row, logs, zero):
            if c:
                acc ^= torch.where(z, 0, EXP[lg + _LOG[c]])
        out.append(acc.to(torch.uint8))
    return out


def part_length(k: int, index: int, chunk_length: int) -> int:
    """Bytes of part ``index`` (data parts 0..k-1, then parity) of a chunk
    of ``chunk_length`` bytes (``slice_traits.h``)."""
    rows, rest = divmod(chunk_length, k * BLOCK)
    share = rest - index * BLOCK if index < k else rest
    return rows * BLOCK + min(max(share, 0), BLOCK)


def stripe(chunk: torch.Tensor, k: int) -> list[torch.Tensor]:
    """The k data parts of a chunk's bytes, each at its own length."""
    n = chunk.numel()
    blocks = -(-n // BLOCK)
    padded = torch.zeros(-(-blocks // k) * k * BLOCK, dtype=torch.uint8)
    padded[:n] = chunk
    grid = padded.view(-1, k, BLOCK)
    return [grid[:, i, :].reshape(-1)[: part_length(k, i, n)].clone() for i in range(k)]


def parity(data: list[torch.Tensor], k: int, m: int) -> list[torch.Tensor]:
    """The m parity parts of k data parts, padded with zeros to the
    longest."""
    n = max(p.numel() for p in data)
    padded = [torch.cat([p, torch.zeros(n - p.numel(), dtype=torch.uint8)]) for p in data]
    return apply(generator_matrix(k, m)[k:], padded)


def invert(rows: list[list[int]]) -> list[list[int]]:
    """Gauss-Jordan inverse of a square matrix over the field."""
    n = len(rows)
    a = [list(r) + [int(i == j) for j in range(n)] for i, r in enumerate(rows)]
    for col in range(n):
        pivot = next(r for r in range(col, n) if a[r][col])
        a[col], a[pivot] = a[pivot], a[col]
        s = inv(a[col][col])
        a[col] = [mul(s, x) for x in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [x ^ mul(f, y) for x, y in zip(a[r], a[col])]
    return [r[n:] for r in a]


def recover(k: int, m: int, parts: dict[int, torch.Tensor]) -> list[torch.Tensor]:
    """The k data parts from any k of the k + m parts (index -> bytes, of
    one length)."""
    have = sorted(parts)[:k]
    gen = generator_matrix(k, m)
    return apply(invert([gen[i] for i in have]), [parts[i] for i in have])
