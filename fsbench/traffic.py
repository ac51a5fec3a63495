"""The generator that the kinds of load (``fsbench/kinds/``) draw their
requests from, from the parameters of a mix's data file
(``fsbench/traffic/<mix>.json``) and the seed.

Every seed gets the same sizes, in another order (stratified draws,
shuffled by the seed), so seeds change which bytes and files are
touched, not how much work there is.
"""

from __future__ import annotations

import numpy as np


def _rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream.encode()])


def log_uniform_sizes(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` stratified draws of a log-uniform size over ``[lo, hi]``."""
    if lo == hi:
        return np.full(n, lo, dtype=np.int64)
    q = (np.arange(n) + 0.5) / n
    return np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo))).astype(np.int64)


class ReadStream:
    """The closed loop's reads in the order readers take them: ``(file,
    offset, size)``, stratified sizes shuffled by the seed, a block of
    ``block`` at a time (the same blocks for every seed length)."""

    def __init__(self, params: dict, seed: int, block: int = 4096):
        self.lo, self.hi = int(params["size_min"]), int(params["size_max"])
        self.files = int(params["files"])
        self.file_bytes = int(params["file_bytes"])
        self.rng = _rng(seed, "read")
        self.block = block
        self._buf: list[tuple[int, int, int]] = []
        self.issued = 0

    def _refill(self) -> None:
        sizes = self.rng.permutation(log_uniform_sizes(self.block, self.lo, self.hi))
        files = self.rng.integers(0, self.files, self.block)
        offs = self.rng.integers(0, self.file_bytes - sizes + 1)
        self._buf = list(zip(files.tolist(), offs.tolist(), sizes.tolist()))[::-1]

    def next(self) -> tuple[int, int, int]:
        if not self._buf:
            self._refill()
        self.issued += 1
        return self._buf.pop()


def keep_sample(seed: int, n: int, share: float) -> np.ndarray:
    """Which of the first ``n`` requests the check compares in full: a
    ``share`` of them drawn from the seed (at least one)."""
    mask = _rng(seed, "sample").random(n) < share
    mask[0] = True
    return mask
