"""The control and faults that the check of ``correct`` must catch.

None of these runs in a measured run: ``run.py --control NAME`` puts one
in the program's place, to show on the chip that the comparison fails it,
and the tests drive each through a whole run on the CPU.

Control (it breaks the guarantee the configuration states, that a read
still comes back whole while a chunkserver is down):

* ``recover_zero``: lost rows returned as zeros, the recovery skipped.
  (The XOR of the survivors handed to ``recover`` is no control: for one
  lost data part the client hands k - 1 data parts and the first parity,
  whose ISA-L row is all ones, so their XOR is the true recovery.)

Faults (a timed path broken underneath):

* ``flip_read``: one byte of every read's answer altered where it is
  produced;
* ``half_reads``: every second read's answer left out (empty).
"""

from __future__ import annotations

import numpy as np

CONTROLS = ("recover_zero",)
FAULTS = ("flip_read", "half_reads")


class BrokenEncoder:
    """The client's encoder with its recovery broken; the rest passes."""

    def __init__(self, inner, how: str):
        self._inner = inner
        self.how = how

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def recover(self, k, m, parts, wanted):
        out = self._inner.recover(k, m, parts, wanted)
        return {w: np.zeros_like(v) for w, v in out.items()}


def wrap_client(client, how: str) -> None:
    """Break the client's own reads for the faults that live there."""
    real = client.read_file
    reads = [0]

    async def read_file(inode, offset=0, size=None):
        reads[0] += 1
        buf = await real(inode, offset, size)
        if how == "half_reads":
            return b"" if reads[0] % 2 == 0 else buf
        buf = bytearray(buf)
        if buf:
            buf[len(buf) // 3] ^= 0x01
        return bytes(buf)

    client.read_file = read_file
