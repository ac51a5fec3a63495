"""The bytes a seam call needs, against numbers worked out by hand."""

import numpy as np
import pytest

from fsbench import roofline, trace

MiB = 1 << 20


def test_recover_bytes():
    # ec(8,4), one lost data row of 256 KiB from 11 survivors: 8 read, 1 written
    assert roofline.recover_bytes(8, 11, 1, 256 * 1024) == 9 * 256 * 1024
    # ec(3,2), two lost rows from the 3 left: 3 read, 2 written
    assert roofline.recover_bytes(3, 3, 2, 1000) == 5000


def test_bound():
    assert roofline.bound_s(9 * MiB, "NVIDIA H100 80GB HBM3") == pytest.approx(9 * MiB / 3.35e12)


def test_timed_encoder_counts_work():
    class Inner:
        name = "inner"

        def recover(self, k, m, parts, wanted):
            return {w: np.zeros(4, np.uint8) for w in wanted}

    enc = trace.TimedEncoder(Inner())
    enc.recover(8, 4, {i: np.zeros(4, np.uint8) for i in range(1, 12)}, [0])
    # ec(3,2), two rows lost, one of the three survivors elided as zeros
    enc.recover(3, 2, {0: np.zeros(8, np.uint8), 1: None, 3: np.zeros(8, np.uint8)}, [2, 4])
    assert [(c.op, c.in_bytes, c.work_bytes) for c in enc.calls] == [
        ("recover", 44, 36), ("recover", 16, 32)]
    assert enc.name == "inner"


def test_device_summary():
    ev = [("void ns::gf_apply_kernel<true>(int)", 1.0, 1.5),
          ("Memcpy HtoD (Pinned -> Device)", 1.4, 2.0), ("x", 5.0, 6.0)]
    s = trace.device_summary(ev, 0.0, 10.0, [("write", 2.0, 4.0)])
    assert s["busy_s"] == pytest.approx(2.0)
    assert s["kernels"] == {"gf_apply_kernel": [1, 0.5]}
    gaps = [(n.split(" (")[0], round(d, 6)) for n, d in s["idle_gaps"]]
    assert gaps == [("no request in flight", 4.0), ("write", 3.0), ("no request in flight", 1.0)]
