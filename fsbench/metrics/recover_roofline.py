"""The window's recoveries through the seam: their bytes over the card's
peak rate, as a share of the device time of the kernels launched for
them."""

from fsbench import readings


def read(w):
    return readings.roofline_pct(w, "recover")
