"""User bytes that every reader got back inside the window, over the
window's seconds (checked afterwards against the reference)."""

from fsbench import readings


def read(w):
    return readings.bytes_done(w, "read", in_window=True) / readings.MiB / w.seconds
