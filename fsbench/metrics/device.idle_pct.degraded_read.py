"""Share of the traced window with no kernel or copy on the card."""

from fsbench import readings


def read(w):
    return readings.idle_pct(w)
