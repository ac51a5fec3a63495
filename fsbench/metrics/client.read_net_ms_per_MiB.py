"""The client's ``read_phases`` net busy time per MiB read."""

from fsbench import readings


def read(w):
    return readings.per_mib(w.read_phases["net_ms"], readings.bytes_done(w, "read"))
