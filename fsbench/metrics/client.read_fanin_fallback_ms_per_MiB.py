"""Time the read's stripe fan-in hops spent before they failed and sent
their reads back to the waves, from submission to the failure, per MiB
read: ``read_phases`` ``fanin_fallback``."""

from fsbench import readings


def read(w):
    ms = w.read_phases.get("fanin_fallback_ms")
    return None if ms is None else readings.per_mib(ms, readings.bytes_done(w, "read"))
