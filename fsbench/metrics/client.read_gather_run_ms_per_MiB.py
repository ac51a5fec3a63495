"""The stripe de-interleave's own time, in its executor thread, per MiB
read: ``read_phases`` ``gather_run``."""

from fsbench import readings


def read(w):
    ms = w.read_phases.get("gather_run_ms")
    return None if ms is None else readings.per_mib(ms, readings.bytes_done(w, "read"))
