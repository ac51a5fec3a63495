"""Time the read's off-loop hops waited for the event loop, from their
return in the thread until the awaiting coroutine ran again, per MiB
read: ``read_phases`` ``net_resume`` + ``gather_resume``."""

from fsbench import readings


def read(w):
    p = w.read_phases
    if "net_resume_ms" not in p:
        return None
    ms = p["net_resume_ms"] + p["gather_resume_ms"]
    return readings.per_mib(ms, readings.bytes_done(w, "read"))
