"""Time the read's off-loop hops (the native part exchange, the native
stripe gather, the de-interleave) waited, from their submission until an
executor thread started them, per MiB read: ``read_phases`` ``net_queue``
+ ``gather_queue``."""

from fsbench import readings


def read(w):
    p = w.read_phases
    if "net_queue_ms" not in p:
        return None
    ms = p["net_queue_ms"] + p["gather_queue_ms"]
    return readings.per_mib(ms, readings.bytes_done(w, "read"))
