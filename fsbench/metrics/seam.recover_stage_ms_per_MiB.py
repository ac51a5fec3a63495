"""Host time the client encoder spends staging survivors (pinned buffer,
row copies, enqueued copy to the card) per MiB read: ``read_phases``
``seam_stage``."""

from fsbench import readings


def read(w):
    ms = w.read_phases.get("seam_stage_ms")
    return None if ms is None else readings.per_mib(ms, readings.bytes_done(w, "read"))
