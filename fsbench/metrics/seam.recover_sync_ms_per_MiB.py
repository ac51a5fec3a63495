"""Host time the client encoder blocks until the card's results are back
(copy in, kernel, copy out) per MiB read: ``read_phases``
``seam_sync``."""

from fsbench import readings


def read(w):
    ms = w.read_phases.get("seam_sync_ms")
    return None if ms is None else readings.per_mib(ms, readings.bytes_done(w, "read"))
