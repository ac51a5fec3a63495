"""Host time inside the client encoder's ``recover`` per MiB read."""

from fsbench import readings


def read(w):
    return readings.seam_ms_per_mib(w, "recover", readings.bytes_done(w, "read"))
