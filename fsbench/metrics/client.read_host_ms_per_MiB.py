"""The client's own time in its logical reads per MiB read: every phase
its ``read_phases`` charge besides the socket transfer (``net``, read by
``client.read_net_ms_per_MiB``) and the recovery (``decode``, whose seam
call ``seam.recover_ms_per_MiB`` reads): locating chunks, dialing,
throttle and retry waits, and de-interleaving the stripes."""

from fsbench import readings


def read(w):
    p = w.read_phases
    ms = p["locate_ms"] + p["dial_ms"] + p["wait_ms"] + p["gather_ms"]
    return readings.per_mib(ms, readings.bytes_done(w, "read"))
