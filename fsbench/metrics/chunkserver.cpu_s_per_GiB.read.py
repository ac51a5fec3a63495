"""CPU seconds of every chunkserver process per GiB of user data read."""

from fsbench import readings


def read(w):
    nbytes = readings.bytes_done(w, "read")
    return readings.cpu_s(w, "cs") / (nbytes / readings.GiB) if nbytes else None
