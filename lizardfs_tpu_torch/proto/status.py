"""Status codes shared across the protocol (MFS-style, one byte).

Semantic mirror of the reference's LIZARDFS_STATUS_* / LIZARDFS_ERROR_*
space (src/protocol/MFSCommunication.h): 0 = OK, small ints = errors.
"""

OK = 0
EPERM = 1
ENOENT = 2
EACCES = 3
EEXIST = 4
EINVAL = 5
ENOTDIR = 6
EISDIR = 7
ENOSPC = 8
EIO = 9
ENOTEMPTY = 10
CHUNK_LOST = 11
OUT_OF_MEMORY = 12
INDEX_TOO_BIG = 13
LOCKED = 14
NO_CHUNK_SERVERS = 15
NO_CHUNK = 16
CHUNK_BUSY = 17
REGISTER_FIRST = 18
WRONG_VERSION = 19
CRC_ERROR = 20
DISCONNECTED = 21
TIMEOUT = 22
ENOATTR = 23
QUOTA_EXCEEDED = 24
NAME_TOO_LONG = 25
EROFS = 26
ENODATA = 27
BAD_SESSION = 28
NOT_POSSIBLE = 29
# data lives only on the tape tier (lifecycle-demoted inode): reads and
# writes must recall it first (CltomaTapeRecall); transient by design —
# a client that waits out the recall and retries succeeds
TAPE_RECALL = 30
# fair-share admission shed the op for THIS tenant (multi-tenant QoS):
# transient by design — clients back off (the reply's trailing
# retry_after_ms is the server's hint) and retry through the unified
# RetryPolicy; S3 maps it to 503 SlowDown, NFS to JUKEBOX delay
BUSY = 31

_NAMES = {v: k for k, v in list(globals().items()) if isinstance(v, int)}


def name(code: int) -> str:
    return _NAMES.get(code, f"status_{code}")


class StatusError(Exception):
    """Raised by clients when an RPC returns a non-OK status.

    ``retry_after_ms``: the server's backoff hint on BUSY sheds (0 =
    none given); carried so the client's busy-retry loop can honor it
    without re-parsing the reply."""

    def __init__(self, code: int, context: str = "",
                 retry_after_ms: int = 0):
        self.code = code
        self.retry_after_ms = retry_after_ms
        super().__init__(f"{name(code)}{(': ' + context) if context else ''}")
