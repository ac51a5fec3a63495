"""Core geometry constants of the PyTorch/CUDA port.

The fixed geometry of the file system (reference: CMakeLists.txt:93-94,
src/protocol/MFSCommunication.h:60-84): a chunk is 1024 blocks of 64 KiB,
each block carries a CRC32 (polynomial 0xEDB88320, zlib-compatible).
The JAX package's ``constants.py`` holds the same values; tests pin the
two together.
"""

# One block: unit of CRC protection and of striping.
MFSBLOCKSIZE = 64 * 1024  # 65536

# Blocks per chunk.
MFSBLOCKSINCHUNK = 1024

# One chunk: unit of replication / erasure coding (64 MiB).
MFSCHUNKSIZE = MFSBLOCKSIZE * MFSBLOCKSINCHUNK

# Header of a chunk part file on disk (signature 1 KiB + CRC table 4 KiB);
# the chunk store's layout (chunkserver/chunk_store.py).
MFSHDRSIZE = 4 * 1024 + 1024

# Maximum file size = chunk size * 2^31 (MFSCommunication.h:84).
MAX_FILE_SIZE = MFSCHUNKSIZE * (1 << 31)

# CRC32 polynomial (reflected), identical to zlib's crc32
# (MFSCommunication.h:81).
CRC_POLY = 0xEDB88320

# GF(2^8) reduction polynomial used by the EC codec: x^8+x^4+x^3+x^2+1
# (0x11d), identical to Intel ISA-L (src/common/galois_field_isal.cc:37-44).
GF_POLY = 0x11D

# EC parameter bounds (src/common/slice_traits.h:143-146).
EC_MIN_DATA = 2
EC_MAX_DATA = 32
EC_MIN_PARITY = 1
EC_MAX_PARITY = 32

# XOR goal bounds (src/common/slice_traits.h:99-100).
XOR_MIN_LEVEL = 2
XOR_MAX_LEVEL = 9

# The four "off" spellings every boolean LZ_* switch honors, as in the JAX
# package: LZ_X=off means off, never "a set string, so on".
OFF_SPELLINGS = ("0", "off", "false", "no")


def env_flag(name: str, default: bool = True) -> bool:
    """The accessor for boolean ``LZ_*`` switches: unset returns
    ``default``; any set value is on unless it is one of
    :data:`OFF_SPELLINGS` (in any case). Read per call, so a switch can
    be flipped while the process runs."""
    import os

    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.lower() not in OFF_SPELLINGS


def shadow_reads_enabled() -> bool:
    """LZ_SHADOW_READS (default on): the chunkserver keeps passive mirror
    links to the non-active masters (shadow read replicas)."""
    return env_flag("LZ_SHADOW_READS")


def qos_enabled() -> bool:
    """LZ_QOS (default on): the chunkserver's weighted data-plane queue
    admits reads, writes and rebuilds per tenant. An unconfigured queue
    admits everything either way."""
    return env_flag("LZ_QOS")


def heat_enabled() -> bool:
    """LZ_HEAT (default on): the chunkserver folds per-chunk heat into
    its heartbeats; off sends an empty fold."""
    return env_flag("LZ_HEAT")


def ha_enabled() -> bool:
    """LZ_HA (default on): quorum election among masters and automatic
    fenced promotion. The port's master runs no election yet (its entry
    point refuses an HA configuration); the master reads the switch for
    the epoch fields of its links, which stay 0 without an election."""
    return env_flag("LZ_HA")


def s3_lifecycle_enabled() -> bool:
    """LZ_S3_LIFECYCLE (default on): the master's lifecycle tiering
    scanner demotes cold objects of directories that carry rules."""
    return env_flag("LZ_S3_LIFECYCLE")


# Per-inode extra-attribute flags (reference: MFSCommunication.h EATTR_*
# subset): NOOWNER makes every uid act as the owner for permission
# checks; NOCACHE forbids client-side caching of the inode's blocks;
# NOENTRYCACHE forbids caching its lookup/attr entries; LIFECYCLE marks a
# directory that carries S3 lifecycle rules (S3_LIFECYCLE_XATTR).
EATTR_NOOWNER = 0x01
EATTR_NOCACHE = 0x02
EATTR_NOENTRYCACHE = 0x04
EATTR_LIFECYCLE = 0x08

EATTR_NAMES = {
    "noowner": EATTR_NOOWNER,
    "nocache": EATTR_NOCACHE,
    "noentrycache": EATTR_NOENTRYCACHE,
    "lifecycle": EATTR_LIFECYCLE,
}

# Directory xattr holding the lifecycle rule parameters as JSON
# ({"demote_after_s": seconds}).
S3_LIFECYCLE_XATTR = "lizardfs.s3.lifecycle"
