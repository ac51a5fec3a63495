"""S3-compatible object gateway over the POSIX namespace.

Third protocol front door after FUSE and NFS (ROADMAP item 3): an
asyncio HTTP server speaking an S3 REST subset, backed by the same
internal :class:`~lizardfs_tpu_torch.client.client.Client` and master
namespace as the other gateways. Buckets are directories under an
export root, objects are files, multipart uploads assemble through the
master's O(1) ``appendchunks`` chunk-share concat, and per-bucket
lifecycle rules demote cold objects to the ``tapeserver/`` tier with
recall on GET.
"""
