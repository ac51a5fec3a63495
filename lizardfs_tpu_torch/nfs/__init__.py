"""NFSv3 gateway: serve the cluster to standard NFS clients.

The reference ships an NFS-Ganesha FSAL (src/nfs-ganesha/, ~4.2k LoC C)
that adapts its C client library to Ganesha's FSAL API. This package is
the TPU-framework analog with the gateway built in: a self-contained
ONC-RPC + MOUNT3 + NFS3 server (RFC 1813) running on asyncio, backed by
:class:`lizardfs_tpu_torch.client.client.Client`, so any OS NFS client can
reach the cluster without FUSE or Python on the consumer side.
"""

from lizardfs_tpu_torch.nfs.server import NfsGateway

__all__ = ["NfsGateway"]
