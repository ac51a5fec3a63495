"""Run the S3 gateway: python -m lizardfs_tpu_torch.s3 MASTER_HOST:PORT
[--host H] [--port N] [--root /path]
"""

import asyncio

from lizardfs_tpu_torch.runtime import faults as faultsmod
from lizardfs_tpu_torch.runtime.daemon import setup_logging
from lizardfs_tpu_torch.s3.server import main


def run() -> None:
    setup_logging("s3")
    faultsmod.set_role("s3")
    asyncio.run(main())


if __name__ == "__main__":
    run()
