"""Run a tape server: python -m lizardfs_tpu_torch.tapeserver [config]

Config keys: DATA_PATH (archive directory), MASTER_HOST, MASTER_PORT,
LABEL, LOG_LEVEL.
"""

import asyncio
import sys

from lizardfs_tpu_torch.runtime.config import Config
from lizardfs_tpu_torch.runtime.daemon import setup_logging
from lizardfs_tpu_torch.tapeserver.server import TapeServer


def main() -> None:
    cfg = Config(sys.argv[1] if len(sys.argv) > 1 else None)
    setup_logging("tapeserver", cfg.get_str("LOG_LEVEL", "INFO"))
    server = TapeServer(
        archive_dir=cfg.get_str("DATA_PATH", "./tape-archive"),
        master_addr=(
            cfg.get_str("MASTER_HOST", "127.0.0.1"),
            cfg.get_int("MASTER_PORT", 9420),
        ),
        label=cfg.get_str("LABEL", "_"),
    )

    asyncio.run(server.run_forever())


if __name__ == "__main__":
    main()
