"""Run the port's chunkserver: python -m lizardfs_tpu_torch.chunkserver [config]

Config keys (mfschunkserver.cfg analog): DATA_PATH (comma-separated
folders allowed), HDD_CFG (file listing one data folder per line,
mfshdd.cfg analog; overrides DATA_PATH), LISTEN_HOST, LISTEN_PORT,
MASTER_HOST, MASTER_PORT, MASTER_ADDRS (host:port,host:port,... —
every master incl. shadows, for floating-IP-less failover: the
registration loop cycles until the ACTIVE master accepts; overrides
MASTER_HOST/PORT), LABEL, ENCODER (cuda|sharded|auto|cpu; unset is
the card's, ``get_encoder()``, which refuses to start without one),
HEARTBEAT_INTERVAL (seconds; also the master-reconnect cadence),
NATIVE_DATA_PLANE (default true; false serves data ops from the
asyncio path — the fault-injection choke points live there, and a
server that starts with LZ_FAULTS rules armed stands the native plane
down on its own), ADMIN_PASSWORD (challenge-response auth for
privileged admin commands), LOG_LEVEL.

Fault injection: LZ_FAULTS="seed=N; role:site[:op[:peer]] action,..."
arms seeded fault rules at startup (runtime/faults.py; also steerable
live via `lizardfs-admin faults`); the debug_read_delay_ms tweak is an
alias arming the serve_read delay rule.
"""

import asyncio
import sys

from lizardfs_tpu_torch.chunkserver.server import ChunkServer
from lizardfs_tpu_torch.runtime.config import Config
from lizardfs_tpu_torch.runtime.daemon import setup_logging


def _folders(cfg: Config) -> list[str]:
    hdd_cfg = cfg.get_str("HDD_CFG", "")
    if hdd_cfg:
        out = []
        with open(hdd_cfg) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    out.append(line)
        if out:
            return out
    return [
        p.strip()
        for p in cfg.get_str("DATA_PATH", "./cs-data").split(",")
        if p.strip()
    ]


def main() -> None:
    cfg = Config(sys.argv[1] if len(sys.argv) > 1 else None)
    setup_logging("chunkserver", cfg.get_str("LOG_LEVEL", "INFO"))
    addrs_raw = cfg.get_str("MASTER_ADDRS", "")
    if addrs_raw:
        master_addr = []
        for item in addrs_raw.split(","):
            item = item.strip()
            if not item:
                continue  # tolerate trailing/double commas
            host, sep, port = item.rpartition(":")
            if not sep or not host or not port.isdigit():
                raise SystemExit(
                    f"MASTER_ADDRS: bad entry {item!r} "
                    "(expected host:port[,host:port...])"
                )
            master_addr.append((host, int(port)))
        if not master_addr:
            raise SystemExit("MASTER_ADDRS: no addresses given")
    else:
        master_addr = (
            cfg.get_str("MASTER_HOST", "127.0.0.1"),
            cfg.get_int("MASTER_PORT", 9420),
        )
    server = ChunkServer(
        data_folder=_folders(cfg),
        master_addr=master_addr,
        host=cfg.get_str("LISTEN_HOST", "127.0.0.1"),
        port=cfg.get_int("LISTEN_PORT", 0),
        label=cfg.get_str("LABEL", "_"),
        encoder_name=cfg.get_str("ENCODER", "") or None,
        heartbeat_interval=cfg.get_float("HEARTBEAT_INTERVAL", 5.0, min_value=0.05),
        # off routes data ops through the asyncio server, where the
        # fault-injection choke points (disk_pread/serve_read/...) live
        native_data_plane=cfg.get_bool("NATIVE_DATA_PLANE", True),
        admin_password=cfg.get_str("ADMIN_PASSWORD", "") or None,
    )
    asyncio.run(server.run_forever())


if __name__ == "__main__":
    main()
