"""Run the master daemon: python -m lizardfs_tpu_torch.master [config]

Config keys (KEY = VALUE, mfsmaster.cfg analog): DATA_PATH, LISTEN_HOST,
LISTEN_PORT, GOALS_CFG (path to mfsgoals.cfg-style file), IO_LIMIT_BPS
(global bytes/s budget), IO_LIMITS_CFG (mfsiolimits.cfg-style per-cgroup
budgets: `subsystem X` + `limit <group> <bps>` lines), QOS_CFG
(multi-tenant fair-share config: tenant match rules/weights, per-class
admission rates, data-plane budgets — doc/operations.md QoS runbook),
LOG_LEVEL,
HEALTH_INTERVAL, IMAGE_INTERVAL, LIFECYCLE_INTERVAL (s3 lifecycle
tiering scan period), PERSONALITY (master|shadow),
ACTIVE_MASTER (host:port, required for shadow).

The port has no quorum election yet: a configuration that names one
(any of HA_KEYS) is refused at start, and failover stays manual
(``promote-shadow`` over the admin port).
"""

import asyncio
import sys

from lizardfs_tpu_torch.master.server import MasterServer
from lizardfs_tpu_torch.runtime.config import Config
from lizardfs_tpu_torch.runtime.daemon import setup_logging


# The keys of the JAX package's election configuration.
HA_KEYS = ("ELECTION_ID", "ELECTION_LISTEN", "ELECTION_PEERS", "MASTER_PEERS",
           "PROMOTE_EXEC", "DEMOTE_EXEC")


def _hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host, int(port)


async def _run(cfg: Config) -> None:
    named = [key for key in HA_KEYS if cfg.get_str(key, "")]
    if named:
        raise SystemExit(
            f"{', '.join(named)}: the port's master runs no quorum election; "
            "leave the election keys out (failover is manual, promote-shadow)"
        )
    personality = cfg.get_str("PERSONALITY", "master")
    active = cfg.get_str("ACTIVE_MASTER", "")
    config_paths = {
        key: path for key, path in (
            ("goals", cfg.get_str("GOALS_CFG", "")),
            ("exports", cfg.get_str("EXPORTS_CFG", "")),
            ("topology", cfg.get_str("TOPOLOGY_CFG", "")),
            ("iolimits", cfg.get_str("IO_LIMITS_CFG", "")),
            ("qos", cfg.get_str("QOS_CFG", "")),
        ) if path
    }
    server = MasterServer(
        data_dir=cfg.get_str("DATA_PATH", "./master-data"),
        host=cfg.get_str("LISTEN_HOST", "127.0.0.1"),
        port=cfg.get_int("LISTEN_PORT", 9420),
        health_interval=cfg.get_float("HEALTH_INTERVAL", 1.0, min_value=0.05),
        image_interval=cfg.get_float("IMAGE_INTERVAL", 300.0, min_value=1.0),
        personality=personality,
        active_addr=_hostport(active) if active else None,
        io_limit_bps=cfg.get_int("IO_LIMIT_BPS", 0),
        admin_password=cfg.get_str("ADMIN_PASSWORD", "") or None,
        lock_grace_seconds=cfg.get_float("LOCK_GRACE", 30.0, min_value=0.0),
        config_paths=config_paths,
        lifecycle_interval=cfg.get_float(
            "LIFECYCLE_INTERVAL", 30.0, min_value=0.1
        ),
    )
    # initial load runs the SAME code as SIGHUP reload, strictly: boot
    # fails loudly on a bad file instead of serving half a config
    server.reload(strict=True)
    await server.run_forever()


def main() -> None:
    cfg = Config(sys.argv[1] if len(sys.argv) > 1 else None)
    setup_logging("master", cfg.get_str("LOG_LEVEL", "INFO"))
    asyncio.run(_run(cfg))


if __name__ == "__main__":
    main()
