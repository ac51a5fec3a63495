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
ACTIVE_MASTER (host:port, required for shadow), and optional election:
ELECTION_ID, ELECTION_LISTEN (host:port), ELECTION_PEERS
(id=host:port,id=host:port,...), PROMOTE_EXEC / DEMOTE_EXEC (shell
commands run on leadership transitions with LIZ_NODE_ID/LIZ_ROLE set —
the floating-IP helper glue).
"""

import asyncio
import sys

from lizardfs_tpu_torch import constants
from lizardfs_tpu_torch.master.server import MasterServer
from lizardfs_tpu_torch.runtime.config import Config
from lizardfs_tpu_torch.runtime.daemon import setup_logging


def _hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host, int(port)


async def _run(cfg: Config) -> None:
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
    controller = None
    # LZ_HA kill switch: off = no election socket, no vote traffic, no
    # automatic promotion — the daemon behaves exactly like the manual-
    # promotion tree even with ELECTION_* configured (promote-shadow
    # over the admin port still works)
    if cfg.get_str("ELECTION_ID", "") and constants.ha_enabled():
        from lizardfs_tpu_torch.ha.controller import FailoverController

        peers = {}
        for item in cfg.get_str("ELECTION_PEERS", "").split(","):
            if item.strip():
                pid, _, addr = item.strip().partition("=")
                peers[pid] = _hostport(addr)
        # MASTER_PEERS (id=host:port,...): each node's master SERVICE
        # address, so followers can re-point their changelog stream at
        # whichever node currently leads (no floating IP required)
        service_addrs = {}
        for item in cfg.get_str("MASTER_PEERS", "").split(","):
            if item.strip():
                pid, _, addr = item.strip().partition("=")
                service_addrs[pid] = _hostport(addr)
        controller = FailoverController(
            server,
            cfg.get_str("ELECTION_ID"),
            _hostport(cfg.get_str("ELECTION_LISTEN", "127.0.0.1:0")),
            peers,
            promote_exec=cfg.get_str("PROMOTE_EXEC", "") or None,
            demote_exec=cfg.get_str("DEMOTE_EXEC", "") or None,
            service_addrs=service_addrs,
            # RTO tuning knobs (doc/operations.md failover runbook):
            # detect time is bounded by the randomized election timeout,
            # steady-state traffic by the heartbeat interval
            election_timeout=(
                cfg.get_float("ELECTION_TIMEOUT_MIN", 0.15, min_value=0.01),
                cfg.get_float("ELECTION_TIMEOUT_MAX", 0.30, min_value=0.02),
            ),
            heartbeat_interval=cfg.get_float(
                "HEARTBEAT_INTERVAL", 0.05, min_value=0.005
            ),
        )
        server.ha_controller = controller
    if controller is not None:
        await controller.start()
    try:
        await server.run_forever()
    finally:
        if controller is not None:
            await controller.stop()


def main() -> None:
    cfg = Config(sys.argv[1] if len(sys.argv) > 1 else None)
    setup_logging("master", cfg.get_str("LOG_LEVEL", "INFO"))
    asyncio.run(_run(cfg))


if __name__ == "__main__":
    main()
