"""Run a metalogger: python -m lizardfs_tpu_torch.metalogger [config]

Config keys: DATA_PATH, MASTER_ADDRS (host:port,host:port,...),
IMAGE_INTERVAL, LOG_LEVEL, and optional quorum membership (the uraft
arbiter analog — the metalogger VOTES in leader elections but can never
lead, so a 2-master + 1-metalogger deployment has a 3-node quorum):
ELECTION_ID, ELECTION_LISTEN (host:port), ELECTION_PEERS
(id=host:port,...), MASTER_PEERS (id=host:port,... — each master
node's SERVICE address, so the archive re-points at whoever leads).
All election wiring is gated on the LZ_HA kill switch.
"""

import asyncio
import logging
import signal
import sys

from lizardfs_tpu_torch import constants
from lizardfs_tpu_torch.metalogger.server import Metalogger
from lizardfs_tpu_torch.runtime.config import Config
from lizardfs_tpu_torch.runtime.daemon import setup_logging


def _hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host, int(port)


async def _run(cfg: Config) -> None:
    addrs = []
    for item in cfg.get_str("MASTER_ADDRS", "127.0.0.1:9420").split(","):
        host, _, port = item.strip().rpartition(":")
        addrs.append((host, int(port)))
    ml = Metalogger(
        cfg.get_str("DATA_PATH", "./metalogger-data"),
        addrs,
        image_interval=cfg.get_float("IMAGE_INTERVAL", 3600.0, min_value=1.0),
    )
    node = None
    if cfg.get_str("ELECTION_ID", "") and constants.ha_enabled():
        from lizardfs_tpu_torch.ha.election import ElectionNode

        peers = {}
        for item in cfg.get_str("ELECTION_PEERS", "").split(","):
            if item.strip():
                pid, _, addr = item.strip().partition("=")
                peers[pid] = _hostport(addr)
        service_addrs = {}
        for item in cfg.get_str("MASTER_PEERS", "").split(","):
            if item.strip():
                pid, _, addr = item.strip().partition("=")
                service_addrs[pid] = _hostport(addr)
        log = logging.getLogger("metalogger")

        async def on_leader() -> None:
            # unreachable with can_lead=False; a vote-only node never
            # starts an election, so it can never win one
            log.error("vote-only metalogger won an election (bug)")

        async def on_follower(leader_id: str) -> None:
            addr = service_addrs.get(leader_id)
            if addr is not None:
                ml.prefer(addr)

        node = ElectionNode(
            cfg.get_str("ELECTION_ID"),
            _hostport(cfg.get_str("ELECTION_LISTEN", "127.0.0.1:0")),
            peers,
            # the vote carries our archived changelog position: the
            # election's up-to-date rule compares candidates against it
            get_version=lambda: ml.version,
            on_leader=on_leader,
            on_follower=on_follower,
            can_lead=False,
            election_timeout=(
                cfg.get_float("ELECTION_TIMEOUT_MIN", 0.15, min_value=0.01),
                cfg.get_float("ELECTION_TIMEOUT_MAX", 0.30, min_value=0.02),
            ),
            heartbeat_interval=cfg.get_float(
                "HEARTBEAT_INTERVAL", 0.05, min_value=0.005
            ),
        )
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await ml.start()
    if node is not None:
        await node.start()
    # lint: waive(unbounded-await): the daemon parks here until SIGTERM/SIGINT by design
    await stop.wait()
    if node is not None:
        await node.stop()
    await ml.stop()


def main() -> None:
    cfg = Config(sys.argv[1] if len(sys.argv) > 1 else None)
    setup_logging("metalogger", cfg.get_str("LOG_LEVEL", "INFO"))
    asyncio.run(_run(cfg))


if __name__ == "__main__":
    main()
