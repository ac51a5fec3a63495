"""Failover controller: binds an ElectionNode to a MasterServer.

The uRaftController analog (reference: src/uraft/uraftcontroller.cc:78-98
runs promote/demote helper scripts): on winning an election, a shadow
master is promoted in-process; on losing leadership while active, the
daemon logs and keeps serving reads only (full demotion = restart, same
operational rule as the reference).

``promote_exec`` / ``demote_exec`` are the floating-IP glue of the
reference's lizardfs-uraft-helper (lizardfs-uraft-helper.in:81-101
``ip addr add/del`` + arping): shell commands run on every leadership
transition with LIZ_NODE_ID/LIZ_ROLE in the environment, so operators
move a service IP, update DNS, or poke a load balancer without patching
the daemon.
"""

from __future__ import annotations

import asyncio
import logging
import os

from lizardfs_tpu_torch.ha.election import ElectionNode


class FailoverController:
    def __init__(
        self,
        master,  # MasterServer
        node_id: str,
        listen: tuple[str, int],
        peers: dict[str, tuple[str, int]],
        promote_exec: str | None = None,
        demote_exec: str | None = None,
        service_addrs: dict[str, tuple[str, int]] | None = None,
        **election_kwargs,
    ):
        self.master = master
        self.node_id = node_id
        self.promote_exec = promote_exec
        self.demote_exec = demote_exec
        # node id -> master SERVICE address (not the election port):
        # lets every follower re-point its changelog stream at whoever
        # currently leads, instead of a boot-time ACTIVE_MASTER
        self.service_addrs = service_addrs or {}
        # serialize hooks: during flapping, a stale demote finishing
        # after a fresh promote would strip the new leader's service IP
        self._hook_lock = asyncio.Lock()
        self.promotions = 0
        self.demotions = 0
        # monotonic stamp of the last self-promotion this controller
        # performed (RTO attribution: detect->elect->promote)
        self.last_promotion_at: float | None = None
        self.log = logging.getLogger(f"failover[{node_id}]")
        self.node = ElectionNode(
            node_id,
            listen,
            peers,
            get_version=lambda: master.changelog.version,
            on_leader=self._on_leader,
            on_follower=self._on_follower,
            **election_kwargs,
        )

    async def _run_hook(self, cmd: str | None, role: str) -> None:
        if not cmd:
            return
        env = dict(os.environ, LIZ_NODE_ID=self.node_id, LIZ_ROLE=role)
        async with self._hook_lock:
            proc = None
            try:
                proc = await asyncio.create_subprocess_shell(cmd, env=env)
                rc = await asyncio.wait_for(proc.wait(), timeout=30.0)
                if rc != 0:
                    self.log.warning("%s hook exited %d: %s", role, rc, cmd)
            except asyncio.TimeoutError:
                # a hung hook must not linger: it could mutate network
                # state (e.g. re-add a floating IP) minutes later
                self.log.warning("%s hook timed out; killing: %s", role, cmd)
                proc.kill()
                # lint: waive(unbounded-await): reaping a SIGKILLed child — the kernel completes this; a timer could leak the zombie
                await proc.wait()
            except OSError as e:
                self.log.warning("%s hook failed: %s", role, e)

    async def start(self) -> None:
        await self.node.start()

    async def stop(self) -> None:
        await self.node.stop()

    def status(self) -> dict:
        doc = self.node.status()
        doc.update({
            "personality": self.master.personality,
            "epoch": self.master.meta.epoch,
            "promotions": self.promotions,
            "demotions": self.demotions,
        })
        return doc

    async def _on_leader(self) -> None:
        if self.master.personality != "master":
            self.log.info("election won — promoting shadow")
            self.master.promote()
            self.promotions += 1
            self.last_promotion_at = asyncio.get_running_loop().time()
            mx = getattr(self.master, "metrics", None)
            if mx is not None:
                mx.counter("ha_promotions").inc()
            await self._run_hook(self.promote_exec, "master")

    async def _on_follower(self, leader_id: str) -> None:
        was_active = self.master.personality == "master"
        if was_active:
            # split-brain guard: an active master that lost leadership
            # stops accepting work
            self.log.warning(
                "lost leadership to %s — demoting to shadow", leader_id
            )
        addr = self.service_addrs.get(leader_id)
        if addr is not None:
            # follow the CURRENT leader's changelog — every replica
            # must converge on it or the next promotion loses writes
            self.master.follow(addr)
        elif was_active:
            # no service map configured: read-only until restarted
            self.master.personality = "shadow"
        if was_active:
            self.demotions += 1
            mx = getattr(self.master, "metrics", None)
            if mx is not None:
                mx.counter("ha_demotions").inc()
            await self._run_hook(self.demote_exec, "shadow")
