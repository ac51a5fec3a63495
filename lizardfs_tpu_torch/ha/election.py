"""Raft-style leader election (election only, no log replication).

The reference's uraft runs Raft *elections* among master nodes and lets
the metadata version serve as the log (reference: src/uraft/uraft.h:18-27
"data version" == metadata version; quorum check uraft.h:27). Same model
here: each master/shadow runs an ElectionNode over UDP; candidates carry
their metadata version and voters refuse candidates whose version is
behind their own, so only the most-up-to-date shadow can win — then the
controller promotes it (the lizardfs-uraft-helper promote analog,
uraftcontroller.cc:78-98).

States: follower -> candidate -> leader, randomized election timeouts,
terms, majority quorum. Messages are single-datagram JSON (election
traffic is tiny and loss-tolerant by design).
"""

from __future__ import annotations

import asyncio
import json
import logging
import random

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# A vote-only arbiter's archived version is only a PROXY for data
# freshness: its archive can momentarily lead the surviving shadow's
# replay (each followed the dead active over its own socket), and with
# the active gone the shadow can never catch up past it — a strict
# up-to-date rule would then deadlock the election forever. After this
# many max election timeouts without ANY leader, an arbiter stops
# refusing behind candidates (availability over the proxy). Real
# masters (can_lead=True) never relax: their version IS the data, and
# relaxing it could elect a stale master and lose acknowledged writes.
ARBITER_RELAX_TIMEOUTS = 10.0


class _Proto(asyncio.DatagramProtocol):
    def __init__(self, node: "ElectionNode"):
        self.node = node

    def datagram_received(self, data, addr):
        try:
            msg = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError):
            return
        self.node._on_message(msg)


class ElectionNode:
    def __init__(
        self,
        node_id: str,
        listen: tuple[str, int],
        peers: dict[str, tuple[str, int]],
        *,
        get_version,  # () -> int: this node's metadata version
        on_leader,  # async () -> None
        on_follower=None,  # async (leader_id) -> None
        election_timeout: tuple[float, float] = (0.15, 0.30),
        heartbeat_interval: float = 0.05,
        can_lead: bool = True,
    ):
        self.node_id = node_id
        self.listen = listen
        self.peers = dict(peers)  # id -> (host, port), excluding self
        self.get_version = get_version
        self.on_leader = on_leader
        self.on_follower = on_follower
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        # metaloggers vote but never lead (uraft arbiter analog): a
        # vote-only node never starts an election, so it contributes to
        # quorum without ever being promoted to serve metadata
        self.can_lead = can_lead
        self.elections_started = 0
        self.votes_granted = 0
        self.depositions = 0
        self.stale_votes_granted = 0
        # last time a leader heartbeat arrived: drives the arbiter's
        # leaderless-deadlock relaxation (never reset by vote grants)
        self._leader_seen_at = 0.0

        self.state = FOLLOWER
        self.term = 0
        self.voted_for: str | None = None
        self.leader_id: str | None = None
        self._votes: set[str] = set()
        self._last_heartbeat = 0.0
        self._transport = None
        self._tasks: list[asyncio.Task] = []
        self._rng = random.Random(hash(node_id) & 0xFFFF)
        self.log = logging.getLogger(f"election[{node_id}]")

    @property
    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Proto(self), local_addr=self.listen
        )
        self.listen = self._transport.get_extra_info("sockname")[:2]
        self._last_heartbeat = loop.time()
        self._leader_seen_at = loop.time()
        self._tasks.append(loop.create_task(self._ticker()))

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._transport is not None:
            self._transport.close()

    # --- wire -------------------------------------------------------------

    def _send(self, peer_id: str, msg: dict) -> None:
        addr = self.peers.get(peer_id)
        if addr is not None and self._transport is not None:
            self._transport.sendto(json.dumps(msg).encode(), addr)

    def _broadcast(self, msg: dict) -> None:
        for pid in self.peers:
            self._send(pid, msg)

    # --- state machine ----------------------------------------------------

    async def _ticker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self.state == LEADER:
                self._broadcast({
                    "type": "heartbeat", "term": self.term,
                    "leader": self.node_id,
                })
                await asyncio.sleep(self.heartbeat_interval)
                continue
            timeout = self._rng.uniform(*self.election_timeout)
            await asyncio.sleep(0.02)
            if (
                self.can_lead
                and loop.time() - self._last_heartbeat > timeout
            ):
                self._start_election()

    def status(self) -> dict:
        """Snapshot for the admin `ha` command / health section."""
        return {
            "node_id": self.node_id,
            "state": self.state,
            "term": self.term,
            "leader": self.leader_id,
            "can_lead": self.can_lead,
            "peers": sorted(self.peers),
            "quorum": self.quorum,
            "elections_started": self.elections_started,
            "votes_granted": self.votes_granted,
            "stale_votes_granted": self.stale_votes_granted,
            "depositions": self.depositions,
        }

    def _start_election(self) -> None:
        self.term += 1
        self.state = CANDIDATE
        self.elections_started += 1
        self.voted_for = self.node_id
        self._votes = {self.node_id}
        self.log.debug("starting election for term %d", self.term)
        self._broadcast({
            "type": "vote_req", "term": self.term,
            "candidate": self.node_id, "version": int(self.get_version()),
        })
        self._last_heartbeat = asyncio.get_running_loop().time()
        self._check_quorum()

    def _check_quorum(self) -> None:
        if self.state == CANDIDATE and len(self._votes) >= self.quorum:
            self.state = LEADER
            self.leader_id = self.node_id
            self.log.info("won election for term %d", self.term)
            self._broadcast({
                "type": "heartbeat", "term": self.term, "leader": self.node_id,
            })
            asyncio.get_running_loop().create_task(self.on_leader())

    def _on_message(self, msg: dict) -> None:
        mtype = msg.get("type")
        term = int(msg.get("term", 0))
        if term > self.term:
            self.term = term
            self.voted_for = None
            if self.state == LEADER:
                self.log.warning("deposed by higher term %d", term)
                self.depositions += 1
            self.state = FOLLOWER
        if mtype == "vote_req":
            self._on_vote_req(msg, term)
        elif mtype == "vote":
            if (
                term == self.term
                and self.state == CANDIDATE
                and msg.get("granted")
            ):
                self._votes.add(msg.get("voter", ""))
                self._check_quorum()
        elif mtype == "heartbeat":
            if term >= self.term:
                was_leader = self.state == LEADER and msg.get("leader") != self.node_id
                self.state = FOLLOWER if msg.get("leader") != self.node_id else self.state
                new_leader = msg.get("leader")
                leader_changed = new_leader != self.leader_id
                self.leader_id = new_leader
                now = asyncio.get_running_loop().time()
                self._last_heartbeat = now
                self._leader_seen_at = now
                if (leader_changed or was_leader) and self.on_follower is not None \
                        and new_leader != self.node_id:
                    asyncio.get_running_loop().create_task(
                        self.on_follower(new_leader)
                    )

    def _on_vote_req(self, msg: dict, term: int) -> None:
        candidate = msg.get("candidate", "")
        cand_version = int(msg.get("version", 0))
        # uraft rule: never elect a master whose metadata is behind ours
        up_to_date = cand_version >= int(self.get_version())
        if not up_to_date and not self.can_lead:
            leaderless_s = (
                asyncio.get_running_loop().time() - self._leader_seen_at
            )
            if leaderless_s > ARBITER_RELAX_TIMEOUTS * self.election_timeout[1]:
                self.stale_votes_granted += 1
                self.log.warning(
                    "arbiter granting vote to behind candidate %s "
                    "(v%d < our v%d) after %.1fs without a leader",
                    candidate, cand_version, int(self.get_version()),
                    leaderless_s,
                )
                up_to_date = True
        granted = (
            term == self.term
            and self.voted_for in (None, candidate)
            and up_to_date
        )
        if granted:
            self.voted_for = candidate
            self.votes_granted += 1
            self._last_heartbeat = asyncio.get_running_loop().time()
        self._send(candidate, {
            "type": "vote", "term": self.term, "granted": granted,
            "voter": self.node_id,
        })
