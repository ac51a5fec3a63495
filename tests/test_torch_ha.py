"""The port's metadata redundancy against the JAX package's, on the CPU.

* Source: ``ha/`` (the election and the failover controller),
  ``metalogger/`` (the archive and its entry point) and
  ``runtime/detsched.py`` are verbatim copies (the package name changed
  in imports); the master's entry point is pinned with the other master
  modules (``tests/test_torch_master.py``).
* Port clusters: the cases of ``tests/test_ha.py`` on a port master, a
  port shadow, port chunkservers on ``CudaChunkEncoder(device="cpu")``
  and port clients on the same encoder: the shadow follows and is
  promoted, catches up from an image, fails over with its chunkservers,
  keeps locks and held files, heals a divergence, serves replica reads
  across its promotion; the metalogger archives; elections of three
  nodes, with exec hooks and a witness, with the arbiter's relaxation
  and under the port's deterministic loop; ``LZ_HA`` off in each
  spelling; a zombie ex-primary fenced by the epoch; and a three-node
  quorum (two masters and a metalogger) failing over an ec(8,4) cluster
  of thirteen servers, the file read degraded through the new master
  and its metadata restored from the metalogger's archive.
* Mixed quorums: a JAX ``ElectionNode`` beside port nodes elects one
  leader; a port metalogger follows a JAX master and a JAX metalogger a
  port master, and each archive restores to the other package's
  ``meta.checksum()``.

Every case is in process on ephemeral localhost ports, polls with a
bound, and closes both packages' connection pools after its loop.
"""

import asyncio
import json
import os
import socket
import time

import pytest

from lizardfs_tpu.client.client import Client as RefClient
from lizardfs_tpu.core.encoder import CpuChunkEncoder as RefCpuChunkEncoder
from lizardfs_tpu.ha.election import ElectionNode as RefElectionNode
from lizardfs_tpu.master.server import MasterServer as RefMasterServer
from lizardfs_tpu.metalogger.server import Metalogger as RefMetalogger
from lizardfs_tpu.tools import metarestore as ref_metarestore
from lizardfs_tpu_torch.chunkserver.server import ChunkServer
from lizardfs_tpu_torch.client.client import Client
from lizardfs_tpu_torch.constants import OFF_SPELLINGS
from lizardfs_tpu_torch.ha.controller import FailoverController
from lizardfs_tpu_torch.ha.election import LEADER, ElectionNode
from lizardfs_tpu_torch.master.changelog import Changelog, load_image
from lizardfs_tpu_torch.master.metadata import MetadataStore
from lizardfs_tpu_torch.master.server import MasterServer
from lizardfs_tpu_torch.metalogger.server import Metalogger
from lizardfs_tpu_torch.proto import framing, messages as m
from lizardfs_tpu_torch.runtime import detsched
from lizardfs_tpu_torch.tools import metarestore
from tests.test_torch_client import (  # noqa: F401 (autouse fixtures)
    ENCODER, GOALS, asyncio_jax_client, make_goals, payload, run, two_threads, wait_for)
from tests.test_torch_master import assert_copy, mod

COPIES = ["ha/__init__.py", "ha/election.py", "ha/controller.py", "metalogger/__init__.py",
          "metalogger/server.py", "metalogger/__main__.py", "runtime/detsched.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


# --- helpers ---------------------------------------------------------------------


async def admin(port, command):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    await framing.send_message(w, m.AdminCommand(req_id=1, command=command, json="{}"))
    reply = await framing.read_message(r)
    w.close()
    return reply


def free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def active_master(root, name="m1", **kw):
    return MasterServer(str(root / name), goals=make_goals("port"), **kw)


def shadow_of(root, active, name="m2", **kw):
    return MasterServer(str(root / name), goals=make_goals("port"), personality="shadow",
                        active_addr=("127.0.0.1", active.port), **kw)


def chunkserver(root, name, addrs, **kw):
    return ChunkServer(str(root / name), master_addr=addrs, encoder=ENCODER,
                       native_data_plane=False, **kw)


def client(*addrs, **kw):
    if len(addrs) == 1:
        return Client("127.0.0.1", addrs[0][1], encoder=ENCODER, **kw)
    return Client("", 0, master_addrs=list(addrs), encoder=ENCODER, **kw)


async def caught_up(shadow, active, timeout=5.0):
    await wait_for(lambda: shadow.changelog.version == active.changelog.version,
                   "the follower to apply the changelog's tail", timeout)


def archived(folder) -> MetadataStore:
    """The metadata a metalogger's folder holds: its image and the
    archived changelog lines after it."""
    version, doc = load_image(str(folder))
    store = MetadataStore()
    store.load_sections(doc)
    with open(os.path.join(str(folder), "changelog_ml.0.log")) as fh:
        for line in fh:
            v, op = Changelog.parse_line(line)
            if v > version:
                store.apply(op)
    return store


# --- the shadow -------------------------------------------------------------------


def test_shadow_follows_and_promotes(tmp_path):
    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        try:
            c = client(("127.0.0.1", active.port))
            await c.connect()
            d = await c.mkdir(1, "dir")
            await c.create(d.inode, "f")
            await c.close()
            await caught_up(shadow, active)
            assert shadow.meta.checksum() == active.meta.checksum()
            # the shadow refuses clients until it is promoted
            with pytest.raises(ConnectionError):
                await client(("127.0.0.1", shadow.port)).connect()
            assert (await admin(shadow.port, "promote-shadow")).status == 0
            c3 = client(("127.0.0.1", shadow.port))
            await c3.connect()
            assert (await c3.lookup(1, "dir")).inode == d.inode
            await c3.close()
        finally:
            await shadow.stop()
            await active.stop()

    run(go())


def test_shadow_catches_up_from_image(tmp_path):
    """A shadow started behind downloads the image first."""
    async def go():
        active = active_master(tmp_path)
        await active.start()
        try:
            c = client(("127.0.0.1", active.port))
            await c.connect()
            for i in range(5):
                await c.mkdir(1, f"d{i}")
            await c.close()
            shadow = shadow_of(tmp_path, active)
            await shadow.start()
            try:
                await caught_up(shadow, active)
                assert shadow.meta.checksum() == active.meta.checksum()
            finally:
                await shadow.stop()
        finally:
            await active.stop()

    run(go())


def test_full_failover_with_chunkservers(tmp_path):
    """The active master stops; the shadow is promoted; chunkservers and
    the client fail over through their address lists; an ec(3,2) file
    reads back."""
    data = payload(3, 4 * 65536 + 99)

    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        addrs = [("127.0.0.1", active.port), ("127.0.0.1", shadow.port)]
        servers = [chunkserver(tmp_path, f"cs{i}", addrs, heartbeat_interval=0.2,
                               wave_timeout=0.2) for i in range(5)]
        for cs in servers:
            await cs.start()
        c = client(*addrs, wave_timeout=0.2)
        await c.connect()
        try:
            f = await c.create(1, "ha.bin")
            await c.setgoal(f.inode, GOALS["ec32"])
            await c.write_file(f.inode, data)
            await caught_up(shadow, active)
            await active.stop()
            shadow.promote()
            await wait_for(lambda: len(shadow.cs_links) == 5,
                           "the chunkservers to register with the new master", 10.0)
            assert await c.read_file(f.inode) == data
        finally:
            await c.close()
            for cs in servers:
                await cs.stop()
            await shadow.stop()

    run(go())


def test_metalogger_archives(tmp_path):
    async def go():
        active = active_master(tmp_path)
        await active.start()
        ml = Metalogger(str(tmp_path / "ml"), [("127.0.0.1", active.port)], image_interval=0.2)
        await ml.start()
        try:
            c = client(("127.0.0.1", active.port))
            await c.connect()
            for i in range(3):
                await c.mkdir(1, f"d{i}")
            await c.close()
            await wait_for(lambda: ml.version >= active.changelog.version
                           and (tmp_path / "ml" / "metadata.liz").exists(),
                           "the metalogger to archive the tail and an image")
            assert ml.version == active.changelog.version
            assert archived(tmp_path / "ml").checksum() == active.meta.checksum()
        finally:
            await ml.stop()
            await active.stop()

    run(go())


def test_locks_survive_shadow_promotion(tmp_path):
    """Held locks replicate through the changelog: the promoted master
    refuses conflicting locks and releases only a closing session's."""
    async def go():
        active = active_master(tmp_path, "m")
        await active.start()
        shadow = MasterServer(str(tmp_path / "s"), personality="shadow",
                              active_addr=("127.0.0.1", active.port))
        await shadow.start()
        try:
            c1 = client(("127.0.0.1", active.port))
            await c1.connect()
            f = await c1.create(1, "locked")
            assert await c1.flock(f.inode, 2, token=1)
            assert await c1.posix_lock(f.inode, 0, 100, 2, token=2)
            await caught_up(shadow, active)
            assert shadow.meta.checksum() == active.meta.checksum()
            assert shadow.meta.locks.flock_files[f.inode].ranges
            assert shadow.meta.locks.posix_files[f.inode].ranges
            await active.stop()
            assert (await admin(shadow.port, "promote-shadow")).status == 0
            c2 = client(("127.0.0.1", shadow.port))
            await c2.connect()
            n = await c2.lookup(1, "locked")
            assert c2.session_id != c1.session_id
            assert not await c2.flock(n.inode, 2, token=9)
            assert not await c2.posix_lock(n.inode, 50, 80, 2, token=9)
            assert await c2.posix_lock(n.inode, 200, 300, 2, token=9)
            assert not await c2.test_lock(n.inode, 0, 50, 2, token=9)
            await c2.close()
            await asyncio.sleep(0)
            c3 = client(("127.0.0.1", shadow.port))
            await c3.connect()
            assert not await c3.flock(n.inode, 2, token=11)
            assert await c3.posix_lock(n.inode, 200, 300, 2, token=11)
            await c3.close()
            await c1.close()
        finally:
            await shadow.stop()

    run(go())


def test_shadow_detects_divergence_and_heals(tmp_path):
    """A shadow whose state drifts from the active's notices by the
    checksum probe and downloads the image again."""
    async def go():
        active = active_master(tmp_path, "m")
        await active.start()
        shadow = MasterServer(str(tmp_path / "s"), personality="shadow",
                              active_addr=("127.0.0.1", active.port))
        shadow.shadow_verify_interval = 0.2
        await shadow.start()
        try:
            c = client(("127.0.0.1", active.port))
            await c.connect()
            await c.mkdir(1, "dir")
            await c.close()
            await caught_up(shadow, active)
            assert shadow.meta.checksum() == active.meta.checksum()
            shadow.meta.fs.node(1).mode = 0o123
            assert f"{shadow.meta.full_digest():032x}" != active.meta.checksum()
            await wait_for(lambda: shadow.meta.checksum() == active.meta.checksum(),
                           "the shadow to heal", 10.0)
        finally:
            await shadow.stop()
            await active.stop()

    run(go())


def test_promoted_shadow_keeps_sustained_files(tmp_path):
    """Open handles and sustained files replicate: the reconnected
    client's last release frees a held nameless file on the new master."""
    async def go():
        active = active_master(tmp_path, "a")
        await active.start()
        shadow = shadow_of(tmp_path, active, "s")
        await shadow.start()
        cs = chunkserver(tmp_path, "cs", ("127.0.0.1", active.port))
        await cs.start()
        c = client(("127.0.0.1", active.port), ("127.0.0.1", shadow.port))
        await c.connect()
        try:
            f = await c.create(1, "held.bin")
            await c.settrashtime(f.inode, 0)
            await c.write_file(f.inode, b"survives-failover" * 100)
            handle = await c.open(f.inode)
            await c.unlink(1, "held.bin")
            assert f.inode in active.meta.fs.sustained
            await caught_up(shadow, active)
            assert shadow.meta.fs.open_refs.get(f.inode)
            assert f.inode in shadow.meta.fs.sustained
            await active.stop()
            assert (await admin(shadow.port, "promote-shadow")).status == 0
            assert f.inode in shadow.meta.fs.sustained
            await c.getattr(f.inode)  # the client's failover reconnect
            await c.release(f.inode, handle)
            assert f.inode not in shadow.meta.fs.nodes
        finally:
            await c.close()
            await cs.stop()
            await shadow.stop()
            await active.stop()

    run(go())


def test_dead_connections_fail_fast():
    """Calls on a lost connection raise at once, on the client's RPC
    link and on the master's chunkserver link."""
    from lizardfs_tpu_torch.master.server import _CsLink
    from lizardfs_tpu_torch.runtime.rpc import RpcConnection

    async def go():
        async def handler(reader, writer):
            writer.close()

        server = await asyncio.start_server(handler, "127.0.0.1", 0)
        conn = await RpcConnection.connect("127.0.0.1", server.sockets[0].getsockname()[1])
        try:
            await wait_for(lambda: conn.closed, "the connection to see the close", 1.0)
            t0 = time.monotonic()
            with pytest.raises(ConnectionError):
                await conn.call(m.CltomaGetattr, inode=1)
            assert time.monotonic() - t0 < 1.0
        finally:
            await conn.close()
            server.close()
            await server.wait_closed()
        link = _CsLink(None, None, None)
        link.fail_all()
        t0 = time.monotonic()
        with pytest.raises(ConnectionError):
            await link.command(m.MatocsSetVersion, chunk_id=1, old_version=1, new_version=2,
                               part_id=650)
        assert time.monotonic() - t0 < 1.0

    run(go())


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_close_fails_a_call_whose_pump_never_ran(pkg):
    """A chunkserver registering with a just-promoted master can have its
    new link closed by its own mirror tick (the mirror plane announced
    the new epoch) after the register was sent and before the link's
    reply pump took its first step. The port's ``close`` fails the
    pending call at once; the JAX package's leaves it to the pump, which
    never runs, so the call waits out its timeout (30 s for a register:
    a chunkserver that long away from the new master)."""
    rpc = mod(pkg, "runtime.rpc")
    msgs = mod(pkg, "proto.messages")

    async def go():
        peers = []

        async def silent(reader, writer):  # takes the request, never replies
            peers.append(writer)

        server = await asyncio.start_server(silent, "127.0.0.1", 0)
        conn = await rpc.RpcConnection.connect("127.0.0.1", server.sockets[0].getsockname()[1])
        conn._pump_task.cancel()  # the close's cancel, before the pump's first step
        call = asyncio.ensure_future(conn.call(msgs.CltomaGetattr, inode=1, timeout=1.0))
        await asyncio.sleep(0.05)
        assert not call.done()
        t0 = time.monotonic()
        await conn.close()
        try:
            await call
            outcome = "replied"
        except ConnectionError:
            outcome = "failed"
        except asyncio.TimeoutError:
            outcome = "timed out"
        for w in peers:
            w.close()
        server.close()
        await server.wait_closed()
        return outcome, time.monotonic() - t0

    outcome, waited = run(go())
    if pkg == "port":
        assert outcome == "failed" and waited < 0.5
    else:  # the reference's fault, which stays as it is
        assert outcome == "timed out" and waited > 0.5


def test_shadow_promotion_mid_replica_serving(tmp_path):
    """The shadow is promoted while it serves replica reads under load:
    every read answers through the transition, the promoted master
    closes its mirror links, the chunkservers re-register, and it serves
    mutations."""
    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        addrs = [("127.0.0.1", active.port), ("127.0.0.1", shadow.port)]
        servers = [chunkserver(tmp_path, f"cs{i}", addrs, heartbeat_interval=0.2,
                               wave_timeout=0.2) for i in range(3)]
        for cs in servers:
            cs.mirror_reregister_interval = 0.2
            await cs.start()
        c = client(*addrs, wave_timeout=0.2)
        await c.connect()
        try:
            assert c.shadow_reads
            d = await c.mkdir(1, "dir")
            f = await c.create(d.inode, "f.bin")
            await c.write_file(f.inode, b"z" * 8192)
            await caught_up(shadow, active)
            assert (await c.getattr(f.inode)).length == 8192
            assert c.metrics.series["shadow_reads"].total >= 1
            errors, done = [], asyncio.Event()

            async def reader_storm():
                while not done.is_set():
                    try:
                        assert (await c.getattr(f.inode)).length == 8192
                        assert (await c.lookup(1, "dir")).inode == d.inode
                        assert [e.name for e in await c.readdir(d.inode)] == ["f.bin"]
                    except Exception as e:  # noqa: BLE001 (collected, asserted below)
                        errors.append(e)
                        return
                    await asyncio.sleep(0.01)

            storm = asyncio.ensure_future(reader_storm())
            await asyncio.sleep(0.3)
            await active.stop()
            shadow.promote()
            await wait_for(lambda: not shadow._mirror_cs_writers, "the mirror links to close")
            await wait_for(lambda: len(shadow.cs_links) == len(servers),
                           "the chunkservers to re-register", 10.0)
            await asyncio.sleep(0.3)
            done.set()
            await storm
            assert not errors, errors[:1]
            assert not shadow._replica_ready()
            f2 = await c.create(d.inode, "post-promotion")
            assert (await c.lookup(d.inode, "post-promotion")).inode == f2.inode
        finally:
            await c.close()
            for cs in servers:
                await cs.stop()
            await shadow.stop()

    run(go())


@pytest.mark.parametrize("spelling", list(OFF_SPELLINGS))
def test_lz_ha_off_spelling_equivalence(tmp_path, monkeypatch, spelling):
    """``LZ_HA`` off: promotion commits no epoch bump, every epoch field
    stays 0, and ``promote-shadow`` still works."""
    monkeypatch.setenv("LZ_HA", spelling)
    from lizardfs_tpu_torch import constants

    assert not constants.ha_enabled()

    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        try:
            c = client(("127.0.0.1", active.port))
            await c.connect()
            d = await c.mkdir(1, "dir")
            assert c.cluster_epoch == 0
            await c.close()
            await caught_up(shadow, active)
            await active.stop()
            assert (await admin(shadow.port, "promote-shadow")).status == 0
            assert shadow.meta.epoch == 0
            assert not any(op.get("op") == "epoch_bump"
                           for _, op in shadow.changelog.iter_entries(0))
            c2 = client(("127.0.0.1", shadow.port))
            await c2.connect()
            assert (await c2.lookup(1, "dir")).inode == d.inode
            assert c2.cluster_epoch == 0
            await c2.close()
            ha = json.loads((await admin(shadow.port, "ha")).json)
            assert ha["enabled"] is False and ha["epoch"] == 0
        finally:
            await shadow.stop()

    run(go())


def test_zombie_ex_primary_fenced_by_epoch(tmp_path):
    """Split brain: the shadow is promoted while the old active runs. The
    promotion's epoch fences the zombie: it steps down, its late writes
    are refused, and the surviving client reads through the new master."""
    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        addrs = [("127.0.0.1", active.port), ("127.0.0.1", shadow.port)]
        cs = chunkserver(tmp_path, "cs", addrs, heartbeat_interval=0.2, wave_timeout=0.2)
        cs.mirror_reregister_interval = 0.2
        await cs.start()
        c = client(*addrs, wave_timeout=0.2)
        await c.connect()
        try:
            f = await c.create(1, "fence.bin")
            data = b"fenced" * 1000
            await c.write_file(f.inode, data)
            await caught_up(shadow, active)
            shadow.promote()
            assert shadow.meta.epoch == 1
            deadline = time.monotonic() + 15.0
            while not (active.personality == "shadow" and cs.cluster_epoch == 1
                       and len(shadow.cs_links) == 1 and c.cluster_epoch == 1):
                assert time.monotonic() < deadline, "the zombie fenced itself"
                try:
                    await c.getattr(f.inode)
                except (ConnectionError, OSError):
                    pass
                await asyncio.sleep(0.05)
            assert active.metrics.counter("ha_fenced").total >= 1
            assert await c.read_file(f.inode) == data
            with pytest.raises(ConnectionError):
                await client(("127.0.0.1", active.port)).connect()
            assert shadow.changelog.version >= active.changelog.version
        finally:
            await c.close()
            await cs.stop()
            await shadow.stop()
            await active.stop()

    run(go())


# --- the election ------------------------------------------------------------------


def _nodes(ports: dict, kinds: dict, leaders: dict, **kw) -> dict:
    """One election node per id, of the package ``kinds[id]`` names."""
    addrs = {nid: ("127.0.0.1", p) for nid, p in ports.items()}
    nodes = {}
    for nid in ports:
        async def on_leader(nid=nid):
            leaders[nid] = True

        async def on_follower(leader, nid=nid):
            leaders[nid] = False

        cls = ElectionNode if kinds.get(nid, "port") == "port" else RefElectionNode
        nodes[nid] = cls(nid, addrs[nid], {p: a for p, a in addrs.items() if p != nid},
                         get_version=lambda: 1, on_leader=on_leader, on_follower=on_follower,
                         **kw)
    return nodes


async def _one_leader(nodes, timeout=10.0):
    leader = []

    def settled():
        leader[:] = [nid for nid, n in nodes.items() if n.state == LEADER]
        return len(leader) == 1

    await wait_for(settled, "one leader", timeout)
    return leader[0]


@pytest.mark.parametrize("kinds", [{}, {"n0": "jax"}, {"n1": "jax", "n2": "jax"}],
                         ids=["port", "one-jax-node", "two-jax-nodes"])
def test_election_three_nodes(kinds):
    """Three nodes elect one leader; it stops; one of the other two
    leads. A quorum may mix the packages' nodes: their datagrams are the
    same."""
    async def go():
        leaders = {}
        nodes = _nodes({f"n{i}": free_udp_port() for i in range(3)}, kinds, leaders)
        for n in nodes.values():
            await n.start()
        try:
            first = await _one_leader(nodes)
            await nodes[first].stop()
            rest = {nid: n for nid, n in nodes.items() if nid != first}
            second = await _one_leader(rest)
            assert second != first
            # the leader's term is every live node's term
            await wait_for(lambda: len({n.term for n in rest.values()}) == 1, "one term")
        finally:
            for n in nodes.values():
                await n.stop()

    run(go())


def test_failover_controller_exec_hooks(tmp_path):
    """A controller on each master and a witness: the active leads, stops;
    the shadow wins, is promoted with a fenced epoch and runs the
    operator's promote command; the admin surface reports the election."""
    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        addrs = {nid: ("127.0.0.1", free_udp_port()) for nid in ("na", "nb", "nw")}

        def peers_of(nid):
            return {k: v for k, v in addrs.items() if k != nid}

        marker = tmp_path / "promoted.marker"
        ctrl_shadow = FailoverController(
            shadow, "nb", addrs["nb"], peers_of("nb"),
            promote_exec=f"echo $LIZ_NODE_ID:$LIZ_ROLE > {marker}", election_timeout=(0.2, 0.4))
        ctrl_active = FailoverController(active, "na", addrs["na"], peers_of("na"),
                                         election_timeout=(0.2, 0.4))
        shadow.ha_controller, active.ha_controller = ctrl_shadow, ctrl_active

        async def noop():
            pass

        witness = ElectionNode("nw", addrs["nw"], peers_of("nw"), get_version=lambda: -1,
                               on_leader=noop, election_timeout=(9.0, 9.9))
        await ctrl_active.start()
        await ctrl_shadow.start()
        await witness.start()
        try:
            await wait_for(lambda: LEADER in (ctrl_active.node.state, ctrl_shadow.node.state),
                           "a first leader")
            await ctrl_active.stop()
            await active.stop()
            await wait_for(lambda: shadow.personality == "master" and marker.exists()
                           and marker.read_text().strip(), "the promotion and its hook", 10.0)
            assert marker.read_text().strip() == "nb:master"
            assert shadow.meta.epoch == 1
            ha = json.loads((await admin(shadow.port, "ha")).json)
            assert ha["enabled"] is True and ha["epoch"] == 1
            assert ha["personality"] == "master" and ha["state"] == LEADER
            assert ha["promotions"] >= 1
            health = json.loads((await admin(shadow.port, "health")).json)
            assert health["ha"]["epoch"] == 1
        finally:
            await witness.stop()
            await ctrl_shadow.stop()
            await shadow.stop()

    run(go())


def test_arbiter_relaxes_version_rule_when_leaderless():
    """A vote-only arbiter grants a behind candidate its vote only after
    a long leaderless window; a master never does."""
    async def go():
        async def noop():
            pass

        now = asyncio.get_running_loop().time()
        arbiter = ElectionNode("w", ("127.0.0.1", 0), {"a": ("127.0.0.1", 1)},
                               get_version=lambda: 10, on_leader=noop, can_lead=False,
                               election_timeout=(0.05, 0.1))
        arbiter._leader_seen_at = now
        arbiter._on_message({"type": "vote_req", "term": 1, "candidate": "a", "version": 5})
        assert arbiter.voted_for is None
        arbiter._leader_seen_at = now - 100.0
        arbiter._on_message({"type": "vote_req", "term": 2, "candidate": "a", "version": 5})
        assert arbiter.voted_for == "a" and arbiter.stale_votes_granted == 1
        voter = ElectionNode("m", ("127.0.0.1", 0), {"a": ("127.0.0.1", 1)},
                             get_version=lambda: 10, on_leader=noop, can_lead=True,
                             election_timeout=(0.05, 0.1))
        voter._leader_seen_at = now - 100.0
        voter._on_message({"type": "vote_req", "term": 1, "candidate": "a", "version": 5})
        assert voter.voted_for is None and voter.stale_votes_granted == 0

    run(go())


async def _election_race_trial():
    """Three candidates and a vote-only witness: elect, stop the leader,
    elect again. No term ever crowns two leaders, a leader emerges each
    time, and the witness never leads."""
    ports = {f"n{i}": free_udp_port() for i in range(3)}
    ports["w"] = free_udp_port()
    addrs = {nid: ("127.0.0.1", p) for nid, p in ports.items()}
    by_term: dict[int, set[str]] = {}
    nodes: dict[str, ElectionNode] = {}

    def make(nid):
        async def on_leader():
            by_term.setdefault(nodes[nid].term, set()).add(nid)

        return ElectionNode(nid, addrs[nid], {k: v for k, v in addrs.items() if k != nid},
                            get_version=lambda: 1, on_leader=on_leader, can_lead=nid != "w",
                            election_timeout=(0.1, 0.25), heartbeat_interval=0.03)

    for nid in ports:
        nodes[nid] = make(nid)
        await nodes[nid].start()
    try:
        first = await _one_leader(nodes)
        assert first != "w"
        await nodes[first].stop()
        second = await _one_leader({n: nd for n, nd in nodes.items() if n != first})
        assert second != "w"
        assert all(len(s) == 1 for s in by_term.values()), by_term
        assert "w" not in {n for s in by_term.values() for n in s}
    finally:
        for n in nodes.values():
            await n.stop()


@pytest.mark.parametrize("seed", [1] + [pytest.param(s, marks=pytest.mark.slow) for s in (2, 3)])
def test_election_race_no_double_leader(seed):
    """The election under the port's deterministic loop: each seed
    reorders the vote, heartbeat and timeout callbacks."""
    detsched.run(_election_race_trial(), seed=seed)


# --- a three-node quorum failing over an ec(8,4) cluster ------------------------------


def test_quorum_fails_over_an_ec84_cluster(tmp_path):
    """Two masters and a metalogger, wired as the entry points wire them
    (a controller on each master, a vote-only node on the metalogger),
    thirteen servers at ec(8,4): the active stops, exactly one promotion
    follows, the chunkservers re-register, the file reads back degraded
    through the new master, and the metalogger's archive restores to the
    new master's metadata checksum."""
    data = payload(5, 9 * 65536 + 123)

    async def go():
        active = active_master(tmp_path)
        await active.start()
        shadow = shadow_of(tmp_path, active)
        await shadow.start()
        service = {"a": ("127.0.0.1", active.port), "b": ("127.0.0.1", shadow.port)}
        vote = {nid: ("127.0.0.1", free_udp_port()) for nid in ("a", "b", "w")}
        ml = Metalogger(str(tmp_path / "ml"), list(service.values()), image_interval=0.5)

        def quorum(nid):
            return {k: v for k, v in vote.items() if k != nid}

        timing = {"election_timeout": (0.3, 0.6), "heartbeat_interval": 0.05}
        ctrls = {nid: FailoverController(master, nid, vote[nid], quorum(nid),
                                         service_addrs=service, **timing)
                 for nid, master in (("a", active), ("b", shadow))}

        async def on_follower(leader):
            ml.prefer(service[leader])

        async def never():
            raise AssertionError("a vote-only node led")

        witness = ElectionNode("w", vote["w"], quorum("w"), get_version=lambda: ml.version,
                               on_leader=never, on_follower=on_follower, can_lead=False,
                               **timing)
        await ml.start()
        await witness.start()
        await ctrls["a"].start()
        await wait_for(lambda: ctrls["a"].node.state == LEADER, "the active to lead")
        await ctrls["b"].start()
        addrs = list(service.values())
        servers = [chunkserver(tmp_path, f"cs{i}", addrs, heartbeat_interval=0.2,
                               wave_timeout=0.2) for i in range(13)]
        for cs in servers:
            await cs.start()
        c = client(*addrs, wave_timeout=0.2)
        await c.connect()
        try:
            f = await c.create(1, "quorum.bin")
            await c.setgoal(f.inode, GOALS["ec84"])
            await c.write_file(f.inode, data)
            await caught_up(shadow, active)
            await wait_for(lambda: ml.version == active.changelog.version, "the archive's tail")
            chunk = active.meta.registry.chunks[active.meta.fs.nodes[f.inode].chunks[0]]
            victim_id = next(cs for cs, p in sorted(chunk.parts) if p < 8)
            victim_port = active.meta.registry.servers[victim_id].port
            # the new master's rebuilds held back (its per-chunk retry
            # backoff): until every server has registered again its
            # registry shows parts missing, and the read must run degraded
            shadow._repl_fail_until[chunk.chunk_id] = time.monotonic() + 3600.0
            await ctrls["a"].stop()
            await active.stop()
            await wait_for(lambda: shadow.personality == "master", "the promotion", 10.0)
            assert (ctrls["b"].promotions, ctrls["a"].promotions) == (1, 0)
            assert shadow.meta.epoch == 1
            await wait_for(lambda: len(shadow.cs_links) == 13,
                           "the chunkservers to register with the new master", 20.0)
            victim = next(cs for cs in servers if cs.port == victim_port)
            await victim.stop()
            servers.remove(victim)
            c.cache.invalidate(f.inode)
            assert await c.read_file(f.inode) == data
            await wait_for(lambda: ml.version == shadow.changelog.version,
                           "the metalogger to follow the new master", 10.0)
            assert archived(tmp_path / "ml").checksum() == shadow.meta.checksum()
            assert witness.leader_id == "b"
        finally:
            await c.close()
            for cs in servers:
                await cs.stop()
            await ctrls["b"].stop()
            await witness.stop()
            await ml.stop()
            await shadow.stop()

    run(go())


# --- mixed packages: a metalogger of one package behind a master of the other ---------


@pytest.mark.parametrize("ml_pkg", ["port", "jax"])
def test_metalogger_follows_the_other_package(tmp_path, ml_pkg):
    """A port metalogger archives a JAX master's changelog and a JAX
    metalogger a port master's; each archive, restored by its own
    package's ``metarestore``, has the other package's checksum."""
    master_cls = RefMasterServer if ml_pkg == "port" else MasterServer
    ml_cls = Metalogger if ml_pkg == "port" else RefMetalogger
    restore = (metarestore if ml_pkg == "port" else ref_metarestore).restore
    client_cls, encoder = ((RefClient, RefCpuChunkEncoder()) if ml_pkg == "port"
                           else (Client, ENCODER))

    async def go():
        master = master_cls(str(tmp_path / "m"))
        await master.start()
        ml = ml_cls(str(tmp_path / "ml"), [("127.0.0.1", master.port)], image_interval=0.2)
        await ml.start()
        try:
            c = client_cls("127.0.0.1", master.port, encoder=encoder)
            await c.connect()
            d = await c.mkdir(1, "docs")
            for i in range(4):
                f = await c.create(d.inode, f"f{i}")
                await c.set_xattr(f.inode, "user.k", b"v%d" % i)
            await c.rename(d.inode, "f0", 1, "moved")
            await c.close()
            await wait_for(lambda: ml.version >= master.changelog.version
                           and (tmp_path / "ml" / "metadata.liz").exists(), "the archive")
            await asyncio.sleep(0.3)  # one more image after the tail
            _, final = restore(str(tmp_path / "ml"), str(tmp_path / "restored"), verbose=False)
            assert final == master.changelog.version
            version, doc = load_image(str(tmp_path / "restored"))
            store = MetadataStore()
            store.load_sections(doc)
            return store.checksum(), master.meta.checksum()
        finally:
            await ml.stop()
            await master.stop()

    restored, live = run(go())
    assert restored == live
