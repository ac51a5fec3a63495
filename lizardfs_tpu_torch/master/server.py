"""Master daemon: client service, chunkserver service, shadow stream,
health loop, persistence.

One asyncio daemon hosting all the reference's master-side network
modules (reference: src/master/matoclserv.cc client service,
matocsserv.cc chunkserver service, matomlserv.cc shadow/metalogger
stream) over the MetadataStore state machine. Connections self-identify
with their first message (register), then stay in a per-role loop.

Write-path protocol (fuse_write_chunk analog, matoclserv.cc:2938):
  WriteChunk -> create chunk (choose servers per part, command creates)
                or bump version on existing parts; lock; reply locations
  WriteChunkEnd -> set file length, unlock, changelog.

Health loop (ChunkWorker analog, chunks.cc:1807): every tick, serve the
endangered queue first, then walk chunks; replicate missing parts
(MatocsReplicate to a chosen server with source locations) and delete
redundant ones.

The port's copy departs in two places: when a chunkserver registers a
part of an unreadable chunk and the chunk's retained parts are all a
version ahead of the metadata (a master died between its chunkservers'
version bump and the bump's commit), the master adopts their version as
soon as enough of them are back to read, as filerepair does; and when a
chunkserver reports a part of a chunk id the metadata never issued (a
master died between its chunkservers' creates and the create's commit),
the master never issues that id, whose orphan parts would pass for the
new chunk's.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.master import fs as fsmod
from lizardfs_tpu_torch.master.changelog import Changelog, load_image, save_image
from lizardfs_tpu_torch.master.chunks import ChunkServerInfo
from lizardfs_tpu_torch.master.locks import LOCK_UNLOCK, MAX_OFFSET
from lizardfs_tpu_torch.master.metadata import MetadataStore
from lizardfs_tpu_torch.master.quotas import KIND_DIR, KIND_GROUP, KIND_USER
from lizardfs_tpu_torch import constants as constants_mod
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE, MFSCHUNKSIZE
from lizardfs_tpu_torch.master import heat as heatmod
from lizardfs_tpu_torch.master import rebuild as rebuild_mod
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import accounting
from lizardfs_tpu_torch.runtime import qos as qosmod
from lizardfs_tpu_torch.runtime import retry as retrymod
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.daemon import Daemon


# client RPC -> op class for the per-session accounting the `top` view
# aggregates: chunk-grant RPCs split read/write (the latency-critical
# classes), namespace traffic splits by mutation, session/control
# chatter stays out of the hot classes
_OP_CLASS_READ = frozenset({
    "CltomaLookup", "CltomaGetattr", "CltomaReaddir", "CltomaReadlink",
    "CltomaAccess", "CltomaStatFs", "CltomaGetXattr", "CltomaListXattr",
    "CltomaGetQuota", "CltomaGetAcl", "CltomaGetRichAcl",
    "CltomaTrashList", "CltomaTapeInfo",
})
_OP_CLASS_SESSION = frozenset({
    "CltomaRegister", "CltomaGoodbye", "CltomaIoLimitRequest",
    "CltomaSessionStats", "CltomaOpen", "CltomaRelease",
})


def _op_class_of(msg) -> str:
    name = type(msg).__name__
    if name == "CltomaReadChunk":
        return "read"
    if name in (
        "CltomaWriteChunk", "CltomaWriteChunkEnd", "CltomaWriteChunkEndBatch",
    ):
        return "write"
    if name in _OP_CLASS_READ:
        return "meta_read"
    if name in _OP_CLASS_SESSION:
        return "session"
    return "meta_write"


def _fork_safe() -> bool:
    """CoW-fork is only safe from an effectively single-threaded
    process. The reference forks its dumper from a single-threaded
    event loop (metadata_dumper.h:37); a process that has loaded a
    thread-heavy native runtime (XLA/torch spawn pools whose mutexes a
    forked child inherits locked) must not fork, or the child can
    deadlock before it ever reaches Python. The master itself never
    imports jax (tests/test_fork_safety.py pins this), so production
    masters always take the fast CoW path; colocated/test processes
    that did import jax fall back to on-loop serialization."""
    if not hasattr(os, "fork"):
        return False
    import sys

    return not any(
        mod in sys.modules for mod in ("jax", "jaxlib", "torch")
    )

CHUNK_LOCK_SECONDS = 30.0

# LZ_SHADOW_READS kill switch (shared across roles — constants.py)
from lizardfs_tpu_torch.constants import shadow_reads_enabled  # noqa: E402


class _CsLink:
    """Server-side link to one registered chunkserver: lets the master
    send commands and await acks while reports flow in."""

    def __init__(self, master: "MasterServer", reader, writer):
        self.master = master
        self.reader = reader
        self.writer = writer
        self.cs_id = 0
        # disjoint from the chunkserver's own call ids (they start at 1):
        # both directions share one connection (see rpc.RpcConnection._pump)
        self._req_ids = iter(range(1 << 30, 1 << 62))
        self._pending: dict[int, asyncio.Future] = {}
        self._dead = False

    async def command(self, msg_cls, *, timeout: float = 20.0, **fields):
        if self._dead:
            # a coroutine that kept this link across an await while the
            # chunkserver dropped would otherwise park on a future
            # nothing resolves until the full timeout (rpc.py fast-fail
            # pattern — failover latency, not correctness)
            raise ConnectionError("chunkserver disconnected")
        req_id = next(self._req_ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            await framing.send_message(self.writer, msg_cls(req_id=req_id, **fields))
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(req_id, None)

    def dispatch_ack(self, msg) -> bool:
        fut = self._pending.get(msg.req_id)
        if fut is not None and not fut.done():
            fut.set_result(msg)
            return True
        return False

    def fail_all(self):
        self._dead = True
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("chunkserver disconnected"))
        self._pending.clear()


class MasterServer(Daemon):
    name = "master"

    def __init__(
        self,
        data_dir: str,
        host: str = "127.0.0.1",
        port: int = 0,
        goals: dict[int, geometry.Goal] | None = None,
        health_interval: float = 1.0,
        image_interval: float = 300.0,
        personality: str = "master",
        active_addr: tuple[str, int] | None = None,
        exports=None,
        topology=None,
        io_limit_bps: int = 0,
        io_limits: dict[str, int] | None = None,
        io_limit_subsystem: str = "",
        admin_password: str | None = None,
        lock_grace_seconds: float = 30.0,
        config_paths: dict[str, str] | None = None,
        lifecycle_interval: float = 30.0,
    ):
        super().__init__(host, port)
        self.admin_password = admin_password
        # a briefly-disconnected client keeps its file locks for this
        # long; reconnecting with the same session id reclaims them
        self.lock_grace_seconds = lock_grace_seconds
        self._lock_grace: dict[int, float] = {}  # sid -> release deadline
        self.data_dir = data_dir
        # flight-recorder incidents (breached-SLO trace captures) live
        # beside the metadata image
        self.slo.recorder.set_dir(os.path.join(data_dir, "incidents"))
        self.meta = MetadataStore()
        self.changelog = Changelog(data_dir)
        self.goals = goals or geometry.default_goals()
        self.cs_links: dict[int, _CsLink] = {}
        # last health snapshot each chunkserver folded into a heartbeat
        # (CstomaHeartbeat.health_json) — aggregated by cluster_health()
        self.cs_health: dict[int, dict] = {}
        # tape server links (matotsserv.cc analog): ts_id -> writer/label
        self.ts_links: dict[int, dict] = {}
        self._next_ts_id = 1
        # inodes whose tape copies are missing/stale: inode -> (length,
        # mtime, gen) content stamp at enqueue; live-master queue
        # (rebuilt by a scan when a tape server registers)
        self.tape_pending: dict[int, tuple[int, int, int]] = {}
        self._tape_inflight: set[int] = set()
        # lifecycle tiering (S3 gateway / ROADMAP 3): inodes the
        # lifecycle scanner wants archived even without a $tape goal —
        # _tape_missing_labels treats membership as one wildcard copy.
        # Derived state (the scanner re-queues each pass), not persisted.
        self.tape_force: set[int] = set()
        # demoted inodes mid-recall: inode -> Future resolving to a
        # status code. While an inode is here the demoted write guard
        # stands down FOR THE RECALLING TAPE SERVER'S SESSION only
        # (_recall_sids; 0 = legacy peer without a session id =
        # permissive); reads stay refused until recall completes.
        self._recall_inflight: dict[int, asyncio.Future] = {}
        self._recall_sids: dict[int, int] = {}
        self.shadow_writers: list[asyncio.StreamWriter] = []
        self.sessions: dict[int, dict] = {}
        # per-session op accounting (runtime/accounting.py): every
        # client RPC charges its originating session's labeled
        # latency/byte cells; `lizardfs-admin top` renders the rollup
        self.session_ops = accounting.SessionOps(self.metrics, "master")
        # gateway-pushed workload summaries (CltomaSessionStats):
        # sid -> {"ts": epoch, ...gateway stats doc}
        self.session_stats: dict[int, dict] = {}
        # orphaned lock owners (no live connection) first seen at ts;
        # released after _ORPHAN_LOCK_TIMEOUT (promotion leaves locks of
        # sessions that never reconnect)
        self._orphan_lock_seen: dict[int, float] = {}
        # pending (blocked) lock requests are live-master-only: entries
        # {kind, sid, token, start, end, ltype} keyed by inode; held
        # locks live in self.meta.locks (changelog-replicated)
        self._pending_locks: dict[int, list[dict]] = {}
        self._session_writers: dict[int, asyncio.StreamWriter] = {}
        # cache-invalidation watch set (matoclserv.cc analog): which
        # sessions recently located chunks OR read attrs/access
        # decisions of an inode; mutations — data writes, truncates,
        # and metadata changes (chmod/setattr/seteattr/ACLs) — push
        # MatoclCacheInvalidate to them, so cross-gateway permission
        # revocation doesn't wait out META_TTL_S.
        # inode -> {sid -> last watch refresh}
        self._read_watchers: dict[int, dict[int, float]] = {}
        # multi-tenant QoS (runtime/qos.py): sessions map to tenants at
        # registration (config-driven, QOS_CFG), the RPC loop sheds
        # over-budget tenants with transient BUSY replies, and the
        # data-plane config rides every heartbeat ack to chunkservers.
        # An unconfigured engine admits everything — QoS only bites on
        # clusters that armed rates/budgets (LZ_QOS=0 kills even that).
        self.qos_tenants = qosmod.TenantMap()
        self.qos = qosmod.FairShare()
        self.qos_doc: dict = {}  # the parsed QOS_CFG (admin-mutable)
        self._qos_cs_cache: tuple = ()  # (key, json) heartbeat-ack cache
        # per-class admission rates double as live tweaks (admin
        # `tweaks-set qos_locate_rate 2000` == admin `qos set`): the
        # hook writes through to the engine
        self._qos_rate_tweaks = {
            cls: self.tweaks.register(
                f"qos_{cls}_rate", 0.0,
                on_set=lambda v, c=cls: self.qos.set_rate(c, v),
            )
            for cls in qosmod.MASTER_RATE_CLASSES
        }
        # bumped whenever the session population (or a session's
        # tenant) changes: the heartbeat-ack qos push keys its cache on
        # (engine generation, this) instead of fingerprinting every
        # session per ack
        self._session_epoch = 0
        from lizardfs_tpu_torch.master.exports import Exports, Topology

        self.exports = exports if exports is not None else Exports()
        self.topology = topology if topology is not None else Topology()
        self.health_interval = health_interval
        self.image_interval = image_interval
        self.lifecycle_interval = lifecycle_interval
        # lifecycle scan work caps: nodes visited / demotes committed
        # per tick — the scan must never own the loop. Oversized
        # buckets resume across ticks via the saved walk stacks.
        self.lifecycle_scan_budget = 10_000
        self.lifecycle_demote_budget = 256
        self._lifecycle_stacks: dict[int, list[int]] = {}
        # explicit rebuild scheduler (priority classes, token-bucket
        # throttle, progress/ETA) — the endangered FIFO feeds it, the
        # health tick launches what it admits (master/rebuild.py)
        self.rebuild = rebuild_mod.RebuildEngine(self.metrics, self.tweaks)
        # cluster heat map (master/heat.py): decayed per-chunk / inode /
        # server heavy-hitter sketch fed by client RPC charges, CS
        # heartbeat heat folds, and gateway stats pushes. The health
        # tick closes the loop: adaptive goal boosts (changelog ops),
        # load-weighted placement, and the SLO→QoS auto-arm below.
        self.heat = heatmod.HeatTracker(self.metrics, self.tweaks)
        # heat-armed QoS pressure: tenant -> (restore_weight, expiry).
        # The SLO breach hook halves an offender's fair-share weight;
        # the health tick restores it when the window expires.
        self._heat_qos_pressure: dict[str, tuple[float, float]] = {}
        self._slo_qos_last = 0.0  # rate limit on the auto-arm action
        # second auto-arm action beside the profiler (runtime/slo.py):
        # an SLO burn breach also squeezes the top-offending tenant
        self.slo.qos_arm = self._slo_qos_arm
        # repair-failure backoff: chunk_id -> monotonic deadline before
        # the next replicate attempt (a source at a stale version fails
        # fast, and retrying it at tick rate floods the log and the net)
        self._repl_fail_until: dict[int, float] = {}
        from lizardfs_tpu_torch.master.tasks import TaskManager

        self.task_manager = TaskManager(self.commit)
        # global IO budget (bytes/s, 0 = unlimited) divided among the
        # sessions that renewed an allocation recently
        self.io_limit_bps = io_limit_bps
        # per-cgroup budgets (mfsiolimits.cfg analog, reference
        # src/mount/io_limit_group.cc + globaliolimits): group path ->
        # bytes/s; each group's budget is divided among the sessions
        # renewing UNDER that group. Takes precedence over io_limit_bps.
        self.io_limits = dict(io_limits or {})
        self.io_limit_subsystem = io_limit_subsystem
        # (sid, resolved group) -> last renew  (legacy global: group "")
        self._io_limited_sessions: dict[tuple[int, str], float] = {}
        # personality: "master" (active) or "shadow" (applies the
        # changelog stream from active_addr; promotable at runtime)
        # (src/master/personality.h:25-69 analog)
        self.personality = personality
        self.active_addr = active_addr
        self._shadow_task: asyncio.Task | None = None
        # shadow replication-lag tracking (active side): connected
        # shadows ack their applied changelog position (MltomaAck);
        # keyed by the stream writer so a dead link's entry dies with
        # its loop. Surfaced in cluster_health + the shadow_lag gauge.
        self.shadow_status: dict[int, dict] = {}
        # shadow side: True while the changelog follow link is up —
        # replica reads are refused without it (a cut-off shadow would
        # otherwise serve unbounded staleness behind a valid token)
        self._follow_connected = False
        self._last_shadow_ack = 0.0
        # passive chunkserver mirror connections (shadow side): closed
        # on promotion so chunkservers re-register command-capable
        self._mirror_cs_writers: set[asyncio.StreamWriter] = set()
        # cs_id -> the writer whose mirror loop currently owns that
        # server's registration (supersession guard for teardown)
        self._mirror_cs_owner: dict[int, asyncio.StreamWriter] = {}
        # autopilot failover: set by __main__ when this daemon runs an
        # ElectionNode (quorum membership); health/admin `ha` read it
        self.ha_controller = None
        # config file paths for SIGHUP / admin `reload` (cfg_reload
        # analog): keys "goals", "exports", "topology", "iolimits"
        self.config_paths = dict(config_paths or {})
        self.log = logging.getLogger("master")

    def reload(self, strict: bool = False) -> None:
        """SIGHUP / admin reload: re-read the runtime-reloadable config
        files (reference: cfg_reload + registered hooks — mfsgoals,
        mfsexports, mfstopology, iolimits). A file that fails to parse
        keeps its previous in-memory config (never half-apply).

        ``strict=True`` raises on the first bad file — the STARTUP
        loading path (__main__) runs the same code so boot and SIGHUP
        can never interpret a file differently."""
        reloaded, failed = [], []

        def attempt(key, fn):
            path = self.config_paths.get(key)
            if not path:
                return
            try:
                with open(path) as f:
                    fn(f.read())
                reloaded.append(key)
            except Exception:  # noqa: BLE001 — keep serving on bad config
                if strict:
                    raise
                self.log.exception("reload of %s (%s) failed", key, path)
                failed.append(key)

        def goals(text):
            self.goals = geometry.load_goal_config(text)

        def exports(text):
            from lizardfs_tpu_torch.master.exports import Exports

            self.exports = Exports.load(text)

        def topology(text):
            from lizardfs_tpu_torch.master.exports import Topology

            self.topology = Topology.load(text)

        def iolimits(text):
            from lizardfs_tpu_torch.utils.io_limits import parse_limits_cfg

            self.io_limit_subsystem, self.io_limits = parse_limits_cfg(text)

        def qos_cfg(text):
            self._qos_apply_config(qosmod.parse_config(text))

        attempt("goals", goals)
        attempt("exports", exports)
        attempt("topology", topology)
        attempt("iolimits", iolimits)
        attempt("qos", qos_cfg)
        self._last_reload = {"reloaded": reloaded, "failed": failed}
        if reloaded or failed:
            self.log.info("config reload: ok=%s failed=%s", reloaded, failed)

    # --- lifecycle -----------------------------------------------------------

    async def setup(self) -> None:
        loaded = load_image(self.data_dir)
        start_version = 0
        if loaded is not None:
            start_version, doc = loaded
            self.meta.load_sections(doc)
            sess = doc.get("sessions", {})
            # legacy-image fallback only; the authoritative counter is
            # metadata's replicated next_session. O(1) digest fixup —
            # only the misc entity changes.
            old_misc = self.meta._entity_hash(("misc",))
            self.meta.next_session = max(
                self.meta.next_session, int(sess.get("next", 1))
            )
            self.meta._digest ^= old_misc ^ self.meta._entity_hash(("misc",))
            for sid, row in sess.get("known", {}).items():
                self.sessions[int(sid)] = {
                    "info": row.get("info", ""), "connected": False,
                }
        self.changelog.version = start_version
        replayed = 0
        for version, op in self.changelog.iter_entries(start_version):
            self.meta.apply(op)
            self.changelog.version = version
            replayed += 1
        if replayed:
            self.log.info("replayed %d changelog entries", replayed)
        self.changelog.open()
        self.add_timer(self.health_interval, self._health_tick)
        self.add_timer(self.image_interval, self._dump_image)
        self.add_timer(10.0, self._purge_trash)
        self.add_timer(0.05, self._task_tick)
        self.add_timer(1.0, self._lock_grace_sweep)
        self.add_timer(30.0, self._read_watcher_sweep)
        self.add_timer(1.0, self._tape_drain)
        # S3 lifecycle tiering scan (age-based demote to tape); the
        # kill switch is re-read per tick, so LZ_S3_LIFECYCLE=0 stops
        # new demotions without a restart
        self.add_timer(max(self.lifecycle_interval, 0.1),
                       self._lifecycle_tick)

    async def _task_tick(self) -> None:
        """Run a batch of background metadata jobs (TaskManager analog:
        long-running work in slices so client service never stalls)."""
        if self.is_active:
            self.task_manager.tick()

    shadow_verify_interval = 30.0

    async def start(self) -> None:
        await super().start()
        # standing derived chart: average chunk density across the fleet
        self.metrics.gauge("chunks")
        self.metrics.gauge("chunkservers_connected")
        self.metrics.define(
            "chunks_per_server", "chunks chunkservers_connected DIV"
        )
        if self.personality == "shadow":
            if self.active_addr is None:
                raise ValueError("shadow personality needs active_addr")
            self._shadow_task = self.spawn(self._shadow_follow())
            # divergence detection (filesystem_checksum analog): compare
            # whole-metadata digests with the active at equal versions.
            # spawn directly — add_timer only registers before start()
            self.spawn(self._run_timer(
                self.shadow_verify_interval, self._shadow_verify_checksum
            ))
            # periodic applied-position ack: an IDLE shadow at tip must
            # keep reporting (lag telemetry ages out otherwise — acks
            # also ride every applied line, throttled)
            self.spawn(self._run_timer(2.0, self._shadow_ack_tick))

    @property
    def is_active(self) -> bool:
        return self.personality == "master"

    async def teardown(self) -> None:
        await self._dump_image()
        self.changelog.close()

    # --- mutation helper --------------------------------------------------------

    def commit(self, op: dict) -> int:
        """Apply + changelog + broadcast to shadows. The one write path."""
        self.metrics.counter("metadata_ops").inc()
        self.metrics.counter(f"op.{op['op']}").inc()
        self.meta.apply(op)
        version = self.changelog.append(op)
        if self.shadow_writers:
            line = m.MatomlChangelogLine(version=version, line=json.dumps(op, sort_keys=True))
            dead = []
            for w in self.shadow_writers:
                try:
                    framing.write_message(w, line)
                except (ConnectionError, RuntimeError):
                    dead.append(w)
            for w in dead:
                self.shadow_writers.remove(w)
        self._tape_mark(op)
        return version

    async def _dump_image(self) -> None:
        version = self.changelog.version
        # persist session registry (sessions.mfs analog): ids survive a
        # master restart so reconnecting clients keep their session ids.
        # Only LIVE sessions are persisted — one-shot CLI sessions would
        # otherwise accumulate in every image forever.
        sessions_section = {
            "known": {
                str(sid): {"info": s.get("info", "")}
                for sid, s in self.sessions.items()
                if s.get("connected")
            },
        }
        # MetadataDumper analog (metadata_dumper.h:37): fork and let the
        # CHILD serialize the copy-on-write snapshot — the master's loop
        # blocks only for the fork itself (page-table copy), not for the
        # O(namespace) serialization. The fork happens synchronously
        # here, so the snapshot is consistent with `version`.
        ok = False
        try:
            pid = os.fork() if _fork_safe() else -1
        except OSError:
            pid = -1
        inc_digest = self.meta._digest
        if pid == 0:
            code = 1
            try:
                sections = self.meta.to_sections()
                sections["sessions"] = sessions_section
                save_image(self.data_dir, version, sections)
                # background checksum verification on the CO-W snapshot
                # (filesystem_checksum_background_updater analog): the
                # full recompute costs the child, not the serving loop
                code = 3 if self.meta.full_digest() != inc_digest else 0
            finally:
                os._exit(code)
        elif pid > 0:
            rc = await self._wait_child(pid, timeout=600.0)
            ok = rc in (0, 3)
            if rc == 3:
                self._handle_digest_drift(version)
            elif not ok:
                self.log.error("forked metadata dump failed (v%d)", version)
        else:
            # no fork (jax/torch threads live, or exotic platform):
            # serialize on the loop thread's snapshot, write off-loop.
            # The digest-drift verification the forked child performs
            # runs here too, at the same consistent point as the
            # serialization — but only on every Nth fallback dump: the
            # full recompute is a second O(namespace) stall on top of
            # to_sections(), and this path never serves production
            # masters (which stay jax-free and fork).
            sections = self.meta.to_sections()
            sections["sessions"] = sessions_section
            self._fallback_dump_n = getattr(self, "_fallback_dump_n", 0) + 1
            drifted = (
                self._fallback_dump_n % 8 == 1
                and self.meta.full_digest() != inc_digest
            )
            await asyncio.to_thread(save_image, self.data_dir, version, sections)
            ok = True
            if drifted:
                self._handle_digest_drift(version)
        if ok:
            self.changelog.rotate()
            self.changelog.open()

    def _handle_digest_drift(self, version: int) -> None:
        """Incremental digest no longer matches a full recompute: state
        was corrupted outside apply() or the incremental update has a
        bug. Log, count, and re-anchor to the full value."""
        self.log.error(
            "incremental metadata digest drift detected (v%d); "
            "re-anchoring", version,
        )
        self.metrics.counter("digest_drift").inc()
        self.meta.reset_digest()

    async def _wait_child(self, pid: int, timeout: float) -> int:
        """Reap a forked worker with a deadline: a child deadlocked by a
        lock some other thread held at fork time (the classic fork+
        threads hazard) must not stall dumps forever. Returns the exit
        code, or -1 on timeout/kill."""
        import signal

        deadline = time.monotonic() + timeout
        while True:
            wpid, status = os.waitpid(pid, os.WNOHANG)
            if wpid == pid:
                return os.waitstatus_to_exitcode(status)
            if time.monotonic() >= deadline:
                self.log.error("forked worker %d hung; killing", pid)
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
                await asyncio.to_thread(os.waitpid, pid, 0)
                return -1
            await asyncio.sleep(0.05)

    async def _lock_grace_sweep(self) -> None:
        """Release locks of sessions whose grace window expired without
        a reconnect (lock retention across brief disconnects)."""
        if not self.is_active:
            return
        now = time.monotonic()
        for sid, deadline in list(self._lock_grace.items()):
            if now < deadline:
                continue
            if self._session_writers.get(sid) is not None:
                # reconnected; shouldn't happen (register clears it)
                del self._lock_grace[sid]
                continue
            del self._lock_grace[sid]
            held = self.meta.locks.session_inodes(sid)
            if held:
                self.commit({"op": "lock_release_session", "sid": sid})
                for inode in held:
                    self._grant_pending_locks(inode)
            self._release_session_opens(sid)

    def _release_session_opens(self, sid: int) -> None:
        """Drop a departed session's open handles (freeing any sustained
        files it was the last holder of)."""
        if any(sid in refs for refs in self.meta.fs.open_refs.values()):
            self.commit({"op": "release_session_opens", "sid": sid})

    _ORPHAN_LOCK_TIMEOUT = 60.0

    async def _purge_trash(self) -> None:
        if not self.is_active:
            return
        now = int(time.time())
        expired = [
            i for i, entry in self.meta.fs.trash.items() if entry[1] <= now
        ]
        for inode in expired:
            self.commit({"op": "purge_trash", "inode": inode})
        # retire disconnected sessions (the in-memory registry would
        # otherwise grow with every one-shot CLI invocation)
        dead = [
            sid for sid, s in self.sessions.items()
            if not s.get("connected") and sid not in self._session_writers
        ]
        for sid in dead:
            del self.sessions[sid]
            # per-session accounting follows the session registry's
            # lifetime: rate windows + pushed gateway stats retire with
            # the session (labeled counters keep their totals)
            self.session_ops.retire(sid)
            self.session_stats.pop(sid, None)
        if dead:
            self._session_epoch += 1
        # release locks AND open handles whose owning session has no
        # live connection and never reconnected (orphans from a
        # promotion or client crash)
        owners = set()
        for table in (self.meta.locks.posix_files, self.meta.locks.flock_files):
            for fl in table.values():
                owners.update(r.owner.session_id for r in fl.ranges)
        for refs in self.meta.fs.open_refs.values():
            owners.update(refs)
        live = set(self._session_writers)
        now_f = time.time()
        for sid in owners - live:
            if sid in self._lock_grace:
                continue  # the grace sweep owns this session's fate
            first_seen = self._orphan_lock_seen.setdefault(sid, now_f)
            if now_f - first_seen >= self._ORPHAN_LOCK_TIMEOUT:
                held = self.meta.locks.session_inodes(sid)
                if held:
                    self.commit({"op": "lock_release_session", "sid": sid})
                self._release_session_opens(sid)
                self._orphan_lock_seen.pop(sid, None)
                for inode in held:
                    self._grant_pending_locks(inode)
        for sid in list(self._orphan_lock_seen):
            if sid in live or sid not in owners:
                del self._orphan_lock_seen[sid]

    # --- connection dispatch ------------------------------------------------------

    async def handle_connection(self, reader, writer) -> None:
        try:
            first = await framing.read_message(reader)
        except (asyncio.IncompleteReadError, ConnectionError):
            return
        if isinstance(first, m.CltomaRegister):
            await self._client_loop(reader, writer, first)
        elif isinstance(first, m.CstomaRegister):
            await self._cs_loop(reader, writer, first)
        elif isinstance(first, m.TstomaRegister):
            await self._ts_loop(reader, writer, first)
        elif isinstance(first, m.MltomaRegister):
            await self._shadow_loop(reader, writer, first)
        elif isinstance(first, (m.AdminInfo, m.AdminCommand)):
            admin_state: dict = {}
            await self._admin_message(writer, first, admin_state)
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                await self._admin_message(writer, msg, admin_state)
        else:
            self.log.warning("unexpected first message %s", type(first).__name__)

    # --- client service (matoclserv analog) -----------------------------------------

    def _stamp_token(self, reply) -> None:
        """Stamp the consistency token (applied changelog position) on
        any reply carrying a trailing ``meta_version`` field — directly,
        or on its nested Attr (MatoclAttrReply's token rides the Attr
        tail). Read AFTER the op was handled, so a mutation's ack
        carries the version that includes it (read-your-writes through
        replicas)."""
        if reply is None:
            return
        target = reply if hasattr(reply, "meta_version") else getattr(
            reply, "attr", None
        )
        if target is not None and hasattr(target, "meta_version") \
                and not target.meta_version:
            target.meta_version = self.changelog.version

    async def _client_loop(self, reader, writer, first: m.CltomaRegister) -> None:
        if not self.is_active:
            if (
                getattr(first, "replica_ok", 0)
                and first.session_id
                and self.personality == "shadow"
                and shadow_reads_enabled()
            ):
                await self._replica_loop(reader, writer, first)
                return
            # clients cycle through master addresses until they find the
            # active one (modern replacement for the floating-IP dance)
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, session_id=0
                ),
            )
            return
        if getattr(first, "replica_ok", 0):
            # replica-mode registrations must never become command
            # sessions (mirror of the mirror=1 guard on the cs side): a
            # promoted shadow would otherwise adopt a client's replica
            # REDIAL as the session's push link — superseding the real
            # primary writer, whose connection has the push handlers —
            # and lock-grant/invalidation pushes would be lost. Refuse;
            # the client's replica dial treats non-OK as "no replica
            # here" and its primary link is unaffected.
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, session_id=0
                ),
            )
            return
        if self.observe_peer_epoch(getattr(first, "epoch", 0)):
            # the client has seen a newer master than us — we just
            # stepped down; refuse so it redials the address list
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, session_id=0
                ),
            )
            return
        peer = writer.get_extra_info("peername") or ("127.0.0.1", 0)
        rule = self.exports.match(peer[0], getattr(first, "password", ""))
        if rule is None:
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id, status=st.EACCES, session_id=0
                ),
            )
            return
        root_inode = self._resolve_export_root(rule)
        if root_inode is None:
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id, status=st.ENOENT, session_id=0
                ),
            )
            return
        session_id = first.session_id or self.meta.next_session
        # replicate the allocation: a promoted shadow must never re-issue
        # an id whose locks are still held (and whose disconnect would
        # then release a stranger's locks)
        self.commit({"op": "session_new", "sid": session_id})
        self.sessions[session_id] = {
            "info": first.info, "connected": True, "ip": peer[0],
            "readonly": rule.readonly, "maproot": rule.maproot,
            "root": root_inode,
            # tenant identity is decided at registration (and
            # re-resolved when the QoS config reloads): admission, the
            # data-plane push, health, and `top` all read this label
            "tenant": self.qos_tenants.tenant_of(first.info, rule.path),
            "export": rule.path,
        }
        self._session_epoch += 1
        self._session_writers[session_id] = writer
        # reconnect within the grace window: the session keeps its locks
        self._lock_grace.pop(session_id, None)
        await framing.send_message(
            writer,
            m.MatoclRegister(
                req_id=first.req_id, status=st.OK, session_id=session_id,
                # seeds the client's monotonic-reads floor: a replica
                # must be at least this caught up to serve this client
                meta_version=self.changelog.version,
                # cluster fencing epoch: the client echoes its highest
                # observed value on every redial, so a zombie ex-primary
                # it lands on learns of the election and steps down
                epoch=self.meta.epoch,
            ),
        )
        try:
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if not self.is_active:
                    # fenced/demoted mid-session (observe_peer_epoch or
                    # a lost election): stop serving writes NOW and
                    # close, so the client's redial loop finds the new
                    # active instead of a zombie merging late mutations
                    break
                # fair-share admission: an over-budget tenant's op is
                # shed with transient BUSY + retry hint BEFORE it costs
                # handler work. Off/unconfigured = these two checks.
                if constants_mod.qos_enabled() and self.qos.armed:
                    busy = self._qos_shed(session_id, msg)
                    if busy is not None:
                        await framing.send_message(writer, busy)
                        continue
                t0 = time.perf_counter()
                try:
                    reply = await self._handle_client(msg, session_id)
                except fsmod.FsError as e:
                    reply = self._error_reply(msg, e.code)
                except Exception:
                    self.log.exception("client op %s failed", type(msg).__name__)
                    reply = self._error_reply(msg, st.EIO)
                # request_log.h analog: per-op-type latency histograms
                t1 = time.perf_counter()
                dt = t1 - t0
                self.metrics.timing(type(msg).__name__).record(dt)
                # request-scoped tracing: RPCs carrying a trace id land
                # in the span ring (dumped via admin `trace-dump`)
                tid = getattr(msg, "trace_id", 0)
                self.trace_ring.record(
                    tid, type(msg).__name__, t0, t1, role="master",
                )
                # per-session accounting: the same op charged to its
                # originating session (the `top` rollup's master leg)
                self.session_ops.record(
                    session_id, _op_class_of(msg), dt, trace_id=tid,
                )
                # SLO accounting: chunk grant/locate RPCs are the
                # master's latency-critical class — a slow one breaches
                # the "locate" objective and flight-records its trace
                if isinstance(msg, (m.CltomaReadChunk, m.CltomaWriteChunk,
                                    m.CltomaWriteChunkEnd,
                                    m.CltomaWriteChunkEndBatch)):
                    self.slo.observe(
                        "locate", dt, trace_id=tid,
                        name=type(msg).__name__,
                    )
                    # heat map, inode kind: the master-leg RPC charge
                    # carries latency + trace id so the hottest cell's
                    # heat_hot_ops histogram gets a drill-down exemplar
                    if constants_mod.heat_enabled():
                        inode = getattr(msg, "inode", 0)
                        if inode:
                            self.heat.charge(
                                "inode", inode, seconds=dt, trace_id=tid,
                            )
                if reply is not None:
                    self._stamp_token(reply)
                    await framing.send_message(writer, reply)
        finally:
            # a reconnected client may have superseded this connection
            # under the same session id — only the CURRENT connection may
            # tear the session down (otherwise the stale loop would
            # release locks the reconnected client still holds)
            if self._session_writers.get(session_id) is writer:
                self.sessions.get(session_id, {})["connected"] = False
                self._session_epoch += 1
                self._session_writers.pop(session_id, None)
                if self._stopping.is_set():
                    # master shutdown, not client departure: locks must
                    # survive the restart (the image is dumped next);
                    # the client reconnects with the same session id
                    return
                held = self.meta.locks.session_inodes(session_id)
                # queued (blocked) requests die with the connection —
                # there is nobody to push the grant to
                queued = [
                    i for i, q in self._pending_locks.items()
                    if any(p["sid"] == session_id for p in q)
                ]
                for q in self._pending_locks.values():
                    q[:] = [p for p in q if p["sid"] != session_id]
                for inode in queued:
                    self._grant_pending_locks(inode)
                clean = self.sessions.get(session_id, {}).get("clean_close")
                if held and clean:
                    # clean goodbye: release now
                    self.commit(
                        {"op": "lock_release_session", "sid": session_id}
                    )
                    for inode in held:
                        self._grant_pending_locks(inode)
                has_opens = any(
                    session_id in refs
                    for refs in self.meta.fs.open_refs.values()
                )
                if (held or has_opens) and not clean:
                    # abrupt disconnect: HELD locks and open handles get
                    # a grace window — a client that reconnects with its
                    # session id (network blip, failover) keeps them;
                    # the sweep releases both if it never comes back
                    self._lock_grace[session_id] = (
                        time.monotonic() + self.lock_grace_seconds
                    )
                if clean:
                    # open handles die with a clean goodbye
                    self._release_session_opens(session_id)

    # read-mostly RPCs a shadow replica serves; everything else gets
    # NOT_POSSIBLE so the client routes it to the primary. Mutations are
    # structurally impossible here: none of these handlers commit.
    # ONLY ops whose reply types carry a meta_version token belong here
    # (MatoclAttrReply/Readdir/Readlink/StatusReply/ReadChunk): a
    # tokenless reply can never pass the client's monotonic-reads floor
    # and would count a spurious stale retry on every call.
    _REPLICA_SERVABLE = (
        "CltomaLookup", "CltomaGetattr", "CltomaReaddir", "CltomaReadlink",
        "CltomaAccess", "CltomaReadChunk",
    )

    def _resolve_export_root(self, rule) -> "int | None":
        """Export subtree root inode for ``rule``, or None when the
        path does not (yet) resolve. ONE implementation shared by the
        primary client loop and the shadow replica loop — their views
        of the export subtree must never diverge."""
        if rule.path in ("/", ""):
            return fsmod.ROOT_INODE
        try:
            node = self.meta.fs.node(fsmod.ROOT_INODE)
            for comp in rule.path.strip("/").split("/"):
                node = self.meta.fs.lookup(node.inode, comp)
            return node.inode
        except fsmod.FsError:
            return None

    # --- multi-tenant QoS (fair-share admission) ---------------------------

    # completion/session verbs are never shed: WriteChunkEnd[Batch]
    # releases the chunk lock a granted write holds (shedding it would
    # convert admission pressure into lock pressure), and session
    # control fires once per mount, not on the request path
    _QOS_NEVER_SHED = frozenset({
        "CltomaWriteChunkEnd", "CltomaWriteChunkEndBatch", "CltomaGoodbye",
        "CltomaRegister", "CltomaIoLimitRequest", "CltomaSessionStats",
        "CltomaOpen", "CltomaRelease",
    })

    def _qos_admission_class(self, msg) -> "str | None":
        """Admission op class of a client RPC (one vocabulary with the
        chunkserver data plane), or None for ops QoS never sheds."""
        name = type(msg).__name__
        if name in self._QOS_NEVER_SHED:
            return None
        if name == "CltomaReadChunk":
            return "locate"
        if name == "CltomaWriteChunk":
            return "write"
        if name == "CltomaLockOp" and getattr(msg, "ltype", -1) == \
                LOCK_UNLOCK:
            # lock RELEASES are never shed (same reason as
            # WriteChunkEnd: shedding a release converts admission
            # pressure into lock pressure for every waiter, including
            # other tenants — cross-tenant priority inversion)
            return None
        if name in _OP_CLASS_READ:
            return "meta_read"
        return "meta_write"

    def _qos_apply_config(self, doc: dict) -> None:
        """Install a parsed QoS config (startup, SIGHUP, admin `qos`):
        tenant mapping + admission engine + the doc the heartbeat-ack
        push to chunkservers is built from. Tweak mirrors stay in sync
        so `tweaks` output never lies about a live rate."""
        self.qos_doc = doc
        self.qos_tenants = qosmod.TenantMap.from_config(doc)
        self.qos.configure(doc)
        self._qos_cs_cache = ()
        for cls, tweak in self._qos_rate_tweaks.items():
            tweak.value = self.qos.rates.get(cls, 0.0)
        # re-resolve live sessions against the NEW match rules: a
        # SIGHUP that moves a client between tenants must bite without
        # waiting for that client to reconnect
        for sess in self.sessions.values():
            sess["tenant"] = self.qos_tenants.tenant_of(
                str(sess.get("info", "")), str(sess.get("export", ""))
            )
        self._session_epoch += 1

    def _qos_shed(self, session_id: int, msg) -> "m.MatoclStatusReply | None":
        """Admission check for one client RPC: None = admitted, else
        the BUSY reply to send (shed, with the backoff hint). The
        LZ_QOS=0 / unconfigured path is the caller's two checks and
        nothing else."""
        cls = self._qos_admission_class(msg)
        if cls is None:
            return None
        tenant = self.sessions.get(session_id, {}).get(
            "tenant", qosmod.DEFAULT_TENANT
        )
        retry_ms = self.qos.admit(tenant, cls)
        if retry_ms is None:
            return None
        self.metrics.labeled_counter(
            "qos_shed", {"tenant": tenant, "op": cls},
            help="client RPCs shed with BUSY by fair-share admission, "
                 "by tenant and op class",
        ).inc()
        return m.MatoclStatusReply(
            req_id=getattr(msg, "req_id", 0), status=st.BUSY,
            retry_after_ms=retry_ms,
        )

    def _qos_cs_json(self) -> str:
        """The QoS data-plane config chunkservers apply, refreshed on
        every heartbeat ack: session->tenant map, tenant weights, the
        in-flight byte budget, and optional per-session native-plane
        pacing. Empty string when QoS is off/unconfigured (the ack is
        byte-identical to the pre-QoS one). Cached until the engine
        generation or session population changes."""
        if not constants_mod.qos_enabled():
            return ""
        doc = self.qos_doc
        inflight_mb = float(doc.get("data_inflight_mb", 0) or 0)
        data_bps = float(doc.get("data_bps", 0) or 0)
        if inflight_mb <= 0 and data_bps <= 0:
            return ""
        key = (self.qos.generation, self._session_epoch)
        if self._qos_cs_cache and self._qos_cs_cache[0] == key:
            return self._qos_cs_cache[1]
        tenants = {
            sid: s.get("tenant", qosmod.DEFAULT_TENANT)
            for sid, s in self.sessions.items() if s.get("connected")
        }
        weights = dict(self.qos.weights)
        out = {
            "gen": self.qos.generation,
            "tenants": {str(sid): t for sid, t in tenants.items()},
            "weights": weights,
            "inflight_mb": inflight_mb,
            "rebuild_weight": float(doc.get("rebuild_weight", 1.0)),
        }
        if data_bps > 0:
            # approximate native-plane pacing: the total data rate
            # split by tenant weight across connected tenants, each
            # session paced at its tenant's share (the asyncio DRR is
            # the precise enforcement; this bounds the C++ fast path)
            active = {tenants[sid] for sid in tenants}
            total_w = sum(
                weights.get(t, 1.0) for t in active
            ) or 1.0
            out["session_bps"] = {
                str(sid): int(
                    data_bps * weights.get(t, 1.0) / total_w
                )
                for sid, t in tenants.items()
            }
        text = json.dumps(out, sort_keys=True)
        self._qos_cs_cache = (key, text)
        return text

    # --- cluster heat loop (master/heat.py) --------------------------------

    def _heat_tick(self) -> None:
        """The heat loop's control leg, riding the health tick: decay
        the sketch, commit goal boosts/demotes for chunks crossing the
        thresholds (hysteresis lives in heat.boost_decisions), refresh
        the load-weighted placement inputs, and expire heat-armed QoS
        pressure."""
        registry = self.meta.registry
        now = time.monotonic()
        enabled = constants_mod.heat_enabled()
        # expire armed QoS pressure even when the switch just went off:
        # LZ_HEAT=0 must never leave a tenant squeezed forever
        for tenant, (restore, until) in list(
            self._heat_qos_pressure.items()
        ):
            if now >= until or not enabled:
                del self._heat_qos_pressure[tenant]
                self.qos.set_weight(tenant, restore)
        if not enabled:
            if registry.server_load:
                # revert placement to pure free-space weighting
                registry.server_load = {}
            return
        self.heat.tick(now)
        # observatory-driven placement: new-chunk server selection
        # weighs observed load — per-server heat share + heartbeat
        # health status + DRR queue depth (queued data-plane bytes)
        waiting: dict[int, float] = {}
        for cs_id, snap in self.cs_health.items():
            q = (snap or {}).get("qos") or {}
            w = q.get("waiting")
            if isinstance(w, dict):
                waiting[cs_id] = float(sum(w.values()))
            elif w:
                try:
                    waiting[cs_id] = float(w)
                except (TypeError, ValueError):
                    pass
        registry.server_load = self.heat.server_loads(
            self.cs_health, waiting
        )
        # adaptive replication: boost chunks whose decayed heat crossed
        # heat_boost_bytes, demote once it falls below heat_demote_bytes
        # — via digest-covered changelog ops so shadows and the image
        # agree; the extra copies are made/shed by the ordinary
        # RebuildEngine machinery under its token-bucket budget
        boosted = {
            cid: registry.chunks[cid].boost
            for cid in registry.boosted if cid in registry.chunks
        }
        to_boost, to_demote = self.heat.boost_decisions(boosted)
        for cid in to_demote:
            self.commit({"op": "goal_demote", "chunk_id": cid})
            self.log.info("heat: goal demote chunk %d", cid)
        for cid, copies in to_boost:
            if cid not in registry.chunks:
                continue
            self.commit({
                "op": "goal_boost", "chunk_id": cid, "boost": copies,
            })
            # wake the health walk on it now, not a cursor cycle later
            registry.mark_endangered(cid)
            self.log.info(
                "heat: goal boost chunk %d (+%d copies)", cid, copies
            )

    def _slo_qos_arm(self, op_class: str, trace_id: int) -> None:
        """Second SLO auto-arm action (beside the profiler): burn-rate
        breach → squeeze the top-offending tenant's fair-share weight
        for a window. Rate-limited, reversible (the health tick
        restores the weight), and inert unless both LZ_HEAT and LZ_QOS
        are on and QoS is actually armed."""
        if not constants_mod.heat_enabled():
            return
        if not constants_mod.qos_enabled() or not self.qos.armed:
            return
        now = time.monotonic()
        if now - self._slo_qos_last < 30.0:
            return
        # top offender: the highest-rate session's tenant right now
        tenant = ""
        for row in self.session_ops.top(4):
            label = row["session"]
            if not label.startswith("s"):
                continue  # "other"/aggregate rows have no tenant
            try:
                sid = int(label[1:])
            except ValueError:
                continue
            tenant = self.sessions.get(sid, {}).get("tenant", "")
            if tenant:
                break
        if not tenant or tenant in self._heat_qos_pressure:
            return
        self._slo_qos_last = now
        current = self.qos.weights.get(tenant, 1.0)
        self._heat_qos_pressure[tenant] = (current, now + 30.0)
        self.qos.set_weight(tenant, current / 2.0)
        self.metrics.labeled_counter(
            "slo_qos_armed", {"tenant": tenant, "op": op_class},
            help="SLO burn-rate breaches that auto-armed QoS pressure "
                 "(halved fair-share weight for a window), by offending "
                 "tenant and breaching op class",
        ).inc()
        self.log.warning(
            "slo breach (%s, trace 0x%x): qos pressure armed on tenant "
            "%s for 30s", op_class, trace_id, tenant,
        )

    def _replica_ready(self) -> bool:
        """A shadow serves replica reads only while its changelog follow
        link is live — a partitioned shadow would otherwise serve
        unbounded staleness behind a formally valid token."""
        return (
            self.personality == "shadow"
            and self._follow_connected
            and shadow_reads_enabled()
        )

    async def _replica_loop(
        self, reader, writer, first: m.CltomaRegister
    ) -> None:
        """Shadow-side client service: consistency-tokened read replica.

        The session id was issued (and committed) by the primary — the
        shadow accepts it without a commit of its own (shadows never
        write the changelog) and serves ONLY _REPLICA_SERVABLE ops, each
        reply stamped with the applied changelog position. The client
        enforces monotonic reads against that token and retries through
        the primary on staleness (client/client.py _call_read)."""
        peer = writer.get_extra_info("peername") or ("127.0.0.1", 0)
        rule = self.exports.match(peer[0], getattr(first, "password", ""))
        if rule is None or not self._replica_ready():
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id,
                    status=st.EACCES if rule is None else st.NOT_POSSIBLE,
                    session_id=0,
                ),
            )
            return
        root_inode = self._resolve_export_root(rule)
        if root_inode is None:
            # the exported subtree may not have replicated yet —
            # refuse; the client stays primary-only and retries the
            # replica link later
            await framing.send_message(
                writer,
                m.MatoclRegister(
                    req_id=first.req_id, status=st.ENOENT, session_id=0
                ),
            )
            return
        session_id = first.session_id
        entry = {
            "info": first.info, "connected": True, "ip": peer[0],
            "readonly": True, "maproot": rule.maproot, "root": root_inode,
            "replica": True,
            # the client appends "/replica" to its info; prefix rules
            # still match, so both legs land on the same tenant
            "tenant": self.qos_tenants.tenant_of(first.info, rule.path),
        }
        self.sessions[session_id] = entry
        self._session_epoch += 1
        await framing.send_message(
            writer,
            m.MatoclRegister(
                req_id=first.req_id, status=st.OK, session_id=session_id,
                meta_version=self.changelog.version,
                # shadow's replayed fencing epoch: the client adopts it
                # and presents it on its next primary (re)dial, so a
                # zombie ex-primary is fenced even by clients that only
                # ever reached this replica after the election
                epoch=self.meta.epoch,
            ),
        )
        served = self.metrics.counter(
            "shadow_reads",
            help="read RPCs served by this shadow in replica mode",
        )
        try:
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if isinstance(msg, m.CltomaGoodbye):
                    reply = m.MatoclStatusReply(
                        req_id=msg.req_id, status=st.OK
                    )
                elif (
                    type(msg).__name__ not in self._REPLICA_SERVABLE
                    or not self._replica_ready()
                ):
                    # promoted mid-session, kill switch flipped, or an
                    # op outside the allowlist: the client reroutes to
                    # the primary (its own conn fails over if WE are
                    # the new primary)
                    reply = self._error_reply(msg, st.NOT_POSSIBLE)
                elif constants_mod.qos_enabled() and self.qos.armed and (
                    (busy := self._qos_shed(session_id, msg)) is not None
                ):
                    # locate storms shed per-tenant on replicas too —
                    # one scanner must not starve the fleet's locates
                    # through the shadow either. BUSY (not
                    # NOT_POSSIBLE) so the client backs off and retries
                    # instead of dropping the replica link.
                    reply = busy
                else:
                    t0 = time.perf_counter()
                    try:
                        reply = await self._handle_client(msg, session_id)
                        served.inc()
                    except fsmod.FsError as e:
                        reply = self._error_reply(msg, e.code)
                    except Exception:
                        self.log.exception(
                            "replica op %s failed", type(msg).__name__
                        )
                        reply = self._error_reply(msg, st.EIO)
                    dt = time.perf_counter() - t0
                    self.metrics.timing(type(msg).__name__).record(dt)
                    # replica-served reads charge the same session the
                    # primary would (the shadow's own registry; the
                    # client never double-counts — fallbacks re-enter
                    # the primary loop which records there instead)
                    self.session_ops.record(
                        session_id, _op_class_of(msg), dt,
                        trace_id=getattr(msg, "trace_id", 0),
                    )
                if reply is not None:
                    self._stamp_token(reply)
                    await framing.send_message(writer, reply)
        finally:
            # supersession guard (mirror of _client_loop's `is writer`
            # check): a half-open old replica connection must not
            # delete the session entry a REDIALED replica loop (or a
            # post-promotion command registration) installed for the
            # same id — ops running against a missing entry would skip
            # the export-subtree remap entirely
            if self.sessions.get(session_id) is entry:
                del self.sessions[session_id]
                self._session_epoch += 1

    def _error_reply(self, msg, code: int):
        if isinstance(msg, (m.CltomaReadChunk,)):
            return m.MatoclReadChunk(
                req_id=msg.req_id, status=code, chunk_id=0, version=0,
                file_length=0, locations=[],
            )
        if isinstance(msg, (m.CltomaWriteChunk,)):
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=code, chunk_id=0, version=0,
                file_length=0, locations=[],
            )
        if isinstance(msg, m.CltomaReaddir):
            return m.MatoclReaddir(req_id=msg.req_id, status=code, entries=[])
        if isinstance(msg, m.CltomaReadlink):
            return m.MatoclReadlink(req_id=msg.req_id, status=code, target="")
        if isinstance(msg, m.CltomaGetXattr):
            return m.MatoclXattrReply(req_id=msg.req_id, status=code, value=b"")
        if isinstance(msg, m.CltomaListXattr):
            return m.MatoclListXattr(req_id=msg.req_id, status=code, names=[])
        if isinstance(msg, m.CltomaGetQuota):
            return m.MatoclQuotaReply(req_id=msg.req_id, status=code, json="[]")
        if isinstance(msg, m.CltomaLockOp):
            return m.MatoclLockReply(req_id=msg.req_id, status=code)
        if isinstance(msg, m.CltomaTrashList):
            return m.MatoclTrashList(req_id=msg.req_id, status=code, json="[]")
        if isinstance(msg, m.CltomaFileRepair):
            return m.MatoclFileRepair(req_id=msg.req_id, status=code, json="{}")
        if isinstance(
            msg,
            (m.CltomaLookup, m.CltomaGetattr, m.CltomaMkdir, m.CltomaCreate,
             m.CltomaSetattr, m.CltomaSymlink, m.CltomaLink, m.CltomaSnapshot,
             m.CltomaAppendChunks),
        ):
            return m.MatoclAttrReply(
                req_id=msg.req_id, status=code, attr=_null_attr()
            )
        return m.MatoclStatusReply(req_id=msg.req_id, status=code)

    def _io_limit_share(self, session_id: int, group: str, bps: int) -> int:
        """Equal share of ``group``'s budget among its sessions that
        renewed in the last 5 s (globaliolimits allocation model)."""
        mono = time.monotonic()
        self._io_limited_sessions[(session_id, group)] = mono
        self._io_limited_sessions = {
            k: ts for k, ts in self._io_limited_sessions.items()
            if mono - ts < 5.0
        }
        n = sum(1 for (_sid, g) in self._io_limited_sessions if g == group)
        return bps // max(n, 1)

    def _check_quota(self, dir_inode: int, uid: int, gid: int,
                     d_inodes: int, d_bytes: int) -> None:
        """Raise QUOTA_EXCEEDED if hard limits forbid the addition."""
        if not self.meta.quotas.check(uid, gid, d_inodes, d_bytes):
            raise fsmod.FsError(st.QUOTA_EXCEEDED, f"uid {uid}/gid {gid}")
        # directory quotas along the ancestor chain
        fs = self.meta.fs
        cur = dir_inode
        hops = 0
        while cur and hops < 4096:
            entry = self.meta.quotas.entry(KIND_DIR, cur)
            node = fs.nodes.get(cur)
            if node is None:
                break
            if entry is not None and not self.meta.quotas.check_dir(
                (node.stat_inodes, node.stat_bytes), entry, d_inodes, d_bytes
            ):
                raise fsmod.FsError(st.QUOTA_EXCEEDED, f"dir {cur}")
            if cur == fsmod.ROOT_INODE or not node.parents:
                break
            cur = node.parents[0]
            hops += 1

    def _owns(self, node, uid: int) -> bool:
        """Ownership test for owner-gated ops (setgoal/seteattr/...):
        root, the owner, or anyone when the inode carries
        EATTR_NOOWNER (the flag makes every uid act as the owner)."""
        from lizardfs_tpu_torch.constants import EATTR_NOOWNER

        return uid == 0 or uid == node.uid or bool(node.eattr & EATTR_NOOWNER)

    def _access_ok(self, node, uid: int, gids: list[int], want: int) -> bool:
        """One permission decision for every call site: RichACL if set,
        else mode bits + POSIX ACL. EATTR_NOOWNER short-circuits to the
        owner's view for every caller."""
        from lizardfs_tpu_torch.constants import EATTR_NOOWNER

        if node.eattr & EATTR_NOOWNER and uid != 0:
            # evaluate as if the caller were the owner (mode/ACL owner
            # entries apply); root keeps its usual path below
            uid = node.uid
            gids = [node.gid]
        if node.rich_acl is not None:
            from lizardfs_tpu_torch.master.richacl import RichAcl

            return RichAcl.from_dict(node.rich_acl).check_access(
                node.uid, node.gid, uid, gids, want, mode=node.mode
            )
        from lizardfs_tpu_torch.master import acl as acl_mod

        a = acl_mod.Acl.from_dict(node.acl) if node.acl else None
        return acl_mod.check_access(
            node.mode, node.uid, node.gid, a, uid, gids, want
        )

    def _check_perm(self, node, uid: int, gids: list[int], want: int) -> None:
        if not self._access_ok(node, uid, gids, want):
            raise fsmod.FsError(st.EACCES, f"inode {node.inode}")

    def _grant_pending_locks(self, inode: int) -> None:
        queue = self._pending_locks.get(inode)
        if not queue:
            self._pending_locks.pop(inode, None)
            return
        still = []
        for p in queue:
            if self._lock_conflict(inode, p) is None:
                self._commit_lock(inode, p)
                w = self._session_writers.get(p["sid"])
                if w is not None:
                    try:
                        framing.write_message(
                            w,
                            m.MatoclLockGranted(inode=inode, token=p["token"]),
                        )
                    except (ConnectionError, RuntimeError):
                        pass
            else:
                still.append(p)
        if still:
            self._pending_locks[inode] = still
        else:
            self._pending_locks.pop(inode, None)

    def _lock_conflict(self, inode: int, p: dict):
        if p["ltype"] == LOCK_UNLOCK:
            return None
        if p["kind"] == "flock":
            return self.meta.locks.test_flock(
                inode, p["sid"], p["token"], p["ltype"]
            )
        return self.meta.locks.test(
            inode, p["sid"], p["token"], p["start"], p["end"], p["ltype"]
        )

    def _commit_lock(self, inode: int, p: dict) -> None:
        if p["kind"] == "flock":
            self.commit({
                "op": "lock_flock", "inode": inode, "sid": p["sid"],
                "token": p["token"], "ltype": p["ltype"],
            })
        else:
            self.commit({
                "op": "lock_posix", "inode": inode, "sid": p["sid"],
                "token": p["token"], "start": p["start"], "end": p["end"],
                "ltype": p["ltype"],
            })

    _MUTATING = (
        "CltomaMkdir", "CltomaCreate", "CltomaSymlink", "CltomaLink",
        "CltomaUnlink", "CltomaRmdir", "CltomaRename", "CltomaSetGoal",
        "CltomaSetattr", "CltomaTruncate", "CltomaWriteChunk",
        "CltomaWriteChunkEnd", "CltomaWriteChunkEndBatch",
        "CltomaSnapshot", "CltomaSetXattr",
        "CltomaSetQuota", "CltomaUndelete", "CltomaSetAcl",
        "CltomaSetRichAcl", "CltomaSetEattr", "CltomaFileRepair",
        "CltomaAppendChunks", "CltomaTapeDemote",
    )

    _INODE_FIELDS = ("parent", "inode", "parent_src", "parent_dst",
                     "dst_parent", "src_inode")

    def _in_subtree(self, inode: int, root: int) -> bool:
        """Is ``inode`` reachable under ``root``? Walks all parent
        chains (hardlinks may have several)."""
        if root == fsmod.ROOT_INODE or inode == root:
            return True
        seen: set[int] = set()
        frontier = [inode]
        for _ in range(4096):
            if not frontier:
                return False
            nxt: list[int] = []
            for i in frontier:
                if i == root:
                    return True
                node = self.meta.fs.nodes.get(i)
                if node is None:
                    continue
                for p in node.parents:
                    if p not in seen:
                        seen.add(p)
                        nxt.append(p)
            frontier = nxt
        return False

    def _apply_session_view(self, msg, session: dict) -> bool:
        """Subtree exports + root squash: remap the client's root inode
        to the exported directory, refuse inodes outside the exported
        subtree, squash root uids to maproot. False = access denied."""
        root = session.get("root", fsmod.ROOT_INODE)
        if root != fsmod.ROOT_INODE:
            for field in self._INODE_FIELDS:
                if getattr(msg, field, None) == fsmod.ROOT_INODE:
                    setattr(msg, field, root)
            for field in self._INODE_FIELDS:
                value = getattr(msg, field, None)
                if value is not None and not self._in_subtree(value, root):
                    return False
        maproot = session.get("maproot")
        if maproot is not None:
            # Squash caller IDENTITY fields only.  CltomaSetattr carries
            # caller identity in caller_uid/caller_gids while its uid/gid
            # are the chown TARGET — those must pass through untouched
            # (the squashed caller is then not root and the handler
            # denies the chown).
            scalars = (("caller_uid",) if isinstance(msg, m.CltomaSetattr)
                       else ("uid", "gid", "caller_uid"))
            for field in scalars:
                if getattr(msg, field, None) == 0:
                    setattr(msg, field, maproot)
            for field in ("gids", "caller_gids"):
                vals = getattr(msg, field, None)
                if vals:
                    setattr(msg, field,
                            [maproot if v == 0 else v for v in vals])
        return True

    async def _handle_client(self, msg, session_id: int = 0):
        fs = self.meta.fs
        now = int(time.time())
        session = self.sessions.get(session_id, {})
        if session:
            if session.get("readonly") and type(msg).__name__ in self._MUTATING:
                return self._error_reply(msg, st.EROFS)
            if not self._apply_session_view(msg, session):
                return self._error_reply(msg, st.EACCES)
        if isinstance(msg, m.CltomaGoodbye):
            if session:
                session["clean_close"] = True
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaSessionStats):
            # gateway workload summary push: folded into the `top`
            # rollup under this session (bounded: one doc per live
            # session, swept with the session registry)
            try:
                doc = json.loads(msg.stats_json) if msg.stats_json else {}
                if not isinstance(doc, dict):
                    raise ValueError("stats doc must be an object")
            except ValueError:
                return m.MatoclStatusReply(
                    req_id=msg.req_id, status=st.EINVAL
                )
            doc["ts"] = time.time()
            self.session_stats[session_id] = doc
            # gateway heat leg: pushes may carry a "hot" table of
            # [inode, ops, bytes] rows (protocol gateways serve data
            # without per-inode master RPCs, so this is the only way
            # their traffic reaches the heat map)
            if constants_mod.heat_enabled():
                for row in doc.get("hot") or ():
                    try:
                        ino, ops, nbytes = (
                            int(row[0]), float(row[1]), float(row[2])
                        )
                    except (TypeError, ValueError, IndexError):
                        continue
                    self.heat.charge("inode", ino, ops=ops, nbytes=nbytes)
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaLookup):
            self._check_perm(fs.dir_node(msg.parent), msg.uid, list(msg.gids), 1)
            if msg.name in (".", ".."):
                # NFS/FUSE path walking.  ".." clamps at the session's
                # export root so a subtree export can't be escaped.
                node = fs.dir_node(msg.parent)
                sroot = session.get("root", fsmod.ROOT_INODE)
                if msg.name == ".." and node.inode != sroot and node.parents:
                    node = fs.node(node.parents[0])
                return self._attr_reply(msg.req_id, node)
            node = fs.lookup(msg.parent, msg.name)
            return self._attr_reply(msg.req_id, node)
        if isinstance(msg, m.CltomaGetattr):
            # attr readers join the invalidation-watch set: gateways
            # cache attr/access decisions off this reply, and a later
            # chmod/seteattr via ANOTHER session must push them stale
            # (cross-gateway revocation no longer waits out META_TTL_S)
            self._note_watcher(msg.inode, session_id)
            return self._attr_reply(msg.req_id, fs.node(msg.inode))
        if isinstance(msg, m.CltomaTapeInfo):
            node = fs.node(msg.inode)
            want_stamp = self._content_stamp(msg.inode, node)
            stamp_fresh = [
                c for c in self.meta.tape_copies.get(msg.inode, [])
                if (c["length"], c["mtime"], c.get("gen", 0)) == want_stamp
            ]
            doc = {
                "wanted": self._goal_tape_copies(node.goal),
                "pending": msg.inode in self.tape_pending,
                "copies": self.meta.tape_copies.get(msg.inode, []),
                "fresh": len(stamp_fresh),
                # lifecycle tiering state: tape-only / restore running /
                # archive forced by the scanner without a $tape goal
                "demoted": msg.inode in self.meta.demoted,
                "recalling": msg.inode in self._recall_inflight,
                "forced": msg.inode in self.tape_force,
            }
            return m.MatoclTapeInfoReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        if isinstance(msg, m.CltomaTapeDemote):
            node = fs.file_node(msg.inode)
            self._check_perm(node, msg.uid, list(msg.gids), 2)
            return m.MatoclStatusReply(
                req_id=msg.req_id, status=self._try_demote(msg.inode, now)
            )
        if isinstance(msg, m.CltomaTapeRecall):
            fs.file_node(msg.inode)  # must exist and be a file
            if msg.inode not in self.meta.demoted:
                return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
            try:
                code = await retrymod.bounded_wait(
                    asyncio.shield(self._ensure_recall(msg.inode)), 120.0
                )
            except asyncio.TimeoutError:
                code = st.TIMEOUT  # the recall task itself keeps going
            return m.MatoclStatusReply(req_id=msg.req_id, status=code)
        if isinstance(msg, m.CltomaStatFs):
            # the space sum is O(servers) — memoize briefly so a statfs
            # storm against a 10k-chunkserver master stays O(1) per call
            # (space figures move at heartbeat pace anyway)
            mono = time.monotonic()
            cached = getattr(self, "_statfs_cache", None)
            if cached is None or mono - cached[0] > 2.0:
                servers = self.meta.registry.connected_servers()
                cached = (
                    mono,
                    sum(s.total_space for s in servers),
                    sum(s.free_space for s in servers),
                )
                self._statfs_cache = cached
            return m.MatoclStatFsReply(
                req_id=msg.req_id, status=st.OK, total_space=cached[1],
                avail_space=cached[2], inodes=len(fs.nodes),
            )
        if isinstance(msg, m.CltomaChunkDamaged):
            # client-side CRC rejection: the named holder's copy of the
            # part is bad. Volatile-registry handling identical to a
            # chunkserver scrubber report — drop the part and queue the
            # chunk through the RebuildEngine's endangered feed. The
            # file itself stays readable (the client already recovered
            # via decode); this report is what closes the loop from
            # detection to re-replication.
            srv = self.meta.registry.server_at(msg.host, msg.port)
            if srv is not None:
                self.meta.registry.drop_part(
                    msg.chunk_id, srv.cs_id, msg.part_id
                )
                self.meta.registry.mark_endangered(msg.chunk_id)
                self.log.warning(
                    "client reported damaged chunk %016X part %d on "
                    "cs %d (%s:%d)", msg.chunk_id, msg.part_id,
                    srv.cs_id, msg.host, msg.port,
                )
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaMkdir):
            self._check_perm(fs.dir_node(msg.parent), msg.uid, [msg.gid], 2 | 1)
            self._check_quota(msg.parent, msg.uid, msg.gid, 1, 0)
            inode = fs.alloc_inode()
            self.commit({
                "op": "mknode", "parent": msg.parent, "name": msg.name,
                "inode": inode, "ftype": fsmod.TYPE_DIR, "mode": msg.mode,
                "uid": msg.uid, "gid": msg.gid, "ts": now, "goal": 1,
                "trash_time": 86400,
            })
            return self._attr_reply(msg.req_id, fs.node(inode))
        if isinstance(msg, m.CltomaCreate):
            self._check_perm(fs.dir_node(msg.parent), msg.uid, [msg.gid], 2 | 1)
            self._check_quota(msg.parent, msg.uid, msg.gid, 1, 0)
            parent_goal = fs.dir_node(msg.parent).goal
            inode = fs.alloc_inode()
            self.commit({
                "op": "mknode", "parent": msg.parent, "name": msg.name,
                "inode": inode, "ftype": fsmod.TYPE_FILE, "mode": msg.mode,
                "uid": msg.uid, "gid": msg.gid, "ts": now, "goal": parent_goal,
                "trash_time": 86400,
            })
            return self._attr_reply(msg.req_id, fs.node(inode))
        if isinstance(msg, m.CltomaSymlink):
            self._check_perm(fs.dir_node(msg.parent), msg.uid, [msg.gid], 2 | 1)
            self._check_quota(msg.parent, msg.uid, msg.gid, 1, 0)
            inode = fs.alloc_inode()
            self.commit({
                "op": "mknode", "parent": msg.parent, "name": msg.name,
                "inode": inode, "ftype": fsmod.TYPE_SYMLINK, "mode": 0o777,
                "uid": msg.uid, "gid": msg.gid, "ts": now, "goal": 1,
                "trash_time": 0, "symlink_target": msg.target,
            })
            return self._attr_reply(msg.req_id, fs.node(inode))
        if isinstance(msg, m.CltomaReadlink):
            node = fs.node(msg.inode)
            if node.ftype != fsmod.TYPE_SYMLINK:
                return m.MatoclReadlink(req_id=msg.req_id, status=st.EINVAL, target="")
            return m.MatoclReadlink(
                req_id=msg.req_id, status=st.OK, target=node.symlink_target
            )
        if isinstance(msg, m.CltomaLink):
            target = fs.file_node(msg.inode)
            self._check_perm(fs.dir_node(msg.parent), msg.uid, list(msg.gids), 2 | 1)
            self._check_quota(msg.parent, target.uid, target.gid, 1, target.length)
            self.commit({
                "op": "link", "inode": msg.inode, "parent": msg.parent,
                "name": msg.name, "ts": now,
            })
            return self._attr_reply(msg.req_id, fs.node(msg.inode))
        if isinstance(msg, m.CltomaReaddir):
            node = fs.dir_node(msg.inode)
            self._check_perm(node, msg.uid, list(msg.gids), 4)
            entries = [
                m.DirEntry(name=name, inode=i, ftype=fs.node(i).ftype)
                for name, i in sorted(node.children.items())
            ]
            return m.MatoclReaddir(req_id=msg.req_id, status=st.OK, entries=entries)
        if isinstance(msg, m.CltomaUnlink):
            self._check_perm(fs.dir_node(msg.parent), msg.uid, list(msg.gids), 2 | 1)
            self.commit({
                "op": "unlink", "parent": msg.parent, "name": msg.name,
                "ts": now, "to_trash": True,
            })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaRmdir):
            self._check_perm(fs.dir_node(msg.parent), msg.uid, list(msg.gids), 2 | 1)
            self.commit({"op": "rmdir", "parent": msg.parent, "name": msg.name, "ts": now})
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaRename):
            ident = (msg.uid, list(msg.gids))
            self._check_perm(fs.dir_node(msg.parent_src), *ident, 2 | 1)
            self._check_perm(fs.dir_node(msg.parent_dst), *ident, 2 | 1)
            self.commit({
                "op": "rename", "parent_src": msg.parent_src,
                "name_src": msg.name_src, "parent_dst": msg.parent_dst,
                "name_dst": msg.name_dst, "ts": now,
            })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaSetGoal):
            if msg.goal not in self.goals:
                return m.MatoclStatusReply(req_id=msg.req_id, status=st.EINVAL)
            node = fs.node(msg.inode)
            if not self._owns(node, msg.uid):
                raise fsmod.FsError(st.EPERM, "setgoal requires ownership")
            self.commit({"op": "setgoal", "inode": msg.inode, "goal": msg.goal, "ts": now})
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaSetEattr):
            from lizardfs_tpu_torch import constants as consts

            if msg.eattr & ~sum(consts.EATTR_NAMES.values()):
                return m.MatoclStatusReply(req_id=msg.req_id, status=st.EINVAL)
            node = fs.node(msg.inode)
            if not self._owns(node, msg.uid):
                raise fsmod.FsError(st.EPERM, "seteattr requires ownership")
            self.commit({
                "op": "seteattr", "inode": msg.inode, "eattr": msg.eattr,
                "ts": now,
            })
            # eattr flags gate client/gateway caching decisions: push
            # the change so another gateway's cached attr snapshot (and
            # the decisions derived from it) drops NOW, not at TTL
            # expiry (ADVICE r05 #4 residual)
            self._invalidate_client_caches(msg.inode, exclude_sid=session_id)
            return self._attr_reply(msg.req_id, fs.node(msg.inode))
        if isinstance(msg, m.CltomaSetattr):
            node = fs.node(msg.inode)
            caller = getattr(msg, "caller_uid", 0)
            if caller != 0:
                if msg.set_mask & (2 | 4):
                    # chown/chgrp are root-only
                    raise fsmod.FsError(st.EPERM, "chown requires root")
                if not self._owns(node, caller):
                    # mode/times/trash-time changes need ownership
                    raise fsmod.FsError(st.EPERM, f"inode {msg.inode}")
            self.commit({
                "op": "setattr", "inode": msg.inode, "set_mask": msg.set_mask,
                "mode": msg.mode, "uid": msg.uid, "gid": msg.gid,
                "atime": msg.atime, "mtime": msg.mtime, "ts": now,
                "trash_time": msg.trash_time,
            })
            # metadata mutation push (ADVICE r05 #4 residual): a chmod/
            # chown through THIS session must revoke other gateways'
            # cached attr/access decisions immediately — before this,
            # cross-gateway permission revocation lagged by META_TTL_S
            self._invalidate_client_caches(msg.inode, exclude_sid=session_id)
            return self._attr_reply(msg.req_id, fs.node(msg.inode))
        if isinstance(msg, m.CltomaTruncate):
            self._check_perm(fs.file_node(msg.inode), msg.uid, list(msg.gids), 2)
            if (msg.inode in self.meta.demoted
                    and not self._recall_writer_ok(msg.inode, session_id)):
                # tape-only content must be recalled before reshaping it
                return self._error_reply(msg, st.TAPE_RECALL)
            self.commit({"op": "set_length", "inode": msg.inode,
                         "length": msg.length, "ts": now})
            self._invalidate_client_caches(msg.inode, exclude_sid=session_id)
            return self._attr_reply(msg.req_id, fs.node(msg.inode))
        if isinstance(msg, m.CltomaOpen):
            node = fs.node(msg.inode)
            if node.ftype == fsmod.TYPE_FILE and session_id:
                # dedupe on (session, handle): the client RPC layer
                # retries over reconnects and acquire isn't idempotent
                handles = session.setdefault("open_handles", set())
                key = (msg.inode, msg.handle)
                if key not in handles:
                    handles.add(key)
                    self.commit({
                        "op": "acquire", "inode": msg.inode,
                        "sid": session_id,
                    })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaRelease):
            if session_id and session_id in self.meta.fs.open_refs.get(
                msg.inode, {}
            ):
                handles = session.setdefault("open_handles", set())
                key = (msg.inode, msg.handle)
                # release a registered handle exactly once; an UNKNOWN
                # handle (master restarted since the open: the in-memory
                # handle set died with the old process) still releases —
                # the persisted ref must be droppable after recovery
                if key in handles or not any(
                    i == msg.inode for i, _ in handles
                ):
                    handles.discard(key)
                    self.commit({
                        "op": "release", "inode": msg.inode,
                        "sid": session_id,
                    })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaReadChunk):
            return await self._read_chunk(msg, session.get("ip"), session_id)
        if isinstance(msg, m.CltomaWriteChunk):
            return await self._write_chunk(msg, session_id)
        if isinstance(msg, m.CltomaWriteChunkEnd):
            # invalidate FIRST and unconditionally: even a failed write
            # (non-OK status, or quota raise below) may have overwritten
            # chunkserver blocks already — a spurious push only costs
            # the readers a refetch
            self._invalidate_client_caches(
                msg.inode, msg.chunk_index, exclude_sid=session_id
            )
            return await self._write_chunk_end(msg)
        if isinstance(msg, m.CltomaWriteChunkEndBatch):
            # coalesced commit: seal every chunk the client's write
            # window finished since its last flush — one round trip
            # instead of one per chunk. Entries apply IN ORDER; the
            # first failure's status is reported, later VALID entries
            # still apply (their bytes are already on the chunkservers
            # and their locks must not outlive the batch). Entries
            # refused by the subtree check are NOT applied at all —
            # like the single-RPC path's EACCES, an unauthorized end
            # must not unlock a chunk some other client may be
            # writing; its lock expires by timeout.
            status = st.OK
            root = session.get("root", fsmod.ROOT_INODE)
            for e in msg.ends:
                if root != fsmod.ROOT_INODE and not self._in_subtree(
                    e.inode, root
                ):
                    # nested inodes bypass _apply_session_view's field
                    # remap — enforce the subtree export here
                    if status == st.OK:
                        status = st.EACCES
                    continue
                self._invalidate_client_caches(
                    e.inode, e.chunk_index, exclude_sid=session_id
                )
                try:
                    self._apply_write_chunk_end(
                        e.chunk_id, e.inode, e.file_length, e.status
                    )
                except fsmod.FsError as err:
                    if status == st.OK:
                        status = err.code
            return m.MatoclStatusReply(req_id=msg.req_id, status=status)
        if isinstance(msg, m.CltomaSnapshot):
            # no invalidation needed: a snapshot lands on a NEW inode
            # (apply_snapshot raises EEXIST on an existing name), so no
            # client can hold cached blocks for it
            return await self._snapshot(msg, now)
        if isinstance(msg, m.CltomaFileRepair):
            return self._file_repair(msg, now)
        if isinstance(msg, m.CltomaAppendChunks):
            return self._append_chunks(msg, now)
        if isinstance(msg, m.CltomaSetXattr):
            import base64

            self._check_perm(fs.node(msg.inode), msg.uid, list(msg.gids), 2)
            self.commit({
                "op": "set_xattr", "inode": msg.inode, "name": msg.name,
                "value": base64.b64encode(msg.value).decode(), "ts": now,
            })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaGetXattr):
            node = fs.node(msg.inode)
            self._check_perm(node, msg.uid, list(msg.gids), 4)
            if msg.name not in node.xattrs:
                return m.MatoclXattrReply(
                    req_id=msg.req_id, status=st.ENOATTR, value=b""
                )
            return m.MatoclXattrReply(
                req_id=msg.req_id, status=st.OK, value=node.xattrs[msg.name]
            )
        if isinstance(msg, m.CltomaListXattr):
            node = fs.node(msg.inode)
            return m.MatoclListXattr(
                req_id=msg.req_id, status=st.OK, names=sorted(node.xattrs)
            )
        if isinstance(msg, m.CltomaSetQuota):
            if msg.uid != 0:
                raise fsmod.FsError(st.EPERM, "setquota requires root")
            self.commit({
                "op": "set_quota", "kind": msg.kind, "owner_id": msg.owner_id,
                "soft_inodes": msg.soft_inodes, "hard_inodes": msg.hard_inodes,
                "soft_bytes": msg.soft_bytes, "hard_bytes": msg.hard_bytes,
                "remove": msg.remove,
            })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaGetQuota):
            rows = []
            gidset = set(msg.gids) if msg.uid != 0 else frozenset()
            for (kind, oid), e in sorted(self.meta.quotas.entries.items()):
                node = fs.nodes.get(oid) if kind == KIND_DIR else None
                if msg.uid != 0:
                    # non-root sees only its own rows: its user quota,
                    # its groups' quotas, and dir quotas it owns
                    if not (
                        (kind == KIND_USER and oid == msg.uid)
                        or (kind == KIND_GROUP and oid in gidset)
                        or (node is not None and node.uid == msg.uid)
                    ):
                        continue
                row = {"kind": kind, "id": oid, **e.to_dict()}
                if node is not None:
                    row["used_inodes"] = node.stat_inodes
                    row["used_bytes"] = node.stat_bytes
                rows.append(row)
            return m.MatoclQuotaReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(rows)
            )
        if isinstance(msg, m.CltomaLockOp):
            return self._lock_op(msg, session_id)
        if isinstance(msg, m.CltomaSetAcl):
            try:
                payload = json.loads(msg.json)
            except ValueError:
                return m.MatoclStatusReply(req_id=msg.req_id, status=st.EINVAL)
            from lizardfs_tpu_torch.master.acl import Acl

            for key in ("access", "default"):
                if payload.get(key) is not None:
                    Acl.from_dict(payload[key])  # validate shape
            node = fs.node(msg.inode)
            caller = getattr(msg, "uid", 0)
            if caller != 0 and caller != node.uid:
                raise fsmod.FsError(st.EPERM, "setfacl requires ownership")
            self.commit({
                "op": "set_acl", "inode": msg.inode,
                "access": payload.get("access"),
                "default": payload.get("default"), "ts": now,
            })
            # ACL changes revoke permissions like a chmod does: push
            self._invalidate_client_caches(msg.inode, exclude_sid=session_id)
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaSetRichAcl):
            from lizardfs_tpu_torch.master.richacl import RichAcl

            try:
                payload = json.loads(msg.json) if msg.json else None
                racl = None
                if payload is not None:
                    if not isinstance(payload, dict) or not isinstance(
                        payload.get("aces"), list
                    ):
                        raise ValueError("acl payload must be {aces: [...]}")
                    racl = RichAcl.from_dict(payload)
            except (ValueError, KeyError, TypeError, AttributeError):
                return m.MatoclStatusReply(req_id=msg.req_id, status=st.EINVAL)
            node = fs.node(msg.inode)
            caller = getattr(msg, "uid", 0)
            if caller != 0 and caller != node.uid:
                raise fsmod.FsError(st.EPERM, "setrichacl requires ownership")
            self.commit({
                "op": "set_rich_acl", "inode": msg.inode,
                # normalized form only — never persist unvalidated keys
                "acl": racl.to_dict() if racl is not None else None,
                "ts": now,
            })
            self._invalidate_client_caches(msg.inode, exclude_sid=session_id)
            if racl is not None:
                # publish the ACL's per-class grant unions as the mode
                # (richacl_compute_max_masks analog) so the mode masks
                # do not immediately cap a freshly set ACL
                o, g, oth = racl.compute_max_masks(node.uid)
                new_mode = (node.mode & ~0o777) | (o << 6) | (g << 3) | oth
                if new_mode != node.mode:
                    self.commit({
                        "op": "setattr", "inode": msg.inode, "set_mask": 1,
                        "mode": new_mode, "uid": node.uid, "gid": node.gid,
                        "atime": node.atime, "mtime": node.mtime, "ts": now,
                    })
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        if isinstance(msg, m.CltomaGetRichAcl):
            node = fs.node(msg.inode)
            return m.MatoclAclReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({"rich": node.rich_acl}),
            )
        if isinstance(msg, m.CltomaGetAcl):
            node = fs.node(msg.inode)
            return m.MatoclAclReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({
                    "access": node.acl, "default": node.default_acl,
                    "mode": node.mode, "uid": node.uid, "gid": node.gid,
                }),
            )
        if isinstance(msg, m.CltomaAccess):
            from lizardfs_tpu_torch.master import acl as acl_mod

            node = fs.node(msg.inode)
            # access decisions are cached gateway-side (NFS _access):
            # watch the session so a permission change pushes the
            # cached verdict stale instead of letting it ride the TTL
            self._note_watcher(msg.inode, session_id)
            ok = self._access_ok(node, msg.uid, list(msg.gids), msg.mask)
            return m.MatoclStatusReply(
                req_id=msg.req_id, status=st.OK if ok else st.EACCES
            )
        if isinstance(msg, m.CltomaIoLimitRequest):
            active = 1 if (self.io_limits or self.io_limit_bps > 0) else 0
            if getattr(msg, "probe", 0):
                # pure status query: answer limits_active without
                # registering the session in the allocation table
                return m.MatoclIoLimitReply(
                    req_id=msg.req_id, status=st.OK, bytes_per_sec=0,
                    renew_ms=10_000, subsystem=self.io_limit_subsystem,
                    limits_active=active,
                )
            if self.io_limits:
                # per-cgroup budgets: resolve the claimed group to its
                # closest configured ancestor, then share that group's
                # budget among the sessions renewing under it
                from lizardfs_tpu_torch.utils.io_limits import (
                    UNCLASSIFIED, resolve_limit,
                )

                key, bps = resolve_limit(
                    msg.group or UNCLASSIFIED, self.io_limits
                )
                if bps <= 0:
                    return m.MatoclIoLimitReply(
                        req_id=msg.req_id, status=st.OK, bytes_per_sec=0,
                        renew_ms=10_000, subsystem=self.io_limit_subsystem,
                        limits_active=active,
                    )
                share = self._io_limit_share(session_id, key, bps)
                return m.MatoclIoLimitReply(
                    req_id=msg.req_id, status=st.OK, bytes_per_sec=share,
                    renew_ms=1000, subsystem=self.io_limit_subsystem,
                    limits_active=active,
                )
            if self.io_limit_bps <= 0:
                return m.MatoclIoLimitReply(
                    req_id=msg.req_id, status=st.OK, bytes_per_sec=0,
                    renew_ms=10_000, subsystem="", limits_active=0,
                )
            share = self._io_limit_share(session_id, "", self.io_limit_bps)
            return m.MatoclIoLimitReply(
                req_id=msg.req_id, status=st.OK, bytes_per_sec=share,
                renew_ms=1000, subsystem="", limits_active=1,
            )
        if isinstance(msg, m.CltomaTrashList):
            rows = [
                {"inode": inode, "name": name, "expires": exp, "parent": parent}
                for inode, (name, exp, parent) in sorted(fs.trash.items())
                if msg.uid == 0
                or (fs.nodes.get(inode) is not None
                    and fs.nodes[inode].uid == msg.uid)
            ]
            return m.MatoclTrashList(
                req_id=msg.req_id, status=st.OK, json=json.dumps(rows)
            )
        if isinstance(msg, m.CltomaUndelete):
            if msg.inode not in fs.trash:
                return m.MatoclStatusReply(req_id=msg.req_id, status=st.ENOENT)
            node = fs.nodes.get(msg.inode)
            # fail closed: an unresolvable trash entry is nobody's to restore
            if msg.uid != 0 and (node is None or msg.uid != node.uid):
                raise fsmod.FsError(st.EPERM, "undelete requires ownership")
            self.commit({"op": "undelete", "inode": msg.inode, "ts": now})
            return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)
        return m.MatoclStatusReply(req_id=getattr(msg, "req_id", 0), status=st.EINVAL)

    def _lock_op(self, msg: m.CltomaLockOp, session_id: int):
        inode, token = msg.inode, msg.token
        self.meta.fs.file_node(inode)  # must exist and be a file
        if msg.op == 2:  # test (F_GETLK); checks both spaces
            conflict = self.meta.locks.test(
                inode, session_id, token, msg.start, msg.end, msg.ltype
            ) or self.meta.locks.test_flock(
                inode, session_id, token, msg.ltype
            )
            return m.MatoclLockReply(
                req_id=msg.req_id,
                status=st.OK if conflict is None else st.LOCKED,
            )
        p = {
            "kind": "flock" if msg.op == 1 else "posix",
            "sid": session_id, "token": token,
            "start": msg.start, "end": msg.end, "ltype": msg.ltype,
        }
        if self._lock_conflict(inode, p) is None:
            self._commit_lock(inode, p)
            if msg.ltype == LOCK_UNLOCK:
                # an unlock also cancels this owner's queued requests in
                # the range (a waiter that gave up aborts cleanly)
                queue = self._pending_locks.get(inode, [])
                end = msg.end or MAX_OFFSET
                queue[:] = [
                    q for q in queue
                    if not (q["sid"] == session_id and q["token"] == token
                            and q["kind"] == p["kind"]
                            and (q["kind"] == "flock"
                                 or (q["start"] < end
                                     and msg.start < (q["end"] or MAX_OFFSET))))
                ]
            # any successful change can free capacity (full unlock, but
            # also downgrades and range narrowing) — retry waiters
            self._grant_pending_locks(inode)
            ok = True
        else:
            if msg.wait:
                self._pending_locks.setdefault(inode, []).append(p)
            ok = False
        return m.MatoclLockReply(
            req_id=msg.req_id, status=st.OK if ok else st.LOCKED
        )

    def _file_repair(self, msg: m.CltomaFileRepair, now: int):
        """`lizardfs filerepair` (file_repair.cc analog): walk the
        file's chunks; readable-but-degraded chunks route through the
        RebuildEngine (rebuilt, never zeroed), unreadable chunks are
        version-fixed from retained stale-version parts when coverage
        allows, and only truly unrecoverable chunks are zero-filled."""
        fs = self.meta.fs
        node = fs.file_node(msg.inode)
        if not self._owns(node, msg.uid):
            raise fsmod.FsError(st.EPERM, "filerepair requires ownership")
        registry = self.meta.registry
        counts = {"repaired_versions": 0, "zeroed": 0,
                  "queued_rebuild": 0, "ok_chunks": 0}
        mutated = False
        for idx, cid in enumerate(list(node.chunks)):
            if cid == 0:
                continue
            chunk = registry.chunks.get(cid)
            if chunk is None:
                # metadata references a chunk the registry no longer
                # knows — the slot can only be zero-filled
                self.commit({"op": "repair_zero_chunk",
                             "inode": msg.inode, "chunk_index": idx,
                             "ts": now})
                counts["zeroed"] += 1
                mutated = True
                continue
            state = registry.evaluate(chunk)
            if state.is_readable:
                if state.needs_work:
                    # repairable: rebuilt through the engine, not zeroed
                    registry.mark_endangered(cid)
                    counts["queued_rebuild"] += 1
                else:
                    counts["ok_chunks"] += 1
                continue
            if self._repair_chunk_version(chunk):
                counts["repaired_versions"] += 1
                registry.mark_endangered(cid)
                mutated = True
                continue
            self.commit({"op": "repair_zero_chunk", "inode": msg.inode,
                         "chunk_index": idx, "ts": now})
            counts["zeroed"] += 1
            mutated = True
        if mutated:
            self._invalidate_client_caches(msg.inode)
        return m.MatoclFileRepair(
            req_id=msg.req_id, status=st.OK, json=json.dumps(counts)
        )

    def _repair_chunk_version(self, chunk) -> bool:
        """Version-fix an unreadable chunk: adopt the newest retained
        stale version whose surviving parts restore readability
        (file_repair.cc correct-version mode). The parts are already on
        disk at that version, so adopting is pure metadata."""
        registry = self.meta.registry
        stale = registry.stale_versions.get(chunk.chunk_id)
        if not stale:
            return False
        t = geometry.SliceType(chunk.slice_type)
        need = 1 if t.is_standard else geometry.required_parts_to_recover(t)
        by_ver: dict[int, list[tuple[int, int]]] = {}
        for (cs_id, part_id), ver in stale.items():
            srv = registry.servers.get(cs_id)
            if srv is None or not srv.connected:
                continue
            cpt = geometry.ChunkPartType.from_id(part_id)
            if int(cpt.type) != chunk.slice_type:
                continue
            by_ver.setdefault(ver, []).append((cs_id, cpt.part))
        for ver in sorted(by_ver, reverse=True):
            if len({p for _, p in by_ver[ver]}) < need:
                continue
            # parts still registered at the CURRENT version become the
            # wrong-version ones after the adoption: unregister them
            # (a mixed-version location set would serve WRONG_VERSION
            # on reads while evaluate() counts the chunk healthy) and
            # retain them as stale material in their turn
            old_holders = set(chunk.parts)
            if old_holders:
                t_cur = geometry.SliceType(chunk.slice_type)
                registry.unregister_parts(chunk, old_holders)
                for cs_id, part in old_holders:
                    registry.record_stale(
                        chunk.chunk_id, cs_id,
                        geometry.ChunkPartType(t_cur, part).id,
                        chunk.version,
                    )
            self.commit({"op": "bump_chunk_version",
                         "chunk_id": chunk.chunk_id, "version": ver})
            for cs_id, part in by_ver[ver]:
                registry.record_part(chunk, cs_id, part)
            for key in [k for k, v in stale.items() if v == ver]:
                del stale[key]
            if not stale:
                registry.stale_versions.pop(chunk.chunk_id, None)
            self.log.info(
                "filerepair: chunk %d version-fixed to v%d (%d parts)",
                chunk.chunk_id, ver, len(by_ver[ver]),
            )
            return True
        return False

    def _append_chunks(self, msg: m.CltomaAppendChunks, now: int):
        """`lizardfs appendchunks` (append_file.cc analog): O(1)
        concatenation — dst is padded to a chunk boundary and src's
        chunks are SHARED onto its tail through the snapshot refcount
        machinery; a later write to either side COWs the chunk."""
        fs = self.meta.fs
        src = fs.file_node(msg.inode_src)
        dst = fs.file_node(msg.inode_dst)
        if msg.inode_src == msg.inode_dst:
            return self._error_reply(msg, st.EINVAL)
        ident = (msg.uid, list(msg.gids))
        self._check_perm(src, *ident, 4)
        self._check_perm(dst, *ident, 2)
        if (msg.inode_src in self.meta.demoted
                or msg.inode_dst in self.meta.demoted):
            # a demoted side holds no chunks to share: concat would
            # fabricate holes where tape-only bytes belong
            return self._error_reply(msg, st.TAPE_RECALL)
        padded = (
            (dst.length + MFSCHUNKSIZE - 1) // MFSCHUNKSIZE * MFSCHUNKSIZE
        )
        parent = dst.parents[0] if dst.parents else fsmod.ROOT_INODE
        self._check_quota(
            parent, dst.uid, dst.gid, 0, padded + src.length - dst.length
        )
        # a write in flight on EITHER file must not race the concat:
        # a locked chunk is mid-mutation, and a dst chunk attached past
        # the length-implied boundary is a concurrent write that
        # WriteChunkEnd has not sealed yet — the padding would land on
        # top of it (set_length's "never drop chunks" invariant)
        if len(dst.chunks) > (
            (dst.length + MFSCHUNKSIZE - 1) // MFSCHUNKSIZE
        ):
            return self._error_reply(msg, st.CHUNK_BUSY)
        for cid in (*src.chunks, *dst.chunks):
            chunk = self.meta.registry.chunks.get(cid) if cid else None
            if chunk is not None and chunk.locked_until > time.monotonic():
                return self._error_reply(msg, st.CHUNK_BUSY)
        self.commit({"op": "append_chunks", "inode_dst": msg.inode_dst,
                     "inode_src": msg.inode_src, "ts": now})
        self._invalidate_client_caches(msg.inode_dst, exclude_sid=None)
        return self._attr_reply(msg.req_id, fs.node(msg.inode_dst))

    async def _snapshot(self, msg: m.CltomaSnapshot, now: int):
        fs = self.meta.fs
        src = fs.node(msg.src_inode)
        ident = (getattr(msg, "uid", 0), list(getattr(msg, "gids", [0])))
        self._check_perm(src, *ident, 4)
        if self.meta.demoted:
            # a demoted file in the subtree holds no chunks to share —
            # its clone would silently read zeros; recall first
            stack = [src.inode]
            while stack:
                cur = stack.pop()
                if cur in self.meta.demoted:
                    return self._error_reply(msg, st.TAPE_RECALL)
                n = fs.nodes.get(cur)
                if n is not None and n.ftype == fsmod.TYPE_DIR:
                    stack.extend(n.children.values())
        self._check_perm(fs.dir_node(msg.dst_parent), *ident, 2 | 1)
        wi, wb = fs._node_weight(src)
        self._check_quota(msg.dst_parent, src.uid, src.gid, wi, wb)
        # pre-assign all clone inodes so replay is deterministic
        inode_map: dict[str, int] = {}

        def assign(node):
            inode_map[str(node.inode)] = fs.alloc_inode()
            if node.ftype == fsmod.TYPE_DIR:
                for child in sorted(node.children.values()):
                    assign(fs.node(child))

        assign(src)
        self.commit({
            "op": "snapshot", "src_inode": msg.src_inode,
            "dst_parent": msg.dst_parent, "dst_name": msg.dst_name,
            "inode_map": inode_map, "ts": now,
        })
        return self._attr_reply(
            msg.req_id, fs.node(inode_map[str(msg.src_inode)])
        )

    def _attr_reply(self, req_id: int, node) -> m.MatoclAttrReply:
        return m.MatoclAttrReply(req_id=req_id, status=st.OK, attr=_attr_of(node))

    def _locations_of(self, chunk, client_ip: str | None = None) -> list[m.PartLocation]:
        """Part locations, same-rack servers first (topology read
        locality, topology.h:25 analog)."""
        t = geometry.SliceType(chunk.slice_type)
        rows = []
        for cs_id, part in sorted(chunk.parts):
            srv = self.meta.registry.servers.get(cs_id)
            if srv is None or not srv.connected:
                continue
            dist = (
                self.topology.distance(client_ip, srv.host)
                if client_ip else 0
            )
            # equal part+distance replicas rank by observed load (heat
            # share + queue depth + health): readers drain toward the
            # cold copy a goal boost just created instead of piling
            # onto the server that made the chunk hot. server_load is
            # empty with LZ_HEAT off, keeping the pre-heat ordering.
            load = self.meta.registry.server_load.get(cs_id, 0.0)
            rows.append((part, dist, load, srv))
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        return [
            m.PartLocation(
                addr=m.Addr(host=srv.host, port=srv.data_addr_port),
                part_id=geometry.ChunkPartType(t, part).id,
            )
            for part, _, _, srv in rows
        ]

    # how long a locate keeps a session subscribed to invalidations;
    # must exceed the client cache TTL (3 s) so every cache fast-path
    # hit is covered by a still-live watch
    CACHE_WATCH_TTL = 60.0

    async def _read_watcher_sweep(self) -> None:
        """Expire idle watch subscriptions — without this, one dict
        entry per inode ever read would accumulate for the master's
        lifetime."""
        now = time.monotonic()
        for inode in list(self._read_watchers):
            watchers = self._read_watchers[inode]
            for sid in [
                s for s, ts in watchers.items()
                if now - ts > self.CACHE_WATCH_TTL
                or s not in self._session_writers
            ]:
                del watchers[sid]
            if not watchers:
                del self._read_watchers[inode]

    def _note_watcher(self, inode: int, session_id: int) -> None:
        """Subscribe a session to ``inode``'s invalidation pushes (it
        just read something cacheable about the inode: chunk
        locations, attrs, or an access verdict)."""
        if session_id:
            self._read_watchers.setdefault(inode, {})[session_id] = (
                time.monotonic()
            )

    def _invalidate_client_caches(
        self, inode: int, chunk_index: int = 0xFFFFFFFF,
        exclude_sid: int | None = None,
    ) -> None:
        """Push MatoclCacheInvalidate to every session that recently
        located chunks of ``inode``, except the mutator (its own cache
        was already updated client-side). Reference analog:
        src/master/matoclserv.cc data-cache invalidation."""
        watchers = self._read_watchers.get(inode)
        if not watchers:
            return
        now = time.monotonic()
        dead = []
        for sid, ts in watchers.items():
            if now - ts > self.CACHE_WATCH_TTL:
                dead.append(sid)
                continue
            if sid == exclude_sid:
                continue
            w = self._session_writers.get(sid)
            if w is None:
                dead.append(sid)
                continue
            try:
                framing.write_message(
                    w,
                    m.MatoclCacheInvalidate(
                        inode=inode, chunk_index=chunk_index,
                        # raises the watcher's monotonic-reads floor so
                        # its next read can't be served pre-mutation by
                        # a lagging replica
                        meta_version=self.changelog.version,
                    ),
                )
            except (ConnectionError, RuntimeError):
                dead.append(sid)
        for sid in dead:
            watchers.pop(sid, None)
        if not watchers:
            self._read_watchers.pop(inode, None)

    async def _read_chunk(
        self, msg: m.CltomaReadChunk, client_ip: str | None = None,
        session_id: int = 0,
    ):
        node = self.meta.fs.file_node(msg.inode)
        self._check_perm(node, msg.uid, list(msg.gids), 4)
        if msg.inode in self.meta.demoted:
            # tape-only data: kick the recall (idempotent single-flight)
            # and refuse with the transient status — a reader that
            # waits (CltomaTapeRecall) or simply retries later succeeds
            # once the archive streamed back
            self._ensure_recall(msg.inode)
            return m.MatoclReadChunk(
                req_id=msg.req_id, status=st.TAPE_RECALL, chunk_id=0,
                version=0, file_length=node.length, locations=[],
            )
        self._note_watcher(msg.inode, session_id)
        chunk_id = (
            node.chunks[msg.chunk_index] if msg.chunk_index < len(node.chunks) else 0
        )
        if chunk_id == 0:
            # hole: no chunk — client reads zeros
            return m.MatoclReadChunk(
                req_id=msg.req_id, status=st.OK, chunk_id=0, version=0,
                file_length=node.length, locations=[],
            )
        chunk = self.meta.registry.chunk(chunk_id)
        # heat map, chunk kind, ops only: the real byte weight arrives
        # via chunkserver heartbeat folds — this keeps a hot chunk
        # tracked even between folds
        if constants_mod.heat_enabled():
            self.heat.charge("chunk", chunk_id)
        return m.MatoclReadChunk(
            req_id=msg.req_id, status=st.OK, chunk_id=chunk_id,
            version=chunk.version, file_length=node.length,
            locations=self._locations_of(chunk, client_ip),
        )

    async def _write_chunk(self, msg: m.CltomaWriteChunk,
                           session_id: int = 0):
        node = self.meta.fs.file_node(msg.inode)
        self._check_perm(node, msg.uid, list(msg.gids), 2)
        if (msg.inode in self.meta.demoted
                and not self._recall_writer_ok(msg.inode, session_id)):
            # tape-only file: recall before mutating (only the
            # recalling tape server's session may write mid-restore)
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=st.TAPE_RECALL, chunk_id=0,
                version=0, file_length=0, locations=[],
            )
        chunk_id = (
            node.chunks[msg.chunk_index] if msg.chunk_index < len(node.chunks) else 0
        )
        if chunk_id == 0:
            return await self._create_new_chunk(msg, node)
        chunk = self.meta.registry.chunk(chunk_id)
        if constants_mod.heat_enabled():
            # chunk-kind heat, ops only (bytes ride the CS folds)
            self.heat.charge("chunk", chunk_id)
        if chunk.locked_until > time.monotonic():
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=st.CHUNK_BUSY, chunk_id=0, version=0,
                file_length=0, locations=[],
            )
        if chunk.refcount > 1:
            # snapshot-shared chunk: copy-on-write before mutating
            return await self._cow_chunk(msg, node, chunk)
        # version bump so stale copies are detectable (chunk lock + bump,
        # matoclserv.cc fuse_write_chunk semantics)
        new_version = chunk.version + 1
        holders = sorted(chunk.parts)
        t = geometry.SliceType(chunk.slice_type)
        acks = []
        for cs_id, part in holders:
            link = self.cs_links.get(cs_id)
            if link is None:
                acks.append((cs_id, part, None))
                continue
            acks.append((
                cs_id, part,
                link.command(
                    m.MatocsSetVersion,
                    chunk_id=chunk_id,
                    old_version=chunk.version,
                    new_version=new_version,
                    part_id=geometry.ChunkPartType(t, part).id,
                ),
            ))
        ok_holders: list[tuple[int, int]] = []
        live = [(cs_id, part, coro) for cs_id, part, coro in acks
                if coro is not None]
        replies = await asyncio.gather(
            *(coro for _, _, coro in live), return_exceptions=True
        )
        for (cs_id, part, _), reply in zip(live, replies):
            if isinstance(reply, (ConnectionError, asyncio.TimeoutError)):
                continue  # missed the bump: dropped as stale below
            if isinstance(reply, BaseException):
                raise reply  # protocol/programming error: surface it
            if reply.status == st.OK:
                ok_holders.append((cs_id, part))
        if not ok_holders:
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=st.NO_CHUNK_SERVERS, chunk_id=0,
                version=0, file_length=0, locations=[],
            )
        # copies that missed the bump are stale: unregister them so the
        # reply's locations are all at new_version, and queue re-repair
        stale = chunk.parts - set(ok_holders)
        if stale:
            self.meta.registry.unregister_parts(chunk, stale)
            self.meta.registry.mark_endangered(chunk_id)
        self.commit({
            "op": "bump_chunk_version", "chunk_id": chunk_id, "version": new_version,
        })
        chunk.locked_until = time.monotonic() + CHUNK_LOCK_SECONDS
        return m.MatoclWriteChunk(
            req_id=msg.req_id, status=st.OK, chunk_id=chunk_id,
            version=new_version, file_length=node.length,
            locations=self._locations_of(chunk),
        )

    async def _cow_chunk(self, msg: m.CltomaWriteChunk, node, chunk):
        """Duplicate a snapshot-shared chunk on its part holders, point
        the file at the private copy, then grant the write on it."""
        new_id = self.meta.registry.next_chunk_id
        self.meta.registry.next_chunk_id = new_id + 1
        t = geometry.SliceType(chunk.slice_type)
        version = 1
        acks = []
        for cs_id, part in sorted(chunk.parts):
            link = self.cs_links.get(cs_id)
            if link is None:
                continue
            acks.append((
                cs_id, part,
                link.command(
                    m.MatocsDuplicateChunk,
                    chunk_id=new_id, version=version,
                    part_id=geometry.ChunkPartType(t, part).id,
                    src_chunk_id=chunk.chunk_id, src_version=chunk.version,
                ),
            ))
        created = []
        for cs_id, part, coro in acks:
            try:
                reply = await coro
                if reply.status == st.OK:
                    created.append((cs_id, part))
            except (ConnectionError, asyncio.TimeoutError):
                pass
        # the duplicate set must be READABLE (any k distinct parts for
        # striped slices, >=1 copy for std); missing redundancy is
        # rebuilt by the health loop on the new chunk — a single down
        # replica must not block writes to a snapshot-shared chunk
        distinct = {part for _, part in created}
        needed = (
            geometry.required_parts_to_recover(t) if not t.is_standard else 1
        )
        if len(distinct) < needed:
            for cs_id, part in created:
                link = self.cs_links.get(cs_id)
                if link is not None:
                    try:
                        await link.command(
                            m.MatocsDeleteChunk, chunk_id=new_id,
                            version=version,
                            part_id=geometry.ChunkPartType(t, part).id,
                        )
                    except (ConnectionError, asyncio.TimeoutError):
                        pass
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=st.NO_CHUNK_SERVERS, chunk_id=0,
                version=0, file_length=0, locations=[],
            )
        self.commit({
            "op": "cow_chunk", "inode": msg.inode, "chunk_index": msg.chunk_index,
            "old_chunk_id": chunk.chunk_id, "new_chunk_id": new_id,
            "slice_type": chunk.slice_type, "version": version,
            "copies": chunk.copies, "goal_id": chunk.goal_id,
        })
        new_chunk = self.meta.registry.chunk(new_id)
        for cs_id, part in created:
            self.meta.registry.record_part(new_chunk, cs_id, part)
        new_chunk.locked_until = time.monotonic() + CHUNK_LOCK_SECONDS
        if self.meta.registry.evaluate(new_chunk).needs_work:
            self.meta.registry.mark_endangered(new_id)
        self.log.info(
            "COW: chunk %d -> %d for inode %d", chunk.chunk_id, new_id, msg.inode
        )
        return m.MatoclWriteChunk(
            req_id=msg.req_id, status=st.OK, chunk_id=new_id, version=version,
            file_length=node.length, locations=self._locations_of(new_chunk),
        )

    def _slice_type_for_goal(self, goal_id: int) -> geometry.SliceType:
        goal = self.goals.get(goal_id)
        s = goal.disk_slice() if goal is not None else None
        if s is None:
            return geometry.SliceType(geometry.STANDARD)
        return s.type

    def _labels_for_goal(
        self, goal_id: int, t: geometry.SliceType, part_list: list[int]
    ) -> list[str]:
        """Per-slot placement labels from the goal definition."""
        goal = self.goals.get(goal_id)
        s = goal.disk_slice() if goal is not None else None
        if s is None:
            return ["_"] * len(part_list)
        if t.is_standard:
            out: list[str] = []
            for label, count in sorted(s.labels_of_part(0).items()):
                out.extend([label] * count)
            out = out[: len(part_list)]
            return out + ["_"] * (len(part_list) - len(out))
        return [
            next(iter(s.labels_of_part(p)), "_") if p < s.size else "_"
            for p in part_list
        ]

    async def _create_new_chunk(self, msg: m.CltomaWriteChunk, node):
        t = self._slice_type_for_goal(node.goal)
        goal = self.goals.get(node.goal)
        copies = goal.expected_copies() if (goal and t.is_standard) else 1
        # std goals: N copies of part 0; xor/ec: one copy of each part
        part_list = [0] * copies if t.is_standard else list(range(t.expected_parts))
        nparts = len(part_list)
        try:
            servers = self.meta.registry.choose_servers(
                nparts, labels=self._labels_for_goal(node.goal, t, part_list)
            )
        except ValueError:
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=st.NO_CHUNK_SERVERS, chunk_id=0,
                version=0, file_length=0, locations=[],
            )
        # reserve the id immediately — the awaits below suspend this
        # coroutine and a concurrent create must not reuse it
        chunk_id = self.meta.registry.next_chunk_id
        self.meta.registry.next_chunk_id = chunk_id + 1
        version = 1
        # command part creation on each server first; registry mutation is
        # committed only after at least the data parts exist
        acks = []
        for part, srv in zip(part_list, servers):
            link = self.cs_links.get(srv.cs_id)
            if link is None:
                continue
            acks.append((
                part, srv,
                link.command(
                    m.MatocsCreateChunk,
                    chunk_id=chunk_id, version=version,
                    part_id=geometry.ChunkPartType(t, part).id,
                ),
            ))
        created: list[tuple[int, ChunkServerInfo]] = []
        replies = await asyncio.gather(
            *(coro for _, _, coro in acks), return_exceptions=True
        )
        for (part, srv, _), reply in zip(acks, replies):
            if isinstance(reply, (ConnectionError, asyncio.TimeoutError)):
                continue  # that server just doesn't get the part
            if isinstance(reply, BaseException):
                raise reply  # protocol/programming error: surface it
            if reply.status == st.OK:
                created.append((part, srv))
        if len(created) < nparts:
            # roll back whatever was created
            for part, srv in created:
                link = self.cs_links.get(srv.cs_id)
                if link is not None:
                    try:
                        await link.command(
                            m.MatocsDeleteChunk, chunk_id=chunk_id,
                            version=version,
                            part_id=geometry.ChunkPartType(t, part).id,
                        )
                    except (ConnectionError, asyncio.TimeoutError):
                        pass
            return m.MatoclWriteChunk(
                req_id=msg.req_id, status=st.NO_CHUNK_SERVERS, chunk_id=0,
                version=0, file_length=0, locations=[],
            )
        self.commit({
            "op": "create_chunk", "chunk_id": chunk_id,
            "slice_type": int(t), "version": version, "copies": copies,
            "goal_id": node.goal,
        })
        self.commit({
            "op": "set_chunk", "inode": msg.inode,
            "chunk_index": msg.chunk_index, "chunk_id": chunk_id,
        })
        chunk = self.meta.registry.chunk(chunk_id)
        for part, srv in created:
            self.meta.registry.record_part(chunk, srv.cs_id, part)
        chunk.locked_until = time.monotonic() + CHUNK_LOCK_SECONDS
        return m.MatoclWriteChunk(
            req_id=msg.req_id, status=st.OK, chunk_id=chunk_id, version=version,
            file_length=node.length, locations=self._locations_of(chunk),
        )

    async def _write_chunk_end(self, msg: m.CltomaWriteChunkEnd):
        self._apply_write_chunk_end(
            msg.chunk_id, msg.inode, msg.file_length, msg.status
        )
        return m.MatoclStatusReply(req_id=msg.req_id, status=st.OK)

    def _apply_write_chunk_end(
        self, chunk_id: int, inode: int, file_length: int, status: int
    ) -> None:
        """Seal one chunk's write: unlock, re-evaluate redundancy, and
        (on a clean end) journal the length/mtime. Shared by the
        per-chunk RPC and the coalesced CltomaWriteChunkEndBatch."""
        chunk = self.meta.registry.chunks.get(chunk_id)
        if chunk is not None:
            chunk.locked_until = 0.0
            state = self.meta.registry.evaluate(chunk)
            if state.needs_work:
                self.meta.registry.mark_endangered(chunk_id)
        if status == st.OK:
            node = self.meta.fs.file_node(inode)
            if file_length > node.length:
                delta = file_length - node.length
                parent = node.parents[0] if node.parents else fsmod.ROOT_INODE
                self._check_quota(parent, node.uid, node.gid, 0, delta)
            # journal every completed write (the reference logs a
            # LENGTH/WRITE line per write too): updates mtime and the
            # content generation, so tape staleness and shadow replay
            # see in-place overwrites, not just growth.
            # write-path grow: never drop chunks — a concurrent write
            # may have attached a higher chunk index already
            self.commit({
                "op": "set_length", "inode": inode,
                "length": max(file_length, node.length),
                "ts": int(time.time()), "drop_chunks": False,
            })

    # --- chunkserver service (matocsserv analog) --------------------------------------

    # registration ingest slice: a 10k-server storm piles up megapart
    # reports; apply them in slices with yield points so client service
    # keeps running between slices (stall-watchdog pinned in the storm
    # test)
    REGISTER_INGEST_SLICE = 4096

    async def _ingest_parts(
        self, cs_id: int, infos, collect_stale: bool
    ) -> list:
        """Apply a registration's part report in slices, yielding the
        event loop between slices (chunked apply — one 1M-part report
        must not stall every other connection for its whole walk)."""
        stale = []
        registry = self.meta.registry
        for i, info in enumerate(infos):
            if not registry.add_part(
                info.chunk_id, cs_id, info.part_id, info.version
            ):
                if collect_stale:
                    stale.append(info)
                if info.chunk_id >= registry.next_chunk_id:
                    # an orphan of a create whose commit never landed: a
                    # chunk issued under its id at version 1 would take
                    # these parts for its own
                    registry.next_chunk_id = info.chunk_id + 1
            if (i + 1) % self.REGISTER_INGEST_SLICE == 0:
                await asyncio.sleep(0)
        return stale

    async def _cs_loop(self, reader, writer, first: m.CstomaRegister) -> None:
        if not self.is_active:
            if (
                self.personality == "shadow"
                and shadow_reads_enabled()
                and getattr(first, "mirror", 0)
            ):
                # passive mirror registration: the shadow learns part
                # locations (volatile state the changelog cannot carry)
                # so replica locates have locations to serve; it never
                # commands the chunkserver. Non-mirror registrations
                # still get NOT_POSSIBLE — the chunkserver's command
                # link must keep cycling until it finds the active.
                await self._mirror_cs_loop(reader, writer, first)
                return
            await framing.send_message(
                writer,
                m.MatocsRegisterReply(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, cs_id=0,
                    epoch=self.meta.epoch,
                ),
            )
            return
        if getattr(first, "mirror", 0):
            # a mirror link never carries commands; the ACTIVE must not
            # adopt one as a command link (its pushes would be dropped
            # by the peer's pump) — refuse so the chunkserver backs off.
            # The refusal CARRIES our epoch: a chunkserver mirror-dialing
            # a freshly promoted master learns of the election from this
            # very reply and flips the address mirror->command (fencing
            # its old command link to the deposed ex-primary).
            await framing.send_message(
                writer,
                m.MatocsRegisterReply(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, cs_id=0,
                    epoch=self.meta.epoch,
                ),
            )
            return
        if self.observe_peer_epoch(getattr(first, "epoch", 0)):
            # this chunkserver has seen a newer master — we just fenced
            # ourselves; refuse so its link cycles to the real active
            await framing.send_message(
                writer,
                m.MatocsRegisterReply(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, cs_id=0,
                    epoch=self.meta.epoch,
                ),
            )
            return
        link = _CsLink(self, reader, writer)
        srv = self.meta.registry.register_server(
            first.addr.host, first.addr.port, first.label,
            first.total_space, first.used_space,
            data_port=getattr(first, "data_port", 0),
        )
        srv.mirror = False  # command link (a promoted shadow's entry
        # for this addr may still carry the mirror flag)
        link.cs_id = srv.cs_id
        self.cs_links[srv.cs_id] = link
        stale: list[m.ChunkPartInfo] = await self._ingest_parts(
            srv.cs_id, first.chunks, collect_stale=True
        )
        await framing.send_message(
            writer,
            m.MatocsRegisterReply(
                req_id=first.req_id, status=st.OK, cs_id=srv.cs_id,
                epoch=self.meta.epoch,
            ),
        )
        self.log.info(
            "chunkserver %d registered (%s:%d, %d parts, %d stale)",
            srv.cs_id, srv.host, srv.port, len(first.chunks), len(stale),
        )
        for info in stale:
            # a wrong-version part of a chunk that is currently
            # UNREADABLE is the only repair material `filerepair` has —
            # keep it on disk and remember it instead of deleting
            # (normal stale copies, e.g. bump stragglers of a healthy
            # chunk, are reclaimed as before)
            chunk = self.meta.registry.chunks.get(info.chunk_id)
            if (
                chunk is not None
                and not self.meta.registry.evaluate(chunk).is_readable
            ):
                self.meta.registry.record_stale(
                    info.chunk_id, srv.cs_id, info.part_id, info.version
                )
                stale_vers = self.meta.registry.stale_versions[info.chunk_id]
                if (min(stale_vers.values()) > chunk.version
                        and self._repair_chunk_version(chunk)):
                    # every retained part a version ahead of the
                    # metadata: a master died between its chunkservers'
                    # version bump and the bump's commit. Adopt the
                    # parts' version, as filerepair does, so the file
                    # reads and writes again
                    self.meta.registry.mark_endangered(info.chunk_id)
                continue
            self.spawn(self._delete_stale(link, info))
        try:
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if not self.is_active:
                    # demoted mid-link (fenced, or lost an election):
                    # a shadow must never hold a command link — close
                    # so the chunkserver's heartbeat loop re-cycles the
                    # address list and finds the new active
                    break
                if isinstance(msg, m.CstomaChunkOpStatus):
                    link.dispatch_ack(msg)
                elif isinstance(msg, m.CstomaHeartbeat):
                    if self.observe_peer_epoch(getattr(msg, "epoch", 0)):
                        # the chunkserver heard of a newer election than
                        # we did (its heartbeat echoes the max epoch it
                        # has observed) — we just stepped down; drop the
                        # command link instead of acking as active
                        break
                    srv.total_space = msg.total_space
                    srv.used_space = msg.used_space
                    if getattr(msg, "health_json", ""):
                        # health rollup input: the CS's SLO burn/stall/
                        # disk snapshot rides the heartbeat (old peers
                        # send "" and stay health-unknown)
                        try:
                            self.cs_health[srv.cs_id] = json.loads(
                                msg.health_json
                            )
                        except ValueError:
                            pass
                    hj = getattr(msg, "heat_json", "")
                    if hj and constants_mod.heat_enabled():
                        # per-chunk heat fold: the byte-weight input of
                        # the cluster heat map (old peers send "")
                        try:
                            self.heat.fold_cs(srv.cs_id, json.loads(hj))
                        except ValueError:
                            pass
                    await framing.send_message(
                        writer, m.MatocsRegisterReply(
                            req_id=msg.req_id, status=st.OK, cs_id=srv.cs_id,
                            # QoS data-plane config refresh: weights /
                            # budgets changed live propagate within one
                            # heartbeat ("" when off/unconfigured)
                            qos_json=self._qos_cs_json(),
                            # fencing epoch refresh: every heartbeat ack
                            # re-stamps the cluster epoch so the fleet
                            # converges on it within one interval
                            epoch=self.meta.epoch,
                        )
                    )
                elif isinstance(msg, (m.CstomaChunkDamaged, m.CstomaChunkLost)):
                    for info in msg.chunks:
                        self.meta.registry.drop_part(
                            info.chunk_id, srv.cs_id, info.part_id
                        )
                        self.meta.registry.mark_endangered(info.chunk_id)
                elif isinstance(msg, m.CstomaChunkNew):
                    for info in msg.chunks:
                        self.meta.registry.add_part(
                            info.chunk_id, srv.cs_id, info.part_id, info.version
                        )
        finally:
            link.fail_all()
            # supersession guard: a quick reconnect registers the same
            # cs_id (addr index) and its sliced ingest YIELDS — this
            # old connection's teardown must not tear down the live
            # replacement's registration mid-ingest
            if self.cs_links.get(srv.cs_id) is link:
                self.cs_links.pop(srv.cs_id, None)
                # drop the health snapshot with the link: a dead
                # server's frozen burn/breach figures must not haunt
                # the rollup (a reconnect re-registers and heartbeats
                # fresh state)
                self.cs_health.pop(srv.cs_id, None)
                affected = self.meta.registry.server_disconnected(srv.cs_id)
                for cid in affected:
                    self.meta.registry.mark_endangered(cid)
                self.log.info(
                    "chunkserver %d disconnected (%d chunks affected)",
                    srv.cs_id, len(affected),
                )

    async def _mirror_cs_loop(
        self, reader, writer, first: m.CstomaRegister
    ) -> None:
        """Shadow-side chunkserver mirror: accept the registration's
        part report (and follow-up heartbeats / gain-loss reports) into
        THIS master's registry so replica locates can serve locations —
        but never send a command (stale parts are the ACTIVE master's to
        reclaim; a shadow deleting parts would be catastrophic).
        Chunkservers re-send their full part list periodically on the
        same connection; each re-registration replaces the server's
        recorded part set wholesale (drift between reports self-heals).
        Closed on promotion so the chunkserver re-registers over a
        command-capable link.

        ``self.meta.registry`` is re-read at every use: a shadow image
        re-download REPLACES the registry object (load_sections), and a
        captured reference would orphan every live mirror link onto the
        old table while _ingest_parts wrote the new one."""
        self._mirror_cs_writers.add(writer)

        async def ingest_registration(msg: m.CstomaRegister):
            registry = self.meta.registry
            srv = registry.register_server(
                msg.addr.host, msg.addr.port, msg.label,
                msg.total_space, msg.used_space,
                data_port=getattr(msg, "data_port", 0),
            )
            srv.mirror = True  # passive location feed, not a command link
            # supersession marker (same race as _cs_loop's `is link`
            # guard): a re-dialed mirror link registers the same cs_id
            # while the half-open old loop lingers in read_message —
            # the old loop's teardown must not drop the new link's parts
            self._mirror_cs_owner[srv.cs_id] = writer
            registry.reset_server_parts(srv.cs_id)
            await self._ingest_parts(srv.cs_id, msg.chunks,
                                     collect_stale=False)
            await framing.send_message(
                writer,
                m.MatocsRegisterReply(
                    req_id=msg.req_id, status=st.OK, cs_id=srv.cs_id,
                    # shadow's replayed epoch: keeps mirror-registered
                    # chunkservers fencing-current even before this
                    # node is ever promoted
                    epoch=self.meta.epoch,
                ),
            )
            return srv

        srv = None
        try:
            srv = await ingest_registration(first)
            self.log.info(
                "chunkserver mirror-registered (%s:%d, %d parts)",
                srv.host, srv.port, len(first.chunks),
            )
            while self.personality == "shadow":
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if not self.personality == "shadow":
                    break
                if isinstance(msg, m.CstomaRegister):
                    srv = await ingest_registration(msg)
                elif isinstance(msg, m.CstomaHeartbeat):
                    srv.total_space = msg.total_space
                    srv.used_space = msg.used_space
                    await framing.send_message(
                        writer, m.MatocsRegisterReply(
                            req_id=msg.req_id, status=st.OK, cs_id=srv.cs_id,
                            epoch=self.meta.epoch,
                        )
                    )
                elif isinstance(msg, (m.CstomaChunkDamaged, m.CstomaChunkLost)):
                    for info in msg.chunks:
                        self.meta.registry.drop_part(
                            info.chunk_id, srv.cs_id, info.part_id
                        )
                elif isinstance(msg, m.CstomaChunkNew):
                    for info in msg.chunks:
                        self.meta.registry.add_part(
                            info.chunk_id, srv.cs_id, info.part_id,
                            info.version,
                        )
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # peer died mid-registration; cleanup below
        finally:
            self._mirror_cs_writers.discard(writer)
            if (
                srv is not None
                and self.personality == "shadow"
                and self._mirror_cs_owner.get(srv.cs_id) is writer
            ):
                # still a shadow AND still the owning link: the mirror
                # peer is gone, drop its parts. A superseded loop (the
                # chunkserver re-dialed; owner moved on) must not wipe
                # the live link's fresh report, and after PROMOTION the
                # chunkserver re-registers command-capable on the same
                # addr-indexed entry — disconnecting would race that.
                self._mirror_cs_owner.pop(srv.cs_id, None)
                self.meta.registry.server_disconnected(srv.cs_id)

    async def _delete_stale(self, link: _CsLink, info: m.ChunkPartInfo) -> None:
        try:
            await link.command(
                m.MatocsDeleteChunk, chunk_id=info.chunk_id,
                version=info.version, part_id=info.part_id,
            )
        except (ConnectionError, asyncio.TimeoutError):
            pass

    # --- tape server service (matotsserv.cc analog) -----------------------------------

    async def _ts_loop(self, reader, writer, first: m.TstomaRegister) -> None:
        if not self.is_active:
            await framing.send_message(
                writer, m.MatotsRegisterReply(
                    req_id=first.req_id, status=st.NOT_POSSIBLE, ts_id=0
                ),
            )
            return
        link = _CsLink(self, reader, writer)
        ts_id = self._next_ts_id
        self._next_ts_id += 1
        label = first.label or "_"
        self.ts_links[ts_id] = {
            "link": link, "label": label,
            # the tape server's own client session (0 = old peer):
            # recalls scope the demoted-file write guard to exactly it
            "sid": getattr(first, "session_id", 0),
        }
        await framing.send_message(
            writer, m.MatotsRegisterReply(
                req_id=first.req_id, status=st.OK, ts_id=ts_id
            ),
        )
        self.log.info("tape server %d registered (label %s)", ts_id, label)
        self._tape_rescan()
        try:
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if isinstance(msg, (m.TstomaPutDone, m.TstomaRecallDone)):
                    link.dispatch_ack(msg)
        finally:
            self.ts_links.pop(ts_id, None)
            link.fail_all()
            self.log.info("tape server %d disconnected", ts_id)

    def _goal_tape_copies(self, goal_id: int) -> int:
        g = self.goals.get(goal_id)
        return g.tape_copies() if g is not None else 0

    def _content_stamp(self, inode: int, node) -> tuple[int, int, int]:
        return (node.length, node.mtime,
                self.meta.content_gen.get(inode, 0))

    def _tape_missing_labels(self, inode: int, node) -> list[str]:
        """Goal tape labels not yet covered by a fresh copy. A named
        label needs a server with that label; a wildcard is satisfied by
        any fresh copy not already claimed by a named label. A
        lifecycle-forced inode (``tape_force``) wants one wildcard copy
        even when its goal carries no $tape slice."""
        goal = self.goals.get(node.goal)
        labels = goal.tape_labels() if goal is not None else []
        if not labels and inode in self.tape_force:
            labels = [geometry.WILDCARD_LABEL]
        if not labels:
            return []
        stamp = self._content_stamp(inode, node)
        fresh = {
            c["label"] for c in self.meta.tape_copies.get(inode, [])
            if (c["length"], c["mtime"], c.get("gen", 0)) == stamp
        }
        named = [l for l in labels if l != geometry.WILDCARD_LABEL]
        missing = [l for l in named if l not in fresh]
        wild = len(labels) - len(named)
        spare_fresh = len(fresh - set(named))
        missing += [geometry.WILDCARD_LABEL] * max(wild - spare_fresh, 0)
        return missing

    def _tape_rescan_sync(self, inodes: list[int]) -> None:
        for inode in inodes:
            node = self.meta.fs.nodes.get(inode)
            if (node is not None and node.ftype == fsmod.TYPE_FILE
                    and self._tape_missing_labels(inode, node)):
                self.tape_pending.setdefault(
                    inode, self._content_stamp(inode, node)
                )

    def _tape_rescan(self) -> None:
        """Requeue files whose tape coverage is missing or stale — run
        when a tape server registers (startup recovery; runtime marking
        is incremental via _tape_mark). Walks the namespace in slices
        off the hot path so a reconnect never stalls the loop."""

        async def walk():
            inodes = list(self.meta.fs.nodes)
            for i in range(0, len(inodes), 10_000):
                self._tape_rescan_sync(inodes[i:i + 10_000])
                await asyncio.sleep(0)

        self.spawn(walk())

    def _tape_mark(self, op: dict) -> None:
        """Incremental tape-dirty marking, called after every commit."""
        t = op["op"]
        if t in ("set_length", "set_chunk", "setgoal", "mknode", "undelete"):
            inodes = [op["inode"]]
        elif t == "snapshot":
            inodes = list(op.get("inode_map", {}).values())
        elif t == "purge_trash":
            inode = op["inode"]
            self.tape_pending.pop(inode, None)
            self.tape_force.discard(inode)
            if (inode not in self.meta.fs.nodes
                    and inode in self.meta.tape_copies):
                self.commit({"op": "tape_drop", "inode": inode})
                for e in self.ts_links.values():
                    # reclaim all archived versions of the dead file
                    try:
                        framing.write_message(
                            e["link"].writer, m.MatotsDeleteFile(
                                req_id=0, inode=inode,
                                keep_mtime=0, keep_length=0,
                            ),
                        )
                    except (ConnectionError, RuntimeError):
                        pass
            return
        else:
            return
        for inode in inodes:
            node = self.meta.fs.nodes.get(inode)
            if node is None or node.ftype != fsmod.TYPE_FILE:
                continue
            if self._goal_tape_copies(node.goal) > 0:
                self.tape_pending[inode] = self._content_stamp(inode, node)
            else:
                # a content mutation resets a lifecycle-forced archive
                # too: the file is hot again, the scanner re-decides
                self.tape_force.discard(inode)
                self.tape_pending.pop(inode, None)

    async def _tape_drain(self) -> None:
        if not (self.is_active and self.ts_links and self.tape_pending):
            return
        batch = [i for i in list(self.tape_pending)
                 if i not in self._tape_inflight][:64]
        for inode in batch:
            node = self.meta.fs.nodes.get(inode)
            if node is None:
                self.tape_pending.pop(inode, None)
                continue
            stamp = self._content_stamp(inode, node)
            self.tape_pending[inode] = stamp
            missing = self._tape_missing_labels(inode, node)
            if not missing:
                self.tape_pending.pop(inode, None)
                continue
            fresh = {
                c["label"] for c in self.meta.tape_copies.get(inode, [])
                if (c["length"], c["mtime"], c.get("gen", 0)) == stamp
            }
            entry = None
            for e in self.ts_links.values():
                if e["label"] in missing or (
                    geometry.WILDCARD_LABEL in missing
                    and e["label"] not in fresh
                ):
                    entry = e
                    break
            if entry is None:
                # no connected server can satisfy THIS inode's labels;
                # others behind it may still be placeable
                continue
            self._tape_inflight.add(inode)
            self.spawn(self._tape_put(entry, inode, node, stamp))

    async def _tape_put(self, entry: dict, inode: int, node, stamp) -> None:
        try:
            done = await entry["link"].command(
                m.MatotsPutFile, inode=inode,
                path=self.meta.fs.path_of(inode),
                length=node.length, mtime=node.mtime, timeout=60.0,
            )
            if (done.status == st.OK
                    and (done.length, done.mtime) == stamp[:2]
                    and self.tape_pending.get(inode) == stamp):
                cur = self.meta.fs.nodes.get(inode)
                if cur is not None and \
                        self._content_stamp(inode, cur) == stamp:
                    self.commit({
                        "op": "tape_copy", "inode": inode,
                        "label": entry["label"], "length": stamp[0],
                        "mtime": stamp[1], "gen": stamp[2],
                        "ts": int(time.time()),
                    })
                    # reclaim stale archive versions on that server
                    # (fire-and-forget; re-sent on the next fresh copy)
                    try:
                        framing.write_message(
                            entry["link"].writer, m.MatotsDeleteFile(
                                req_id=0, inode=inode,
                                keep_mtime=stamp[1], keep_length=stamp[0],
                            ),
                        )
                    except (ConnectionError, RuntimeError):
                        pass
        except (ConnectionError, asyncio.TimeoutError, st.StatusError):
            pass  # stays pending; next drain retries
        finally:
            self._tape_inflight.discard(inode)

    # --- lifecycle tiering: demote to tape, recall on access ---------------------------

    def _tape_fresh_labels(self, inode: int, stamp) -> set[str]:
        """Labels holding an archival copy at exactly this content
        stamp."""
        return {
            c["label"] for c in self.meta.tape_copies.get(inode, [])
            if (c["length"], c["mtime"], c.get("gen", 0)) == tuple(stamp)
        }

    def _try_demote(self, inode: int, now: int) -> int:
        """Demote one file to the tape tier. OK = demoted (or nothing
        to do), CHUNK_BUSY = archive queued / file busy, retry later."""
        node = self.meta.fs.nodes.get(inode)
        if node is None or node.ftype != fsmod.TYPE_FILE:
            return st.ENOENT
        if inode in self.meta.demoted:
            return st.OK  # already tape-only
        if node.length == 0 or not node.chunks:
            return st.OK  # nothing to free; GET serves zeros already
        if self.meta.fs.open_refs.get(inode) or inode in self._recall_inflight:
            return st.CHUNK_BUSY  # never demote under an open handle
        for cid in node.chunks:
            chunk = self.meta.registry.chunks.get(cid) if cid else None
            if chunk is not None and chunk.locked_until > time.monotonic():
                return st.CHUNK_BUSY  # write in flight
        stamp = self._content_stamp(inode, node)
        if self._tape_fresh_labels(inode, stamp):
            self.commit({"op": "tape_demote", "inode": inode, "ts": now})
            self.tape_force.discard(inode)
            self.tape_pending.pop(inode, None)
            self._invalidate_client_caches(inode)
            self.metrics.counter(
                "tape_demoted",
                help="files demoted to the tape tier (chunk data freed)",
            ).inc()
            return st.OK
        # no fresh archival copy yet: force-queue one (wildcard label,
        # goal-independent) and report busy so the caller retries
        self.tape_force.add(inode)
        self.tape_pending.setdefault(inode, stamp)
        return st.CHUNK_BUSY

    def _recall_writer_ok(self, inode: int, session_id: int) -> bool:
        """May this session write a demoted inode right now? Only the
        recalling tape server's session, and only once the recall task
        dispatched the restore (sid recorded). A legacy tape server
        that registered without a session id (sid 0) gets the old
        permissive standdown — the recall-done length check is then
        the only concurrent-write defense."""
        if inode not in self._recall_inflight:
            return False
        sid = self._recall_sids.get(inode)
        if sid is None:
            return False  # restore not dispatched yet: nobody writes
        return sid == 0 or sid == session_id

    def _ensure_recall(self, inode: int) -> asyncio.Future:
        """The single-flight recall future for an inode: every GET that
        trips over a demoted file awaits the same restore."""
        fut = self._recall_inflight.get(inode)
        if fut is None or fut.done():
            fut = asyncio.get_running_loop().create_future()
            self._recall_inflight[inode] = fut
            self.spawn(self._tape_recall_task(inode, fut))
        return fut

    async def _tape_recall_task(self, inode: int, fut: asyncio.Future) -> None:
        status = st.EIO
        try:
            doc = self.meta.demoted.get(inode)
            if doc is None:
                status = st.OK
                return
            want = (doc["length"], doc["mtime"], doc.get("gen", 0))
            labels = self._tape_fresh_labels(inode, want)
            entry = next(
                (e for e in self.ts_links.values() if e["label"] in labels),
                None,
            )
            if entry is None:
                # no connected tape server holds the archived version
                status = st.NOT_POSSIBLE
                return
            # scope the write-guard standdown to the restoring session
            # (0 = legacy tape server: permissive, length check below
            # is then the only concurrent-write defense)
            self._recall_sids[inode] = entry.get("sid", 0)
            done = await entry["link"].command(
                m.MatotsRecallFile, inode=inode,
                path=self.meta.fs.path_of(inode),
                length=doc["length"], mtime=doc["mtime"], timeout=120.0,
            )
            if done.status != st.OK:
                status = done.status
                return
            node = self.meta.fs.nodes.get(inode)
            if node is None or inode not in self.meta.demoted:
                status = st.OK if node is not None else st.ENOENT
                return
            # a write that raced the restore makes the content live
            # again but NOT the archived version: clear the demoted
            # state without the mtime/stamp restore, and let _tape_mark
            # (which already saw the write) drive any re-archive. With
            # a session-scoped guard (sid > 0) concurrent writes were
            # refused outright, so the length check is pure defense;
            # for a legacy tape server (sid == 0) it is the only
            # concurrent-write tell we have (a same-length race slips
            # through — upgrade the tape server to close it).
            clean = (
                (done.length, done.mtime) == want[:2]
                and node.length == doc["length"]
            )
            self.commit({
                "op": "tape_recall_done", "inode": inode,
                "ts": int(time.time()), "restore": clean,
            })
            self.tape_pending.pop(inode, None)
            self._invalidate_client_caches(inode)
            self.metrics.counter(
                "tape_recalled",
                help="files recalled from the tape tier on access",
            ).inc()
            status = st.OK
        except (ConnectionError, asyncio.TimeoutError):
            status = st.TIMEOUT
        finally:
            self._recall_inflight.pop(inode, None)
            self._recall_sids.pop(inode, None)
            if not fut.done():
                fut.set_result(status)

    def _lifecycle_rule_of(self, node) -> float | None:
        """demote_after_s from a lifecycle directory's rule xattr, or
        None when the rule is absent/offline/unparseable."""
        raw = node.xattrs.get(constants_mod.S3_LIFECYCLE_XATTR)
        if not raw:
            return None
        try:
            rule = json.loads(raw.decode("utf-8"))
            if not rule.get("enabled", True):
                return None
            return max(float(rule["demote_after_s"]), 0.0)
        except (ValueError, KeyError, UnicodeDecodeError):
            return None

    async def _lifecycle_tick(self) -> None:
        """Age-based demote scan over lifecycle-marked directories
        (S3 buckets with rules): files colder than the rule's
        demote_after_s push through the existing tape archive flow and
        demote once a fresh copy lands. Budgeted per tick with a
        RESUMABLE cursor (the saved walk stack): a bucket larger than
        one tick's budget makes progress every tick instead of
        rescanning the same prefix forever."""
        if not (self.is_active and self.meta.fs.lifecycle_dirs):
            return
        if not constants_mod.s3_lifecycle_enabled():
            return
        fs = self.meta.fs
        now = int(time.time())
        scanned = demoted = 0
        # drop cursors of roots that lost their rule/marker
        for root in [r for r in self._lifecycle_stacks
                     if r not in fs.lifecycle_dirs]:
            del self._lifecycle_stacks[root]
        for root in list(fs.lifecycle_dirs):
            dnode = fs.nodes.get(root)
            if dnode is None or dnode.ftype != fsmod.TYPE_DIR:
                fs.lifecycle_dirs.discard(root)
                self._lifecycle_stacks.pop(root, None)
                continue
            after_s = self._lifecycle_rule_of(dnode)
            if after_s is None:
                self._lifecycle_stacks.pop(root, None)
                continue
            # resume where the last tick stopped; a fresh (or finished)
            # walk restarts at the root. Stale inodes saved in a cursor
            # are skipped via nodes.get below.
            stack = self._lifecycle_stacks.pop(root, None) or [root]
            while stack:
                if scanned >= self.lifecycle_scan_budget:
                    self._lifecycle_stacks[root] = stack  # resume here
                    return
                scanned += 1
                if scanned % 2048 == 0:
                    await asyncio.sleep(0)  # stay off the hot loop
                # lint: waive(cross-await-race): _run_timer awaits each tick to completion — lifecycle ticks never overlap, so the cursor stack and fs alias can't be clobbered by a concurrent scan
                node = fs.nodes.get(stack.pop())
                if node is None:
                    continue
                if node.ftype == fsmod.TYPE_DIR:
                    stack.extend(node.children.values())
                    continue
                if node.ftype != fsmod.TYPE_FILE:
                    continue
                if node.inode in self.meta.demoted:
                    continue
                if now - node.mtime <= after_s:
                    continue
                if self._try_demote(node.inode, now) == st.OK:
                    demoted += 1
                    if demoted >= self.lifecycle_demote_budget:
                        self._lifecycle_stacks[root] = stack
                        return

    # --- health loop (ChunkWorker analog) ----------------------------------------------

    async def _health_tick(self) -> None:
        # HA posture gauges are set on EVERY personality — during a
        # failover the node an operator is watching is precisely the
        # one that is NOT (yet) active
        self.metrics.gauge(
            "ha_epoch",
            help="cluster fencing epoch this node has applied (bumped "
                 "by every promotion; 0 = pre-HA / LZ_HA off)",
        ).set(self.meta.epoch)
        self.metrics.gauge(
            "ha_is_active",
            help="1 when this node serves as the active master",
        ).set(int(self.is_active))
        if not self.is_active:
            return
        self.metrics.gauge("chunks").set(len(self.meta.registry.chunks))
        self.metrics.gauge("endangered_queue").set(
            len(self.meta.registry.endangered)
        )
        self.metrics.gauge("chunkservers_connected").set(len(self.cs_links))
        self.metrics.gauge("inodes").set(len(self.meta.fs.nodes))
        # metrics-history inputs for the `top` trends: aggregate
        # per-session op rate + live session population ride the
        # retention rings like any other gauge
        self.metrics.gauge(
            "session_ops_rate",
            help="aggregate client-RPC rate across tracked sessions "
                 "(ops/s over the accounting window)",
        ).set(self.session_ops.total_rate())
        self.metrics.gauge(
            "sessions_active",
            help="client sessions with a live connection",
        ).set(sum(
            1 for s in self.sessions.values() if s.get("connected")
        ))
        self.metrics.gauge("open_files").set(len(self.meta.fs.open_refs))
        self.metrics.gauge("sustained_files").set(
            len(self.meta.fs.sustained)
        )
        # cluster health rollup as derived Prometheus gauges: status
        # (0 ok / 1 degraded / 2 critical), fleet-wide SLO breach total,
        # and how many registered chunkservers report unhealthy/absent
        report = self.cluster_health(evaluate_chunks=False)
        from lizardfs_tpu_torch.runtime import slo as slomod

        self.metrics.gauge(
            "cluster_health_status",
            help="aggregated cluster health: 0 ok, 1 degraded, 2 critical",
        ).set(slomod.STATUS_ORDER.index(report["status"]))
        self.metrics.gauge(
            "cluster_slo_breaches",
            help="SLO breaches across master + all reporting chunkservers",
        ).set(report["summary"]["breaches_total"])
        self.metrics.gauge(
            "cluster_cs_unhealthy",
            help="registered chunkservers down or reporting degraded/"
                 "critical health",
        ).set(report["summary"]["cs_unhealthy"])
        # shadow replication lag (changelog positions): the incident
        # metric for the read-replica plane — staleness retries climb
        # when this does
        self.metrics.gauge(
            "shadow_lag",
            help="worst connected-shadow replication lag in changelog "
                 "positions (0 = all shadows caught up or none connected)",
        ).set(report["summary"]["shadow_lag_max"])
        self.metrics.gauge(
            "shadows_connected",
            help="shadow/metalogger changelog subscribers connected",
        ).set(report["summary"]["shadows"])
        # released chunks: delete their on-disk parts
        drained = self.meta.registry.pending_deletes[:16]
        del self.meta.registry.pending_deletes[:16]
        for dead in drained:
            t = geometry.SliceType(dead.slice_type)
            for cs_id, part in dead.parts:
                link = self.cs_links.get(cs_id)
                if link is None:
                    continue
                self.spawn(self._delete_orphan(link, dead, t, part))
        if len(self._repl_fail_until) > 256:
            # deleted/abandoned chunks leave expired deadlines behind;
            # prune so the dict tracks only active backoffs
            now = time.monotonic()
            self._repl_fail_until = {
                cid: t for cid, t in self._repl_fail_until.items() if t > now
            }
        # until the first danger-aggregate publish, also advance the
        # bootstrap counter so /health's lost/endangered become exact
        # within minutes of a restart, not after a full cursor cycle
        self.meta.registry.danger_bootstrap()
        # heat loop: decay, goal boosts/demotes, placement loads, QoS
        # pressure expiry — before health_work so a fresh boost's
        # missing copies are scheduled in this same tick
        self._heat_tick()
        work = self.meta.registry.health_work(limit=16)
        for item in work:
            if item[0] == "replicate":
                _, chunk, part = item
                if chunk.locked_until > time.monotonic():
                    continue
                if self._repl_fail_until.get(chunk.chunk_id, 0) > time.monotonic():
                    # keep it in the priority FIFO (cheap: one pop +
                    # requeue per tick) so the retry happens when the
                    # backoff expires, not a full scan cycle later
                    self.meta.registry.mark_endangered(chunk.chunk_id)
                    continue
                t = geometry.SliceType(chunk.slice_type)
                state = self.meta.registry.evaluate(chunk)
                self.rebuild.submit(rebuild_mod.Rebuild(
                    chunk_id=chunk.chunk_id, part=part,
                    priority=rebuild_mod.classify(chunk, state),
                    kind="replicate",
                    bytes_est=geometry.number_of_blocks_in_part(
                        geometry.ChunkPartType(t, part)
                    ) * MFSBLOCKSIZE,
                ))
            elif item[0] == "delete":
                _, chunk, cs_id, part = item
                self.spawn(self._delete_redundant(chunk, cs_id, part))
            elif item[0] == "move":
                _, chunk, src_cs, part, dst_cs = item
                t = geometry.SliceType(chunk.slice_type)
                self.rebuild.submit(rebuild_mod.Rebuild(
                    chunk_id=chunk.chunk_id, part=part,
                    priority=rebuild_mod.PRIORITY_REBALANCE,
                    kind="move", src_cs=src_cs, dst_cs=dst_cs,
                    bytes_est=geometry.number_of_blocks_in_part(
                        geometry.ChunkPartType(t, part)
                    ) * MFSBLOCKSIZE,
                ))
        # launch what the scheduler admits (priority order under the
        # concurrency cap); every launch reports back via finished()
        for rb in self.rebuild.next_batch():
            chunk = self.meta.registry.chunks.get(rb.chunk_id)
            if chunk is None:
                self.rebuild.skipped(rb)
                continue
            if chunk.locked_until > time.monotonic():
                # a client write was granted while the rebuild sat
                # queued: step aside and retry when the lock clears
                self.rebuild.skipped(rb)
                self.meta.registry.mark_endangered(rb.chunk_id)
                continue
            rb.trace_id = tracing.new_id() if tracing.enabled() else 0
            if rb.kind == "move":
                self.spawn(
                    self._move_part(chunk, rb.src_cs, rb.part, rb.dst_cs, rb)
                )
            else:
                self.spawn(self._replicate_part(chunk, rb.part, rb))
        self.metrics.gauge("rebuilds_active").set(
            float(len(self.rebuild.active))
        )
        await self._reclaim_stale_parts()

    async def _reclaim_stale_parts(self) -> None:
        """Retained stale-version parts are repair material only while
        their chunk is unreadable; once it recovers (e.g. the rest of a
        rolling restart re-registered the real parts) they are disk
        waste — reclaim a bounded batch per tick so a restart's
        transient retentions can't accumulate forever."""
        registry = self.meta.registry
        if not registry.stale_versions:
            return
        reclaimed = 0
        for cid in list(registry.stale_versions):
            if reclaimed >= 16:
                break
            chunk = registry.chunks.get(cid)
            if chunk is not None and \
                    not registry.evaluate(chunk).is_readable:
                continue  # still the only hope of a version-fix
            reclaimed += 1
            entries = registry.stale_versions.pop(cid, {})
            for (cs_id, part_id), version in entries.items():
                link = self.cs_links.get(cs_id)
                if link is None:
                    continue
                self.spawn(self._delete_stale(link, m.ChunkPartInfo(
                    chunk_id=cid, version=version, part_id=part_id,
                )))

    async def _delete_orphan(self, link, dead, t, part: int) -> None:
        try:
            await link.command(
                m.MatocsDeleteChunk, chunk_id=dead.chunk_id,
                version=dead.version, part_id=geometry.ChunkPartType(t, part).id,
            )
        except (ConnectionError, asyncio.TimeoutError):
            pass

    async def _replicate_part(
        self, chunk, part: int, rb: rebuild_mod.Rebuild | None = None
    ) -> None:
        if rb is None:  # direct callers (tests) bypass the scheduler
            rb = rebuild_mod.Rebuild(
                chunk_id=chunk.chunk_id, part=part,
                priority=rebuild_mod.PRIORITY_ENDANGERED,
            )
            rb.started_at = time.monotonic()
            self.rebuild.active[rb.key] = rb
        ok = False
        attempted = False
        t0 = time.perf_counter()
        try:
            t = geometry.SliceType(chunk.slice_type)
            holders = {cs for cs, _ in chunk.parts}
            label = self._labels_for_goal(chunk.goal_id, t, [part])[0]
            try:
                target = self.meta.registry.choose_servers(
                    1, exclude=holders, labels=[label]
                )[0]
            except ValueError:
                # every connected server already holds some part (e.g.
                # ec(3,2) on 5 servers after one died). Doubling up on a
                # server that lacks THIS part beats leaving the chunk
                # endangered forever — the reference fills goals with
                # repeats too when servers run short.
                same_part = {cs for cs, p in chunk.parts if p == part}
                try:
                    target = self.meta.registry.choose_servers(
                        1, exclude=same_part, labels=[label]
                    )[0]
                except ValueError:
                    return
            link = self.cs_links.get(target.cs_id)
            if link is None:
                return
            sources = self._locations_of(chunk)
            # cluster rebuild throttle: pace this part's bytes against
            # the admin-tunable budget BEFORE commanding the rebuild
            await self.rebuild.throttle(rb.bytes_est)
            # re-check the write lock: the chunk may have been queued
            # across ticks (concurrency cap) and throttled across
            # awaits — a client write granted meanwhile must not race
            # a rebuild assembled from parts it is mutating
            if chunk.locked_until > time.monotonic():
                return
            attempted = True
            try:
                reply = await link.command(
                    m.MatocsReplicate,
                    chunk_id=chunk.chunk_id, version=chunk.version,
                    part_id=geometry.ChunkPartType(t, part).id,
                    sources=sources, trace_id=rb.trace_id, timeout=60.0,
                )
            except (ConnectionError, asyncio.TimeoutError):
                return
            if reply.status == st.OK:
                ok = True
                self._repl_fail_until.pop(chunk.chunk_id, None)
            else:
                self.log.warning(
                    "replication of chunk %d v%d part %d to cs %d failed:"
                    " %s (sources: %s)",
                    chunk.chunk_id, chunk.version, part, target.cs_id,
                    st.name(reply.status),
                    # PartLocation carries addr+part, not cs_id — the
                    # old cs_id access raised here, killing the task
                    # with the failure reason unlogged
                    [(f"{l.addr.host}:{l.addr.port}",
                      geometry.ChunkPartType.from_id(l.part_id).part)
                     for l in sources],
                )
                self._repl_fail_until[chunk.chunk_id] = (
                    time.monotonic() + 5.0
                )
        finally:
            if attempted:
                # scheduler-side accounting: the span names the rebuild
                # in trace-dump, the replicate SLO class catches slow
                # rebuilds (flight-recording their timeline), the
                # engine folds the outcome into progress/ETA
                t1 = time.perf_counter()
                dt = t1 - t0
                self.trace_ring.record(
                    rb.trace_id, "rebuild", t0, t1,
                    role="master", bytes=rb.bytes_est,
                    chunk_id=chunk.chunk_id,
                )
                self.slo.observe(
                    "replicate", dt, trace_id=rb.trace_id, name="rebuild"
                )
                self.rebuild.finished(rb, ok, rb.bytes_est if ok else 0)
            else:
                # never attempted (no target / link gone / re-locked):
                # free the slot without polluting failure telemetry
                self.rebuild.skipped(rb)
            # re-evaluate on the next tick until healthy — but only hot-
            # requeue chunks that can actually be repaired: an
            # unreadable chunk (fewer than k live parts) has no sources,
            # so the endangered FIFO would spin on it forever; the
            # routine scan keeps retrying it at its own slower pace
            state = self.meta.registry.evaluate(chunk)
            if state.needs_work and state.is_readable:
                self.meta.registry.mark_endangered(chunk.chunk_id)

    async def _move_part(
        self, chunk, src_cs: int, part: int, dst_cs: int,
        rb: rebuild_mod.Rebuild | None = None,
    ) -> None:
        """Rebalancing migration: replicate the part onto the target,
        then drop the source copy. The replicate window is long (up to
        60 s) and does NOT lock the chunk; if a client write bumped the
        version meanwhile, the fresh copy is stale — drop it and abort
        instead of registering it."""
        if rb is None:  # direct callers (tests) bypass the scheduler
            rb = rebuild_mod.Rebuild(
                chunk_id=chunk.chunk_id, part=part,
                priority=rebuild_mod.PRIORITY_REBALANCE, kind="move",
                src_cs=src_cs, dst_cs=dst_cs,
            )
            rb.started_at = time.monotonic()
            self.rebuild.active[rb.key] = rb
        moved = False
        attempted = False
        v0 = chunk.version
        try:
            t = geometry.SliceType(chunk.slice_type)
            link = self.cs_links.get(dst_cs)
            if link is None:
                return
            part_id = geometry.ChunkPartType(t, part).id
            await self.rebuild.throttle(rb.bytes_est)
            attempted = True
            try:
                reply = await link.command(
                    m.MatocsReplicate,
                    chunk_id=chunk.chunk_id, version=v0,
                    part_id=part_id, sources=self._locations_of(chunk),
                    trace_id=rb.trace_id, timeout=60.0,
                )
            except (ConnectionError, asyncio.TimeoutError):
                return
            if reply.status != st.OK:
                return
            current = self.meta.registry.chunks.get(chunk.chunk_id)
            if (
                current is not chunk
                or chunk.version != v0
                or chunk.locked_until > time.monotonic()
            ):
                # chunk changed under the migration: discard the copy
                try:
                    await link.command(
                        m.MatocsDeleteChunk, chunk_id=chunk.chunk_id,
                        version=v0, part_id=part_id,
                    )
                except (ConnectionError, asyncio.TimeoutError):
                    pass
                return
            self.meta.registry.record_part(chunk, dst_cs, part)
            await self._delete_redundant(chunk, src_cs, part)
            self.metrics.counter("rebalance_moves").inc()
            moved = True
        finally:
            if attempted:
                self.rebuild.finished(
                    rb, moved, rb.bytes_est if moved else 0
                )
            else:
                self.rebuild.skipped(rb)

    async def _delete_redundant(self, chunk, cs_id: int, part: int) -> None:
        link = self.cs_links.get(cs_id)
        if link is None:
            return
        t = geometry.SliceType(chunk.slice_type)
        part_id = geometry.ChunkPartType(t, part).id
        try:
            reply = await link.command(
                m.MatocsDeleteChunk, chunk_id=chunk.chunk_id,
                version=chunk.version, part_id=part_id,
            )
            if reply.status == st.OK:
                self.meta.registry.drop_part(chunk.chunk_id, cs_id, part_id)
        except (ConnectionError, asyncio.TimeoutError):
            pass

    # --- shadow / metalogger stream (matomlserv analog) ---------------------------------

    async def _shadow_loop(self, reader, writer, first: m.MltomaRegister) -> None:
        if self.observe_peer_epoch(getattr(first, "epoch", 0)):
            # the registering shadow/metalogger has replayed a NEWER
            # epoch_bump than our own state — a later election happened
            # without us. We just stepped down; refuse the stream (a
            # zombie feeding changelog lines would fork its follower).
            await framing.send_message(
                writer,
                m.MatomlRegisterReply(
                    req_id=first.req_id, status=st.NOT_POSSIBLE,
                    version=self.changelog.version, epoch=self.meta.epoch,
                ),
            )
            return
        self.shadow_writers.append(writer)
        await framing.send_message(
            writer,
            m.MatomlRegisterReply(
                req_id=first.req_id, status=st.OK,
                version=self.changelog.version,
                # followers compare this against their replayed epoch:
                # lower than theirs = we are the zombie, they refuse us
                epoch=self.meta.epoch,
            ),
        )
        try:
            # serve image download requests; changelog lines are pushed by
            # commit(); shadows ack their applied position (MltomaAck) so
            # health/admin can report per-shadow replication lag
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if isinstance(msg, m.MltomaAck):
                    self.shadow_status[id(writer)] = {
                        "version": msg.version,
                        "serving": bool(getattr(msg, "serving", 0)),
                        "ts": time.monotonic(),
                    }
                    continue
                if isinstance(msg, m.MltomaDownloadImage):
                    doc = {
                        "format": "inline",
                        **self.meta.to_sections(),
                    }
                    await framing.send_message(
                        writer,
                        m.MatomlImage(
                            req_id=msg.req_id, status=st.OK,
                            version=self.changelog.version,
                            image=json.dumps(doc, sort_keys=True).encode(),
                        ),
                    )
        finally:
            if writer in self.shadow_writers:
                self.shadow_writers.remove(writer)
            self.shadow_status.pop(id(writer), None)

    # --- shadow personality: follow the active master -------------------------------------

    async def _shadow_follow(self) -> None:
        """masterconn analog (src/master/masterconn.cc:401-483): stream
        the changelog from the active master, applying through the same
        MetadataStore.apply path; download the image when behind."""
        while self.personality == "shadow":
            try:
                await self._shadow_follow_once()
            except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
                self.log.info("shadow link lost (%s); retrying", e)
            except asyncio.CancelledError:
                return
            await asyncio.sleep(1.0)

    async def _shadow_verify_checksum(self) -> None:
        if self.personality != "shadow":
            return
        try:
            reader, writer = await retrymod.bounded_wait(
                asyncio.open_connection(*self.active_addr), 5.0
            )
            await framing.send_message(
                writer,
                m.AdminCommand(
                    req_id=1, command="metadata-checksum", json="{}"
                ),
            )
            reply = await asyncio.wait_for(framing.read_message(reader), 5.0)
            writer.close()
        except (OSError, ConnectionError, asyncio.TimeoutError):
            return  # active unreachable; the follow loop handles that
        try:
            doc = json.loads(reply.json)
        except (AttributeError, ValueError):
            return
        if doc.get("version") != self.changelog.version:
            return  # mid-catch-up; compare only at equal versions
        # O(1) fast path: compare incremental digests. A full
        # recomputation (which alone can see state corrupted outside
        # apply()) runs in a FORKED child — O(namespace) must not stall
        # the shadow's replication loop — on mismatch and periodically
        # (background-updater analog).
        active_sum = doc.get("checksum")
        self._verify_probe_n = getattr(self, "_verify_probe_n", 0) + 1
        if (active_sum == self.meta.checksum()
                and self._verify_probe_n % 20 != 0):
            return  # fast-path match; deep check runs every 20th probe
        try:
            pid = os.fork() if _fork_safe() else -1
        except OSError:
            pid = -1
        if pid == 0:
            code = 1
            try:
                code = (
                    0 if f"{self.meta.full_digest():032x}" == active_sum
                    else 2
                )
            finally:
                os._exit(code)
        if pid > 0:
            rc = await self._wait_child(pid, timeout=600.0)
        else:  # fork unavailable: recompute on the loop (degraded)
            rc = 0 if f"{self.meta.full_digest():032x}" == active_sum else 2
        if rc == 0:
            if active_sum != self.meta.checksum():
                # state matches the active; only the local incremental
                # digest drifted — re-anchor (rare, O(namespace))
                self.log.warning(
                    "shadow incremental digest drift; re-anchoring"
                )
                self.meta.reset_digest()
            return
        self.log.error(
            "shadow metadata DIVERGED from active at v%d — "
            "re-downloading the image", self.changelog.version,
        )
        self._force_image_download = True
        w = getattr(self, "_follow_writer", None)
        if w is not None:
            w.close()  # the follow loop reconnects and re-downloads

    async def _shadow_follow_once(self) -> None:
        # bounded dial (unbounded-await audit): a blackholed active must
        # cost one 5 s attempt per follow-loop lap, never the OS SYN
        # timeout — an electing shadow has to notice promotion promptly
        reader, writer = await retrymod.bounded_wait(
            asyncio.open_connection(*self.active_addr), 5.0
        )
        self._follow_writer = writer
        try:
            await framing.send_message(
                writer,
                m.MltomaRegister(
                    req_id=1, version_known=self.changelog.version,
                    # our replayed cluster epoch: a deposed ex-primary we
                    # accidentally dial sees it is behind and steps down
                    epoch=self.meta.epoch,
                ),
            )
            hello = await framing.read_message(reader)
            if not isinstance(hello, m.MatomlRegisterReply) or hello.status != st.OK:
                raise ConnectionError("active master rejected shadow registration")
            if (
                constants_mod.ha_enabled()
                and getattr(hello, "epoch", 0)
                and hello.epoch < self.meta.epoch
            ):
                # zombie active: it never applied the epoch_bump we
                # replayed — following it would fork our history off the
                # elected leader's. Drop the link; the follow loop (or
                # the failover controller's next leader event) re-points.
                raise ConnectionError(
                    f"refusing stale active (epoch {hello.epoch} < "
                    f"ours {self.meta.epoch})"
                )
            if (
                hello.version > self.changelog.version
                or getattr(self, "_force_image_download", False)
            ):
                self._force_image_download = False
                await self._shadow_download_image(reader, writer)
            # replica reads may serve from here on: the stream is live
            # and we are at (or catching up to) the active's position
            self._follow_connected = True
            self._shadow_ack(writer, force=True)
            while self.personality == "shadow":
                msg = await framing.read_message(reader)
                if isinstance(msg, m.MatomlChangelogLine):
                    await self._shadow_apply(msg, reader, writer)
                    self._shadow_ack(writer)
        finally:
            self._follow_connected = False
            await retrymod.close_writer(writer, swallow_cancel=True)

    async def _shadow_ack_tick(self) -> None:
        w = getattr(self, "_follow_writer", None)
        if self._follow_connected and w is not None:
            self._shadow_ack(w, force=True)

    def _shadow_ack(self, writer, force: bool = False) -> None:
        """Throttled applied-position report to the active (lag
        telemetry input for `health` / the shadow_lag gauge)."""
        now = time.monotonic()
        if not force and now - self._last_shadow_ack < 1.0:
            return
        self._last_shadow_ack = now
        try:
            framing.write_message(
                writer,
                m.MltomaAck(
                    version=self.changelog.version,
                    serving=int(shadow_reads_enabled()),
                ),
            )
        except (ConnectionError, RuntimeError):
            pass  # the follow loop notices the dead link itself

    async def _shadow_download_image(self, reader, writer) -> None:
        await framing.send_message(writer, m.MltomaDownloadImage(req_id=2))
        while True:
            msg = await framing.read_message(reader)
            if isinstance(msg, m.MatomlImage):
                break
            # changelog lines racing the download are superseded by it
        if msg.status != st.OK:
            raise ConnectionError("image download failed")
        doc = json.loads(msg.image.decode())
        self.meta.load_sections(doc)
        self.changelog.close()
        self.changelog.version = msg.version
        self.changelog.open()
        save_image(self.data_dir, msg.version, self.meta.to_sections())
        # load_sections REPLACED self.meta.registry: live mirror links
        # hold cs_ids from the old table — close them so chunkservers
        # re-register (fresh part reports) against the new registry
        for w in list(self._mirror_cs_writers):
            try:
                w.close()
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        self.log.info("shadow: downloaded metadata image at v%d", msg.version)

    async def _shadow_apply(self, line: m.MatomlChangelogLine, reader, writer) -> None:
        if line.version <= self.changelog.version:
            return  # duplicate during catch-up
        if line.version != self.changelog.version + 1:
            self.log.warning(
                "shadow: changelog gap (have v%d, got v%d) — re-downloading",
                self.changelog.version, line.version,
            )
            await self._shadow_download_image(reader, writer)
            return
        op = json.loads(line.line)
        self.meta.apply(op)
        self.changelog.append(op)  # assigns the same version, persists

    def observe_peer_epoch(self, peer_epoch: int) -> bool:
        """Zombie-fencing input: every register/heartbeat surface feeds
        the peer's highest observed cluster epoch here. An ACTIVE master
        seeing a HIGHER epoch than its own has been superseded by an
        election it never heard (partitioned ex-primary): it steps down
        to shadow on the spot — all mutating timers and loops guard on
        ``is_active``, so demotion mid-run is safe — instead of merging
        late writes into a forked history. Returns True when the caller
        must refuse/close its link (we just fenced ourselves).

        Epoch 0 is a pre-HA peer (or LZ_HA off end to end): fencing
        disengaged, byte-for-byte the manual-promotion behavior."""
        if not peer_epoch or not constants_mod.ha_enabled():
            return False
        if self.is_active and peer_epoch > self.meta.epoch:
            self.log.error(
                "FENCED: peer reports cluster epoch %d > our %d — a newer "
                "master was elected; stepping down to shadow",
                peer_epoch, self.meta.epoch,
            )
            self.metrics.counter("ha_fenced").inc()
            self.personality = "shadow"
            return True
        return False

    def promote(self) -> None:
        """Shadow -> active master (promoteAutoToMaster analog,
        personality.h:69). Chunkservers and clients find us by cycling
        their configured master address lists."""
        if self.personality == "master":
            return
        self.personality = "master"
        self._follow_connected = False
        if self._shadow_task is not None:
            self._shadow_task.cancel()
            self._shadow_task = None
        # passive chunkserver mirror links never carry commands: close
        # them so every chunkserver re-registers over a command-capable
        # link (their heartbeat loops reconnect within one interval)
        for w in list(self._mirror_cs_writers):
            try:
                w.close()
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        if constants_mod.ha_enabled():
            # fenced promotion: the new active's FIRST committed write
            # claims the next cluster epoch. It rides the changelog
            # (replayed by every shadow/metalogger) and is stamped on
            # every register/heartbeat ack from here on, so a zombie
            # ex-primary's links are refused by its own peers. With
            # LZ_HA off no bump is committed and every epoch field
            # stays 0 — manual promotion behaves exactly as before.
            self.commit({"op": "epoch_bump", "epoch": self.meta.epoch + 1})
        self.log.info(
            "promoted to active master at v%d (epoch %d)",
            self.changelog.version, self.meta.epoch,
        )

    def follow(self, addr: tuple[str, int]) -> None:
        """(Re-)point this node at the CURRENT active master and stream
        its changelog. The failover controller calls this whenever the
        election names a leader: a shadow must track the live leader —
        not its boot-time ACTIVE_MASTER, which may itself have been
        demoted — and a demoted master must start following, or every
        replica silently stays behind and a later promotion loses
        acknowledged writes (r05 HA e2e flake root cause)."""
        if self.personality == "master" or self.active_addr != addr:
            self.personality = "shadow"
            self.active_addr = addr
            if self._shadow_task is not None:
                self._shadow_task.cancel()
            self._shadow_task = self.spawn(self._shadow_follow())
            self.log.info(
                "following active master at %s:%d (v%d)",
                addr[0], addr[1], self.changelog.version,
            )

    # --- admin ----------------------------------------------------------------------------

    # mutating admin surface requires challenge-response auth when an
    # ADMIN_PASSWORD is configured (registered_admin_connection.cc)
    ADMIN_PRIVILEGED = frozenset({
        "tweaks-set", "save-metadata", "promote-shadow", "reload", "stop",
        "rremove-task", "setgoal-task", "settrashtime-task",
        "synth-populate",
    })

    async def _admin_message(self, writer, msg, state: dict | None = None) -> None:
        state = state if state is not None else {}
        if isinstance(msg, m.AdminCommand):
            reply = self.admin_gate(msg, state)
            if reply is not None:
                await framing.send_message(writer, reply)
                return
        if isinstance(msg, m.AdminInfo):
            info = {
                "personality": self.personality,
                "version": self.changelog.version,
                "inodes": len(self.meta.fs.nodes),
                "chunks": len(self.meta.registry.chunks),
                "chunkservers": [
                    {
                        "cs_id": s.cs_id, "host": s.host, "port": s.port,
                        "label": s.label, "connected": s.connected,
                        "total_space": s.total_space, "used_space": s.used_space,
                        # mirror=True: a shadow's passive location feed,
                        # NOT a command link — active-discovery tooling
                        # must skip these
                        "mirror": s.mirror,
                    }
                    for s in self.meta.registry.servers.values()
                ],
                "sessions": len(self.sessions),
                "open_files": len(self.meta.fs.open_refs),
                "sustained_files": len(self.meta.fs.sustained),
                "trash_files": len(self.meta.fs.trash),
            }
            await framing.send_message(
                writer,
                m.AdminInfoReply(req_id=msg.req_id, status=st.OK, json=json.dumps(info)),
            )
            return
        if isinstance(msg, m.AdminCommand):
            reply = await self._admin_command(msg)
            await framing.send_message(writer, reply)

    def _ha_status(self) -> dict:
        """The `ha` section of health / the admin `ha` command: this
        node's failover posture. Always present (operators check it
        FIRST during an incident); election fields appear only when a
        FailoverController is wired (__main__ with ELECTION_ID)."""
        doc: dict = {
            "enabled": constants_mod.ha_enabled(),
            "personality": self.personality,
            "epoch": self.meta.epoch,
            "fenced": int(self.metrics.counter("ha_fenced").total),
        }
        ctrl = self.ha_controller
        if ctrl is not None:
            doc.update(ctrl.status())
        return doc

    def cluster_health(self, evaluate_chunks: bool = True) -> dict:
        """The cluster-wide health rollup: this master's own snapshot,
        every chunkserver's heartbeat-folded snapshot, and chunk-level
        danger, aggregated to one status.

        Chunk danger comes from the registry's maintained aggregate
        (published by the routine health-walk cycle — the evaluations
        the walk already pays for), NEVER a full-table sweep: /health
        is a probe endpoint monitors may poll every few seconds, and
        the old O(all-chunks) evaluation was the master's biggest
        per-probe stall at 1M chunks (test_scalability pins the bound).
        ``evaluate_chunks=False`` (the per-tick gauge path) uses the
        endangered queue length instead of the aggregate.

        Freshness contract: ``endangered`` is backstopped by the live
        FIFO (a chunkserver death shows within a tick); ``lost`` is
        cycle-fresh — exact as of the last completed walk cycle (or
        the post-restart bootstrap sweep, registry.danger_bootstrap),
        lagging a fresh loss by up to one cycle. Alert on
        status/endangered for immediacy; ``lost`` is the precise
        classification, not the tripwire."""
        from lizardfs_tpu_torch.runtime import slo as slomod

        master_snap = self.health_snapshot()
        if evaluate_chunks:
            endangered, lost, _ = self.meta.registry.danger_counts
            # a fresh burst (chunkserver died seconds ago) shows in the
            # endangered FIFO before the walk cycle republishes
            endangered = max(endangered, len(self.meta.registry.endangered))
        else:
            endangered = len(self.meta.registry.endangered)
            lost = 0
        servers = {}
        cs_unhealthy = 0
        breaches = master_snap.get("breaches_total", 0)
        worst_burn = 0.0
        for s in self.meta.registry.servers.values():
            snap = dict(self.cs_health.get(s.cs_id, {}))
            snap["connected"] = s.connected
            if not s.connected:
                # "down" is the whole signal for a dead server: its
                # last snapshot's burn/breach figures are frozen at
                # heartbeat age and must not keep inflating the fleet
                # aggregates (burn decays, frozen values don't)
                snap = {"connected": False, "status": "down"}
                cs_unhealthy += 1
            elif not snap.get("status"):
                snap["status"] = "unknown"  # old peer: no health in hb
            elif snap["status"] != "ok":
                cs_unhealthy += 1
            if s.connected:
                breaches += snap.get("breaches_total", 0)
                for cls in snap.get("slo", {}).values():
                    worst_burn = max(worst_burn, cls.get("burn_fast", 0.0))
            servers[s.cs_id] = snap
        status = master_snap["status"]
        for snap in servers.values():
            if snap["status"] == "down":
                status = slomod.worst_status(status, "degraded")
            elif snap["status"] != "unknown":
                status = slomod.worst_status(status, snap["status"])
        if endangered:
            status = slomod.worst_status(status, "degraded")
        if lost:
            status = slomod.worst_status(status, "critical")
        for cls in master_snap.get("slo", {}).values():
            worst_burn = max(worst_burn, cls.get("burn_fast", 0.0))
        # per-shadow replication lag (changelog positions): shadows ack
        # their applied version over the changelog stream; `health`
        # names each one so a lagging replica is visible before clients
        # notice the staleness retries
        now_m = time.monotonic()
        shadows = [
            {
                "version": snap["version"],
                "lag": max(self.changelog.version - snap["version"], 0),
                "serving": snap["serving"],
                "age_s": round(now_m - snap["ts"], 1),
            }
            for snap in self.shadow_status.values()
        ]
        # protocol gateways, by role, from the session registry: the
        # rollup names every front door (fuse clients register as
        # pyclient/fuse, gateways as nfs-gateway / s3-gateway), so "is
        # the s3 tier up" is answerable from `lizardfs-admin health`
        gateways: dict[str, int] = {"nfs": 0, "s3": 0}
        for sess in self.sessions.values():
            if not sess.get("connected"):
                continue
            info = str(sess.get("info", ""))
            if info.startswith("nfs-gateway"):
                gateways["nfs"] += 1
            elif info.startswith("s3-gateway"):
                gateways["s3"] += 1
        # QoS: NAME currently-throttled tenants so "who is being shed"
        # is answerable from `lizardfs-admin health` during an incident
        qos_doc: dict = {}
        if constants_mod.qos_enabled() and (
            self.qos.armed or self.qos.sheds
        ):
            snap = self.qos.snapshot()
            qos_doc = {
                "armed": snap["armed"],
                "throttled": self.qos.throttled_tenants(),
                "sheds": snap["sheds"],
            }
            # per-tenant SLO objectives (QOS_CFG p99_ms): evaluate each
            # configured tenant's worst observed master-leg p99 across
            # its connected sessions against its objective
            if self.qos.objectives:
                qos_doc["objectives"] = self._qos_objective_report()
        # heat: the hottest chunks and any standing goal boosts, so an
        # operator reading a degraded rollup sees the hot spot (and the
        # adaptive-replication response) without a second probe
        heat_doc: dict = {}
        if constants_mod.heat_enabled():
            boosted = {
                cid: self.meta.registry.chunks[cid].boost
                for cid in self.meta.registry.boosted
                if cid in self.meta.registry.chunks
            }
            heat_doc = {
                "chunks": self.heat.top("chunk", 4),
                "boosted": {str(c): b for c, b in boosted.items()},
                "qos_pressure": sorted(self._heat_qos_pressure),
            }
        return {
            "status": status,
            "master": master_snap,
            "chunkservers": servers,
            "shadows": shadows,
            "gateways": gateways,
            "qos": qos_doc,
            "heat": heat_doc,
            "ha": self._ha_status(),
            "tape": {
                "servers": len(self.ts_links),
                "pending": len(self.tape_pending),
                "demoted": len(self.meta.demoted),
                "recalling": len(self._recall_inflight),
            },
            "summary": {
                "endangered": endangered,
                "lost": lost,
                "cs_unhealthy": cs_unhealthy,
                "breaches_total": breaches,
                "worst_burn_fast": round(worst_burn, 3),
                "shadows": len(self.shadow_writers),
                "shadow_lag_max": max(
                    (s["lag"] for s in shadows), default=0
                ),
            },
        }

    def _qos_objective_report(self) -> dict:
        """Per-tenant SLO check: worst session_ops p99 (ms) across a
        tenant's connected sessions vs. its configured ``p99_ms``
        objective. Cold path (health/admin only)."""
        out: dict[str, dict] = {}
        by_tenant: dict[str, list[int]] = {}
        for sid, sess in self.sessions.items():
            if sess.get("connected"):
                by_tenant.setdefault(
                    sess.get("tenant", qosmod.DEFAULT_TENANT), []
                ).append(sid)
        variants = self.metrics.labeled_timings.get("session_ops", {})
        for tenant, objective in self.qos.objectives.items():
            worst = 0.0
            for key, timing in variants.items():
                labels = dict(key)
                for sid in by_tenant.get(tenant, ()):
                    if labels.get("session") == f"s{sid}":
                        worst = max(
                            worst, timing.quantile_us(0.99) / 1e3
                        )
            out[tenant] = {
                "p99_ms": round(worst, 3),
                "objective_ms": objective,
                "breached": bool(worst > objective),
            }
        return out

    def top_report(self, k: int = 16, resolution: str = "sec") -> dict:
        """The cluster-wide workload rollup `lizardfs-admin top` and
        the webui ``/api/top`` render: per-session op rates / bytes /
        p99 / exemplars from this master's own accounting, decorated
        with session identity, merged with every chunkserver's
        heartbeat-folded top-K (data-plane bytes) and every gateway's
        pushed protocol-op summary, plus short metrics-history rings so
        the view shows trends, not just instants."""
        now = time.time()
        sessions_doc: dict[str, dict] = {}
        for row in self.session_ops.top(k):
            sessions_doc[row["session"]] = {"master": row}
        # decorate with the session registry's identity; sessions only
        # known through a gateway push still get a row
        for sid, sess in self.sessions.items():
            label = f"s{sid}"
            if label not in sessions_doc and sid not in self.session_stats:
                continue
            entry = sessions_doc.setdefault(label, {})
            entry["info"] = str(sess.get("info", ""))
            entry["ip"] = sess.get("ip", "")
            entry["connected"] = bool(sess.get("connected"))
            entry["tenant"] = sess.get("tenant", qosmod.DEFAULT_TENANT)
            stats = self.session_stats.get(sid)
            if stats is not None:
                entry["gateway"] = dict(stats)
                entry["gateway"]["age_s"] = round(
                    now - stats.get("ts", now), 1
                )
                # client-pushed phase breakdowns ride the same stats
                # doc (Client.push_session_stats); lift them to the
                # entry so `top` renders each session's read/write
                # roofline without digging into the gateway sub-doc
                for key in ("read_phases", "write_phases"):
                    if stats.get(key):
                        entry[key] = stats[key]
        # chunkserver legs: per-session data-plane summaries folded
        # into heartbeats (health_json "sessions"); merged per session
        chunkservers: dict[str, list] = {}
        for cs_id, snap in self.cs_health.items():
            rows = snap.get("sessions") or []
            if not rows:
                continue
            chunkservers[str(cs_id)] = rows
            for row in rows:
                entry = sessions_doc.setdefault(row["session"], {})
                entry.setdefault("chunkservers", {})[str(cs_id)] = row
        history = {
            name: self.metrics.history(name, resolution)
            for name in (
                "session_ops_rate", "sessions_active",
                "cluster_health_status", "cluster_slo_breaches",
                "endangered_queue",
                "slo_locate_burn_fast",
            )
        }
        # per-tenant rollup: aggregate the master-leg rates of each
        # tenant's sessions + whether admission is currently shedding
        # it (the `top` tenant column's source)
        tenants_doc: dict[str, dict] = {}
        throttled = set(
            self.qos.throttled_tenants()
            if constants_mod.qos_enabled() else ()
        )
        for label, entry in sessions_doc.items():
            tenant = entry.get("tenant")
            if tenant is None:
                continue
            row = tenants_doc.setdefault(
                tenant, {"sessions": 0, "rate_ops": 0.0, "throttled": False}
            )
            row["sessions"] += 1
            row["rate_ops"] = round(
                row["rate_ops"]
                + entry.get("master", {}).get("rate_ops", 0.0), 2
            )
        for tenant in throttled:
            tenants_doc.setdefault(
                tenant, {"sessions": 0, "rate_ops": 0.0}
            )["throttled"] = True
        return {
            "ts": now,
            "enabled": accounting.enabled(),
            "resolution": resolution,
            "sessions": sessions_doc,
            "chunkservers": chunkservers,
            "tenants": tenants_doc,
            "totals": {
                "rate_ops": self.session_ops.total_rate(),
                "sessions_tracked": self.session_ops.active_sessions(),
                "sessions_connected": sum(
                    1 for s in self.sessions.values() if s.get("connected")
                ),
            },
            "slo": self.slo.snapshot(),
            "history": history,
        }

    async def _admin_command(self, msg: m.AdminCommand) -> m.AdminReply:
        if msg.command == "top":
            try:
                payload = json.loads(msg.json) if msg.json else {}
                k = int(payload.get("k", 16))
                resolution = str(payload.get("resolution", "sec"))
            except (ValueError, TypeError):
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL, json="{}"
                )
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(self.top_report(k, resolution)),
            )
        if msg.command == "health":
            # cluster-wide rollup (overrides the base daemon's
            # single-process snapshot): one command answers "is the
            # cluster healthy" — also served at the webui /health
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(self.cluster_health()),
            )
        if msg.command == "ha":
            # failover posture: personality, cluster epoch, election
            # state (term/leader/quorum when a controller is wired),
            # promotion/fencing counters — `lizardfs-admin ha`
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(self._ha_status()),
            )
        if msg.command == "qos":
            # show/set fair-share weights and limits LIVE (the tweaks
            # plane is the other write path for the per-class rates;
            # SIGHUP re-reads QOS_CFG wholesale). Payload keys:
            #   {"weight": {tenant: w}}, {"rate": {class: ops_s}},
            #   {"data_inflight_mb": v}, {"data_bps": v},
            #   {"rebuild_weight": v}  — empty payload = show
            try:
                payload = json.loads(msg.json) if msg.json else {}
                for tenant, w in (payload.get("weight") or {}).items():
                    self.qos.set_weight(str(tenant), float(w))
                    self.qos_doc.setdefault("tenants", {}).setdefault(
                        str(tenant), {}
                    )["weight"] = float(w)
                for cls, rate in (payload.get("rate") or {}).items():
                    self.qos.set_rate(str(cls), float(rate))
                    self._qos_rate_tweaks[str(cls)].value = float(rate)
                    self.qos_doc.setdefault("rates", {})[str(cls)] = (
                        float(rate)
                    )
                for key in ("data_inflight_mb", "data_bps",
                            "rebuild_weight"):
                    if key in payload:
                        self.qos_doc[key] = float(payload[key])
                        self.qos.generation += 1
                if payload:
                    self._qos_cs_cache = ()
            except (ValueError, TypeError) as e:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json=json.dumps({"error": str(e)[:200]}),
                )
            doc = self.qos.snapshot()
            doc["enabled"] = constants_mod.qos_enabled()
            doc["data"] = {
                "inflight_mb": float(
                    self.qos_doc.get("data_inflight_mb", 0) or 0
                ),
                "data_bps": float(self.qos_doc.get("data_bps", 0) or 0),
                "rebuild_weight": float(
                    self.qos_doc.get("rebuild_weight", 1.0)
                ),
            }
            doc["default_tenant"] = self.qos_tenants.default
            doc["match_rules"] = list(self.qos_tenants.rules)
            if self.qos.objectives:
                doc["objectives"] = self._qos_objective_report()
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        basic = self.handle_admin_basics(msg)
        if basic is not None:
            return basic
        if msg.command == "save-metadata":
            await self._dump_image()
            return m.AdminReply(req_id=msg.req_id, status=st.OK, json="{}")
        if msg.command == "reload":
            self.reload()
            result = getattr(self, "_last_reload", {})
            return m.AdminReply(
                req_id=msg.req_id,
                # scripts check the status like they do for tweaks-set:
                # a partial reload is a failure, details in the JSON
                status=st.OK if not result.get("failed") else st.EINVAL,
                json=json.dumps(result),
            )
        if msg.command == "heat":
            # the cluster heat map: hottest chunks/inodes/servers with
            # decayed scores, thresholds, standing goal boosts, and any
            # heat-armed QoS pressure (lizardfs-admin heat / webui)
            registry = self.meta.registry
            doc = self.heat.snapshot({
                cid: registry.chunks[cid].boost
                for cid in registry.boosted if cid in registry.chunks
            })
            doc["enabled"] = constants_mod.heat_enabled()
            doc["server_load"] = {
                str(cs): round(v, 3)
                for cs, v in sorted(registry.server_load.items())
            }
            doc["qos_pressure"] = sorted(self._heat_qos_pressure)
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        if msg.command == "rebuild-status":
            # RebuildEngine progress: queue depths by priority class,
            # active rebuilds, throttle config, rate + backlog ETA —
            # plus the endangered FIFO feeding it
            doc = self.rebuild.status()
            doc["endangered_queue"] = len(self.meta.registry.endangered)
            doc["stale_version_chunks"] = len(
                self.meta.registry.stale_versions
            )
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        if msg.command == "chunks-health":
            # budgeted incremental walk: an accurate on-demand count
            # still visits every chunk, but in slices with yield points
            # so a 1M-chunk table never stalls client service for the
            # whole evaluation (the old loop was a single synchronous
            # full-registry sweep)
            healthy = endangered = lost = 0
            registry = self.meta.registry
            ids = list(registry.chunks.keys())
            for start in range(0, len(ids), 4096):
                for cid in ids[start:start + 4096]:
                    chunk = registry.chunks.get(cid)
                    if chunk is None:
                        continue  # deleted while we yielded
                    state = registry.evaluate(chunk)
                    if not state.is_readable:
                        lost += 1
                    elif state.is_endangered or state.missing_parts:
                        endangered += 1
                    else:
                        healthy += 1
                await asyncio.sleep(0)
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({
                    "healthy": healthy, "endangered": endangered, "lost": lost,
                }),
            )
        if msg.command == "promote-shadow":
            if self.personality == "master":
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json='{"error": "already active"}',
                )
            self.promote()
            return m.AdminReply(req_id=msg.req_id, status=st.OK, json="{}")
        if msg.command in ("rremove-task", "setgoal-task", "settrashtime-task"):
            from lizardfs_tpu_torch.master import tasks as tasks_mod

            try:
                payload = json.loads(msg.json)
                now = int(time.time())
                if msg.command == "rremove-task":
                    gen = tasks_mod.recursive_remove_ops(
                        self.meta.fs, int(payload["parent"]),
                        str(payload["name"]), now,
                    )
                elif msg.command == "setgoal-task":
                    gen = tasks_mod.subtree_setgoal_ops(
                        self.meta.fs, int(payload["inode"]),
                        int(payload["goal"]), now,
                    )
                else:
                    gen = tasks_mod.subtree_settrashtime_ops(
                        self.meta.fs, int(payload["inode"]),
                        int(payload["seconds"]), now,
                    )
                task = self.task_manager.submit(msg.command, gen)
            except (KeyError, ValueError, fsmod.FsError) as e:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json=json.dumps({"error": str(e)[:200]}),
                )
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(task.to_dict())
            )
        if msg.command == "list-tasks":
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps([
                    t.to_dict() for t in self.task_manager.tasks.values()
                ]),
            )
        if msg.command == "synth-populate":
            # storm-bench loader: bulk-create a synthetic namespace +
            # chunk registry (files/chunks/servers) through the normal
            # commit path so shadows converge on it from the changelog.
            # Batched commits with yield points: the master keeps
            # serving while a million inodes stream in.
            if not self.is_active:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json='{"error": "not the active master"}',
                )
            try:
                payload = json.loads(msg.json or "{}")
                files = int(payload.get("files", 0))
                servers = int(payload.get("servers", 0))
                copies = int(payload.get("copies", 1))
                dir_name = str(payload.get("dir", "synthstorm"))
            except (ValueError, TypeError) as e:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json=json.dumps({"error": str(e)[:200]}),
                )
            fs = self.meta.fs
            now = int(time.time())
            root = fs.node(fsmod.ROOT_INODE)
            dir_inode = root.children.get(dir_name)
            if dir_inode is None:
                dir_inode = fs.alloc_inode()
                self.commit({
                    "op": "mknode", "parent": fsmod.ROOT_INODE,
                    "name": dir_name, "inode": dir_inode, "ftype":
                    fsmod.TYPE_DIR, "mode": 0o755, "uid": 0, "gid": 0,
                    "ts": now, "goal": 1, "trash_time": 0,
                })
            created = 0
            batch = 10_000
            while created < files:
                n = min(batch, files - created)
                base_inode = fs.next_inode
                fs.next_inode += n  # pre-reserve like alloc_inode
                base_chunk = self.meta.registry.next_chunk_id
                self.meta.registry.next_chunk_id += n
                self.commit({
                    "op": "synth_populate", "parent": dir_inode,
                    "base_inode": base_inode, "base_chunk": base_chunk,
                    "count": n, "servers": servers, "copies": copies,
                    "ts": now,
                })
                created += n
                await asyncio.sleep(0)
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({
                    "files": files, "servers": servers,
                    "dir_inode": dir_inode,
                    "inodes": len(fs.nodes),
                    "chunks": len(self.meta.registry.chunks),
                    "version": self.changelog.version,
                }),
            )
        if msg.command == "metadata-checksum":
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({
                    "version": self.changelog.version,
                    "checksum": self.meta.checksum(self.changelog.version),
                }),
            )
        return m.AdminReply(req_id=msg.req_id, status=st.EINVAL, json="{}")


def _attr_of(node) -> m.Attr:
    return m.Attr(
        inode=node.inode, ftype=node.ftype, mode=node.mode, uid=node.uid,
        gid=node.gid, atime=node.atime, mtime=node.mtime, ctime=node.ctime,
        nlink=node.nlink, length=node.length, goal=node.goal,
        trash_time=node.trash_time, eattr=node.eattr,
    )


def _null_attr() -> m.Attr:
    return m.Attr(
        inode=0, ftype=0, mode=0, uid=0, gid=0, atime=0, mtime=0, ctime=0,
        nlink=0, length=0, goal=0, trash_time=0,
    )
