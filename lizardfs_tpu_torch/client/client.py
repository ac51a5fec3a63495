"""Library-first client: metadata RPCs + EC read/write data paths.

The analog of the reference's libclient + mount core (reference:
src/mount/client/lizardfs_c_api.h API shape, lizard_client.cc VFS ops,
readdata.cc / writedata.cc / chunk_writer.cc data paths) — as an asyncio
library, FUSE-independent (a FUSE shim mounts on top of this, exactly
like mfs_fuse.cc wraps LizardClient).

Data paths:
  * write: per chunk — acquire (CltomaWriteChunk), split bytes into
    slice parts, **compute xor/RS parity client-side through the
    ChunkEncoder** (chunk_writer.cc:365-398 semantics), push each part
    to its chunkserver (std copies ride one chain; EC parts go direct),
    finish (CltomaWriteChunkEnd).
  * read: per chunk — locate (CltomaReadChunk), plan over available
    parts with the SliceReadPlanner, execute with the wave executor
    (recovery on failures), reassemble stripes; retries with backoff on
    plan failure re-locate and re-plan (readdata.cc:233-329 pattern).
"""

from __future__ import annotations

import asyncio
import logging
import os as _os
import time as _time

import numpy as np

from lizardfs_tpu_torch.constants import (
    EATTR_NOCACHE,
    EATTR_NOENTRYCACHE,
    MFSBLOCKSIZE,
    MFSCHUNKSIZE,
    env_flag,
)
from lizardfs_tpu_torch.core import geometry, plans
from lizardfs_tpu_torch.core.encoder import ChunkEncoder, get_encoder
from lizardfs_tpu_torch.core.read_executor import ReadError, execute_plan
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.client.cache import BlockCache, ReadaheadAdviser
from lizardfs_tpu_torch.runtime import accounting
from lizardfs_tpu_torch.runtime import faults as _faults
from lizardfs_tpu_torch.runtime import qos as qosmod
from lizardfs_tpu_torch.runtime import retry as retrymod
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.metrics import PhaseBreakdown
from lizardfs_tpu_torch.runtime.rpc import RpcConnection
from lizardfs_tpu_torch.utils import striping

log = logging.getLogger("client")

# the pid whose cgroup classifies the current IO for limit-group
# throttling; FUSE sets it per operation from the kernel caller's
# context (reference: src/mount/io_limit_group.cc reads the fuse ctx
# pid the same way). None = this process itself.
import contextvars  # noqa: E402

IO_CALLER_PID: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "io_caller_pid", default=None
)

# status codes worth retrying a write for (infrastructure trouble);
# everything else (quota, permissions, invalid args) is permanent.
# BUSY is the QoS fair-share shed — transient BY CONTRACT (the master
# asks this tenant to back off and retry, never to error).
_TRANSIENT = {
    st.EIO, st.NO_CHUNK_SERVERS, st.CHUNK_BUSY, st.DISCONNECTED,
    st.TIMEOUT, st.WRONG_VERSION, st.CHUNK_LOST, st.NO_CHUNK, st.BUSY,
}


def _is_transient(e: Exception) -> bool:
    if isinstance(e, st.StatusError):
        return e.code in _TRANSIENT
    return isinstance(
        e, (ReadError, ConnectionError, OSError, asyncio.TimeoutError)
    )


class Client:
    def __init__(
        self,
        master_host: str,
        master_port: int,
        encoder: ChunkEncoder | None = None,
        wave_timeout: float = 0.3,
        retries: int = 5,
        master_addrs: list[tuple[str, int]] | None = None,
        metrics=None,
    ):
        # master_addrs: full list of master addresses (active + shadows);
        # the client cycles until the active one accepts its session
        self.master_addrs = master_addrs or [(master_host, master_port)]
        self.current_master_addr = self.master_addrs[0]
        self.master: RpcConnection | None = None
        self.session_id = 0
        # highest cluster fencing epoch seen on any register reply
        # (primary or replica): echoed on every redial, so a deposed
        # ex-primary this client lands on learns it was superseded and
        # steps down instead of accepting our writes. 0 = pre-HA.
        self.cluster_epoch = 0
        # default: the card's encoder (get_encoder(None): cuda:0, or the
        # mesh over two or more cards), which raises without a card;
        # callers on the CPU pass an encoder
        self.encoder = encoder or get_encoder(None)
        self.wave_timeout = wave_timeout
        self.retries = retries
        # QoS shed handling: how many BUSY backoff-retries one logical
        # master RPC gets before the shed surfaces to the caller
        self.busy_retries = 8
        self._info = "pyclient"
        self.cache = BlockCache()
        # reads at least this large bypass the block cache (bulk path)
        self.CACHE_BYPASS_BYTES = 4 * 1024 * 1024
        self._readahead: dict[int, ReadaheadAdviser] = {}
        # operation log ring + counters (.oplog / .stats analog)
        from collections import deque

        self.oplog: deque = deque(maxlen=1024)
        self.op_counters: dict[str, int] = {}
        # serialize concurrent writes per (inode, chunk): read-modify-
        # write on a shared stripe must not interleave (FUSE is
        # multithreaded; the reference serializes via its per-inode
        # write journal, writedata.cc)
        # (inode, chunk) -> [asyncio.Lock, refcount]; see _pwrite_chunk
        self._chunk_write_locks: dict[tuple[int, int], list] = {}
        # open handles this client registered: inode -> [handle ids]
        # (release() without an explicit handle drops the most recent)
        self._open_handles: dict[int, list[int]] = {}
        # (parent inode, name) -> (inode, expiry): TTL dentry cache for
        # path walks (see resolve); LRU-bounded
        from collections import OrderedDict as _OD

        self._dentry: "_OD[tuple[int, str], tuple[int, float]]" = _OD()
        # last-seen per-inode extra-attribute flags, learned from every
        # attr-bearing reply (the Attr blob's trailing ``eattr``):
        # EATTR_NOCACHE bypasses the block cache for the inode,
        # EATTR_NOENTRYCACHE keeps it out of the dentry cache
        self._eattr: dict[int, int] = {}
        # reusable stripe-scatter staging buffers, keyed (d, part_len):
        # a fresh 64 MiB allocation pays its page faults inside the
        # scatter copy (~2x measured cost); the write window keeps at
        # most 2 chunks in flight, so 2 buffers per shape suffice
        self._stage_buffers: dict[tuple[int, int], list[np.ndarray]] = {}
        # waiting lock requests: (inode, token) -> grant queue
        self._lock_grants: dict[tuple[int, int], asyncio.Queue] = {}
        # identity attached to permission-checked ops when the caller
        # doesn't supply one (FUSE passes the kernel caller's context)
        self.default_uid = 0
        self.default_gids = [0]
        # cluster-wide QoS (LimiterProxy analog): per limit-group
        # TokenBuckets paced by master-granted shares. Callers are
        # classified into cgroup limit groups (reference:
        # src/mount/io_limit_group.cc) — FUSE sets IO_CALLER_PID so a
        # mount shared by several containers throttles each container
        # under its own group's budget; other consumers fall under this
        # process's own cgroup.
        from lizardfs_tpu_torch.client.io_limit_group import GroupCache

        # group -> {"bucket": TokenBucket|None, "next_renew": float}
        self._io_groups: dict[str, dict] = {}
        self._io_subsystem = ""  # learned from master replies
        self._io_group_cache = GroupCache("")
        # True while the master has ANY limit configured: unthrottled
        # fast paths (FUSE native read pool) must stand down so every
        # byte passes _throttle (the fast path cannot classify or pace)
        self.io_limits_active = False
        self.io_limits_probe_interval = 5.0
        self._limits_probe_task: asyncio.Task | None = None
        # how long a lost master may stay unreachable before ops fail
        # (election + promotion fit well inside this on a sane cluster)
        self.failover_timeout = 15.0
        # single-flight registration: concurrent ops all failing on a
        # dead master each call _reconnect; without serialization every
        # one runs its own registration handshake and the master
        # allocates a session per loser (the cross-await-race class the
        # invariant lint flags). The lock serializes registration, the
        # generation lets queued reconnects detect that a peer already
        # finished the job while they waited.
        self._conn_lock = asyncio.Lock()
        self._conn_gen = 0
        # bumped when a failover window EXHAUSTS: ops queued on the
        # lock behind a failed reconnect must fail fast, not each
        # serially re-run their own full failover_timeout window
        self._reconnect_fail_gen = 0
        # end-to-end budget for one retried data op (_retry_transient):
        # the RetryPolicy deadline that nested dials/RPC waits inherit,
        # so a wedged chunk write fails the caller in bounded time
        # instead of attempts x timeouts wall-clock
        self.op_deadline = 60.0
        # read-locate cache (reference: src/mount/chunk_locator.h
        # ReadChunkLocator's timed cache): repeat reads of a chunk skip
        # the master RPC entirely. Coherence mirrors the BlockCache's
        # three layers: dropped by the SAME invalidations (local writes,
        # truncate, master pushes — via the listener below), bypassed on
        # every read retry (a dead/stale holder re-locates), and
        # TTL-bounded as the backstop.
        self._locate_cache: dict[tuple[int, int], tuple[object, float]] = {}
        self._locate_epoch: dict[int, int] = {}
        # bumped whenever _locate_epoch is bulk-cleared: folded into the
        # per-inode epoch token so a clear can never reset an inode to a
        # previously-seen epoch value (which would let an in-flight
        # locate that raced the clear cache a pre-mutation reply)
        self._locate_gen = 0
        self.locate_cache_ttl = 3.0
        self.cache.add_invalidate_listener(self._drop_locates)
        # per-phase busy-time accounting for the write data path
        # (encode/stage/send/ack/commit); pipelined phases overlap, so
        # the phase sum may exceed wall time — see runtime.metrics.
        # "send" is the push cost (socket copy, or descriptor writes on
        # the shm-ring plane); "ack" is the windowed path's completion
        # wait (downstream backpressure). Through r06 ack waits were
        # folded into send_ms — compare r07+ send_ms to older rounds as
        # send_ms + ack_ms.
        self.write_phases = PhaseBreakdown(
            "client_write", ("encode", "stage", "send", "ack", "commit")
        )
        # the read-side twin: busy-time per logical read decomposed as
        # locate (master RPC), dial (pool-miss connects), wait (QoS
        # throttle + retry backoff + shed waits), net (socket transfer,
        # incl. the native gather call), decode (plan postprocess /
        # EC recovery), gather (stripe de-interleave), and the parts
        # of these that tracing.READ_SUBPHASES names. Deep layers that
        # can't see the client (conn pool, read executor, encoder seam)
        # charge via tracing.PHASE_SINK, activated around each logical
        # read.
        self.read_phases = PhaseBreakdown(
            "client_read", tracing.READ_PHASES + tracing.READ_SUBPHASES,
        )
        # request-scoped span ring (runtime/tracing.py): phase charges
        # double as client-role spans when the op runs under a trace;
        # merge with daemon `trace-dump` output via tracing.merge_timeline
        self.trace_ring = tracing.SpanRing()
        # double-buffered stripe pipeline for striped (xor/ec) chunk
        # writes: encode stripe segment i+1 while segment i's parts are
        # in flight. LZ_WRITE_PIPELINE=0 is the kill switch (strictly
        # serial stage->encode->send ordering, the byte-identity golden
        # reference); LZ_WRITE_PIPELINE_SEGMENTS tunes pipeline depth.
        self.write_pipeline = env_flag("LZ_WRITE_PIPELINE")
        try:
            self.write_pipeline_segments = max(
                2, int(_os.environ.get("LZ_WRITE_PIPELINE_SEGMENTS", "4"))
            )
        except ValueError:
            self.write_pipeline_segments = 4
        # below this chunk payload size the per-segment handshake
        # overhead outweighs the overlap win — serial path handles it
        self.WRITE_PIPELINE_MIN_BYTES = 8 * 1024 * 1024
        # client-side metrics registry: the write window registers its
        # depth/credit/coalesce series here. Embedders that export a
        # registry pass their own (the NFS gateway shares its
        # gateway-local registry so the window series surface wherever
        # it is scraped); library users get a private one, readable as
        # Client.metrics.to_prometheus().
        from lizardfs_tpu_torch.runtime.metrics import Metrics

        self.metrics = metrics if metrics is not None else Metrics()
        # adaptive N-deep write window (spends the write phase telemetry):
        # up to LZ_WRITE_WINDOW stripe segments ride unacknowledged per
        # striped chunk write under per-chunkserver credits + a shared
        # staging-byte budget, with depth adapted from live encode/send
        # busy fractions; finished chunks coalesce their WriteChunkEnd
        # commits into one master round trip per window flush.
        # LZ_WRITE_WINDOW=0 is the kill switch: the double-buffered
        # pipeline (per-segment ack barriers, per-chunk commits) runs
        # byte- and wire-identically to before.
        from lizardfs_tpu_torch.client.write_window import WriteWindow

        try:
            _depth = int(_os.environ.get("LZ_WRITE_WINDOW", "8"))
        except ValueError:
            _depth = 8
        try:
            _cs_credits = int(_os.environ.get("LZ_WRITE_CS_CREDITS", "0"))
        except ValueError:
            _cs_credits = 0
        try:
            _budget_mb = int(
                _os.environ.get("LZ_WRITE_WINDOW_BYTES_MB", "128")
            )
        except ValueError:
            _budget_mb = 128
        self.write_window = (
            WriteWindow(
                _depth, metrics=self.metrics,
                cs_credits=_cs_credits or None,
                budget_bytes=max(_budget_mb, 1) * 2**20,
            )
            if _depth > 0 else None
        )
        # shadow read replicas (LZ_SHADOW_READS kill switch, default on
        # when more than one master address is configured): read-mostly
        # metadata RPCs route to a shadow serving consistency-tokened
        # replies; anything mutating still goes to the primary only.
        # Monotonic reads: every reply's token (meta_version = applied
        # changelog position) ratchets _meta_floor, and a replica reply
        # older than the floor is retried through the primary. With the
        # switch off (or a single address) every RPC goes to the
        # primary exactly as before.
        from lizardfs_tpu_torch.constants import shadow_reads_enabled

        self.shadow_reads = (
            shadow_reads_enabled() and len(self.master_addrs) > 1
        )
        self._meta_floor = 0
        # CRC-rejected parts already reported to the master this
        # session: one report per (chunk, part, holder) — a degraded
        # chunk re-read every second must not spam the master
        self._damage_reported: set = set()
        # fault-injection fires attributed to the client role land in
        # this registry (faults_injected{site,action})
        _faults.attach_metrics("client", self.metrics)
        # per-session op accounting (runtime/accounting.py): LOGICAL
        # reads/writes charge exactly once at the public-API boundary —
        # replica fallbacks, transient retries, and RMW retry loops are
        # implementation detail below this line (the double-count
        # class, pinned across detsched seeds in test_op_accounting).
        # Gateways share this registry, so their per-session view rides
        # whatever exporter embeds the client.
        self.session_ops = accounting.SessionOps(
            self.metrics, "client", max_sessions=8
        )
        self._replica: RpcConnection | None = None
        self._replica_addr: tuple[str, int] | None = None
        self._replica_retry_at = 0.0
        self._replica_dialing = False
        if self.shadow_reads:
            self.metrics.counter(
                "shadow_reads",
                help="read RPCs served by a shadow replica",
            )
            self.metrics.counter(
                "shadow_stale_retries",
                help="replica replies older than the monotonic-reads "
                     "floor, retried through the primary",
            )
            self.metrics.counter(
                "shadow_fallbacks",
                help="replica RPCs rerouted to the primary (connection "
                     "failure or replica refusal)",
            )

    def _io_group_of_caller(self) -> str:
        import os

        pid = IO_CALLER_PID.get()
        return self._io_group_cache.classify(
            pid if pid is not None else os.getpid()
        )

    async def _throttle(self, nbytes: int) -> None:
        """Apply the master-coordinated IO limit to a data transfer,
        under the calling process's limit group. Traced as its own
        ``throttle`` span: QoS pacing and the limit-renew RPC are
        deliberately excluded from the send phase (charging pacing as
        transfer time would misattribute), so without a span of their
        own they would be an anonymous hole in every merged timeline."""
        t0 = _time.perf_counter()
        try:
            await self._throttle_inner(nbytes)
        finally:
            self.trace_ring.record(
                tracing.current_trace_id(), "throttle", t0,
                _time.perf_counter(), role="client",
            )

    async def _throttle_inner(self, nbytes: int) -> None:
        group = self._io_group_of_caller()
        state = self._io_groups.setdefault(
            group, {"bucket": None, "next_renew": 0.0}
        )
        now = _time.monotonic()
        if now >= state["next_renew"]:
            state["next_renew"] = now + 1.0
            try:
                r = await self.master.call(
                    m.CltomaIoLimitRequest, group=group, probe=0,
                    timeout=5.0
                )
                rate = float(r.bytes_per_sec)
                state["next_renew"] = now + r.renew_ms / 1000.0
                self.io_limits_active = bool(
                    getattr(r, "limits_active", 0)
                )
                if r.subsystem != self._io_subsystem:
                    # master names the cgroup hierarchy to classify in;
                    # reclassify everyone under it from now on
                    from lizardfs_tpu_torch.client.io_limit_group import GroupCache

                    self._io_subsystem = r.subsystem
                    self._io_group_cache = GroupCache(r.subsystem)
                if rate <= 0:
                    state["bucket"] = None
                elif state["bucket"] is None:
                    from lizardfs_tpu_torch.runtime.limiter import TokenBucket

                    bucket = TokenBucket(rate, burst=rate)
                    bucket._tokens = 0.0  # pace from the start
                    state["bucket"] = bucket
                else:
                    state["bucket"].rate = rate
                    state["bucket"].burst = rate
            except (ConnectionError, asyncio.TimeoutError, st.StatusError):
                pass  # keep the previous allocation
        if state["bucket"] is not None:
            await state["bucket"].acquire(nbytes)

    def _uid(self, uid) -> int:
        return self.default_uid if uid is None else uid

    def _ident(self, uid, gids) -> dict:
        return {
            "uid": self._uid(uid),
            "gids": list(self.default_gids) if gids is None else list(gids),
        }

    def _record(self, op: str, **kw) -> None:
        self.oplog.append((_time.time(), op, kw))
        self.op_counters[op] = self.op_counters.get(op, 0) + 1

    async def _retry_transient(self, what: str, attempt_fn) -> None:
        """Run ``attempt_fn`` under the unified RetryPolicy
        (runtime/retry.py): jittered exponential backoff on TRANSIENT
        failures, permanent errors surface immediately, and the policy's
        end-to-end deadline threads through nested calls (dials, RPC
        timeouts) so stacked retries share ONE budget instead of
        multiplying. Always makes at least one attempt regardless of
        the retries setting."""
        policy = retrymod.RetryPolicy(
            attempts=max(self.retries, 1),
            base_delay=0.2, max_delay=2.0,
            deadline=self.op_deadline,
            transient=_is_transient,
        )
        try:
            await policy.run(attempt_fn, what=what, log=log)
        except retrymod.RetryError as e:
            raise st.StatusError(
                st.EIO, f"{what} failed after retries: {e.last}"
            ) from e.last

    # --- session -----------------------------------------------------------------

    async def connect(self, info: str = "pyclient", password: str = "") -> None:
        # single-flight: registration mutates session identity
        # (session_id, master conn, token floor) across awaits — only
        # one coroutine may run the handshake at a time. _reconnect
        # holds the same lock around its whole failover policy.
        async with self._conn_lock:
            await self._connect_locked(info, password)

    async def _connect_locked(self, info: str, password: str) -> None:
        """Registration handshake body. Caller MUST hold _conn_lock."""
        self._info = info
        self._password = password
        # spawn the native-IO pool threads while the process is quiet:
        # lazy spawn inside submit() blocks the event loop under GIL
        # pressure (measured 150-600 ms during EC write fan-out)
        from lizardfs_tpu_torch.core import native_io

        if native_io.available():
            native_io.prestart_executors()
        last: Exception | None = None
        for addr in self.master_addrs:
            try:
                conn = await RpcConnection.connect(*addr)
                reply = await conn.call_ok(
                    m.CltomaRegister, session_id=self.session_id, info=info,
                    password=password,
                    # fencing epoch echo: a zombie ex-primary steps down
                    # on seeing a higher epoch than it ever applied
                    epoch=self.cluster_epoch,
                )
                self.cluster_epoch = max(
                    self.cluster_epoch, getattr(reply, "epoch", 0)
                )
                self.master = conn
                self.current_master_addr = addr  # failover moves this
                # lint: waive(cross-await-race): every caller holds _conn_lock (connect/_reconnect) — the handshake is single-flight and adopts the server-issued id
                self.session_id = reply.session_id
                # the identity this process's data-plane requests carry
                # (CltocsRead/WriteInit trailing session_id): module-
                # global because read_executor is module functions
                accounting.set_process_session(self.session_id)
                # the primary's position at registration seeds the
                # monotonic-reads floor: a replica must be at least
                # this caught up before any of its replies are accepted
                self._note_token(reply)
                if self._replica_addr == addr:
                    # the old replica peer is the new primary
                    await self._drop_replica()
                conn.on_push(m.MatoclLockGranted, self._on_lock_granted)
                conn.on_push(
                    m.MatoclCacheInvalidate, self._on_cache_invalidate
                )
                # one-shot probe: fast paths (FUSE native reads) need to
                # know AT MOUNT TIME whether any IO limit is configured
                # — a read-only workload would otherwise never learn.
                # Errors stay inside the helper: registration already
                # succeeded, so a failed probe must not fail over to
                # the next master address
                await self._probe_limits_active()
                # keep the flag tracking RUNTIME config changes: a
                # read-only workload on the native fast path never
                # calls _throttle, so a SIGHUP that enables limits
                # would otherwise go unnoticed forever
                if (self._limits_probe_task is None
                        or self._limits_probe_task.done()):
                    # detached: connect() may run inside a failover
                    # RetryPolicy and this loop outlives its deadline
                    self._limits_probe_task = retrymod.spawn_detached(
                        self._limits_probe_loop()
                    )
                # registration generation: reconnects queued on
                # _conn_lock see the bump and skip their own handshake
                self._conn_gen += 1
                return
            except (OSError, ConnectionError, st.StatusError, asyncio.TimeoutError) as e:
                last = e
        raise ConnectionError(f"no active master reachable: {last}")

    def _t0(self) -> float:
        """``perf_counter`` stamp opening a phase: it feeds the
        PhaseBreakdown and anchors the span's timeline."""
        return _time.perf_counter()

    def _phase(self, name: str, t0: float) -> None:
        """Charge a write phase and, when the op runs under a trace,
        record the same interval as a client-role span."""
        t1 = _time.perf_counter()
        self.write_phases.add(name, t1 - t0)
        self.trace_ring.record(
            tracing.current_trace_id(), name, t0, t1, role="client",
        )

    def _read_phase(self, name: str, t0: float) -> None:
        """Charge a read phase (+ client-role span under a trace)."""
        self._read_sink(name, t0, _time.perf_counter())

    def _read_sink(self, phase: str, t0: float, t1: float) -> None:
        """tracing.PHASE_SINK target: layers below the client (connection
        pool dials, read-executor socket waits and plan postprocess,
        off-loop hops, the encoder seam) charge the ambient logical
        read's phases here. Pool-miss dials double as the ``dial``
        queue-wait gate."""
        self.read_phases.add(phase, max(t1 - t0, 0.0))
        tid = tracing.current_trace_id()
        if tid:
            self.trace_ring.record(
                tid, f"read:{phase}", t0, t1, role="client"
            )
        if phase == "dial":
            # ring=None: the read:dial span above already lands in the
            # attribution queue bucket; a twin span would be noise
            tracing.charge_queue_wait(
                self.metrics, None, "dial", "default", t0, role="client"
            )

    async def _busy_retry(self, fn, what: str):
        """Honor QoS fair-share sheds: a BUSY status is retried here
        with a jittered backoff seeded by the server's retry-after
        hint, clamped by the ambient RetryPolicy deadline so stacked
        layers never amplify the wait. Exhausted attempts (or a budget
        too small for even one backoff) surface the BUSY StatusError —
        gateways map it (S3: 503 SlowDown, NFS: JUKEBOX delay)."""
        attempt = 0
        while True:
            try:
                return await fn()
            except st.StatusError as e:
                if e.code != st.BUSY:
                    raise
                if getattr(e, "_busy_exhausted", False):
                    # an INNER busy-retry layer (e.g. _call inside a
                    # _call_read fallback) already burned its attempts:
                    # retrying here would amplify to attempts^2 and
                    # re-record the op on each re-entry
                    raise
                delay = qosmod.busy_backoff_s(e.retry_after_ms, attempt)
                rem = retrymod.budget()
                if attempt >= self.busy_retries or (
                    rem is not None and rem <= delay
                ):
                    e._busy_exhausted = True
                    raise
                self.metrics.counter(
                    "qos_busy_waits",
                    help="master RPCs shed with BUSY by fair-share "
                         "admission and retried after backoff",
                ).inc()
                log.debug("%s shed (BUSY), retry %d in %.3fs",
                          what, attempt + 1, delay)
                # shed-retry waits are a queue-wait gate: the op did no
                # work, it queued behind fair-share admission
                w0 = tracing.phase_t0()
                await asyncio.sleep(delay)
                tracing.charge_queue_wait(
                    self.metrics, self.trace_ring, "busy_retry", "default",
                    w0, role="client",
                )
                tracing.charge_phase("wait", w0)
                attempt += 1

    async def _call(self, msg_cls, **fields):
        """Master RPC with transparent reconnect+retry on a lost or
        demoted master (failover support) and backoff+retry on QoS
        sheds. RPCs whose schema carries the trailing ``trace_id``
        field get the current request trace attached automatically."""
        # record ONCE, outside the busy-retry loop: a shed-and-retried
        # op is one logical op in op_counters/oplog
        self._record(msg_cls.__name__)
        return await self._busy_retry(
            lambda: self._call_once(msg_cls, **fields), msg_cls.__name__
        )

    async def _call_once(self, msg_cls, **fields):
        if msg_cls.FIELDS and msg_cls.FIELDS[-1][0] == "trace_id":
            tid = tracing.current_trace_id()
            if tid:
                fields.setdefault("trace_id", tid)
        try:
            r = await self.master.call_ok(msg_cls, **fields)
        except (ConnectionError, asyncio.TimeoutError):
            await self._reconnect()
            r = await self.master.call_ok(msg_cls, **fields)
        self._note_token(r)
        self._note_eattr(getattr(r, "attr", None))
        return r

    @staticmethod
    def _token_of(reply) -> int:
        """Consistency token of a reply: its trailing ``meta_version``,
        or the nested Attr's (MatoclAttrReply carries the token on the
        Attr tail — Attr must stay the message's terminal field)."""
        mv = getattr(reply, "meta_version", 0)
        if not mv:
            mv = getattr(getattr(reply, "attr", None), "meta_version", 0)
        return mv

    def _note_token(self, reply) -> None:
        """Ratchet the monotonic-reads floor from any tokened reply
        (primary or replica — the floor is what the session has
        OBSERVED, wherever it observed it)."""
        mv = self._token_of(reply)
        if mv > self._meta_floor:
            self._meta_floor = mv

    async def _drop_replica(self) -> None:
        conn, self._replica = self._replica, None
        self._replica_addr = None
        if conn is not None:
            await conn.close()

    async def _replica_conn(self) -> "RpcConnection | None":
        """The live replica connection, dialing one lazily. Dial
        failures back off 5 s and the caller falls through to the
        primary — replica trouble must never add latency beyond the one
        failed attempt (primary-fallback contract)."""
        conn = self._replica
        if conn is not None and not conn.closed:
            return conn
        now = _time.monotonic()
        if (
            self._replica_dialing
            or now < self._replica_retry_at
            or not self.session_id
        ):
            return None
        self._replica_dialing = True
        self._replica_retry_at = now + 5.0
        try:
            for addr in self.master_addrs:
                if addr == self.current_master_addr:
                    continue
                conn = None
                try:
                    # bounded dial: a blackholed shadow must cost the
                    # caller ~2 s once per retry window, never the OS
                    # connect timeout (primary-fallback contract)
                    conn = await asyncio.wait_for(
                        RpcConnection.connect(*addr), timeout=2.0
                    )
                    reply = await conn.call(
                        m.CltomaRegister, session_id=self.session_id,
                        info=self._info + "/replica",
                        password=getattr(self, "_password", ""),
                        replica_ok=1, epoch=self.cluster_epoch,
                        timeout=5.0,
                    )
                    # replica replies carry the shadow's replayed epoch:
                    # adopting it here means the NEXT primary redial
                    # presents the post-election epoch even if the
                    # client never reached the new active yet
                    self.cluster_epoch = max(
                        self.cluster_epoch, getattr(reply, "epoch", 0)
                    )
                    if getattr(reply, "status", 1) == st.OK:
                        self._note_token(reply)
                        self._replica = conn
                        self._replica_addr = addr
                        return conn
                    await conn.close()
                except (OSError, ConnectionError, asyncio.TimeoutError):
                    if conn is not None:
                        await conn.close()
            return None
        finally:
            self._replica_dialing = False

    async def _call_read(self, msg_cls, **fields):
        """Read-mostly RPC, routed to a shadow replica when one serves.

        The monotonic-reads contract: accept a replica reply only when
        its token is >= the floor this session has observed; otherwise
        count a stale retry and re-issue through the primary. Replica
        connection failures and refusals (NOT_POSSIBLE — promoted
        shadow, server-side kill switch, non-servable op) fall through
        to the primary too. QoS BUSY sheds (either leg) back off and
        retry via _busy_retry — a shed is never an error and never a
        spurious stale-retry count."""
        if not self.shadow_reads:
            return await self._call(msg_cls, **fields)
        return await self._busy_retry(
            lambda: self._call_read_once(msg_cls, **fields),
            msg_cls.__name__,
        )

    async def _call_read_once(self, msg_cls, **fields):
        # ONE busy-retry layer: every fallback below re-enters
        # _call (whose own busy loop handles primary sheds); a replica
        # BUSY raises out to _call_read's wrapper instead of nesting
        conn = await self._replica_conn()
        if conn is None:
            return await self._call(msg_cls, **fields)
        # same trace attachment as _call: a replica-served read must
        # not vanish from request traces (the serving-master span is
        # exactly what replica-latency debugging needs)
        if msg_cls.FIELDS and msg_cls.FIELDS[-1][0] == "trace_id":
            tid = tracing.current_trace_id()
            if tid:
                fields.setdefault("trace_id", tid)
        try:
            r = await conn.call(msg_cls, timeout=10.0, **fields)
        except (OSError, ConnectionError, asyncio.TimeoutError):
            await self._drop_replica()
            self.metrics.counter("shadow_fallbacks").inc()
            return await self._call(msg_cls, **fields)
        status = getattr(r, "status", 0)
        if status == st.NOT_POSSIBLE:
            # refusal (promoted shadow, cut follow link, server-side
            # kill switch): drop the link and back off — keeping it
            # would pay a wasted round trip on EVERY read for as long
            # as the condition lasts
            await self._drop_replica()
            self._replica_retry_at = _time.monotonic() + 5.0
            self.metrics.counter("shadow_fallbacks").inc()
            return await self._call(msg_cls, **fields)
        if status == st.BUSY:
            # fair-share shed on the replica leg: checked BEFORE the
            # token floor (the tokenless BUSY reply is a shed, not
            # staleness — it must not count a spurious stale retry).
            # The link stays up; _call_read's wrapper backs off and
            # retries through whichever leg serves then.
            raise st.StatusError(
                st.BUSY, msg_cls.__name__,
                retry_after_ms=getattr(r, "retry_after_ms", 0),
            )
        if self._token_of(r) < self._meta_floor:
            self.metrics.counter("shadow_stale_retries").inc()
            return await self._call(msg_cls, **fields)
        self._note_token(r)
        self.metrics.counter("shadow_reads").inc()
        # record ONLY on the replica-served path: every fallback above
        # re-enters _call, which records — one logical op must count
        # once in op_counters/oplog wherever it was served
        self._record(msg_cls.__name__)
        r._replica_served = True  # read-path guards key off this
        if status != st.OK:
            raise st.StatusError(status, msg_cls.__name__)
        self._note_eattr(getattr(r, "attr", None))
        return r

    def _note_eattr(self, attr) -> None:
        """Track per-inode eattr flags from any attr-bearing reply so
        cache paths can enforce NOCACHE/NOENTRYCACHE without a second
        RPC. Zero flags still overwrite (a cleared flag must lift)."""
        if attr is None or not getattr(attr, "inode", 0):
            return
        if len(self._eattr) > 65536:
            # bound by dropping only UNFLAGGED entries: forgetting a
            # zero costs nothing (0 is the default), while forgetting a
            # NOCACHE/NOENTRYCACHE flag would silently re-enable the
            # caches the flag forbids until the next attr reply
            self._eattr = {k: v for k, v in self._eattr.items() if v}
        self._eattr[attr.inode] = attr.eattr

    async def _reconnect(self) -> None:
        """Cycle the master address list with backoff until one accepts
        (or ``failover_timeout`` passes): after the active master dies,
        an election takes time — during it EVERY address refuses (dead)
        or answers NOT_POSSIBLE (still shadow), and a single pass would
        fail exactly the ops the address list exists to save (reference:
        the mount's fs_reconnect loop). Expressed as a RetryPolicy so
        the failover window is ONE deadline every nested dial inherits
        (a blackholed master host — SYN silently dropped — costs a
        bounded attempt, never the OS ~2 min SYN timeout).

        Single-flight: every op failing on the dead master lands here
        at once. The first holds _conn_lock through the whole failover
        window; the rest queue on the lock and, once inside, see the
        bumped registration generation and return without running a
        second handshake against the fresh master."""
        gen = self._conn_gen
        fail_gen = self._reconnect_fail_gen
        async with self._conn_lock:
            if self._conn_gen != gen:
                return  # a queued-ahead reconnect already registered
            if self._reconnect_fail_gen != fail_gen:
                # a queued-ahead reconnect already burned a full
                # failover window and lost — fail this op now instead
                # of serially burning another window per waiter
                raise ConnectionError(
                    "failover window exhausted (concurrent reconnect)"
                )
            policy = retrymod.RetryPolicy(
                attempts=10_000,  # the deadline, not the count, bounds
                base_delay=0.1, max_delay=1.0, jitter=0.2,
                deadline=self.failover_timeout,
                attempt_timeout=5.0 * len(self.master_addrs),
                transient=lambda e: isinstance(
                    e, (ConnectionError, OSError, asyncio.TimeoutError)
                ),
            )
            try:
                await policy.run(
                    lambda: self._connect_locked(
                        self._info, getattr(self, "_password", "")
                    ),
                    what="master failover", log=log,
                )
            except retrymod.RetryError as e:
                self._reconnect_fail_gen += 1
                raise ConnectionError(
                    f"failover window exhausted: {e.last}"
                ) from None

    async def _probe_limits_active(self) -> None:
        """Probe-only IoLimitRequest (probe=1: never joins the
        allocation table): refresh io_limits_active, swallowing every
        transport error — callers must not fail on a lost probe."""
        try:
            r = await self.master.call(
                m.CltomaIoLimitRequest, group="", probe=1, timeout=5.0
            )
            self.io_limits_active = bool(getattr(r, "limits_active", 0))
        except (ConnectionError, OSError, asyncio.TimeoutError,
                st.StatusError):
            pass  # reconnect path re-probes at connect

    def _drop_locates(self, inode: int) -> None:
        """BlockCache invalidate-listener + end-of-write hook: any
        invalidation of an inode's data drops its cached chunk
        locations, and bumps the inode's epoch so an in-flight locate
        that raced the invalidation refuses to store its reply (the
        BlockCache's revoked-put rule, applied to locations)."""
        for key in [k for k in self._locate_cache if k[0] == inode]:
            del self._locate_cache[key]
        self._locate_epoch[inode] = self._locate_epoch.get(inode, 0) + 1
        if len(self._locate_epoch) > 65536:
            # bulk-evict the bound, but never reset an inode to a
            # previously-seen epoch: the generation makes every
            # pre-clear token stale forever (ADVICE r05)
            self._locate_epoch.clear()
            self._locate_gen += 1

    def _locate_token(self, inode: int) -> tuple[int, int]:
        """Epoch token captured before a locate RPC and compared after:
        unequal means an invalidation (or a table clear) raced the RPC
        and the reply must not be cached. Folding the clear generation
        in keeps tokens unique across `_locate_epoch.clear()`."""
        return (self._locate_gen, self._locate_epoch.get(inode, 0))

    async def _limits_probe_loop(self) -> None:
        """Periodic probe so io_limits_active tracks runtime config
        reloads (SIGHUP/admin) even on workloads that never _throttle."""
        while True:
            await asyncio.sleep(self.io_limits_probe_interval)
            await self._probe_limits_active()

    async def close(self) -> None:
        if self._limits_probe_task is not None:
            self._limits_probe_task.cancel()
            self._limits_probe_task = None
        await self._drop_replica()
        if self.master is not None:
            if self.read_phases.reps or self.write_phases.reps:
                # parting stats push: the session's phase breakdowns
                # stay visible in `top` past disconnect (best effort)
                await self.push_session_stats()
            try:
                # clean goodbye: the master releases our locks now
                # instead of holding them for the crash-grace window
                await self.master.call(m.CltomaGoodbye, timeout=2.0)
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    st.StatusError):
                pass
            await self.master.close()

    # --- metadata ops ---------------------------------------------------------------

    async def lookup(self, parent: int, name: str, uid: int | None = None,
                     gids: list[int] | None = None) -> m.Attr:
        r = await self._call_read(
            m.CltomaLookup, parent=parent, name=name, **self._ident(uid, gids)
        )
        return r.attr

    async def open(self, inode: int) -> int:
        """Register an open handle with the master: while held, the
        file survives unlink/trash-expiry (sustained files — reference
        "reserved" namespace). Returns the handle id to pass to
        release() (retry-safe: the master dedupes on it)."""
        import secrets

        handle = secrets.randbits(64)
        await self._call(m.CltomaOpen, inode=inode, handle=handle)
        self._open_handles.setdefault(inode, []).append(handle)
        return handle

    async def release(self, inode: int, handle: int | None = None) -> None:
        """Drop one open handle (best effort: a lost release is cleaned
        up by the master's session teardown / orphan sweep)."""
        handles = self._open_handles.get(inode, [])
        if handle is None:
            handle = handles[-1] if handles else 0
        if handle in handles:
            handles.remove(handle)
            if not handles:
                self._open_handles.pop(inode, None)
        try:
            await self._call(m.CltomaRelease, inode=inode, handle=handle)
        except (st.StatusError, ConnectionError, asyncio.TimeoutError):
            pass

    async def getattr(self, inode: int) -> m.Attr:
        r = await self._call_read(m.CltomaGetattr, inode=inode)
        return r.attr

    async def tape_info(self, inode: int) -> dict:
        """Tape-copy state: {"wanted", "pending", "copies", "fresh",
        "demoted", "recalling", "forced"}."""
        import json as _json

        r = await self._call(m.CltomaTapeInfo, inode=inode)
        return _json.loads(r.json)

    async def tape_demote(self, inode: int, uid: int | None = None,
                          gids: list[int] | None = None) -> None:
        """Demote a file to the tape tier (frees its chunk data once a
        fresh archival copy exists). CHUNK_BUSY means the master queued
        a forced archive — retry after it lands."""
        await self._call(
            m.CltomaTapeDemote, inode=inode, **self._ident(uid, gids)
        )
        self._drop_locates(inode)
        self.cache.invalidate(inode)

    async def tape_recall(self, inode: int) -> None:
        """Recall a demoted file from the tape tier; returns once the
        master restored the bytes (no-op for a live file). Callers that
        hit TAPE_RECALL on a read retry it after this resolves."""
        await self._call(m.CltomaTapeRecall, inode=inode)
        self._drop_locates(inode)
        self.cache.invalidate(inode)

    async def statfs(self) -> tuple[int, int]:
        """Cluster (total_bytes, available_bytes) across chunkservers."""
        r = await self._call(m.CltomaStatFs)
        return r.total_space, r.avail_space

    async def mkdir(
        self, parent: int, name: str, mode: int = 0o755, uid: int = 0, gid: int = 0
    ) -> m.Attr:
        r = await self._call(
            m.CltomaMkdir, parent=parent, name=name, mode=mode, uid=uid, gid=gid
        )
        self._dentry_drop(parent, name)
        return r.attr

    async def create(
        self, parent: int, name: str, mode: int = 0o644, uid: int = 0, gid: int = 0
    ) -> m.Attr:
        r = await self._call(
            m.CltomaCreate, parent=parent, name=name, mode=mode, uid=uid, gid=gid
        )
        self._dentry_drop(parent, name)
        return r.attr

    async def readdir(self, inode: int, uid: int | None = None,
                      gids: list[int] | None = None) -> list[m.DirEntry]:
        r = await self._call_read(
            m.CltomaReaddir, inode=inode, **self._ident(uid, gids)
        )
        return r.entries

    async def unlink(self, parent: int, name: str, uid: int | None = None,
                     gids: list[int] | None = None) -> None:
        await self._call(
            m.CltomaUnlink, parent=parent, name=name, **self._ident(uid, gids)
        )
        self._dentry_drop(parent, name)

    async def rmdir(self, parent: int, name: str, uid: int | None = None,
                     gids: list[int] | None = None) -> None:
        await self._call(
            m.CltomaRmdir, parent=parent, name=name, **self._ident(uid, gids)
        )
        self._dentry_drop(parent, name)

    async def rename(self, psrc: int, nsrc: str, pdst: int, ndst: str,
                     uid: int | None = None,
                     gids: list[int] | None = None) -> None:
        await self._call(
            m.CltomaRename,
            parent_src=psrc, name_src=nsrc, parent_dst=pdst, name_dst=ndst,
            **self._ident(uid, gids),
        )
        self._dentry_drop(psrc, nsrc)
        self._dentry_drop(pdst, ndst)

    async def symlink(self, parent: int, name: str, target: str,
                      uid: int = 0, gid: int = 0) -> m.Attr:
        r = await self._call(
            m.CltomaSymlink, parent=parent, name=name, target=target,
            uid=uid, gid=gid
        )
        self._dentry_drop(parent, name)
        return r.attr

    async def readlink(self, inode: int) -> str:
        r = await self._call_read(m.CltomaReadlink, inode=inode)
        return r.target

    async def link(self, inode: int, parent: int, name: str,
                   uid: int | None = None,
                   gids: list[int] | None = None) -> m.Attr:
        r = await self._call(
            m.CltomaLink, inode=inode, parent=parent, name=name,
            **self._ident(uid, gids),
        )
        self._dentry_drop(parent, name)
        return r.attr

    async def setgoal(self, inode: int, goal: int,
                      uid: int | None = None) -> None:
        await self._call(m.CltomaSetGoal, inode=inode, goal=goal,
                         uid=self._uid(uid))

    async def geteattr(self, inode: int) -> int:
        """Per-inode extra-attribute flags (constants.EATTR_*)."""
        return (await self.getattr(inode)).eattr

    async def seteattr(self, inode: int, eattr: int,
                       uid: int | None = None) -> m.Attr:
        """Set the inode's extra-attribute flags wholesale (the CLI's
        +flag/-flag arithmetic happens client-side over geteattr)."""
        r = await self._call(
            m.CltomaSetEattr, inode=inode, eattr=eattr, uid=self._uid(uid)
        )
        if eattr & EATTR_NOCACHE:
            # stop serving already-cached blocks the moment the flag
            # lands — the flag forbids the cache, not just new fills
            self.cache.invalidate(inode)
        return r.attr

    async def truncate(self, inode: int, length: int, uid: int | None = None,
                       gids: list[int] | None = None) -> m.Attr:
        r = await self._call(
            m.CltomaTruncate, inode=inode, length=length,
            **self._ident(uid, gids),
        )
        self.cache.invalidate(inode)
        return r.attr

    async def setattr(
        self, inode: int, set_mask: int, mode: int = 0, uid: int = 0,
        gid: int = 0, atime: int = 0, mtime: int = 0, trash_time: int = 0,
        caller_uid: int | None = None, caller_gids: list[int] | None = None,
    ) -> m.Attr:
        ident = self._ident(caller_uid, caller_gids)
        r = await self._call(
            m.CltomaSetattr, inode=inode, set_mask=set_mask, mode=mode,
            uid=uid, gid=gid, atime=atime, mtime=mtime, trash_time=trash_time,
            caller_uid=ident["uid"], caller_gids=ident["gids"],
        )
        return r.attr

    async def settrashtime(self, inode: int, seconds: int) -> m.Attr:
        return await self.setattr(inode, 32, trash_time=seconds)

    # directory-entry cache TTL for path walks (reference: the mount's
    # direntry cache / kernel entry_timeout model — staleness across
    # OTHER clients' renames is bounded by this; local mutations
    # invalidate immediately)
    DENTRY_TTL = 1.0

    def _dentry_drop(self, parent: int, name: str) -> None:
        self._dentry.pop((parent, name), None)

    async def resolve(self, path: str) -> m.Attr:
        """Walk an absolute path from the root inode.

        Intermediate DIRECTORY components come from a TTL dentry cache
        (FUSE resolves a path per operation — an uncached walk costs
        O(depth) master RPCs per op); the leaf is always looked up
        fresh so its attributes (size!) are never stale."""
        comps = [c for c in path.strip("/").split("/") if c]
        if not comps:
            return await self.getattr(1)
        now = _time.monotonic()
        parent = 1
        for comp in comps[:-1]:
            hit = self._dentry.get((parent, comp))
            if hit is not None and hit[1] > now:
                self._dentry.move_to_end((parent, comp))
                parent = hit[0]
                continue
            attr = await self.lookup(parent, comp)
            if attr.ftype == m.FTYPE_DIR and not (
                attr.eattr & EATTR_NOENTRYCACHE
            ):
                # lint: waive(cross-await-race): TTL-bounded dentry hint — the key must name the pre-await (parent, comp) the lookup resolved; a racing invalidation costs at most DENTRY_TTL of staleness
                self._dentry[(parent, comp)] = (
                    attr.inode, now + self.DENTRY_TTL
                )
                # reassignment keeps the old LRU slot; a refreshed
                # entry must not be the first evicted
                self._dentry.move_to_end((parent, comp))
                while len(self._dentry) > 65536:
                    self._dentry.popitem(last=False)
            parent = attr.inode
        return await self.lookup(parent, comps[-1])

    async def resolve_parent(self, path: str) -> tuple[m.Attr, str]:
        """-> (parent dir attr, leaf name) for an absolute path."""
        path = path.rstrip("/")
        parent_path, _, name = path.rpartition("/")
        if not name:
            raise st.StatusError(st.EINVAL, "path has no leaf")
        return await self.resolve(parent_path or "/"), name

    async def chunk_info(self, inode: int, chunk_index: int) -> m.MatoclReadChunk:
        """Chunk id/version/locations at a file position (fileinfo)."""
        return await self._call_read(
            m.CltomaReadChunk, inode=inode, chunk_index=chunk_index,
            **self._ident(None, None),
        )

    async def snapshot(self, src_inode: int, dst_parent: int, dst_name: str,
                       uid: int | None = None,
                       gids: list[int] | None = None) -> m.Attr:
        """COW snapshot of a file or subtree (makesnapshot analog)."""
        r = await self._call(
            m.CltomaSnapshot, src_inode=src_inode, dst_parent=dst_parent,
            dst_name=dst_name, **self._ident(uid, gids),
        )
        return r.attr

    async def filerepair(self, inode: int,
                         uid: int | None = None,
                         gids: list[int] | None = None) -> dict:
        """Repair a file with unrecoverable chunks (file_repair.cc
        analog): returns {"repaired_versions", "zeroed",
        "queued_rebuild", "ok_chunks"} counts."""
        import json as _json

        r = await self._call(
            m.CltomaFileRepair, inode=inode, **self._ident(uid, gids)
        )
        return _json.loads(r.json)

    async def append_chunks(self, inode_dst: int, inode_src: int,
                            uid: int | None = None,
                            gids: list[int] | None = None) -> m.Attr:
        """O(1) chunk-level concatenation of src onto dst (appendchunks
        verb; chunks are shared + refcounted, COW on later writes)."""
        r = await self._call(
            m.CltomaAppendChunks, inode_dst=inode_dst,
            inode_src=inode_src, **self._ident(uid, gids),
        )
        self._drop_locates(inode_dst)
        self.cache.invalidate(inode_dst)
        return r.attr

    async def set_xattr(self, inode: int, name: str, value: bytes,
                        uid: int | None = None,
                        gids: list[int] | None = None) -> None:
        await self._call(m.CltomaSetXattr, inode=inode, name=name,
                         value=value, **self._ident(uid, gids))

    async def get_xattr(self, inode: int, name: str,
                        uid: int | None = None,
                        gids: list[int] | None = None) -> bytes:
        r = await self._call(m.CltomaGetXattr, inode=inode, name=name,
                             **self._ident(uid, gids))
        return r.value

    async def remove_xattr(self, inode: int, name: str,
                           uid: int | None = None,
                           gids: list[int] | None = None) -> None:
        await self._call(m.CltomaSetXattr, inode=inode, name=name, value=b"",
                         **self._ident(uid, gids))

    async def list_xattr(self, inode: int, uid: int | None = None,
                         gids: list[int] | None = None) -> list[str]:
        # uid/gids accepted for interface symmetry; listxattr(2) does not
        # require access to the inode, so no identity goes on the wire
        r = await self._call(m.CltomaListXattr, inode=inode)
        return r.names

    async def set_quota(
        self, kind: str, owner_id: int, *, soft_inodes: int = 0,
        hard_inodes: int = 0, soft_bytes: int = 0, hard_bytes: int = 0,
        remove: bool = False, uid: int | None = None,
    ) -> None:
        await self._call(
            m.CltomaSetQuota, kind=kind, owner_id=owner_id,
            soft_inodes=soft_inodes, hard_inodes=hard_inodes,
            soft_bytes=soft_bytes, hard_bytes=hard_bytes, remove=remove,
            uid=self._uid(uid),
        )

    async def get_quota(self, uid: int | None = None,
                        gids: list[int] | None = None) -> list[dict]:
        import json

        r = await self._call(m.CltomaGetQuota, **self._ident(uid, gids))
        return json.loads(r.json)

    async def set_acl(
        self, inode: int, access: dict | None, default: dict | None = None,
        uid: int | None = None, gids: list[int] | None = None,
    ) -> None:
        import json

        await self._call(
            m.CltomaSetAcl, inode=inode,
            json=json.dumps({"access": access, "default": default}),
            **self._ident(uid, gids),
        )

    async def get_acl(self, inode: int) -> dict:
        import json

        r = await self._call(m.CltomaGetAcl, inode=inode)
        return json.loads(r.json)

    async def set_rich_acl(
        self, inode: int, acl: dict | None,
        uid: int | None = None, gids: list[int] | None = None,
    ) -> None:
        import json

        await self._call(
            m.CltomaSetRichAcl, inode=inode,
            json=json.dumps(acl) if acl is not None else "",
            **self._ident(uid, gids),
        )

    async def get_rich_acl(self, inode: int) -> dict | None:
        import json

        r = await self._call(m.CltomaGetRichAcl, inode=inode)
        return json.loads(r.json).get("rich")

    async def access(
        self, inode: int, uid: int, gids: list[int], mask: int
    ) -> bool:
        try:
            await self._call_read(
                m.CltomaAccess, inode=inode, uid=uid, gids=gids, mask=mask
            )
            return True
        except st.StatusError as e:
            if e.code == st.EACCES:
                return False
            raise

    async def trash_list(self, uid: int | None = None) -> list[dict]:
        import json

        r = await self._call(m.CltomaTrashList,
                             uid=self._uid(uid))
        return json.loads(r.json)

    async def undelete(self, inode: int, uid: int | None = None) -> None:
        await self._call(m.CltomaUndelete, inode=inode,
                         uid=self._uid(uid))

    # --- locking -----------------------------------------------------------

    async def flock(
        self, inode: int, ltype: int, token: int = 0, wait: bool = False,
        timeout: float = 30.0,
    ) -> bool:
        """BSD flock (1=shared 2=exclusive 0=unlock). wait=True blocks
        until granted (the master pushes the grant). False = refused."""
        return await self._lock(inode, 1, token, 0, 0, ltype, wait, timeout)

    async def posix_lock(
        self, inode: int, start: int, end: int, ltype: int, token: int = 0,
        wait: bool = False, timeout: float = 30.0,
    ) -> bool:
        return await self._lock(inode, 0, token, start, end, ltype, wait, timeout)

    async def test_lock(self, inode: int, start: int, end: int, ltype: int,
                        token: int = 0) -> bool:
        """True iff the lock would be grantable (F_GETLK)."""
        r = await self.master.call(
            m.CltomaLockOp, op=2, inode=inode, token=token, start=start,
            end=end, ltype=ltype, wait=False,
        )
        return r.status == st.OK

    async def _on_lock_granted(self, push: m.MatoclLockGranted) -> None:
        q = self._lock_grants.get((push.inode, push.token))
        if q is not None:
            q.put_nowait(True)

    async def _on_cache_invalidate(self, push) -> None:
        """Master push: another session mutated this file — drop its
        cached blocks (reference: matoclserv.cc data-cache
        invalidation to mounts). The push carries the mutation's
        changelog position: raising the floor here means the NEXT read
        can't be served pre-mutation by a lagging replica."""
        self._note_token(push)
        ci = None if push.chunk_index == 0xFFFFFFFF else push.chunk_index
        self.cache.invalidate(push.inode, ci)
        self._record("cache_invalidate", inode=push.inode)

    async def _lock(self, inode, op, token, start, end, ltype, wait, timeout):
        key = (inode, token)
        grant_q: asyncio.Queue = asyncio.Queue()
        if wait:
            # one persistent push handler (installed at connect) fans out
            # to per-(inode, token) waiters — concurrent waits don't
            # clobber each other
            self._lock_grants[key] = grant_q
        try:
            r = await self.master.call(
                m.CltomaLockOp, op=op, inode=inode, token=token, start=start,
                end=end, ltype=ltype, wait=wait,
            )
            if r.status == st.OK:
                return True
            if r.status == st.LOCKED and wait:
                try:
                    await asyncio.wait_for(grant_q.get(), timeout)
                    return True
                except asyncio.TimeoutError:
                    # cancel the queued request master-side so it isn't
                    # granted to a caller that already gave up
                    await self.master.call(
                        m.CltomaLockOp, op=op, inode=inode, token=token,
                        start=start, end=end, ltype=0, wait=False,
                    )
                    return False
            return False
        finally:
            if wait:
                self._lock_grants.pop(key, None)

    # --- write path -------------------------------------------------------------------

    async def write_file(self, inode: int, data: bytes | np.ndarray) -> None:
        """Stream-write file contents from offset 0 (create/overwrite).

        Overwriting with shorter content truncates to the new length
        (the master's WriteChunkEnd only ever grows the file, matching
        the reference's extend-on-write semantics)."""
        data = np.frombuffer(bytes(data), dtype=np.uint8)
        total = len(data)
        wall_t0 = _time.perf_counter()
        # each top-level write is one traced request (unless the caller
        # already runs under a trace); chunk tasks inherit the context,
        # and a trace WE started is cleared on the way out so the next
        # op in this task gets its own id
        tid, fresh_trace = tracing.begin()
        try:
            # every chunk task spawned below copies this context — the
            # native scatter path reads the session from it in-task
            session_ctx = accounting.task_session(self.session_id)
            session_ctx.__enter__()
            old_length = (await self.getattr(inode)).length
            self.trace_ring.record(
                tid, "getattr", wall_t0, _time.perf_counter(), role="client"
            )
            # a small in-flight window pipelines chunk N+1's grant +
            # transfer behind chunk N's tail (write_cache_window
            # analog); chunks are independent (separate ids/versions)
            # and the master's WriteChunkEnd only ever grows the file,
            # so completion order doesn't matter
            window = asyncio.Semaphore(2)
            # with the write window active, clean chunk ends coalesce
            # into one CltomaWriteChunkEndBatch per flush instead of a
            # commit handshake per chunk (multi-chunk files pay one
            # master round trip per window drain)
            defer = self.write_window is not None

            async def write_one(ci: int, piece: np.ndarray, end: int) -> None:
                async with window:
                    async def attempt():
                        await self._write_chunk(
                            inode, ci, piece, file_length=end,
                            defer_end=defer,
                        )

                    await self._retry_transient(f"write chunk {ci}", attempt)

            tasks = []
            pos = 0
            index = 0
            while pos < total:
                end = min(pos + MFSCHUNKSIZE, total)
                tasks.append(asyncio.ensure_future(
                    write_one(index, data[pos:end], end)
                ))
                pos = end
                index += 1
            ok = False
            try:
                for t in tasks:
                    await t
                ok = True
            finally:
                for t in tasks:
                    t.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                if ok:
                    # quota raises here must surface like a per-chunk
                    # end's would
                    await self._flush_chunk_ends()
                else:
                    # error unwind: chunks that DID land must still
                    # commit (their bytes are on the chunkservers), but
                    # a flush failure must not mask the original error
                    try:
                        await self._flush_chunk_ends()
                    except (st.StatusError, ConnectionError, OSError,
                            asyncio.TimeoutError):
                        log.warning(
                            "coalesced commit flush failed during unwind"
                        )
            if old_length > total:
                await self.truncate(inode, total)
            wall_t1 = _time.perf_counter()
            self.write_phases.add_wall(wall_t1 - wall_t0)
            self.trace_ring.record(
                tid, "write_file", wall_t0, wall_t1, role="client",
                bytes=total,
            )
            # ONE logical write == ONE accounting record, regardless of
            # how many transient retries the chunks above burned
            self.session_ops.record(
                self.session_id, "write", wall_t1 - wall_t0, nbytes=total,
                trace_id=tid,
            )
        finally:
            # manual __enter__/__exit__ pair: the session scope must
            # cover the whole body without re-indenting it under a
            # second with-block (tokens reset in reverse order, same
            # task, so pairing across the try/finally is sound)
            session_ctx.__exit__(None, None, None)
            tracing.end(fresh_trace)

    async def pwrite(self, inode: int, offset: int, data: bytes | np.ndarray) -> None:
        """Positional write at an arbitrary offset (POSIX pwrite).

        Partial stripes are handled with read-modify-write: the affected
        stripes' current data is read back (with recovery if parts are
        down), patched, parity recomputed client-side, and all affected
        blocks rewritten — the chunk_writer.cc:471-533 pattern.
        """
        data = np.frombuffer(bytes(data), dtype=np.uint8)
        if len(data) == 0:
            return
        wall_t0 = _time.perf_counter()
        tid, fresh_trace = tracing.begin()
        try:
            # session scope for the RMW read-backs + native write path
            # (paired __exit__ in the finally, as in write_file)
            session_ctx = accounting.task_session(self.session_id)
            session_ctx.__enter__()
            old_length = (await self.getattr(inode)).length
            end = offset + len(data)
            pos = offset
            while pos < end:
                ci = pos // MFSCHUNKSIZE
                coff = pos % MFSCHUNKSIZE
                take = min(MFSCHUNKSIZE - coff, end - pos)
                await self._pwrite_chunk(
                    inode, ci, coff,
                    data[pos - offset : pos - offset + take],
                    old_length, max(old_length, end),
                )
                pos += take
            # the RMW path charges encode/send phases above — close the
            # rep so phase sums stay attributable against wall time for
            # pwrite-heavy workloads too
            wall_t1 = _time.perf_counter()
            self.write_phases.add_wall(wall_t1 - wall_t0)
            self.trace_ring.record(
                tid, "pwrite", wall_t0, wall_t1, role="client",
                bytes=len(data),
            )
            # one logical pwrite counts once — RMW retries inside
            # _pwrite_chunk are implementation detail
            self.session_ops.record(
                self.session_id, "write", wall_t1 - wall_t0,
                nbytes=len(data), trace_id=tid,
            )
        finally:
            session_ctx.__exit__(None, None, None)
            tracing.end(fresh_trace)

    async def _pwrite_chunk(
        self, inode: int, ci: int, coff: int, piece: np.ndarray,
        old_length: int, new_length: int,
    ) -> None:
        key = (inode, ci)
        # [lock, refcount]: long-lived mounts touch unboundedly many
        # (inode, chunk) pairs, so entries are dropped once nobody holds
        # or awaits them (a plain locked() check would race with waiters)
        entry = self._chunk_write_locks.get(key)
        if entry is None:
            entry = self._chunk_write_locks[key] = [asyncio.Lock(), 0]
        entry[1] += 1
        try:
            async with entry[0]:
                # a failed attempt can leave parts torn (some written,
                # some not, parity stale); each retry takes a FRESH grant
                # — the version bump drops unreachable holders and the
                # full region rewrite restores stripe consistency on the
                # survivors. The RMW read-back happens ONCE and is
                # reused across retries (rmw_cache): a retry that
                # re-read the region would decode a MIX of first-attempt
                # and stale parts — torn state — and write the garbage
                # back over the preserved bytes (caught by the
                # s3-multipart chaos schedule: SIGKILL mid-RMW)
                rmw_cache: dict = {}

                async def attempt():
                    await self._pwrite_chunk_locked(
                        inode, ci, coff, piece, old_length, new_length,
                        rmw_cache,
                    )

                await self._retry_transient(f"pwrite chunk {ci}", attempt)
        finally:
            entry[1] -= 1
            if entry[1] == 0 and self._chunk_write_locks.get(key) is entry:
                del self._chunk_write_locks[key]

    async def _pwrite_chunk_locked(
        self, inode: int, ci: int, coff: int, piece: np.ndarray,
        old_length: int, new_length: int,
        rmw_cache: dict | None = None,
    ) -> None:
        grant = await self._call(
            m.CltomaWriteChunk, inode=inode, chunk_index=ci,
            **self._ident(None, None),
        )
        self.cache.invalidate(inode, ci)
        status_code = st.EIO
        try:
            copies: dict[int, list[m.PartLocation]] = {}
            slice_type = None
            for loc in grant.locations:
                cpt = geometry.ChunkPartType.from_id(loc.part_id)
                slice_type = cpt.type if slice_type is None else slice_type
                copies.setdefault(cpt.part, []).append(loc)
            if slice_type is None:
                raise st.StatusError(st.NO_CHUNK_SERVERS, "no locations granted")
            if slice_type.is_standard:
                # plain copies: patch the byte range in every replica chain
                await self._write_part(
                    grant.chunk_id, grant.version, copies[0], piece,
                    len(piece), part_offset=coff,
                )
            else:
                # use the grant's file length, not the caller's snapshot:
                # concurrent writers may have extended the file since
                await self._rmw_striped(grant, slice_type, copies, ci, coff,
                                        piece, grant.file_length, rmw_cache)
            status_code = st.OK
        finally:
            await self._call(
                m.CltomaWriteChunkEnd,
                chunk_id=grant.chunk_id, inode=inode, chunk_index=ci,
                file_length=new_length, status=status_code,
            )
            # a locate cached BETWEEN this write's grant and its end
            # carries the pre-write length/identity — drop again now
            # (the master's end-of-write push excludes our own session)
            self._drop_locates(inode)

    async def _rmw_striped(
        self, grant, slice_type, copies, ci: int, coff: int,
        piece: np.ndarray, old_length: int,
        rmw_cache: dict | None = None,
    ) -> None:
        d = slice_type.data_parts
        first_data = 1 if slice_type.is_xor else 0
        stripe_bytes = d * MFSBLOCKSIZE
        lo_s = coff // stripe_bytes
        hi_s = (coff + len(piece) - 1) // stripe_bytes
        nstripes = hi_s - lo_s + 1
        region_start = lo_s * stripe_bytes
        if rmw_cache is not None and "region" in rmw_cache:
            # retry after a torn first attempt: re-reading the stripes
            # now would decode a mix of already-rewritten and stale
            # parts — reuse the region assembled BEFORE any of our
            # writes touched the wire, making retries write-only
            region = rmw_cache["region"]
            await self._rmw_send(grant, slice_type, copies, lo_s,
                                 nstripes, region)
            return
        region = np.zeros(nstripes * stripe_bytes, dtype=np.uint8)

        chunk_len_old = min(max(old_length - ci * MFSCHUNKSIZE, 0), MFSCHUNKSIZE)
        overlap_end = min(chunk_len_old, region_start + len(region))
        fully_covered = (
            coff == region_start and coff + len(piece) >= overlap_end
        )
        if overlap_end > region_start and not fully_covered:
            # read back the stripes being partially overwritten,
            # preferring healthy copies (same scoring as the read path)
            from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS

            def best(locs):
                top = max(
                    locs,
                    key=lambda l: GLOBAL_STATS.score(
                        (l.addr.host, l.addr.port)
                    ),
                )
                return ((top.addr.host, top.addr.port), top.part_id)

            by_part = {p: best(locs) for p, locs in copies.items()}
            part_sizes = {
                p: striping.part_length(slice_type, p, chunk_len_old)
                for p in range(slice_type.expected_parts)
            }
            wanted = [first_data + i for i in range(d)]
            planner = plans.SliceReadPlanner(
                slice_type, list(by_part.keys()),
                scores={p: GLOBAL_STATS.score(a)
                        for p, (a, _) in by_part.items()},
                encoder=self.encoder,
            )
            if not planner.is_readable(wanted):
                raise ReadError("not enough parts for read-modify-write")
            plan = planner.build_plan(wanted, lo_s, nstripes, part_sizes)
            buf = await execute_plan(
                plan, grant.chunk_id, grant.version, by_part,
                wave_timeout=self.wave_timeout,
            )
            bps = nstripes * MFSBLOCKSIZE
            data_parts = {
                wanted[i]: buf[i * bps : (i + 1) * bps] for i in range(d)
            }
            region[:] = striping.assemble_chunk(
                data_parts, slice_type, len(region)
            )
        region[coff - region_start : coff - region_start + len(piece)] = piece
        if rmw_cache is not None:
            # stash the patched region BEFORE any write hits the wire:
            # this is the one pre-torn snapshot a retry may trust
            rmw_cache["region"] = region
        await self._rmw_send(grant, slice_type, copies, lo_s, nstripes,
                             region)

    async def _rmw_send(self, grant, slice_type, copies, lo_s: int,
                        nstripes: int, region: np.ndarray) -> None:
        """Encode + rewrite the RMW region's parts (the write half of
        _rmw_striped, shared by first attempts and torn-state
        retries)."""
        t0 = self._t0()
        parts = await asyncio.to_thread(
            striping.split_chunk, region, slice_type, self.encoder
        )
        self._phase("encode", t0)
        sends = []
        for part_idx, locs in copies.items():
            stream = parts.get(part_idx)
            if stream is None:
                continue
            sends.append(
                self._write_part(
                    grant.chunk_id, grant.version, locs,
                    stream[: nstripes * MFSBLOCKSIZE],
                    nstripes * MFSBLOCKSIZE,
                    part_offset=lo_s * MFSBLOCKSIZE,
                )
            )
        t0 = self._t0()
        await asyncio.gather(*sends)
        self._phase("send", t0)

    async def _write_chunk(
        self, inode: int, chunk_index: int, chunk_data: np.ndarray,
        file_length: int, defer_end: bool = False,
    ) -> None:
        t0 = self._t0()
        grant = await self._call(
            m.CltomaWriteChunk, inode=inode, chunk_index=chunk_index,
            **self._ident(None, None),
        )
        self._phase("commit", t0)
        self.cache.invalidate(inode, chunk_index)
        status_code = st.EIO
        try:
            await self._push_chunk_parts(grant, chunk_data)
            status_code = st.OK
        finally:
            if (defer_end and status_code == st.OK
                    and self.write_window is not None):
                # commit coalescing: queue the end record; the window's
                # owner (write_file) flushes the batch as ONE master
                # round trip. Only CLEAN ends coalesce — a failed write
                # must release the master's chunk lock before the retry
                # takes a fresh grant, so it commits immediately below.
                if self.write_window.queue_end(
                    grant.chunk_id, inode, chunk_index, file_length,
                    st.OK,
                ):
                    await self._flush_chunk_ends()
            else:
                t0 = self._t0()
                await self._call(
                    m.CltomaWriteChunkEnd,
                    chunk_id=grant.chunk_id,
                    inode=inode,
                    chunk_index=chunk_index,
                    file_length=file_length,
                    status=status_code,
                )
                self._phase("commit", t0)
            # see _write_chunk's twin: locates cached mid-write carry
            # pre-write length/identity and must not outlive the write
            self._drop_locates(inode)

    async def _flush_chunk_ends(self) -> None:
        """Flush queued end-of-write records as one coalesced
        CltomaWriteChunkEndBatch (the window pays one commit handshake
        per flush instead of one per chunk)."""
        win = self.write_window
        if win is None or not win.pending_ends:
            return
        batch = win.drain_ends()
        t0 = self._t0()
        try:
            await self._call(
                m.CltomaWriteChunkEndBatch,
                ends=[m.WriteChunkEndEntry(**e) for e in batch],
            )
        except st.StatusError:
            # a STATUS reply proves the master consumed the batch (it
            # applies every entry it can and reports the first failure,
            # e.g. quota): surface the error but do NOT requeue —
            # re-sending would re-apply applied entries and park a
            # permanently-failing one in front of every future flush
            raise
        except BaseException:
            # transport failure: the batch may never have arrived, and
            # it may hold ANOTHER concurrent write's commits — requeue
            # so a later flush retries instead of silently losing that
            # write's length/locks to this one's failure
            win.requeue_ends(batch)
            raise
        self._phase("commit", t0)
        win.note_coalesced(len(batch))
        self._record("write_commit_batch")

    async def _push_chunk_parts(self, grant, chunk_data: np.ndarray) -> None:
        # group locations by part index
        by_part: dict[int, list[m.PartLocation]] = {}
        slice_type = None
        for loc in grant.locations:
            cpt = geometry.ChunkPartType.from_id(loc.part_id)
            slice_type = cpt.type if slice_type is None else slice_type
            by_part.setdefault(cpt.part, []).append(loc)
        if slice_type is None:
            raise st.StatusError(st.NO_CHUNK_SERVERS, "no locations granted")

        # abort handles for every native send this chunk issues: a
        # cancelled write must kill zombie executor threads before the
        # staging buffer they stream from can go back to the pool
        send_cells: list[dict] = []

        def send_of(part_idx: int, payload: np.ndarray,
                    skip_throttle: bool = False):
            length = striping.part_length(
                slice_type, part_idx, len(chunk_data)
            )
            cell: dict = {}
            send_cells.append(cell)
            return self._write_part(
                grant.chunk_id, grant.version, by_part[part_idx],
                payload, length, skip_throttle=skip_throttle, cell=cell,
            )

        async def send_batch(
            items: list[tuple[int, np.ndarray]], skip_throttle: bool = False
        ) -> None:
            """Write several whole parts: ONE native poll-driven call
            when every part has a single holder (no relay chain),
            per-part sends otherwise or on native failure.
            ``skip_throttle``: the caller already charged these bytes
            (QoS rule: charge once, not per retry/fallback)."""
            from lizardfs_tpu_torch.core import native_io

            items = [(p, pay) for p, pay in items if p in by_part]
            if not items:
                return
            lengths = [
                striping.part_length(slice_type, p, len(chunk_data))
                for p, _ in items
            ]
            if not skip_throttle:
                # charged BEFORE the send timer starts: QoS queueing
                # (token-bucket waits, the limit-renew RPC) must not be
                # booked as send_ms, or a throttled client's phase row
                # misattributes pacing as chunkserver transfer time
                await self._throttle(sum(lengths))
            t0 = self._t0()
            try:
                if (
                    native_io.parts_scatter_available()
                    and not _faults.ACTIVE
                    and len(items) > 1
                    and all(len(by_part[p]) == 1 for p, _ in items)
                ):
                    cell: dict = {"submitted": True}
                    send_cells.append(cell)
                    try:
                        await native_io.run(
                            native_io.write_parts_scatter_blocking,
                            [(by_part[p][0].addr.host,
                              by_part[p][0].addr.port)
                             for p, _ in items],
                            grant.chunk_id, grant.version,
                            [by_part[p][0].part_id for p, _ in items],
                            [pay for _, pay in items], lengths, 0, cell,
                        )
                        self._record("parts_scatter_write")
                        return
                    except (native_io.NativeIOError, OSError,
                            ConnectionError, st.StatusError):
                        self._record("parts_scatter_fallback")
                        # fall through per-part — bytes were already
                        # charged to the throttle above, don't pay twice
                        await asyncio.gather(*(
                            send_of(p, pay, skip_throttle=True)
                            for p, pay in items
                        ))
                        return
                # bytes already charged above — per-part sends must not
                # pay again (and their throttle would pollute the timer)
                await asyncio.gather(*(
                    send_of(p, pay, skip_throttle=True)
                    for p, pay in items
                ))
            finally:
                self._phase("send", t0)

        from lizardfs_tpu_torch.core import native_io

        def _abort_zombie_sends() -> list[dict]:
            """Kill executor threads of cancelled/failed native sends:
            run_in_executor threads are unkillable, so a cancelled send
            would otherwise keep streaming from its buffer for up to
            120 s while pinning a native-IO worker."""
            zombies = [
                c for c in send_cells
                if c.get("submitted") and not c.get("finished")
            ]
            for c in zombies:
                native_io.abort_write(c)
            return zombies

        if slice_type.is_standard or slice_type.is_tape:
            # whole-chunk copies: stream the caller's buffer directly
            # (_write_part only reads it) — no 64 MiB staging copy
            copy_tasks = [
                asyncio.ensure_future(send_of(p, chunk_data))
                for p in by_part
            ]
            try:
                for t in copy_tasks:
                    await t
            finally:
                for t in copy_tasks:
                    t.cancel()
                await asyncio.gather(*copy_tasks, return_exceptions=True)
                _abort_zombie_sends()
            return
        # striped slices: scatter into contiguous part streams first
        # (one memcpy, the `stage` phase), then hand off to one of:
        #   * the segmented stripe pipeline (default, preconditions
        #     permitting): encode segment i+1 while segment i's data AND
        #     parity are in flight — parity lands straight in the send
        #     buffer, no second staging copy;
        #   * the overlapped whole-chunk path (pipeline on, but chains/
        #     missing parts/no native scatter): whole-chunk encode
        #     overlaps the data-part transfer (chunk_writer.cc computes
        #     parity inline per stripe; this is its coarse analog);
        #   * the strictly serial path (LZ_WRITE_PIPELINE=0 kill
        #     switch): stage -> encode -> send(data) -> send(parity),
        #     the byte-identity golden reference whose phase totals sum
        #     to ~the rep wall time.
        d = slice_type.data_parts
        nblocks = -(-len(chunk_data) // MFSBLOCKSIZE)
        part_len = -(-nblocks // d) * MFSBLOCKSIZE
        stage = self._stage_acquire(d, part_len)
        t0 = self._t0()
        stacked, _ = await asyncio.to_thread(
            striping.padded_data_parts, chunk_data, d, stage
        )
        self._phase("stage", t0)
        first = 1 if slice_type.is_xor else 0
        full_chunk = len(chunk_data) == MFSCHUNKSIZE

        async def parity_parts() -> dict[int, np.ndarray]:
            t0 = self._t0()
            try:
                if slice_type.is_xor:
                    par = await asyncio.to_thread(
                        self.encoder.xor_parity, stacked
                    )
                    return {0: par}
                par = await asyncio.to_thread(
                    self.encoder.encode, d, slice_type.parity_parts,
                    list(stacked),
                )
                return {d + j: p for j, p in enumerate(par)}
            finally:
                self._phase("encode", t0)

        try:
            throttled = False
            if self.write_pipeline and self._pipeline_eligible(
                slice_type, by_part, chunk_data, part_len
            ):
                # charge the QoS budget up front (one acquire for the
                # chunk); a fallback below must then not charge again
                await self._throttle(sum(
                    striping.part_length(slice_type, p, len(chunk_data))
                    for p in by_part
                ))
                throttled = True
                try:
                    if (self.write_window is not None
                            and native_io.parts_scatterv_available()):
                        # adaptive window: N unacked segments in flight
                        # over shared per-chunkserver connections
                        await self._push_striped_windowed(
                            grant, chunk_data, slice_type, by_part,
                            stacked, part_len, full_chunk, send_cells,
                        )
                        self._record("write_window")
                    else:
                        await self._push_striped_pipelined(
                            grant, chunk_data, slice_type, by_part, stacked,
                            part_len, full_chunk, send_cells,
                        )
                    # both overlapped paths count as the pipeline for
                    # observability (the window is its deeper form)
                    self._record("write_pipeline")
                    return
                except (native_io.NativeIOError, OSError, ConnectionError,
                        st.StatusError):
                    # torn segments are healed by the full-part rewrite
                    # the paths below perform
                    self._record("write_pipeline_fallback")
            if not self.write_pipeline:
                par = await parity_parts()
                await send_batch(
                    [(first + i, stacked[i]) for i in range(d)],
                    skip_throttle=throttled,
                )
                await send_batch(sorted(par.items()), skip_throttle=throttled)
                return
            par_task = asyncio.ensure_future(parity_parts())
            tasks = [asyncio.ensure_future(
                send_batch(
                    [(first + i, stacked[i]) for i in range(d)],
                    skip_throttle=throttled,
                )
            )]
            try:
                par = await par_task
                tasks.append(asyncio.ensure_future(
                    send_batch(sorted(par.items()), skip_throttle=throttled)
                ))
                for t in tasks:
                    await t
            finally:
                par_task.cancel()
                for t in tasks:
                    t.cancel()
                await asyncio.gather(par_task, *tasks, return_exceptions=True)
        finally:
            # the coroutines are done, but a cancelled native send's
            # executor thread may still be streaming from the staging
            # buffer: kill it now, and never pool a buffer a zombie
            # thread might still read
            zombies = _abort_zombie_sends()
            self._stage_release(
                stage, poolable=full_chunk and not zombies
            )

    def _stage_acquire(self, d: int, part_len: int) -> np.ndarray | None:
        # stage buffers only serve the native scatter; the numpy
        # fallback ignores out= and would pool never-written memory
        from lizardfs_tpu_torch.core import native

        if not native.stripe_helpers_available():
            return None
        bucket = self._stage_buffers.get((d, part_len))
        if bucket:
            return bucket.pop()
        return np.empty((d, part_len), dtype=np.uint8)

    def _stage_release(self, buf: np.ndarray | None, poolable: bool) -> None:
        # pool ONLY the full-chunk shape: tail chunks produce one shape
        # per distinct file length, and keeping 2 buffers per shape
        # forever would grow without bound on a long-lived mount
        if buf is None or not poolable:
            return
        bucket = self._stage_buffers.setdefault(buf.shape, [])
        if len(bucket) < 2:
            bucket.append(buf)

    def _parity_acquire(self, m: int, part_len: int) -> np.ndarray:
        """Parity send buffer for the pipelined path ((m, part_len),
        pooled with the stage buffers): the encoder writes parity
        straight into it and the native scatter streams from it — the
        per-chunk parity staging copy is gone."""
        bucket = self._stage_buffers.get((m, part_len))
        if bucket:
            return bucket.pop()
        return np.empty((m, part_len), dtype=np.uint8)

    def _pipeline_eligible(
        self, slice_type, by_part, chunk_data, part_len: int
    ) -> bool:
        """Segmented stripe pipeline preconditions: native scatter
        built, every expected part granted with exactly one holder (no
        relay chains — the session sends chain-less frames), and a
        payload big enough that per-segment overlap beats the extra
        segment barriers. Anything else takes the fallback paths."""
        from lizardfs_tpu_torch.core import native_io

        if not native_io.parts_scatter_available():
            return False
        if _faults.ACTIVE:
            # armed faults: native scatter sessions can't be
            # instrumented — the hookable per-part senders serve
            return False
        if len(chunk_data) < self.WRITE_PIPELINE_MIN_BYTES:
            return False
        if part_len < 2 * MFSBLOCKSIZE:
            return False  # a single slot per part: nothing to overlap
        return all(
            p in by_part and len(by_part[p]) == 1
            for p in range(slice_type.expected_parts)
        )

    def _stripe_send_plan(
        self, grant, chunk_data, slice_type, by_part, stacked,
        part_len: int, send_cells: list[dict], share: bool, nseg_min: int,
    ):
        """Shared prologue of the two overlapped stripe senders (the
        double-buffered pipeline and the adaptive window): part order
        and per-part lengths, the pooled parity send buffer, the
        scatter session + abort cell, slot-aligned segment bounds, and
        the per-segment encode/payload/length closures — a stripe-
        geometry or encoder-boundary change lands in exactly one place.
        Returns ``(par_buf, cell, session, bounds, encode_segment,
        seg_payloads, seg_lengths)``."""
        from lizardfs_tpu_torch.core import native_io

        d = slice_type.data_parts
        first = 1 if slice_type.is_xor else 0
        m_par = 1 if slice_type.is_xor else slice_type.parity_parts
        order = [first + i for i in range(d)] + (
            [0] if slice_type.is_xor else [d + j for j in range(m_par)]
        )
        plens = {
            p: striping.part_length(slice_type, p, len(chunk_data))
            for p in order
        }
        par_buf = self._parity_acquire(m_par, part_len)
        cell: dict = {}
        send_cells.append(cell)
        session = native_io.PartsScatterSession(
            [(by_part[p][0].addr.host, by_part[p][0].addr.port)
             for p in order],
            grant.chunk_id, grant.version,
            [by_part[p][0].part_id for p in order],
            cell, share_connections=share,
        )
        blocks_per_part = part_len // MFSBLOCKSIZE
        nseg = min(
            max(self.write_pipeline_segments, nseg_min), blocks_per_part
        )
        seg_blocks = -(-blocks_per_part // nseg)
        bounds = [
            (a * MFSBLOCKSIZE,
             min(a + seg_blocks, blocks_per_part) * MFSBLOCKSIZE)
            for a in range(0, blocks_per_part, seg_blocks)
        ]

        def encode_segment(a: int, b: int, views=None) -> None:
            data_seg = [stacked[i][a:b] for i in range(d)]
            if views is not None:
                # shm-ring staging: parity is encoded STRAIGHT into the
                # chunkserver-mapped arena (zero copies end to end);
                # data rows stay in the stage buffer — their single
                # GIL-free memcpy into the arena happens inside the
                # native descriptor send (native/shm_ring.h). The
                # later "send" phase moves descriptors, not megabytes.
                par_out = [views[d + j] for j in range(m_par)]
                if par_out[0] is None:
                    return  # segment past every part's live length
                if slice_type.is_xor:
                    self.encoder.xor_parity_into(data_seg, par_out[0])
                else:
                    self.encoder.encode_into(d, m_par, data_seg, par_out)
                return
            if slice_type.is_xor:
                self.encoder.xor_parity_into(data_seg, par_buf[0][a:b])
            else:
                self.encoder.encode_into(
                    d, m_par, data_seg,
                    [par_buf[j][a:b] for j in range(m_par)],
                )

        def seg_payloads(a: int, b: int) -> list:
            return (
                [stacked[i][a:b] for i in range(d)]
                + [par_buf[j][a:b] for j in range(m_par)]
            )

        def seg_lengths(a: int, b: int) -> list[int]:
            return [max(min(b, plens[p]) - a, 0) for p in order]

        return (par_buf, cell, session, bounds, encode_segment,
                seg_payloads, seg_lengths)

    async def _push_striped_pipelined(
        self, grant, chunk_data, slice_type, by_part, stacked,
        part_len: int, full_chunk: bool, send_cells: list[dict],
    ) -> None:
        """Double-buffered stripe pipeline: ONE WriteInit/End handshake
        pair per part for the whole chunk, the part streams cut into
        slot-aligned segments, and segment i+1's parity encoding (into
        the send buffer, via the ChunkEncoder boundary) overlapping
        segment i's data+parity transfer.

        Byte-identical to the serial path by construction: RS/xor
        parity is columnwise (parity[j][x] depends only on column x of
        the data parts), so a per-segment encode equals the matching
        slice of a whole-part encode; segment boundaries stay 64 KiB
        aligned, so the chunkservers see the same per-block pieces and
        store the same CRCs. Raises on any failure — the caller falls
        back to the serial path, whose full-part rewrite heals torn
        segments. The caller has already charged the QoS throttle."""
        from lizardfs_tpu_torch.core import native_io

        (par_buf, cell, session, bounds, encode_segment, seg_payloads,
         seg_lengths) = self._stripe_send_plan(
            grant, chunk_data, slice_type, by_part, stacked, part_len,
            send_cells, share=False, nseg_min=2,
        )

        async def send_segment(a: int, b: int, wid: int, after) -> None:
            # chained on the previous segment's task: the session's
            # sockets carry one exchange at a time, and a predecessor's
            # failure propagates down the chain
            if after is not None:
                await after
            t0 = self._t0()
            await native_io.run(
                session.send_segment, seg_payloads(a, b),
                seg_lengths(a, b), a, wid,
            )
            self._phase("send", t0)

        send_tasks: list[asyncio.Task] = []
        try:
            t0 = self._t0()
            await native_io.run(session.open)
            self._phase("send", t0)
            for wid, (a, b) in enumerate(bounds, start=1):
                t0 = self._t0()
                await asyncio.to_thread(encode_segment, a, b)
                self._phase("encode", t0)
                send_tasks.append(asyncio.ensure_future(send_segment(
                    a, b, wid, send_tasks[-1] if send_tasks else None
                )))
            await send_tasks[-1]
            t0 = self._t0()
            await native_io.run(session.finish)
            self._phase("send", t0)
        except BaseException:
            for t in send_tasks:
                t.cancel()
            await asyncio.gather(*send_tasks, return_exceptions=True)
            # the session's executor thread may still be streaming from
            # stacked/par_buf — kill the exchange before those buffers
            # can be released (the caller's zombie-abort also covers
            # this cell, but do it promptly here)
            native_io.abort_write(cell)
            raise
        finally:
            self._stage_release(
                par_buf,
                poolable=full_chunk and not (
                    cell.get("submitted") and not cell.get("finished")
                ),
            )

    async def _push_striped_windowed(
        self, grant, chunk_data, slice_type, by_part, stacked,
        part_len: int, full_chunk: bool, send_cells: list[dict],
    ) -> None:
        """Adaptive N-deep write window over the stripe pipeline: up to
        ``write_window.depth`` slot-aligned segments ride UNACKNOWLEDGED
        (part-addressed 1215 frames, vectored header+payload sendmsg,
        parts sharing a chunkserver multiplexed over one connection),
        with per-chunkserver credits + a shared staging-byte budget as
        flow control. Acks are collected oldest-first as the window
        fills — the per-segment round-trip barrier the PR-1 pipeline
        paid (its send phase dominated the ec(8,4) telemetry) is gone.

        Byte-identical to the serial path for the same reason the
        pipelined path is: parity is columnwise, segments stay 64 KiB
        aligned, and the chunkservers land the same per-block pieces
        and CRCs — only the framing and ack cadence differ. Raises on
        any failure; the caller's serial fallback heals torn segments.
        The caller has already charged the QoS throttle."""
        from lizardfs_tpu_torch.core import native_io

        win = self.write_window
        d = slice_type.data_parts  # ring widths: data rows vs parity
        # nseg_min=win.max_depth: enough segments that the window can
        # actually fill (a 4-deep window over 4 segments would
        # degenerate to the old barrier)
        (par_buf, cell, session, bounds, encode_segment, seg_payloads,
         seg_lengths) = self._stripe_send_plan(
            grant, chunk_data, slice_type, by_part, stacked, part_len,
            send_cells, share=True, nseg_min=win.max_depth,
        )

        from collections import deque

        # (write_id, credited bytes, encode seconds, send seconds so far)
        outstanding: deque[list] = deque()
        try:
            t0 = self._t0()
            await native_io.run(session.open)
            self._phase("send", t0)
            for wid, (a, b) in enumerate(bounds, start=1):
                lengths = seg_lengths(a, b)
                # shm-ring staging: reserve this segment's arena regions
                # BEFORE encoding so parity lands straight in mapped
                # memory. A full ring reaps the oldest segment's acks
                # (freeing its regions) and retries; with nothing left
                # to reap, this segment takes the socket-copy send.
                views = None
                if session.ring_ready():
                    # parity regions are allocated at the full padded
                    # segment width (the encoder writes the whole
                    # column range); only the live bytes go on the wire
                    widths = lengths[:d] + [b - a] * (len(lengths) - d)
                    views = session.ring_stage(wid, lengths, widths)
                    while views is None and outstanding:
                        await self._window_collect(session, win, outstanding)
                        views = session.ring_stage(wid, lengths, widths)
                t0 = self._t0()
                try:
                    await asyncio.to_thread(encode_segment, a, b, views)
                except BaseException:
                    session.ring_unstage(wid)
                    raise
                enc_dt = _time.perf_counter() - t0
                self._phase("encode", t0)
                payloads = seg_payloads(a, b)
                if views is not None:
                    # parity already lives in its staged arena view —
                    # hand THAT as the payload so the native send sees
                    # src == dst and moves zero parity bytes; data rows
                    # keep their stage-buffer source for the C memcpy
                    for idx in range(d, len(views)):
                        if views[idx] is not None:
                            payloads[idx] = views[idx]
                seg_bytes = sum(lengths)
                # credits BEFORE the send: per-chunkserver in-flight
                # frames + the client-wide staging budget (returned as
                # each segment's commit acks come back). NEVER block on
                # credits while holding outstanding segments — reap the
                # oldest instead (two concurrent chunk writes jointly
                # exhausting a bucket would otherwise deadlock, each
                # waiting for credits only the other's reap can free);
                # blocking with nothing outstanding is safe, since any
                # credit holder then has acks of its own to reap.
                waited = False
                w0 = tracing.phase_t0()
                while not win.try_acquire(session.unique_addrs, seg_bytes):
                    waited = True
                    if outstanding:
                        await self._window_collect(session, win, outstanding)
                    else:
                        await win.acquire(session.unique_addrs, seg_bytes)
                        break
                win.note_segment(waited)
                if waited:
                    # credit-gate queue wait (reap-or-block included):
                    # the segment did no work while the window was full
                    tracing.charge_queue_wait(
                        self.metrics, self.trace_ring, "write_credit",
                        "default", w0, role="client",
                    )
                try:
                    t0 = self._t0()
                    await native_io.run(
                        session.send_segment_window, payloads, lengths,
                        a, wid,
                    )
                    send_dt = _time.perf_counter() - t0
                    self._phase("send", t0)
                except BaseException:
                    win.release(session.unique_addrs, seg_bytes)
                    raise
                outstanding.append([wid, seg_bytes, enc_dt, send_dt])
                # window full: reap the oldest segment's acks (depth is
                # LIVE — adaptation may have moved it since the last
                # segment, so reap down to the current depth)
                while len(outstanding) >= max(win.depth, 1):
                    await self._window_collect(session, win, outstanding)
            while outstanding:
                await self._window_collect(session, win, outstanding)
            t0 = self._t0()
            await native_io.run(session.finish)
            self._phase("send", t0)
        except BaseException:
            # the session's executor thread may still be streaming from
            # stacked/par_buf — kill the exchange before those buffers
            # can be released
            native_io.abort_write(cell)
            raise
        finally:
            self._fold_ring_stats(session)
            # failure path: return credits the reap loop never got to
            for wid, seg_bytes, *_rest in outstanding:
                win.release(session.unique_addrs, seg_bytes)
            self._stage_release(
                par_buf,
                poolable=full_chunk and not (
                    cell.get("submitted") and not cell.get("finished")
                ),
            )

    _SHM_RING_HELP = {
        "segments_mapped": "shm ring segments negotiated with same-host "
                           "chunkservers (memfd mappings created)",
        "desc_parts": "part writes handed off as shm-ring descriptors "
                      "(payload moved via shared memory, not the socket)",
        "full_waits": "segment stagings that found a ring full and had "
                      "to reap acks first (ring backpressure events)",
        "fallbacks": "windowed segments sent via socket copy while rings "
                     "were active (ring-full or unstaged fallbacks)",
    }

    def _fold_ring_stats(self, session) -> None:
        """Fold one scatter session's shm-ring counters into the client
        registry (Prometheus-exported wherever the owner exposes it)."""
        stats = getattr(session, "ring_stats", None)
        if not stats:
            return
        for key, val in stats.items():
            if val:
                self.metrics.counter(
                    f"shm_ring_{key}", help=self._SHM_RING_HELP[key]
                ).inc(float(val))
        if stats.get("desc_parts"):
            # visible alongside write_pipeline/write_window counters:
            # this chunk moved (at least partly) over the ring plane
            self._record("write_shm")
        session.ring_stats = {k: 0 for k in stats}

    async def _window_collect(self, session, win, outstanding) -> None:
        """Reap the oldest outstanding segment: collect its acks,
        return its credits, and feed the adaptive depth controller."""
        from lizardfs_tpu_torch.core import native_io

        wid, seg_bytes, enc_dt, send_dt = outstanding.popleft()
        try:
            t0 = self._t0()
            await native_io.run(session.collect_acks, wid)
            # ack-reaping is backpressure (downstream disk/CPU), not
            # push cost — charge it to its own phase so send_ms keeps
            # measuring the copy the shm ring exists to eliminate; the
            # depth controller still sees the combined time (ack wait
            # is exactly the send-bound signal that should deepen it)
            send_dt += _time.perf_counter() - t0
            self._phase("ack", t0)
        finally:
            win.release(session.unique_addrs, seg_bytes)
        win.observe(enc_dt, send_dt)

    async def _write_part(
        self,
        chunk_id: int,
        version: int,
        locs: list[m.PartLocation],
        payload: np.ndarray,
        length: int,
        part_offset: int = 0,
        skip_throttle: bool = False,
        cell: dict | None = None,
    ) -> None:
        """Write ``payload[:length]`` at ``part_offset`` within one part:
        head of the chain + forwarding for extra copies (WriteExecutor
        analog, write_executor.cc:66-96). Pieces never cross 64 KiB block
        boundaries; each carries its own CRC. ``skip_throttle``: the
        caller already charged these bytes (QoS rule: charge once, not
        per retry/fallback). ``cell``: abort handle for the native path —
        a cancelled caller must be able to kill the executor thread that
        is still streaming from ``payload`` (native_io.abort_write)."""
        if not skip_throttle:
            await self._throttle(max(length, 0))
        head = locs[0]
        chain = locs[1:]

        # bulk writes stream their pieces in C++ off the event loop
        from lizardfs_tpu_torch.core import native_io

        if (
            native_io.available()
            and length >= native_io.NATIVE_WRITE_THRESHOLD
            # armed faults: the C++ streamer can't be instrumented —
            # the framed asyncio path below serves (LZ_FAULTS unset:
            # byte-identical, the gate is one module-attribute check)
            and not _faults.ACTIVE
        ):
            if cell is not None:
                # marked BEFORE the executor hand-off: an abort racing
                # the thread's connect phase must still see a zombie
                cell["submitted"] = True
            try:
                await native_io.run(
                    native_io.write_part_blocking,
                    (head.addr.host, head.addr.port),
                    chunk_id, version, head.part_id, chain,
                    payload[:length], part_offset, cell,
                )
                return
            except native_io.NativeIOError as e:
                raise st.StatusError(
                    e.code if e.code > 0 else st.EIO, str(e)
                ) from None
            except (OSError, ConnectionError) as e:
                raise st.StatusError(st.EIO, f"native write: {e}") from None

        if _faults.ACTIVE:
            # client data-plane dial choke point (runtime/faults.py)
            await _faults.dial_point(
                "cs", f"{head.addr.host}:{head.addr.port}", role="client"
            )
        # bounded dial (unbounded-await audit): honors any ambient
        # RetryPolicy deadline on top of the 5 s cap
        reader, writer = await retrymod.bounded_wait(
            asyncio.open_connection(head.addr.host, head.addr.port), 5.0
        )
        try:
            await framing.send_message(
                writer,
                m.CltocsWriteInit(
                    req_id=1,
                    chunk_id=chunk_id,
                    version=version,
                    part_id=head.part_id,
                    chain=chain,
                    create=False,
                    session_id=self.session_id,
                ),
            )
            # every reply wait is deadline-bounded (unbounded-await
            # audit): a chunkserver that accepts frames but never acks
            # fails this part write in bounded time instead of wedging
            # the session forever
            init = await retrymod.bounded_wait(
                framing.read_message(reader), 30.0
            )
            if not isinstance(init, m.CstoclWriteStatus) or init.status != st.OK:
                raise st.StatusError(getattr(init, "status", st.EIO), "write init")
            nbytes = max(length, 0)
            write_id = 0
            expected = set()
            from lizardfs_tpu_torch.ops import crc32 as crc_mod

            pos = 0
            while pos < nbytes:
                abs_off = part_offset + pos
                block = abs_off // MFSBLOCKSIZE
                block_off = abs_off % MFSBLOCKSIZE
                take = min(MFSBLOCKSIZE - block_off, nbytes - pos)
                piece = payload[pos : pos + take].tobytes()
                pos += take
                if not piece:
                    continue
                write_id += 1
                expected.add(write_id)
                await framing.send_message(
                    writer,
                    m.CltocsWriteData(
                        req_id=write_id,
                        chunk_id=chunk_id,
                        write_id=write_id,
                        block=block,
                        offset=block_off,
                        crc=crc_mod.crc32(piece),
                        data=piece,
                    ),
                )
            while expected:
                msg = await retrymod.bounded_wait(
                    framing.read_message(reader), 30.0
                )
                if not isinstance(msg, m.CstoclWriteStatus):
                    raise st.StatusError(st.EIO, "unexpected write reply")
                if msg.status != st.OK:
                    raise st.StatusError(msg.status, f"write id {msg.write_id}")
                expected.discard(msg.write_id)
            await framing.send_message(
                writer, m.CltocsWriteEnd(req_id=0, chunk_id=chunk_id)
            )
            end = await retrymod.bounded_wait(
                framing.read_message(reader), 30.0
            )
            if not isinstance(end, m.CstoclWriteStatus) or end.status != st.OK:
                raise st.StatusError(getattr(end, "status", st.EIO), "write end")
        finally:
            await retrymod.close_writer(writer, swallow_cancel=True)

    # --- read path ---------------------------------------------------------------------

    async def read_file(self, inode: int, offset: int = 0, size: int | None = None) -> bytes:
        t0 = _time.perf_counter()
        tid, fresh_trace = tracing.begin()
        # the read-phase sink is scoped to THIS logical read: every
        # locate/dial/wait/net/decode/gather charge below — including
        # ones from the conn pool and read executor — lands on this
        # client's read_phases exactly once (retries/fallbacks re-enter
        # phases, never the wall/rep accounting)
        sink_tok = tracing.PHASE_SINK.set(self._read_sink)
        try:
            with accounting.task_session(self.session_id):
                data = await self._read_file_inner(inode, offset, size)
        finally:
            tracing.PHASE_SINK.reset(sink_tok)
            tracing.end(fresh_trace)
        # ONE logical read == ONE accounting record: replica fallbacks
        # and dead-holder retries below this line never double-count
        t1 = _time.perf_counter()
        dt = t1 - t0
        self.read_phases.add_wall(dt)
        # root span: the attribution wall anchor (`trace-dump --attribute`)
        self.trace_ring.record(
            tid, "read_file", t0, t1, role="client", bytes=len(data),
        )
        self.session_ops.record(
            self.session_id, "read", dt, nbytes=len(data), trace_id=tid,
        )
        return data

    def session_stats_doc(self) -> dict:
        """Workload summary for the master's `top` rollup: the client's
        read/write phase breakdowns ride the same CltomaSessionStats
        push the protocol gateways use, so `lizardfs-admin top` (and
        the webui) name each session's read roofline."""
        return {
            "role": "client",
            "read_phases": self.read_phases.snapshot(),
            "write_phases": self.write_phases.snapshot(),
        }

    async def push_session_stats(self) -> None:
        """Push :meth:`session_stats_doc` to the master (best effort —
        telemetry must never fail the caller)."""
        import json as _json

        try:
            await self._call(
                m.CltomaSessionStats,
                stats_json=_json.dumps(self.session_stats_doc()),
            )
        except (ConnectionError, OSError, asyncio.TimeoutError,
                st.StatusError):
            log.debug("session-stats push failed", exc_info=True)

    async def _read_file_inner(
        self, inode: int, offset: int, size: int | None
    ) -> bytes:
        if size is not None and size > 0:
            ci = offset // MFSCHUNKSIZE
            if (offset + size - 1) // MFSCHUNKSIZE == ci:
                # sized single-chunk read (every FUSE/NFS READ is this
                # shape): ONE master RPC — the locate reply carries
                # file_length, so the separate getattr round trip that
                # used to precede every read is gone (reference:
                # fs_readchunk returns the length the same way)
                piece = await self._read_chunk_range(
                    inode, ci, offset - ci * MFSCHUNKSIZE, size, None
                )
                return b"" if piece is None else piece.tobytes()
        attr = await self.getattr(inode)
        length = attr.length
        if size is None:
            size = max(length - offset, 0)
        end = min(offset + size, length)
        if end <= offset:
            return b""
        out = np.zeros(end - offset, dtype=np.uint8)
        await self._read_into(inode, offset, out, length)
        return out.tobytes()

    async def read_file_into(
        self, inode: int, offset: int, out: np.ndarray
    ) -> int:
        """pread-style zero-extra-copy read: fill ``out`` with file bytes
        at ``offset``; returns bytes read (short at EOF). On the bulk
        path the network recv lands directly in ``out``. ``out`` must be
        C-contiguous uint8."""
        tid, fresh_trace = tracing.begin()
        tp0 = _time.perf_counter()
        sink_tok = tracing.PHASE_SINK.set(self._read_sink)
        try:
            attr = await self.getattr(inode)
            length = attr.length
            end = min(offset + out.size, length)
            if end <= offset:
                return 0
            n = end - offset
            with accounting.task_session(self.session_id):
                await self._read_into(inode, offset, out[:n], length)
            tp1 = _time.perf_counter()
            self.trace_ring.record(
                tid, "read_file", tp0, tp1, role="client", bytes=n
            )
            self.read_phases.add_wall(tp1 - tp0)
            self.session_ops.record(
                self.session_id, "read", tp1 - tp0, nbytes=n, trace_id=tid,
            )
            return n
        finally:
            tracing.PHASE_SINK.reset(sink_tok)
            tracing.end(fresh_trace)

    async def _read_into(
        self, inode: int, offset: int, out: np.ndarray, length: int
    ) -> None:
        """Fill ``out`` (C-contiguous uint8) with [offset, offset+len(out)).

        Pipelines chunk ranges: while one chunk's bytes stream in C++,
        the next chunk's locate RPC and stream startup proceed (each
        task writes a disjoint slice of ``out``)."""
        end = offset + out.size
        window = asyncio.Semaphore(3)

        async def read_one(index, chunk_off, take, dst):
            async with window:
                piece = await self._read_chunk_range(
                    inode, index, chunk_off, take, length,
                    into=out, into_offset=dst,
                )
                if piece is not None:
                    out[dst : dst + take] = piece

        tasks = []
        pos = offset
        while pos < end:
            index = pos // MFSCHUNKSIZE
            chunk_off = pos % MFSCHUNKSIZE
            take = min(MFSCHUNKSIZE - chunk_off, end - pos)
            tasks.append(asyncio.ensure_future(
                read_one(index, chunk_off, take, pos - offset)
            ))
            pos += take
        try:
            for t in tasks:
                await t
        finally:
            for t in tasks:
                t.cancel()
            # join the stragglers: their native reader threads may still
            # be scattering into `out`; the caller must never see the
            # exception before every writer is done with the buffer
            await asyncio.gather(*tasks, return_exceptions=True)

    async def _read_chunk_range(
        self, inode: int, chunk_index: int, off: int, size: int,
        file_length: int | None, into: np.ndarray | None = None,
        into_offset: int = 0,
    ) -> np.ndarray | None:
        """Read one chunk range. Returns the bytes — or ``None`` when
        they were scattered directly into ``into`` (bulk aligned reads
        of standard chunks land network bytes in the caller's buffer).

        ``file_length=None``: length unknown — learn it from the locate
        reply (MatoclReadChunk.file_length, like the reference's
        fs_readchunk) and clamp there, saving sized reads the separate
        getattr round trip. Only valid with ``into=None``."""
        if file_length is None:
            assert into is None, "length-from-locate needs the copy path"
            chunk_len = MFSCHUNKSIZE  # provisional; clamped post-locate
        else:
            chunk_len = min(
                max(file_length - chunk_index * MFSCHUNKSIZE, 0),
                MFSCHUNKSIZE,
            )
        # bulk reads skip the block cache entirely: probing + filling it
        # costs a per-64KiB-block copy, and streaming workloads would
        # only evict it anyway (the reference's readcache is similarly
        # bypassed by its readahead path for large requests). An inode
        # flagged EATTR_NOCACHE takes the same bypass for every read —
        # its bytes must never be served from or land in the cache
        bulk = (
            size >= self.CACHE_BYPASS_BYTES
            or bool(self._eattr.get(inode, 0) & EATTR_NOCACHE)
        )
        lo_b = off // MFSBLOCKSIZE
        hi_b = (off + size - 1) // MFSBLOCKSIZE
        if not bulk:
            # cache fast path: all covering blocks resident
            cached = [
                self.cache.get(inode, chunk_index, b)
                for b in range(lo_b, hi_b + 1)
            ]
            if all(c is not None for c in cached):
                joined = b"".join(cached)
                rel = off - lo_b * MFSBLOCKSIZE
                if len(joined) >= rel + size:
                    return np.frombuffer(joined, dtype=np.uint8)[rel : rel + size]

        # block-align the request and extend by the readahead window;
        # bulk reads skip the extension — they bypass the cache, so
        # extra bytes would be fetched only to be discarded, and an
        # extended range disqualifies the zero-copy direct scatter
        adviser = self._readahead.setdefault(inode, ReadaheadAdviser())
        extra = (
            0 if bulk
            else adviser.advise(chunk_index * MFSCHUNKSIZE + off, size)
        )
        aligned_off = lo_b * MFSBLOCKSIZE
        # the unclamped end the caller asked for: re-clamps against a
        # fresher file_length (growth during retries) start from here
        aligned_target = -(-(off + size + extra) // MFSBLOCKSIZE) * MFSBLOCKSIZE
        aligned_end = min(aligned_target, chunk_len)
        read_size = aligned_end - aligned_off
        req_size = size

        throttled = file_length is not None
        if throttled:
            t0 = self._t0()
            await self._throttle(read_size)  # QoS: charge once, not per retry
            self._read_phase("wait", t0)
        last_error: Exception | None = None
        bad_addrs: set[tuple[str, int]] = set()  # replicas that failed us
        for attempt in range(self.retries):
            if attempt:
                t0 = self._t0()
                await asyncio.sleep(min(0.1 * 2 ** attempt, 2.0))  # backoff
                self._read_phase("wait", t0)
            loc = None
            fresh = False
            if attempt == 0:
                cached = self._locate_cache.get((inode, chunk_index))
                if (cached is not None and _time.monotonic() - cached[1]
                        <= self.locate_cache_ttl):
                    loc = cached[0]
                    self.op_counters["locate_cache_hit"] = (
                        self.op_counters.get("locate_cache_hit", 0) + 1
                    )
            if loc is None:
                t0 = self._t0()
                token = self._locate_token(inode)
                # first attempt may serve the locate from a replica;
                # RETRY locates go to the primary — a failed read may
                # mean the replica's mirrored location set lags (e.g.
                # empty for a chunk just written), and the primary's is
                # authoritative
                locate = self._call_read if attempt == 0 else self._call
                loc = await locate(
                    m.CltomaReadChunk, inode=inode, chunk_index=chunk_index,
                    **self._ident(None, None),
                )
                fresh = True
                if (
                    loc.chunk_id and not loc.locations
                    and getattr(loc, "_replica_served", False)
                ):
                    # a real chunk with no locations FROM A REPLICA: its
                    # mirrored location set lags (parts registered with
                    # the primary only so far). Re-locate through the
                    # primary instead of failing the plan. A primary
                    # answer with no locations is authoritative — never
                    # re-ask (that would double locate load during a
                    # chunkserver outage).
                    loc = await self._call(
                        m.CltomaReadChunk, inode=inode,
                        chunk_index=chunk_index, **self._ident(None, None),
                    )
                # locate phase: the master round trip(s), replica
                # fallback included; cache hits charge nothing
                self._read_phase("locate", t0)
                if self._locate_token(inode) == token:
                    # refuse stores that raced an invalidation: the
                    # reply may predate the mutation that bumped epoch
                    # (the token folds in the clear generation, so a
                    # bulk clear can never alias an old epoch value)
                    self._locate_cache[(inode, chunk_index)] = (
                        loc, _time.monotonic()
                    )
                    if len(self._locate_cache) > 4096:
                        self._locate_cache.clear()  # crude bound
            # revalidate cached blocks against the chunk identity this
            # locate returned: a rewrite bumps the version, a truncate+
            # regrow swaps the chunk_id — either way stale blocks drop
            chunk_tag = (loc.chunk_id, loc.version)
            self.cache.note_version(inode, chunk_index, chunk_tag)
            if file_length is None or (
                fresh and loc.file_length > file_length
            ):
                # clamp the provisional geometry with the length the
                # locate just taught us — and RE-clamp on every fresh
                # (non-cached) reply that reports growth: a read racing
                # an append must not return short against the stale
                # length a first (possibly cached) locate pinned
                # (ADVICE r05). Growth after the throttle charge leaves
                # a few bytes unbilled — QoS charges once, not per retry.
                file_length = loc.file_length
                chunk_len = min(
                    max(file_length - chunk_index * MFSCHUNKSIZE, 0),
                    MFSCHUNKSIZE,
                )
                size = min(req_size, max(chunk_len - off, 0))
                if size <= 0:
                    return np.zeros(0, dtype=np.uint8)  # past EOF
                aligned_end = min(aligned_target, chunk_len)
                read_size = aligned_end - aligned_off
            if not throttled:
                # deferred until the locate-taught clamp: charging the
                # provisional geometry would bill EOF reads for bytes
                # never transferred
                throttled = True
                t0 = self._t0()
                await self._throttle(read_size)
                self._read_phase("wait", t0)
            if loc.chunk_id == 0:
                if into is not None:
                    into[into_offset : into_offset + size] = 0
                    return None
                return np.zeros(size, dtype=np.uint8)  # hole
            # direct scatter into the caller's buffer is possible only
            # when the network range IS the requested range
            direct = (
                into is not None and aligned_off == off and read_size == size
            )
            try:
                data = await self._read_located(
                    loc, chunk_index, aligned_off, read_size, file_length,
                    attempt=attempt, avoid=bad_addrs,
                    into=into if direct else None,
                    into_offset=into_offset,
                )
            except (ReadError, ConnectionError, OSError) as e:
                last_error = e
                bad_addrs.update(getattr(e, "used_addrs", ()))
                log.info("read retry %d for chunk %d: %s", attempt + 1, loc.chunk_id, e)
                continue
            if not bulk:
                # data is None when the bytes landed directly in `into`
                # (zero-copy scatter) — cache from there in that case
                src = (
                    data if data is not None
                    else into[into_offset : into_offset + size]
                )
                src_base = aligned_off if data is not None else off
                for b in range(lo_b, aligned_end // MFSBLOCKSIZE + 1):
                    s = b * MFSBLOCKSIZE - src_base
                    if s < 0:
                        continue
                    blk = src[s : s + MFSBLOCKSIZE]
                    if len(blk):
                        self.cache.put(
                            inode, chunk_index, b, blk.tobytes(),
                            version=chunk_tag,
                        )
            if extra > 0 and aligned_end < chunk_len:
                # sequential stream detected: warm the chunkservers' page
                # cache for the region after this one (PREFETCH analog)
                asyncio.ensure_future(
                    self._send_prefetch(
                        loc, aligned_end, min(extra, chunk_len - aligned_end)
                    )
                )
            if data is None:
                return None  # landed in `into` already
            rel = off - aligned_off
            return data[rel : rel + size]
        raise st.StatusError(st.EIO, f"read failed after retries: {last_error}")

    async def _send_prefetch(self, loc, chunk_off: int, size: int) -> None:
        """Fire-and-forget CltocsPrefetch to the data-part holders for
        the chunk byte range [chunk_off, chunk_off+size)."""
        try:
            slice_type = None
            targets = []
            for pl in loc.locations:
                cpt = geometry.ChunkPartType.from_id(pl.part_id)
                slice_type = cpt.type if slice_type is None else slice_type
                if cpt.is_data:
                    targets.append((pl, cpt))
            if slice_type is None:
                return
            d = slice_type.data_parts
            lo_slot = (chunk_off // MFSBLOCKSIZE) // d
            hi_slot = ((chunk_off + size - 1) // MFSBLOCKSIZE) // d
            part_off = lo_slot * MFSBLOCKSIZE
            part_size = (hi_slot - lo_slot + 1) * MFSBLOCKSIZE
            from lizardfs_tpu_torch.core.conn_pool import GLOBAL_POOL

            for pl, cpt in targets[:8]:
                addr = (pl.addr.host, pl.addr.port)
                try:
                    conn = await GLOBAL_POOL.acquire(addr)
                    await framing.send_message(
                        conn.writer,
                        m.CltocsPrefetch(
                            req_id=0, chunk_id=loc.chunk_id,
                            version=loc.version, part_id=pl.part_id,
                            offset=part_off, size=part_size,
                        ),
                    )
                    GLOBAL_POOL.release(addr, conn)
                except (OSError, ConnectionError):
                    pass
        except Exception:  # noqa: BLE001 — prefetch must never hurt reads
            log.debug("prefetch failed", exc_info=True)

    async def _read_located(
        self, loc, chunk_index: int, off: int, size: int, file_length: int,
        attempt: int = 0, avoid: set[tuple[str, int]] | None = None,
        into: np.ndarray | None = None, into_offset: int = 0,
    ) -> np.ndarray | None:
        from lizardfs_tpu_torch.core import chunk_planner
        from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS

        # whole-chunk planning (chunk_read_planner.cc analog): a chunk
        # may have several representations at once (std copy + ec parts
        # mid-conversion); rank them by viability/health/cost and fall
        # through to the next on failure
        cands = chunk_planner.candidates(
            loc.locations, GLOBAL_STATS.score, avoid or set()
        )
        if not cands:
            raise ReadError("no locations for chunk")
        last: Exception | None = None
        failed_addrs: list[tuple[str, int]] = []
        for cand in cands:
            try:
                return await self._read_slice(
                    cand.type, cand.copies, loc, chunk_index, off, size,
                    file_length, attempt=attempt, avoid=avoid,
                    into=into, into_offset=into_offset,
                )
            except (ReadError, ConnectionError, OSError) as e:
                # aggregate every candidate's failed replicas so the
                # caller's blacklist learns them all, not just the
                # last slice's
                failed_addrs.extend(getattr(e, "used_addrs", ()))
                last = e
        if last is None:
            raise ReadError("unreachable")
        if failed_addrs:
            last.used_addrs = failed_addrs
        raise last

    def _part_failure_observer(self, loc):
        """execute_plan ``on_part_failure`` hook: a CRC-flagged part
        failure (the holder SERVED bytes that fail their checksum)
        reports the damaged part to the master, which drops it from the
        holder and queues the chunk through the RebuildEngine — closing
        the loop from client-side detection to re-replication even
        though the read itself recovers via decode."""
        def observe(part, wire_part_id, addr, exc):
            if not getattr(exc, "crc", False):
                return
            key = (loc.chunk_id, wire_part_id, addr)
            if key in self._damage_reported:
                return
            if len(self._damage_reported) > 4096:
                self._damage_reported.clear()
            self._damage_reported.add(key)
            self.metrics.counter(
                "damaged_parts_reported",
                help="chunk parts this client CRC-rejected and "
                     "reported to the master for rebuild",
            ).inc()
            # detached: the report must not inherit (and die with) the
            # reading op's retry deadline
            retrymod.spawn_detached(
                self._report_damaged(loc.chunk_id, wire_part_id, addr)
            )
        return observe

    async def _report_damaged(self, chunk_id: int, part_id: int,
                              addr: tuple[str, int]) -> None:
        try:
            await self._call(
                m.CltomaChunkDamaged, chunk_id=chunk_id, part_id=part_id,
                host=addr[0], port=addr[1],
            )
        except (st.StatusError, ConnectionError, OSError,
                asyncio.TimeoutError):
            pass  # best-effort: the scrubber is the backstop

    async def _read_slice(
        self, slice_type, copies, loc, chunk_index: int, off: int,
        size: int, file_length: int, attempt: int = 0,
        avoid: set[tuple[str, int]] | None = None,
        into: np.ndarray | None = None, into_offset: int = 0,
    ) -> np.ndarray | None:
        import random

        from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS

        # copy choice within the slice: health scores demote flaky/slow
        # replicas; topology order (master sorts closest first) breaks
        # ties. Retries avoid replicas that already failed THIS read,
        # then randomize among what is left.
        def pick(locs):
            good = [l for l in locs if l[0] not in (avoid or ())]
            pool = good or locs
            if attempt > 0 and len(pool) > 1:
                return random.choice(pool)
            best = max(range(len(pool)),
                       key=lambda i: (GLOBAL_STATS.score(pool[i][0]), -i))
            return pool[best]

        by_part = {p: pick(locs) for p, locs in copies.items()}

        def _tag(err):
            err.used_addrs = [addr for addr, _ in by_part.values()]
            return err
        chunk_len = min(
            max(file_length - chunk_index * MFSCHUNKSIZE, 0), MFSCHUNKSIZE
        )
        part_sizes = {
            p: striping.part_length(slice_type, p, chunk_len)
            for p in range(slice_type.expected_parts)
        }
        if slice_type.is_standard:
            # single part: read only [off, off+size)
            plan = plans.SliceReadPlan(
                slice_type, [plans.RequestedPartInfo(0, size)], size
            )
            plan.read_operations.append(plans.ReadOp(0, off, size, 0, 0))
            in_place = (
                into is not None and into.flags.c_contiguous
                and into.dtype == np.uint8
            )
            buffer = (
                into[into_offset : into_offset + size] if in_place else None
            )
            try:
                result = await execute_plan(
                    plan, loc.chunk_id, loc.version, by_part,
                    wave_timeout=self.wave_timeout,
                    buffer=buffer,
                    on_part_failure=self._part_failure_observer(loc),
                )
            except (ReadError, ConnectionError, OSError) as e:
                raise _tag(e)
            if in_place:
                return None  # bytes landed in `into`
            return np.asarray(result[:size])
        # striped slice: read covering stripe slots from all data parts
        d = slice_type.data_parts
        first_data = 1 if slice_type.is_xor else 0
        lo_block = off // MFSBLOCKSIZE
        hi_block = (off + size - 1) // MFSBLOCKSIZE
        lo_slot = lo_block // d
        hi_slot = hi_block // d
        nslots = hi_slot - lo_slot + 1
        wanted = [first_data + i for i in range(d)]

        # whole-stripe fast path: all data parts healthy, the request is
        # exactly a slot-aligned region, and the caller gave us a
        # contiguous destination — ONE native call reads every part over
        # polled sockets and de-interleaves in C (no per-part thread
        # dispatch, no separate gather pass). Any failure falls through
        # to the wave executor below, which handles recovery.
        from lizardfs_tpu_torch.core import native_io

        region_blocks = hi_block - lo_block + 1
        if (
            native_io.parts_gather_available()
            # armed faults: the C gather can't be instrumented — the
            # wave executor below serves (LZ_FAULTS unset: unchanged)
            and not _faults.ACTIVE
            and into is not None
            and off == lo_slot * d * MFSBLOCKSIZE
            and size == region_blocks * MFSBLOCKSIZE
            and into.flags.c_contiguous and into.dtype == np.uint8
            and all(p in by_part for p in wanted)
            and attempt == 0
        ):
            cell: dict = {}
            # the hop carries the request trace id into the thread
            # (run_in_executor drops context); the whole native gather
            # (sockets + C de-interleave) is charged at the await as net
            # and its queue/run/resume parts — the chunkserver's
            # queue/disk/net attrs refine it in the attribution view
            hop = native_io.Hop(
                native_io.EXECUTOR, native_io.read_parts_gather_blocking,
                [by_part[p][0] for p in wanted],
                loc.chunk_id, loc.version,
                [by_part[p][1] for p in wanted],
                lo_slot * MFSBLOCKSIZE, region_blocks,
                into[into_offset : into_offset + size],
                cell,
            )
            fut = hop.future
            try:
                await asyncio.shield(fut)
                hop.charge("net")
                for p in wanted:
                    GLOBAL_STATS.record_success(by_part[p][0])
                # counted so tests/operators can see the fast path is
                # actually taken (a silent precondition miss would
                # quietly forfeit the 3x read win)
                self._record("stripe_gather_fast")
                return None
            except asyncio.CancelledError:
                native_io.abort_parts_gather(cell)
                try:
                    await asyncio.wait_for(asyncio.shield(fut), 10.0)
                except (Exception, asyncio.CancelledError):
                    pass
                raise
            except (native_io.NativeIOError, OSError, ConnectionError):
                self._record("stripe_gather_fallback")
                # degrade to the plan path (waves + recovery)
        # per-part scores from the shared chunkserver health registry:
        # an unhealthy holder's part drops in rank, so recovery reads
        # prefer parts on healthy servers (read_plan_executor.cc:95)
        planner = plans.SliceReadPlanner(
            slice_type, list(by_part.keys()),
            scores={p: GLOBAL_STATS.score(a[0])
                    for p, a in by_part.items()},
            encoder=self.encoder,
        )
        if not planner.is_readable(wanted):
            raise ReadError("not enough parts available")
        plan = planner.build_plan(wanted, lo_slot, nslots, part_sizes)
        # striped plans rotate bad parts internally via waves — no
        # blacklist tagging here, or one dead server would push every
        # healthy part off its topology-preferred copy on retry
        buf = await execute_plan(
            plan, loc.chunk_id, loc.version, by_part,
            wave_timeout=self.wave_timeout,
            on_part_failure=self._part_failure_observer(loc),
        )
        # reassemble the stripes we read, then slice the requested bytes.
        # The gather runs off-loop (native stripe_gather releases the
        # GIL) — at 64 MiB chunks an on-loop de-interleave serialized
        # every concurrent read behind ~40 ms of memcpy.
        bps = nslots * MFSBLOCKSIZE
        data_parts = {
            wanted[i]: buf[i * bps : (i + 1) * bps] for i in range(len(wanted))
        }
        rel = off - lo_slot * d * MFSBLOCKSIZE
        if (
            into is not None and rel == 0
            and into.flags.c_contiguous and into.dtype == np.uint8
        ):
            # zero-copy: de-interleave straight into the caller's buffer
            await native_io.run_hop(
                "gather", None, striping.assemble_chunk, data_parts,
                slice_type, size, into[into_offset : into_offset + size],
            )
            return None
        region = await native_io.run_hop(
            "gather", None, striping.assemble_chunk, data_parts, slice_type,
            d * bps,  # bytes covered by these stripes
        )
        return np.asarray(region[rel : rel + size])
