"""Chunkserver daemon: serving, write chains, master link, replicator.

The analog of the reference's chunkserver (reference:
src/chunkserver/network_worker_thread.cc serving state machine,
masterconn.cc master link, chunk_replicator.cc EC recovery). Disk work
runs in worker threads via ``asyncio.to_thread`` (the bgjobs pool
analog); the event loop stays non-blocking.

Data-plane flows:
  * read: CltocsRead -> stream of CstoclReadData (per-block CRC) +
    CstoclReadStatus
  * write: CltocsWriteInit opens a chain — this server stores the part
    and pipelines every CltocsWriteData to the next server in the chain;
    a write is acked upstream (CstoclWriteStatus) only when the local
    write AND the downstream ack both landed
  * replicate: master sends MatocsReplicate with source part locations;
    the replicator builds a recovery plan (copy same part / recover
    data / recover parity — slice_recovery_planner.h:29-38 modes all
    reduce to a SliceReadPlanner plan + ChunkEncoder recovery), executes
    it over the network, writes the part with fresh CRCs, reports
    CstomaChunkNew.

The port's copy of the JAX package's ``chunkserver/server.py``, with
these differences:
  * the encoder is the card's: ``ChunkServer`` takes an ``encoder`` or
    an ``encoder_name``, and with neither resolves ``get_encoder()``,
    which raises without a card. Tests pass a CPU encoder;
  * the replicator's steps are ``chunkserver/replicate.py``'s
    ``plan_rebuild`` and ``write_rebuilt`` around the network read, and
    its recovery encoder falls back to the configured one only on the
    sharded encoder's ``MeshUnavailable``.
The native data plane (the C++ listener of ``native_serve``, the native
read exchange and the shared-memory part ring) is the JAX package's, on
the port's build of ``native/`` (``core/native.py``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import threading
import time

import numpy as np

from lizardfs_tpu_torch.chunkserver import replicate
from lizardfs_tpu_torch.chunkserver.chunk_store import (
    ChunkStoreError,
    MultiStore,
)
from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import geometry, native_io
from lizardfs_tpu_torch.core import read_executor
from lizardfs_tpu_torch.core.encoder import ChunkEncoder, get_encoder
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch import constants as constants_mod
from lizardfs_tpu_torch.runtime import accounting
from lizardfs_tpu_torch.runtime import faults as faultsmod
from lizardfs_tpu_torch.runtime import qos as qosmod
from lizardfs_tpu_torch.runtime import retry as retrymod
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.daemon import Daemon
from lizardfs_tpu_torch.runtime.rpc import RpcConnection


class _WriteSession:
    """State for one open write chain on one connection.

    One session == one (chunk, part): clients and forwarding peers open
    a dedicated connection per chain head (csserventry analog).
    """

    def __init__(self, chunk_id: int, version: int, part_id: int,
                 trace_id: int = 0, session_id: int = 0):
        self.chunk_id = chunk_id
        self.version = version
        self.part_id = part_id
        self.trace_id = trace_id  # request trace from WriteInit
        self.session_id = session_id  # originating client session
        self.downstream: tuple[asyncio.StreamReader, asyncio.StreamWriter] | None = None
        self.down_status: dict[int, int] = {}  # write_id -> status
        self.down_event: dict[int, asyncio.Event] = {}
        self.relay_task: asyncio.Task | None = None

    async def close(self):
        if self.relay_task is not None:
            self.relay_task.cancel()
        if self.downstream is not None:
            _, w = self.downstream
            # bounded: a dead next-hop must not park session close
            await retrymod.close_writer(w, swallow_cancel=True)


class ChunkServer(Daemon):
    name = "chunkserver"

    def __init__(
        self,
        data_folder: str | list[str],
        master_addr: tuple[str, int] | list[tuple[str, int]] | None,
        host: str = "127.0.0.1",
        port: int = 0,
        label: str = "_",
        encoder: ChunkEncoder | None = None,
        encoder_name: str | None = None,
        wave_timeout: float = 0.3,
        heartbeat_interval: float = 5.0,
        native_data_plane: bool = True,
        admin_password: str | None = None,
    ):
        super().__init__(host, port)
        self.admin_password = admin_password
        folders = [data_folder] if isinstance(data_folder, str) else list(data_folder)
        self.store = MultiStore(folders)
        # flight-recorder incidents (breached-SLO trace captures) live
        # in the first data folder
        self.slo.recorder.set_dir(os.path.join(folders[0], "incidents"))
        # damaged chunks found by the scrubber since start — a health
        # rollup signal alongside damaged folders. Keyed so a bad part
        # that stays on disk is counted once, not once per scrub lap
        # (the master only drops it from the registry; the file — and
        # its re-detection — persists)
        self.chunks_damaged = 0
        self._damaged_seen: set[tuple[int, int]] = set()
        # per-session data-plane accounting (runtime/accounting.py):
        # reads/writes charge the originating session carried by the
        # request's trailing session_id; native-plane ops (no session
        # on their frames) aggregate under the "native" row. The top-K
        # summary folds into heartbeat health_json for the master's
        # cluster-wide `top` view.
        self.session_ops = accounting.SessionOps(
            self.metrics, "chunkserver", max_sessions=16
        )
        # per-chunk heat accumulator between heartbeats: chunk_id ->
        # [ops, bytes]. The top slice folds into heartbeat heat_json
        # (master/heat.py heavy-hitter sketch); bounded so a scan over
        # millions of chunks can't balloon the daemon — once full, new
        # (cold) chunks are dropped and the hot set keeps charging
        self._heat: dict[int, list[float]] = {}
        # (total, used) from the last heartbeat's store.space() so the
        # health snapshot doesn't re-stat the folders
        self._last_space: tuple[int, int] | None = None
        # native C++ data-plane listener (network_worker_thread analog);
        # its port is registered with the master as data_port
        self.data_server = None
        self._want_native_plane = native_data_plane
        # one or more master addresses (active + shadows); registration
        # cycles until the active master accepts
        if isinstance(master_addr, tuple):
            master_addr = [master_addr]
        self.master_addrs: list[tuple[str, int]] | None = master_addr
        self.master_addr = master_addr[0] if master_addr else None
        self.label = label
        self.cs_id = 0
        self.master: RpcConnection | None = None
        # highest cluster fencing epoch observed on any master link
        # (register/heartbeat acks and mirror refusals carry it). Echoed
        # on every registration and heartbeat so a deposed ex-primary
        # hears about the election from its own chunkservers and steps
        # down; an ack BELOW this fences the command link instead of
        # obeying a zombie. 0 = pre-HA / LZ_HA off, fencing disengaged.
        self.cluster_epoch = 0
        # the configured encoder: the one given, else by name, else the
        # card's (get_encoder() raises without one)
        self.encoder = encoder if encoder is not None else get_encoder(encoder_name)
        # replicator recovery backend, resolved lazily on first rebuild:
        # the mesh-sharded encoder over two or more cards
        # (LZ_SHARDED_RECOVERY=0 kills it), else the configured encoder
        self._recovery_encoder = None
        self.wave_timeout = wave_timeout
        self.heartbeat_interval = heartbeat_interval
        # chunk-tester pacing (hdd_test_chunk analog: the reference
        # scrubs ONE chunk per HDD_TEST_FREQ tick, rotating through the
        # folder — never a fixed prefix): rotate a cursor and stop after
        # ~budget bytes per round, so scrubbing is steady background
        # load instead of a 60 s storm that contends every part flock
        # with live writers
        self.test_budget_bytes = 16 * 2**20
        self._test_cursor = 0
        # write-chain next-hop init reply bound (unbounded-await audit
        # regression pin rides tests/test_chaos.py); class-level default
        # overridable per instance for tests
        self.CHAIN_INIT_TIMEOUT = 10.0
        self.log = logging.getLogger("chunkserver")
        # replication bandwidth cap (bytes/s, 0 = unlimited) — tweakable
        # at runtime (replication_bandwidth_limiter analog)
        from lizardfs_tpu_torch.runtime.limiter import TokenBucket

        self._repl_bps = self.tweaks.register("replication_bps", 0)
        self._repl_bucket = TokenBucket(0.0)
        # multi-tenant QoS data plane (runtime/qos.py): per-tenant
        # in-flight byte budgets under weighted deficit-round-robin.
        # Config arrives on heartbeat acks (MatocsRegisterReply.
        # qos_json: session->tenant map, weights, budget); unarmed
        # (or LZ_QOS=0) every data path pays two checks and nothing
        # else. Rebuild traffic enters as the "_rebuild" pseudo-tenant
        # so rebuilds and tenants cannot starve each other.
        self.qos_queue = qosmod.DrrByteQueue()
        self._qos_tenants: dict[int, str] = {}
        self._qos_raw = ""  # last applied qos_json (change detection)
        # fault injection for the SLO/flight-recorder e2e path: delays
        # every asyncio-plane read by this many ms (0 = off). The tweak
        # name survives as an ALIAS onto the general fault framework —
        # setting it arms (or clears, at 0) the equivalent serve_read
        # delay rule in runtime/faults.py, so `tweaks-set
        # debug_read_delay_ms N` and `faults-arm` steer the same engine.
        self._read_delay_ms = self.tweaks.register(
            "debug_read_delay_ms", 0, on_set=self._read_delay_alias
        )
        # sockets with a native stream in flight; shutdown() on stop so
        # blocked serve threads see EPIPE instead of waiting out their
        # deadline (a ThreadPoolExecutor joins its workers at exit)
        self._native_streams: set = set()
        # passive mirror links to NON-active configured masters (shadow
        # read replicas): addr -> {"conn", "cs_id", "rereg_at"}. The
        # shadow learns this server's part locations from them (volatile
        # state the changelog cannot carry) so replica locates have
        # locations to serve; the link carries registrations/heartbeats
        # only, never commands. LZ_SHADOW_READS=0 disables the plane.
        self._mirror: dict[tuple[str, int], dict] = {}
        # full part list re-report period (seconds): wholesale refresh
        # bounds shadow location drift (parts created by client writes
        # are recorded master-side only, never reported incrementally)
        self.mirror_reregister_interval = 60.0

    # --- lifecycle -----------------------------------------------------------

    async def setup(self) -> None:
        # standing derived chart (charts.cc "total traffic" analog)
        self.metrics.counter("bytes_read")
        self.metrics.counter("bytes_written")
        self.metrics.define("bytes_total", "bytes_read bytes_written ADD")
        await asyncio.to_thread(self.store.scan)
        for folder in self.store.damaged_folders:
            self.log.warning("data folder %s is damaged; skipping", folder)
        if self._want_native_plane and faultsmod.ACTIVE:
            # fault rules armed at startup: the C++ data plane cannot be
            # instrumented from Python, so it stands down and every data
            # byte flows through the hookable asyncio path. A documented
            # behavior change OF THE ARMED STATE ONLY — LZ_FAULTS unset
            # leaves the plane untouched (kill-switch discipline).
            self.log.info(
                "fault injection armed: native data plane standing down"
            )
            self._want_native_plane = False
        if self._want_native_plane:
            from lizardfs_tpu_torch.chunkserver import native_serve

            if native_serve.available():
                # lz_serve_start can fail transiently (fd pressure /
                # ephemeral-port races under heavy test load): retry
                # before falling back to the asyncio data path
                for attempt in range(3):
                    try:
                        self.data_server = native_serve.DataPlaneServer(
                            [s.folder for s in self.store.stores], self.host
                        )
                        self.log.info(
                            "native data plane on %s:%d",
                            self.host, self.data_server.port,
                        )
                        break
                    except RuntimeError as e:
                        self.log.warning(
                            "native data plane start failed "
                            "(attempt %d/3): %s", attempt + 1, e,
                        )
                        await asyncio.sleep(0.2 * (attempt + 1))
        self.add_timer(self.heartbeat_interval, self._heartbeat)
        # mirror maintenance runs on its OWN timer: a sick shadow
        # (accepted connect, hung register — the 30 s call_ok bound)
        # must never stall the command-plane heartbeat to the active
        self.add_timer(self.heartbeat_interval, self._mirror_maintain)
        self.add_timer(60.0, self._test_chunks)

    async def start(self) -> None:
        await super().start()
        from lizardfs_tpu_torch.core import native_io

        if native_io.available():
            # see native_io.prestart_executors: lazy thread spawn inside
            # submit() can block the loop under GIL pressure
            native_io.prestart_executors()
        if self.master_addr is not None:  # None = standalone (tests)
            await self._connect_master()

    async def teardown(self) -> None:
        # the debug_read_delay_ms alias rule is process-global state
        # armed on this daemon's behalf — it must not outlive the
        # daemon (in-process test clusters share one process)
        faultsmod.clear(alias="debug_read_delay_ms")
        if self.data_server is not None:
            await asyncio.to_thread(self.data_server.stop)
            self.data_server = None
        if self.master is not None:
            await self.master.close()
        for entry in list(self._mirror.values()):
            if entry.get("conn") is not None:
                await entry["conn"].close()
        self._mirror.clear()

    async def _connect_master(self) -> None:
        from lizardfs_tpu_torch.proto.status import StatusError

        last: Exception | None = None
        for addr in self.master_addrs:
            try:
                await self._connect_master_at(addr)
                self.master_addr = addr
                return
            except (OSError, ConnectionError, StatusError, asyncio.TimeoutError) as e:
                last = e
                if self.master is not None:
                    await self.master.close()
                    self.master = None
        raise ConnectionError(f"no active master reachable: {last}")

    def _part_report(self) -> list[m.ChunkPartInfo]:
        return [
            m.ChunkPartInfo(
                chunk_id=cf.chunk_id, version=cf.version, part_id=cf.part_id
            )
            for cf in self.store.all_parts()
        ]

    async def _connect_master_at(self, addr: tuple[str, int]) -> None:
        self.master = await RpcConnection.connect(*addr)
        for cls, handler in (
            (m.MatocsCreateChunk, self._cmd_create),
            (m.MatocsDeleteChunk, self._cmd_delete),
            (m.MatocsSetVersion, self._cmd_set_version),
            (m.MatocsTruncateChunk, self._cmd_truncate),
            (m.MatocsReplicate, self._cmd_replicate),
            (m.MatocsDuplicateChunk, self._cmd_duplicate),
        ):
            self.master.on_push(cls, handler)
        total, used = self.store.space()
        reply = await self.master.call_ok(
            m.CstomaRegister,
            addr=m.Addr(host=self.host, port=self.port),
            label=self.label,
            chunks=self._part_report(),
            total_space=total,
            used_space=used,
            data_port=self.data_server.port if self.data_server else 0,
            # echo the highest epoch we have seen: a zombie ex-primary
            # answering this addr fences itself on it and refuses us
            epoch=self.cluster_epoch,
        )
        self.cs_id = reply.cs_id
        self.cluster_epoch = max(
            self.cluster_epoch, getattr(reply, "epoch", 0)
        )
        self.log.info(
            "registered with master as cs %d (epoch %d)",
            self.cs_id, self.cluster_epoch,
        )

    async def stop(self) -> None:
        import socket as _socket

        for sock in list(self._native_streams):
            try:
                sock.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
        await super().stop()

    async def _heartbeat(self) -> None:
        if self.master_addr is None:
            return
        if self.master is None or self.master.closed:
            try:
                await self._connect_master()
            except OSError:
                return
        total, used = self.store.space()
        self._last_space = (total, used)
        if self.data_server is not None:
            # fold native-plane counters into the metrics registry so
            # charts/admin/prometheus see one consistent view — incl.
            # the per-op disk/net time split (stats v2), which answers
            # "where does data-plane wall time go" without tracing
            s = self.data_server.stats()
            self.metrics.gauge("native_bytes_read").set(float(s["bytes_read"]))
            self.metrics.gauge("native_bytes_written").set(
                float(s["bytes_written"])
            )
            for key in (
                "read_ops", "write_ops", "read_disk_us", "read_net_us",
                "write_disk_us", "write_net_us",
            ):
                if key in s:
                    self.metrics.gauge(f"native_{key}").set(float(s[key]))
            # shm ring plane (native/shm_ring.h proactor): how many
            # same-host segments are mapped and how many bytes skipped
            # the socket copy — the same view Prometheus scrapes
            self.metrics.gauge(
                "native_qos_deferrals",
                help="native data-plane ops paced/deferred by the "
                     "per-session QoS byte budgets (proactor drains + "
                     "threaded read/write paths)",
            ).set(float(self.data_server.qos_deferrals()))
            shm = self.data_server.shm_stats()
            for key, help_txt in (
                ("segments_mapped", "shm ring segments negotiated on "
                 "the native data plane (memfd mappings created)"),
                ("desc_ops", "part writes landed from shm ring "
                 "descriptors on the native data plane"),
                ("bytes", "payload bytes landed via shm ring segments "
                 "(no socket copy)"),
                ("active_segments", "shm ring segments currently "
                 "mapped (released on peer disconnect)"),
            ):
                self.metrics.gauge(
                    f"native_shm_{key}", help=help_txt
                ).set(float(shm[key]))
            self._fold_native_trace()
        try:
            import json as _json

            reply = await self.master.call(
                m.CstomaHeartbeat,
                cs_id=self.cs_id,
                total_space=total,
                used_space=used,
                # health rollup input: this CS's SLO burn / stall /
                # span-drop / disk-error snapshot rides the heartbeat
                # (skew-tolerant trailing field; old masters ignore it)
                health_json=_json.dumps(self.health_snapshot()),
                # per-chunk heat fold for the master's cluster heat map
                # (skew-tolerant trailing field; "" when LZ_HEAT is off
                # so the wire stays byte-identical to the pre-heat tree)
                heat_json=self._heat_fold_json(),
                # max epoch observed on ANY link (incl. mirror refusals
                # from a freshly promoted shadow): the deposed primary
                # learns of the election from this echo and steps down
                epoch=self.cluster_epoch,
                timeout=5.0,
            )
            reply_epoch = getattr(reply, "epoch", 0)
            if reply_epoch and reply_epoch < self.cluster_epoch:
                # the acking master never applied the epoch_bump we saw
                # elsewhere — zombie ex-primary. Fence the command link:
                # drop it and let the next tick re-cycle the address
                # list to the elected active. Its commands after this
                # point would mutate a forked history.
                self.log.warning(
                    "fencing command link to stale master (epoch %d < %d)",
                    reply_epoch, self.cluster_epoch,
                )
                await self.master.close()
                self.master = None
                return
            self.cluster_epoch = max(self.cluster_epoch, reply_epoch)
            # QoS data-plane config refresh (skew-tolerant trailing
            # qos_json; old masters send "" = stay unthrottled)
            self._qos_apply(getattr(reply, "qos_json", ""))
        except (ConnectionError, asyncio.TimeoutError):
            pass

    async def _observe_mirror_epoch(self, epoch: int) -> None:
        """Mirror->command flip: a mirror-plane reply (ack or refusal)
        announcing a HIGHER cluster epoch means an election happened —
        the peer at that address was promoted, and our command link
        points at the deposed ex-primary. Adopt the epoch and fence the
        command link; the next heartbeat re-dials the address list and
        lands command-capable on the new active (the stale mirror entry
        for its addr is popped by the next mirror tick)."""
        if epoch <= self.cluster_epoch:
            return
        self.cluster_epoch = epoch
        if self.master is not None and not self.master.closed:
            self.log.warning(
                "cluster epoch %d announced on the mirror plane — "
                "fencing the command link and re-dialing", epoch,
            )
            await self.master.close()
            self.master = None

    async def _mirror_maintain(self) -> None:
        """Own-timer wrapper for _mirror_tick (never inline in the
        heartbeat: mirror-plane trouble must not cost the active its
        heartbeats)."""
        if self.master_addr is None:
            return
        total, used = self.store.space()
        await self._mirror_tick(total, used)

    async def _mirror_tick(self, total: int, used: int) -> None:
        """Maintain passive mirror links to every configured NON-active
        master address: shadow read replicas learn this server's part
        locations from the registration (volatile state the changelog
        cannot carry) so their locate replies have locations to serve.
        Mirror links carry registrations/heartbeats only — a shadow
        never commands a chunkserver. The full part list re-reports
        every ``mirror_reregister_interval`` seconds (wholesale
        replacement on the shadow) so locations drift-heals; between
        reports a lagging location set is caught by the client's
        read-retry path, which re-locates through the primary."""
        from lizardfs_tpu_torch.constants import shadow_reads_enabled

        if (
            not shadow_reads_enabled()
            or not self.master_addrs
            or len(self.master_addrs) < 2
        ):
            return
        now = asyncio.get_running_loop().time()
        for addr in self.master_addrs:
            if addr == self.master_addr:
                # became (or is) the active command link: a leftover
                # mirror entry is stale
                entry = self._mirror.pop(addr, None)
                if entry is not None and entry.get("conn") is not None:
                    await entry["conn"].close()
                continue
            entry = self._mirror.get(addr)
            if entry is not None and entry.get("conn") is None:
                if now < entry["retry_at"]:
                    continue  # negative cache: peer refused recently
                entry = None
            if entry is not None and entry["conn"].closed:
                entry = None
            async def mirror_register(c):
                # ONE field list for initial registration and the 60 s
                # wholesale re-report — only the connection varies.
                # Plain `call`, not call_ok: a REFUSAL from a freshly
                # promoted master carries the NEW cluster epoch, and
                # that refusal is exactly how this chunkserver learns
                # to flip the address mirror->command (the flip itself
                # is _observe_mirror_epoch fencing the command link).
                reply = await c.call(
                    m.CstomaRegister,
                    addr=m.Addr(host=self.host, port=self.port),
                    label=self.label,
                    chunks=self._part_report(),
                    total_space=total,
                    used_space=used,
                    data_port=(
                        self.data_server.port if self.data_server else 0
                    ),
                    mirror=1,
                    epoch=self.cluster_epoch,
                    timeout=30.0,
                )
                await self._observe_mirror_epoch(
                    getattr(reply, "epoch", 0)
                )
                if getattr(reply, "status", 0) != 0:
                    raise st.StatusError(reply.status, "CstomaRegister")
                return reply

            conn = None  # a dial not yet handed to self._mirror
            try:
                if entry is None:
                    # bounded dial: this runs inside the heartbeat
                    # timer, and an unbounded connect to a blackholed
                    # shadow would stall command-plane heartbeats to
                    # the ACTIVE for the OS connect timeout
                    conn = await asyncio.wait_for(
                        RpcConnection.connect(*addr), timeout=5.0
                    )
                    reply = await mirror_register(conn)
                    self._mirror[addr] = {
                        "conn": conn, "cs_id": reply.cs_id,
                        "rereg_at": now + self.mirror_reregister_interval,
                    }
                    conn = None  # owned by the entry now
                    self.log.info(
                        "mirror-registered with shadow %s:%d", *addr
                    )
                elif now >= entry["rereg_at"]:
                    # wholesale part re-report on the SAME connection
                    # (the shadow replaces this server's recorded set)
                    reply = await mirror_register(entry["conn"])
                    entry["cs_id"] = reply.cs_id
                    entry["rereg_at"] = (
                        now + self.mirror_reregister_interval
                    )
                else:
                    await entry["conn"].call(
                        m.CstomaHeartbeat,
                        cs_id=entry["cs_id"],
                        total_space=total,
                        used_space=used,
                        health_json="",
                        # heat folds go to the ACTIVE only (shadows
                        # don't run the heat loop)
                        heat_json="",
                        timeout=5.0,
                    )
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    st.StatusError):
                # peer down, not a shadow, or refusing (e.g. the
                # ACTIVE master answers this addr, or its kill switch
                # is off): drop the link and back off
                if conn is not None:
                    # dialed but refused before it was stored
                    await conn.close()
                stale = self._mirror.pop(addr, None)
                if stale is not None and stale.get("conn") is not None:
                    await stale["conn"].close()
                elif entry is not None and entry.get("conn") is not None:
                    await entry["conn"].close()
                self._mirror[addr] = {"conn": None, "retry_at": now + 30.0}

    def _fold_native_trace(self) -> None:
        """Drain the native data plane's per-op trace ring into this
        daemon's SpanRing (the C side records receive/disk/send
        timestamps per traced op; here they become chunkserver-role
        spans dumps/merges understand)."""
        if self.data_server is None:
            return
        try:
            ops = self.data_server.trace_ops()
        except Exception:  # noqa: BLE001 — tracing must never hurt serving
            self.log.debug("native trace drain failed", exc_info=True)
            return
        for op in ops:
            # queue_us (lz_serve_trace3): QoS pacing wait inside the op
            # — the attribution engine splits the span's head into a
            # "queue" sub-interval so native backpressure is visible
            self.trace_ring.record(
                op["trace_id"], op["name"], op["t0"], op["t1"],
                role="chunkserver", bytes=op["bytes"],
                disk_us=op["disk_us"], net_us=op["net_us"],
                queue_us=op.get("queue_us", 0),
                chunk_id=op["chunk_id"],
            )
            # SLO accounting for the native plane rides the fold (the
            # C side has no objective engine): class by op name
            op_class = "read" if "read" in op["name"] else "write"
            self.slo.observe(
                op_class, max(op["t1"] - op["t0"], 0.0),
                trace_id=op["trace_id"], name=op["name"],
            )
            # the C plane parses the same trailing session_id the
            # asyncio plane reads (wire.h additive-tail convention;
            # lz_serve_trace2) — ops from legacy peers/stale .so land
            # on the "native" aggregate row so totals stay truthful
            self.session_ops.record(
                op.get("session_id") or "native", op_class,
                max(op["t1"] - op["t0"], 0.0),
                nbytes=op["bytes"], trace_id=op["trace_id"],
            )
            # native-plane ops heat the same per-chunk accumulator the
            # asyncio handlers charge — the master's heat map must not
            # go blind when the C++ data plane serves the bytes
            self._heat_charge(op["chunk_id"], op["bytes"])

    def trace_spans(self, trace_id: int | None = None) -> list[dict]:
        # pull whatever the native plane recorded since the last
        # heartbeat before dumping, so trace-dump is never stale
        self._fold_native_trace()
        return self.trace_ring.dump(trace_id)

    def _health_disk_errors(self) -> int:
        # damaged data folders + scrubber-found corrupt parts: either
        # degrades this daemon's health snapshot (runtime/slo.py)
        return len(self.store.damaged_folders) + self.chunks_damaged

    def _health_extra(self) -> dict:
        # reuse the space figures the heartbeat just computed instead
        # of re-statting every data folder (snapshot and heartbeat run
        # back to back; the fallback covers ad-hoc admin `health`)
        total, used = self._last_space or self.store.space()
        extra = {"cs_id": self.cs_id, "used_space": used,
                 "total_space": total}
        # per-session data-plane top-K rides the heartbeat health_json
        # (skew-tolerant: old masters ignore the key) so the master's
        # `top` rollup owns the cluster-wide byte attribution; empty
        # under LZ_TOP=0 — the heartbeat stays byte-identical
        sessions = self.session_ops.top(8)
        if sessions:
            extra["sessions"] = sessions
        # QoS data plane: which tenants are queued behind the byte
        # budget right now (health/`top` name throttled tenants)
        if self.qos_queue.armed:
            q = self.qos_queue.snapshot()
            extra["qos"] = {
                "waiting": q["waiting"],
                "throttle_waits": q["throttle_waits"],
            }
        return extra

    # --- per-chunk heat fold (master/heat.py input) -------------------------

    def _heat_charge(self, chunk_id: int, nbytes: int) -> None:
        """Charge one data-plane op against the chunk's heat row. Cheap
        enough for every read/write; gated so LZ_HEAT=off costs one
        env read and nothing else."""
        if not constants_mod.heat_enabled():
            return
        cell = self._heat.get(chunk_id)
        if cell is None:
            if len(self._heat) >= 1024:
                # full: keep charging known-hot chunks, drop newcomers
                # (the master's sketch only wants the heavy hitters)
                return
            cell = self._heat[chunk_id] = [0.0, 0.0]
        cell[0] += 1.0
        cell[1] += float(nbytes)

    def _heat_fold_json(self) -> str:
        """Top-K of the accumulator as heartbeat heat_json, then reset.
        Returns "" when LZ_HEAT is off or nothing charged — the
        heartbeat stays byte-identical to the pre-heat wire."""
        if not constants_mod.heat_enabled():
            self._heat.clear()
            return ""
        if not self._heat:
            return ""
        import json as _json

        top = sorted(
            self._heat.items(), key=lambda kv: kv[1][1], reverse=True
        )[:16]
        self._heat.clear()
        return _json.dumps({
            "chunks": [[cid, int(ops), int(nb)] for cid, (ops, nb) in top]
        })

    # --- multi-tenant QoS data plane ---------------------------------------

    def _qos_apply(self, text: str) -> None:
        """Install the master-pushed QoS config (heartbeat ack). Empty
        text disarms (master off/unconfigured: behavior reverts to the
        pre-QoS data plane). Idempotent per payload."""
        if text == self._qos_raw:
            return
        if not text:
            self._qos_raw = ""
            self._qos_tenants = {}
            self.qos_queue.configure({}, 0.0)
            self._qos_native_apply({})
            return
        import json as _json

        try:
            doc = _json.loads(text)
            tenants = {
                int(sid): str(t)
                for sid, t in (doc.get("tenants") or {}).items()
            }
            weights = {
                str(t): float(w)
                for t, w in (doc.get("weights") or {}).items()
            }
            weights[qosmod.REBUILD_TENANT] = float(
                doc.get("rebuild_weight", 1.0)
            )
            capacity = float(doc.get("inflight_mb", 0) or 0) * 2**20
        except (ValueError, TypeError):
            self.log.warning("bad qos_json from master; keeping previous")
            return
        self._qos_raw = text
        self._qos_tenants = tenants
        self.qos_queue.configure(weights, capacity)
        self._qos_native_apply(doc.get("session_bps") or {})

    def _qos_native_apply(self, session_bps: dict) -> None:
        """Per-session byte-rate budgets for the C++ data plane (epoll
        proactor descriptor drain + threaded reads). Best effort: a
        stale .so without the API simply stays unpaced — QoS fails
        open, never into a lockout."""
        if self.data_server is None:
            return
        try:
            self.data_server.qos_set({
                int(sid): int(bps) for sid, bps in session_bps.items()
            })
        except (AttributeError, ValueError, TypeError):
            pass

    def _qos_tenant(self, session_id) -> str:
        try:
            return self._qos_tenants.get(
                int(session_id or 0), qosmod.DEFAULT_TENANT
            )
        except (TypeError, ValueError):
            return qosmod.DEFAULT_TENANT

    async def _qos_admit(self, session_id, nbytes: int) -> "str | None":
        """Admit ``nbytes`` of data-plane work for the session's
        tenant. Returns the tenant token for :meth:`_qos_done`, or
        None when QoS is off/unarmed (the zero-cost path: these two
        checks and nothing else)."""
        if not constants_mod.qos_enabled() or not self.qos_queue.armed:
            return None
        tenant = (
            session_id if session_id == qosmod.REBUILD_TENANT
            else self._qos_tenant(session_id)
        )
        w0 = tracing.phase_t0()
        waited = await self.qos_queue.admit(tenant, nbytes)
        if waited:
            self.metrics.labeled_counter(
                "qos_throttle", {"tenant": tenant},
                help="data-plane ops that had to queue behind the "
                     "per-tenant in-flight byte budget (weighted DRR)",
            ).inc()
            # the wait itself is a labeled queue_wait timing + an
            # ambient-trace span, so DRR backpressure is attributable
            tracing.charge_queue_wait(
                self.metrics, self.trace_ring, "drr_disk", tenant, w0,
                role="chunkserver",
            )
        return tenant

    def _qos_done(self, tenant: "str | None", nbytes: int) -> None:
        if tenant is not None:
            self.qos_queue.done(tenant, nbytes)

    async def _test_chunks(self) -> None:
        """Chunk tester (hdd_test_chunk analog): rotate through every
        stored part, verifying up to ``test_budget_bytes`` per round —
        full-scrub coverage over time at bounded IO/CPU cost (the old
        fixed ``[:8]`` prefix re-scanned the same parts forever and, on
        big parts, read 8 x 64 MiB per round while holding part
        flocks against live writers)."""
        parts = self.store.all_parts()
        if not parts:
            return
        damaged = []
        tested_bytes = 0
        for _ in range(len(parts)):  # at most one full lap per round
            cf = parts[self._test_cursor % len(parts)]
            self._test_cursor += 1
            try:
                size = os.path.getsize(cf.path)
            except OSError:
                continue  # vanished mid-rotation (deleted chunk)
            ok = await asyncio.to_thread(self.store.test_part, cf)
            if not ok:
                damaged.append(
                    m.ChunkPartInfo(
                        chunk_id=cf.chunk_id, version=cf.version, part_id=cf.part_id
                    )
                )
            tested_bytes += size
            if tested_bytes >= self.test_budget_bytes:
                break
        self._test_cursor %= max(len(parts), 1)
        fresh = [
            info for info in damaged
            if (info.chunk_id, info.part_id) not in self._damaged_seen
        ]
        if fresh:
            self._damaged_seen.update(
                (info.chunk_id, info.part_id) for info in fresh
            )
            self.chunks_damaged += len(fresh)
            self.metrics.counter(
                "chunks_damaged",
                help="chunk parts the background scrubber found corrupt",
            ).inc(len(fresh))
        if damaged and self.master is not None and not self.master.closed:
            await self.master.send(
                m.CstomaChunkDamaged(cs_id=self.cs_id, chunks=damaged)
            )

    # --- master commands -------------------------------------------------------

    async def _ack(self, req_id: int, chunk_id: int, part_id: int, code: int):
        if self.master is not None and not self.master.closed:
            await self.master.send(
                m.CstomaChunkOpStatus(
                    req_id=req_id, status=code, chunk_id=chunk_id, part_id=part_id
                )
            )

    async def _run_job(self, msg, fn, *args):
        try:
            await asyncio.to_thread(fn, *args)
            code = st.OK
        except ChunkStoreError as e:
            code = e.code
        except Exception:
            self.log.exception("chunk op failed")
            code = st.EIO
        await self._ack(msg.req_id, msg.chunk_id, msg.part_id, code)

    async def _cmd_create(self, msg: m.MatocsCreateChunk):
        await self._run_job(
            msg, self.store.create, msg.chunk_id, msg.version, msg.part_id
        )

    async def _cmd_delete(self, msg: m.MatocsDeleteChunk):
        await self._run_job(
            msg, self.store.delete, msg.chunk_id, msg.version, msg.part_id
        )

    async def _cmd_set_version(self, msg: m.MatocsSetVersion):
        await self._run_job(
            msg,
            self.store.set_version,
            msg.chunk_id,
            msg.old_version,
            msg.new_version,
            msg.part_id,
        )

    async def _cmd_duplicate(self, msg: m.MatocsDuplicateChunk):
        await self._run_job(
            msg,
            self.store.duplicate,
            msg.src_chunk_id,
            msg.src_version,
            msg.part_id,
            msg.chunk_id,
            msg.version,
        )

    async def _cmd_truncate(self, msg: m.MatocsTruncateChunk):
        def job():
            cpt = geometry.ChunkPartType.from_id(msg.part_id)
            part_len = geometry.chunk_length_to_part_length(cpt, msg.chunk_length)
            self.store.set_version(
                msg.chunk_id, msg.old_version, msg.new_version, msg.part_id
            )
            self.store.truncate_part(
                msg.chunk_id, msg.new_version, msg.part_id, part_len
            )

        await self._run_job(msg, job)

    # --- replication (chunk_replicator.cc analog) -------------------------------

    async def _cmd_replicate(self, msg: m.MatocsReplicate):
        t0 = time.perf_counter()
        tw0 = time.time()
        # join the RebuildEngine's per-rebuild trace: the source reads
        # this replica issues carry the id into the peers' span rings,
        # and this executor span merges with the master's scheduler
        # span into one rebuild timeline
        tid = getattr(msg, "trace_id", 0)
        tracing.adopt_trace(tid)
        try:
            await self._replicate(msg)
            code = st.OK
        except (ChunkStoreError,) as e:
            code = e.code
        except Exception as e:
            self.log.warning("replication failed: %s", e)
            code = st.EIO
        finally:
            tracing.clear_trace()
        self.trace_ring.record(
            tid, "cs_replicate", tw0, time.time(), role="chunkserver",
            chunk_id=msg.chunk_id,
        )
        self.slo.observe(
            "replicate", time.perf_counter() - t0, trace_id=tid,
            name="cs_replicate",
        )
        await self._ack(msg.req_id, msg.chunk_id, msg.part_id, code)
        if code == st.OK and self.master is not None:
            cf = self.store.get(msg.chunk_id, msg.part_id)
            if cf is not None:
                new = m.CstomaChunkNew(
                    cs_id=self.cs_id,
                    chunks=[
                        m.ChunkPartInfo(
                            chunk_id=cf.chunk_id,
                            version=cf.version,
                            part_id=cf.part_id,
                        )
                    ],
                )
                await self.master.send(new)
                # shadow mirrors accept the same frame: a rebuilt part
                # becomes replica-locatable now instead of at the next
                # wholesale re-report (best-effort; the re-report
                # drift-heals a miss)
                for entry in self._mirror.values():
                    conn = entry.get("conn")
                    if conn is not None and not conn.closed:
                        try:
                            await conn.send(new)
                        except (ConnectionError, OSError, RuntimeError):
                            pass

    def _replicator_encoder(self):
        """The rebuild compute backend: the mesh-sharded encoder where
        it binds (two or more cards, the LZ_SHARDED_RECOVERY switch
        open), else the configured encoder. Only the sharded encoder's
        refusal falls back (``replicate.replicator_encoder``)."""
        if self._recovery_encoder is None:
            self._recovery_encoder = replicate.replicator_encoder(self.encoder)
            if self._recovery_encoder is not self.encoder:
                self.log.info(
                    "replicator: mesh-sharded recovery backend active"
                )
        return self._recovery_encoder

    async def _replicate(self, msg: m.MatocsReplicate) -> None:
        # source availability, the plan (a plain copy for std, else the
        # slice planner over the sources' health scores) and the part's
        # block count; recovery runs on the replicator's encoder
        plan, locations, nblocks = replicate.plan_rebuild(
            msg.part_id, msg.sources, self._replicator_encoder()
        )
        nbytes_needed = sum(op.request_size for op in plan.read_operations if op.wave == 0)
        self._repl_bucket.rate = float(self._repl_bps.value)
        self._repl_bucket.burst = max(self._repl_bucket.rate, 1.0)
        await self._repl_bucket.acquire(nbytes_needed)
        # rebuild traffic rides the SAME weighted data-plane queue as
        # client IO, as the "_rebuild" pseudo-tenant: a rebuild storm
        # is capped at its weight share, and a tenant flood cannot
        # starve rebuilds either
        qt = await self._qos_admit(qosmod.REBUILD_TENANT, nbytes_needed)
        try:
            data = await read_executor.execute_plan(
                plan,
                msg.chunk_id,
                msg.version,
                locations,
                wave_timeout=self.wave_timeout,
            )
        finally:
            self._qos_done(qt, nbytes_needed)
        self.metrics.counter("replications").inc()
        self.metrics.counter("replication_bytes").inc(float(len(data)))
        # the checksum runs on the configured encoder, not the recovery one
        await asyncio.to_thread(
            replicate.write_rebuilt, self.store, msg.chunk_id, msg.version,
            msg.part_id, data, nblocks, self.encoder,
        )

    # --- serving ---------------------------------------------------------------

    @staticmethod
    def _chunk_session(sessions: dict, chunk_id: int):
        """Resolve a frame that predates part addressing (1211/1214) to
        the connection's sole write session for the chunk. Sessions key
        on (chunk_id, part_id) because the vectored client multiplexes
        several parts of one chunk over a single connection."""
        for (cid, _part), session in sessions.items():
            if cid == chunk_id:
                return session
        return None

    async def handle_connection(self, reader, writer) -> None:
        # (chunk_id, part_id) -> session; see _chunk_session
        sessions: dict[tuple[int, int], _WriteSession] = {}
        admin_state: dict = {}
        # shared-memory part ring negotiated on this connection (pure-
        # Python demux of the same descriptor frames serve_native.cpp's
        # proactor drains; the mapping is released on disconnect)
        shm_state: dict = {}
        # in-flight _finish_write tasks still owe status frames on this
        # writer; native streaming must not interleave with them
        pending_writes: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    msg = await framing.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if isinstance(msg, (m.AdminInfo, m.AdminCommand)):
                    await self._serve_admin(writer, msg, admin_state)
                elif isinstance(msg, m.CltocsPrefetch):
                    # fire-and-forget page-cache warmup
                    self.spawn(asyncio.to_thread(
                        self.store.prefetch, msg.chunk_id, msg.version,
                        msg.part_id, msg.offset, msg.size,
                    ))
                elif isinstance(msg, m.CltocsRead):
                    # native streaming needs exclusive use of the socket;
                    # in-flight pipelined writes still owe status frames
                    t0 = time.perf_counter()
                    tw0 = time.time()
                    await self._debug_read_delay()
                    await self._serve_read(
                        writer, msg,
                        native_ok=not sessions and not pending_writes,
                    )
                    dt = time.perf_counter() - t0
                    self.metrics.timing("read").record(dt)
                    self.trace_ring.record(
                        msg.trace_id, "cs_read", tw0, time.time(),
                        role="chunkserver", bytes=msg.size,
                    )
                    self.slo.observe(
                        "read", dt, trace_id=msg.trace_id, name="cs_read"
                    )
                    self.session_ops.record(
                        msg.session_id or "unattributed", "read", dt,
                        nbytes=msg.size, trace_id=msg.trace_id,
                    )
                    self._heat_charge(msg.chunk_id, msg.size)
                elif isinstance(msg, m.CltocsReadBulk):
                    t0 = time.perf_counter()
                    tw0 = time.time()
                    await self._debug_read_delay()
                    await self._serve_read_bulk(writer, msg)
                    dt = time.perf_counter() - t0
                    self.metrics.timing("read_bulk").record(dt)
                    self.trace_ring.record(
                        msg.trace_id, "cs_read_bulk", tw0, time.time(),
                        role="chunkserver", bytes=msg.size,
                    )
                    self.slo.observe(
                        "read", dt, trace_id=msg.trace_id,
                        name="cs_read_bulk",
                    )
                    self.session_ops.record(
                        msg.session_id or "unattributed", "read", dt,
                        nbytes=msg.size, trace_id=msg.trace_id,
                    )
                    self._heat_charge(msg.chunk_id, msg.size)
                elif isinstance(msg, m.CltocsWriteInit):
                    await self._serve_write_init(writer, msg, sessions)
                elif isinstance(msg, m.CltocsWriteData):
                    await self._serve_write_data(
                        writer, msg, sessions, pending_writes
                    )
                elif isinstance(msg, (m.CltocsWriteBulk,
                                      m.CltocsWriteBulkPart)):
                    await self._serve_write_bulk(writer, msg, sessions)
                elif isinstance(msg, m.CltocsShmInit):
                    await self._serve_shm_init(writer, msg, shm_state)
                elif isinstance(msg, m.CltocsShmWritePart):
                    await self._serve_shm_write(
                        writer, msg, sessions, shm_state
                    )
                elif isinstance(msg, m.CltocsWriteEnd):
                    # one End seals EVERY part session of the chunk on
                    # this connection (the vectored client sends one
                    # End per connection), answered by a single status
                    for key in [k for k in sessions
                                if k[0] == msg.chunk_id]:
                        session = sessions.pop(key)
                        if session.downstream is not None:
                            _, dw = session.downstream
                            await framing.send_message(dw, msg)
                        await session.close()
                    await framing.send_message(
                        writer,
                        m.CstoclWriteStatus(
                            req_id=msg.req_id,
                            chunk_id=msg.chunk_id,
                            write_id=0,
                            status=st.OK,
                        ),
                    )
                else:
                    self.log.warning("unexpected %s", type(msg).__name__)
                    break
        finally:
            for session in sessions.values():
                await session.close()
            mm = shm_state.pop("mm", None)
            if mm is not None:
                # peer gone (incl. SIGKILL): release the mapping now —
                # segments are owned by the connection, never leaked
                # across reconnects
                mm.close()

    async def _serve_shm_init(self, writer, msg: m.CltocsShmInit,
                              shm_state: dict) -> None:
        """Map the client's memfd ring segment (native/shm_ring.h).

        The asyncio plane reads frames through a StreamReader, which
        drops SCM_RIGHTS ancillary data, so the segment is opened via
        ``/proc/<pid>/fd/<n>`` instead — same-host only, and the kernel
        enforces the same same-uid gate the UDS SO_PEERCRED check does.
        Acked with a CstoclWriteStatus; any refusal leaves the
        connection on the socket-copy path."""
        import mmap as mmap_mod
        import socket as socket_mod

        # same-host contract: a remote peer must not be able to drive
        # the /proc fd mapping (or pin server-side segments).  Unix
        # sockets qualify outright; TCP only from a loopback peer —
        # pure-Python runs have no UDS data listener, so the demux's
        # legitimate callers arrive over 127.0.0.1 (the /proc open
        # still enforces the same-uid gate either way).
        sock = writer.get_extra_info("socket")
        peer = writer.get_extra_info("peername")
        if sock is not None and sock.family == socket_mod.AF_UNIX:
            same_host = True
        else:
            host = peer[0] if isinstance(peer, tuple) and peer else None
            same_host = host in ("127.0.0.1", "::1")
        code = st.OK
        if (
            not same_host
            or not native_io.shm_ring_enabled()
            or msg.seg_size <= 0
            or msg.seg_size > (1 << 30)
        ):
            code = st.EINVAL
        else:
            try:
                fd = os.open(
                    f"/proc/{msg.pid}/fd/{msg.mem_fd}", os.O_RDONLY
                )
                try:
                    if os.fstat(fd).st_size < msg.seg_size:
                        raise OSError("segment smaller than advertised")
                    mm = mmap_mod.mmap(
                        fd, msg.seg_size, prot=mmap_mod.PROT_READ
                    )
                finally:
                    os.close(fd)
                old = shm_state.pop("mm", None)
                if old is not None:
                    old.close()  # renegotiation replaces the mapping
                shm_state["mm"] = mm
                shm_state["size"] = msg.seg_size
                self.metrics.counter(
                    "shm_segments_mapped",
                    help="shm ring segments mapped from same-host "
                         "clients (asyncio data plane)",
                ).inc()
            except OSError:
                code = st.EINVAL
        await framing.send_message(
            writer,
            m.CstoclWriteStatus(
                req_id=msg.req_id, chunk_id=0, write_id=0, status=code
            ),
        )

    async def _serve_shm_write(self, writer, msg: m.CltocsShmWritePart,
                               sessions, shm_state: dict) -> None:
        """Land one ring descriptor: the payload is read straight out
        of the mapped segment; the wire carried only addressing + CRCs.
        Acked exactly like a CltocsWriteBulkPart (FIFO per connection),
        so the windowed client's ack collector is path-agnostic."""
        session = sessions.get((msg.chunk_id, msg.part_id))
        mm = shm_state.get("mm")

        async def ack(code):
            await framing.send_message(
                writer,
                m.CstoclWriteStatus(
                    req_id=msg.req_id, chunk_id=msg.chunk_id,
                    write_id=msg.write_id, status=code,
                ),
            )

        nblocks = -(-msg.length // MFSBLOCKSIZE)
        if (
            session is None
            or mm is None
            or msg.length == 0
            or msg.part_offset % MFSBLOCKSIZE != 0
            or msg.ring_off + msg.length > shm_state.get("size", 0)
            or len(msg.crcs) != nblocks
        ):
            await ack(st.EINVAL)
            return
        tw0 = time.time()
        t0 = time.perf_counter()
        data = bytes(mm[msg.ring_off : msg.ring_off + msg.length])

        def apply_all():
            pos = 0
            for crc in msg.crcs:
                piece = data[pos : pos + MFSBLOCKSIZE]
                # store.write verifies the piece against its wire CRC
                self.store.write(
                    msg.chunk_id, session.version, session.part_id,
                    (msg.part_offset + pos) // MFSBLOCKSIZE, 0,
                    piece, int(crc),
                )
                pos += len(piece)

        code = st.OK
        qt = await self._qos_admit(session.session_id, msg.length)
        try:
            await asyncio.to_thread(apply_all)
        except ChunkStoreError as e:
            code = e.code
        except Exception:
            self.log.exception("shm write failed")
            code = st.EIO
        finally:
            self._qos_done(qt, msg.length)
        self.metrics.counter("bytes_written").inc(float(msg.length))
        self.metrics.counter(
            "shm_desc_writes",
            help="part writes landed from shm ring descriptors "
                 "(asyncio data plane)",
        ).inc()
        self.trace_ring.record(
            session.trace_id, "cs_write_shm", tw0, time.time(),
            role="chunkserver", bytes=msg.length,
        )
        dt = time.perf_counter() - t0
        self.slo.observe(
            "write", dt, trace_id=session.trace_id, name="cs_write_shm"
        )
        self.session_ops.record(
            session.session_id or "unattributed", "write", dt,
            nbytes=msg.length, trace_id=session.trace_id,
        )
        self._heat_charge(msg.chunk_id, msg.length)
        await ack(code)

    @staticmethod
    def _read_delay_alias(ms) -> None:
        """``debug_read_delay_ms`` tweak setter: arm (or clear, at 0)
        the equivalent fault rule. Alias slot = one live rule max."""
        try:
            ms = int(ms)
        except (TypeError, ValueError):
            return
        if ms > 0:
            faultsmod.arm(
                f"chunkserver:serve_read delay={ms}",
                alias="debug_read_delay_ms",
            )
        else:
            faultsmod.clear(alias="debug_read_delay_ms")

    async def _debug_read_delay(self) -> None:
        """The ``serve_read`` fault choke point on the asyncio-plane
        read path (runtime/faults.py). The ``debug_read_delay_ms``
        tweak arms a delay rule here; LZ_FAULTS/admin-armed rules can
        also stall or abort the path, so SLO breach -> flight-record ->
        health-degrade stays drillable end to end."""
        if faultsmod.ACTIVE:
            await faultsmod.async_point(
                "serve_read", op="cs_read", role="chunkserver"
            )

    async def _serve_admin(self, writer, msg, state: dict | None = None) -> None:
        import json

        state = state if state is not None else {}
        if isinstance(msg, m.AdminCommand):
            reply = self.admin_gate(msg, state)
            if reply is not None:
                await framing.send_message(writer, reply)
                return
        if isinstance(msg, m.AdminInfo):
            total, used = self.store.space()
            await framing.send_message(
                writer,
                m.AdminInfoReply(
                    req_id=msg.req_id, status=st.OK,
                    json=json.dumps({
                        "cs_id": self.cs_id, "label": self.label,
                        "parts": len(self.store.all_parts()),
                        "total_space": total, "used_space": used,
                    }),
                ),
            )
            return
        reply = self.handle_admin_basics(msg)
        if reply is None:
            reply = m.AdminReply(req_id=msg.req_id, status=st.EINVAL, json="{}")
        await framing.send_message(writer, reply)

    async def _serve_read(
        self, writer, msg: m.CltocsRead, native_ok: bool = True
    ) -> None:
        if (
            native_ok
            and native_io.available()
            and msg.size >= native_io.NATIVE_READ_THRESHOLD
            # armed faults: the native load path bypasses store.read,
            # where the disk_pread choke point lives — serve through
            # the instrumented path (LZ_FAULTS unset: unchanged)
            and not faultsmod.ACTIVE
        ):
            served = await self._serve_read_native(writer, msg)
            if served:
                return
        # QoS: the disk phase holds per-tenant in-flight credits (the
        # send phase must not — a wedged consumer would pin the shared
        # pool; its connection already self-backpressures)
        qt = await self._qos_admit(msg.session_id, msg.size)
        try:
            pieces = await asyncio.to_thread(
                self.store.read,
                msg.chunk_id,
                msg.version,
                msg.part_id,
                msg.offset,
                msg.size,
            )
        except ChunkStoreError as e:
            await framing.send_message(
                writer,
                m.CstoclReadStatus(
                    req_id=msg.req_id, chunk_id=msg.chunk_id, status=e.code
                ),
            )
            return
        finally:
            self._qos_done(qt, msg.size)
        for off, data, crc in pieces:
            self.metrics.counter("bytes_read").inc(float(len(data)))
            await framing.send_message(
                writer,
                m.CstoclReadData(
                    req_id=msg.req_id,
                    chunk_id=msg.chunk_id,
                    offset=off,
                    crc=crc,
                    data=bytes(data),
                ),
            )
        await framing.send_message(
            writer,
            m.CstoclReadStatus(
                req_id=msg.req_id, chunk_id=msg.chunk_id, status=st.OK
            ),
        )

    async def _serve_read_bulk(self, writer, msg: m.CltocsReadBulk) -> None:
        """Asyncio fallback for the bulk read op (serve_native.cpp is
        the fast path): load pieces, reply with ONE frame whose CRCs the
        receiver verifies."""
        def reply_err(code):
            return framing.send_message(
                writer,
                m.CstoclReadBulkData(
                    req_id=msg.req_id, chunk_id=msg.chunk_id, status=code,
                    offset=msg.offset, crcs=[], data=b"",
                ),
            )

        if msg.offset % MFSBLOCKSIZE != 0 or msg.size == 0:
            await reply_err(st.EINVAL)
            return
        qt = await self._qos_admit(msg.session_id, msg.size)
        try:
            pieces = await asyncio.to_thread(
                self.store.read,
                msg.chunk_id, msg.version, msg.part_id, msg.offset, msg.size,
            )
        except ChunkStoreError as e:
            await reply_err(e.code)
            return
        finally:
            self._qos_done(qt, msg.size)
        self.metrics.counter("bytes_read").inc(float(msg.size))
        await framing.send_message(
            writer,
            m.CstoclReadBulkData(
                req_id=msg.req_id, chunk_id=msg.chunk_id, status=st.OK,
                offset=msg.offset,
                crcs=[crc for _, _, crc in pieces],
                data=b"".join(bytes(d) for _, d, _ in pieces),
            ),
        )

    async def _serve_read_native(self, writer, msg: m.CltocsRead) -> bool:
        """Stream the response via native/io_native.cpp — load + CRC
        verify under the chunk lock, then frame + send off the event
        loop with the lock released and the GIL dropped. Returns False
        to fall back to the per-piece asyncio path."""
        try:
            cf = self.store.require(msg.chunk_id, msg.version, msg.part_id)
        except ChunkStoreError as e:
            await framing.send_message(
                writer,
                m.CstoclReadStatus(
                    req_id=msg.req_id, chunk_id=msg.chunk_id, status=e.code
                ),
            )
            return True
        max_bytes = cf.max_blocks() * MFSBLOCKSIZE
        if msg.offset + msg.size > max_bytes:
            await framing.send_message(
                writer,
                m.CstoclReadStatus(
                    req_id=msg.req_id, chunk_id=msg.chunk_id, status=st.EINVAL
                ),
            )
            return True
        sock = writer.get_extra_info("socket")
        if sock is None:
            return False
        if not native_io.serve_slot_available():
            return False  # executor saturated (stalled clients): asyncio path

        def load():
            with cf.lock:
                return native_io.load_read_blocking(
                    cf.path, msg.offset, msg.size, cf.data_length()
                )

        native_io.serve_slot_acquire()
        try:
            return await self._serve_read_native_inner(
                writer, msg, cf, sock, load
            )
        finally:
            native_io.serve_slot_release()

    async def _serve_read_native_inner(
        self, writer, msg, cf, sock, load
    ) -> bool:
        # QoS in-flight credits cover the disk load (same contract as
        # the asyncio path; the stream phase self-backpressures)
        qt = await self._qos_admit(msg.session_id, msg.size)
        try:
            rc, buf, crcs = await native_io.run_serve(load)
        except FileNotFoundError:
            rc = st.NO_CHUNK  # file vanished between require() and open
        except OSError:
            rc = st.EIO  # transient local error (EMFILE, EACCES, ...)
        finally:
            self._qos_done(qt, msg.size)
        if rc != st.OK:
            self.log.warning(
                "native read of %016X:%d failed: %s",
                msg.chunk_id, msg.part_id, st.name(rc),
            )
            await framing.send_message(
                writer,
                m.CstoclReadStatus(
                    req_id=msg.req_id, chunk_id=msg.chunk_id, status=rc
                ),
            )
            return True
        self.metrics.counter("bytes_read").inc(float(msg.size))
        # raw fd sends must not jump ahead of queued transport bytes;
        # drain() only waits below the high-water mark, so under
        # sustained output the loaded buffer is streamed through the
        # transport instead of being thrown away for a second disk pass
        # lint: waive(unbounded-await): server->client read backpressure on the per-connection serve task — a wedged consumer parks only its own connection, reaped on disconnect; a timer would cut live slow readers
        await writer.drain()
        if writer.transport.get_write_buffer_size() != 0:
            await self._stream_pieces_asyncio(writer, msg, buf, crcs)
            return True
        try:
            # the streaming thread owns this dup: the connection task may
            # be cancelled (and the transport fd closed + reused) while
            # the thread is still sending
            fd = os.dup(sock.fileno())
        except OSError:
            await self._stream_pieces_asyncio(writer, msg, buf, crcs)
            return True
        # exactly one of {worker thread, cancellation handler} claims the
        # dup — a job cancelled while still queued never runs its
        # finally, so the loser of this race must not touch the fd
        claim = threading.Lock()

        def stream_job():
            if not claim.acquire(blocking=False):
                return -1  # cancelled before start; fd already closed
            return native_io.stream_read_blocking(
                fd, msg.chunk_id, msg.req_id, msg.offset, msg.size,
                buf, crcs,
            )

        self._native_streams.add(sock)
        try:
            rc = await native_io.run_serve(stream_job)
        except BaseException:
            # covers CancelledError and executor-rejected submissions
            # (RuntimeError after shutdown): close the dup iff the
            # worker never claimed it
            if claim.acquire(blocking=False):
                os.close(fd)
            raise
        finally:
            self._native_streams.discard(sock)
        if rc < 0:
            writer.close()  # socket died mid-stream; let the loop unwind
        return True

    async def _stream_pieces_asyncio(self, writer, msg, buf, crcs) -> None:
        """Send an already-loaded + verified range as normal framed
        messages (used when the transport still has queued bytes)."""
        pos = msg.offset
        end = msg.offset + msg.size
        idx = 0
        while pos < end:
            block_start = (pos // MFSBLOCKSIZE) * MFSBLOCKSIZE
            piece_end = min(end, block_start + MFSBLOCKSIZE)
            await framing.send_message(
                writer,
                m.CstoclReadData(
                    req_id=msg.req_id,
                    chunk_id=msg.chunk_id,
                    offset=pos,
                    crc=int(crcs[idx]),
                    data=bytes(buf[pos - msg.offset:piece_end - msg.offset]),
                ),
            )
            idx += 1
            pos = piece_end
        await framing.send_message(
            writer,
            m.CstoclReadStatus(
                req_id=msg.req_id, chunk_id=msg.chunk_id, status=st.OK
            ),
        )

    async def _serve_write_init(self, writer, msg: m.CltocsWriteInit, sessions):
        session = _WriteSession(
            msg.chunk_id, msg.version, msg.part_id, trace_id=msg.trace_id,
            session_id=msg.session_id,
        )
        code = st.OK
        try:
            if msg.create and self.store.get(msg.chunk_id, msg.part_id) is None:
                await asyncio.to_thread(
                    self.store.create, msg.chunk_id, msg.version, msg.part_id
                )
            else:
                self.store.require(msg.chunk_id, msg.version, msg.part_id)
        except ChunkStoreError as e:
            code = e.code
        if code == st.OK and msg.chain:
            # connect to the next server and forward the init with the
            # rest of the chain (WRITEFWD state analog). Both the dial
            # AND the init reply are deadline-bounded (unbounded-await
            # audit): a next-hop that accepts the connect but never
            # answers used to wedge this whole write chain forever.
            nxt = msg.chain[0]
            try:
                dr, dw = await retrymod.bounded_wait(
                    asyncio.open_connection(nxt.addr.host, nxt.addr.port),
                    5.0,
                )
                session.downstream = (dr, dw)
                await framing.send_message(
                    dw,
                    m.CltocsWriteInit(
                        req_id=msg.req_id,
                        chunk_id=msg.chunk_id,
                        version=msg.version,
                        part_id=nxt.part_id,
                        chain=msg.chain[1:],
                        create=msg.create,
                        trace_id=msg.trace_id,
                        session_id=msg.session_id,
                    ),
                )
                reply = await retrymod.bounded_wait(
                    framing.read_message(dr), self.CHAIN_INIT_TIMEOUT
                )
                if (
                    not isinstance(reply, m.CstoclWriteStatus)
                    or reply.status != st.OK
                ):
                    code = getattr(reply, "status", st.EIO)
                else:
                    session.relay_task = self.spawn(
                        self._relay_down_statuses(session)
                    )
            except asyncio.TimeoutError:
                code = st.TIMEOUT
            except OSError:
                code = st.DISCONNECTED
        if code == st.OK:
            sessions[(msg.chunk_id, msg.part_id)] = session
        else:
            await session.close()
        await framing.send_message(
            writer,
            m.CstoclWriteStatus(
                req_id=msg.req_id, chunk_id=msg.chunk_id, write_id=0, status=code
            ),
        )

    async def _relay_down_statuses(self, session: _WriteSession) -> None:
        dr, _ = session.downstream
        try:
            while True:
                msg = await framing.read_message(dr)
                if isinstance(msg, m.CstoclWriteStatus):
                    ev = session.down_event.get(msg.write_id)
                    if ev is None:
                        # late ack: the waiter already timed out (the
                        # 30 s down_ev bound) and popped its entries —
                        # storing a status nobody will ever consume
                        # would leak one dict entry per timed-out write
                        continue
                    session.down_status[msg.write_id] = msg.status
                    ev.set()
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            # downstream died: fail all waiting writes
            for wid, ev in session.down_event.items():
                session.down_status.setdefault(wid, st.DISCONNECTED)
                ev.set()

    async def _serve_write_data(
        self, writer, msg: m.CltocsWriteData, sessions, pending_writes
    ):
        """Forward downstream in-order, then complete the local write and
        the upstream ack in a background task — the connection loop keeps
        reading, so blocks pipeline through the chain instead of paying
        one chain round trip each (WRITEFWD pipelining)."""
        session = self._chunk_session(sessions, msg.chunk_id)
        if session is None:
            await framing.send_message(
                writer,
                m.CstoclWriteStatus(
                    req_id=msg.req_id,
                    chunk_id=msg.chunk_id,
                    write_id=msg.write_id,
                    status=st.EINVAL,
                ),
            )
            return
        down_ev = None
        if session.downstream is not None:
            down_ev = asyncio.Event()
            session.down_event[msg.write_id] = down_ev
            _, dw = session.downstream
            try:
                await framing.send_message(dw, msg)
            except (ConnectionError, OSError):
                session.down_status[msg.write_id] = st.DISCONNECTED
                down_ev.set()
        task = self.spawn(self._finish_write(writer, session, msg, down_ev))
        pending_writes.add(task)
        task.add_done_callback(pending_writes.discard)

    async def _finish_write(self, writer, session, msg, down_ev) -> None:
        code = st.OK
        qt = await self._qos_admit(session.session_id, len(msg.data))
        try:
            await asyncio.to_thread(self._local_write, session, msg)
        except ChunkStoreError as e:
            code = e.code
        except Exception:
            self.log.exception("local write failed")
            code = st.EIO
        finally:
            self._qos_done(qt, len(msg.data))
        if down_ev is not None:
            # bounded like the bulk path: a next-hop that accepted the
            # dial but never acks must fail this write with TIMEOUT,
            # not park the head's write task forever (the write-chain
            # cousin of the bounded WriteInit reply above)
            try:
                await asyncio.wait_for(down_ev.wait(), 30.0)
                down_code = session.down_status.pop(
                    msg.write_id, st.DISCONNECTED
                )
            except asyncio.TimeoutError:
                down_code = st.TIMEOUT
            session.down_event.pop(msg.write_id, None)
            session.down_status.pop(msg.write_id, None)
            if code == st.OK:
                code = down_code
        try:
            await framing.send_message(
                writer,
                m.CstoclWriteStatus(
                    req_id=msg.req_id,
                    chunk_id=msg.chunk_id,
                    write_id=msg.write_id,
                    status=code,
                ),
            )
        except (ConnectionError, OSError):
            pass

    async def _serve_write_bulk(self, writer, msg, sessions):
        """Asyncio fallback for the bulk write ops (serve_native.cpp is
        the fast path): apply the whole block-aligned range, forward the
        frame down the chain, single combined ack. Accepts both the
        chunk-addressed CltocsWriteBulk and the part-addressed
        CltocsWriteBulkPart (vectored clients multiplex several parts
        of one chunk over one connection)."""
        part_id = getattr(msg, "part_id", None)
        if part_id is not None:
            session = sessions.get((msg.chunk_id, part_id))
        else:
            session = self._chunk_session(sessions, msg.chunk_id)

        async def ack(code):
            await framing.send_message(
                writer,
                m.CstoclWriteStatus(
                    req_id=msg.req_id, chunk_id=msg.chunk_id,
                    write_id=msg.write_id, status=code,
                ),
            )

        if session is None or msg.part_offset % MFSBLOCKSIZE != 0:
            await ack(st.EINVAL)
            return
        tw0 = time.time()
        t0 = time.perf_counter()  # monotonic twin of tw0 for the SLO
        down_ok = st.OK
        down_ev = None
        if session.downstream is not None:
            # register the ack event BEFORE anything can fail, so a
            # downstream death during the local apply fails this write
            # promptly instead of timing out
            down_ev = asyncio.Event()
            session.down_event[msg.write_id] = down_ev
            _, dw = session.downstream
            try:
                await framing.send_message(dw, msg)
            except (ConnectionError, OSError):
                down_ok = st.DISCONNECTED

        def apply_all():
            data = np.frombuffer(msg.data, dtype=np.uint8)
            pos = 0
            for i, crc in enumerate(msg.crcs):
                piece = data[pos:pos + MFSBLOCKSIZE]
                self.store.write(
                    msg.chunk_id, session.version, session.part_id,
                    (msg.part_offset + pos) // MFSBLOCKSIZE, 0,
                    piece.tobytes(), int(crc),
                )
                pos += len(piece)

        code = st.OK
        qt = await self._qos_admit(session.session_id, len(msg.data))
        try:
            await asyncio.to_thread(apply_all)
        except ChunkStoreError as e:
            code = e.code
        except Exception:
            self.log.exception("bulk write failed")
            code = st.EIO
        finally:
            self._qos_done(qt, len(msg.data))
        self.metrics.counter("bytes_written").inc(float(len(msg.data)))
        if down_ev is not None:
            if code == st.OK and down_ok == st.OK:
                # no pre-set compensation needed: every path that
                # stores down_status sets the event in the same step
                try:
                    await asyncio.wait_for(down_ev.wait(), 30.0)
                    code = session.down_status.pop(
                        msg.write_id, st.DISCONNECTED
                    )
                except asyncio.TimeoutError:
                    code = st.TIMEOUT
            elif code == st.OK:
                code = down_ok
            session.down_event.pop(msg.write_id, None)
            session.down_status.pop(msg.write_id, None)
        self.trace_ring.record(
            session.trace_id, "cs_write_bulk", tw0, time.time(),
            role="chunkserver", bytes=len(msg.data),
        )
        dt = time.perf_counter() - t0
        self.slo.observe(
            "write", dt, trace_id=session.trace_id, name="cs_write_bulk"
        )
        self.session_ops.record(
            session.session_id or "unattributed", "write", dt,
            nbytes=len(msg.data), trace_id=session.trace_id,
        )
        self._heat_charge(msg.chunk_id, len(msg.data))
        await ack(code)

    def _local_write(self, session: _WriteSession, msg: m.CltocsWriteData) -> None:
        self.metrics.counter("bytes_written").inc(float(len(msg.data)))
        self.store.write(
            msg.chunk_id,
            session.version,
            session.part_id,
            msg.block,
            msg.offset,
            msg.data,
            msg.crc,
        )
