"""Asyncio daemon harness: serve, timers, reload/terminate hooks.

The analog of the reference's event loop + main harness (reference:
src/common/event_loop.h:47-77 poll loop with timers and reload/exit
hooks; src/main/main.cc daemon scaffolding). One asyncio loop per
daemon; connection handlers and periodic tasks are coroutines.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys

from lizardfs_tpu_torch.runtime import faults as faultsmod
from lizardfs_tpu_torch.runtime import profiler as profmod
from lizardfs_tpu_torch.runtime import retry as retrymod
from lizardfs_tpu_torch.runtime import slo as slomod
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.metrics import Metrics
from lizardfs_tpu_torch.runtime.tweaks import Tweaks


def setup_logging(name: str, level: str = "INFO") -> logging.Logger:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname).1s [" + name + "] %(message)s",
        stream=sys.stderr,
    )
    return logging.getLogger(name)


class Daemon:
    """Base daemon: TCP server + named periodic timers + signal hooks."""

    name = "daemon"

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.log = logging.getLogger(self.name)
        self._server: asyncio.Server | None = None
        self._timers: list[tuple[float, object]] = []
        self._tasks: set[asyncio.Task] = set()
        self._conn_writers: set[asyncio.StreamWriter] = set()
        self._stopping = asyncio.Event()
        self.metrics = Metrics()
        self.tweaks = Tweaks()
        # request-scoped span ring (oplog-style), dumped over the admin
        # link via `trace-dump` and merged client-side into per-request
        # timelines (runtime/tracing.py)
        self.trace_ring = tracing.SpanRing()
        # silent trace loss under load must be visible: ring evictions
        # ride /metrics as lizardfs_span_ring_dropped_total
        self.trace_ring.attach_drop_counter(
            self.metrics.counter(
                "span_ring_dropped",
                help="trace spans evicted from the bounded span ring "
                     "before any dump read them",
            )
        )
        # SLO engine + flight recorder (runtime/slo.py): per-op-class
        # latency objectives whose burn rates/breach counts live in this
        # registry; breaches auto-capture their trace timeline.
        # Subclasses with a disk home point the recorder at an
        # incidents/ dir (slo.recorder.set_dir)
        self.slo = slomod.SloEngine(
            self.metrics, role=self.name, span_source=self.trace_spans
        )
        # always-on sampling profiler (runtime/profiler.py): adaptive
        # interval under a <2% overhead budget, dumped as collapsed
        # stacks via `lizardfs-admin <addr> profile`; an SLO breach
        # arms its incident boost and incident files embed the profile.
        # LZ_PROF=0 = the thread is never started (no hot-path hooks).
        # PROCESS-wide shared instance: a profile is per-process, and
        # in-process test clusters host many daemons — N private
        # samplers would contend on one GIL for N copies of the same
        # stacks (measured ~7% on the ec(8,4) row at 13 daemons; the
        # shared sampler costs <0.5%)
        self.profiler = profmod.process_profiler(role=self.name)
        self.slo.profiler = self.profiler
        self.slo.recorder.profile_source = self.profiler.collapsed
        # challenge-response admin password (None = open admin port)
        self.admin_password: str | None = None
        self.add_timer(1.0, self._sample_metrics)
        # event-loop stall watchdog (loop_watchdog.h analog): a blocked
        # loop is THE latency failure mode of an asyncio daemon — the
        # reference aborts on a stuck poll loop; here a stall is logged
        # with its duration and charted so operators see it. A sampler
        # THREAD grabs the loop thread's stack while the stall is in
        # progress (the loop itself can only notice after the fact), so
        # the warning names a file:line instead of guessing.
        self.watchdog_warn_s = 0.25
        self._wd_last = 0.0
        self._wd_max_lag = 0.0  # worst lag since the last metrics sample
        self._wd_beat = 0.0  # written by the loop tick, read by sampler
        self._wd_loop_ident = 0
        self._wd_sampler_stop: object | None = None
        self._wd_sampler_thread: object | None = None
        self._wd_stall_stack: str | None = None  # set mid-stall by sampler
        self.add_timer(0.1, self._watchdog_tick)

    def _wd_sampler(self) -> None:
        """Watchdog sampler thread: when the loop misses its heartbeat,
        snapshot the loop thread's Python stack (the culprit is whatever
        frame the loop thread is stuck in). One capture per stall; a
        stack parked in select/epoll means GIL starvation by another
        thread rather than an on-loop blocking call."""
        import time as _time
        import traceback as _tb

        captured_for = -1.0
        while not self._wd_sampler_stop.wait(0.05):
            beat = self._wd_beat
            if not beat or beat == captured_for:
                continue
            if _time.monotonic() - beat > self.watchdog_warn_s + 0.1:
                frame = sys._current_frames().get(self._wd_loop_ident)
                # validate AFTER capturing: a beat that moved means the
                # stall ended mid-capture and the frame is an innocent
                # post-stall callback — blaming it would send the
                # operator to the wrong code (GIL-starved stalls end
                # exactly when this thread gets to run again)
                if frame is not None and self._wd_beat == beat:
                    self._wd_stall_stack = "".join(_tb.format_stack(frame))
                    captured_for = beat

    async def _watchdog_tick(self) -> None:
        import time as _time

        now = _time.monotonic()
        # refresh the heartbeat FIRST: the sampler must not attribute
        # this tick's own logging to the stall it is reporting
        last, self._wd_last = self._wd_last, now
        self._wd_beat = now
        if last:
            lag = max(now - last - 0.1, 0.0)
            if lag > self.watchdog_warn_s:
                stack, self._wd_stall_stack = self._wd_stall_stack, None
                self.log.warning(
                    "event loop stalled for %.0f ms%s", lag * 1000,
                    "; loop thread was at:\n" + stack if stack
                    else " (stack not captured)",
                )
                self.metrics.counter("loop_stalls").inc()
            # hold the WORST lag until the 1 Hz sampler reads it —
            # a transient stall must not be erased by the next tick
            self._wd_max_lag = max(self._wd_max_lag, lag)

    async def _sample_metrics(self) -> None:
        self.metrics.gauge("loop_lag_ms").set(self._wd_max_lag * 1000)
        self._wd_max_lag = 0.0
        # burn gauges must decay with the windows, not freeze at the
        # last observed value when traffic stops
        self.slo.refresh_gauges()
        self.metrics.sample_all()

    def handle_admin_basics(self, msg) -> object | None:
        """Shared admin commands every daemon answers (metrics, tweaks).
        Returns a reply message or None if the command is not handled."""
        import json

        from lizardfs_tpu_torch.proto import messages as m
        from lizardfs_tpu_torch.proto import status as st

        command = getattr(msg, "command", None)
        if command in ("metrics", "metrics-csv"):
            try:
                payload = json.loads(msg.json) if msg.json else {}
            except ValueError:
                payload = {}
            from lizardfs_tpu_torch.runtime.metrics import RESOLUTION_NAMES

            resolution = payload.get("resolution", "sec")
            if resolution not in RESOLUTION_NAMES:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL, json="{}"
                )
            doc = self.metrics.to_dict(resolution)
            if command == "metrics":
                return m.AdminReply(
                    req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
                )
            # charts.cc CSV export analog: one row per series, oldest
            # first; series younger than the window get EMPTY leading
            # cells (a fabricated 0 would read as a real zero sample)
            width = max(
                (len(s.get("points", ())) for s in doc.values()), default=0
            )
            rows = ["series," + ",".join(
                f"t-{i}" for i in range(width, 0, -1)
            )]
            for name, series in doc.items():
                if "points" not in series:
                    continue  # timing histograms export via JSON only
                points = series["points"]
                padded = [""] * (width - len(points)) + [
                    str(v) for v in points
                ]
                rows.append(name + "," + ",".join(padded))
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({"csv": "\n".join(rows) + "\n"}),
            )
        if command in ("metrics-derive", "metrics-define"):
            # charts.h calc-op analog: evaluate (or register) an RPN
            # expression over this daemon's series
            from lizardfs_tpu_torch.runtime.metrics import RESOLUTION_NAMES

            try:
                payload = json.loads(msg.json) if msg.json else {}
                expr = str(payload["expr"])
                resolution = payload.get("resolution", "sec")
                if resolution not in RESOLUTION_NAMES:
                    raise ValueError(resolution)
                if command == "metrics-define":
                    self.metrics.define(str(payload["name"]), expr)
                    doc = {"defined": str(payload["name"]), "expr": expr}
                else:
                    doc = {
                        "expr": expr, "resolution": resolution,
                        "points": self.metrics.eval_rpn(expr, resolution),
                    }
            except (ValueError, KeyError) as e:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json=json.dumps({"error": str(e)}),
                )
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        if command == "metrics-prom":
            # Prometheus text exposition, relayed as JSON over the admin
            # link (the webui /metrics endpoint unwraps "text" verbatim)
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({"text": self.metrics.to_prometheus()}),
            )
        if command == "trace-dump":
            try:
                payload = json.loads(msg.json) if msg.json else {}
            except ValueError:
                payload = {}
            try:
                trace_id = int(payload.get("trace_id", 0))
            except (TypeError, ValueError):
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL, json="{}"
                )
            spans = self.trace_spans(trace_id or None)
            if trace_id and not spans:
                # flight-recorder fallback: a breached op's spans were
                # captured into the incident ring at breach time, so
                # any id listed by `slowops` renders even after the
                # live span ring moved on
                spans = self.slo.recorder.incident_spans(trace_id) or []
            # the spans' perf_counter stamps and the epoch, read
            # together: a reader merging hosts moves them by it
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({
                    "spans": spans, "anchor": tracing.clock_anchor(),
                }),
            )
        if command == "profile":
            # collapsed-stack flamegraph dump of the always-on sampling
            # profiler (runtime/profiler.py); `lizardfs-admin <addr>
            # profile` prints the text ready for flamegraph.pl
            try:
                payload = json.loads(msg.json) if msg.json else {}
            except ValueError:
                payload = {}
            top = payload.get("top")
            doc = self.profiler.snapshot()
            # the sampler is process-wide; the dump names the surface
            # it was asked through (in-process clusters share one)
            doc["role"] = self.name
            doc["collapsed"] = self.profiler.collapsed(
                int(top) if top else None
            )
            if payload.get("reset"):
                self.profiler.reset()
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        if command == "top-sessions":
            # this daemon's own per-session accounting summary (the
            # master's `top` aggregates these cluster-wide)
            from lizardfs_tpu_torch.runtime import accounting

            ops = getattr(self, "session_ops", None)
            doc = {
                "role": self.name,
                "enabled": accounting.enabled(),
                "sessions": ops.top(16) if ops is not None else [],
            }
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK, json=json.dumps(doc)
            )
        if command == "slowops":
            # in-memory top-N slowest ops (flight recorder); each entry
            # names the trace id `trace-dump` renders
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({"slowops": self.slo.recorder.slowops()}),
            )
        if command == "health":
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(self.health_snapshot()),
            )
        if getattr(msg, "command", None) == "tweaks":
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(self.tweaks.to_dict()),
            )
        if command == "faults":
            # live fault-injection view: armed rules + fire counts +
            # the bounded event log (runtime/faults.py)
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(faultsmod.describe()),
            )
        if command == "faults-arm":
            # arm one rule (payload {"rule": "..."}) or replace the
            # whole set from a spec (payload {"spec": "...", "seed": N})
            try:
                payload = json.loads(msg.json) if msg.json else {}
                if "spec" in payload:
                    faultsmod.install(
                        str(payload["spec"]), seed=payload.get("seed")
                    )
                else:
                    faultsmod.arm(str(payload["rule"]))
            except (ValueError, KeyError, faultsmod.FaultSpecError) as e:
                return m.AdminReply(
                    req_id=msg.req_id, status=st.EINVAL,
                    json=json.dumps({"error": str(e)}),
                )
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(faultsmod.describe()),
            )
        if command == "faults-clear":
            faultsmod.clear()
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps(faultsmod.describe()),
            )
        if getattr(msg, "command", None) == "tweaks-set":
            try:
                payload = json.loads(msg.json)
                ok = self.tweaks.set(str(payload["name"]), str(payload["value"]))
            except (ValueError, KeyError):
                ok = False
            return m.AdminReply(
                req_id=msg.req_id,
                status=st.OK if ok else st.EINVAL,
                json=json.dumps(self.tweaks.to_dict()),
            )
        return None

    def trace_spans(self, trace_id: int | None = None) -> list[dict]:
        """Spans for `trace-dump` — subclasses that hold spans outside
        the ring (the chunkserver's native data plane) fold them in
        here before dumping."""
        return self.trace_ring.dump(trace_id)

    def health_snapshot(self) -> dict:
        """This daemon's health: SLO burn + stall/span-drop/disk
        signals (runtime/slo.py health_from). Subclasses extend via
        ``_health_extra``; the master aggregates the fleet's snapshots
        into the cluster `health` rollup."""
        snap = slomod.health_from(
            self.name, self.slo,
            loop_stalls=self.metrics.counter("loop_stalls").total,
            span_ring_dropped=self.trace_ring.dropped,
            disk_errors=self._health_disk_errors(),
            extra=self._health_extra(),
        )
        if faultsmod.ACTIVE:
            # incident output must NAME the injected fault: while rules
            # are armed, health carries them (with fire counts) so an
            # operator reading a degraded rollup sees the chaos drill,
            # not a mystery
            desc = faultsmod.describe()
            snap["faults"] = {
                "seed": desc["seed"],
                "rules": [
                    f"{r['rule']} (fired {r['fired']})"
                    for r in desc["rules"]
                ],
            }
        return snap

    def _health_disk_errors(self) -> int:
        return 0

    def _health_extra(self) -> dict:
        return {}

    # --- admin authentication (registered_admin_connection.cc analog) -------
    #
    # Challenge-response over the existing AdminCommand plumbing: the
    # client asks for a nonce ("auth-challenge") and answers with
    # HMAC-SHA256(password, nonce) ("auth"); the password itself never
    # crosses the wire. Privileged commands on a connection that has not
    # authenticated are refused when a password is configured.

    # commands that mutate daemon/cluster state; subclasses extend
    ADMIN_PRIVILEGED: frozenset[str] = frozenset(
        {"tweaks-set", "metrics-define", "faults-arm", "faults-clear"}
    )

    def handle_admin_auth(self, msg, state: dict) -> object | None:
        """Handle auth-challenge / auth commands; None if not one."""
        import hmac as hmac_mod
        import json
        import secrets

        from lizardfs_tpu_torch.proto import messages as m
        from lizardfs_tpu_torch.proto import status as st

        command = getattr(msg, "command", None)
        if command == "auth-challenge":
            nonce = secrets.token_hex(16)
            state["nonce"] = nonce
            return m.AdminReply(
                req_id=msg.req_id, status=st.OK,
                json=json.dumps({"nonce": nonce}),
            )
        if command == "auth":
            nonce = state.pop("nonce", "")
            password = getattr(self, "admin_password", None)
            try:
                payload = json.loads(msg.json)
                digest = str(payload.get("digest", "")) if isinstance(
                    payload, dict) else ""
            except ValueError:
                digest = ""
            if not password:
                # open daemon: auth trivially succeeds so ops scripts can
                # pass --password uniformly across secured/unsecured nodes
                state["authed"] = True
                return m.AdminReply(req_id=msg.req_id, status=st.OK, json="{}")
            if nonce:
                want = hmac_mod.new(
                    password.encode(), nonce.encode(), "sha256"
                ).hexdigest()
                if hmac_mod.compare_digest(want, digest):
                    state["authed"] = True
                    return m.AdminReply(
                        req_id=msg.req_id, status=st.OK, json="{}"
                    )
            return m.AdminReply(req_id=msg.req_id, status=st.EPERM, json="{}")
        return None

    def admin_refused(self, msg, state: dict) -> object | None:
        """EPERM reply if the command is privileged and the connection
        has not authenticated (and a password is configured)."""
        from lizardfs_tpu_torch.proto import messages as m
        from lizardfs_tpu_torch.proto import status as st

        command = getattr(msg, "command", None)
        if (
            getattr(self, "admin_password", None)
            and command in self.ADMIN_PRIVILEGED
            and not state.get("authed")
        ):
            return m.AdminReply(
                req_id=msg.req_id, status=st.EPERM,
                json='{"error": "admin authentication required"}',
            )
        return None

    def admin_gate(self, msg, state: dict) -> object | None:
        """Auth handshake + privilege gate in one step: returns the
        reply to send (challenge/auth result or EPERM refusal), or None
        when the command may proceed."""
        reply = self.handle_admin_auth(msg, state)
        if reply is None:
            reply = self.admin_refused(msg, state)
        return reply

    # --- lifecycle ---------------------------------------------------------

    async def setup(self) -> None:
        """Subclass hook: run before serving."""

    async def teardown(self) -> None:
        """Subclass hook: run on shutdown."""

    def reload(self) -> None:
        """Subclass hook: SIGHUP / admin reload-config."""

    async def handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        raise NotImplementedError

    def add_timer(self, interval: float, coro_fn) -> None:
        """Register a periodic coroutine (event_loop.h timer hook analog)."""
        self._timers.append((interval, coro_fn))

    def spawn(self, coro) -> asyncio.Task:
        """Track a background task; it is cancelled on shutdown."""
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def _run_timer(self, interval: float, coro_fn) -> None:
        while not self._stopping.is_set():
            try:
                await asyncio.wait_for(self._stopping.wait(), timeout=interval)
                return
            except asyncio.TimeoutError:
                pass
            try:
                await coro_fn()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.log.exception("timer %s failed", getattr(coro_fn, "__name__", "?"))

    async def _guarded_connection(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        self._conn_writers.add(writer)
        try:
            # fault-role scoping: everything this connection's handler
            # does (incl. to_thread disk work — context propagates) is
            # attributed to THIS daemon's role, so in-process multi-
            # daemon tests match (role, site, op, peer) rules correctly
            with faultsmod.role_scope(self.name):
                await self.handle_connection(reader, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # peer went away
        except asyncio.CancelledError:
            raise
        except Exception:
            self.log.exception("connection from %s crashed", peer)
        finally:
            self._conn_writers.discard(writer)
            await retrymod.close_writer(writer, swallow_cancel=True)

    async def start(self) -> None:
        # fault fires attributed to this role land in this registry
        # (faults_injected{site,action}, Prometheus-exported)
        faultsmod.attach_metrics(self.name, self.metrics)
        await self.setup()
        self._server = await asyncio.start_server(
            self._guarded_connection, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        for interval, coro_fn in self._timers:
            self.spawn(self._run_timer(interval, coro_fn))
        import threading

        self._wd_loop_ident = threading.get_ident()
        self._wd_sampler_stop = threading.Event()
        self._wd_sampler_thread = threading.Thread(
            target=self._wd_sampler, name=self.name + "-watchdog", daemon=True
        )
        self._wd_sampler_thread.start()
        # no-op under LZ_PROF=0 (the switch is the start gate)
        self.profiler.start()
        self.log.info("%s listening on %s:%d", self.name, self.host, self.port)

    async def stop(self) -> None:
        self._stopping.set()
        self.profiler.stop()
        if self._wd_sampler_stop is not None:
            self._wd_sampler_stop.set()
            self._wd_sampler_thread.join(timeout=1.0)
        if self._server is not None:
            self._server.close()
            # drop live connections: python 3.12's wait_closed() blocks
            # until every handler's transport is gone
            for w in list(self._conn_writers):
                w.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=5.0)
            except asyncio.TimeoutError:
                self.log.warning("server close timed out with handlers alive")
        for task in list(self._tasks):
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.teardown()

    async def run_forever(self) -> None:
        """Start, install signal handlers, run until SIGTERM/SIGINT."""
        # a real daemon process is single-role: make it the fault
        # framework's process default (in-process test clusters rely on
        # the per-connection role_scope instead)
        faultsmod.set_role(self.name)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        loop.add_signal_handler(signal.SIGHUP, self.reload)
        await self.start()
        # lint: waive(unbounded-await): run_forever parks until SIGTERM/SIGINT by design
        await stop.wait()
        self.log.info("shutting down")
        await self.stop()
