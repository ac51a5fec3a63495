"""The port's own read-path timing, where it departs from the JAX
package's source: the off-loop hop (``core/native_io.py`` ``Hop``, which
took the place of ``partial_with_trace``) at the read path's three hops,
the read phases' parts (``runtime/tracing.py`` ``READ_SUBPHASES``), spans
stamped on ``time.perf_counter`` in every role with a clock anchor in each
``trace-dump`` reply, span ids from a seeded generator, and the dominant
read phase ranked over the top-level phases only.

``DEPARTS[rel]`` lists (old, new) blocks: the copy of ``rel`` is the
renamed original with each old block, found exactly once, replaced by its
new one (``tests/test_torch_master.py`` ``renamed``). Each block is whole
lines.
"""

DEPARTS = {
    "chunkserver/server.py": [
        ("""            self.log.debug("native trace drain failed", exc_info=True)
            return
""",
         """            self.log.debug("native trace drain failed", exc_info=True)
            return
        # the C side stamps CLOCK_REALTIME; spans run on perf_counter
        shift = time.perf_counter() - time.time()
"""),
        ("""                op["trace_id"], op["name"], op["t0"], op["t1"],
""",
         """                op["trace_id"], op["name"], op["t0"] + shift,
                op["t1"] + shift,
"""),
        ("""        t0 = time.perf_counter()
        tw0 = time.time()
""",
         """        t0 = time.perf_counter()
"""),
        ("""            tid, "cs_replicate", tw0, time.time(), role="chunkserver",
""",
         """            tid, "cs_replicate", t0, time.perf_counter(), role="chunkserver",
"""),
        ("""                    # in-flight pipelined writes still owe status frames
                    t0 = time.perf_counter()
                    tw0 = time.time()
""",
         """                    # in-flight pipelined writes still owe status frames
                    t0 = time.perf_counter()
"""),
        ("""                    )
                    dt = time.perf_counter() - t0
""",
         """                    )
                    t1 = time.perf_counter()
                    dt = t1 - t0
"""),
        ("""                        msg.trace_id, "cs_read", tw0, time.time(),
""",
         """                        msg.trace_id, "cs_read", t0, t1,
"""),
        ("""                elif isinstance(msg, m.CltocsReadBulk):
                    t0 = time.perf_counter()
                    tw0 = time.time()
""",
         """                elif isinstance(msg, m.CltocsReadBulk):
                    t0 = time.perf_counter()
"""),
        ("""                    await self._serve_read_bulk(writer, msg)
                    dt = time.perf_counter() - t0
""",
         """                    await self._serve_read_bulk(writer, msg)
                    t1 = time.perf_counter()
                    dt = t1 - t0
"""),
        ("""                        msg.trace_id, "cs_read_bulk", tw0, time.time(),
""",
         """                        msg.trace_id, "cs_read_bulk", t0, t1,
"""),
        ("""        ):
            await ack(st.EINVAL)
            return
        tw0 = time.time()
""",
         """        ):
            await ack(st.EINVAL)
            return
"""),
        ("""                 "(asyncio data plane)",
        ).inc()
""",
         """                 "(asyncio data plane)",
        ).inc()
        t1 = time.perf_counter()
"""),
        ("""            session.trace_id, "cs_write_shm", tw0, time.time(),
""",
         """            session.trace_id, "cs_write_shm", t0, t1,
"""),
        ("""            role="chunkserver", bytes=msg.length,
        )
        dt = time.perf_counter() - t0
""",
         """            role="chunkserver", bytes=msg.length,
        )
        dt = t1 - t0
"""),
        ("""        tw0 = time.time()
        t0 = time.perf_counter()  # monotonic twin of tw0 for the SLO
""",
         """        t0 = time.perf_counter()
"""),
        ("""                code = down_ok
            session.down_event.pop(msg.write_id, None)
            session.down_status.pop(msg.write_id, None)
""",
         """                code = down_ok
            session.down_event.pop(msg.write_id, None)
            session.down_status.pop(msg.write_id, None)
        t1 = time.perf_counter()
"""),
        ("""            session.trace_id, "cs_write_bulk", tw0, time.time(),
""",
         """            session.trace_id, "cs_write_bulk", t0, t1,
"""),
        ("""            role="chunkserver", bytes=len(msg.data),
        )
        dt = time.perf_counter() - t0
""",
         """            role="chunkserver", bytes=len(msg.data),
        )
        dt = t1 - t0
"""),
    ],
    "client/client.py": [
        ("""        # EC recovery), gather (stripe de-interleave). Deep layers that
        # can't see the client (conn pool, read executor) charge via
        # tracing.PHASE_SINK, activated around each logical read.
""",
         """        # EC recovery), gather (stripe de-interleave), and the parts
        # of these that tracing.READ_SUBPHASES names. Deep layers that
        # can't see the client (conn pool, read executor, encoder seam)
        # charge via tracing.PHASE_SINK, activated around each logical
        # read.
"""),
        ("""            "client_read",
            ("locate", "dial", "wait", "net", "decode", "gather"),
""",
         """            "client_read", tracing.READ_PHASES + tracing.READ_SUBPHASES,
"""),
        ("""        own they would be an anonymous hole in every merged timeline.\"\"\"
        tw0 = _time.time()
""",
         """        own they would be an anonymous hole in every merged timeline.\"\"\"
        t0 = _time.perf_counter()
"""),
        ("""                tracing.current_trace_id(), "throttle", tw0, _time.time(),
                role="client",
""",
         """                tracing.current_trace_id(), "throttle", t0,
                _time.perf_counter(), role="client",
"""),
        ("""    def _t0(self) -> tuple[float, float]:
        \"\"\"(perf_counter, wall) pair opening a phase: the first feeds
        the PhaseBreakdown, the second anchors the span's timeline.\"\"\"
        return (_time.perf_counter(), _time.time())
""",
         """    def _t0(self) -> float:
        \"\"\"``perf_counter`` stamp opening a phase: it feeds the
        PhaseBreakdown and anchors the span's timeline.\"\"\"
        return _time.perf_counter()
"""),
        ("""    def _phase(self, name: str, t0: tuple[float, float]) -> None:
""",
         """    def _phase(self, name: str, t0: float) -> None:
"""),
        ("""        self.write_phases.add(name, _time.perf_counter() - t0[0])
""",
         """        t1 = _time.perf_counter()
        self.write_phases.add(name, t1 - t0)
"""),
        ("""            tracing.current_trace_id(), name, t0[1], _time.time(),
            role="client",
""",
         """            tracing.current_trace_id(), name, t0, t1, role="client",
"""),
        ("""    def _read_phase(self, name: str, t0: tuple[float, float]) -> None:
""",
         """    def _read_phase(self, name: str, t0: float) -> None:
"""),
        ("""        self.read_phases.add(name, _time.perf_counter() - t0[0])
        self.trace_ring.record(
            tracing.current_trace_id(), f"read:{name}", t0[1], _time.time(),
            role="client",
        )
""",
         """        self._read_sink(name, t0, _time.perf_counter())
"""),
        ("""    def _read_sink(self, phase: str, t0, t1) -> None:
""",
         """    def _read_sink(self, phase: str, t0: float, t1: float) -> None:
"""),
        ("""        pool dials, read-executor socket waits and plan postprocess)
        charge the ambient logical read's phases here. Pool-miss dials
        double as the ``dial`` queue-wait gate.\"\"\"
        self.read_phases.add(phase, max(t1[0] - t0[0], 0.0))
""",
         """        pool dials, read-executor socket waits and plan postprocess,
        off-loop hops, the encoder seam) charge the ambient logical
        read's phases here. Pool-miss dials double as the ``dial``
        queue-wait gate.\"\"\"
        self.read_phases.add(phase, max(t1 - t0, 0.0))
"""),
        ("""                tid, f"read:{phase}", t0[1], t1[1], role="client"
""",
         """                tid, f"read:{phase}", t0, t1, role="client"
"""),
        ("""        # op in this task gets its own id
        tid, fresh_trace = tracing.begin()
        tw0 = _time.time()
""",
         """        # op in this task gets its own id
        tid, fresh_trace = tracing.begin()
"""),
        ("""                tid, "getattr", tw0, _time.time(), role="client"
""",
         """                tid, "getattr", wall_t0, _time.perf_counter(), role="client"
"""),
        ("""                await self.truncate(inode, total)
            self.write_phases.add_wall(_time.perf_counter() - wall_t0)
""",
         """                await self.truncate(inode, total)
            wall_t1 = _time.perf_counter()
            self.write_phases.add_wall(wall_t1 - wall_t0)
"""),
        ("""                tid, "write_file", tw0, _time.time(), role="client",
""",
         """                tid, "write_file", wall_t0, wall_t1, role="client",
"""),
        ("""                self.session_id, "write",
                _time.perf_counter() - wall_t0, nbytes=total, trace_id=tid,
""",
         """                self.session_id, "write", wall_t1 - wall_t0, nbytes=total,
                trace_id=tid,
"""),
        ("""        wall_t0 = _time.perf_counter()
        tid, fresh_trace = tracing.begin()
        tw0 = _time.time()
""",
         """        wall_t0 = _time.perf_counter()
        tid, fresh_trace = tracing.begin()
"""),
        ("""            # pwrite-heavy workloads too
            self.write_phases.add_wall(_time.perf_counter() - wall_t0)
""",
         """            # pwrite-heavy workloads too
            wall_t1 = _time.perf_counter()
            self.write_phases.add_wall(wall_t1 - wall_t0)
"""),
        ("""                tid, "pwrite", tw0, _time.time(), role="client",
""",
         """                tid, "pwrite", wall_t0, wall_t1, role="client",
"""),
        ("""                self.session_id, "write",
                _time.perf_counter() - wall_t0, nbytes=len(data),
                trace_id=tid,
""",
         """                self.session_id, "write", wall_t1 - wall_t0,
                nbytes=len(data), trace_id=tid,
"""),
        ("""                enc_dt = _time.perf_counter() - t0[0]
""",
         """                enc_dt = _time.perf_counter() - t0
"""),
        ("""                    send_dt = _time.perf_counter() - t0[0]
""",
         """                    send_dt = _time.perf_counter() - t0
"""),
        ("""            send_dt += _time.perf_counter() - t0[0]
""",
         """            send_dt += _time.perf_counter() - t0
"""),
        ("""        t0 = _time.perf_counter()
        tw0 = _time.time()
""",
         """        t0 = _time.perf_counter()
"""),
        ("""        dt = _time.perf_counter() - t0
""",
         """        t1 = _time.perf_counter()
        dt = t1 - t0
"""),
        ("""            tid, "read_file", tw0, _time.time(), role="client",
            bytes=len(data),
""",
         """            tid, "read_file", t0, t1, role="client", bytes=len(data),
"""),
        ("""        C-contiguous uint8.\"\"\"
        tid, fresh_trace = tracing.begin()
        tw0 = _time.time()
""",
         """        C-contiguous uint8.\"\"\"
        tid, fresh_trace = tracing.begin()
"""),
        ("""                await self._read_into(inode, offset, out[:n], length)
""",
         """                await self._read_into(inode, offset, out[:n], length)
            tp1 = _time.perf_counter()
"""),
        ("""                tid, "read_file", tw0, _time.time(), role="client", bytes=n
""",
         """                tid, "read_file", tp0, tp1, role="client", bytes=n
"""),
        ("""            self.read_phases.add_wall(_time.perf_counter() - tp0)
""",
         """            self.read_phases.add_wall(tp1 - tp0)
"""),
        ("""                self.session_id, "read", _time.time() - tw0, nbytes=n,
                trace_id=tid,
""",
         """                self.session_id, "read", tp1 - tp0, nbytes=n, trace_id=tid,
"""),
        ("""            fut = asyncio.get_running_loop().run_in_executor(
                native_io.EXECUTOR,
                # partial_with_trace: run_in_executor drops context, so
                # the request trace id rides the partial instead
                native_io.partial_with_trace(
                    native_io.read_parts_gather_blocking,
                    [by_part[p][0] for p in wanted],
                    loc.chunk_id, loc.version,
                    [by_part[p][1] for p in wanted],
                    lo_slot * MFSBLOCKSIZE, region_blocks,
                    into[into_offset : into_offset + size],
                    cell,
                ),
""",
         """            # the hop carries the request trace id into the thread
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
"""),
        ("""            # run_in_executor does not propagate the phase-sink context;
            # the whole native gather (sockets + C de-interleave) is
            # timed at the await and charged as net — the chunkserver's
            # queue/disk/net attrs refine it in the attribution view
            t0 = self._t0()
""",
         """            fut = hop.future
"""),
        ("""                self._read_phase("net", t0)
""",
         """                hop.charge("net")
"""),
        ("""            t0 = self._t0()
            await asyncio.to_thread(
                striping.assemble_chunk, data_parts, slice_type, size,
                into[into_offset : into_offset + size],
""",
         """            await native_io.run_hop(
                "gather", None, striping.assemble_chunk, data_parts,
                slice_type, size, into[into_offset : into_offset + size],
"""),
        ("""            self._read_phase("gather", t0)
""",
         """"""),
        ("""        t0 = self._t0()
        region = await asyncio.to_thread(
            striping.assemble_chunk, data_parts, slice_type,
""",
         """        region = await native_io.run_hop(
            "gather", None, striping.assemble_chunk, data_parts, slice_type,
"""),
        ("""        )
        self._read_phase("gather", t0)
""",
         """        )
"""),
    ],
    "core/native_io.py": [
        ("""import struct
import threading
""",
         """import struct
import threading
import time
"""),
        ("""from lizardfs_tpu_torch.runtime import accounting
""",
         """from lizardfs_tpu_torch.runtime import accounting, tracing
"""),
        ("""async def run(fn, *args):
    \"\"\"Run a blocking native-IO function on the dedicated executor.
""",
         """class Hop:
    \"\"\"One off-loop hop of a request: ``fn(*args)`` submitted at once to
    ``executor`` (None: the loop's default) with the caller's trace id
    AND wire session carried into the thread, captured HERE, in the
    calling task, because neither contextvars nor the task's session
    scope reach an executor thread. Four ``perf_counter`` stamps time
    it: ``submitted`` on the loop, ``started`` and ``returned`` in the
    thread, and the resume, which :meth:`charge` takes on the loop when
    the awaiting coroutine runs again. Sites that need the raw future
    (shield/abort-cell patterns) await ``future`` themselves and call
    :meth:`charge` once it succeeded.\"\"\"
"""),
        ("""    The caller's request trace id (runtime/tracing.py contextvar) is
    captured HERE — run_in_executor does not carry context into the
    worker thread — and installed as the C side's thread-local
    (lz_trace_set) for the duration of the call, so the native request
    builders tag their frames with the trace of the request they serve.\"\"\"
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(EXECUTOR, partial_with_trace(fn, *args))
""",
         """    __slots__ = ("future", "submitted", "started", "returned")

    def __init__(self, executor, fn, *args):
        trace_id = tracing.current_trace_id()
        session = accounting.wire_session() if trace_id else 0
        self.started = self.returned = 0.0
        self.submitted = time.perf_counter()
        self.future = asyncio.get_running_loop().run_in_executor(
            executor,
            functools.partial(self._call, trace_id, session, fn, *args),
        )

    def _call(self, trace_id, session, fn, *args):
        self.started = time.perf_counter()
        try:
            if trace_id:
                return _traced_call(trace_id, session, fn, *args)
            return fn(*args)
        finally:
            self.returned = time.perf_counter()

    def charge(self, phase: str) -> None:
        \"\"\"Charge the finished hop to ``phase`` of the ambient read
        (runtime/tracing.py :func:`charge_hop`).\"\"\"
        tracing.charge_hop(phase, self.submitted, self.started, self.returned)
"""),
        ("""def partial_with_trace(fn, *args):
    \"\"\"``functools.partial`` carrying the caller's trace id AND wire
    session into the executor thread — for call sites that need raw
    run_in_executor (shield/abort-cell patterns) instead of
    :func:`run`. Both are captured HERE, in the calling task, because
    neither contextvars nor the task's session scope reach an executor
    thread.\"\"\"
    from lizardfs_tpu_torch.runtime import tracing
""",
         """async def run(fn, *args):
    \"\"\"Run a blocking native-IO function on the dedicated executor, with
    the caller's request trace id installed as the C side's
    thread-local (lz_trace_set) for the duration of the call, so the
    native request builders tag their frames with the trace of the
    request they serve.\"\"\"
    return await Hop(EXECUTOR, fn, *args).future
"""),
        ("""    trace_id = tracing.current_trace_id()
    if trace_id:
        return functools.partial(
            _traced_call, trace_id, accounting.wire_session(), fn, *args
        )
    return functools.partial(fn, *args)
""",
         """
async def run_hop(phase: str, executor, fn, *args):
    \"\"\"``fn(*args)`` as a :class:`Hop` on ``executor``, charged to the
    ambient read's ``phase`` when it returns.\"\"\"
    hop = Hop(executor, fn, *args)
    out = await hop.future
    hop.charge(phase)
    return out
"""),
    ],
    "core/read_executor.py": [
        ("""        fut = asyncio.get_running_loop().run_in_executor(
            native_io.EXECUTOR,
            # partial_with_trace: carries the request trace id into the
            # worker thread (plain run_in_executor drops context)
            native_io.partial_with_trace(
                native_io.read_part_blocking,
                addr, chunk_id, version, part_id, offset, size, tmp,
                cell if scatter_direct else None,
            ),
""",
         """        # the hop carries the request trace id into the worker thread
        # (plain run_in_executor drops context, the phase sink's too):
        # the native exchange is charged here as read-phase net and its
        # queue/run/resume parts (parallel part reads overlap, so net
        # busy-time may exceed wall — the PhaseBreakdown pipelining
        # contract)
        hop = native_io.Hop(
            native_io.EXECUTOR, native_io.read_part_blocking,
            addr, chunk_id, version, part_id, offset, size, tmp,
            cell if scatter_direct else None,
"""),
        ("""        # run_in_executor drops the phase-sink context too: the native
        # exchange is timed here and charged as read-phase net (parallel
        # part reads overlap, so net busy-time may exceed wall — the
        # PhaseBreakdown pipelining contract)
        t0 = tracing.phase_t0()
""",
         """        fut = hop.future
"""),
        ("""            await asyncio.shield(fut)
            tracing.charge_phase("net", t0)
""",
         """            await asyncio.shield(fut)
            hop.charge("net")
"""),
    ],
    "master/server.py": [
        ("""                tw0 = time.time()
""",
         """"""),
        ("""                # request_log.h analog: per-op-type latency histograms
                dt = time.perf_counter() - t0
""",
         """                # request_log.h analog: per-op-type latency histograms
                t1 = time.perf_counter()
                dt = t1 - t0
"""),
        ("""                    tid, type(msg).__name__, tw0, time.time(), role="master",
""",
         """                    tid, type(msg).__name__, t0, t1, role="master",
"""),
        ("""        t0 = time.perf_counter()
        tw0 = time.time()
""",
         """        t0 = time.perf_counter()
"""),
        ("""                # engine folds the outcome into progress/ETA
                dt = time.perf_counter() - t0
""",
         """                # engine folds the outcome into progress/ETA
                t1 = time.perf_counter()
                dt = t1 - t0
"""),
        ("""                    rb.trace_id, "rebuild", tw0, time.time(),
""",
         """                    rb.trace_id, "rebuild", t0, t1,
"""),
    ],
    "nfs/server.py": [
        ("""        tw0 = time.time()
""",
         """"""),
        ("""            dt = time.perf_counter() - t0
            self.client.trace_ring.record(
                tid, name, tw0, time.time(), role="nfs"
            )
""",
         """            t1 = time.perf_counter()
            dt = t1 - t0
            self.client.trace_ring.record(tid, name, t0, t1, role="nfs")
"""),
    ],
    "runtime/daemon.py": [
        ("""                spans = self.slo.recorder.incident_spans(trace_id) or []
""",
         """                spans = self.slo.recorder.incident_spans(trace_id) or []
            # the spans' perf_counter stamps and the epoch, read
            # together: a reader merging hosts moves them by it
"""),
        ("""                json=json.dumps({"spans": spans}),
""",
         """                json=json.dumps({
                    "spans": spans, "anchor": tracing.clock_anchor(),
                }),
"""),
    ],
    "runtime/tracing.py": [
        ("""Clocks: spans carry CLOCK_REALTIME epoch seconds (C side: microseconds
via clock_gettime) so same-host cross-process merges line up; durations
inside one process stay monotonic-accurate at the span granularity
(tens of microseconds and up) this subsystem targets.
""",
         """Clocks: spans carry ``time.perf_counter`` seconds, CLOCK_MONOTONIC on
Linux, which every process on one host shares, so same-host
cross-process merges line up, and the card's profiler events that a
benchmark maps onto ``perf_counter`` line up with them too. The native
plane's CLOCK_REALTIME microsecond stamps are moved onto it when the
chunkserver drains them. Every ``trace-dump`` reply carries one
:func:`clock_anchor` pair, with which :func:`to_epoch` turns its spans
into epoch seconds (merges across hosts).
"""),
        ("""import secrets
""",
         """import os
import random
"""),
        ("""    _ENABLED = bool(on)


""",
         """    _ENABLED = bool(on)


# ids need to be unique, not secret: one generator per process, seeded
# once (a child after fork seeds its own), not a syscall per span
_RNG = random.Random()


def _seed_ids() -> None:
    _RNG.seed(os.urandom(16))


_seed_ids()
os.register_at_fork(after_in_child=_seed_ids)


"""),
        ("""    return secrets.randbits(63) | 1
""",
         """    return _RNG.getrandbits(63) | 1
"""),
        ("""

def ensure_trace() -> int:
    \"\"\"Current trace id, starting a fresh trace if none is active.\"\"\"
    tid = current_trace_id()
    return tid if tid else start_trace()
""",
         """"""),
        ("""        self.t0 = time.time()
""",
         """        self.t0 = time.perf_counter()
"""),
        ("""            self.trace_id, self.name, self.t0, time.time(), role=self.role
""",
         """            self.trace_id, self.name, self.t0, time.perf_counter(),
            role=self.role,
"""),
        ("""        return False
""",
         """        return False


def clock_anchor() -> list[float]:
    \"\"\"One ``[perf_counter, epoch]`` pair, taken now: what a span dump
    carries so a reader can place its stamps on the epoch clock.\"\"\"
    return [time.perf_counter(), time.time()]


def to_epoch(spans: list[dict], anchor: list[float]) -> list[dict]:
    \"\"\"Copies of ``spans`` with their stamps moved from ``perf_counter``
    onto epoch seconds by a :func:`clock_anchor` pair of the same
    process (a dump's).\"\"\"
    shift = anchor[1] - anchor[0]
    return [{**s, "t0": s["t0"] + shift, "t1": s["t1"] + shift}
            for s in spans]
"""),
        ("""# postprocess — charge busy-time into whatever sink is ambient. A
# contextvar (not a global) keeps concurrent clients in one process
# (in-process test clusters, gateways) from cross-charging; asyncio
# tasks and to_thread propagate it, run_in_executor does not (native
# executor hops are therefore timed at the await site instead).
""",
         """# postprocess, the encoder seam — charge busy-time into whatever sink is
# ambient. A contextvar (not a global) keeps concurrent clients in one
# process (in-process test clusters, gateways) from cross-charging;
# asyncio tasks and to_thread propagate it, run_in_executor does not
# (native executor hops are therefore charged at the await site, by
# :func:`charge_hop`).
"""),
        ("""
def phase_t0() -> tuple[float, float]:
    \"\"\"(perf_counter, wall) anchor for :func:`charge_phase` — durations
    stay monotonic-accurate while span endpoints stay epoch-aligned.\"\"\"
    return (time.perf_counter(), time.time())
""",
         """# the phases of a logical read; each sums into the client's read
# PhaseBreakdown. An off-loop hop's phase (net, gather) is split in
# three parts that partition it: ``_queue`` (submitted until an executor
# thread starts it), ``_run`` (the function in its thread) and
# ``_resume`` (returned until the awaiting coroutine runs again). The
# seam's ``seam_stage`` (survivor rows into pinned memory, H2D enqueued)
# and ``seam_sync`` (the host blocked until the card's results are
# back) fall inside ``decode``. Only the top-level phases rank as a
# read's dominant one.
READ_PHASES = ("locate", "dial", "wait", "net", "decode", "gather")
HOP_PARTS = ("queue", "run", "resume")
READ_SUBPHASES = tuple(
    f"{hop}_{part}" for hop in ("net", "gather") for part in HOP_PARTS
) + ("seam_stage", "seam_sync")
"""),
        ("""def charge_phase(phase: str, t0: tuple[float, float]) -> None:
""",
         """def phase_t0() -> float:
    \"\"\"``perf_counter`` stamp opening a :func:`charge_phase` interval.\"\"\"
    return time.perf_counter()


def charge_phase(phase: str, t0: float) -> None:
"""),
        ("""        sink(phase, t0, (time.perf_counter(), time.time()))
""",
         """        sink(phase, t0, time.perf_counter())


def charge_hop(
    phase: str, submitted: float, started: float, returned: float,
) -> None:
    \"\"\"Charge one finished off-loop hop, on the loop as its awaiting
    coroutine resumes: [submitted, now] to ``phase``, and its three
    parts (executor queue, run in the thread, wait for the loop) to
    ``<phase>_queue``, ``<phase>_run`` and ``<phase>_resume``.\"\"\"
    sink = PHASE_SINK.get()
    if sink is not None:
        resumed = time.perf_counter()
        sink(phase, submitted, resumed)
        sink(f"{phase}_queue", submitted, started)
        sink(f"{phase}_run", started, returned)
        sink(f"{phase}_resume", returned, resumed)
"""),
        ("""    metrics, ring, gate: str, tenant: str, t0: tuple[float, float],
""",
         """    metrics, ring, gate: str, tenant: str, t0: float,
"""),
        ("""    seconds = max(time.perf_counter() - t0[0], 0.0)
""",
         """    seconds = max(time.perf_counter() - t0, 0.0)
"""),
        ("""            tid, f"queue_wait:{gate}", t0[1], t0[1] + seconds,
""",
         """            tid, f"queue_wait:{gate}", t0, t0 + seconds,
"""),
        ("""_BUCKET_RULES = (
""",
         """_BUCKET_RULES = (
    # the parts of an off-loop hop and of the seam, before the generic
    # "read"/"net"/"gather" rules below would take them whole
    ("_queue", "queue"),
    ("_resume", "queue"),
    ("net_run", "net"),
    ("gather_run", "compute"),
    ("seam_stage", "compute"),
    ("seam_sync", "compute"),
"""),
    ],
    "s3/server.py": [
        ("""        tw0 = time.time()
""",
         """"""),
        ("""            dt = time.perf_counter() - t0
""",
         """            t1 = time.perf_counter()
            dt = t1 - t0
"""),
        ("""                tid, f"s3_{opname}", tw0, time.time(), role="s3"
""",
         """                tid, f"s3_{opname}", t0, t1, role="s3"
"""),
    ],
    "tools/admin_cli.py": [
        ("""from lizardfs_tpu_torch.proto import status as st
""",
         """from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime.tracing import READ_PHASES
"""),
        ("""        if phases and phases.get("reps"):
""",
         """        if phases and phases.get("reps"):
            # the top-level phases only: a part of one never dominates
"""),
        ("""                k[:-3]: v for k, v in phases.items()
                if k.endswith("_ms") and k != "wall_ms"
""",
         """                p: phases[f"{p}_ms"] for p in READ_PHASES
                if f"{p}_ms" in phases
"""),
    ],
    "tools/webui.py": [
        ("""from lizardfs_tpu_torch.proto import messages as m
""",
         """from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.runtime.tracing import READ_PHASES
"""),
        ("""            if phases.get("reps"):
""",
         """            if phases.get("reps"):
                # the top-level phases only: a part of one never dominates
"""),
        ("""                    k[:-3]: v for k, v in phases.items()
                    if k.endswith("_ms") and k != "wall_ms"
""",
         """                    p: phases[f"{p}_ms"] for p in READ_PHASES
                    if f"{p}_ms" in phases
"""),
    ],
}
