"""Wave-scheduled network execution of read plans.

The async analog of the reference's ReadPlanExecutor (reference:
src/common/read_plan_executor.cc): start wave 0's reads, fire the next
wave when a wave timeout expires or a read fails, finish as soon as the
plan says enough parts arrived, then post-process (recovery). Used by
the client read path and by the chunkserver replicator (both read chunk
parts from chunkservers).
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from lizardfs_tpu_torch.core.plans import SliceReadPlan
from lizardfs_tpu_torch.ops import crc32 as crc_mod
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import accounting
from lizardfs_tpu_torch.runtime import faults as _faults
from lizardfs_tpu_torch.runtime import tracing

log = logging.getLogger("read_executor")

DEFAULT_WAVE_TIMEOUT = 0.5
DEFAULT_TOTAL_TIMEOUT = 30.0


class ReadError(Exception):
    """``crc`` marks end-to-end checksum rejections (the part's bytes
    arrived but are corrupt) — the signal the client's damaged-part
    reporting keys off, distinct from a merely unreachable holder."""

    def __init__(self, msg: str, crc: bool = False):
        self.crc = crc
        super().__init__(msg)


async def read_part_range(
    addr: tuple[str, int],
    chunk_id: int,
    version: int,
    part_id: int,
    offset: int,
    size: int,
    into: np.ndarray | None = None,
    into_offset: int = 0,
) -> np.ndarray:
    """Read one range of one part from one chunkserver, verifying piece
    CRCs (ReadOperationExecutor analog). Connections come from the
    process-wide pool and are returned after a clean, fully-drained
    exchange (ConnectionPool analog). Every outcome feeds the shared
    per-chunkserver health scores (chunkserver_stats.cc analog)."""
    from lizardfs_tpu_torch.core.conn_pool import GLOBAL_POOL
    from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS

    out = into if into is not None else np.zeros(size, dtype=np.uint8)
    if size == 0:
        return out[into_offset:into_offset]

    # bulk reads run the whole exchange in C++ off the event loop
    # (framing + CRC + scatter with the GIL released)
    from lizardfs_tpu_torch.core import native_io

    if (
        native_io.available()
        and size >= native_io.NATIVE_READ_THRESHOLD
        # armed faults: the C++ exchange cannot be instrumented, so the
        # hookable asyncio path below serves (LZ_FAULTS unset: no change)
        and not _faults.ACTIVE
    ):
        # scatter straight into the caller's buffer whenever it is
        # contiguous: each op owns a disjoint region, and the cancel
        # path below aborts the socket and JOINS the executor thread, so
        # by the time execute_plan's finally finishes (it gathers every
        # cancelled task) no thread can still be writing the plan buffer
        # that post-processing reads. This removes a private-buffer
        # allocation + an on-loop memcpy per part (64 MiB per EC chunk).
        scatter_direct = (
            into is not None and out.flags.c_contiguous
            and out.dtype == np.uint8
        )
        if scatter_direct:
            tmp = out[into_offset : into_offset + size]  # view, no copy
        else:
            tmp = np.empty(size, dtype=np.uint8)
        # when scattering into the CALLER's buffer, the uninterruptible
        # executor thread must not outlive this coroutine: a cancelled
        # or failed attempt would otherwise keep writing `out` while a
        # retry refills the same region. The cell lets us shut the
        # socket down (killing the thread's recv) and join it.
        cell: dict = {}
        fut = asyncio.get_running_loop().run_in_executor(
            native_io.EXECUTOR,
            # partial_with_trace: carries the request trace id into the
            # worker thread (plain run_in_executor drops context)
            native_io.partial_with_trace(
                native_io.read_part_blocking,
                addr, chunk_id, version, part_id, offset, size, tmp,
                cell if scatter_direct else None,
            ),
        )
        # run_in_executor drops the phase-sink context too: the native
        # exchange is timed here and charged as read-phase net (parallel
        # part reads overlap, so net busy-time may exceed wall — the
        # PhaseBreakdown pipelining contract)
        t0 = tracing.phase_t0()
        try:
            await asyncio.shield(fut)
            tracing.charge_phase("net", t0)
            GLOBAL_STATS.record_success(addr)
            if not scatter_direct:
                out[into_offset : into_offset + size] = tmp
            return out
        except asyncio.CancelledError:
            if scatter_direct:
                native_io.abort_read(cell)
                try:
                    await asyncio.wait_for(asyncio.shield(fut), 10.0)
                except (Exception, asyncio.CancelledError):
                    pass
            raise
        except native_io.NativeIOError as e:
            GLOBAL_STATS.record_failure(addr)
            raise ReadError(str(e), crc="crc" in str(e).lower()) from None
        except (OSError, ConnectionError) as e:
            GLOBAL_STATS.record_failure(addr)
            raise ReadError(f"native read failed: {e}") from None

    conn = await GLOBAL_POOL.acquire(addr)
    clean = False
    cancelled = False
    # the whole framed exchange (request send + piece recv/CRC loop) is
    # read-phase net busy-time on the ambient logical read
    t0 = tracing.phase_t0()
    try:
        await framing.send_message(
            conn.writer,
            m.CltocsRead(
                req_id=1,
                chunk_id=chunk_id,
                version=version,
                part_id=part_id,
                offset=offset,
                size=size,
                trace_id=tracing.current_trace_id(),
                # per-session attribution on the chunkserver: the
                # process-wide session identity (accounting.py), the
                # module-function analog of the thread-local trace id
                session_id=accounting.wire_session(),
            ),
        )
        received = 0
        while True:
            msg = await framing.read_message(conn.reader)
            if isinstance(msg, m.CstoclReadData):
                data = np.frombuffer(msg.data, dtype=np.uint8)
                if crc_mod.crc32(msg.data) != msg.crc:
                    raise ReadError(
                        "piece CRC mismatch from chunkserver", crc=True
                    )
                rel = msg.offset - offset
                if rel < 0 or rel + len(data) > size:
                    raise ReadError("piece outside requested range")
                out[into_offset + rel : into_offset + rel + len(data)] = data
                received += len(data)
            elif isinstance(msg, m.CstoclReadStatus):
                clean = True  # stream fully drained, even on error status
                if msg.status != st.OK:
                    GLOBAL_STATS.record_failure(addr)
                    raise ReadError(
                        f"read failed: {st.name(msg.status)}",
                        crc=msg.status == st.CRC_ERROR,
                    )
                if received < size:
                    GLOBAL_STATS.record_failure(addr)
                    raise ReadError(
                        f"short read: {received} of {size} bytes"
                    )
                GLOBAL_STATS.record_success(addr)
                tracing.charge_phase("net", t0)
                return out
            else:
                raise ReadError(f"unexpected message {type(msg).__name__}")
    except asyncio.CancelledError:
        cancelled = True
        raise
    finally:
        if clean:
            GLOBAL_POOL.release(addr, conn)
        else:
            # a CANCELLED read (wave straggler made redundant, plan
            # aborted by a different part's failure) is not this
            # server's defect — only real failures count
            if not cancelled:
                GLOBAL_STATS.record_failure(addr)
            GLOBAL_POOL.discard(conn)


async def execute_plan(
    plan: SliceReadPlan,
    chunk_id: int,
    version: int,
    locations: dict[int, tuple[tuple[str, int], int]],
    wave_timeout: float = DEFAULT_WAVE_TIMEOUT,
    total_timeout: float = DEFAULT_TOTAL_TIMEOUT,
    buffer: np.ndarray | None = None,
    on_part_failure=None,
) -> np.ndarray:
    """Execute a plan; returns the post-processed result bytes.

    locations: slice part index -> ((host, port), wire part_id).
    ``buffer`` (optional, C-contiguous uint8 of plan.buffer_size) lets
    the caller provide the scatter target so successful single-op plans
    write the result in place.
    ``on_part_failure`` (optional ``fn(part, wire_part_id, addr, exc)``)
    observes every per-part failure as it happens — the client threads
    its damaged-part reporter through here so a CRC-rejected part is
    reported to the master even when the read itself recovers.
    """
    if buffer is None:
        buffer = np.zeros(plan.buffer_size, dtype=np.uint8)
    else:
        assert buffer.size == plan.buffer_size and buffer.dtype == np.uint8
    available: list[int] = []
    unreadable: list[int] = []
    pending: dict[asyncio.Task, int] = {}
    max_wave = max((op.wave for op in plan.read_operations), default=0)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + total_timeout
    current_wave = -1

    def start_wave(w: int):
        for op in plan.read_operations:
            if op.wave != w:
                continue
            if op.part not in locations:
                unreadable.append(op.part)
                continue
            addr, wire_part_id = locations[op.part]
            task = asyncio.ensure_future(
                read_part_range(
                    addr,
                    chunk_id,
                    version,
                    wire_part_id,
                    op.request_offset,
                    op.request_size,
                    into=buffer,
                    into_offset=op.buffer_offset,
                )
            )
            pending[task] = op.part

    current_wave = 0
    start_wave(0)
    wave_start = loop.time()
    try:
        while not plan.is_reading_finished(available):
            if not pending:
                # everything in flight resolved; fire the next wave now
                if current_wave >= max_wave:
                    raise ReadError(
                        f"no more parts to try (available={available}, "
                        f"unreadable={unreadable})"
                    )
                current_wave += 1
                start_wave(current_wave)
                wave_start = loop.time()
                continue
            now = loop.time()
            if now >= deadline:
                raise ReadError("read plan timed out")
            if current_wave < max_wave:
                timeout = min(wave_start + wave_timeout - now, deadline - now)
            else:
                timeout = deadline - now
            done, _ = await asyncio.wait(
                pending.keys(),
                timeout=max(timeout, 0.001),
                return_when=asyncio.FIRST_COMPLETED,
            )
            for task in done:
                part = pending.pop(task)
                exc = task.exception()
                if exc is None:
                    available.append(part)
                else:
                    log.debug("part %d failed: %s", part, exc)
                    if on_part_failure is not None and part in locations:
                        addr, wire_part_id = locations[part]
                        try:
                            on_part_failure(part, wire_part_id, addr, exc)
                        except Exception:  # noqa: BLE001
                            log.debug("part-failure observer failed",
                                      exc_info=True)
                    unreadable.append(part)
                    if not plan.is_finishing_possible(unreadable):
                        raise ReadError(f"too many failed parts: {unreadable}")
            # wave timeout: stragglers trigger the next wave (reference
            # startReadsForWave, read_plan_executor.cc:162-176)
            if (
                current_wave < max_wave
                and loop.time() - wave_start >= wave_timeout
            ):
                current_wave += 1
                start_wave(current_wave)
                wave_start = loop.time()
    finally:
        for task in pending:
            task.cancel()
        if pending:
            await asyncio.gather(*pending.keys(), return_exceptions=True)

    # postprocess is the decode leg: parity recovery / block CRC checks
    # for striped plans (a plain pass-through for healthy std reads)
    t0 = tracing.phase_t0()
    result = plan.postprocess(buffer, available)
    tracing.charge_phase("decode", t0)
    return result
