"""The stripe fan-in: a striped read in one off-loop hop.

On the wave executor (``core/read_executor.py``) a striped read costs
the event loop one task and one resume for each wave-0 part, the
recovery on the loop and a de-interleave hop. Where the plan's wave 0
is d parts read from one offset, this module serves it in one executor
thread instead:

1. the native gather (``native_io.read_parts_gather_blocking``) reads
   the d parts over polled sockets and de-interleaves as it receives:
   slot i of the stripe gets data part i where it survives, and each
   lost data part's slot gets a wave-0 parity part that stands in for
   it, so the surviving data lands in stripe order at once. It reads in
   rounds of at most ``ROUND_SLOTS`` slots, each round within the wave
   timeout;
2. the lost data parts are recovered in the same thread through the
   client's encoder, from the same k parts, in the same order, as
   ``ECReadPlan._recover_parts`` takes them (the same selection, matrix
   and bytes), and written back into their slots.

With every data part present (EC or XOR) the gather reads just the
blocks up to the request's last one, a chunk's tail included; with a
data part lost (EC only) every part reads the same whole slots, so a
tail with short parts is left to the wave executor.

The loop resumes once. The hop is charged as ``net`` but for the
recovery in its thread, which is ``decode``; the recovery's charges
(the seam's ``seam_stage`` and ``seam_sync``) are collected in the
thread and replayed on the read's sink when the loop resumes, so the
sink and the trace ring are touched on the loop only. A hop that fails
and sends the read to the waves is charged as ``fanin_fallback``, from
its submission to the failure, and nothing else.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE
from lizardfs_tpu_torch.core import native_io
from lizardfs_tpu_torch.core.plans import ReadOp, SliceReadPlan
from lizardfs_tpu_torch.runtime import tracing

# Slots of each part one gather call reads (1 MiB a part). Each call
# has the wave timeout to finish, so the rule for a straggler is the
# same at any read size: a part that cannot deliver 1 MiB within the
# wave timeout has stalled, and the read falls back to the waves.
ROUND_SLOTS = 16


def slots(plan: SliceReadPlan, region_blocks: int) -> tuple[list[ReadOp], int] | None:
    """The wave-0 op that fills each slot of the stripe (data part i's
    own op for slot i, a parity part's where data part i is lost) and
    the blocks the gather reads, or None where the fan-in cannot serve
    the plan. ``region_blocks`` counts the blocks from the first slot's
    first block to the request's last one."""
    st = plan.slice_type
    if not (st.is_ec or st.is_xor):
        return None
    d = st.data_parts
    data = list(range(1, d + 1)) if st.is_xor else list(range(d))
    if [info.part for info in plan.requested_parts] != data:
        return None
    wave0 = [op for op in plan.read_operations if op.wave == 0]
    if len(wave0) != d or any(op.request_offset != wave0[0].request_offset for op in wave0):
        return None
    own = {op.part: op for op in wave0 if op.part in data}
    if len(own) == d:
        # each part's share of the region has to lie inside its data
        by_slot = [own[p] for p in data]
        if all(max(0, -(-(region_blocks - i) // d)) * MFSBLOCKSIZE <= op.request_size
               for i, op in enumerate(by_slot)):
            return by_slot, region_blocks
        return None
    if not st.is_ec or any(op.request_size != plan.buffer_part_size for op in wave0):
        return None
    stand_ins = [op for op in wave0 if op.part >= d]
    by_slot = [own[i] if i in own else stand_ins.pop(0) for i in range(d)]
    return by_slot, plan.buffer_part_size // MFSBLOCKSIZE * d


def recover_slots(
    plan: SliceReadPlan, by_slot: list[ReadOp], encoder, region: np.ndarray,
    nslots: int,
) -> None:
    """Rebuild, in place, each lost data part's slot of the gathered
    ``region`` (``nslots`` stripes of d blocks): each survivor goes to
    ``encoder.recover`` as a contiguous row, keyed and ordered as
    ``ECReadPlan._recover_parts`` keys and orders them."""
    st = plan.slice_type
    d, m = st.data_parts, st.parity_parts
    grid = region[: nslots * d * MFSBLOCKSIZE].reshape(nslots, d, MFSBLOCKSIZE)
    slot_of = {op.part: i for i, op in enumerate(by_slot)}
    lost = [i for i, op in enumerate(by_slot) if op.part != i]
    parts = {
        op.part: np.ascontiguousarray(grid[:, slot_of[op.part], :]).reshape(-1)
        for op in plan.read_operations if op.part in slot_of
    }
    recovered = encoder.recover(d, m, parts, lost)
    for i in lost:
        grid[:, i, :] = recovered[i].reshape(nslots, MFSBLOCKSIZE)


def _read_blocking(
    plan, by_slot, blocks, encoder, chunk_id, version, locations, rel, size,
    max_ms, dst, cell,
):
    """The hop, in its executor thread: gather round by round, recover,
    and land the requested bytes in ``dst`` where one is given. Returns
    the region, when the recovery started (None without one) and the
    seam's charges collected in the thread."""
    d = plan.slice_type.data_parts
    exact = dst is not None and rel == 0 and size == blocks * MFSBLOCKSIZE
    region = dst if exact else np.empty(blocks * MFSBLOCKSIZE, dtype=np.uint8)
    addrs = [locations[op.part][0] for op in by_slot]
    part_ids = [locations[op.part][1] for op in by_slot]
    step = ROUND_SLOTS * d
    for first in range(0, blocks, step):
        n = min(step, blocks - first)
        cell["rounds"] = cell.get("rounds", 0) + 1
        native_io.read_parts_gather_blocking(
            addrs, chunk_id, version, part_ids,
            by_slot[0].request_offset + first // d * MFSBLOCKSIZE, n,
            region[first * MFSBLOCKSIZE : (first + n) * MFSBLOCKSIZE], cell, max_ms,
        )
    if cell.get("aborted"):
        raise native_io.NativeIOError(-1, "stripe fan-in (aborted)")
    recovered_from = None
    charges: list[tuple[str, float, float]] = []
    if plan.slice_type.is_ec and any(op.part != i for i, op in enumerate(by_slot)):
        recovered_from = time.perf_counter()
        # a pooled thread must never keep the collector: reset below
        tok = tracing.PHASE_SINK.set(lambda *c: charges.append(c))
        try:
            recover_slots(plan, by_slot, encoder, region, blocks // d)
        finally:
            tracing.PHASE_SINK.reset(tok)
    if dst is not None and not exact:
        dst[:] = region[rel : rel + size]
    return region, recovered_from, charges


def _charge(hop: native_io.Hop, recovered_from: float | None, charges) -> None:
    """Charge the finished hop on the loop: ``net`` and its queue, run
    and resume parts, but for the recovery, which runs in the thread
    from ``recovered_from`` to its return and is ``decode`` (two ``net``
    spans around it); then the seam's charges from the thread."""
    if recovered_from is None:
        hop.charge("net")
        return
    sink = tracing.PHASE_SINK.get()
    if sink is None:
        return
    resumed = time.perf_counter()
    sink("net", hop.submitted, recovered_from)
    sink("net", hop.returned, resumed)
    sink("net_queue", hop.submitted, hop.started)
    sink("net_run", hop.started, recovered_from)
    sink("net_resume", hop.returned, resumed)
    sink("decode", recovered_from, hop.returned)
    for phase, t0, t1 in charges:
        sink(phase, t0, t1)


async def read_stripe(
    plan: SliceReadPlan, by_slot: list[ReadOp], blocks: int, encoder,
    chunk_id: int, version: int, locations: dict, rel: int, size: int,
    wave_timeout: float, dst: np.ndarray | None = None, cell: dict | None = None,
) -> np.ndarray | None:
    """Serve ``plan`` in one hop with the wave-0 ops by slot and the
    blocks to gather from :func:`slots`: the ``size`` bytes at ``rel``
    into the stripes, written to ``dst`` (then None is returned) or
    returned. ``locations``: part -> ((host, port), wire part id).
    Raises ``native_io.NativeIOError``, ``OSError`` or
    ``ConnectionError`` where the wave executor has to serve the plan
    instead, charging the hop as ``fanin_fallback``. Cancelled, it
    aborts the gather and joins its thread before it returns, so nothing
    writes ``dst`` after. ``cell``, where given, is the hop's state
    shared with its thread; its ``rounds`` counts the gather calls."""
    from lizardfs_tpu_torch.core.cs_stats import GLOBAL_STATS

    cell = {} if cell is None else cell
    hop = native_io.Hop(
        native_io.EXECUTOR, _read_blocking, plan, by_slot, blocks, encoder,
        chunk_id, version, locations, rel, size,
        max(1, int(wave_timeout * 1000)), dst, cell,
    )
    fut = hop.future
    try:
        region, recovered_from, charges = await asyncio.shield(fut)
    except asyncio.CancelledError:
        native_io.abort_parts_gather(cell)
        try:
            await asyncio.wait_for(asyncio.shield(fut), 10.0)
        except (Exception, asyncio.CancelledError):
            pass
        raise
    except (native_io.NativeIOError, OSError, ConnectionError):
        tracing.charge_phase("fanin_fallback", hop.submitted)
        raise
    _charge(hop, recovered_from, charges)
    for op in by_slot:
        GLOBAL_STATS.record_success(locations[op.part][0])
    if dst is not None:
        return None
    return region[rel : rel + size]
