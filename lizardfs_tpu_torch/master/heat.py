"""HeatTracker: the master's decayed per-chunk / per-inode / per-server
heat map — the subsystem that closes the workload-observatory loop.

The observatory built the accounting legs (client RPC charges on the master, CS
top-K heartbeat folds, gateway session-stats pushes) but nothing acted
on them: a viral file kept hammering the same k+m chunkservers while
the fleet idled. This module turns those streams into a bounded,
decayed heat sketch the master can *act* on:

* **bounded memory** — one Space-Saving-style heavy-hitter table per
  kind (chunk / inode / server), ``capacity`` cells each. A new key
  arriving at a full table evicts the coldest cell and inherits its
  decayed score (the classic Space-Saving error bound), so the hottest
  keys are always tracked without the table ever growing.
* **epoch decay** — :meth:`tick` halves every score each
  ``half_life_s`` of elapsed time, so "hot" always means *recently*
  hot and hysteresis-driven demotion follows the storm down for free.
* **rendered** — ``lizardfs-admin heat`` / webui ``/api/heat`` read
  :meth:`snapshot`; the currently-tracked cells export as the
  ``lizardfs_heat_*`` labeled metric families (cumulative ops/bytes
  counters, bounded by the sketch capacity, retired via
  ``drop_labeled`` on eviction) and master-leg charges with a trace id
  feed the ``heat_hot_ops`` labeled histogram whose +Inf bucket
  carries the hottest cell's trace-id exemplar.
* **acted on** — :meth:`boost_decisions` compares decayed chunk heat
  against the ``heat_boost_bytes`` / ``heat_demote_bytes`` thresholds
  (runtime-tunable tweaks) and tells the master which chunks to
  goal-boost / goal-demote through the changelog;
  :meth:`server_loads` folds per-server heat share into the placement
  load scores (master/chunks.py ``server_load``).

The whole plane is behind the ``LZ_HEAT`` kill switch
(constants.heat_enabled) — consulted by the call SITES (master tick,
chunkserver fold), not here: the tracker itself is a pure data
structure so tests can drive it directly.
"""

from __future__ import annotations

KINDS = ("chunk", "inode", "server")

# decayed-score floor below which a cell is dropped entirely (its
# labeled series retire with it): keeps a quiet cluster's heat page
# empty instead of full of stale near-zero cells
EVICT_EPSILON = 1.0


class _Cell:
    """One tracked key: decayed scores (the heat) + monotonic raw
    totals (the exported counters — Prometheus counters must never go
    down; a re-tracked key after eviction restarts them, which scrapers
    treat as an ordinary counter reset)."""

    __slots__ = ("ops", "nbytes", "ops_total", "bytes_total", "trace_id")

    def __init__(self):
        self.ops = 0.0        # decayed op heat
        self.nbytes = 0.0     # decayed byte heat (THE heat score)
        self.ops_total = 0.0
        self.bytes_total = 0.0
        self.trace_id = 0     # most recent charged trace (hottest-cell drill)


class HeatTracker:
    # sketch capacity per kind: heat exists to find the FEW hot keys,
    # and the labeled metric families it exports must stay far under
    # the registry's LABEL_VARIANT_CAP
    CAPACITY = 64
    HALF_LIFE_S = 30.0

    def __init__(self, metrics=None, tweaks=None,
                 capacity: int = CAPACITY,
                 half_life_s: float = HALF_LIFE_S):
        self.metrics = metrics
        self.capacity = capacity
        self.half_life_s = half_life_s
        self._tables: dict[str, dict[int, _Cell]] = {k: {} for k in KINDS}
        self._last_decay = 0.0
        self.evictions = 0
        # adaptive-replication knobs ride the tweaks registry (admin
        # tweaks-set / SIGHUP tunable, the rebuild_bps pattern):
        # boost when decayed chunk heat crosses heat_boost_bytes,
        # demote only after it falls below heat_demote_bytes (the
        # hysteresis band), never more than heat_max_boosted chunks
        # boosted at once, each by heat_boost_copies extra copies.
        if tweaks is not None:
            self._boost_bytes = tweaks.register(
                "heat_boost_bytes", 32 * 1024 * 1024)
            self._demote_bytes = tweaks.register(
                "heat_demote_bytes", 4 * 1024 * 1024)
            self._boost_copies = tweaks.register("heat_boost_copies", 2)
            self._max_boosted = tweaks.register("heat_max_boosted", 8)
            # decay half-life is live-tunable too: shortening it makes
            # demotion follow a storm down faster (and lets the chaos
            # drill assert the full boost→demote cycle in seconds)
            self._half_life = tweaks.register(
                "heat_half_life_s", half_life_s)
        else:  # unit tests / detached use
            class _V:  # noqa: N801 - tiny value cell
                def __init__(self, v):
                    self.value = v

            self._boost_bytes = _V(32 * 1024 * 1024)
            self._demote_bytes = _V(4 * 1024 * 1024)
            self._boost_copies = _V(2)
            self._max_boosted = _V(8)
            self._half_life = _V(half_life_s)

    # --- charging -----------------------------------------------------------

    def charge(self, kind: str, key: int, ops: float = 1.0,
               nbytes: float = 0.0, seconds: float = 0.0,
               trace_id: int = 0) -> None:
        """Account heat to one key. CS heartbeat folds charge (ops,
        bytes) batches; master RPC legs also carry the op's latency +
        trace id, which feed the exemplar histogram."""
        table = self._tables[kind]
        cell = table.get(key)
        if cell is None:
            cell = _Cell()
            if len(table) >= self.capacity:
                coldest = min(table, key=lambda k: table[k].nbytes)
                evicted = table.pop(coldest)
                self.evictions += 1
                # Space-Saving: the newcomer inherits the evicted
                # score — it may have been this hot already while
                # untracked (over-estimates, never under-estimates)
                cell.ops = evicted.ops
                cell.nbytes = evicted.nbytes
                if self.metrics is not None:
                    self.metrics.drop_labeled("heat_ops", "key", coldest)
                    self.metrics.drop_labeled("heat_bytes", "key", coldest)
                    self.metrics.drop_labeled("heat_hot_ops", "key", coldest)
            table[key] = cell
        cell.ops += ops
        cell.nbytes += nbytes
        cell.ops_total += ops
        cell.bytes_total += nbytes
        if trace_id:
            cell.trace_id = trace_id
        if self.metrics is not None:
            labels = {"kind": kind, "key": key}
            self.metrics.labeled_counter(
                "heat_ops", labels,
                help="ops observed on currently-tracked hot keys "
                     "(heat sketch cells; series retire on eviction)",
            ).inc(ops)
            self.metrics.labeled_counter(
                "heat_bytes", labels,
                help="bytes observed on currently-tracked hot keys "
                     "(heat sketch cells; series retire on eviction)",
            ).inc(nbytes)
            if seconds > 0.0 or trace_id:
                # hottest-cell drill-down: op latency histogram whose
                # +Inf bucket carries the trace-id exemplar
                self.metrics.labeled_timing(
                    "heat_hot_ops", labels,
                    help="per-hot-key op latency with trace-id "
                         "exemplars (heat map drill-down)",
                ).record(seconds, trace_id=trace_id)

    def fold_cs(self, cs_id: int, doc: dict) -> None:
        """Ingest one chunkserver heartbeat heat fold:
        ``{"chunks": [[chunk_id, ops, bytes], ...]}`` (heat_json). The
        server's own heat is the sum of its chunk folds."""
        total_ops = 0.0
        total_bytes = 0.0
        for row in doc.get("chunks", ()):
            try:
                cid, ops, nbytes = int(row[0]), float(row[1]), float(row[2])
            except (TypeError, ValueError, IndexError):
                continue
            self.charge("chunk", cid, ops=ops, nbytes=nbytes)
            total_ops += ops
            total_bytes += nbytes
        if total_ops or total_bytes:
            self.charge("server", cs_id, ops=total_ops, nbytes=total_bytes)

    # --- decay / queries ----------------------------------------------------

    def tick(self, now: float) -> None:
        """Apply epoch decay for the wall time elapsed since the last
        tick and drop cells that decayed to nothing (their labeled
        series retire so the scrape page empties after a storm)."""
        if self._last_decay == 0.0:
            self._last_decay = now
            return
        dt = now - self._last_decay
        if dt <= 0:
            return
        self._last_decay = now
        factor = 0.5 ** (dt / max(float(self._half_life.value), 0.1))
        for kind, table in self._tables.items():
            dead = []
            for key, cell in table.items():
                cell.ops *= factor
                cell.nbytes *= factor
                if cell.nbytes < EVICT_EPSILON and cell.ops < EVICT_EPSILON:
                    dead.append(key)
            for key in dead:
                del table[key]
                if self.metrics is not None:
                    self.metrics.drop_labeled("heat_ops", "key", key)
                    self.metrics.drop_labeled("heat_bytes", "key", key)
                    self.metrics.drop_labeled("heat_hot_ops", "key", key)
        if self.metrics is not None:
            self.metrics.gauge(
                "heat_tracked_cells",
                help="keys currently tracked by the heat sketch "
                     "(all kinds; bounded by capacity per kind)",
            ).set(float(sum(len(t) for t in self._tables.values())))

    def heat_of(self, kind: str, key: int) -> float:
        cell = self._tables[kind].get(key)
        return cell.nbytes if cell is not None else 0.0

    def top(self, kind: str, k: int = 16) -> list[dict]:
        table = self._tables[kind]
        rows = sorted(
            table.items(), key=lambda kv: kv[1].nbytes, reverse=True
        )[:k]
        return [
            {
                "key": key,
                "heat_bytes": round(cell.nbytes, 1),
                "heat_ops": round(cell.ops, 2),
                "total_bytes": int(cell.bytes_total),
                "total_ops": int(cell.ops_total),
                "trace_id": f"0x{cell.trace_id:x}" if cell.trace_id else "",
            }
            for key, cell in rows
        ]

    def snapshot(self, boosted: dict[int, int] | None = None,
                 k: int = 16) -> dict:
        """The `heat` admin / webui document."""
        return {
            "half_life_s": float(self._half_life.value),
            "capacity": self.capacity,
            "evictions": self.evictions,
            "thresholds": {
                "heat_boost_bytes": int(self._boost_bytes.value),
                "heat_demote_bytes": int(self._demote_bytes.value),
                "heat_boost_copies": int(self._boost_copies.value),
                "heat_max_boosted": int(self._max_boosted.value),
            },
            "chunks": self.top("chunk", k),
            "inodes": self.top("inode", k),
            "servers": self.top("server", k),
            "boosted": dict(boosted or {}),
        }

    # --- the feedback legs --------------------------------------------------

    def boost_decisions(
        self, boosted: dict[int, int]
    ) -> tuple[list[tuple[int, int]], list[int]]:
        """(to_boost, to_demote) against the current sketch.

        ``boosted`` is the live map of chunk_id -> boost currently
        applied (mirrors ChunkInfo.boost). Boost when decayed heat
        crosses ``heat_boost_bytes`` (bounded by ``heat_max_boosted``
        concurrent boosts); demote only when heat falls below
        ``heat_demote_bytes`` — the hysteresis band between the two
        keeps a flickering chunk from thrashing the changelog."""
        boost_at = float(self._boost_bytes.value)
        demote_at = float(self._demote_bytes.value)
        copies = max(int(self._boost_copies.value), 1)
        cap = max(int(self._max_boosted.value), 0)
        table = self._tables["chunk"]
        to_demote = [
            cid for cid in sorted(boosted)
            if (table[cid].nbytes if cid in table else 0.0) < demote_at
        ]
        to_boost: list[tuple[int, int]] = []
        room = cap - (len(boosted) - len(to_demote))
        if room > 0 and boost_at > 0:
            hot = sorted(
                (
                    (cell.nbytes, cid) for cid, cell in table.items()
                    if cid not in boosted and cell.nbytes >= boost_at
                ),
                reverse=True,
            )
            to_boost = [(cid, copies) for _, cid in hot[:room]]
        return to_boost, to_demote

    def server_loads(self, health: dict[int, dict],
                     waiting: dict[int, float] | None = None) -> dict[int, float]:
        """Placement load scores (master/chunks.py ``server_load``):
        per-server heat share + degraded-health penalty + queue-depth
        pressure, each clamped so one signal cannot drown the others.

        ``health`` is the master's cs_id -> heartbeat health doc map;
        ``waiting`` optionally carries cs_id -> queued data-plane bytes
        (DRR queue depth from the health fold)."""
        table = self._tables["server"]
        total = sum(c.nbytes for c in table.values()) or 1.0
        loads: dict[int, float] = {}
        for cs_id, cell in table.items():
            loads[cs_id] = min(cell.nbytes / total, 1.0)
        for cs_id, doc in health.items():
            status = str((doc or {}).get("status", "ok"))
            if status not in ("", "ok"):
                loads[cs_id] = loads.get(cs_id, 0.0) + 0.5
        for cs_id, nbytes in (waiting or {}).items():
            # 64 MiB queued = full extra point of load
            loads[cs_id] = loads.get(cs_id, 0.0) + min(
                float(nbytes) / (64 * 1024 * 1024), 1.0
            )
        return loads
