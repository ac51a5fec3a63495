"""Per-chunkserver health scores shared across reads.

The port's copy of the JAX package's ``core/cs_stats.py`` (tests pin the two
together).

The analog of the reference's ChunkserverStats (reference:
src/common/chunkserver_stats.cc; consumed by read_plan_executor.cc:95
and chunk_read_planner.cc): every data-plane exchange records success
or failure per server address; defects DECAY exponentially with time so
a server that recovered stops being penalized. Planners and replica
choice consult ``score`` (1.0 = healthy, approaching 0 = repeatedly
failing) so a flaky or slow chunkserver is demoted everywhere at once
instead of per-connection.
"""

from __future__ import annotations

import threading
import time


class ChunkserverStats:
    HALF_LIFE = 30.0  # seconds for a defect to decay to half weight
    FAILURE_WEIGHT = 1.0
    # successes actively repair the score so one good exchange after a
    # blip recovers faster than pure decay
    SUCCESS_REPAIR = 0.25

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        # addr -> (decayed defect weight, last update timestamp)
        self._defects: dict[tuple[str, int], tuple[float, float]] = {}

    def _decayed(self, addr: tuple[str, int], now: float) -> float:
        entry = self._defects.get(addr)
        if entry is None:
            return 0.0
        weight, ts = entry
        return weight * 0.5 ** ((now - ts) / self.HALF_LIFE)

    def record_failure(self, addr: tuple[str, int]) -> None:
        now = self._clock()
        with self._lock:
            w = self._decayed(addr, now) + self.FAILURE_WEIGHT
            self._defects[addr] = (w, now)

    def record_success(self, addr: tuple[str, int]) -> None:
        now = self._clock()
        with self._lock:
            w = self._decayed(addr, now)
            if w <= 0.01:
                self._defects.pop(addr, None)
                return
            self._defects[addr] = (max(w - self.SUCCESS_REPAIR, 0.0), now)

    def defects(self, addr: tuple[str, int]) -> float:
        with self._lock:
            return self._decayed(addr, self._clock())

    def score(self, addr: tuple[str, int]) -> float:
        """1.0 = healthy; halves per recent defect (never reaches 0 so
        a degraded server stays usable when it is the only one)."""
        return 0.5 ** min(self.defects(addr), 10.0)


# process-wide registry: clients, FUSE mounts, and the replicator in one
# process share what they learn about chunkserver health
GLOBAL_STATS = ChunkserverStats()
