"""What a run notes of the host beside its result, to tell a slow host
from a slow program when runs of one cell spread: the mount's CPU
seconds by thread, the daemons' by role, a fixed piece of pure-Python
work timed after the window, and the card's name and power limit. None
of it is a metric.
"""

from __future__ import annotations

import os
import subprocess
import time

_TICKS = os.sysconf("SC_CLK_TCK")


def thread_cpu_seconds(pid: int | str = "self") -> dict[int, float]:
    """utime + stime of each live thread of a process, by thread id."""
    out: dict[int, float] = {}
    base = f"/proc/{pid}/task"
    try:
        tids = os.listdir(base)
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"{base}/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[int(tid)] = (int(fields[11]) + int(fields[12])) / _TICKS
    return out


def threads_delta(after: dict[int, float], before: dict[int, float]) -> dict:
    """CPU seconds between two readings: the main thread's, all others'
    summed, and the five busiest other threads' (a thread that spins
    whatever the load reads near the window's length)."""
    main = os.getpid()
    d = {t: v - before.get(t, 0.0) for t, v in after.items()}
    others = sorted((v for t, v in d.items() if t != main), reverse=True)
    return {"main": round(d.get(main, 0.0), 2), "others": round(sum(others), 2),
            "others_top": [round(v, 2) for v in others[:5]], "threads": len(d)}


def by_role(cpu: dict[str, float]) -> dict[str, float]:
    """Daemons' CPU seconds: the master's, all chunkservers' summed, and
    the busiest and idlest chunkserver's."""
    cs = [v for n, v in cpu.items() if n.startswith("cs")]
    return {"master": round(cpu.get("master", 0.0), 2), "chunkservers": round(sum(cs), 2),
            "chunkserver_max": round(max(cs, default=0.0), 2),
            "chunkserver_min": round(min(cs, default=0.0), 2)}


def probe_ms(n: int = 1_000_000, reps: int = 5) -> float:
    """Median milliseconds of ``reps`` fixed loops of ``n`` Python
    additions: the same work in every run, so a slower host reads higher."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        s = 0
        for i in range(n):
            s += i
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[reps // 2]


def card_info() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return {"nvidia_smi": out}
