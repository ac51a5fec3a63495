"""A cluster of the program's daemons, one process each: a master and
the configuration's chunkservers, started with ``python -m``, each from a
config file of its own, with their data under the run's ``TMPDIR``.

The operating system's counters of each daemon (CPU seconds from
``/proc/<pid>/stat``, bytes written from ``/proc/<pid>/io``) are read
here too.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TICKS = os.sysconf("SC_CLK_TCK")


def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def free_port(taken: set[int] = frozenset()) -> int:
    """A free port below the kernel's ephemeral range (so that no socket a
    daemon binds to port 0 can take it before its own daemon starts), and
    not in ``taken``."""
    rng = random.SystemRandom()
    low = _ephemeral_low()
    for _ in range(500):
        port = rng.randrange(max(1024, low - 20000), low)
        if port in taken:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below the ephemeral range")


def cpu_seconds(pid: int) -> float:
    """utime + stime of a live process."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / _TICKS


def io_counters(pid: int) -> dict[str, int]:
    """``/proc/<pid>/io``: ``write_bytes`` (sent to storage) and ``wchar``."""
    out = {}
    with open(f"/proc/{pid}/io") as f:
        for line in f:
            key, _, val = line.partition(":")
            out[key] = int(val)
    return out


async def admin(port: int, command: str, payload: dict | None = None):
    """One admin command to a daemon's port; its reply message."""
    from lizardfs_tpu_torch.proto import framing
    from lizardfs_tpu_torch.proto import messages as m

    r, w = await asyncio.wait_for(asyncio.open_connection("127.0.0.1", port), 5.0)
    try:
        if command == "info":
            await framing.send_message(w, m.AdminInfo(req_id=1))
        else:
            await framing.send_message(
                w, m.AdminCommand(req_id=1, command=command,
                                  json=json.dumps(payload or {})))
        return await asyncio.wait_for(framing.read_message(r), 30.0)
    finally:
        w.close()


async def admin_json(port: int, command: str, payload: dict | None = None) -> dict:
    reply = await admin(port, command, payload)
    if getattr(reply, "status", 0) != 0:
        raise RuntimeError(f"admin {command} failed: {reply}")
    return json.loads(reply.json)


class Cluster:
    """The master and ``config["chunkservers"]`` chunkservers of one
    configuration (its ``goal``, ``master_cfg`` and ``chunkserver_cfg``)."""

    def __init__(self, config: dict):
        self.config = config
        self.workdir = tempfile.mkdtemp(prefix="fsbench-cluster-")
        self.master_port = free_port()
        self.cs_ports: list[int] = []
        self._taken = {self.master_port}
        self.procs: dict[str, subprocess.Popen] = {}
        self._logs = []
        # counters of daemons killed on purpose, read just before the kill
        self._dead_io = {"write_bytes": 0, "wchar": 0}

    def _spawn(self, name: str, module: str, cfg: dict) -> None:
        path = os.path.join(self.workdir, f"{name}.cfg")
        with open(path, "w") as f:
            f.writelines(f"{k} = {v}\n" for k, v in cfg.items())
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.pop("LZ_FAULTS", None)
        log = open(os.path.join(self.workdir, f"{name}.log"), "wb")
        self._logs.append(log)
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", module, path], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=self.workdir,
        )

    def data_dir(self, index: int) -> str:
        return os.path.join(self.workdir, f"cs{index}")

    async def start(self, timeout: float = 120.0) -> None:
        goal = self.config["goal"]
        goals = os.path.join(self.workdir, "goals.cfg")
        with open(goals, "w") as f:
            f.write(f"1 one : _\n{goal['id']} {goal['name']} : {goal['expr']}\n")
        self._spawn("master", "lizardfs_tpu_torch.master", {
            "DATA_PATH": os.path.join(self.workdir, "master"),
            "LISTEN_PORT": self.master_port,
            "GOALS_CFG": goals,
            **self.config["master_cfg"],
        })
        for i in range(self.config["chunkservers"]):
            port = free_port(self._taken)
            self._taken.add(port)
            self.cs_ports.append(port)
            self._spawn(f"cs{i}", "lizardfs_tpu_torch.chunkserver", {
                "DATA_PATH": self.data_dir(i),
                "LISTEN_HOST": "127.0.0.1",
                "LISTEN_PORT": port,
                "MASTER_HOST": "127.0.0.1",
                "MASTER_PORT": self.master_port,
                **self.config["chunkserver_cfg"],
            })
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self._check_alive()
            if await self.connected_count() >= self.config["chunkservers"]:
                return
            await asyncio.sleep(0.1)
        raise RuntimeError("chunkservers never registered")

    def _check_alive(self) -> None:
        for name, p in self.procs.items():
            if p.poll() is not None and not getattr(p, "killed_on_purpose", False):
                raise RuntimeError(f"{name} exited with {p.returncode}: "
                                   f"{self.log_tail(name)}")

    def log_tail(self, name: str, nbytes: int = 1500) -> str:
        try:
            with open(os.path.join(self.workdir, f"{name}.log"), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(f.tell() - nbytes, 0))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    async def master_info(self) -> dict:
        return json.loads((await admin(self.master_port, "info")).json)

    async def connected_count(self) -> int:
        try:
            doc = await self.master_info()
        except (ConnectionError, OSError, asyncio.TimeoutError):
            return 0
        return sum(1 for s in doc.get("chunkservers", []) if s.get("connected"))

    def pids(self) -> dict[str, int]:
        return {n: p.pid for n, p in self.procs.items() if p.poll() is None}

    def cpu(self) -> dict[str, float]:
        out = {}
        for name, pid in self.pids().items():
            try:
                out[name] = cpu_seconds(pid)
            except OSError:
                pass
        return out

    def disk_writes(self) -> dict[str, int]:
        """Bytes each live daemon has written to storage and through
        ``write(2)``, summed: ``{"write_bytes": .., "wchar": ..}``."""
        tot = dict(self._dead_io)
        for pid in self.pids().values():
            try:
                io = io_counters(pid)
            except OSError:
                continue
            for key in tot:
                tot[key] += io.get(key, 0)
        return tot

    def kill9(self, name: str) -> None:
        p = self.procs[name]
        try:
            io = io_counters(p.pid)
            for key in self._dead_io:
                self._dead_io[key] += io.get(key, 0)
        except OSError:
            pass
        p.killed_on_purpose = True
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=20)
        for log in self._logs:
            log.close()
        shutil.rmtree(self.workdir, ignore_errors=True)
