"""Tape server daemon (matotsserv.cc peer, src/common/tape_* analog).

Protocol: ``TstomaRegister`` -> master, then the master pushes
``MatotsPutFile`` commands; the daemon reads the file's current content
via a regular cluster client session and writes it to the archive
directory, acking with ``TstomaPutDone`` carrying the content stamp
(length, mtime) it actually archived — the master only records the tape
copy if the stamp still matches the live file (no torn archives of
concurrently-written files).

Archive layout: ``<archive>/<inode>_<mtime>_<length>.tape`` plus a
``.json`` sidecar with the original path for operator recovery.
"""

from __future__ import annotations

import asyncio
import json
import os

from lizardfs_tpu_torch.client.client import Client
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime.daemon import Daemon
from lizardfs_tpu_torch.runtime.rpc import RpcConnection


class TapeServer(Daemon):
    name = "tapeserver"

    def __init__(
        self,
        archive_dir: str,
        master_addr: tuple[str, int],
        label: str = "_",
        heartbeat_interval: float = 5.0,
        encoder=None,
    ) -> None:
        # the admin/metrics port; tape data flows over the master link
        super().__init__()
        self.archive_dir = archive_dir
        self.master_addr = master_addr
        self.label = label
        self.heartbeat_interval = heartbeat_interval
        self.master: RpcConnection | None = None
        self.client: Client | None = None
        self.encoder = encoder
        self.ts_id = 0
        # test hook: when set, _cmd_put parks here AFTER reading the
        # file and BEFORE archiving/acking — the window the master's
        # stamp-mismatch defense exists for (a concurrent write must
        # not be recorded as archived)
        self.put_barrier: asyncio.Event | None = None
        os.makedirs(archive_dir, exist_ok=True)

    async def setup(self) -> None:
        self.add_timer(self.heartbeat_interval, self._keepalive)

    async def start(self) -> None:
        await super().start()
        await self._connect()

    async def _connect(self) -> None:
        self.client = Client(*self.master_addr, encoder=self.encoder)
        # lint: waive(unbounded-await): delegates to Client.connect — dials via the 5 s-bounded RpcConnection.connect and a 30 s-capped register RPC
        await self.client.connect(info=f"tapeserver:{self.label}")
        self.master = await RpcConnection.connect(*self.master_addr)
        self.master.on_push(m.MatotsPutFile, self._cmd_put)
        self.master.on_push(m.MatotsDeleteFile, self._cmd_delete)
        self.master.on_push(m.MatotsRecallFile, self._cmd_recall)
        reply = await self.master.call_ok(
            m.TstomaRegister, label=self.label, capacity=0,
            session_id=self.client.session_id,
        )
        self.ts_id = reply.ts_id
        self.log.info("registered with master as tape server %d", self.ts_id)

    async def _keepalive(self) -> None:
        """Reconnect the master link after a failover/restart."""
        if self.master is None or self.master.closed:
            try:
                if self.client is not None:
                    await self.client.close()
                await self._connect()
            except (OSError, ConnectionError, st.StatusError,
                    asyncio.TimeoutError):
                pass

    def _archive_path(self, inode: int, mtime: int, length: int) -> str:
        return os.path.join(
            self.archive_dir, f"{inode}_{mtime}_{length}.tape"
        )

    async def _cmd_put(self, msg: m.MatotsPutFile) -> None:
        code = st.OK
        length, mtime = 0, 0
        try:
            attr = await self.client.getattr(msg.inode)
            length, mtime = attr.length, attr.mtime
            data = await self.client.read_file(msg.inode, 0, attr.length)
            if self.put_barrier is not None:
                # test hook: hold the read-to-ack window open so a
                # concurrent mutation can race the archive
                await asyncio.wait_for(self.put_barrier.wait(), 30.0)
            dest = self._archive_path(msg.inode, mtime, length)
            tmp = dest + ".tmp"
            await asyncio.to_thread(self._write_archive, tmp, dest, data, {
                "inode": msg.inode, "path": msg.path,
                "length": length, "mtime": mtime, "label": self.label,
            })
            self.metrics.counter("tape_archived_bytes").inc(float(len(data)))
            self.metrics.counter("tape_files").inc()
        except st.StatusError as e:
            code = e.code
        except (OSError, ConnectionError, asyncio.TimeoutError):
            self.log.exception("archiving inode %d failed", msg.inode)
            code = st.EIO
        await self.master.send(m.TstomaPutDone(
            req_id=msg.req_id, inode=msg.inode, status=code,
            length=length, mtime=mtime,
        ))

    async def _cmd_recall(self, msg: m.MatotsRecallFile) -> None:
        """Restore a demoted file from the archive: stream the exact
        stamped version back through the cluster client session. The
        master only sends this while it holds the inode in
        recall-inflight state (writes allowed, reads still fenced)."""
        code = st.OK
        try:
            path = self._archive_path(msg.inode, msg.mtime, msg.length)
            data = await asyncio.to_thread(self._read_archive, path)
            if data is None:
                code = st.ENOENT
            else:
                await self.client.write_file(msg.inode, data)
                self.metrics.counter("tape_recalled_bytes").inc(
                    float(len(data))
                )
                self.metrics.counter("tape_recalls").inc()
        except st.StatusError as e:
            code = e.code
        except (OSError, ConnectionError, asyncio.TimeoutError):
            self.log.exception("recalling inode %d failed", msg.inode)
            code = st.EIO
        await self.master.send(m.TstomaRecallDone(
            req_id=msg.req_id, inode=msg.inode, status=code,
            length=msg.length, mtime=msg.mtime,
        ))

    @staticmethod
    def _read_archive(path: str) -> bytes | None:
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    async def _cmd_delete(self, msg: m.MatotsDeleteFile) -> None:
        """Reclaim archives: keep only the (keep_mtime, keep_length)
        version; (0, 0) removes every version of the inode."""
        keep = None
        if msg.keep_mtime or msg.keep_length:
            keep = f"{msg.inode}_{msg.keep_mtime}_{msg.keep_length}.tape"

        def reclaim() -> int:
            n = 0
            prefix = f"{msg.inode}_"
            for name in os.listdir(self.archive_dir):
                base = name[:-5] if name.endswith(".json") else name
                if not (base.startswith(prefix) and base.endswith(".tape")):
                    continue
                if keep is not None and base == keep:
                    continue
                try:
                    os.unlink(os.path.join(self.archive_dir, name))
                    n += 1
                except OSError:
                    pass
            return n

        removed = await asyncio.to_thread(reclaim)
        if removed:
            self.metrics.counter("tape_reclaimed").inc(float(removed))

    @staticmethod
    def _write_archive(tmp: str, dest: str, data: bytes, meta: dict) -> None:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dest)
        with open(dest + ".json", "w") as f:
            json.dump(meta, f)

    async def stop(self) -> None:
        if self.master is not None:
            await self.master.close()
        if self.client is not None:
            await self.client.close()
        await super().stop()
