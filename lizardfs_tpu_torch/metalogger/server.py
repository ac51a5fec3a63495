"""Metalogger daemon: archives the master's changelog + metadata images.

The reference's metalogger is the master's changelog-subscriber module
running standalone (reference: src/metalogger/init.h:35-42 — just the
masterconn module). Same here: subscribe to the changelog stream, append
lines to ``changelog_ml.0.log``, periodically snapshot a downloaded
metadata image. Restoring a lost master = metarestore over these files
(tools/metarestore analog).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os

from lizardfs_tpu_torch.master.changelog import Changelog, save_image
from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import retry as retrymod


class Metalogger:
    def __init__(
        self,
        data_dir: str,
        master_addrs: list[tuple[str, int]],
        image_interval: float = 3600.0,
    ):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.master_addrs = master_addrs
        self.image_interval = image_interval
        self.version = 0
        # highest cluster fencing epoch seen in the archived stream
        # (epoch_bump lines / image sections): a master whose reply
        # epoch is BEHIND this is a deposed ex-primary — refuse to
        # follow it, or the archive forks off the elected leader's
        # history. 0 until the first promotion = fencing disengaged.
        self.epoch = 0
        self._log_file = None
        self._task: asyncio.Task | None = None
        self._stopping = asyncio.Event()
        self.log = logging.getLogger("metalogger")
        self._load_state()

    def _load_state(self) -> None:
        """Resume from the last archived line's version."""
        path = os.path.join(self.data_dir, "changelog_ml.0.log")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parsed = Changelog.parse_line(line)
                    if parsed:
                        self.version = max(self.version, parsed[0])
                        self._note_epoch(parsed[1])

    def _note_epoch(self, line: str) -> None:
        """Fold an archived changelog line into the known cluster epoch
        (substring pre-filter: one json.loads per PROMOTION, not per
        line)."""
        if '"epoch_bump"' not in line:
            return
        try:
            op = json.loads(line)
        except ValueError:
            return
        if op.get("op") == "epoch_bump":
            self.epoch = max(self.epoch, int(op.get("epoch", 0)))

    def _append(self, version: int, line: str) -> None:
        if self._log_file is None:
            self._log_file = open(
                os.path.join(self.data_dir, "changelog_ml.0.log"),
                "a",
                encoding="utf-8",
            )
        self._log_file.write(f"{version}: {line}\n")
        self._log_file.flush()
        self.version = version
        self._note_epoch(line)

    def prefer(self, addr: tuple[str, int]) -> None:
        """Move an address to the front of the follow cycle. The
        election wiring calls this when a leader is named, so the next
        (re)connect lands on the elected master first instead of
        probing deposed peers in config order."""
        if addr in self.master_addrs and self.master_addrs[0] != addr:
            self.master_addrs.remove(addr)
            self.master_addrs.insert(0, addr)

    async def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopping.set()
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    async def _run(self) -> None:
        while not self._stopping.is_set():
            for addr in self.master_addrs:
                try:
                    await self._follow(addr)
                except (ConnectionError, OSError,
                        asyncio.IncompleteReadError, asyncio.TimeoutError):
                    continue
                except asyncio.CancelledError:
                    return
            await asyncio.sleep(1.0)

    async def _follow(self, addr: tuple[str, int]) -> None:
        # dial bound: a blackholed master costs 5 s, not the OS SYN
        # timeout, before the follow loop tries the next address
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(*addr), 5.0
        )
        try:
            await framing.send_message(
                writer, m.MltomaRegister(
                    req_id=1, version_known=self.version,
                    # our replayed epoch: a zombie we dial steps down
                    epoch=self.epoch,
                )
            )
            hello = await framing.read_message(reader)
            if not isinstance(hello, m.MatomlRegisterReply) or hello.status != st.OK:
                raise ConnectionError("not the active master")
            hello_epoch = getattr(hello, "epoch", 0)
            if hello_epoch and hello_epoch < self.epoch:
                # deposed ex-primary: it never applied the epoch_bump we
                # already archived — its lines would fork our archive off
                # the elected leader's history. Try the next address.
                raise ConnectionError(
                    f"refusing stale active (epoch {hello_epoch} < "
                    f"ours {self.epoch})"
                )
            self.epoch = max(self.epoch, hello_epoch)
            self.log.info("following master at %s:%d (v%d)", *addr, hello.version)
            last_image = 0.0
            loop = asyncio.get_running_loop()
            while True:
                if loop.time() - last_image > self.image_interval:
                    await framing.send_message(
                        writer, m.MltomaDownloadImage(req_id=2)
                    )
                    last_image = loop.time()
                msg = await framing.read_message(reader)
                if isinstance(msg, m.MatomlChangelogLine):
                    if msg.version > self.version:
                        self._append(msg.version, msg.line)
                elif isinstance(msg, m.MatomlImage) and msg.status == st.OK:
                    doc = json.loads(msg.image.decode())
                    doc.pop("format", None)  # save_image stamps its own
                    save_image(self.data_dir, msg.version, doc)
                    # the image's epoch section covers promotions whose
                    # epoch_bump line predates our archive window
                    self.epoch = max(self.epoch, int(doc.get("epoch", 0)))
                    self.log.info("archived metadata image v%d", msg.version)
        finally:
            await retrymod.close_writer(writer, swallow_cancel=True)
