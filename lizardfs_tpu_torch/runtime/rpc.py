"""Client-side RPC connection: pipelined request/response over one stream.

The analog of the reference's mastercomm packet pump (reference:
src/mount/mastercomm.cc): one persistent connection, concurrent in-flight
requests matched to responses by ``req_id``, push messages (e.g. the
changelog stream) dispatched to registered handlers.
"""

from __future__ import annotations

import asyncio
import itertools

from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto.codec import Message
from lizardfs_tpu_torch.proto.status import StatusError
from lizardfs_tpu_torch.runtime import faults as _faults
from lizardfs_tpu_torch.runtime import retry as _retry


class RpcConnection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._req_ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._push_handlers: dict[type, object] = {}
        self._handler_tasks: set[asyncio.Task] = set()
        self._pump_task: asyncio.Task | None = None
        self._closed = asyncio.Event()

    # dial bound (unbounded-await audit): an RPC link to a blackholed
    # peer fails in seconds, not the OS SYN timeout; ambient RetryPolicy
    # deadlines (runtime/retry.py) shrink it further
    DIAL_TIMEOUT = 5.0

    @classmethod
    async def connect(cls, host: str, port: int) -> "RpcConnection":
        if _faults.ACTIVE:
            await _faults.dial_point("rpc", f"{host}:{port}")
        reader, writer = await _retry.bounded_wait(
            asyncio.open_connection(host, port), cls.DIAL_TIMEOUT
        )
        conn = cls(reader, writer)
        conn.start()
        return conn

    def start(self) -> None:
        # detached: the pump (and the push-handler tasks it spawns)
        # outlives any RetryPolicy attempt that dialed this connection —
        # it must not inherit that attempt's deadline budget
        self._pump_task = _retry.spawn_detached(self._pump())

    def on_push(self, msg_cls: type, handler) -> None:
        """Register an async handler for unsolicited messages of a type."""
        self._push_handlers[msg_cls] = handler

    async def _pump(self) -> None:
        try:
            while True:
                msg = await framing.read_message(self.reader)
                # push types FIRST: peer-initiated requests (e.g. master
                # commands) carry their own req_id space which would
                # otherwise collide with our call ids on a bidirectional
                # link. Push handlers run as tasks so a slow handler
                # (e.g. a replication) never stalls the pump.
                handler = self._push_handlers.get(type(msg))
                if handler is not None:
                    task = asyncio.get_running_loop().create_task(handler(msg))
                    self._handler_tasks.add(task)
                    task.add_done_callback(self._handler_tasks.discard)
                    continue
                req_id = getattr(msg, "req_id", None)
                fut = self._pending.pop(req_id, None) if req_id is not None else None
                if fut is not None and not fut.done():
                    fut.set_result(msg)
                # unsolicited + unhandled messages are dropped
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._closed.set()
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("connection lost"))
            self._pending.clear()

    async def call(
        self, msg_cls, *, timeout: float = 30.0, **fields
    ) -> Message:
        """Send a request (auto req_id) and await its response."""
        if self._closed.is_set():
            # the pump is gone: nothing will ever resolve the future.
            # Failing fast here is what makes client failover prompt —
            # without it every call on a dead connection burns the full
            # timeout before the reconnect path runs.
            raise ConnectionError("connection lost")
        req_id = next(self._req_ids)
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            await framing.send_message(self.writer, msg_cls(req_id=req_id, **fields))
            # the per-call timeout is additionally clamped by any
            # ambient RetryPolicy deadline: nested retries share one
            # end-to-end budget instead of multiplying their waits
            return await asyncio.wait_for(
                fut, max(_retry.budget(timeout), 0.001)
            )
        finally:
            self._pending.pop(req_id, None)

    async def call_ok(self, msg_cls, *, timeout: float = 30.0, **fields) -> Message:
        """``call`` that raises StatusError on non-OK status replies."""
        reply = await self.call(msg_cls, timeout=timeout, **fields)
        st = getattr(reply, "status", 0)
        if st != 0:
            # BUSY sheds carry the admission controller's backoff hint
            # (MatoclStatusReply.retry_after_ms); surface it on the
            # exception so the client's busy-retry loop can honor it
            raise StatusError(
                st, msg_cls.__name__,
                retry_after_ms=getattr(reply, "retry_after_ms", 0),
            )
        return reply

    async def send(self, msg: Message) -> None:
        """Fire-and-forget (reports, acks)."""
        await framing.send_message(self.writer, msg)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    async def close(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
        for task in list(self._handler_tasks):
            task.cancel()
        await _retry.close_writer(self.writer, swallow_cancel=True)
        self._closed.set()
        # a pump cancelled before its first step never runs its finally:
        # fail the calls it would have failed, or a call sent just before
        # the close waits out its whole timeout
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("connection lost"))
        self._pending.clear()
