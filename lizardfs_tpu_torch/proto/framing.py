"""Packet framing over asyncio streams.

Same shape as the reference's framing (reference: src/protocol/packet.h:
29-57): an 8-byte header — type:u32, length:u32 big-endian — followed by
``length`` payload bytes, with a protocol version byte leading the
payload (the LIZ packet version field).
"""

from __future__ import annotations

import asyncio
import struct

from lizardfs_tpu_torch.proto.codec import Message, message_class_for
from lizardfs_tpu_torch.runtime import faults as _faults
from lizardfs_tpu_torch.runtime.retry import bounded_wait

HEADER = struct.Struct(">II")
PROTO_VERSION = 1
MAX_PACKET_SIZE = 128 * 1024 * 1024  # sanity bound


class ProtocolError(Exception):
    pass


def encode(msg: Message) -> bytes:
    if msg.MSG_TYPE is None:
        raise ProtocolError(f"{type(msg).__name__} is not a top-level message")
    body = msg.pack_body()
    return HEADER.pack(msg.MSG_TYPE, len(body) + 1) + bytes([PROTO_VERSION]) + body


def decode(msg_type: int, payload: bytes) -> Message:
    if not payload:
        raise ProtocolError("empty payload")
    if payload[0] != PROTO_VERSION:
        raise ProtocolError(f"unsupported protocol version {payload[0]}")
    return message_class_for(msg_type).parse(payload[1:])


def _msg_name(msg_type: int) -> str:
    try:
        return message_class_for(msg_type).__name__
    except KeyError:
        return str(msg_type)


def _peer_of(writer: asyncio.StreamWriter) -> str:
    peer = writer.get_extra_info("peername")
    if isinstance(peer, tuple) and len(peer) >= 2:
        return f"{peer[0]}:{peer[1]}"
    return str(peer) if peer else ""


async def read_message(reader: asyncio.StreamReader) -> Message:
    # bounded_wait with no cap = ambient-deadline-only: a client op
    # under a RetryPolicy budget cannot park past it on a wedged peer,
    # while a server connection loop (no ambient deadline) still parks
    # on the next request frame by design — liveness there is owned by
    # heartbeats/TCP, not a per-frame timer
    header = await bounded_wait(reader.readexactly(HEADER.size))
    msg_type, length = HEADER.unpack(header)
    if length > MAX_PACKET_SIZE:
        raise ProtocolError(f"packet too large: {length}")
    payload = await bounded_wait(reader.readexactly(length))
    if _faults.ACTIVE:
        # fault choke point (runtime/faults.py): delay/drop/flip the
        # received frame. One module-attribute check when injection is
        # off — the clean path is byte-identical.
        payload = await _faults.frame_point(
            "frame_recv", _msg_name(msg_type), payload
        )
    return decode(msg_type, payload)


def write_message(writer: asyncio.StreamWriter, msg: Message) -> None:
    writer.write(encode(msg))


async def send_message(writer: asyncio.StreamWriter, msg: Message) -> None:
    if _faults.ACTIVE:
        # fault choke point: delay/drop/flip/short-write the outbound
        # frame (runtime/faults.py). The sync write_message fast path
        # (shadow acks) stays unhooked by design.
        data = await _faults.frame_point(
            "frame_send", type(msg).__name__, encode(msg),
            peer=_peer_of(writer), writer=writer,
        )
        writer.write(data)
        await bounded_wait(writer.drain())
        return
    write_message(writer, msg)
    # ambient-deadline-bounded like the reads: backpressure from a
    # dead-slow peer charges the caller's budget, not forever
    await bounded_wait(writer.drain())
