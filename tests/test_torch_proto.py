"""The port's wire protocol (``lizardfs_tpu_torch.proto``) against the JAX
package's, on the CPU, byte-exact.

Every one of the message classes is checked in its own case: the same
type number and field list, the same bytes for a seeded instance (body
and frame), and each package parses the other's bytes back to the same
values. Skew-tolerant messages are also packed with their optional tail
at its defaults, where the encoding drops it. Framing round-trips a
stream of frames through both packages' asyncio readers and writers.
"""

import asyncio
import inspect

import numpy as np
import pytest

from lizardfs_tpu.proto import codec as ref_codec
from lizardfs_tpu.proto import framing as ref_framing
from lizardfs_tpu.proto import messages as ref_m
from lizardfs_tpu_torch.proto import codec, framing
from lizardfs_tpu_torch.proto import messages as m


def _classes(mod, base) -> dict[str, type]:
    return {
        name: cls for name, cls in vars(mod).items()
        if inspect.isclass(cls) and issubclass(cls, base) and cls is not base
        and cls.__module__ == mod.__name__
    }


PORT = _classes(m, codec.Message)
REF = _classes(ref_m, ref_codec.Message)
_SCALAR_BITS = {"u8": 8, "u16": 16, "u32": 32, "u64": 64}


def _value(ftype: str, rng: np.random.Generator):
    """A seeded plain value of a field type (a nested message is a dict)."""
    if ftype in _SCALAR_BITS:
        return int(rng.integers(0, 2 ** _SCALAR_BITS[ftype], dtype=np.uint64))
    if ftype in ("i32", "i64"):
        bits = 32 if ftype == "i32" else 64
        return int(rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1) - 1, dtype=np.int64))
    if ftype == "bool":
        return True
    if ftype == "bytes":
        return rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
    if ftype == "str":
        return "".join(chr(c) for c in rng.integers(0x20, 0x7F, int(rng.integers(1, 12))))
    if ftype.startswith("list:"):
        return [_value(ftype[5:], rng) for _ in range(int(rng.integers(1, 4)))]
    if ftype.startswith("msg:"):
        return {name: _value(t, rng) for name, t in PORT[ftype[4:]].FIELDS}
    raise TypeError(ftype)


def _build(classes: dict[str, type], cls_name: str, values: dict):
    """An instance of ``classes[cls_name]`` from plain values."""
    fields = {}
    for name, ftype in classes[cls_name].FIELDS:
        if name not in values:
            continue
        fields[name] = _build_value(classes, ftype, values[name])
    return classes[cls_name](**fields)


def _build_value(classes, ftype, value):
    if ftype.startswith("list:"):
        return [_build_value(classes, ftype[5:], v) for v in value]
    if ftype.startswith("msg:"):
        return _build(classes, ftype[4:], value)
    return value


def _plain(msg) -> dict:
    out = {}
    for name, _ in msg.FIELDS:
        v = getattr(msg, name)
        out[name] = _plain_value(v)
    return out


def _plain_value(v):
    if isinstance(v, list):
        return [_plain_value(x) for x in v]
    if hasattr(v, "FIELDS"):
        return _plain(v)
    return v


def _check_both_ways(name: str, values: dict) -> bytes:
    port_msg, ref_msg = _build(PORT, name, values), _build(REF, name, values)
    body = port_msg.pack_body()
    assert body == ref_msg.pack_body()
    assert _plain(PORT[name].parse(ref_msg.pack_body())) == _plain(ref_msg)
    assert _plain(REF[name].parse(body)) == _plain(port_msg)
    if PORT[name].MSG_TYPE is not None:
        frame = framing.encode(port_msg)
        assert frame == ref_framing.encode(ref_msg)
        hdr = framing.HEADER.size
        assert _plain(framing.decode(PORT[name].MSG_TYPE, frame[hdr:])) == _plain(port_msg)
        assert _plain(ref_framing.decode(REF[name].MSG_TYPE, frame[hdr:])) == _plain(ref_msg)
    return body


def test_same_registry():
    assert sorted(PORT) == sorted(REF) and len(PORT) == 115
    assert {c.MSG_TYPE for c in PORT.values()} == {c.MSG_TYPE for c in REF.values()}
    for t in (c.MSG_TYPE for c in PORT.values() if c.MSG_TYPE is not None):
        assert codec.message_class_for(t).__name__ == ref_codec.message_class_for(t).__name__


@pytest.mark.parametrize("name", sorted(REF))
def test_message_packs_the_same_bytes(name):
    cls = PORT[name]
    assert cls.MSG_TYPE == REF[name].MSG_TYPE
    assert cls.FIELDS == REF[name].FIELDS
    assert cls.SKEW_TOLERANT_FROM == REF[name].SKEW_TOLERANT_FROM
    rng = np.random.default_rng(sum(name.encode()))
    values = {n: _value(t, rng) for n, t in cls.FIELDS}
    full = _check_both_ways(name, values)
    if cls.SKEW_TOLERANT_FROM is not None:
        # the optional tail left at its defaults: both encodings drop it
        head = {n: values[n] for n, _ in cls.FIELDS[: cls.SKEW_TOLERANT_FROM]}
        short = _check_both_ways(name, head)
        assert len(short) < len(full)


def _stream_frames():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    return [
        ("CltocsRead", dict(req_id=1, chunk_id=2**40 + 3, version=5, part_id=17, offset=0,
                            size=65536, trace_id=9, session_id=4)),
        ("CstoclReadData", dict(req_id=1, chunk_id=2**40 + 3, offset=0, crc=0xDEADBEEF,
                                data=data)),
        ("CstoclReadStatus", dict(req_id=1, chunk_id=2**40 + 3, status=0)),
        ("CltocsWriteEnd", dict(req_id=2, chunk_id=11)),
    ]


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_framing_round_trips_a_stream(writer_pkg):
    """Frames written by one package's ``send_message`` are read back by
    the other's ``read_message``, through a real socket pair."""
    frames = _stream_frames()
    send_mod, send_cls = (framing, PORT) if writer_pkg == "port" else (ref_framing, REF)
    recv_mod, recv_cls = (ref_framing, REF) if writer_pkg == "port" else (framing, PORT)

    async def run():
        got = []
        done = asyncio.Event()

        async def serve(reader, writer):
            for _ in frames:
                got.append(await recv_mod.read_message(reader))
            writer.close()
            done.set()

        server = await asyncio.start_server(serve, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for name, values in frames:
            await send_mod.send_message(writer, _build(send_cls, name, values))
        await asyncio.wait_for(done.wait(), 10)
        writer.close()
        server.close()
        await server.wait_closed()
        return got

    got = asyncio.run(run())
    assert [type(g).__name__ for g in got] == [n for n, _ in frames]
    for g, (name, values) in zip(got, frames):
        assert isinstance(g, recv_cls[name])
        assert _plain(g) == values
