"""Declarative binary message codec.

The reference generates typed big-endian serializers for every message
with macro magic (reference: src/common/serialization.h,
serialization_macros.h:82-140). Here the same idea is a dataclass-like
metaclass: a message declares ``FIELDS`` as (name, type) pairs and gets
``pack``/``unpack`` plus equality for free.

Field type language:
  u8 u16 u32 u64 i32 i64      big-endian scalars
  bool                        one byte
  bytes                       u32 length-prefixed byte string
  str                         u32 length-prefixed utf-8 string
  list:<type>                 u32 count-prefixed homogeneous list
  msg:<ClassName>             nested message (class must be registered)

Messages are versioned at the framing layer (see framing.py), matching
the reference's LIZ packet version field (src/protocol/packet.h:29-43).
"""

from __future__ import annotations

import struct
from typing import Any

_SCALARS = {
    "u8": ">B",
    "u16": ">H",
    "u32": ">I",
    "u64": ">Q",
    "i32": ">i",
    "i64": ">q",
    "bool": ">?",
}

_MESSAGE_CLASSES: dict[str, type] = {}
_TYPE_REGISTRY: dict[int, type] = {}


def _pack_value(ftype: str, value: Any, out: bytearray) -> None:
    if ftype in _SCALARS:
        out += struct.pack(_SCALARS[ftype], value)
    elif ftype == "bytes":
        b = bytes(value)
        out += struct.pack(">I", len(b))
        out += b
    elif ftype == "str":
        b = str(value).encode("utf-8")
        out += struct.pack(">I", len(b))
        out += b
    elif ftype.startswith("list:"):
        inner = ftype[5:]
        out += struct.pack(">I", len(value))
        for item in value:
            _pack_value(inner, item, out)
    elif ftype.startswith("msg:"):
        cls = _MESSAGE_CLASSES[ftype[4:]]
        out += value.pack_body()
    else:
        raise TypeError(f"unknown field type {ftype!r}")


def _default_value(ftype: str) -> Any:
    """Zero value of a field type — what a peer that predates the field
    would have meant. Used to default-fill trailing fields missing from
    a version-skewed sender's encoding (see Message.unpack_body)."""
    if ftype in _SCALARS:
        return False if ftype == "bool" else 0
    if ftype == "bytes":
        return b""
    if ftype == "str":
        return ""
    if ftype.startswith("list:"):
        return []
    if ftype.startswith("msg:"):
        cls = _MESSAGE_CLASSES[ftype[4:]]
        return cls(**{n: _default_value(t) for n, t in cls.FIELDS})
    raise TypeError(f"unknown field type {ftype!r}")


def _unpack_value(ftype: str, buf: memoryview, off: int) -> tuple[Any, int]:
    if ftype in _SCALARS:
        fmt = _SCALARS[ftype]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, off)[0], off + size
    if ftype == "bytes":
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        return bytes(buf[off : off + n]), off + n
    if ftype == "str":
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        return bytes(buf[off : off + n]).decode("utf-8"), off + n
    if ftype.startswith("list:"):
        inner = ftype[5:]
        (n,) = struct.unpack_from(">I", buf, off)
        off += 4
        items = []
        for _ in range(n):
            item, off = _unpack_value(inner, buf, off)
            items.append(item)
        return items, off
    if ftype.startswith("msg:"):
        cls = _MESSAGE_CLASSES[ftype[4:]]
        return cls.unpack_body(buf, off)
    raise TypeError(f"unknown field type {ftype!r}")


def _tail_elides(cls) -> bool:
    """Does this message's encoding have a skew-variable length (its
    own optional tail, or transitively via a terminal nested message)?"""
    if cls.SKEW_TOLERANT_FROM is not None:
        return True
    if cls.FIELDS:
        _, ftype = cls.FIELDS[-1]
        if ftype.startswith("msg:"):
            inner = _MESSAGE_CLASSES.get(ftype[4:])
            return inner is not None and _tail_elides(inner)
    return False


def _nested_msg_refs(cls):
    """Yield (inner class name, is_nonterminal) for every nested-message
    field; list elements are never buffer-terminal."""
    for i, (_, ftype) in enumerate(cls.FIELDS):
        if ftype.startswith("list:msg:"):
            yield ftype[9:], True
        elif ftype.startswith("msg:"):
            yield ftype[4:], i != len(cls.FIELDS) - 1


def _check_skew_nesting(cls) -> None:
    for inner_name, nonterminal in _nested_msg_refs(cls):
        inner = _MESSAGE_CLASSES.get(inner_name)
        if inner is not None and nonterminal and _tail_elides(inner):
            raise TypeError(
                f"{cls.__name__}: skew-tolerant {inner_name} may only be "
                "nested as the final field (its optional tail elides)"
            )
    if _tail_elides(cls):
        # the other definition order: this class just became
        # variable-length; nobody may already nest it non-terminally
        for other in _MESSAGE_CLASSES.values():
            for inner_name, nonterminal in _nested_msg_refs(other):
                if inner_name == cls.__name__ and nonterminal:
                    raise TypeError(
                        f"{other.__name__} nests skew-tolerant "
                        f"{cls.__name__} non-terminally"
                    )


class Message:
    """Base class; subclasses define MSG_TYPE (int or None) and FIELDS."""

    MSG_TYPE: int | None = None
    FIELDS: tuple[tuple[str, str], ...] = ()
    # opt-in version-skew tolerance: the index of the first OPTIONAL
    # field — fields from this index on default-fill when the wire ends
    # before them (an older peer predating the additions); everything
    # before it stays required. STRICTLY opt-in per message and scoped
    # to the genuinely-additive suffix: blanket tolerance would fail
    # OPEN — e.g. a truncated CstoclWriteStatus would decode its
    # missing ``status`` u8 as 0 == OK and report a write committed
    # that no server ever acknowledged, and a reply cut before a
    # verdict-bearing v0 field must still be a parse error, not a
    # zero. None (default) = every field required.
    SKEW_TOLERANT_FROM: int | None = None
    # fast path for data-plane messages: when FIELDS is all scalars plus
    # optionally one trailing ``bytes`` field, the scalar prefix packs/
    # unpacks as one struct call (per-64KiB-piece overhead matters)
    _FAST: struct.Struct | None = None
    _FAST_NAMES: tuple[str, ...] = ()
    _FAST_TAIL: str | None = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        # skew-nesting guard (registration-time, zero hot-path cost):
        # pack_body elides default-valued optional trailing fields, so
        # a message with a skew-variable tail has no fixed encoded
        # length — it may only be nested as the LAST field of its
        # container (where the decoder's off==len(buf) default-fill
        # applies). Nesting one non-terminally (or in a list) would
        # silently misalign every field after it; fail the class
        # definition instead.
        _check_skew_nesting(cls)
        _MESSAGE_CLASSES[cls.__name__] = cls
        if cls.MSG_TYPE is not None:
            existing = _TYPE_REGISTRY.get(cls.MSG_TYPE)
            if existing is not None and existing.__name__ != cls.__name__:
                raise TypeError(
                    f"duplicate MSG_TYPE {cls.MSG_TYPE}: "
                    f"{existing.__name__} vs {cls.__name__}"
                )
            _TYPE_REGISTRY[cls.MSG_TYPE] = cls
        fmt = ">"
        names = []
        tail = None
        for i, (name, ftype) in enumerate(cls.FIELDS):
            if ftype in _SCALARS:
                fmt += _SCALARS[ftype][1:]
                names.append(name)
            elif ftype == "bytes" and i == len(cls.FIELDS) - 1:
                tail = name
            else:
                return  # generic path only
        cls._FAST = struct.Struct(fmt)
        cls._FAST_NAMES = tuple(names)
        cls._FAST_TAIL = tail

    def __init__(self, **kwargs):
        optional_from = self.SKEW_TOLERANT_FROM
        for i, (name, ftype) in enumerate(self.FIELDS):
            if name not in kwargs:
                if optional_from is not None and i >= optional_from:
                    # optional-on-the-wire fields are optional in the
                    # constructor too: call sites predating an additive
                    # trailing field keep working (same zero the decoder
                    # would fill for a skewed peer)
                    setattr(self, name, _default_value(ftype))
                    continue
                raise TypeError(f"{type(self).__name__} missing field {name!r}")
            setattr(self, name, kwargs.pop(name))
        if kwargs:
            raise TypeError(f"{type(self).__name__} unknown fields {sorted(kwargs)}")

    def pack_body(self) -> bytes:
        # canonical skew-friendly encoding: OPTIONAL trailing fields
        # still holding their default are not emitted at all, so a
        # message whose additive suffix is unused stays byte-identical
        # to the pre-addition encoding — a new sender interoperates
        # with old receivers (whose parse would reject trailing bytes)
        # unless it actually USES a new field
        n_emit = len(self.FIELDS)
        if self.SKEW_TOLERANT_FROM is not None:
            while (
                n_emit > self.SKEW_TOLERANT_FROM
                and self._field_is_default(n_emit - 1)
            ):
                n_emit -= 1
        if self._FAST is not None and n_emit == len(self.FIELDS):
            head = self._FAST.pack(
                *(getattr(self, n) for n in self._FAST_NAMES)
            )
            if self._FAST_TAIL is None:
                return head
            tail = bytes(getattr(self, self._FAST_TAIL))
            return head + struct.pack(">I", len(tail)) + tail
        out = bytearray()
        for name, ftype in self.FIELDS[:n_emit]:
            _pack_value(ftype, getattr(self, name), out)
        return bytes(out)

    def _field_is_default(self, i: int) -> bool:
        name, ftype = self.FIELDS[i]
        return getattr(self, name) == _default_value(ftype)

    @classmethod
    def unpack_body(cls, buf: memoryview | bytes, off: int = 0):
        optional_from = cls.SKEW_TOLERANT_FROM
        if cls._FAST is not None and (
            optional_from is None or len(buf) - off >= cls._FAST.size
        ):
            msg = cls.__new__(cls)
            for name, value in zip(
                cls._FAST_NAMES, cls._FAST.unpack_from(buf, off)
            ):
                setattr(msg, name, value)
            off += cls._FAST.size
            if cls._FAST_TAIL is not None:
                if (
                    off == len(buf)
                    and optional_from is not None
                    and optional_from <= len(cls.FIELDS) - 1
                ):
                    # sender predates the tail field: default-fill
                    setattr(msg, cls._FAST_TAIL, b"")
                else:
                    (n,) = struct.unpack_from(">I", buf, off)
                    off += 4
                    setattr(msg, cls._FAST_TAIL, bytes(buf[off : off + n]))
                    off += n
            return msg, off
        buf = memoryview(buf)
        values = {}
        for i, (name, ftype) in enumerate(cls.FIELDS):
            if (
                off == len(buf)
                and optional_from is not None
                and i >= optional_from
            ):
                # version skew: the sender's schema ends here — newer
                # trailing fields default-fill instead of failing the
                # whole parse (a rolling upgrade would otherwise break
                # e.g. CltomaIoLimitRequest on its new `probe` field).
                # A REQUIRED field missing, or a field CUT MID-VALUE,
                # still raises: that is truncation/corruption, not skew.
                values[name] = _default_value(ftype)
            else:
                values[name], off = _unpack_value(ftype, buf, off)
        return cls(**values), off

    @classmethod
    def parse(cls, payload: bytes):
        msg, off = cls.unpack_body(payload)
        if off != len(payload):
            raise ValueError(
                f"{cls.__name__}: trailing {len(payload) - off} bytes"
            )
        return msg

    def __eq__(self, other):
        return type(self) is type(other) and all(
            getattr(self, n) == getattr(other, n) for n, _ in self.FIELDS
        )

    def __repr__(self):
        fields = ", ".join(
            f"{n}={_short(getattr(self, n))!r}" for n, _ in self.FIELDS
        )
        return f"{type(self).__name__}({fields})"


def _short(v):
    if isinstance(v, (bytes, bytearray)) and len(v) > 16:
        return v[:16] + b"..."
    return v


def message_class_for(msg_type: int) -> type[Message]:
    try:
        return _TYPE_REGISTRY[msg_type]
    except KeyError:
        raise KeyError(f"unknown message type {msg_type}") from None
