"""XDR (RFC 4506) encoding primitives for the ONC-RPC/NFS gateway.

Minimal by design: the NFS3/MOUNT3 wire structures only need big-endian
u32/u64, opaque byte strings padded to 4 bytes, and optional/list
combinators. Reference semantics: src/nfs-ganesha/ speaks these via
Ganesha's bundled XDR; here the codec is ~80 lines and allocation-light.
"""

from __future__ import annotations

import struct


class XdrError(Exception):
    pass


class Packer:
    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: list[bytes] = []

    def u32(self, v: int) -> "Packer":
        self._parts.append(struct.pack(">I", v & 0xFFFFFFFF))
        return self

    def i32(self, v: int) -> "Packer":
        self._parts.append(struct.pack(">i", v))
        return self

    def u64(self, v: int) -> "Packer":
        self._parts.append(struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF))
        return self

    def boolean(self, v: bool) -> "Packer":
        return self.u32(1 if v else 0)

    def opaque(self, data: bytes) -> "Packer":
        """Variable-length opaque: length + bytes + pad to 4."""
        self.u32(len(data))
        return self.fixed(data)

    def fixed(self, data: bytes) -> "Packer":
        """Fixed-length opaque: bytes + pad to 4 (length implied)."""
        self._parts.append(data)
        if len(data) % 4:
            self._parts.append(b"\x00" * (4 - len(data) % 4))
        return self

    def string(self, s: str) -> "Packer":
        return self.opaque(s.encode("utf-8", "surrogateescape"))

    def raw(self, data: bytes) -> "Packer":
        self._parts.append(data)
        return self

    def bytes(self) -> bytes:
        return b"".join(self._parts)


class Unpacker:
    __slots__ = ("_buf", "_pos")

    def __init__(self, buf: bytes) -> None:
        self._buf = buf
        self._pos = 0

    def _take(self, n: int) -> bytes:
        if self._pos + n > len(self._buf):
            raise XdrError(f"short XDR buffer: need {n} at {self._pos}")
        out = self._buf[self._pos : self._pos + n]
        self._pos += n
        return out

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u32() != 0

    def opaque(self, max_len: int = 1 << 26) -> bytes:
        n = self.u32()
        if n > max_len:
            raise XdrError(f"opaque too long: {n} > {max_len}")
        data = self._take(n)
        if n % 4:
            self._take(4 - n % 4)
        return data

    def fixed(self, n: int) -> bytes:
        data = self._take(n)
        if n % 4:
            self._take(4 - n % 4)
        return data

    def string(self, max_len: int = 4096) -> str:
        return self.opaque(max_len).decode("utf-8", "surrogateescape")

    def done(self) -> bool:
        return self._pos >= len(self._buf)

    def remaining(self) -> bytes:
        return self._buf[self._pos :]
