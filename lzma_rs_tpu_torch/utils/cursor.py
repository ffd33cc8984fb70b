"""Byte-cursor helpers for host-side container parsing.

TPU-native equivalent of the reference's IO adapter layer
(``/root/reference/src/decode/util.rs:3-117``): instead of wrapping
``io::BufRead`` streams with counting/CRC taps, the host parser walks a
``memoryview`` with an explicit cursor; counted ranges and CRC taps become
explicit slices hashed after the fact. EOF semantics mirror Rust's
``read_exact`` ("failed to fill whole buffer").
"""

from __future__ import annotations

import struct

from lzma_rs_tpu_torch.utils.errors import IoError, UNEXPECTED_EOF


class ByteCursor:
    """A cursor over an immutable bytes buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes | bytearray | memoryview, pos: int = 0):
        self.buf = memoryview(data)
        self.pos = pos

    def remaining(self) -> int:
        return len(self.buf) - self.pos

    def is_eof(self) -> bool:
        return self.pos >= len(self.buf)

    def read_exact(self, n: int) -> memoryview:
        if self.remaining() < n:
            # Consume what's left, like Rust's read_exact leaves the reader
            # in an unspecified state; the error text matches std::io.
            self.pos = len(self.buf)
            raise IoError(UNEXPECTED_EOF)
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_u8(self) -> int:
        if self.remaining() < 1:
            raise IoError(UNEXPECTED_EOF)
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read_u16_be(self) -> int:
        return int.from_bytes(self.read_exact(2), "big")

    def read_u16_le(self) -> int:
        return int.from_bytes(self.read_exact(2), "little")

    def read_u32_be(self) -> int:
        return int.from_bytes(self.read_exact(4), "big")

    def read_u32_le(self) -> int:
        return int.from_bytes(self.read_exact(4), "little")

    def read_u64_le(self) -> int:
        return int.from_bytes(self.read_exact(8), "little")

    def read_tag(self, tag: bytes) -> bool:
        """Read len(tag) bytes and compare (src/decode/util.rs:3-7)."""
        return bytes(self.read_exact(len(tag))) == tag

    def peek_remaining(self) -> memoryview:
        return self.buf[self.pos :]

    def skip(self, n: int) -> None:
        if self.remaining() < n:
            raise IoError(UNEXPECTED_EOF)
        self.pos += n

    def flush_zero_padding(self) -> bool:
        """Consume the rest of the buffer; True iff all remaining bytes are
        zero (src/decode/util.rs:14-34)."""
        rest = self.buf[self.pos :]
        self.pos = len(self.buf)
        return not any(rest)


class ByteWriter:
    """An append-only byte sink with counting (mirrors CountWrite,
    src/encode/util.rs:41-77)."""

    __slots__ = ("_chunks", "_count")

    def __init__(self) -> None:
        self._chunks: list[bytes] = []
        self._count = 0

    def write(self, data: bytes) -> None:
        self._chunks.append(data)
        self._count += len(data)

    def write_u8(self, v: int) -> None:
        self.write(bytes([v]))

    def write_u16_be(self, v: int) -> None:
        self.write(struct.pack(">H", v))

    def write_u32_le(self, v: int) -> None:
        self.write(struct.pack("<I", v))

    def write_u64_le(self, v: int) -> None:
        self.write(struct.pack("<Q", v))

    @property
    def count(self) -> int:
        return self._count

    def getvalue(self) -> bytes:
        return b"".join(self._chunks)
