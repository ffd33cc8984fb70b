"""Decompression / compression option dataclasses.

Mirrors the reference option structs:

- decompress options: ``/root/reference/src/decode/options.rs:1-43``
  (``unpacked_size`` mode, ``memlimit``, ``allow_incomplete``),
- compress options: ``/root/reference/src/encode/options.rs:1-30``.

The three decode-side ``UnpackedSize`` modes (including the non-standard
OpenCTM-style headerless payloads) are preserved exactly.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class _UnpackedSizeKind(enum.Enum):
    READ_FROM_HEADER = "read_from_header"
    READ_HEADER_BUT_USE_PROVIDED = "read_header_but_use_provided"
    USE_PROVIDED = "use_provided"


@dataclasses.dataclass(frozen=True)
class UnpackedSize:
    """How the unpacked size of decoded data is determined.

    Mirrors ``decompress::UnpackedSize`` (src/decode/options.rs:24-42):

    - ``UnpackedSize.read_from_header()``: read the 8-byte LE size from the
      header; ``0xFFFF_FFFF_FFFF_FFFF`` means an end-of-payload marker is
      expected instead.
    - ``UnpackedSize.read_header_but_use_provided(x)``: read (and discard)
      the 8 header bytes, then use ``x`` (``None`` = expect EOS marker).
    - ``UnpackedSize.use_provided(x)``: the header carries no size field;
      use ``x`` (``None`` = expect EOS marker).
    """

    kind: _UnpackedSizeKind = _UnpackedSizeKind.READ_FROM_HEADER
    value: Optional[int] = None

    @staticmethod
    def read_from_header() -> "UnpackedSize":
        return UnpackedSize(_UnpackedSizeKind.READ_FROM_HEADER, None)

    @staticmethod
    def read_header_but_use_provided(value: Optional[int]) -> "UnpackedSize":
        return UnpackedSize(_UnpackedSizeKind.READ_HEADER_BUT_USE_PROVIDED, value)

    @staticmethod
    def use_provided(value: Optional[int]) -> "UnpackedSize":
        return UnpackedSize(_UnpackedSizeKind.USE_PROVIDED, value)

    @property
    def reads_header_field(self) -> bool:
        return self.kind in (
            _UnpackedSizeKind.READ_FROM_HEADER,
            _UnpackedSizeKind.READ_HEADER_BUT_USE_PROVIDED,
        )


@dataclasses.dataclass(frozen=True)
class Options:
    """Decompression options (reference ``decompress::Options``).

    - ``unpacked_size``: see :class:`UnpackedSize`.
    - ``memlimit``: optional cap on the decoder dictionary/accumulation
      buffer, in bytes. Exceeding it raises ``LzmaError("exceeded memory
      limit of N")`` like the reference (src/decode/lzbuffer.rs:113-117).
    - ``allow_incomplete``: bypass end-of-stream validation in the streaming
      API (src/decode/options.rs:14-18).
    """

    unpacked_size: UnpackedSize = dataclasses.field(
        default_factory=UnpackedSize.read_from_header
    )
    memlimit: Optional[int] = None
    allow_incomplete: bool = False


class _WriteUnpackedSizeKind(enum.Enum):
    WRITE_TO_HEADER = "write_to_header"
    SKIP_WRITING_TO_HEADER = "skip_writing_to_header"


@dataclasses.dataclass(frozen=True)
class WriteUnpackedSize:
    """How the encoder records the unpacked size.

    Mirrors ``compress::UnpackedSize`` (src/encode/options.rs:9-24):

    - ``write_to_header(None)`` (default): write ``0xFFFF_FFFF_FFFF_FFFF``
      and terminate the payload with an end-of-stream marker.
    - ``write_to_header(n)``: write ``n``; no EOS marker is emitted.
    - ``skip_writing_to_header()``: omit the 8-byte field entirely
      (OpenCTM-style); an EOS marker terminates the payload.
    """

    kind: _WriteUnpackedSizeKind = _WriteUnpackedSizeKind.WRITE_TO_HEADER
    value: Optional[int] = None

    @staticmethod
    def write_to_header(value: Optional[int]) -> "WriteUnpackedSize":
        return WriteUnpackedSize(_WriteUnpackedSizeKind.WRITE_TO_HEADER, value)

    @staticmethod
    def skip_writing_to_header() -> "WriteUnpackedSize":
        return WriteUnpackedSize(_WriteUnpackedSizeKind.SKIP_WRITING_TO_HEADER, None)

    @property
    def writes_header_field(self) -> bool:
        return self.kind is _WriteUnpackedSizeKind.WRITE_TO_HEADER


@dataclasses.dataclass(frozen=True)
class CompressOptions:
    """Compression options (reference ``compress::Options``)."""

    unpacked_size: WriteUnpackedSize = dataclasses.field(
        default_factory=lambda: WriteUnpackedSize.write_to_header(None)
    )
