"""`.xz` container parsing and writing (host side).

Behavioral spec from the reference (`/root/reference/src/decode/xz.rs:18-464`,
`src/xz/{mod,header,footer}.rs`, `src/encode/xz.rs:9-162`):

- stream header: magic ``FD 37 7A 58 5A 00``, 2-byte stream flags
  (null + check method), CRC32 of the flags,
- block loop until a zero "header size" byte introduces the index,
- block header: size byte ``(hs << 2) - 1``, flags (num filters, reserved
  bits must be zero, optional packed/unpacked varints), filter chain (only
  0x21 = LZMA2 accepted), zero padding, CRC32,
- per-block check (None/CRC32/CRC64/SHA-256 all verified — SHA-256 is a
  documented superset: the reference rejects it, decode/xz.rs:326-330),
- index: record count + per-record unpadded/unpacked varints + padding +
  CRC32, all cross-checked against the decoded blocks,
- footer: CRC32 over backward_size + flags, backward_size must equal
  index_size, flags must match the header, magic ``59 5A`` ("YZ"), EOF.

Container parsing is sequential but trivial (tiny headers); the block
payloads it locates are handed to the decode runtime, which shards them
across lanes/devices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from lzma_rs_tpu_torch.utils.crc import crc32, crc64
from lzma_rs_tpu_torch.utils.cursor import ByteCursor, ByteWriter
from lzma_rs_tpu_torch.utils.errors import XzError
from lzma_rs_tpu_torch.utils import logging as log

XZ_MAGIC = bytes([0xFD, 0x37, 0x7A, 0x58, 0x5A, 0x00])
XZ_MAGIC_FOOTER = bytes([0x59, 0x5A])

# Check methods, xz/mod.rs:55-60.
CHECK_NONE = 0x00
CHECK_CRC32 = 0x01
CHECK_CRC64 = 0x04
CHECK_SHA256 = 0x0A
_VALID_CHECKS = (CHECK_NONE, CHECK_CRC32, CHECK_CRC64, CHECK_SHA256)

FILTER_LZMA2 = 0x21


def parse_check_method(id_: int) -> int:
    """Map a check id to CheckMethod, rejecting unknown ids (xz/mod.rs:55-73)."""
    if id_ not in _VALID_CHECKS:
        raise XzError(
            f"Invalid check method {id_:x}, expected one of [0x00, 0x01, 0x04, 0x0A]"
        )
    return id_


@dataclasses.dataclass(frozen=True)
class StreamFlags:
    """Stream flags (xz/mod.rs:18-49). Only the check method is meaningful."""

    check_method: int

    @staticmethod
    def parse(field: int) -> "StreamFlags":
        hi = (field >> 8) & 0xFF
        if hi != 0x00:
            raise XzError(f"Invalid null byte in Stream Flags: {hi:x}")
        return StreamFlags(check_method=parse_check_method(field & 0xFF))

    def serialize(self) -> bytes:
        return bytes([0x00, self.check_method])

    def _debug(self) -> str:
        # Rust Debug rendering used inside error strings
        # ("StreamFlags { check_method: Crc64 }").
        name = {
            CHECK_NONE: "None",
            CHECK_CRC32: "Crc32",
            CHECK_CRC64: "Crc64",
            CHECK_SHA256: "Sha256",
        }[self.check_method]
        return f"StreamFlags {{ check_method: {name} }}"


def get_multibyte(cursor: ByteCursor) -> int:
    """XZ varint: <=9 bytes x 7 bits (decode/xz.rs:448-464)."""
    result = 0
    for i in range(9):
        byte = cursor.read_u8()
        result ^= (byte & 0x7F) << (i * 7)
        if (byte & 0x80) == 0:
            return result
    raise XzError("Invalid multi-byte encoding")


def write_multibyte(writer: ByteWriter, value: int) -> None:
    """XZ varint writer (encode/xz.rs:146-162)."""
    while True:
        byte = value & 0x7F
        value >>= 7
        if value == 0:
            writer.write_u8(byte)
            return
        writer.write_u8(0x80 | byte)


def parse_stream_header(cursor: ByteCursor) -> StreamFlags:
    """Parse the 12-byte stream header (xz/header.rs:20-51)."""
    if not cursor.read_tag(XZ_MAGIC):
        raise XzError(f"Invalid XZ magic, expected {_rust_bytes(XZ_MAGIC)}")
    flags_bytes = bytes(cursor.read_exact(2))
    digest = crc32(flags_bytes)
    expected = cursor.read_u32_le()
    if expected != digest:
        raise XzError(
            f"Invalid header CRC32: expected 0x{expected:08x} but got 0x{digest:08x}"
        )
    return StreamFlags.parse(int.from_bytes(flags_bytes, "big"))


def _rust_bytes(b: bytes) -> str:
    """Render like Rust's Debug for &[u8] (used in reference error strings)."""
    return "[" + ", ".join(str(x) for x in b) + "]"


@dataclasses.dataclass
class Filter:
    filter_id: int
    props: bytes


@dataclasses.dataclass
class BlockHeader:
    filters: List[Filter]
    packed_size: Optional[int]
    unpacked_size: Optional[int]


@dataclasses.dataclass
class Record:
    """Per-block index record (decode/xz.rs:12-16)."""

    unpadded_size: int
    unpacked_size: int


@dataclasses.dataclass
class BlockInfo:
    """A located (not yet decoded) block: header + payload extent."""

    header: BlockHeader
    header_off: int  # offset of the header-size byte
    payload_off: int  # offset of the first filter-payload byte
    payload_end: Optional[int]  # known end (from packed_size) or None
    check_method: int


def read_block_header(cursor: ByteCursor, header_size: int) -> BlockHeader:
    """Parse a block header body (after the size byte), decode/xz.rs:356-446.

    ``header_size`` is the encoded byte count *excluding* the size byte and
    the trailing CRC32, i.e. ``(hs << 2) - 1``.
    """
    body = ByteCursor(cursor.read_exact(header_size))
    flags = body.read_u8()
    num_filters = (flags & 0x03) + 1
    reserved = flags & 0x3C
    if reserved != 0:
        raise XzError(
            f"Invalid block flags {flags}, reserved bits (mask 0x3C) must be zero"
        )
    packed_size = get_multibyte(body) if flags & 0x40 else None
    unpacked_size = get_multibyte(body) if flags & 0x80 else None

    filters: List[Filter] = []
    for _ in range(num_filters):
        filter_id = get_multibyte(body)
        if filter_id != FILTER_LZMA2:
            raise XzError(f"Unknown filter id {filter_id}")
        size_of_properties = get_multibyte(body)
        if size_of_properties > header_size:
            raise XzError(
                "Size of filter properties exceeds block header size "
                f"({size_of_properties} > {header_size})"
            )
        try:
            props = bytes(body.read_exact(size_of_properties))
        except Exception:
            raise XzError(
                f"Could not read filter properties of size {size_of_properties}: "
                "failed to fill whole buffer"
            ) from None
        filters.append(Filter(filter_id=filter_id, props=props))

    if not body.flush_zero_padding():
        raise XzError("Invalid block header padding, must be null bytes")

    return BlockHeader(
        filters=filters, packed_size=packed_size, unpacked_size=unpacked_size
    )


def read_block_header_at(cursor: ByteCursor) -> Optional[BlockInfo]:
    """Read one block header at the cursor; None when the index begins.

    Verifies the header CRC32 like the reference (decode/xz.rs:207-224).
    """
    header_off = cursor.pos
    header_size_byte = cursor.read_u8()
    if header_size_byte == 0:
        cursor.pos = header_off
        return None
    header_size = (header_size_byte << 2) - 1
    body_start = cursor.pos
    header = read_block_header(cursor, header_size)
    crc_input = bytes([header_size_byte]) + bytes(
        cursor.buf[body_start : body_start + header_size]
    )
    digest = crc32(crc_input)
    expected = cursor.read_u32_le()
    if expected != digest:
        raise XzError(
            f"Invalid header CRC32: expected 0x{expected:08x} but got 0x{digest:08x}"
        )
    payload_off = cursor.pos
    payload_end = (
        payload_off + header.packed_size if header.packed_size is not None else None
    )
    return BlockInfo(
        header=header,
        header_off=header_off,
        payload_off=payload_off,
        payload_end=payload_end,
        check_method=0,
    )


def check_size(check_method: int) -> int:
    """Stored size in bytes of a block check field (None=0, CRC32=4, CRC64=8, SHA-256=32)."""
    return {CHECK_NONE: 0, CHECK_CRC32: 4, CHECK_CRC64: 8, CHECK_SHA256: 32}[
        check_method
    ]


def validate_block_check(
    cursor: ByteCursor, decoded: bytes, check_method: int
) -> None:
    """Read and verify the block check field (decode/xz.rs:295-333)."""
    if check_method == CHECK_NONE:
        return
    if check_method == CHECK_CRC32:
        expected = cursor.read_u32_le()
        digest = crc32(decoded)
        if expected != digest:
            raise XzError(
                f"Invalid block CRC32, expected 0x{expected:08x} but got 0x{digest:08x}"
            )
        return
    if check_method == CHECK_CRC64:
        expected = int.from_bytes(cursor.read_exact(8), "little")
        digest = crc64(decoded)
        if expected != digest:
            raise XzError(
                f"Invalid block CRC64, expected 0x{expected:016x} but got "
                f"0x{digest:016x}"
            )
        return
    # SHA-256: the reference rejects it ("Unsupported SHA-256 checksum
    # (not yet implemented)", decode/xz.rs:326-330); we verify it.
    import hashlib

    expected_sha = bytes(cursor.read_exact(32))
    digest_sha = hashlib.sha256(decoded).digest()
    if expected_sha != digest_sha:
        raise XzError(
            f"Invalid block SHA-256, expected {expected_sha.hex()} but got "
            f"{digest_sha.hex()}"
        )


def padding_size(count: int) -> int:
    """Bytes of zero padding to reach 4-byte alignment (decode/xz.rs:140)."""
    return ((count ^ 0x03) + 1) & 0x03


def read_padding(cursor: ByteCursor, n: int, what: str) -> bytes:
    """Consume n alignment bytes, requiring zeros (decode/xz.rs:264-279)."""
    pad = bytes(cursor.read_exact(n))
    if any(pad):
        raise XzError(f"Invalid {what} padding, must be null bytes")
    return pad


def check_index(cursor: ByteCursor, records: List[Record]) -> int:
    """Verify the index against decoded-block records (decode/xz.rs:96-171).

    Returns the index size in bytes (including the leading zero tag, padding
    and CRC32). The cursor must be positioned at the index's zero tag.
    """
    start = cursor.pos
    tag = cursor.read_u8()
    assert tag == 0
    crc_start = start
    num_records = get_multibyte(cursor)
    if num_records != len(records):
        raise XzError(
            f"Expected {num_records} records but got {len(records)} records"
        )
    for i, record in enumerate(records):
        unpadded_size = get_multibyte(cursor)
        if unpadded_size != record.unpadded_size:
            raise XzError(
                f"Invalid index for record {i}: unpadded size "
                f"({record.unpadded_size}) does not match index ({unpadded_size})"
            )
        unpacked_size = get_multibyte(cursor)
        if unpacked_size != record.unpacked_size:
            raise XzError(
                f"Invalid index for record {i}: unpacked size "
                f"({record.unpacked_size}) does not match index ({unpacked_size})"
            )
    count = cursor.pos - start
    pad = padding_size(count)
    pad_bytes = bytes(cursor.read_exact(pad))
    if any(pad_bytes):
        raise XzError("Invalid index padding, must be null bytes")
    digest = crc32(bytes(cursor.buf[crc_start : cursor.pos]))
    expected = cursor.read_u32_le()
    if expected != digest:
        raise XzError(
            f"Invalid index CRC32: expected 0x{expected:08x} but got 0x{digest:08x}"
        )
    return cursor.pos - start


def check_footer(cursor: ByteCursor, header_flags: StreamFlags, index_size: int) -> None:
    """Verify the 12-byte stream footer (decode/xz.rs:47-93)."""
    expected_crc32 = cursor.read_u32_le()
    footer_body = bytes(cursor.read_exact(6))
    body = ByteCursor(footer_body)
    backward_size = body.read_u32_le()
    if index_size != (backward_size + 1) << 2:
        raise XzError(
            f"Invalid index size: expected {(backward_size + 1) << 2} but got "
            f"{index_size}"
        )
    stream_flags = StreamFlags.parse(body.read_u16_be())
    if header_flags != stream_flags:
        raise XzError(
            f"Flags in header ({header_flags._debug()}) does not match footer "
            f"({stream_flags._debug()})"
        )
    digest = crc32(footer_body)
    if expected_crc32 != digest:
        raise XzError(
            f"Invalid footer CRC32: expected 0x{expected_crc32:08x} but got "
            f"0x{digest:08x}"
        )
    if not cursor.read_tag(XZ_MAGIC_FOOTER):
        raise XzError(
            f"Invalid footer magic, expected {_rust_bytes(XZ_MAGIC_FOOTER)}"
        )
    if not cursor.is_eof():
        raise XzError("Unexpected data after last XZ block")


# ---------------------------------------------------------------------------
# Encoder side (multi-block writer; the reference writes exactly one block,
# encode/xz.rs:9-29 — we generalize so block-parallel *encode* falls out for
# free while staying spec-valid).
# ---------------------------------------------------------------------------


def write_stream_header(writer: ByteWriter, flags: StreamFlags) -> None:
    """Emit magic + stream flags + CRC32 (encode/xz.rs:31-44)."""
    writer.write(XZ_MAGIC)
    ser = flags.serialize()
    writer.write(ser)
    writer.write_u32_le(crc32(ser))


def write_block(
    writer: ByteWriter,
    payload: bytes,
    raw_data: bytes,
    check_method: int = CHECK_NONE,
) -> Record:
    """Write one block (header + payload + padding + check) and return its
    index record. Mirrors encode/xz.rs:67-112 (hard-coded 8-byte header:
    1 filter = LZMA2, props byte 22, no size fields). ``raw_data`` is the
    uncompressed content, used for the optional block check."""
    start = writer.count
    header = bytes(
        [
            8 >> 2,  # header_size byte
            0x00,  # flags: 1 filter, no sizes
            FILTER_LZMA2,
            0x01,  # size_of_properties
            22,  # props byte (dict size code), same fixed value as reference
            0,
            0,
            0,  # padding to 8 bytes
        ]
    )
    writer.write(header)
    writer.write_u32_le(crc32(header))
    writer.write(payload)
    unpadded = writer.count - start
    writer.write(b"\x00" * padding_size(unpadded))
    # The unpadded size in the index INCLUDES the check field
    # (xz spec 3.1; the reference counts it via count_input in
    # decode/xz.rs:283-286 because its writer emits CheckMethod::None only).
    if check_method == CHECK_CRC32:
        writer.write(crc32(raw_data).to_bytes(4, "little"))
        unpadded += 4
    elif check_method == CHECK_CRC64:
        writer.write(crc64(raw_data).to_bytes(8, "little"))
        unpadded += 8
    elif check_method == CHECK_SHA256:
        import hashlib

        writer.write(hashlib.sha256(raw_data).digest())
        unpadded += 32
    return Record(unpadded_size=unpadded, unpacked_size=len(raw_data))


def write_index(writer: ByteWriter, records: List[Record]) -> int:
    """Write the index (encode/xz.rs:114-144); returns its size."""
    start = writer.count
    body = ByteWriter()
    body.write_u8(0)
    write_multibyte(body, len(records))
    for rec in records:
        write_multibyte(body, rec.unpadded_size)
        write_multibyte(body, rec.unpacked_size)
    data = body.getvalue()
    pad = padding_size(len(data))
    data += b"\x00" * pad
    writer.write(data)
    writer.write_u32_le(crc32(data))
    return writer.count - start


def write_footer(writer: ByteWriter, flags: StreamFlags, index_size: int) -> None:
    """Emit CRC32(backward_size+flags) + backward_size + flags + YZ magic (encode/xz.rs:46-65)."""
    backward_size = (index_size >> 2) - 1
    body = backward_size.to_bytes(4, "little") + flags.serialize()
    writer.write_u32_le(crc32(body))
    writer.write(body)
    writer.write(XZ_MAGIC_FOOTER)
