"""Host-side (scalar) LZMA / LZMA2 / XZ decoders built on the executable spec.

These mirror the reference's sequential decode paths exactly (outputs and
error strings) and serve as (a) the oracle for the TPU kernels, (b) the
fallback for inputs that cannot use the parallel runtime (e.g. raw LZMA with
``lc+lp > 4``), and (c) the engine behind the push-style streaming API.

Reference call stacks being mirrored:
- ``lzma_decompress``: src/lib.rs:44-60 -> decode/lzma.rs:635-648
- ``lzma2_decompress``: src/lib.rs:82-88 -> decode/lzma2.rs:52-82
- ``xz_decompress``: src/lib.rs:100-105 -> decode/xz.rs:18-94
"""

from __future__ import annotations

from typing import Optional

from lzma_rs_tpu_torch.formats import lzma2 as lzma2_fmt
from lzma_rs_tpu_torch.formats import xz as xz_fmt
from lzma_rs_tpu_torch.formats.lzma_header import LzmaParams, LzmaProperties, parse_props_byte
from lzma_rs_tpu_torch.models.spec import (
    AccumBuffer,
    CircularBuffer,
    DecoderState,
    RangeDecoder,
)
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError, XzError


#: Sentinel for ``LzmaDecoder.reset``: keep the current unpacked size
#: (the reference's outer ``None`` in ``Option<Option<u64>>``,
#: decode/lzma.rs:624-631).
KEEP_UNPACKED_SIZE = object()


class LzmaDecoder:
    """Raw LZMA decoder (reference ``LzmaDecoder``, decode/lzma.rs:595-649)."""

    def __init__(self, params: LzmaParams, memlimit: Optional[int] = None):
        self.params = params
        self.memlimit = memlimit
        self.state = DecoderState(params.properties, params.unpacked_size)

    def reset(self, unpacked_size=KEEP_UNPACKED_SIZE) -> None:
        """Reuse allocations for a fresh stream; optionally override the
        expected unpacked size (lzma.rs:624-631 reset(Option<Option<u64>>))."""
        """Reset to a freshly-initialized state (decode/lzma.rs:625-631).

        ``unpacked_size`` mirrors the reference's ``Option<Option<u64>>``:
        pass nothing (``KEEP_UNPACKED_SIZE``) to keep the old value
        (reference ``None``), ``None`` to mark the size unknown / EOS-
        terminated (reference ``Some(None)``), or an int to replace it
        (reference ``Some(Some(n))``).
        """
        self.state.reset_state(self.params.properties)
        if unpacked_size is not KEEP_UNPACKED_SIZE:
            self.state.set_unpacked_size(unpacked_size)

    def decompress(self, cursor: ByteCursor) -> bytes:
        """Decode one raw-LZMA payload to completion (lzma.rs:635-648)."""
        output = CircularBuffer(self.params.dict_size, self.memlimit)
        try:
            rc = RangeDecoder.new(cursor.buf, pos=cursor.pos)
        except IoError as e:
            raise LzmaError(f"LZMA stream too short: {e.message}") from None
        self.state.process(output, rc)
        cursor.pos = rc.pos
        return output.finish()


class Lzma2Decoder:
    """Raw LZMA2 decoder (reference ``Lzma2Decoder``, decode/lzma2.rs:11-230)."""

    def __init__(self) -> None:
        self.state = DecoderState(LzmaProperties(0, 0, 0), None)

    def reset(self) -> None:
        """Fresh LZMA2 chunk-stream state (lzma2.rs:41-48)."""
        self.state.reset_state(LzmaProperties(0, 0, 0))

    def decompress(self, cursor: ByteCursor) -> bytes:
        """Decode an LZMA2 chunk stream to its terminator (lzma2.rs:59-78)."""
        accum = AccumBuffer()
        while True:
            try:
                control = cursor.read_u8()
            except IoError as e:
                raise LzmaError(f"LZMA2 expected new status: {e.message}") from None
            if control == 0:
                break
            elif control in (1, 2):
                self._parse_uncompressed(accum, cursor, reset_dict=(control == 1))
            else:
                self._parse_lzma(accum, cursor, control)
        return accum.finish()

    def _parse_lzma(self, accum: AccumBuffer, cursor: ByteCursor, status: int) -> None:
        if status & 0x80 == 0:
            raise LzmaError(
                f"LZMA2 invalid status {status}, must be 0, 1, 2 or >= 128"
            )
        reset_mode = (status >> 5) & 0x3
        reset_dict = reset_mode == 3
        reset_state = reset_mode >= 1
        reset_props = reset_mode >= 2

        try:
            unpacked_size = cursor.read_u16_be()
        except IoError as e:
            raise LzmaError(f"LZMA2 expected unpacked size: {e.message}") from None
        unpacked_size = (((status & 0x1F) << 16) | unpacked_size) + 1
        try:
            packed_size = cursor.read_u16_be() + 1
        except IoError as e:
            raise LzmaError(f"LZMA2 expected packed size: {e.message}") from None

        if reset_dict:
            accum.reset()

        if reset_state:
            if reset_props:
                try:
                    props_byte = cursor.read_u8()
                except IoError as e:
                    raise LzmaError(
                        f"LZMA2 expected new properties: {e.message}"
                    ) from None
                new_props = parse_props_byte(props_byte, context="LZMA2")
                if new_props.lc + new_props.lp > 4:
                    raise LzmaError(
                        f"LZMA2 invalid properties: lc + lp ({new_props.lc} + "
                        f"{new_props.lp}) must be <= 4"
                    )
            else:
                new_props = self.state.props
            self.state.reset_state(new_props)

        self.state.set_unpacked_size(unpacked_size + accum.len)

        end = min(cursor.pos + packed_size, len(cursor.buf))
        try:
            rc = RangeDecoder.new(cursor.buf, pos=cursor.pos, end=end)
        except IoError as e:
            raise LzmaError(f"LZMA input too short: {e.message}") from None
        self.state.process(accum, rc)
        cursor.pos = rc.pos

    @staticmethod
    def _parse_uncompressed(
        accum: AccumBuffer, cursor: ByteCursor, reset_dict: bool
    ) -> None:
        try:
            unpacked_size = cursor.read_u16_be() + 1
        except IoError as e:
            raise LzmaError(f"LZMA2 expected unpacked size: {e.message}") from None
        if reset_dict:
            accum.reset()
        try:
            data = cursor.read_exact(unpacked_size)
        except IoError as e:
            raise LzmaError(
                f"LZMA2 expected {unpacked_size} uncompressed bytes: {e.message}"
            ) from None
        accum.append_bytes(data)


def xz_decode_stream(cursor: ByteCursor, decode_lzma2=None) -> bytes:
    """Sequential `.xz` stream decode (decode/xz.rs:18-94).

    ``decode_lzma2`` may override the LZMA2 payload decoder (the parallel
    runtime passes its TPU path); it receives the cursor positioned at the
    payload and must consume exactly the payload bytes, returning the
    decompressed block content.
    """
    header_flags = xz_fmt.parse_stream_header(cursor)
    records = []
    out = bytearray()

    while True:
        block_start = cursor.pos
        header_size_byte = cursor.read_u8()
        if header_size_byte == 0:
            index_start = cursor.pos - 1
            cursor.pos = index_start
            index_size = xz_fmt.check_index(cursor, records)
            break
        cursor.pos = block_start
        info = xz_fmt.read_block_header_at(cursor)
        assert info is not None

        # Decode the filter chain. Only LZMA2 is accepted (enforced during
        # header parse); filters beyond the first would re-filter the buffer
        # (decode/xz.rs:226-250) but only one LZMA2 filter can ever appear.
        filt = info.header.filters[0]
        if len(filt.props) != 1:
            raise XzError("Invalid properties for filter Lzma2")
        payload_start = cursor.pos
        if decode_lzma2 is not None:
            decoded = decode_lzma2(cursor)
        else:
            decoded = Lzma2Decoder().decompress(cursor)
        packed_size = cursor.pos - payload_start
        if info.header.packed_size is not None and packed_size != info.header.packed_size:
            raise XzError(
                f"Invalid compressed size: expected {info.header.packed_size} "
                f"but got {packed_size}"
            )
        if (
            info.header.unpacked_size is not None
            and len(decoded) != info.header.unpacked_size
        ):
            raise XzError(
                f"Invalid decompressed size: expected {info.header.unpacked_size} "
                f"but got {len(decoded)}"
            )

        count = cursor.pos - block_start
        pad = xz_fmt.padding_size(count)
        xz_fmt.read_padding(cursor, pad, "block")
        xz_fmt.validate_block_check(cursor, decoded, header_flags.check_method)
        out += decoded
        records.append(
            xz_fmt.Record(
                unpadded_size=cursor.pos - block_start - pad,
                unpacked_size=len(decoded),
            )
        )

    xz_fmt.check_footer(cursor, header_flags, index_size)
    return bytes(out)
