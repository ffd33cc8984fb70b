"""Literal-only LZMA encoder.

Capability mirror of the reference "dumb" encoder
(``/root/reference/src/encode/dumbencoder.rs:6-140``): every input byte is
coded as a literal with hard-coded properties ``lc=3, lp=0, pb=2``, dict
size ``0x0080_0000``, 8 literal contexts (``prev_byte >> 5``), and an
optional end-of-stream marker (match with distance 0xFFFF_FFFF) when the
header does not carry the unpacked size. Output is byte-identical-decodable
by any LZMA decoder.

A real match-finding encoder is a stretch goal tracked for a later round;
compressed-size parity with the reference is already met because the
reference's own xz/LZMA2 writers emit uncompressed chunks only.
"""

from __future__ import annotations

from lzma_rs_tpu_torch.encode.rangecoder import RangeEncoder, fresh_probs
from lzma_rs_tpu_torch.formats.lzma_header import LzmaProperties, serialize_header
from lzma_rs_tpu_torch.utils.options import CompressOptions

LC = 3
LP = 0
PB = 2
DICT_SIZE = 0x0080_0000


def lzma_compress(data: bytes, options: CompressOptions | None = None) -> bytes:
    """Encode raw LZMA: 13-byte header + range-coded payload (lib.rs:64-79)."""
    options = options or CompressOptions()
    mode = options.unpacked_size

    header = serialize_header(
        LzmaProperties(LC, LP, PB),
        DICT_SIZE,
        mode.value,
        write_size_field=mode.writes_header_field,
    )

    write_eos = mode.writes_header_field and mode.value is None
    # Fast path: native range encoder (bit-identical to the Python one).
    try:
        from lzma_rs_tpu_torch.native import loader

        lib = loader.load()
    except Exception:
        lib = None
    if lib is not None:
        return header + lib.lzma_encode_body(bytes(data), write_eos)

    rc = RangeEncoder()
    literal_probs = fresh_probs(8 * 0x300)  # [prev_byte >> 5][0x300]
    is_match = fresh_probs(4)  # pos_state contexts (pb=2)

    prev_byte = 0
    input_len = 0
    for out_len, byte in enumerate(data):
        pos_state = out_len & 3
        input_len = out_len
        rc.encode_bit(is_match, pos_state, False)
        _encode_literal(rc, literal_probs, byte, prev_byte)
        prev_byte = byte

    _finish(rc, is_match, mode, input_len + 1)
    return header + rc.finish()


def _encode_literal(rc: RangeEncoder, literal_probs, byte: int, prev_byte: int) -> None:
    result = 1
    lit_state = prev_byte >> 5
    base = lit_state * 0x300
    for i in range(8):
        bit = (byte >> (7 - i)) & 1
        rc.encode_bit(literal_probs, base + result, bool(bit))
        result = (result << 1) ^ bit


def _finish(rc: RangeEncoder, is_match, mode, input_len: int) -> None:
    # EOS marker only when the header says "unknown size"
    # (dumbencoder.rs:87-123).
    if mode.writes_header_field and mode.value is None:
        pos_state = input_len & 3
        rc.encode_bit(is_match, pos_state, True)
        scratch = fresh_probs(1)
        # is_rep = 0 (new distance)
        scratch[0] = 0x400
        rc.encode_bit(scratch, 0, False)
        # len = 0 (choice=0 + 3 low-tree bits of 0)
        for _ in range(4):
            scratch[0] = 0x400
            rc.encode_bit(scratch, 0, False)
        # pos_slot = 63 (6 one-bits), then 30 direct/align one-bits
        # -> distance field 0xFFFF_FFFF
        for _ in range(6):
            scratch[0] = 0x400
            rc.encode_bit(scratch, 0, True)
        for _ in range(30):
            scratch[0] = 0x400
            rc.encode_bit(scratch, 0, True)
