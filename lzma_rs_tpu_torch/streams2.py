"""Chunk-granular streaming decoders for LZMA2 and `.xz`.

A capability beyond the reference, which only streams raw LZMA
(``/root/reference/src/decode/stream.rs``). The reference's raw-LZMA
streaming needs a 20-byte dry-run buffer because a symbol decode is not
restartable mid-way (``/root/reference/src/decode/lzma.rs:403-419``);
LZMA2 and `.xz` layer framing on top whose headers carry exact sizes, so
the natural streaming granule is a *chunk* (<= 64 KiB packed + 6-byte
header) / container section — buffer until a framing unit is complete,
then decode it whole. Probability model, dictionary, and rep distances
persist across chunks through the native incremental decoder
(``lrt_l2stream_*``) or a pure-Python spec engine.

API mirrors ``Stream``: ``write(bytes) -> consumed``, ``finish() ->
bytes``; an optional sink receives output as chunks finalize; a failed
write poisons the stream.
"""

from __future__ import annotations

from typing import Optional

from lzma_rs_tpu_torch.formats import xz as xz_fmt
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError, XzError

_EOF = "failed to fill whole buffer"


class _NativeL2:
    def __init__(self, lib):
        self.lib = lib
        self.handle = lib.l2stream_new()

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.l2stream_delete(self.handle)
                self.handle = None
        except Exception:
            pass

    def chunk(self, payload, kind, unpacked, reset_mode, props):
        self.lib.l2stream_chunk(
            self.handle, payload, kind, unpacked, reset_mode,
            -1 if props is None else props,
        )

    def take(self) -> bytes:
        return self.lib.l2stream_take(self.handle)


class _SpecL2:
    """Pure-Python incremental LZMA2 engine (mirror of the C++ handle)."""

    def __init__(self):
        from lzma_rs_tpu_torch.formats.lzma_header import LzmaProperties
        from lzma_rs_tpu_torch.models.spec import AccumBuffer, DecoderState

        self.state = DecoderState(LzmaProperties(0, 0, 0), None)
        self.accum = AccumBuffer()
        self._taken = 0
        self._props = LzmaProperties(0, 0, 0)

    def chunk(self, payload, kind, unpacked, reset_mode, props):
        from lzma_rs_tpu_torch.formats.lzma_header import LzmaProperties
        from lzma_rs_tpu_torch.models.spec import RangeDecoder

        if kind == 1:
            if reset_mode:
                self.accum.reset()
            self.accum.append_bytes(payload)
            return
        if reset_mode == 3:
            self.accum.reset()
        if reset_mode >= 1:
            if reset_mode >= 2:
                if props is None or props >= 225:
                    raise LzmaError(
                        f"LZMA2 invalid properties: {props} must be < 225"
                    )
                lc = props % 9
                rem = props // 9
                lp = rem % 5
                pb = rem // 5
                if lc + lp > 4:
                    raise LzmaError(
                        f"LZMA2 invalid properties: lc + lp ({lc} + {lp})"
                        " must be <= 4"
                    )
                self._props = LzmaProperties(lc, lp, pb)
            self.state.reset_state(self._props)
        # unpacked_size counts bytes since the dict reset (accum.len)
        self.state.set_unpacked_size(unpacked + self.accum.len)
        rc = RangeDecoder.new(payload)
        self.state.process(self.accum, rc)

    def take(self) -> bytes:
        total = bytes(self.accum.flushed) + bytes(self.accum.buf)
        new = total[self._taken:]
        self._taken = len(total)
        return new


def _make_engine():
    try:
        from lzma_rs_tpu_torch.native import loader

        lib = loader.load()
    except Exception:
        lib = None
    return _NativeL2(lib) if lib is not None else _SpecL2()


class Lzma2Stream:
    """Push-style LZMA2 decompressor (chunk-granular)."""

    def __init__(self, output=None):
        self.sink = output
        self.buf = bytearray()
        self.engine = _make_engine()
        self.finished = False
        self.poisoned = False
        self._accum = bytearray()

    def _push_out(self, data: bytes) -> None:
        if not data:
            return
        if self.sink is not None:
            self.sink.write(data)
        else:
            self._accum += data

    def _drain(self) -> None:
        while True:
            if self.finished:
                # leave trailing bytes buffered: the xz layer reclaims
                # them (block padding / check); standalone finish() flags
                return
            if not self.buf:
                return
            control = self.buf[0]
            if control == 0:
                del self.buf[:1]
                self.finished = True
                continue
            if control in (1, 2):
                if len(self.buf) < 3:
                    return
                unpacked = ((self.buf[1] << 8) | self.buf[2]) + 1
                total = 3 + unpacked
                if len(self.buf) < total:
                    return
                payload = bytes(self.buf[3:total])
                del self.buf[:total]
                self.engine.chunk(payload, 1, unpacked,
                                  1 if control == 1 else 0, None)
                self._push_out(self.engine.take())
                continue
            if control < 0x80:
                raise LzmaError(
                    f"LZMA2 invalid status {control}, "
                    "must be 0, 1, 2 or >= 128"
                )
            reset_mode = (control >> 5) & 0x3
            hdr = 5 + (1 if reset_mode >= 2 else 0)
            if len(self.buf) < hdr:
                return
            unpacked = (((control & 0x1F) << 16)
                        | (self.buf[1] << 8) | self.buf[2]) + 1
            packed = ((self.buf[3] << 8) | self.buf[4]) + 1
            props = self.buf[5] if reset_mode >= 2 else None
            total = hdr + packed
            if len(self.buf) < total:
                return
            payload = bytes(self.buf[hdr:total])
            del self.buf[:total]
            self.engine.chunk(payload, 0, unpacked, reset_mode, props)
            self._push_out(self.engine.take())

    def write(self, data) -> int:
        """Feed compressed bytes; complete chunks/blocks decode eagerly.
        Returns len(data) (framing is buffered, never rejected early)."""
        data = bytes(data)
        if self.poisoned:
            raise LzmaError(
                "can't finish stream because of previous write error"
            )
        self.buf += data
        try:
            self._drain()
        except Exception:
            self.poisoned = True
            raise
        return len(data)

    def get_output(self) -> Optional[bytes]:
        """Bytes decoded so far (None when poisoned or sink-attached)."""
        if self.poisoned or self.sink is not None:
            return None
        return bytes(self._accum)

    def finish(self) -> bytes:
        """Validate the LZMA2 terminator and return all decoded bytes."""
        if self.poisoned:
            raise LzmaError(
                "can't finish stream because of previous write error"
            )
        if not self.finished:
            what = "new status" if not self.buf else "chunk data"
            raise LzmaError(f"LZMA2 expected {what}: {_EOF}")
        if self.buf:
            raise LzmaError(
                "LZMA2 data found after the end-of-stream marker"
            )
        return bytes(self._accum)


class XzStream:
    """Push-style `.xz` decompressor: streams block payloads chunk-wise,
    verifies each block's check as output finalizes, then validates the
    index and footer — all without buffering the whole archive."""

    _HEADER = 0
    _BLOCK_OR_INDEX = 1
    _BLOCK_PAYLOAD = 2
    _PADDING_CHECK = 3
    _INDEX_FOOTER = 4
    _DONE = 5

    def __init__(self, output=None):
        self.sink = output
        self.buf = bytearray()
        self.state = self._HEADER
        self.flags = None
        self.poisoned = False
        self._accum = bytearray()
        self._records = []
        self._block_start_total = 0  # bytes consumed before current block
        self._consumed = 0
        self._inner: Optional[Lzma2Stream] = None
        self._inner_out = bytearray()
        self._block_start = 0
        self._hasher = None
        self._block_unpacked = 0
        self._header_size = 0

    # -- helpers ------------------------------------------------------------

    def _push_out(self, data: bytes) -> None:
        if not data:
            return
        if self._hasher is not None:
            self._hasher.update(data)
        self._block_unpacked += len(data)
        if self.sink is not None:
            self.sink.write(data)
        else:
            self._accum += data

    def _new_hasher(self):
        check = self.flags.check_method
        if check == xz_fmt.CHECK_CRC32:
            import zlib

            class H:
                def __init__(self):
                    self.v = 0

                def update(self, d):
                    self.v = zlib.crc32(d, self.v)

            return H()
        if check == xz_fmt.CHECK_CRC64:
            from lzma_rs_tpu_torch.utils import crc as crc_mod

            class H64:
                def __init__(self):
                    self.v = 0

                def update(self, d):
                    self.v = crc_mod.crc64(d, self.v)

            return H64()
        if check == xz_fmt.CHECK_SHA256:
            # One policy across one-shot and streaming: SHA-256 is
            # *verified* (documented superset of the reference, which
            # rejects it: /root/reference/src/decode/xz.rs:326-330).
            import hashlib

            return hashlib.sha256()
        return None

    # -- state machine -------------------------------------------------------

    def _drain(self) -> None:
        while True:
            if self.state == self._HEADER:
                if len(self.buf) < 12:
                    return
                cursor = ByteCursor(bytes(self.buf[:12]))
                self.flags = xz_fmt.parse_stream_header(cursor)
                del self.buf[:12]
                self._consumed += 12
                self.state = self._BLOCK_OR_INDEX
                continue

            if self.state == self._BLOCK_OR_INDEX:
                if not self.buf:
                    return
                if self.buf[0] == 0:
                    self.state = self._INDEX_FOOTER
                    continue
                # total header bytes = size byte + body ((b<<2)-1) + CRC32
                header_size = (self.buf[0] << 2) + 4
                if len(self.buf) < header_size:
                    return
                cursor = ByteCursor(bytes(self.buf[:header_size]))
                info = xz_fmt.read_block_header_at(cursor)
                filt = info.header.filters[0]
                if len(filt.props) != 1:
                    raise XzError("Invalid properties for filter Lzma2")
                del self.buf[:header_size]
                self._block_start_total = self._consumed
                self._consumed += header_size
                self._header_size = header_size
                self._block_info = info
                self._inner = Lzma2Stream()
                self._inner.sink = _CallbackSink(self._push_out)
                self._hasher = self._new_hasher()
                self._block_unpacked = 0
                self._inner_fed = 0
                self.state = self._BLOCK_PAYLOAD
                continue

            if self.state == self._BLOCK_PAYLOAD:
                if not self.buf:
                    return
                data = bytes(self.buf)
                self.buf.clear()
                self._inner.write(data)  # buffers whole input, may raise
                self._inner_fed += len(data)
                if not self._inner.finished:
                    return
                # inner finished: the unconsumed tail stays in inner.buf —
                # reclaim it (padding / check / next block sections)
                tail = bytes(self._inner.buf)
                self._inner.buf.clear()
                payload_len = self._inner_fed - len(tail)
                self.buf[:0] = tail
                self._consumed += payload_len
                hdr = self._block_info.header
                if (
                    hdr.packed_size is not None
                    and payload_len != hdr.packed_size
                ):
                    raise XzError(
                        f"Invalid compressed size: expected "
                        f"{hdr.packed_size} but got {payload_len}"
                    )
                if (
                    hdr.unpacked_size is not None
                    and self._block_unpacked != hdr.unpacked_size
                ):
                    raise XzError(
                        f"Invalid decompressed size: expected "
                        f"{hdr.unpacked_size} but got "
                        f"{self._block_unpacked}"
                    )
                self.state = self._PADDING_CHECK
                continue

            if self.state == self._PADDING_CHECK:
                count = self._consumed - self._block_start_total
                pad = xz_fmt.padding_size(count)
                check_n = xz_fmt.check_size(self.flags.check_method)
                if len(self.buf) < pad + check_n:
                    return
                for i in range(pad):
                    if self.buf[i] != 0:
                        raise XzError("Invalid block padding")
                check_bytes = bytes(self.buf[pad:pad + check_n])
                del self.buf[:pad + check_n]
                self._consumed += pad + check_n
                self._verify_check(check_bytes)
                # unpadded size = header + payload + check (no padding)
                unpadded = self._consumed - self._block_start_total - pad
                self._records.append(
                    xz_fmt.Record(
                        unpadded_size=unpadded,
                        unpacked_size=self._block_unpacked,
                    )
                )
                self.state = self._BLOCK_OR_INDEX
                continue

            if self.state == self._INDEX_FOOTER:
                # need the full remainder: index size is data-dependent;
                # try to parse, retry on EOF errors as more data arrives
                data = bytes(self.buf)
                cursor = ByteCursor(data)
                try:
                    index_size = xz_fmt.check_index(cursor, self._records)
                    xz_fmt.check_footer(cursor, self.flags, index_size)
                except (IoError, EOFError):
                    return
                except XzError as e:
                    if _EOF in str(e):
                        return
                    raise
                del self.buf[: cursor.pos]
                self._consumed += cursor.pos
                self.state = self._DONE
                continue

            if self.state == self._DONE:
                if self.buf:
                    raise XzError("Unexpected data after the stream footer")
                return

    def _verify_check(self, check_bytes: bytes) -> None:
        check = self.flags.check_method
        if check == xz_fmt.CHECK_CRC32:
            expected = int.from_bytes(check_bytes, "little")
            if expected != self._hasher.v:
                raise XzError(
                    f"Invalid block CRC32, expected 0x{expected:08x} "
                    f"but got 0x{self._hasher.v:08x}"
                )
        elif check == xz_fmt.CHECK_CRC64:
            expected = int.from_bytes(check_bytes, "little")
            if expected != self._hasher.v:
                raise XzError(
                    f"Invalid block CRC64, expected 0x{expected:016x} "
                    f"but got 0x{self._hasher.v:016x}"
                )
        elif check == xz_fmt.CHECK_SHA256:
            digest = self._hasher.digest()
            if check_bytes != digest:
                raise XzError(
                    f"Invalid block SHA-256, expected {check_bytes.hex()} "
                    f"but got {digest.hex()}"
                )

    # -- public API -----------------------------------------------------------

    def write(self, data) -> int:
        """Feed compressed bytes; complete chunks/blocks decode eagerly.
        Returns len(data) (framing is buffered, never rejected early)."""
        data = bytes(data)
        if self.poisoned:
            raise XzError(
                "can't finish stream because of previous write error"
            )
        self.buf += data
        try:
            self._drain()
        except Exception:
            self.poisoned = True
            raise
        return len(data)

    def get_output(self) -> Optional[bytes]:
        """Bytes decoded so far (None when poisoned or sink-attached)."""
        if self.poisoned or self.sink is not None:
            return None
        return bytes(self._accum)

    def finish(self) -> bytes:
        """Require footer-complete state and return all decoded bytes."""
        if self.poisoned:
            raise XzError(
                "can't finish stream because of previous write error"
            )
        if self.state != self._DONE:
            raise XzError(f"Unexpected end of stream: {_EOF}")
        return bytes(self._accum)


class _CallbackSink:
    def __init__(self, cb):
        self.cb = cb

    def write(self, data):
        self.cb(bytes(data))
