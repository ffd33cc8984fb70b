"""Push-style streaming LZMA decoder.

Mirrors the reference ``decompress::Stream`` (``/root/reference/src/decode/
stream.rs:66-340``):

- ``write(data)`` accepts arbitrary chunks; header bytes (<= 18: 13-byte
  header + 5 range-coder init bytes) are buffered until complete
  (``MAX_TMP_LEN``, stream.rs:9-24),
- decode state (range, code, probability model, window) carries across
  writes; symbols are only consumed when provably complete, via the
  <= 20-byte partial buffer + update=False dry-run (lzma.rs:403-419),
- ``finish()`` runs a final empty-input Finish pass to validate the end of
  stream unless ``allow_incomplete`` (stream.rs:119-151),
- a failed ``write`` poisons the stream: ``finish`` then raises
  "can't finish stream because of previous write error" (stream.rs:145-150).

The engine is the native C++ incremental decoder when available, else the
pure-Python executable spec.
"""

from __future__ import annotations

from typing import Optional

from lzma_rs_tpu_torch.formats import lzma_header
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.errors import HeaderTooShort, IoError, LzmaError
from lzma_rs_tpu_torch.utils.options import Options

MIN_HEADER_LEN = 5
MAX_HEADER_LEN = MIN_HEADER_LEN + 8
START_BYTES = 5
MAX_TMP_LEN = MAX_HEADER_LEN + START_BYTES


class _SpecEngine:
    """Streaming engine over the Python executable spec."""

    def __init__(self, params, memlimit, range_, code):
        from lzma_rs_tpu_torch.models.spec import CircularBuffer, DecoderState

        self.state = DecoderState(params.properties, params.unpacked_size)
        self.output = CircularBuffer(params.dict_size, memlimit)
        self.range = range_
        self.code = code
        self._taken = 0

    def feed(self, data: bytes, finish: bool) -> int:
        """Returns input bytes consumed (stream.rs write() returns
        input.position(): once a provided unpacked size is reached the
        decoder takes nothing more — the WriteZero condition)."""
        from lzma_rs_tpu_torch.models.spec import RangeDecoder

        rc = RangeDecoder.from_parts(data, self.range, self.code)
        if finish:
            self.state.process(self.output, rc)
        else:
            self.state.process_stream(self.output, rc)
        self.range, self.code = rc.range, rc.code
        return rc.pos

    def flushed_len(self) -> int:
        return len(self.output.out)

    def take_output(self) -> bytes:
        new = bytes(self.output.out[self._taken :])
        self._taken = len(self.output.out)
        return new

    def finalize(self) -> None:
        if self.output.cursor > 0:
            self.output.out += self.output.buf[: self.output.cursor]
            self.output.cursor = 0
            # Keep window consistent: treat flushed bytes as still in buf.
            # (Only called once, at finish().)


class _NativeEngine:
    """Streaming engine over the C++ incremental decoder."""

    def __init__(self, lib, params, memlimit, range_, code):
        import ctypes

        self._ctypes = ctypes
        self.lib = lib._lib
        self.nlib = lib
        f = self.lib
        f.lrt_stream_new.restype = ctypes.c_void_p
        f.lrt_stream_new.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_uint32,
        ]
        f.lrt_stream_feed.restype = ctypes.c_int
        f.lrt_stream_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
        ]
        f.lrt_stream_take_output.restype = ctypes.c_int
        f.lrt_stream_take_output.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        f.lrt_stream_finalize.restype = None
        f.lrt_stream_finalize.argtypes = [ctypes.c_void_p]
        f.lrt_stream_delete.restype = None
        f.lrt_stream_delete.argtypes = [ctypes.c_void_p]
        p = params
        self.handle = f.lrt_stream_new(
            p.properties.lc, p.properties.lp, p.properties.pb, p.dict_size,
            int(p.unpacked_size is not None), p.unpacked_size or 0,
            int(memlimit is not None), memlimit or 0, range_, code,
        )

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.lrt_stream_delete(self.handle)
                self.handle = None
        except Exception:
            pass

    def feed(self, data: bytes, finish: bool) -> int:
        ctypes = self._ctypes
        err = ctypes.create_string_buffer(512)
        consumed = ctypes.c_size_t()
        rc = self.lib.lrt_stream_feed(
            self.handle, data, len(data), int(finish),
            ctypes.byref(consumed), err,
        )
        if rc != 0:
            msg = err.value.decode("utf-8", "replace")
            raise IoError(msg) if rc == 2 else LzmaError(msg)
        return int(consumed.value)

    def take_output(self) -> bytes:
        ctypes = self._ctypes
        buf = ctypes.c_void_p()
        n = ctypes.c_size_t()
        self.lib.lrt_stream_take_output(
            self.handle, ctypes.byref(buf), ctypes.byref(n)
        )
        try:
            return ctypes.string_at(buf.value, n.value) if n.value else b""
        finally:
            self.lib.lrt_free(buf)

    def finalize(self) -> None:
        self.lib.lrt_stream_finalize(self.handle)


class Stream:
    """LZMA decompressor accepting multiple chunks of input.

    ``output`` may be a writable binary sink; decompressed bytes are pushed
    to it as they are finalized. Without a sink, bytes accumulate
    internally and ``finish()`` returns them.
    """

    def __init__(self, output=None, options: Optional[Options] = None):
        self.options = options or Options()
        self.sink = output
        self.tmp = bytearray()
        self.engine = None
        self.poisoned = False
        self.finished = False
        self._accum = bytearray()

    # -- internal ---------------------------------------------------------

    def _push_out(self, data: bytes) -> None:
        if not data:
            return
        if self.sink is not None:
            self.sink.write(data)
        else:
            self._accum += data

    def _try_start(self):
        """Attempt header + range-coder init from self.tmp.

        Returns None when more header bytes are needed; otherwise the
        number of payload bytes the engine left unconsumed (nonzero only
        when decode completed with input remaining — the reference's
        WriteZero condition, stream.rs via tests/lzma.rs:71-88).
        """
        cursor = ByteCursor(bytes(self.tmp))
        try:
            params = lzma_header.read_header(cursor, self.options)
        except HeaderTooShort:
            return None
        # Range coder init needs 5 more bytes (stream.rs:19-21,172-183).
        if len(self.tmp) - cursor.pos < START_BYTES:
            return None
        cursor.skip(1)
        code = cursor.read_u32_be()
        range_ = 0xFFFFFFFF

        lib = None
        try:
            from lzma_rs_tpu_torch.native import loader

            lib = loader.load()
        except Exception:
            lib = None
        if lib is not None:
            self.engine = _NativeEngine(lib, params, self.options.memlimit, range_, code)
        else:
            self.engine = _SpecEngine(params, self.options.memlimit, range_, code)
        rest = bytes(self.tmp[cursor.pos :])
        self.tmp.clear()
        unconsumed = 0
        if rest:
            taken = self.engine.feed(rest, finish=False)
            unconsumed = len(rest) - taken
            self._push_out(self.engine.take_output())
        return unconsumed

    # -- public API -------------------------------------------------------

    def write(self, data) -> int:
        """Process a chunk of compressed data; returns bytes consumed.

        Mirrors ``io::Write`` semantics (stream.rs:227-325): once a
        provided unpacked size has been fully decoded while the stream's
        own end marker is still unread, further input is not consumed and
        ``write`` returns less than ``len(data)`` — eventually 0, the
        Python analog of the reference's ``WriteZero`` error
        (``/root/reference/tests/lzma.rs:71-88``). The stream is NOT
        poisoned by this; ``finish()`` still succeeds.
        """
        data = bytes(data)
        if self.poisoned:
            raise LzmaError(
                "can't finish stream because of previous write error"
            )
        consumed = len(data)
        try:
            if self.engine is None:
                self.tmp += data
                if len(self.tmp) >= 1:
                    unconsumed = self._try_start()
                    if unconsumed:
                        consumed -= min(unconsumed, consumed)
            else:
                consumed = self.engine.feed(data, finish=False)
                self._push_out(self.engine.take_output())
        except Exception:
            self.poisoned = True
            self.engine = None
            raise
        return consumed

    def get_output(self) -> Optional[bytes]:
        """Decompressed bytes finalized so far (None if poisoned)."""
        if self.poisoned:
            return None
        if self.sink is not None:
            return None
        return bytes(self._accum)

    def finish(self) -> bytes:
        """Validate end-of-stream and return all decompressed bytes."""
        if self.poisoned:
            raise LzmaError(
                "can't finish stream because of previous write error"
            )
        self.finished = True
        if self.engine is None:
            if len(self.tmp) > 0:
                raise LzmaError("failed to read header")
            return bytes(self._accum)
        if not self.options.allow_incomplete:
            # One last Finish-mode pass validates EOS / unpacked size
            # (stream.rs:130-140).
            self.engine.feed(b"", finish=True)
        self.engine.finalize()
        self._push_out(self.engine.take_output())
        return bytes(self._accum)
