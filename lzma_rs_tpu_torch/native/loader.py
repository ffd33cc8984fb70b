"""Loader for the native C++ runtime (liblzma_rs_tpu_torch_native-<hash>.so).

Builds lazily with g++ on first use if the shared object is missing; returns
``None`` when no toolchain is available so callers fall back to the Python
spec engine. The wrapper exposes a small typed facade over the C ABI.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lzma_native.cpp")
# The port's own library: its own file name, in the port's git-ignored
# build directory, keyed by the source's hash (never beside the JAX
# package's liblzma_rs_tpu_native.so, which a process may load as well).
_BUILD = os.path.join(os.path.dirname(_HERE), "build")


@functools.lru_cache(maxsize=1)
def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"liblzma_rs_tpu_torch_native-{digest}.so")


_lock = threading.Lock()
_cached = None
_tried = False


class NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.lrt_crc64_update.restype = ctypes.c_uint64
        lib.lrt_crc64_update.argtypes = [
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]

        lib.lrt_lzma_decode.restype = ctypes.c_int
        lib.lrt_lzma_decode.argtypes = [
            ctypes.c_char_p,  # input
            ctypes.c_size_t,  # input len
            ctypes.c_size_t,  # payload offset
            ctypes.c_int,  # lc
            ctypes.c_int,  # lp
            ctypes.c_int,  # pb
            ctypes.c_uint64,  # dict size
            ctypes.c_int,  # has unpacked size
            ctypes.c_uint64,  # unpacked size
            ctypes.c_int,  # has memlimit
            ctypes.c_uint64,  # memlimit
            ctypes.POINTER(ctypes.c_void_p),  # out buf
            ctypes.POINTER(ctypes.c_size_t),  # out len
            ctypes.c_char_p,  # err buf (256)
        ]
        lib.lrt_lzma2_decode.restype = ctypes.c_int
        lib.lrt_lzma2_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_size_t,  # start offset
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),  # consumed
            ctypes.c_char_p,
        ]
        lib.lrt_free.restype = None
        lib.lrt_free.argtypes = [ctypes.c_void_p]

        class LrtChunk(ctypes.Structure):
            _fields_ = [
                ("in_start", ctypes.c_uint64),
                ("in_end", ctypes.c_uint64),
                ("out_start", ctypes.c_uint64),
                ("out_end", ctypes.c_uint64),
                ("reset_state", ctypes.c_int32),
                ("lc", ctypes.c_int32),
                ("lp", ctypes.c_int32),
                ("pb", ctypes.c_int32),
            ]

        lib.lrt_lzma2_compress.restype = ctypes.c_int
        lib.lrt_lzma2_compress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.c_size_t,  # chunk size (unpacked bytes per chunk)
            ctypes.c_int,  # props byte, or -1 for lc=3 lp=0 pb=2
            ctypes.c_size_t,  # match-distance cap (0 = uncapped)
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        ]

        lib.lrt_lzma_encode_body.restype = ctypes.c_int
        lib.lrt_lzma_encode_body.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        ]

        lib.lrt_l2stream_new.restype = ctypes.c_void_p
        lib.lrt_l2stream_new.argtypes = []
        lib.lrt_l2stream_delete.restype = None
        lib.lrt_l2stream_delete.argtypes = [ctypes.c_void_p]
        lib.lrt_l2stream_chunk.restype = ctypes.c_int
        lib.lrt_l2stream_chunk.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,     # kind: 0 lzma, 1 uncompressed
            ctypes.c_uint64,  # unpacked size
            ctypes.c_int,     # reset mode
            ctypes.c_int,     # props byte or -1
            ctypes.c_char_p,
        ]
        lib.lrt_l2stream_take_output.restype = ctypes.c_int
        lib.lrt_l2stream_take_output.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_size_t),
        ]

        self.LrtChunk = LrtChunk
        lib.lrt_lzma2_decode_segment.restype = ctypes.c_int
        lib.lrt_lzma2_decode_segment.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(LrtChunk),
            ctypes.c_int,
            ctypes.c_void_p,  # out (points into shared writable buffer)
            ctypes.c_size_t,
            ctypes.c_char_p,
        ]

    def crc64_update(self, data, crc: int) -> int:
        """data: bytes or a numpy uint8 array (zero-copy)."""
        import numpy as _np

        if not isinstance(data, _np.ndarray):
            data = _np.frombuffer(data, dtype=_np.uint8)
        return self._lib.lrt_crc64_update(
            ctypes.c_uint64(crc), data.ctypes.data, data.size
        )

    def _take(self, buf, n) -> bytes:
        try:
            return ctypes.string_at(buf.value, n.value) if n.value else b""
        finally:
            self._lib.lrt_free(buf)

    def lzma_decode(self, data: bytes, payload_off: int, params, memlimit):
        """Returns decoded bytes, or raises the mapped error. None = not supported."""
        from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError

        buf = ctypes.c_void_p()
        n = ctypes.c_size_t()
        err = ctypes.create_string_buffer(512)
        rc = self._lib.lrt_lzma_decode(
            data,
            len(data),
            payload_off,
            params.properties.lc,
            params.properties.lp,
            params.properties.pb,
            params.dict_size,
            int(params.unpacked_size is not None),
            params.unpacked_size or 0,
            int(memlimit is not None),
            memlimit or 0,
            ctypes.byref(buf),
            ctypes.byref(n),
            err,
        )
        if rc == 0:
            return self._take(buf, n)
        self._lib.lrt_free(buf)
        msg = err.value.decode("utf-8", "replace")
        if rc == 2:
            raise IoError(msg)
        raise LzmaError(msg)

    def lzma2_decode(self, data: bytes) -> bytes:
        out, _ = self.lzma2_decode_at(data, 0)
        return out

    def lzma2_compress(
        self, data: bytes, level: int, chunk_size: int = 65536,
        props: int = -1, dist_cap: int = 0,
    ) -> bytes:
        buf = ctypes.c_void_p()
        n = ctypes.c_size_t()
        self._lib.lrt_lzma2_compress(
            data, len(data), level, chunk_size, props, dist_cap,
            ctypes.byref(buf), ctypes.byref(n),
        )
        return self._take(buf, n)

    def lzma_encode_body(self, data: bytes, write_eos: bool) -> bytes:
        buf = ctypes.c_void_p()
        n = ctypes.c_size_t()
        self._lib.lrt_lzma_encode_body(
            data, len(data), int(write_eos), ctypes.byref(buf), ctypes.byref(n)
        )
        return self._take(buf, n)

    def lzma2_decode_segment(self, data, chunks, out_view, out_cap) -> None:
        """Decode one segment's chunk schedule into ``out_view`` (a ctypes
        pointer into a shared output buffer). Raises on error."""
        import ctypes

        from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError

        n = len(chunks)
        arr = (self.LrtChunk * n)()
        for i, c in enumerate(chunks):
            arr[i] = self.LrtChunk(*c)
        err = ctypes.create_string_buffer(512)
        rc = self._lib.lrt_lzma2_decode_segment(
            data, len(data), arr, n, out_view, out_cap, err
        )
        if rc != 0:
            msg = err.value.decode("utf-8", "replace")
            raise IoError(msg) if rc == 2 else LzmaError(msg)

    # -- incremental LZMA2 (chunk-granular streaming) ----------------------

    def l2stream_new(self):
        return self._lib.lrt_l2stream_new()

    def l2stream_delete(self, handle) -> None:
        self._lib.lrt_l2stream_delete(handle)

    def l2stream_chunk(
        self, handle, payload: bytes, kind: int, unpacked: int,
        reset_mode: int, props: int,
    ) -> None:
        from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError

        err = ctypes.create_string_buffer(512)
        rc = self._lib.lrt_l2stream_chunk(
            handle, payload, len(payload), kind, unpacked, reset_mode,
            props, err,
        )
        if rc != 0:
            msg = err.value.decode("utf-8", "replace")
            raise IoError(msg) if rc == 2 else LzmaError(msg)

    def l2stream_take(self, handle) -> bytes:
        buf = ctypes.c_void_p()
        n = ctypes.c_size_t()
        self._lib.lrt_l2stream_take_output(
            handle, ctypes.byref(buf), ctypes.byref(n)
        )
        return self._take(buf, n)

    def lzma2_decode_at(self, data: bytes, start: int):
        from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError

        buf = ctypes.c_void_p()
        n = ctypes.c_size_t()
        consumed = ctypes.c_size_t()
        err = ctypes.create_string_buffer(512)
        rc = self._lib.lrt_lzma2_decode(
            data, len(data), start, ctypes.byref(buf), ctypes.byref(n),
            ctypes.byref(consumed), err,
        )
        if rc == 0:
            return self._take(buf, n), consumed.value
        self._lib.lrt_free(buf)
        msg = err.value.decode("utf-8", "replace")
        if rc == 2:
            raise IoError(msg)
        raise LzmaError(msg)


def _pgo_train(so_path: str) -> None:
    """Exercise the hot paths of an instrumented build (decode dominates)."""
    lib = ctypes.CDLL(so_path)
    lib.lrt_lzma2_compress.restype = ctypes.c_int
    lib.lrt_lzma2_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.lrt_lzma2_decode.restype = ctypes.c_int
    lib.lrt_lzma2_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
    ]
    lib.lrt_free.restype = None
    lib.lrt_free.argtypes = [ctypes.c_void_p]

    # training corpus: this package's own sources (text), repeated
    train = bytearray()
    pkg = os.path.dirname(_HERE)
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith((".py", ".cpp")):
                with open(os.path.join(root, f), "rb") as fh:
                    train += fh.read()
    train = bytes(train * 4)

    buf = ctypes.c_void_p()
    n = ctypes.c_size_t()
    lib.lrt_lzma2_compress(train, len(train), 6, 65536, -1, 0,
                           ctypes.byref(buf), ctypes.byref(n))
    comp = ctypes.string_at(buf.value, n.value)
    lib.lrt_free(buf)
    err = ctypes.create_string_buffer(512)
    consumed = ctypes.c_size_t()
    for _ in range(3):
        lib.lrt_lzma2_decode(comp, len(comp), 0, ctypes.byref(buf),
                             ctypes.byref(n), ctypes.byref(consumed), err)
        lib.lrt_free(buf)

    # Also train the production decode entrypoint (FlatOut segments +
    # the register-local fast loop): scan the LZMA2 chunk headers and
    # drive lrt_lzma2_decode_segment over the whole stream.
    class _Chunk(ctypes.Structure):
        _fields_ = [
            ("in_start", ctypes.c_uint64), ("in_end", ctypes.c_uint64),
            ("out_start", ctypes.c_uint64), ("out_end", ctypes.c_uint64),
            ("reset_state", ctypes.c_int32), ("lc", ctypes.c_int32),
            ("lp", ctypes.c_int32), ("pb", ctypes.c_int32),
        ]

    lib.lrt_lzma2_decode_segment.restype = ctypes.c_int
    lib.lrt_lzma2_decode_segment.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_Chunk),
        ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
    ]
    chunks, pos, out_pos = [], 0, 0
    lc = lp = pb = 0
    ok = True
    while pos < len(comp) and comp[pos] != 0:
        c = comp[pos]
        if c < 0x80 or pos + 5 > len(comp):
            # uncompressed chunk (not emitted for text corpora) or a
            # truncated header: skip PGO training rather than abort the
            # whole native build on an IndexError
            ok = False
            break
        unpacked = ((c & 0x1F) << 16) + (comp[pos + 1] << 8) + comp[pos + 2] + 1
        packed = (comp[pos + 3] << 8) + comp[pos + 4] + 1
        reset = (c >> 5) & 3
        hdr = 5
        if reset >= 2:
            if pos + 6 > len(comp):
                ok = False
                break
            p = comp[pos + 5]
            lc, lp, pb = p % 9, (p // 9) % 5, p // 45
            hdr = 6
        if pos + hdr + packed > len(comp):
            ok = False
            break
        chunks.append(_Chunk(pos + hdr, pos + hdr + packed, out_pos,
                             out_pos + unpacked, 1 if reset else 0,
                             lc, lp, pb))
        out_pos += unpacked
        pos += hdr + packed
    if ok and chunks:
        arr = (_Chunk * len(chunks))(*chunks)
        out = ctypes.create_string_buffer(out_pos)
        for _ in range(3):
            lib.lrt_lzma2_decode_segment(comp, len(comp), arr, len(chunks),
                                         out, out_pos, err)


def build(force: bool = False) -> bool:
    """Compile the native library (two-stage PGO; ~+17% on the decode hot
    loop). Falls back to a plain -O3 build on any PGO failure."""
    import tempfile

    if not os.path.exists(_SRC):
        return False
    _SO = _so_path()
    if os.path.exists(_SO) and not force:
        if os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return True

    os.makedirs(_BUILD, exist_ok=True)
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

    def compile_to(path, extra):
        subprocess.run(base + extra + [_SRC, "-o", path], check=True,
                       capture_output=True, timeout=240)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            stage1 = os.path.join(tmp, "stage1.so")
            prof = os.path.join(tmp, "prof")
            compile_to(stage1, [f"-fprofile-generate={prof}"])
            _pgo_train(stage1)
            stage2 = os.path.join(tmp, "stage2.so")
            compile_to(
                stage2, [f"-fprofile-use={prof}", "-fprofile-correction"]
            )
            os.replace(stage2, _SO)
            return True
    except Exception:
        pass
    try:
        compile_to(_SO, [])
        return True
    except Exception:
        return False


def load() -> Optional[NativeLib]:
    global _cached, _tried
    with _lock:
        if _tried:
            return _cached
        _tried = True
        if os.environ.get("LZMA_RS_TPU_NO_NATIVE"):
            return None
        if not build():
            return None
        try:
            _cached = NativeLib(ctypes.CDLL(_so_path()))
        except Exception:
            _cached = None
        return _cached


# --- edge-coverage instrumented build (fuzzing) ------------------------

_SO_COV = os.path.join(_BUILD, "liblzma_rs_tpu_torch_native_cov.so")
_COV_SRC = os.path.join(_HERE, "cov_runtime.cpp")
_cov_cached = None
_cov_tried = False


class CovNativeLib(NativeLib):
    """NativeLib plus the edge-coverage query API (cov_runtime.cpp).
    Arc ids are bitmap indices derived from code offsets — stable for a
    given .so build; pair persisted arcs with :meth:`build_id`."""

    def __init__(self, lib: ctypes.CDLL):
        super().__init__(lib)
        lib.lrt_cov_enable.argtypes = [ctypes.c_int]
        lib.lrt_cov_reset.argtypes = []
        lib.lrt_cov_snapshot.restype = ctypes.c_int
        lib.lrt_cov_snapshot.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        self._snap_buf = (ctypes.c_int32 * (1 << 17))()

    def cov_run(self, fn):
        """Run fn() with edge recording; returns the arc-id set."""
        self._lib.lrt_cov_reset()
        self._lib.lrt_cov_enable(1)
        try:
            fn()
        finally:
            self._lib.lrt_cov_enable(0)
        n = self._lib.lrt_cov_snapshot(self._snap_buf, 1 << 17)
        return set(self._snap_buf[:n])

    @staticmethod
    def build_id() -> str:
        """Hash of the instrumented .so — persisted arc sets are only
        comparable within one build."""
        import hashlib

        with open(_SO_COV, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()[:16]


def build_instrumented(force: bool = False) -> bool:
    """Compile the -fsanitize-coverage=trace-pc build (the coverage
    callback lives in the UNinstrumented cov_runtime.cpp TU). -O1: edge
    attribution beats speed for the fuzz tier."""
    if not os.path.exists(_SRC) or not os.path.exists(_COV_SRC):
        return False
    if os.path.exists(_SO_COV) and not force:
        newest = max(os.path.getmtime(_SRC), os.path.getmtime(_COV_SRC))
        if os.path.getmtime(_SO_COV) >= newest:
            return True
    import tempfile

    os.makedirs(_BUILD, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            main_o = os.path.join(tmp, "main.o")
            cov_o = os.path.join(tmp, "cov.o")
            # the callback TU must NOT be instrumented — a traced
            # __sanitizer_cov_trace_pc would recurse into itself
            subprocess.run(
                ["g++", "-O1", "-fPIC", "-std=c++17", "-c",
                 "-fsanitize-coverage=trace-pc", _SRC, "-o", main_o],
                check=True, capture_output=True, timeout=240,
            )
            subprocess.run(
                ["g++", "-O1", "-fPIC", "-std=c++17", "-c",
                 _COV_SRC, "-o", cov_o],
                check=True, capture_output=True, timeout=240,
            )
            subprocess.run(
                ["g++", "-shared", main_o, cov_o, "-o", _SO_COV],
                check=True, capture_output=True, timeout=240,
            )
        return True
    except Exception:
        return False


def load_instrumented() -> Optional[CovNativeLib]:
    """The edge-coverage build, for the coverage-guided fuzz tier.
    Separate cache from the production library."""
    global _cov_cached, _cov_tried
    with _lock:
        if _cov_tried:
            return _cov_cached
        _cov_tried = True
        if os.environ.get("LZMA_RS_TPU_NO_NATIVE"):
            return None
        if not build_instrumented():
            return None
        try:
            _cov_cached = CovNativeLib(ctypes.CDLL(_SO_COV))
        except Exception:
            _cov_cached = None
        return _cov_cached
