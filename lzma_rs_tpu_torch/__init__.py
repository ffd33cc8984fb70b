"""lzma_rs_tpu_torch — the LZMA / LZMA2 / XZ codec on PyTorch and CUDA.

The port of ``lzma_rs_tpu`` to an NVIDIA Hopper card. It imports nothing
of ``lzma_rs_tpu``: the host layers it needs (``utils/``, ``formats/``,
``models/``, ``encode/``, ``native/`` and the host half of
``parallel/runtime.py``) are its own copies, each at its original's path
and changed only in its imports and in where the native library is built
(``lzma_rs_tpu_torch/build/``).

Decoding goes through this package's backends (``backends.py``): bulk
LZMA2 and `.xz` streams split into independent dict-reset segments that a
hand-written CUDA kernel decodes one warp per segment
(``ops/segment_decoder.py``, ``csrc/``). Encoding is the host encoder.

The public API is the eight functions of the JAX package (and of the
reference's ``src/lib.rs``). ``LZMA_RS_TPU_BACKEND`` picks the decode
engine: ``auto`` (default), ``cuda``, ``native`` or ``spec``.
``LZMA_RS_TPU_VMEM_GEN=1`` picks the JAX package's gen-1 shape bucket (one
bucket for window and staged input) instead of gen-2's; the same kernel
runs either.
"""

from __future__ import annotations

from typing import BinaryIO, Optional, Union

from lzma_rs_tpu_torch.utils.options import CompressOptions, Options

__all__ = [
    "lzma_decompress",
    "lzma_decompress_with_options",
    "lzma_compress",
    "lzma_compress_with_options",
    "lzma2_decompress",
    "lzma2_compress",
    "xz_decompress",
    "xz_compress",
    "Options",
    "CompressOptions",
]

# -- copied from lzma_rs_tpu/__init__.py:39, 48-58

_Input = Union[bytes, bytearray, memoryview, BinaryIO]


def _as_bytes(data: _Input) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    return data.read()


def _emit(result: bytes, output: Optional[BinaryIO]) -> Optional[bytes]:
    if output is None:
        return result
    output.write(result)
    return None


# -- copied from lzma_rs_tpu/__init__.py:83-94, 111-130, 145-186


def lzma_compress(input: _Input, output: Optional[BinaryIO] = None) -> Optional[bytes]:
    """Compress data as raw LZMA with default options (src/lib.rs:64-69)."""
    return lzma_compress_with_options(input, CompressOptions(), output)


def lzma_compress_with_options(
    input: _Input, options: CompressOptions, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Compress data as raw LZMA with the provided options (src/lib.rs:72-79)."""
    from lzma_rs_tpu_torch.encode.lzma_enc import lzma_compress as _enc

    return _emit(_enc(_as_bytes(input), options), output)


def lzma2_compress(
    input: _Input,
    output: Optional[BinaryIO] = None,
    *,
    level: Optional[int] = 6,
    props: int = -1,
    dist_cap: int = 0,
) -> Optional[bytes]:
    """Compress data as an LZMA2 chunk stream (src/lib.rs:91-97).

    ``level`` 1-9 = real compression (beyond the reference's
    uncompressed-chunk writer); 0/None = stored chunks. ``props`` is a raw
    LZMA props byte or -1 for lc=3 lp=0 pb=2. ``dist_cap`` (0 = uncapped)
    bounds match distances for the TPU ring-window decode profile."""
    from lzma_rs_tpu_torch.encode.lzma2_enc import lzma2_compress as _enc

    return _emit(
        _enc(_as_bytes(input), level, props=props, dist_cap=dist_cap),
        output,
    )


def xz_compress(
    input: _Input,
    output: Optional[BinaryIO] = None,
    *,
    block_size: Optional[int] = None,
    check_method: int = 0,
    level: Optional[int] = 6,
    props: int = -1,
    dist_cap: int = 0,
    tpu_profile: bool = False,
) -> Optional[bytes]:
    """Compress data into a `.xz` stream (src/lib.rs:108-110).

    Extensions over the reference's one-block writer: ``block_size`` splits
    the input into independent blocks (block-parallel encode/decode) and
    ``check_method`` selects the per-block integrity check (0=None,
    1=CRC32, 4=CRC64), and ``level`` picks real compression (1-9, native
    greedy encoder) or stored chunks (0/None, the reference's writer).
    ``props`` is a raw LZMA props byte (-1 = lc=3 lp=0 pb=2).

    ``tpu_profile=True`` targets the VMEM TPU decode kernel
    (ops/vmem_decoder.py): small independent blocks (dict-reset segments
    fit the kernel's VMEM window), lc=0 (a 768-entry literal table
    instead of 6144, tripling kernel step rate), and capped match
    distances (``dist_cap``) so the decode's window reads hit the
    kernel's VMEM-resident recent-history ring — a few % larger archive
    that decodes dramatically faster on TPU."""
    from lzma_rs_tpu_torch.encode.xz_enc import xz_compress as _enc

    if tpu_profile:
        if block_size is None:
            block_size = 8192
        if props < 0:
            props = 0 + 9 * (0 + 5 * 2)  # lc=0 lp=0 pb=2
        if dist_cap == 0:
            dist_cap = 2048  # ring-window bucket (ops/vmem_decoder.py)
    return _emit(
        _enc(_as_bytes(input), block_size=block_size,
             check_method=check_method, level=level, props=props,
             dist_cap=dist_cap),
        output,
    )


# -- decoding through the port's backends


def lzma_decompress(
    input: _Input, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress raw LZMA data with default options."""
    return lzma_decompress_with_options(input, Options(), output)


def lzma_decompress_with_options(
    input: _Input, options: Options, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress raw LZMA data with the provided options."""
    from lzma_rs_tpu_torch import backends

    return _emit(backends.lzma_decode(_as_bytes(input), options), output)


def lzma2_decompress(
    input: _Input, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress an LZMA2 chunk stream."""
    from lzma_rs_tpu_torch import backends

    return _emit(backends.lzma2_decode(_as_bytes(input)), output)


def xz_decompress(
    input: _Input, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress a `.xz` stream."""
    from lzma_rs_tpu_torch import backends

    return _emit(backends.xz_decode(_as_bytes(input)), output)
