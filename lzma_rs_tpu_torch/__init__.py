"""lzma_rs_tpu_torch — the LZMA / LZMA2 / XZ codec on PyTorch and CUDA.

The port of ``lzma_rs_tpu`` to an NVIDIA Hopper card. Decoding goes
through this package's backends (``backends.py``): bulk LZMA2 and `.xz`
streams split into independent dict-reset segments that a hand-written CUDA
kernel decodes one thread per segment (``ops/segment_decoder.py``,
``csrc/``); the container walk, block checks and host engines are the JAX
package's JAX-free host modules, imported as they are. Encoding is the
shared host encoder, re-exported.

The public API is the eight functions of the JAX package (and of the
reference's ``src/lib.rs``). ``LZMA_RS_TPU_BACKEND`` picks the decode
engine: ``auto`` (default), ``cuda``, ``native`` or ``spec``.
"""

from __future__ import annotations

from typing import BinaryIO, Optional

from lzma_rs_tpu import (  # the shared host encoder and API helpers
    _Input,
    _as_bytes,
    _emit,
    lzma2_compress,
    lzma_compress,
    lzma_compress_with_options,
    xz_compress,
)
from lzma_rs_tpu.utils.options import CompressOptions, Options

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
