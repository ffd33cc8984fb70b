"""Decode-backend selection for the port (``LZMA_RS_TPU_BACKEND``).

- ``cuda``: the segment kernel on the current CUDA device
  (``parallel/runtime.py``). Without a CUDA device it raises; it never
  runs on the CPU in the card's place. A stream the kernel cannot take
  (too large a segment, too many chunks, lc+lp or pb beyond the table
  budget) decodes on the native host engine, with the reason in
  ``stats.fallbacks``, as the JAX package's device engine does; raw LZMA
  of unknown size, with lc+lp > 4 or under a memlimit goes there
  unrecorded, as it does in the JAX package.
- ``native``: the C++ host engine, segment- and block-parallel.
- ``spec``: the pure-Python executable specification.
- ``auto`` (default): ``cuda`` for an LZMA2 / `.xz` stream of at least 64
  lanes and 1 MiB out (the JAX package's small-workload gate) that the
  kernel can take, when a CUDA device is present and the kernel builds;
  ``native`` otherwise, with the reason in ``stats.fallbacks`` (none
  without a card, as the JAX router records none without a TPU). Raw
  LZMA (one stream, one lane) stays on the host.
"""

from __future__ import annotations

import os

from lzma_rs_tpu_torch.formats.lzma_header import read_header
from lzma_rs_tpu_torch.models.codecs import (
    Lzma2Decoder,
    LzmaDecoder,
    xz_decode_stream,
)
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.options import Options

BACKENDS = ("auto", "cuda", "native", "spec")


def _backend() -> str:
    name = os.environ.get("LZMA_RS_TPU_BACKEND", "auto")
    if name not in BACKENDS:
        raise ValueError(
            f"LZMA_RS_TPU_BACKEND={name!r}: expected one of {BACKENDS}"
        )
    return name


def _native():
    try:
        from lzma_rs_tpu_torch.native import loader

        return loader.load()
    except Exception:
        return None


def _parallel(backend: str) -> bool:
    """Does an LZMA2 / `.xz` stream go to the parallel runtime? ``cuda``
    always (it raises there without a card); ``native`` and ``auto`` when
    an engine they can pick is present; ``spec`` never."""
    if backend == "cuda":
        return True
    if backend == "spec":
        return False
    if _native() is not None:
        return True
    if backend == "auto":
        import torch

        return torch.cuda.is_available()
    return False


def lzma_decode(data: bytes, options: Options) -> bytes:
    """Raw-LZMA decode via the selected backend."""
    cursor = ByteCursor(data)
    params = read_header(cursor, options)
    backend = _backend()
    if backend == "cuda":
        from lzma_rs_tpu_torch.parallel import runtime

        runtime.cuda_device()  # raises without a card
        p = params.properties
        if (params.unpacked_size is not None and p.lc + p.lp <= 4
                and options.memlimit is None):
            return runtime.lzma_raw_decode_device(data, cursor.pos, params)
        # unknown size, lc+lp beyond the JAX lane layout's 4 bits or a
        # memlimit: the host engines below, unrecorded, as the JAX
        # package's ``tpu`` backend does
    if backend != "spec":
        lib = _native()
        if lib is not None:
            res = lib.lzma_decode(data, cursor.pos, params, options.memlimit)
            if res is not None:
                return res
            if backend == "native":
                raise RuntimeError("native backend failed to decode")
    return LzmaDecoder(params, options.memlimit).decompress(cursor)


def lzma2_decode(data: bytes) -> bytes:
    """LZMA2 chunk-stream decode via the selected backend."""
    backend = _backend()
    if _parallel(backend):
        from lzma_rs_tpu_torch.parallel import runtime

        return runtime.lzma2_decode(data, engine=backend)
    return Lzma2Decoder().decompress(ByteCursor(data))


def xz_decode(data: bytes) -> bytes:
    """`.xz` container decode via the selected backend."""
    backend = _backend()
    if _parallel(backend):
        from lzma_rs_tpu_torch.parallel import runtime

        return runtime.xz_decode(data, engine=backend)
    return xz_decode_stream(ByteCursor(data))
