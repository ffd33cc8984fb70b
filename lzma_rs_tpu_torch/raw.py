"""Raw decoding primitives (reference ``decompress::raw``, src/lib.rs:29-35).

Exposes the low-level decoder objects for callers that manage framing
themselves: ``LzmaDecoder`` (raw LZMA with explicit params), ``Lzma2Decoder``
(chunk streams), plus ``LzmaParams`` / ``LzmaProperties``. Unlike the
feature-gated Rust API this is always available.
"""

from __future__ import annotations

from typing import Optional

from lzma_rs_tpu_torch.formats.lzma_header import LzmaParams, LzmaProperties
from lzma_rs_tpu_torch.models.codecs import KEEP_UNPACKED_SIZE
from lzma_rs_tpu_torch.models.codecs import Lzma2Decoder as _SpecLzma2Decoder
from lzma_rs_tpu_torch.models.codecs import LzmaDecoder as _SpecLzmaDecoder
from lzma_rs_tpu_torch.utils.cursor import ByteCursor

__all__ = [
    "LzmaDecoder",
    "Lzma2Decoder",
    "LzmaParams",
    "LzmaProperties",
    "KEEP_UNPACKED_SIZE",
]


class LzmaDecoder:
    """Raw LZMA decoder with explicit parameters (decode/lzma.rs:595-649)."""

    def __init__(self, params: LzmaParams, memlimit: Optional[int] = None):
        self._inner = _SpecLzmaDecoder(params, memlimit)

    @property
    def params(self) -> LzmaParams:
        return self._inner.params

    def reset(self, unpacked_size=KEEP_UNPACKED_SIZE) -> None:
        """Reset decoder state, optionally overriding the expected size."""
        """Mirror of the reference's ``reset(Option<Option<u64>>)``
        (decode/lzma.rs:624-631): default keeps the current unpacked
        size, ``None`` marks it unknown, an int replaces it."""
        self._inner.reset(unpacked_size)

    def decompress(self, data) -> bytes:
        """Decode one raw-LZMA payload with this decoder's parameters."""
        """Decompress a raw LZMA payload (no 13-byte header)."""
        from lzma_rs_tpu_torch.native import loader

        lib = loader.load()
        if lib is not None and not self._inner.state.partial:
            return lib.lzma_decode(bytes(data), 0, self._inner.params,
                                   self._inner.memlimit)
        return self._inner.decompress(ByteCursor(bytes(data)))


class Lzma2Decoder:
    """Raw LZMA2 chunk-stream decoder (decode/lzma2.rs:11-230)."""

    def __init__(self) -> None:
        self._inner = _SpecLzma2Decoder()

    def reset(self) -> None:
        """Fresh LZMA2 state (mirrors decompress::raw::Lzma2Decoder::reset)."""
        self._inner.reset()

    def decompress(self, data) -> bytes:
        """Decode an LZMA2 chunk stream to its terminator."""
        from lzma_rs_tpu_torch.native import loader

        lib = loader.load()
        if lib is not None:
            return lib.lzma2_decode(bytes(data))
        return self._inner.decompress(ByteCursor(bytes(data)))
