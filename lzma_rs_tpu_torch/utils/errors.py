"""Error taxonomy for lzma_rs_tpu.

Mirrors the four-variant error model of the reference library
(``/root/reference/src/error.rs:8-17``): ``IoError``, ``HeaderTooShort``,
``LzmaError`` and ``XzError``, with the same ``Display`` strings
("io error: ...", "header too short: ...", "lzma error: ...",
"xz error: ...", ``src/error.rs:29-37``).

``HeaderTooShort`` is kept distinct from ``IoError`` because the streaming
decoder uses it to distinguish *retryable* truncation while buffering header
bytes (``/root/reference/src/decode/stream.rs:186``).
"""

from __future__ import annotations


class LzmaRsError(Exception):
    """Base class for all lzma_rs_tpu errors (reference ``error::Error``)."""

    _prefix = "error"

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:  # mirrors Display impl, src/error.rs:29-37
        return f"{self._prefix}: {self.message}"


class IoError(LzmaRsError):
    """I/O error (reference ``Error::IoError``)."""

    _prefix = "io error"


class HeaderTooShort(LzmaRsError):
    """Not enough bytes to complete a header (reference ``Error::HeaderTooShort``).

    Retryable for the push-style streaming decoder: more bytes may arrive.
    """

    _prefix = "header too short"


class LzmaError(LzmaRsError):
    """LZMA coding error (reference ``Error::LzmaError``)."""

    _prefix = "lzma error"


class XzError(LzmaRsError):
    """XZ container error (reference ``Error::XzError``)."""

    _prefix = "xz error"


# Message used by Rust's std::io for read_exact hitting EOF; the reference's
# error strings embed it (e.g. tests assert "failed to fill whole buffer" for
# truncated streams, /root/reference/src/decode/stream.rs:428). We reproduce
# the same message so error-string behavior is comparable.
UNEXPECTED_EOF = "failed to fill whole buffer"
