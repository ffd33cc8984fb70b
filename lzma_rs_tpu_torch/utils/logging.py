"""Zero-cost-when-off logging.

The reference compiles its logging macros to no-ops unless the
``enable_logging`` feature is set (``/root/reference/src/macros.rs:1-41``);
gating logging bought ~25% decode speed (CHANGELOG.md:46-47). We reproduce
the same discipline: logging is enabled only when the environment variable
``LZMA_RS_TPU_LOG`` is set, and the hot paths consult a module-level boolean
(checked once at import) so the off-path is a single falsy test — never a
logging-module call. Kernels never log.
"""

from __future__ import annotations

import logging
import os

LOG_ENABLED: bool = bool(os.environ.get("LZMA_RS_TPU_LOG"))

logger = logging.getLogger("lzma_rs_tpu")

if LOG_ENABLED:
    logging.basicConfig(level=os.environ.get("LZMA_RS_TPU_LOG", "INFO").upper()
                        if os.environ.get("LZMA_RS_TPU_LOG", "").isalpha()
                        else logging.DEBUG)


def info(fmt: str, *args) -> None:
    """lzma_info! analog (macros.rs:31-41): logged only when enabled."""
    if LOG_ENABLED:
        logger.info(fmt, *args)


def debug(fmt: str, *args) -> None:
    """lzma_debug! analog (macros.rs:16-26)."""
    if LOG_ENABLED:
        logger.debug(fmt, *args)


def trace(fmt: str, *args) -> None:
    """lzma_trace! analog (macros.rs:1-11): per-bit decode tracing."""
    if LOG_ENABLED:
        logger.debug(fmt, *args)
