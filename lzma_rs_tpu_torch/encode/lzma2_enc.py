"""LZMA2 encoder.

Two modes:

- ``level=0`` / no native library: uncompressed chunks only — the exact
  capability mirror of the reference encoder
  (``/root/reference/src/encode/lzma2.rs:4-26``): <=64 KiB chunks, control
  ``0x01`` (uncompressed + dict reset), ``(n-1)`` u16 BE, raw bytes,
  ``0x00`` terminator.
- ``level>=1`` (default 6): real compression via the native greedy
  hash-chain LZMA encoder — 64 KiB chunks, dictionary carried across
  chunks, state/props reset per chunk, stored-chunk fallback for
  incompressible data. Output is accepted by liblzma, the reference, and
  all of our engines. This exceeds the reference's capability floor.
"""

from __future__ import annotations

from typing import Optional

CHUNK = 0x10000
DEFAULT_LEVEL = 6


def _store(data: bytes) -> bytes:
    out = bytearray()
    for off in range(0, len(data), CHUNK):
        piece = data[off : off + CHUNK]
        out.append(1)  # uncompressed, reset dict
        out += (len(piece) - 1).to_bytes(2, "big")
        out += piece
    out.append(0)
    return bytes(out)


def lzma2_compress(
    data: bytes,
    level: Optional[int] = DEFAULT_LEVEL,
    chunk_size: int = CHUNK,
    props: int = -1,
    dist_cap: int = 0,
) -> bytes:
    """``chunk_size`` sets unpacked bytes per LZMA2 chunk (256..65536).
    Smaller chunks cost a little ratio but bound the per-chunk work unit
    (the VMEM TPU kernel wants segments <= its window). ``props`` is a raw
    LZMA props byte (lc + 9*(lp + 5*pb)) or -1 for the default lc=3 lp=0
    pb=2; small lc+lp shrinks the literal-probability table the TPU kernel
    must keep in VMEM (see ops/vmem_decoder.py). ``dist_cap`` (0 =
    uncapped) bounds match distances so the archive decodes on the TPU
    ring-window kernel, which keeps only the last ``dist_cap`` bytes of
    history resident."""
    data = bytes(data)
    if props != -1:
        # Validate here so callers get an error instead of the native
        # encoder's silent clamp to the default lc=3 lp=0 pb=2 (which
        # would produce a structurally different archive than requested).
        if not 0 <= props < 225:
            raise ValueError(
                f"invalid LZMA props byte {props}: must be in [0, 225)"
            )
        lc = props % 9
        lp = (props // 9) % 5
        if lc + lp > 4:
            raise ValueError(
                f"unsupported LZMA props: lc + lp ({lc} + {lp}) must be <= 4"
            )
    if level:
        try:
            from lzma_rs_tpu_torch.native import loader

            lib = loader.load()
        except Exception:
            lib = None
        if lib is not None:
            return lib.lzma2_compress(
                data, int(level), int(chunk_size), int(props), int(dist_cap)
            )
    return _store(data)
