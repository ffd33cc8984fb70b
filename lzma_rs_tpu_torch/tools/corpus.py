"""The corpus and archives that ``chip_smoke.py``, ``bench.py`` and the
measurement tools decode.

The corpus is the interpreter's stdlib ``.py`` sources, files in sorted
path order (installed packages left out), cycled to the size asked for:
every machine that runs the port has them, and `.xz` blocks decode
independently, so a repeat changes no block's work. The archives are
written with stdlib ``lzma`` (liblzma) and the port's own `.xz` writers,
so no ``xz`` binary is needed:

- :func:`tpu_archive`: the port's encoder, ``tpu_profile`` (8 KiB blocks,
  lc=0, distances within 2 KiB), CRC32;
- :func:`stock_archive`: liblzma's raw LZMA2 at preset 6 (lc=3) per block,
  CRC64, as ``xz -6 --block-size=N`` writes; 64 KiB blocks for the
  stock-shaped device archive, 1 MiB for the host one.
"""

from __future__ import annotations

import glob
import lzma
import os
import sysconfig
from concurrent.futures import ThreadPoolExecutor


def stdlib_corpus(n_bytes: int) -> tuple:
    """``n_bytes`` of the interpreter's stdlib ``.py`` sources, cycled when
    the installation holds fewer. Returns (corpus, distinct bytes)."""
    root = sysconfig.get_paths()["stdlib"]
    parts, n = [], 0
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, root)
        if "site-packages" in rel or "dist-packages" in rel:
            continue
        with open(path, "rb") as f:
            parts.append(f.read())
        n += len(parts[-1])
        if n >= n_bytes:
            break
    data = b"".join(parts)
    if len(data) < min(n_bytes, 1 << 20):
        raise RuntimeError(f"stdlib sources hold only {len(data)} B")
    return (data * -(-n_bytes // len(data)))[:n_bytes], len(data)


def raw_lzma2(data: bytes, preset: int = 6, **props) -> bytes:
    """stdlib ``lzma``'s raw LZMA2 stream of ``data``."""
    filt = {"id": lzma.FILTER_LZMA2, "preset": preset, **props}
    return lzma.compress(data, format=lzma.FORMAT_RAW, filters=[filt])


def stock_archive(data: bytes, block_size: int = 65536) -> bytes:
    """stdlib ``lzma`` raw LZMA2 (preset 6, lc=3) per ``block_size`` block,
    in an `.xz` container with CRC64 checks, written by the port's
    writers; the blocks are compressed on a thread pool."""
    from lzma_rs_tpu_torch.formats import xz as fmt
    from lzma_rs_tpu_torch.utils.cursor import ByteWriter

    blocks = [data[i:i + block_size] for i in range(0, len(data), block_size)]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        payloads = list(pool.map(raw_lzma2, blocks))
    flags = fmt.StreamFlags(check_method=fmt.CHECK_CRC64)
    w = ByteWriter()
    fmt.write_stream_header(w, flags)
    records = [fmt.write_block(w, p, b, check_method=fmt.CHECK_CRC64)
               for p, b in zip(payloads, blocks)]
    fmt.write_footer(w, flags, fmt.write_index(w, records))
    return w.getvalue()


def tpu_archive(data: bytes, block_size=None) -> bytes:
    """The port's ``tpu_profile`` archive of ``data`` (CRC32); 8 KiB
    blocks unless ``block_size`` is given."""
    from lzma_rs_tpu_torch import xz_compress

    return xz_compress(data, tpu_profile=True, check_method=1,
                       block_size=block_size)
