"""`.xz` container encoder.

Mirrors the reference writer (``/root/reference/src/encode/xz.rs:9-162``)
— stream header, block(s), index, footer, check method None — but
generalized to N blocks: large inputs are split into independent blocks
(one LZMA2 stream each), which makes *encode* block-parallel and, more
importantly, makes our own archives block-parallel to decode. A
single-block layout identical to the reference is produced for small
inputs.
"""

from __future__ import annotations

from lzma_rs_tpu_torch.encode.lzma2_enc import lzma2_compress
from lzma_rs_tpu_torch.formats import xz as xz_fmt
from lzma_rs_tpu_torch.utils.cursor import ByteWriter

# Block size for multi-block output. 1 MiB of raw input per block keeps
# per-block overhead negligible (<0.01%) while exposing ample parallelism.
DEFAULT_BLOCK_SIZE = 1 << 20


def xz_compress(
    data: bytes,
    block_size: int | None = None,
    check_method: int = xz_fmt.CHECK_NONE,
    level: int | None = 6,
    props: int = -1,
    dist_cap: int = 0,
) -> bytes:
    """``level`` 1-9 = real compression (native greedy encoder, dictionary
    per block so blocks stay independently decodable); 0/None = stored
    chunks (reference-parity writer, maximally parallel). ``props`` is a
    raw LZMA props byte or -1 for lc=3 lp=0 pb=2 (see lzma2_enc)."""
    block_size = block_size or DEFAULT_BLOCK_SIZE
    flags = xz_fmt.StreamFlags(check_method=check_method)
    writer = ByteWriter()
    xz_fmt.write_stream_header(writer, flags)

    records = []
    if len(data) == 0:
        payload = lzma2_compress(b"", level, props=props, dist_cap=dist_cap)
        records.append(
            xz_fmt.write_block(writer, payload, b"", check_method=check_method)
        )
    else:
        blocks = [
            data[off : off + block_size]
            for off in range(0, len(data), block_size)
        ]
        if len(blocks) > 1:
            # blocks are independent: compress them across host cores (the
            # native encoder releases the GIL)
            import os
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1)
            ) as pool:
                payloads = list(
                    pool.map(
                        lambda b: lzma2_compress(
                            b, level, props=props, dist_cap=dist_cap
                        ),
                        blocks,
                    )
                )
        else:
            payloads = [
                lzma2_compress(blocks[0], level, props=props,
                               dist_cap=dist_cap)
            ]
        for raw, payload in zip(blocks, payloads):
            records.append(
                xz_fmt.write_block(writer, payload, raw, check_method=check_method)
            )

    index_size = xz_fmt.write_index(writer, records)
    xz_fmt.write_footer(writer, flags, index_size)
    return writer.getvalue()
