"""The segment decoder's variants: each part of the decoder's design,
priced by timing builds that leave it out against each other.

``csrc/decode_variants.cu`` instantiates the decoder's kernel template
(``csrc/segment_kernel.cuh`` over ``csrc/lzma_lane.cuh``) at the placements
of :data:`VARIANTS`, from the first design (``V0``: a thread a lane, table
and window in global memory) to the decoder itself (``V3``). Every variant
computes :func:`~lzma_rs_tpu_torch.ops.segment_decoder.decode_segments`'s
function, so its plain version is the decoder's. They are off the main
path: ``chip_smoke.py`` phase 14 and the on-card tests launch them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig, prob_layout

__all__ = ["VARIANTS", "decode_variant", "smem_bytes", "variant_occupancy"]


@dataclasses.dataclass(frozen=True)
class Variant:
    code: int           # the C interface's variant number
    what: str
    probs_shared: bool  # the probability table in shared memory
    win_shared: bool    # the window in shared memory


VARIANTS = {
    "V0": Variant(0, "a thread a lane, 128-thread blocks, table and window "
                  "in global memory, one byte copied a step", False, False),
    "V1": Variant(1, "a warp a lane, table and window in global memory",
                  False, False),
    "V2": Variant(2, "V1 with the table in shared memory", True, False),
    "V3": Variant(3, "V2 with the window in shared memory (the decoder)",
                  True, True),
    "V4": Variant(4, "V3 with one thread copying a byte a step", True, True),
    "V5": Variant(5, "V3 with the input read through a look-ahead word",
                  True, True),
    "S3": Variant(6, "V4 run by one thread, a lane a block (no warp team)",
                  True, True),
}


def smem_bytes(name: str, cfg: SegmentConfig) -> int:
    """Dynamic shared memory of one block of variant ``name``."""
    v = VARIANTS[name]
    return ((sd.probs_bytes(cfg.NLIT) if v.probs_shared else 0)
            + (cfg.W if v.win_shared else 0))


def decode_variant(
    name, inbuf, win_init, in_start, in_end, out_start, out_end, chunk_meta,
    *, config: SegmentConfig, max_steps: int | None = None,
):
    """Decode every lane with variant ``name``. Returns ``(win, err, outp,
    steps)``, as ``decode_segments`` does.

    CUDA tensors launch the variant's kernel on the current stream or
    raise; CPU tensors take the decoder's plain version."""
    v = VARIANTS[name]
    if max_steps is None:
        max_steps = sd.default_max_steps(config)
    tables = (in_start, in_end, out_start, out_end, chunk_meta)
    sd._check_inputs(config, inbuf, win_init, tables, max_steps)
    dev = inbuf.device
    if dev.type == "cpu":
        return sd.decode_segments_reference(
            inbuf, win_init, *tables, config=config, max_steps=max_steps
        )
    if dev.type != "cuda":
        raise ValueError(f"decode_variant runs on cuda or cpu, not {dev}")
    smem = smem_bytes(name, config)
    if smem > sd.SMEM_PER_BLOCK:
        raise ValueError(f"{name} at W={config.W} NLIT={config.NLIT} needs "
                         f"{smem} B of shared memory; a block holds "
                         f"{sd.SMEM_PER_BLOCK}")
    if name == "V5" and config.W_IN % 4:
        raise ValueError(f"V5 reads whole words: W_IN={config.W_IN}")

    from lzma_rs_tpu_torch.ops import build

    lib = build.load_variants()
    L = config.L
    nprobs = prob_layout(config.NLIT).total
    with torch.cuda.device(dev):
        # a window in global memory is decoded in place
        win = (torch.empty_like(win_init) if v.win_shared
               else win_init.clone())
        probs = (torch.empty(0, dtype=torch.uint16, device=dev)
                 if v.probs_shared else
                 torch.empty((L, nprobs), dtype=torch.uint16, device=dev))
        err, outp, steps = (
            torch.empty(L, dtype=torch.int32, device=dev) for _ in range(3)
        )
        rc = lib.lzl_decode_variant(
            v.code, inbuf.data_ptr(), win_init.data_ptr(), win.data_ptr(),
            probs.data_ptr(), *(t.data_ptr() for t in tables),
            err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
            L, config.W_IN, config.W, nprobs, config.NLIT, config.K,
            int(max_steps), smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"decode_variant {name} launch failed: "
            + lib.lzl_variant_error_string(rc).decode()
        )
    decode_variant.launches += 1
    return win, err, outp, steps


decode_variant.launches = 0


def variant_occupancy(name: str, cfg: SegmentConfig) -> int:
    """Blocks of variant ``name`` that the CUDA runtime keeps resident on
    one SM at ``cfg``'s bucket; needs the card."""
    from lzma_rs_tpu_torch.ops import build

    lib = build.load_variants()
    blocks = ctypes.c_int(0)
    rc = lib.lzl_variant_occupancy(VARIANTS[name].code,
                                   smem_bytes(name, cfg),
                                   ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{name} occupancy query failed: "
                           + lib.lzl_variant_error_string(rc).decode())
    return blocks.value
