"""The decoder's step-cost builds: the segment decoder in spin mode, with
parts of its step taken out, so that timing the builds against each other
prices each part.

The port of the JAX kernel's ``LZMA_RS_TPU_ABLATE`` switches
(``lzma_rs_tpu/ops/vmem_decoder.py:55-62``, tested in both TPU decoders),
which ``tools/probe_step_cost.py`` and ``probe_step_cost2.py`` set. Here
they are compile-time option bits of the decoder's own code
(``csrc/lzma_lane.cuh``: ``kSpin``, ``kNoProbRead``, ...), and
``csrc/step_cost.cu`` instantiates the decoder (a warp a lane, table and
window in shared memory) with each case's bits. Nothing reads an
environment variable; the decoder's build sets none of the bits.

- :data:`ABLATIONS`: each case's bits, its JAX name and what it removes.
- :func:`decode_ablated`: one case on every lane. CUDA tensors launch the
  case's kernel or raise; CPU tensors run :func:`decode_ablated_reference`.
  ``decode_ablated.launches`` counts kernel launches.
- :func:`decode_ablated_reference`: the plain PyTorch version, the
  decoder's plain version with the same substitutions and the spin
  restart (``segment_decoder.lockstep_reference``).
- :func:`ablated_occupancy`: a case's lanes resident on an SM.

Under spin every lane runs exactly ``max_steps`` steps of decoding: at the
end of its chunks or on any error it starts its segment again (a fresh
coder, the table refilled, ``outp`` at the first chunk's start), and it
ends with ``ERR_STEP_CAP`` (which is also ``ERR_EOF``'s code: read
``steps == max_steps``, not ``err``). Each lane's restart count comes out
beside ``err``, ``outp`` and ``steps``. The JAX package has no spin or
ablation of its plain decoder: they belong to its TPU kernel, and here to
the port's kernel. Off the main path: the step-cost tools,
``chip_smoke.py`` phase 19 and the tests launch these.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig

__all__ = [
    "ABLATIONS",
    "NOT_PORTED",
    "ablated_occupancy",
    "decode_ablated",
    "decode_ablated_reference",
]


@dataclasses.dataclass(frozen=True)
class Ablation:
    code: int   # the C interface's case number (step_cost.cu)
    opts: int   # the option bits (segment_decoder.SPIN, ...)
    what: str   # what the case takes out of a step


_ALL = (sd.SPIN | sd.NO_PROB_READ | sd.NO_PROB_WRITE | sd.NO_PORT
        | sd.NO_WIN_WRITE | sd.NO_INPUT)

# Each case by its JAX name (the tools' LZMA_RS_TPU_ABLATE values), in the
# tools' order. "refill" is the JAX kernel's input look-ahead refill: here
# the range coder's input byte (kNoInput), not the probability table's
# reset, which lzma_lane.cuh calls refill().
ABLATIONS = {
    "spin": Ablation(0, sd.SPIN, "nothing: the decoder, spinning"),
    "spin,probread": Ablation(
        1, sd.SPIN | sd.NO_PROB_READ,
        "the probability read (a bit reads 0x400)"),
    "spin,probread,probwrite": Ablation(
        2, sd.SPIN | sd.NO_PROB_READ | sd.NO_PROB_WRITE,
        "the probability read and its store"),
    "spin,port": Ablation(
        3, sd.SPIN | sd.NO_PORT,
        "window reads (a copy's source, a match byte read 0)"),
    "spin,winwrite": Ablation(
        4, sd.SPIN | sd.NO_WIN_WRITE, "window stores"),
    "spin,refill": Ablation(
        5, sd.SPIN | sd.NO_INPUT, "the input byte's load (it reads 0)"),
    "spin,probread,probwrite,port,winwrite,refill": Ablation(
        6, _ALL, "all five together"),
}

# The JAX tools' cases with no counterpart here, and why: printed by the
# tools, never timed under another name.
NOT_PORTED = {
    "spin,flush": "not applicable: the JAX kernel's ring flush; this "
                  "decoder keeps the whole window (no ring)",
}


def decode_ablated_reference(
    case, inbuf, win_init, in_start, in_end, out_start, out_end, chunk_meta,
    *, config: SegmentConfig, max_steps: int | None = None,
):
    """The plain PyTorch version of case ``case`` (any device). Returns
    ``(win, err, outp, steps, restarts)``."""
    return sd.lockstep_reference(
        inbuf, win_init, in_start, in_end, out_start, out_end, chunk_meta,
        config=config, max_steps=max_steps, opts=ABLATIONS[case].opts,
    )


def decode_ablated(
    case, inbuf, win_init, in_start, in_end, out_start, out_end, chunk_meta,
    *, config: SegmentConfig, max_steps: int | None = None,
):
    """Run case ``case`` of :data:`ABLATIONS` on every lane. Returns
    ``(win, err, outp, steps, restarts)``.

    CUDA tensors launch the case's kernel on the current stream
    (asynchronously) or raise; CPU tensors take the plain version."""
    a = ABLATIONS[case]
    if max_steps is None:
        max_steps = sd.default_max_steps(config)
    tables = (in_start, in_end, out_start, out_end, chunk_meta)
    sd._check_inputs(config, inbuf, win_init, tables, max_steps)
    dev = inbuf.device
    if dev.type == "cpu":
        return decode_ablated_reference(case, inbuf, win_init, *tables,
                                        config=config, max_steps=max_steps)
    if dev.type != "cuda":
        raise ValueError(f"decode_ablated runs on cuda or cpu, not {dev}")

    from lzma_rs_tpu_torch.ops import build

    smem = sd.check_fits(config)
    lib = build.load_step_cost()
    L = config.L
    with torch.cuda.device(dev):
        win = torch.empty_like(win_init)
        err, outp, steps, restarts = (
            torch.empty(L, dtype=torch.int32, device=dev) for _ in range(4)
        )
        rc = lib.lzl_decode_ablated(
            a.code, inbuf.data_ptr(), win_init.data_ptr(), win.data_ptr(),
            *(t.data_ptr() for t in tables),
            err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
            restarts.data_ptr(), L, config.W_IN, config.W, config.NLIT,
            config.K, int(max_steps), smem,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"decode_ablated {case} launch failed: "
            + lib.lzl_ablated_error_string(rc).decode()
        )
    decode_ablated.launches += 1
    return win, err, outp, steps, restarts


decode_ablated.launches = 0


def ablated_occupancy(case: str, cfg: SegmentConfig) -> int:
    """Lanes of case ``case`` the CUDA runtime keeps resident on one SM at
    ``cfg``'s bucket; needs the card."""
    from lzma_rs_tpu_torch.ops import build

    lib = build.load_step_cost()
    blocks = ctypes.c_int(0)
    rc = lib.lzl_ablated_occupancy(ABLATIONS[case].code, sd.check_fits(cfg),
                                   ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{case} occupancy query failed: "
                           + lib.lzl_ablated_error_string(rc).decode())
    return blocks.value
