"""Constants and the static shape bucket of the segment decoder.

The micro-op node ids, error codes, literal row size, chunk-meta packing
and the state transitions are the ones of the JAX package's gen-1/gen-2
kernels (``lzma_rs_tpu/ops/vmem_decoder.py``); ``tests/test_torch_consts.py``
holds the two packages equal. ``SegmentConfig`` keeps only the budget
fields of the JAX ``KernelConfig``: the unroll, tile, maintenance, ring,
tree-bits, LIT4 and GAPFREE knobs shape the Mosaic lowering, and the
CUDA kernel has no use for them.
"""

from __future__ import annotations

import dataclasses

import torch

from lzma_rs_tpu_torch.models.state import PROB_INIT, ProbLayout, make_layout

__all__ = [
    "PROB_INIT",
    "LIT_ROW",
    "SegmentConfig",
    "pack_chunk_meta",
    "prob_layout",
    "after_lit",
    "after_match",
    "after_rep",
    "after_shortrep",
]

# Micro-op node ids (the DFA of ops/lane_decoder.py and the VMEM kernels).
# DONE and ERROR are the highest ids: a lane is active while node < N_DONE.
N_ISMATCH = 0
N_LIT = 1
N_LITM = 2
N_ISREP = 3
N_ISREPG0 = 4
N_ISREP0LONG = 5
N_ISREPG1 = 6
N_ISREPG2 = 7
N_LEN_CHOICE = 8
N_LEN_CHOICE2 = 9
N_LEN_TREE = 10
N_POSSLOT = 11
N_SPECPOS = 12
N_DIRECT = 13
N_ALIGN = 14
N_COPY = 15
N_CHUNK = 16
N_DONE = 17
N_ERROR = 18

# Per-lane error codes. Any nonzero code sends the stream to the host
# replay, which reproduces the reference's exact error.
ERR_NONE = 0
ERR_EOF = 1        # the range coder needs a byte past the chunk's input
ERR_DIST_OUT = 2   # match distance beyond the segment's output so far
ERR_SIZE = 4       # a symbol runs past the chunk's unpacked size
ERR_EOS_EXTRA = 5  # end-of-stream marker inside a sized chunk
ERR_SHORT = 6      # chunk too short for range-coder init (or off the buffers)
ERR_MATCHDIST = 7  # matched-literal distance beyond the output so far
# A lane that runs out of steps is corrupt; the JAX runtime reports a lane
# that stopped short with code 1 as well (parallel/runtime.py).
ERR_STEP_CAP = 1

LIT_ROW = 0x300  # 768 probabilities per literal context


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Static shape bucket of one ``decode_segments`` call.

    ``L`` lanes (independent dict-reset segments), each with a ``W``-byte
    window (its whole output), ``W_IN`` bytes of staged compressed input
    and at most ``K`` LZMA chunks; ``NLIT`` literal contexts
    (``lc + lp <= log2(NLIT)``) and ``NPS`` pos-states (``1 << pb <= NPS``)
    bound the props the eligibility gate admits."""

    L: int
    W: int
    W_IN: int
    NLIT: int = 8
    K: int = 8
    NPS: int = 16

    # The shared eligibility gate (parallel/runtime.check_vmem_eligibility)
    # reads RING; the CUDA kernel has no ring mode. Not a dataclass field.
    RING = 0

    def __post_init__(self):
        if self.NLIT not in (1, 2, 4, 8):
            raise ValueError(f"NLIT={self.NLIT}: must be 1, 2, 4 or 8")
        if self.NPS not in (4, 16):
            raise ValueError(f"NPS={self.NPS}: must be 4 or 16")
        if min(self.L, self.W, self.W_IN, self.K) < 1:
            raise ValueError(f"empty shape bucket {self}")


def prob_layout(nlit: int) -> ProbLayout:
    """The per-lane probability table: models/state.py's flat layout for
    ``lc + lp <= log2(nlit)``."""
    return make_layout(nlit.bit_length() - 1)


def pack_chunk_meta(reset_state, lcs, lps, pbs, valid):
    """Pack the five small per-chunk fields into one int32 table
    (the JAX kernels' ``chunk_meta`` layout)."""
    return (
        (reset_state & 3)
        | (lcs << 2)
        | (lps << 6)
        | (pbs << 9)
        | (valid << 12)
    )


# State transitions in closed form (models/state.py tables):
#   after_lit:      0..3 -> 0, 4..9 -> s-3, 10..11 -> s-6
#   after_match:    <7 -> 7,  else 10
#   after_rep:      <7 -> 8,  else 11
#   after_shortrep: <7 -> 9,  else 11


def after_lit(state: torch.Tensor) -> torch.Tensor:
    """The state after a literal."""
    return torch.clamp(state - 3 - 3 * (state >= 10).long(), min=0)


def after_match(state: torch.Tensor) -> torch.Tensor:
    """The state after a match."""
    return 7 + 3 * (state >= 7).long()


def after_rep(state: torch.Tensor) -> torch.Tensor:
    """The state after a rep match."""
    return 8 + 3 * (state >= 7).long()


def after_shortrep(state: torch.Tensor) -> torch.Tensor:
    """The state after a short rep (one byte at rep0)."""
    return 9 + 2 * (state >= 7).long()
