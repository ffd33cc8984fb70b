"""Probe: lane state in memory against registers, and a real-weight step.

The port of the JAX package's ``tools/probe_state_in_ref.py``, with its
function names and rows. ``y1`` / ``y2`` run the bit-decode step with its
state loaded and stored through device memory every iteration (one
``[NST, L]`` array, or four ``[L]`` arrays); ``y4`` is the decoder's step
in miniature: ``nops`` tiny ops, the bit decode and a ring window's reads
and masked write, with the state in registers.

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_state_in_ref [y1..y6] [--seed N]

or through the plain versions on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import torch

from lzma_rs_tpu_torch.ops import probes
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

ROWS = probes.ROWS
S = 8
NST = probes.NST
_PROBS = (0, 2048)


def _table(s_dim, device):
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.full((ROWS, s_dim, 128), 1024, dtype=torch.int32,
                      device=device)


def y1(s_dim=S, device=None):
    """State in one [NST, S, 128] memory array."""
    fn = Probe(probes.bitdecode_chain, lambda x: (x,),
               {"init": probes.Y_INIT}, {"state": "slots"},
               probes.BITDECODE_OPS, ROWS + NST + 1, (_PROBS,))
    return fn, (_table(s_dim, device),), s_dim * 128


def y2(device=None):
    """State in four [S, 128] memory arrays."""
    fn = Probe(probes.bitdecode_chain, lambda x: (x,),
               {"init": probes.Y_INIT}, {"state": "arrays"},
               probes.BITDECODE_OPS, ROWS + 4 + 1, (_PROBS,))
    return fn, (_table(S, device),), S * 128


def y4(s_dim=8, nops=500, device=None):
    """nops // 3 tiny-op rounds, the bit decode and the ring window."""
    rounds = nops // 3
    fn = Probe(probes.realweight_step, lambda x: (x,), {"rounds": rounds},
               {}, probes.realweight_ops(rounds),
               ROWS + probes.RING + 16 + 1, (_PROBS,))
    return fn, (_table(s_dim, device),), s_dim * 128


ROWS_OF_TOOL = [
    ("y1 state-in-ref [NST,S,128]", lambda d: y1(device=d)),
    ("y2 state-in-4-refs [S,128]", lambda d: y2(device=d)),
    ("y3 state-in-ref S=16", lambda d: y1(16, device=d)),
    ("y4 real-weight S=8 nops=500", lambda d: y4(8, 500, device=d)),
    ("y5 real-weight S=16 nops=500", lambda d: y4(16, 500, device=d)),
    ("y6 real-weight S=8 nops=250", lambda d: y4(8, 250, device=d)),
]


if __name__ == "__main__":
    main(ROWS_OF_TOOL, prog="probe_state_in_ref")
