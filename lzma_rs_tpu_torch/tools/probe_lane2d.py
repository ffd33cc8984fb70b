"""Probe: the bit-decode step and a tiny-op chain, lane by lane.

The port of the JAX package's ``tools/probe_lane2d.py``, with its function
names and rows. On the TPU the probe compared 1-D replicated carries with
2-D ``[S, 128]`` tiles; a CUDA thread per lane has no such layouts, so the
1-D and 2-D functions are one kernel each at L = S * 128 lanes, and the
card's own question is asked instead: how many cycles a dependent integer
op takes (``tinyops_*``), and what a probability-table read costs where the
table lives (``bitdecode_*``, ``placement``: device memory lane-minor, the
TPU layout; lane-major, the segment decoder's; shared memory).

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_lane2d [prefix] [--seed N]

or through the plain versions on the CPU with ``--device cpu``. Each
``f(...)`` returns ``(fn, args, lanes)``: ``fn(*args)`` runs the row
(``fn.plain`` the plain version); ``device`` defaults to the card.
"""

from __future__ import annotations

import torch

from lzma_rs_tpu_torch.ops import probes
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

ROWS = probes.ROWS
_INT32 = (-2**31, 2**31)
_PROBS = (0, 2048)  # the seeded tables: 11-bit probabilities


def _cuda(device):
    return torch.device("cuda") if device is None else torch.device(device)


def _bitdecode(view, shape, lanes, placement, device):
    fn = Probe(probes.bitdecode_chain, view,
               {"init": probes.BITDECODE_INIT}, {"placement": placement},
               probes.BITDECODE_OPS, ROWS + 4 + 1, (_PROBS,))
    x = torch.full(shape, 1024, dtype=torch.int32, device=_cuda(device))
    return fn, (x,), lanes


def bitdecode_1d(L, placement="minor", device=None):
    """[ROWS, L] table in, [1, L] out."""
    return _bitdecode(lambda x: (x[:, None, :],), (ROWS, L), L, placement,
                      device)


def bitdecode_2d(S, placement="minor", device=None):
    """[ROWS, S, 128] table in, [S, 128] out."""
    return _bitdecode(lambda x: (x,), (ROWS, S, 128), S * 128, placement,
                      device)


def _tinyops(view, shape, lanes, device):
    fn = Probe(probes.tinyops_chain, view, {}, {}, probes.TINYOPS_OPS, 2,
               (_INT32,))
    return fn, (torch.zeros(shape, dtype=torch.int32,
                            device=_cuda(device)),), lanes


def tinyops_only_1d(L, device=None):
    """[8, L] in (row 0 is read), [1, L] out."""
    return _tinyops(lambda x: (x[0:1],), (8, L), L, device)


def tinyops_only_2d(S, device=None):
    """[S, 128] in and out."""
    return _tinyops(lambda x: (x,), (S, 128), S * 128, device)


ROWS_OF_TOOL = [
    ("tinyops(150) 1d L=256", lambda d: tinyops_only_1d(256, device=d)),
    ("tinyops(150) 2d S=8 (1024 lanes)", lambda d: tinyops_only_2d(8, device=d)),
    ("tinyops(150) 2d S=32 (4096 lanes)",
     lambda d: tinyops_only_2d(32, device=d)),
    ("bitdecode 1d L=256", lambda d: bitdecode_1d(256, device=d)),
    ("bitdecode 2d S=8 (1024 lanes)", lambda d: bitdecode_2d(8, device=d)),
    ("bitdecode 2d S=16 (2048 lanes)", lambda d: bitdecode_2d(16, device=d)),
    # the card's question: the table's placement, at archive (a)'s width
    ("bitdecode 2d S=16 (2048 lanes) lane-major",
     lambda d: bitdecode_2d(16, "major", device=d)),
    ("bitdecode 2d S=16 (2048 lanes) shared",
     lambda d: bitdecode_2d(16, "shared", device=d)),
]


if __name__ == "__main__":
    main(ROWS_OF_TOOL, prog="probe_lane2d")
