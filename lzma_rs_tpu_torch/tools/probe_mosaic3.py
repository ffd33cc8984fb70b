"""Probe: loop exits voted by every lane, byte extracts, dependent one-hots.

The port of the JAX package's ``tools/probe_mosaic3.py``, with its
function names, input (``ones[W, L]``) and rows. On the TPU the probe
looked for the construct behind a Mosaic relayout failure (a vector
reduced to a scalar in a while loop's condition) and priced a few
per-lane operations on a table held in VMEM, the core's on-chip memory.
On the card the questions are what a vote over every lane costs an
iteration (P7-P9: one warp holds all lanes), whether a variable shift and a 4-way select are one code
(P11a/b), what a dependent one-hot read of an on-chip table costs (the
block's shared memory plays VMEM's part) by sum or by max (P12s, P12m),
unrolled 8x (P13) and at small heights (P14: 8 rows, P15: 64), and what
a max over 64 rows a step costs, split over a warp a lane (P10 over
fixed rows, P16 over two chunks its last max picks). The one-hot reads
are direct indexed loads here.

P7-P9 and P11 do not read ``x``: their row's input is the loop's start
(``node0``, ``v0``: zeros, as the probe's), and their seeded input a start
that the tool's lacks (P7-P9: one lane at -2^30, the others in [-20, 10],
so every iteration runs and lanes diverge; P11: the full int32 range).

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_mosaic3 [prefix] [--seed N]

or through the plain versions on the CPU with ``--device cpu``. The shape
(``L``, ``W``) and ``ITERS`` are module values, read when a function is
called, as the TPU tool's are.
"""

from __future__ import annotations

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import probes_mosaic3 as pm3
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

L = 128
W = 2048
ITERS = 64
_INT32 = (-2**31, 2**31)
DEEP = -2**30  # a start that keeps P7-P9 running for every iteration


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def _ones(device):
    return torch.ones((W, L), dtype=torch.int32, device=_device(device))


def _zeros(device):
    return torch.zeros(L, dtype=torch.int32, device=_device(device))


def deep_start(rng, shape):
    """P7-P9's seeded start: lanes in [-20, 10], one of them at -2^30."""
    a = rng.integers(-20, 11, size=shape, dtype=np.int32)
    a.flat[rng.integers(0, a.size)] = DEEP
    return a


def _vote(mode, device):
    def ran(node0, iters):
        return pm3.vote_iterations(node0, mode=mode, iters=iters)

    fn = Probe(pm3.vote_chain, lambda n: (n,), {"mode": mode}, {},
               pm3.VOTE_OPS, 2, (deep_start,), ITERS, ran)
    return fn, (_zeros(device),), L


def _onehot(reduce, unroll, rows, device):
    iters = ITERS

    def words(x):  # the table words this input's walk reads, and acc
        return pm3.onehot_rows_read(x[:rows], reduce=reduce,
                                    iters=iters) / L + 1

    fn = Probe(pm3.onehot_chain, lambda x: (x[:rows],),
               {"reduce": reduce, "unroll": unroll}, {},
               pm3.ONEHOT_OPS[reduce], words, (_INT32,), iters)
    return fn, (_ones(device),), L


def p7(device=None):
    """``node += i & 1`` while ``any(node < 5)`` and ``i < ITERS``."""
    return _vote("any", device)


def p8(device=None):
    """P7 with the exit tested by a max over the lanes."""
    return _vote("max", device)


def p9(device=None):
    """P7 with the exit a flag computed in the body after the update (from
    1: the body runs at least once)."""
    return _vote("flag", device)


def p10(device=None):
    """``acc += max_r(x[r] + i)`` over rows ``r < 64``, the add wrapping
    per element before the max."""
    fn = Probe(pm3.window_chain, lambda x: (x,), {"mode": "concat"}, {},
               pm3.WINDOW_OPS["concat"], pm3.WINDOW_ROWS + 1, (_INT32,),
               ITERS)
    return fn, (_ones(device),), L


def _byte(mode, device):
    fn = Probe(pm3.byte_chain, lambda v: (v,), {"mode": mode}, {},
               pm3.BYTE_OPS[mode], 2, (_INT32,), ITERS)
    return fn, (_zeros(device),), L


def p11a(device=None):
    """``v = ((v >> 8 (v & 3)) & 0xFF) + i``: a variable per-lane shift."""
    return _byte("shift", device)


def p11b(device=None):
    """The same value by a select of four constant shifts."""
    return _byte("select", device)


def p12(reduce_sum):
    """``v`` = the one-hot read of ``x[idx]`` by sum (``reduce_sum``) or by
    max (``max(x[idx], 0)``); ``acc += v; idx = (idx + v + 1) % W``."""

    def build(device=None):
        return _onehot("sum" if reduce_sum else "max", 1, W, device)

    return build


def p13(device=None):
    """P12m with 8 dependent reads per loop pass."""
    return _onehot("max", 8, W, device)


def p_small(rows_n):
    """P12m over the first ``rows_n`` rows, ``idx`` mod ``rows_n``."""

    def build(device=None):
        return _onehot("max", 1, rows_n, device)

    return build


def p16(device=None):
    """``row0 = base // 128``; ``v`` = the max over the 32-row chunks
    ``row0`` and ``row0 + 1`` (zeros past the table); ``acc += v; base =
    (base + v + 129) % 16 W``."""
    iters = ITERS

    def words(x):  # the chunks this input's walk reads, and acc
        return pm3.refill_rows_read(x, iters) / L + 1

    fn = Probe(pm3.window_chain, lambda x: (x,), {"mode": "refill"}, {},
               pm3.WINDOW_OPS["refill"], words, (_INT32,), iters)
    return fn, (_ones(device),), L


ROWS_OF_TOOL = [
    ("P7 cond: jnp.any over carried vec", lambda d: p7(device=d)),
    ("P8 cond: max-reduce to scalar", lambda d: p8(device=d)),
    ("P9 cond: carried scalar flag", lambda d: p9(device=d)),
    ("P10 concatenate in body", lambda d: p10(device=d)),
    ("P11a variable per-lane shift", lambda d: p11a(device=d)),
    ("P11b constant-shift 4-way select", lambda d: p11b(device=d)),
    ("P12s one-hot sum-reduce [2048,128]", lambda d: p12(True)(device=d)),
    ("P12m one-hot max-reduce [2048,128]", lambda d: p12(False)(device=d)),
    ("P13 8x-unrolled dependent one-hots", lambda d: p13(device=d)),
    ("P14 one-hot over [8, L]", lambda d: p_small(8)(device=d)),
    ("P15 one-hot over [64, L]", lambda d: p_small(64)(device=d)),
    ("P16 refill mask-select + concat + scratch", lambda d: p16(device=d)),
]


if __name__ == "__main__":
    main(ROWS_OF_TOOL, prog="probe_mosaic3")
