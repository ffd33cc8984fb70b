"""Probe: a lane-carried index, packed bytes, refills and segment updates.

The port of the JAX package's ``tools/probe_mosaic2.py``, with its
function names, input (``ones[W, L]``) and rows. On the TPU the probe
isolated which construct of a carried index Mosaic failed to relayout; on
the card a thread carries its index in a register, ``p1`` and ``p2`` (a
``[L]`` and a ``[1, L]`` index) are one function, and the question is what
a step costs when each load's address waits on the carried index (p1-p3)
or on the last loaded byte (p6), and what a refill (p4) and a walk over
every row (p5) cost. The one-hot reads and writes are direct indexed
accesses here. On the card, a run that includes P1 also times its library
call (:func:`library_row`).

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_mosaic2 [prefix] [--seed N]

or through the plain versions on the CPU with ``--device cpu``. The shape
(``L``, ``W``) and ``ITERS`` are module values, read when a function is
called, as the TPU tool's are.
"""

from __future__ import annotations

import torch

from lzma_rs_tpu_torch.ops import probes_mosaic as pm
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

L = 128
W = 2048
ITERS = 64
_INT32 = (-2**31, 2**31)


def _ones(device):
    device = torch.device("cuda") if device is None else torch.device(device)
    return torch.ones((W, L), dtype=torch.int32, device=device)


def _probe(wrapper, mode, ops, words, device):
    fn = Probe(wrapper, lambda x: (x,), {"mode": mode}, {}, ops, words,
               (_INT32,), ITERS)
    return fn, (_ones(device),), L


def _row(mode, device):
    # each lane reads min(ITERS, W) rows from 0 and writes its acc
    return _probe(pm.row_chain, mode, pm.ROW_OPS[mode], min(ITERS, W) + 1,
                  device)


def p1(device=None):
    """A ``[L]`` index: ``acc += max(x[idx], 0); idx = (idx + 1) % W``."""
    return _row("clamp", device)


def p2(device=None):
    """p1 with a ``[1, L]`` index: the same function."""
    return _row("clamp", device)


def p3(device=None):
    """p2, and ``x[idx] = v + 1`` where ``v`` is odd."""
    return _row("clamp_write", device)


def p4(device=None):
    """Every 8th step ``s = x[0:2] + i``; ``acc += s``; out ``acc[0]``."""
    return _probe(pm.segment_chain, "refill", pm.segment_ops("refill", W), 3,
                  device)


def p5(device=None):
    """Four segments of W / 4 rows; the lane's ``mask`` segment gets +1;
    ``total`` adds each segment's max; ``mask = (mask + 1) % 4``."""
    return _probe(pm.segment_chain, "segments",
                  pm.segment_ops("segments", W), W + 1, device)


def p6(device=None):
    """``byte = x[idx >> 2] >> 8 (idx & 3) & 0xFF; acc += byte;
    idx = (idx + byte + 1) % W``: each load's address waits on the last
    loaded byte."""
    iters, lanes = ITERS, L

    def words(x):  # the rows this input's walk reads, and the output
        return pm.byte_rows_read(x, iters) / lanes + 1

    return _probe(pm.row_chain, "byte", pm.ROW_OPS["byte"], words, device)


LIBRARY_ROW = "P1 while-carried 1D idx onehot [W,L]"


def clamp_library(x=None, device=None):
    """P1's function as one PyTorch call: ``call()`` is
    ``x[:ITERS].clamp(min=0).sum(0, dtype=torch.int32)`` (from idx 0 the
    walk reads rows 0 .. ITERS - 1 once each where ITERS <= W), on ``x``
    or the tool's input. Returns ``(call, fn, args)``: ``fn(*args)`` is the
    row's kernel."""
    fn, args, _ = p1(device=device if x is None else x.device)
    if x is not None:
        args = (x,)
    t, iters = args[0], fn.iters
    if iters > t.shape[0]:
        raise ValueError(f"ITERS = {iters} passes W = {t.shape[0]}: the "
                         "walk visits rows more than once")
    return (lambda: t[:iters].clamp(min=0).sum(0, dtype=torch.int32)), fn, args


def library_row(device) -> dict:
    """P1's library call on the card: whether it equals the kernel's output
    and its median ms, timed as the rows are (``probe_rows.median_ms``)."""
    from lzma_rs_tpu_torch.tools import probe_rows

    call, fn, args = clamp_library(device=device)
    equal = torch.equal(call(), fn(*args)[0])
    return {"name": LIBRARY_ROW, "equal": equal,
            "ms": probe_rows.median_ms(call)}


ROWS_OF_TOOL = [
    ("P1 while-carried 1D idx onehot [W,L]", lambda d: p1(device=d)),
    ("P2 while-carried [1,L] idx keepdims", lambda d: p2(device=d)),
    ("P3 P2 + masked onehot ref write", lambda d: p3(device=d)),
    ("P4 pl.when ref write in while", lambda d: p4(device=d)),
    ("P5 static-slice swap with carried mask", lambda d: p5(device=d)),
    ("P6 packed-word read + shift extract", lambda d: p6(device=d)),
]


if __name__ == "__main__":
    ran = main(ROWS_OF_TOOL, prog="probe_mosaic2")
    on_card = [r for r in ran if r["device"] != "cpu"]
    if any(r["name"] == LIBRARY_ROW for r in on_card):
        lib = library_row(torch.device(on_card[0]["device"]))
        print(f"{LIBRARY_ROW} library call (clamp and sum of rows 0 .. "
              f"{ITERS - 1}): {lib['ms'] * 1e3:.2f} us, equal to the "
              f"kernel's output: {lib['equal']}", flush=True)
