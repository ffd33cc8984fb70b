"""Probe: a table read-modify-write per step, its reset, and a scheduled term.

The port of the JAX package's ``tools/probe_mosaic4.py``, with its
function names (``build``, ``build2``), variants and input (``zeros[4,
L]``, ``build2``'s ``zeros[8, L]``). On the TPU the probe was a compile-
only bisect of a Mosaic lowering failure; on the card each variant runs
and is timed. Every lane walks its own column of a ``[512, L]`` table
filled with 7: it reads ``table[idx]``, writes it back plus one where
``acc > 0`` and moves ``idx`` by the value read (the decoder's probability
update, ``base``); the reset variants also set the lane's whole column to
``0x400``, LZMA's initial probability, every 17 steps (the state reset at
an LZMA2 chunk); ``build2``'s variants add a term of an ``[8, L]`` input,
picked by ``clip(acc, 0, 7)``, instead of writing. The TPU tool runs
``build2`` from no entry point (only ``main2`` lists it); this tool runs
all seven rows.

A row's inputs are ``x`` (read only for its lane count by ``build``, as
the probe reads it as ``x * 0``; ``build2``'s ``k``), the loop's start
``start`` ([2, L]: idx, acc; zeros, as the probe's) and ``it0`` ([1]:
zero). The seeded input has lanes apart: idx outside [0, 512) on some
lanes, acc negative on some and near 2^31 on one, ``k`` over the full
int32 range, and ``it0`` in [0, 56), so the run is 16 to 64 steps (and a
call at a limit of 0 runs none: the set-up alone).

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_mosaic4 [prefix] [--seed N]

or through the plain version on the CPU with ``--device cpu``. ``L`` and
``ITERS`` (the loop's limit of ``it``) are module values, read when a
function is called, as the TPU tool's are.
"""

from __future__ import annotations

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import probes_mosaic4 as pm4
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

L = 128
ITERS = 64
LONG_ITERS = 8192
_INT32 = (-2**31, 2**31)


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def seeded_start(rng, shape):
    """idx, acc ([2, L]): idx in [-600, 1100) (so outside [0, 512) on about
    two lanes in three) or, on every fourth lane, over the full int32
    range; acc in [-40, 40) (writes start, and resets fall, at different
    steps), one lane at 2^31 - 5 (acc wraps)."""
    idx = rng.integers(-600, 1100, size=shape[1])
    idx[::4] = rng.integers(*_INT32, size=len(idx[::4]))
    acc = rng.integers(-40, 40, size=shape[1])
    acc[rng.integers(0, shape[1])] = 2**31 - 5
    return np.stack([idx, acc]).astype(np.int32)


def seeded_it0(rng, shape):
    """A seeded start of the step counter ``it``, in [0, 56)."""
    return rng.integers(0, 56, size=shape).astype(np.int32)


def _row(variant, rows_x, device):
    dev = _device(device)
    words = 3 + (0 if rows_x == 4 else pm4.SCHED)  # start, out; k

    def ran(x, start, it0, iters):
        return pm4.steps_run(int(it0[0]), iters)

    fn = Probe(pm4.table_chain, lambda x, s, i: (x, s, i),
               {"variant": variant}, {}, pm4.step_ops(variant), words,
               (_INT32, seeded_start, seeded_it0), ITERS, ran, LONG_ITERS)
    args = (torch.zeros((rows_x, L), dtype=torch.int32, device=dev),
            torch.zeros((2, L), dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    return fn, args, L


def build(variant, device=None):
    """``base``, ``when_reset``, ``when_reset_hoisted``,
    ``when_reset_refed``: a round's refill of the tile, then 16 steps of
    ``v = table[idx]``; ``table[idx] = v + 1`` where ``acc > 0``; ``idx =
    (idx + v) % 512; acc += 1``; the resets set the lane's column to 0x400
    where ``acc % 17 == 0``."""
    return _row(variant, 4, device)


def build2(variant, device=None):
    """``sched8_max``, ``sched8_sum``, ``sched8_blend``: no refill, no
    write; ``v = table[idx]`` plus ``max(k[ci], 0)`` or ``k[ci]``, ``ci =
    clip(acc, 0, 7)``."""
    return _row(variant, pm4.SCHED, device)


ROWS_OF_TOOL = (
    [(v, lambda d, v=v: build(v, device=d)) for v in pm4.BUILD_VARIANTS]
    + [(v, lambda d, v=v: build2(v, device=d)) for v in pm4.SCHED_VARIANTS])


if __name__ == "__main__":
    main(ROWS_OF_TOOL, prog="probe_mosaic4")
