"""Probe: the bit decode's stages, added one by one on the same state.

The port of the JAX package's ``tools/probe_lane2d_bisect.py``, with its
sixteen row names and its command line (the rows whose name holds the
first argument). On the TPU the probe bisected which stage of the 2-D bit
decode Mosaic could not lay out (it printed ``OK`` or ``FAIL``); on the
card each body runs and is timed, and the differences between bodies are
what a stage costs a thread's dependent chain: v1 the index climb alone,
v2 + the table load, v3 + the range coder's arithmetic, v4 + the store
(``ops/probes.py``'s ``bitdecode_chain``), v5 the same with a blend write;
v2m, v2max and v2bt other forms of v2's read; w1-w8 the read in
isolation (a column sum, a constant row, a mask, a load after a one-step
index move). The bodies are in ``ops/probes_bisect.py``.

A row's inputs are the table (``full(1024)`` of ``[ROWS, S, 128]``, the
probe's) and the start ``[4, S, 128]`` (idx, acc, rng, cod: ``0, 1, -1,
12345`` in every lane, the probe's). On them ``p & 1`` is 0, ``p & 0x7FF``
is 1024 and ``cod`` stays under ``bound``: every bit is 0. The seeded
input has a table over the full int32 range and starts over the full int32
range, idx near 2^31 - 1 on some lanes (the climb and the step wrap before
the clip) and acc small on some (the climb's count varies).

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_lane2d_bisect [substring] [--seed N]

or through the plain version on the CPU with ``--device cpu``. ``ITERS``
and ``S`` are module values, read when a row is built, as the TPU tool's
are; ``ROWS`` sets the clip and stays 648.
"""

from __future__ import annotations

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import probes_bisect as pb
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

ITERS = pb.ITERS
ROWS = pb.ROWS
S = 8
LONG_ITERS = 8192
_INT32 = (-2**31, 2**31)
# the TPU tool's rows, in its order
NAMES = ("v1 idx-only", "v2 +onehot-read", "v3 +uint-arith",
         "v4 +masked-write", "v5 blend-write", "v2m mult-mask",
         "v2max max-reduce", "v2bt broadcast_to", "w1 reduce-only",
         "w2 const-cmp", "w3 mask-reduce", "w4 cmp-no-reduce",
         "w5 sel-tab-reduce", "w6 mult-tab-reduce", "w7 split-reduce",
         "w8 mask-plus-consttab")


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def seeded_start(rng, shape):
    """idx, acc, rng, cod ([4, *lanes]) over the full int32 range; on
    every eighth lane idx within 10 of 2^31 - 1 and acc in [0, 12) (its
    low bit and the climb's count vary, and both wrap idx before the
    clip)."""
    st = rng.integers(*_INT32, size=shape, dtype=np.int64).reshape(4, -1)
    n = len(st[0, ::8])
    st[0, ::8] = 2**31 - 1 - rng.integers(0, 10, size=n)
    st[1, ::8] = rng.integers(0, 12, size=n)
    return st.reshape(shape).astype(np.int32)


def bisect(body: str, device=None):
    """Row ``body`` (``v1`` ... ``w8``): ``(fn, (table, start), lanes)``."""
    dev = _device(device)
    lanes, iters = S * 128, ITERS

    def words(table, start):  # the rows this run's walk reads
        return pb.body_words(table, start, body=body, iters=iters)

    fn = Probe(pb.bisect_chain, lambda t, s: (t, s), {"body": body}, {},
               pb.body_ops(body), words, (_INT32, seeded_start), iters,
               None, LONG_ITERS)
    table = torch.full((ROWS, S, 128), 1024, dtype=torch.int32, device=dev)
    start = torch.tensor(pb.INIT, dtype=torch.int32, device=dev)
    start = start[:, None, None].expand(4, S, 128).contiguous()
    return fn, (table, start), lanes


ROWS_OF_TOOL = [(name, lambda d, b=name.split()[0]: bisect(b, device=d))
                for name in NAMES]


if __name__ == "__main__":
    main(ROWS_OF_TOOL, prog="probe_lane2d_bisect", substring=True)
