"""Probe: chained and independent table reads, blend writes, narrow tables.

The port of the JAX package's ``tools/probe_round4.py``, with its row
names (``CASES``, in its order), build functions, shapes and inputs:
``ITERS = 16384`` iterations over a ``[ROWS = 784, S = 16, 128]`` int32 table
(2,048 lanes), ``arange % 2047`` (narrow tables ``arange % 97``), state
``[4, S, 128]`` with slot 0 the seed ``full(1)`` (the tool's first call;
``narrow_1`` has no seed: zeros). On the TPU the probe asked what a
one-hot pass over the table (in VMEM scratch) costs and whether Mosaic
fuses passes; on the card the same rows ask what a lane's dependent reads
of its column in shared memory cost (``sel1``-``sel4``: a block holds 32
lanes' 3,136-byte columns, ``sel_s`` 16 lanes' 8 KB ones, as the
decoder holds its probability table; the 6.4 MB lane-minor table is
staged from device memory once a call), whether independent reads
overlap (``par3``, ``fused3``), what writes before the reads add
(``blend_par3``, ``fusedb*``, ``blendmask512``, ``blendoldw512``),
whether a narrower table helps (``i16_1``, ``i8_1``), and what a read of
an 8-row table costs (``gather_taa``); ``null`` is the loop's floor.
``wide4`` is ``sel1``, ``fusedb3_B16`` is ``fusedb3`` and ``sel_s2f4`` is
``sel_s2`` on the card (the same function on the same memory): controls.

The seeded input has the table over its type's full range and every
state slot over the full int32 range (``v * 40499`` wraps; slots 1-3
start nonzero). The kernels are held against their plain versions at
``CHECK_ITERS`` iterations (the plain version at the tool's 16,384 takes
seconds a row) and timed at ``ITERS`` and ``LONG_ITERS``.

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_round4 [prefix] [--seed N]

or through the plain versions on the CPU with ``--device cpu``. The shape
(``ROWS``, ``S``) and ``ITERS`` are module values, read when a function is
called, as the TPU tool's are.
"""

from __future__ import annotations

import torch

from lzma_rs_tpu_torch.ops import probes_round4 as pr4
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

ITERS = 16384
LONG_ITERS = 32768
CHECK_ITERS = 1024
ROWS = 784
S = 16
_I32 = torch.int32
_RANGE = {torch.int32: (-2**31, 2**31), torch.int16: (-2**15, 2**15),
          torch.int8: (-2**7, 2**7)}


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def _table(shape, dev, mod=2047, dtype=_I32):
    """The tool's table: ``arange % mod`` in ``shape``."""
    n = 1
    for d in shape:
        n *= d
    return (torch.arange(n, dtype=torch.int64, device=dev) % mod).to(
        dtype).reshape(shape)


def _state(s_dim, seeded, dev):
    st = torch.zeros((4, s_dim, 128), dtype=_I32, device=dev)
    if seeded:
        st[0] = 1
    return st


def _row(wrapper, kwargs, x, *, s_dim=None, seeded=True):
    """A row over table ``x`` (the tool's shape) and state ``[4, s_dim,
    128]``: the Probe, its inputs and its lanes."""
    s_dim = S if s_dim is None else s_dim
    lanes = s_dim * 128
    blend = wrapper is pr4.blend_chain
    mode = kwargs["mode"]
    n = kwargs.get("n", (pr4.BLEND_NS if blend else pr4.SELECT_NS)[mode][0])
    rows = x.numel() // lanes
    ops = (pr4.blend_ops if blend else pr4.select_ops)(mode, n)
    elem = x.element_size()
    mask = kwargs.get("mask", 1023)
    words = (pr4.rows_reached(mode, n, mask, rows, blend=blend) * elem / 4
             + 4 + 1)  # the rows the walk can reach, st in, slot 0 out
    fn = Probe(wrapper,
               lambda t, st: (t.reshape(-1, st[0].numel()),
                              st.reshape(4, -1)),
               kwargs, {}, ops, words, (_RANGE[x.dtype], _RANGE[_I32]),
               ITERS, None, LONG_ITERS, CHECK_ITERS)
    return fn, (x, _state(s_dim, seeded, x.device)), lanes


def sel_n(n):
    """``n`` chained reads per iteration: ``acc += x[clip(mix(st0) + j)];
    st0 = acc & 0xFFFF``, each index from the slot the last read set."""

    def build(device=None):
        return _row(pr4.select_chain, {"mode": "sel", "n": n},
                    _table((ROWS, S, 128), _device(device)))

    return build


def par3():
    """Three independent reads at ``m``, ``m + 17``, ``m + 33``."""

    def build(device=None):
        return _row(pr4.select_chain, {"mode": "par3"},
                    _table((ROWS, S, 128), _device(device)))

    return build


def blend_par3():
    """Two writes (``st1`` at ``m + 5``, ``st2`` at ``m + 9``), then
    ``par3``'s reads of the written table."""

    def build(device=None):
        return _row(pr4.blend_chain, {"mode": "par3"},
                    _table((ROWS, S, 128), _device(device)))

    return build


def fused_n(n, with_blend, B=8):
    """``n`` independent reads at ``m + 17 j`` (``with_blend``: after the
    two writes of ``blend_par3``). ``B`` set Mosaic's traversal only."""

    def build(device=None):
        rows = ROWS // B * B
        wrapper = pr4.blend_chain if with_blend else pr4.select_chain
        return _row(wrapper, {"mode": "fused", "n": n},
                    _table((rows, S, 128), _device(device)))

    return build


def narrow_1(dtype, mult):
    """``sel1`` over a ``[784 mult, S, 128]`` table of ``dtype`` (``arange
    % 97``), the entry sign-extended; no seed: the state starts at
    zero."""

    def build(device=None):
        return _row(pr4.select_chain, {"mode": "sel", "n": 1},
                    _table((ROWS * mult, S, 128), _device(device), 97,
                           dtype), seeded=False)

    return build


def wide4():
    """The table viewed as ``[196, 4, S, 128]``, read at ``m``: ``sel1``."""

    def build(device=None):
        return _row(pr4.select_chain, {"mode": "sel", "n": 1},
                    _table((ROWS // 4, 4, S, 128), _device(device)))

    return build


def gather_taa():
    """``st0 += x[st0[0] & 7]`` of an ``[8, S, 128]`` table: lane ``(s,
    m)`` adds row ``st0[0, m] & 7`` of column ``(0, m)``."""

    def build(device=None):
        return _row(pr4.select_chain, {"mode": "gather"},
                    _table((8, S, 128), _device(device)))

    return build


def null_case():
    """``st0 = (5 st0 + 1) & 0xFFFF``: the loop alone."""

    def build(device=None):
        dev = _device(device)
        return _row(pr4.select_chain, {"mode": "null"},
                    torch.zeros((8, S, 128), dtype=_I32, device=dev))

    return build


def sel_s(s_dim, rows, fold=1):
    """``sel1`` over ``[rows, s_dim, 128]`` with the index ``(st0 * 40499)
    & 2047``; ``fold`` stores it as ``[rows / fold, fold s_dim, 128]``
    (the same memory)."""

    def build(device=None):
        return _row(pr4.select_chain, {"mode": "sel", "n": 1, "mask": 2047},
                    _table((rows // fold, fold * s_dim, 128),
                           _device(device)), s_dim=s_dim)

    return build


def blend_mask(rows):
    """``x[m] ^= (x[m] ^ st1) & (st2 | 0xFF)``, then ``w0 = x[m + 1]``;
    ``st1 = w0``, ``st2 = (st1 >> 8) & 0xFFFF``."""

    def build(device=None):
        return _row(pr4.blend_chain, {"mode": "mask"},
                    _table((rows, S, 128), _device(device)))

    return build


def blend_oldw(rows):
    """``x[m] = st1``, then ``w0 = x[m + 1]``, ``old = x[m + 2]``; ``st1 =
    (old & -256) | (w0 & 0xFF)``."""

    def build(device=None):
        return _row(pr4.blend_chain, {"mode": "oldw"},
                    _table((rows, S, 128), _device(device)))

    return build


CASES = {
    "null": null_case(),
    "sel1": sel_n(1),
    "sel2": sel_n(2),
    "sel3": sel_n(3),
    "sel4": sel_n(4),
    "par3": par3(),
    "blend_par3": blend_par3(),
    "fused3": fused_n(3, False),
    "fusedb3": fused_n(3, True),
    "fusedb3_B16": fused_n(3, True, B=16),
    "fusedb7": fused_n(7, True),
    "i16_1": narrow_1(torch.int16, 2),
    "i8_1": narrow_1(torch.int8, 4),
    "wide4": wide4(),
    "gather_taa": gather_taa(),
    "sel_s2": sel_s(2, 2048),
    "sel_s8": sel_s(8, 2048),
    "sel_s2f4": sel_s(2, 2048, fold=4),
    "blendmask512": blend_mask(512),
    "blendoldw512": blend_oldw(512),
}
ROWS_OF_TOOL = list(CASES.items())


if __name__ == "__main__":
    main(ROWS_OF_TOOL, prog="probe_round4")
