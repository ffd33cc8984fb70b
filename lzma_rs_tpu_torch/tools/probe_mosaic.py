"""Probe: per-lane dynamic indexing (gathers, indexed reads and writes).

The port of the JAX package's ``tools/probe_mosaic.py``, with its function
names, inputs and rows. On the TPU the probe asked which dynamic-indexing
patterns Mosaic lowers and what each costs; on the card every pattern is
a plain indexed load or store, and the question is what the access
costs: a gather along a row (A, C: a warp an output, its 32 loads of a
step neighbouring words) or down a column (B, F: a warp an output below
4,096 outputs, else a thread an output, a warp's loads coalesced where
its columns' rows agree), a read-modify-write per row (D: a warp a row,
its adds atomic), and one thread's load-after-store chain (E, over the
row in shared memory). The one-hot forms of C and D are direct indexed
accesses here. On the card, a run that includes D's main row also times
its library call (:func:`library_row`).

Run on the card::

    python -m lzma_rs_tpu_torch.tools.probe_mosaic [prefix] [--seed N]

or through the plain versions on the CPU with ``--device cpu``. Each
function returns ``(fn, args, lanes)``: ``fn(*args)`` runs the row
(``fn.plain`` the plain version), ``lanes`` is its threads, for the
gathers its output elements (the bound's count of work: the kernel gives
an output a warp or a thread, ``ops/probes_mosaic.py::gather_launch``);
``device`` defaults to the card.
"""

from __future__ import annotations

import torch

from lzma_rs_tpu_torch.ops import probes_mosaic as pm
from lzma_rs_tpu_torch.tools.probe_rows import Probe, main

ITERS = 512
_INT32 = (-2**31, 2**31)
_UINT8 = (0, 256)
_NEAR_LIMIT = (2**31 - 1024, 2**31 + 1024)  # start indices that wrap


def _device(device):
    return torch.device("cuda") if device is None else torch.device(device)


def _iota(n, device, dtype=torch.int32):
    """``arange(n)`` in ``dtype``, wrapped as jnp's ``arange`` wraps u8."""
    a = torch.arange(n, device=device)
    return (a % 256 if dtype == torch.uint8 else a).to(dtype)


def _gather(axis, x, idx, lanes, words, stride=1, x_range=_INT32):
    mod = x.shape[1] if axis == "minor" else x.shape[0]
    fn = Probe(pm.gather_sum, lambda x, i: (x, i),
               {"axis": axis, "mod": mod, "stride": stride}, {},
               pm.GATHER_OPS, words, (x_range, _NEAR_LIMIT), ITERS)
    return fn, (x, idx), lanes


def probe_gather_minor(L, W, dtype, device=None):
    """A: ``out[l, j] = sum_i x[l, (idx[l, j] + i) & (W - 1)]``; x and out
    [L, W] of ``dtype`` (int32 or uint8), idx [L, W] int32."""
    dev = _device(device)
    x = _iota(L * W, dev, dtype).reshape(L, W)
    idx = (torch.arange(L * W, dtype=torch.int32, device=dev)
           .reshape(L, W) * 7) % W
    b = x.element_size()
    return _gather("minor", x, idx, L * W, (2 * b + 4) / 4,
                   x_range=_UINT8 if dtype == torch.uint8 else _INT32)


def probe_gather_sublane(R, C, dtype, device=None):
    """B: ``out[r, c] = sum_i x[(idx[r, c] + i) % R, c]``; all [R, C]."""
    dev = _device(device)
    x = _iota(R * C, dev, dtype).reshape(R, C)
    idx = (torch.arange(R * C, dtype=torch.int32, device=dev)
           .reshape(R, C) * 3) % R
    return _gather("major", x, idx, R * C, 3)


def probe_onehot_read(L, W, dtype, device=None):
    """C: ``out[l, 0] = sum_i x[l, (idx[l] + i) % W]`` (the TPU probe's
    one-hot masked sum, a direct indexed load here); x [L, W], idx [L],
    out [L, 1]."""
    dev = _device(device)
    x = _iota(L * W, dev, dtype).reshape(L, W)
    idx = (torch.arange(L, dtype=torch.int32, device=dev) * 11) % W
    fn = Probe(pm.gather_sum, lambda x, i: (x, i[:, None]),
               {"axis": "minor", "mod": W}, {}, pm.GATHER_OPS,
               min(ITERS, W) + 2, (_INT32, _NEAR_LIMIT), ITERS)
    return fn, (x, idx), L


def probe_onehot_write(L, W, dtype, device=None):
    """D: for each step, ``x[l, (idx[l] + i) % W] += 1``; out is the final
    x [L, W] (the TPU probe's one-hot masked write, a direct
    read-modify-write here)."""
    dev = _device(device)
    x = _iota(L * W, dev, dtype).reshape(L, W)
    idx = (torch.arange(L, dtype=torch.int32, device=dev) * 11) % W
    fn = Probe(pm.rw_chain, lambda x, i: (x, i), {"mode": "rows"}, {},
               pm.RW_OPS["rows"], 2 * W + 1, (_INT32, _NEAR_LIMIT), ITERS)
    return fn, (x, idx), L


def probe_scalar_rw(W, device=None):
    """E: one chain, ``j = 37 i % W; v = x[0, j]; x[0, (j + 1) % W] =
    v + carry; carry += v``; x [1, W], out the carry [1, 1]."""
    x = _iota(W, _device(device)).reshape(1, W)
    fn = Probe(pm.rw_chain, lambda x: (x,), {"mode": "scalar"}, {},
               pm.RW_OPS["scalar"], min(ITERS, W) + 1, (_INT32,), ITERS)
    return fn, (x,), 1


def probe_dynrow(R, C, device=None):
    """F: ``out[0, c] = sum_i x[(13 i) % R, c]``; x [R, C], out [1, C]
    (the TPU probe's ``pl.ds`` row slice)."""
    dev = _device(device)
    x = _iota(R * C, dev).reshape(R, C)

    def view(x):  # every column walks from row 0 by 13
        return x, torch.zeros((1, x.shape[1]), dtype=torch.int32,
                              device=x.device)

    # 13 is odd and R a power of two: min(ITERS, R) distinct rows
    fn = Probe(pm.gather_sum, view, {"axis": "major", "mod": R, "stride": 13},
               {}, pm.GATHER_OPS, min(ITERS, R) + 1, (_INT32,), ITERS)
    return fn, (x,), C


LIBRARY_ROW = "D onehot-write [128,2048] i32"


def onehot_write_library(W=2048, device=None):
    """D's function on its row [128, W] as one PyTorch call: ``call()`` is
    ``x.clone().scatter_add_(1, cols, ones)``, the walk's wrapped column
    index ``cols`` ([128, ITERS]) built here, outside the call. Returns
    ``(call, fn, args)``: ``fn(*args)`` is the row's kernel."""
    fn, args, _ = probe_onehot_write(128, W, torch.int32, device=device)
    x, idx = args
    steps = torch.arange(fn.iters, device=x.device)
    walk = (idx.long()[:, None] + steps + 2**31) % 2**32 - 2**31
    cols = torch.remainder(walk, W)
    ones = torch.ones_like(cols, dtype=torch.int32)
    return (lambda: x.clone().scatter_add_(1, cols, ones)), fn, args


def library_row(device) -> dict:
    """D's library call on the card: whether it equals the kernel's output
    and its median ms, timed as the rows are (``probe_rows.median_ms``)."""
    from lzma_rs_tpu_torch.tools import probe_rows

    call, fn, args = onehot_write_library(device=device)
    equal = torch.equal(call(), fn(*args))
    return {"name": LIBRARY_ROW, "equal": equal,
            "ms": probe_rows.median_ms(call)}


i32, u8 = torch.int32, torch.uint8
ROWS_OF_TOOL = [
    *((f"A gather-minor [{L},{W}] {t}",
       lambda d, L=L, W=W, dt=dt: probe_gather_minor(L, W, dt, device=d))
      for L, W, dt, t in ((8, 128, i32, "i32"), (128, 128, i32, "i32"),
                          (8, 1024, i32, "i32"), (128, 1024, i32, "i32"),
                          (8, 128, u8, "u8"))),
    *((f"B gather-sublane [{R},128] i32",
       lambda d, R=R: probe_gather_sublane(R, 128, i32, device=d))
      for R in (8, 64, 512)),
    *((f"C onehot-read [128,{W}] i32",
       lambda d, W=W: probe_onehot_read(128, W, i32, device=d))
      for W in (768, 2048)),
    *((f"D onehot-write [128,{W}] i32",
       lambda d, W=W: probe_onehot_write(128, W, i32, device=d))
      for W in (768, 2048)),
    ("E scalar-rw [1,4096]", lambda d: probe_scalar_rw(4096, device=d)),
    *((f"F dynrow pl.ds [{R},128]",
       lambda d, R=R: probe_dynrow(R, 128, device=d))
      for R in (512, 4096)),
]


if __name__ == "__main__":
    ran = main(ROWS_OF_TOOL, prog="probe_mosaic")
    if any(r["name"] == LIBRARY_ROW and r["device"] != "cpu" for r in ran):
        lib = library_row(torch.device(ran[0]["device"]))
        print(f"{LIBRARY_ROW} library call (clone, scatter_add_; the index "
              f"built outside): {lib['ms'] * 1e3:.2f} us, equal to the "
              f"kernel's output: {lib['equal']}", flush=True)
