"""Bisect probe kernel: the bit decode's stages one by one, asked on the card.

The port of the Pallas probe in ``tools/probe_lane2d_bisect.py``
(``try_case`` with sixteen bodies; eleven functions on a thread-per-lane
card, where the probe's one-hot forms of a read are a direct load):

- :func:`bisect_chain`: ``iters`` iterations of one body on the bit
  decode's state (idx, acc, rng, cod) over a per-lane table ``[648,
  *lanes]``, then ``idx + acc + rng + cod``. A body is four stages:

  ============  ==========  ===============================  =============  =====
  body          index       read ``p``                       bit            write
  ============  ==========  ===============================  =============  =====
  v1            climb       ``idx``                          ``p & 1``      no
  v2 v2m v2bt   climb       ``tab[idx]``                     ``p & 1``      no
  v2max         climb       ``max(tab[idx], 0)``             ``p & 1``      no
  v3            climb       ``tab[idx]``                     range coder    no
  v4 v5         climb       ``tab[idx]``                     range coder    yes
  w1            none        the column's wrapping sum        ``p & 1``      no
  w2            none        ``tab[5]``                       ``p & 1``      no
  w3            step        1 (the mask's sum)               ``p & 1``      no
  w4            step        ``(idx == 0) + (idx == 1)``      ``p & 1``      no
  w5 w6 w7      step        ``tab[idx]``                     ``p & 1``      no
  w8            step        ``7 + tab[5]``                   ``p & 1``      no
  ============  ==========  ===============================  =============  =====

  climb: ``idx += #{k < 10 : acc > k}``; step: ``idx += acc & 1``; both
  then clip ``idx`` to [0, 647]. The range coder: ``bound = (rng >> 11) *
  (p & 0x7FF)`` (uint32), ``bit = cod >= bound``, ``rng = bit ? rng -
  bound : rng | 1``, ``cod ^= bit``; the write: ``tab[idx] = bit ? p - (p
  >> 5) : p + 3``. Then ``acc = (acc << 1) | bit``, 1 above 0x100.

The wrapper launches its hand-written kernel (``csrc/probes_bisect.cu``) on
a CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch version
(:func:`bisect_reference`: every lane in lockstep). ``bisect_chain.launches``
counts kernel launches, ``bisect_chain.reference`` is the plain version.
Inputs are not changed. ``full=True`` also returns ``{"table": the final
table, "state": [4, *lanes]}`` (idx, acc, rng, cod).

A call is one launch: blocks of 32 lanes, each staging its lanes' ``[648,
32]`` slice of the table in shared memory (the probe's VMEM scratch) where
the body reads rows; the bodies that read no row or only row 5 run on the
table itself, which was faster. The kernel writes the final table only for
``full=True``.

Integer semantics are wrapping int32 and uint32, as in ``ops/probes.py``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lzma_rs_tpu_torch.ops import probes
from lzma_rs_tpu_torch.ops.probes import _stream
from lzma_rs_tpu_torch.ops.probes_mosaic import (_check, _check_int,
                                                 _check_mode,
                                                 _check_same_device)

__all__ = [
    "ITERS", "ROWS", "INIT", "CONST_ROW", "BODIES", "STAGES", "WRAPPERS",
    "body_ops", "body_words", "rows_read",
    "bisect_chain", "bisect_reference", "launch_bisect", "kernel_attributes",
]

ITERS = 32         # the probe's ITERS
ROWS = probes.ROWS  # 648
INIT = (0, 1, -1, 12345)  # the probe's idx, acc, rng, cod
CONST_ROW = 5      # w2's and w8's row
_U32 = 0xFFFFFFFF

# body -> (index, read, bit, write); the order is the TPU tool's
STAGES = {
    "v1": ("climb", "idx", "low", False),
    "v2": ("climb", "row", "low", False),
    "v3": ("climb", "row", "range", False),
    "v4": ("climb", "row", "range", True),
    "v5": ("climb", "row", "range", True),
    "v2m": ("climb", "row", "low", False),
    "v2max": ("climb", "max0", "low", False),
    "v2bt": ("climb", "row", "low", False),
    "w1": ("none", "column", "low", False),
    "w2": ("none", "const_row", "low", False),
    "w3": ("step", "mask", "low", False),
    "w4": ("step", "first_two", "low", False),
    "w5": ("step", "row", "low", False),
    "w6": ("step", "row", "low", False),
    "w7": ("step", "row", "low", False),
    "w8": ("step", "mask7_row", "low", False),
}
BODIES = tuple(STAGES)
# the kernel's modes (csrc/probe_bisect.cuh): one per function
_MODE = {"v1": 0, "v2": 1, "v2m": 1, "v2bt": 1, "v2max": 2, "v3": 3,
         "v4": 4, "v5": 4, "w1": 5, "w2": 6, "w3": 7, "w4": 8, "w5": 9,
         "w6": 9, "w7": 9, "w8": 10}

# Integer operations per lane and iteration of each stage, counted from the
# probe's code (for the bound): the climb 10 x (compare, add) and the clip
# (22), the step's and, add and clip (4); a row's address (1), max's
# compare and select (+1), the column's 648 addresses and adds, the mask's
# range test (1), w4's two compares and add (3), w8's test, address and add
# (3); the bit's and (1) or the range coder's p & 0x7FF, rng >> 11, product,
# compare, rng - bound, rng | 1, select and cod ^ bit (8); the write's p >>
# 5, subtract, add and select (4); the shift-in's shift, or, compare and
# select (4). v4 is ops/probes.py's BITDECODE_OPS.
_INDEX_OPS = {"none": 0, "climb": 22, "step": 4}
_READ_OPS = {"idx": 0, "row": 1, "max0": 2, "column": 2 * ROWS,
             "const_row": 1, "mask": 1, "first_two": 3, "mask7_row": 3}
_READ_ROWS = {"column": ROWS, "const_row": 1, "mask7_row": 1}  # row reads


def body_ops(body: str) -> int:
    """Integer operations per lane and iteration of ``body``."""
    index, read, bit, write = STAGES[body]
    return (_INDEX_OPS[index] + _READ_OPS[read] + (8 if bit == "range" else 1)
            + (4 if write else 0) + 4)


def rows_read(table, start, *, body: str, iters: int = ITERS) -> int:
    """Table words that ``iters`` iterations of ``body`` read on these
    inputs, summed over the lanes: the distinct rows each lane's index
    reaches (the plain version's walk) where the body reads ``tab[idx]``,
    the column for w1, one row for w2 and w8, none for the others or at 0
    iterations."""
    read = STAGES[body][1]
    lanes = math.prod(table.shape[1:])
    if iters == 0:
        return 0
    if read not in ("row", "max0"):
        return _READ_ROWS.get(read, 0) * lanes
    seen = torch.zeros((ROWS, lanes), dtype=torch.bool, device=table.device)
    bisect_reference(table, start, body=body, iters=iters, _seen=seen)
    return int(seen.sum())


def body_words(table, start, *, body: str, iters: int = ITERS) -> float:
    """4-byte words per lane that ``body`` must move on these inputs: the
    table words it reads (:func:`rows_read`), the start (4) in, and the
    output (1) and final state (4) out. Without ``full`` the wrapper
    returns no table, so v4's and v5's writes are not counted."""
    lanes = math.prod(table.shape[1:])
    return rows_read(table, start, body=body, iters=iters) / lanes + 9


# -- the plain version ---------------------------------------------------


def bisect_reference(table, start, *, body: str, iters: int = ITERS,
                     full: bool = False, _seen=None):
    """Plain version of :func:`bisect_chain`. ``_seen`` ([648, L] bool),
    where given, is set at every row ``tab[idx]`` read (for
    :func:`rows_read`)."""
    index, read, bit_of, write = STAGES[body]
    lanes = table.shape[1:]
    tab = probes._lanes(table, ROWS)
    idx, acc, rng, cod = probes._lanes(start, 4)
    rng, cod = rng.long() & _U32, cod.long() & _U32
    every = torch.arange(idx.numel(), device=idx.device)
    for _ in range(iters):
        if index == "climb":
            idx = (idx + acc.clamp(0, 10)).clamp(0, ROWS - 1)
        elif index == "step":
            idx = (idx + (acc & 1)).clamp(0, ROWS - 1)
        if _seen is not None and read in ("row", "max0"):
            _seen[idx.long(), every] = True
        if bit_of == "range":
            bit, rng, cod = probes._decode_bit(tab, idx, rng, cod, write)
        else:
            if read == "idx":
                p = idx
            elif read in ("row", "max0"):
                p = tab.gather(0, idx.long()[None])[0]
                if read == "max0":
                    p = p.clamp(min=0)
            elif read == "column":
                p = tab.long().sum(0) & _U32
            elif read == "const_row":
                p = tab[CONST_ROW]
            elif read == "mask":  # idx is clipped: one row matches
                p = torch.ones_like(idx)
            elif read == "first_two":
                p = (idx == 0).int() + (idx == 1).int()
            else:  # mask7_row
                p = tab[CONST_ROW].long() + 7
            bit = p & 1
        acc = probes._shift_in(acc, bit)
    out = idx + acc + probes._to_i32(rng) + probes._to_i32(cod)
    out = out.reshape(lanes)
    if not full:
        return out
    state = torch.stack([idx, acc, probes._to_i32(rng), probes._to_i32(cod)])
    return out, {"table": tab.reshape(table.shape),
                 "state": state.reshape(4, *lanes)}


# -- the launch ----------------------------------------------------------


def _cuda_lib():
    from lzma_rs_tpu_torch.ops import build

    return build.load_bisect()


def launch_bisect(lib, table, start, *, body: str, iters: int = ITERS,
                  full: bool = False):
    """Run ``lib``'s ``lzb_bisect``: the nvcc build on a CUDA tensor, the
    g++ build of ``probe_bisect.cuh`` on a CPU one. One launch."""
    lanes = table.shape[1:]
    L = math.prod(lanes)
    x = table.reshape(ROWS, L).contiguous()
    st0 = start.reshape(4, L).contiguous()
    tab = torch.empty_like(x) if full else None
    state = torch.empty_like(st0)
    out = torch.empty(L, dtype=torch.int32, device=table.device)
    rc = lib.lzb_bisect(_MODE[body], x.data_ptr(),
                        None if tab is None else tab.data_ptr(),
                        st0.data_ptr(), state.data_ptr(), out.data_ptr(), L,
                        iters, _stream(table))
    if rc != 0:
        raise RuntimeError("bisect_chain launch failed: "
                           + lib.lzb_error_string(rc).decode())
    out = out.reshape(lanes)
    if not full:
        return out
    return out, {"table": tab.reshape(table.shape),
                 "state": state.reshape(4, *lanes)}


def kernel_attributes(body: str) -> dict:
    """The card build's attributes of ``body``'s kernel: ``registers`` and
    ``local_bytes`` a thread
    (spills), ``static_shared`` and ``max_dynamic_shared`` bytes
    (``cudaFuncGetAttributes`` after the opt-in), ``threads`` and
    ``lanes`` a block and ``shared_bytes``, the dynamic shared memory of a
    block. Needs the card."""
    _check_mode("body", body, BODIES)
    out = (ctypes.c_int * 7)()
    lib = _cuda_lib()
    rc = lib.lzb_kernel_attributes(_MODE[body], out)
    if rc != 0:
        raise RuntimeError("bisect kernel_attributes failed: "
                           + lib.lzb_error_string(rc).decode())
    return dict(zip(("registers", "local_bytes", "static_shared",
                     "max_dynamic_shared", "threads", "lanes",
                     "shared_bytes"), out))


# -- the wrapper ---------------------------------------------------------


def bisect_chain(table, start, *, body: str, iters: int = ITERS,
                 full: bool = False):
    """``idx + acc + rng + cod`` (int32, the lanes' shape) after ``iters``
    iterations of ``body`` (a name of :data:`BODIES`) from ``start`` ([4,
    *lanes] int32: idx, acc, rng, cod; the probe's is :data:`INIT` in every
    lane) over ``table`` ([648, *lanes] int32; v4 and v5 write a copy of
    it). The bodies are in this module's docstring."""
    _check_mode("body", body, BODIES)
    _check("table", table, dim=table.dim())
    if table.dim() < 2 or table.shape[0] != ROWS:
        raise ValueError(f"table {tuple(table.shape)}: want [{ROWS}, "
                         "*lanes]")
    _check("start", start, dim=table.dim())
    if tuple(start.shape) != (4, *table.shape[1:]):
        raise ValueError(f"start {tuple(start.shape)}: want [4, "
                         f"*{tuple(table.shape[1:])}]")
    _check_same_device(table, start)
    _check_int("iters", iters, 0)
    kw = {"body": body, "iters": iters, "full": full}
    if table.device.type == "cpu":
        return bisect_reference(table, start, **kw)
    res = launch_bisect(_cuda_lib(), table, start, **kw)
    bisect_chain.launches += 1
    return res


bisect_chain.launches = 0
bisect_chain.reference = bisect_reference
WRAPPERS = (bisect_chain,)
