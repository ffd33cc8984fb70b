"""Mosaic4 probe kernel: one per-thread function, asked on the card.

The port of the Pallas probes in ``tools/probe_mosaic4.py`` (``build``'s
four variants and ``build2``'s three: seven functions, one function on a
thread-per-lane card; the one-hot reads and writes of the TPU probes are
direct indexed loads and stores here, with the same results):

- :func:`table_chain`: a lane-carried ``idx`` over the lane's own column of
  a ``[512, L]`` table filled with 7 (``build``: each step writes the word
  it read back plus one, and the reset variants set the whole column to
  ``0x400`` every 17 steps; ``build2``: a term of an ``[8, L]`` input
  joins each step instead), in outer rounds of 16 steps, ``build``'s
  rounds each starting with a refill of a ``[64, L]`` tile from two
  32-row chunks of the table.

The wrapper launches its hand-written kernel (``csrc/probes_mosaic4.cu``)
on a CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch
version (:func:`table_chain_reference`: direct indexing, every lane in
lockstep). ``table_chain.launches`` counts kernel launches,
``table_chain.reference`` is the plain version. Inputs are not changed.
``full=True`` also returns a dict: the final ``table`` [512, L], the
``tile`` [64, L] (``build``'s variants), the carried ``state`` [2, L]
(idx, acc) and ``it`` [1].

A call is one launch: blocks of 8 lanes, each holding its lanes' table and
tile in shared memory (the probe's VMEM scratch), and one warp that runs
the lanes' chains and shares a round's refill and a step's resets. The
kernel writes table and tile out only for ``full=True``.

Integer semantics are the probe's: wrapping int32, and ``%`` and ``//``
are jnp's floor mod and floor division of a wrapped int32.
"""

from __future__ import annotations

import ctypes
import math

import torch

from lzma_rs_tpu_torch.ops.probes import _stream
from lzma_rs_tpu_torch.ops.probes_mosaic import (_check, _check_int,
                                                 _check_mode,
                                                 _check_same_device, _wrap)

__all__ = [
    "VARIANTS", "BUILD_VARIANTS", "SCHED_VARIANTS", "WRAPPERS",
    "W", "TILE", "ROUND", "SCHED", "step_ops", "steps_run", "table_chain",
    "table_chain_reference", "launch_table_chain", "kernel_attributes",
]

W = 512          # table rows
TILE = 64        # tile rows: two chunks
CHUNK = 32       # rows per chunk; chunks 0-3 are rows 0-127
CHUNKS = 4
ROW_OF = 128     # the refill's row0 = idx // 128
ROUND = 16       # steps per outer round
SCHED = 8        # build2: rows of k
FILL = 7
RESET = 0x400
RESET_EVERY = 17

BUILD_VARIANTS = ("base", "when_reset", "when_reset_hoisted",
                  "when_reset_refed")
SCHED_VARIANTS = ("sched8_max", "sched8_sum", "sched8_blend")
VARIANTS = BUILD_VARIANTS + SCHED_VARIANTS
# the kernel's modes (csrc/probe_mosaic4.cuh): when_reset and its hoisted
# form are one function (the guard's block-wide max changes no result)
_MODE = {"base": 0, "when_reset": 1, "when_reset_hoisted": 1,
         "when_reset_refed": 2, "sched8_max": 3, "sched8_sum": 4,
         "sched8_blend": 5}


def step_ops(variant: str) -> float:
    """Integer operations per lane and step, counted from the probe's code
    (for the bound): the range test, the address, the select of 0, idx + v,
    the mod (an and), acc + 1, it + 1 and the loop's add and test (9);
    build: the acc > 0 test, the store's address and v + 1 (3), the refill
    amortised over its round (the chunk index and tests, per row of the two
    chunks an address, a load and a store: 3 + 64 * 3 over 16 steps); the
    resets: acc % 17 (five for a floor mod by a constant) and the test,
    then 512 stores every 17th step (an address and a store each); refed
    also the tile's store, load and test; build2: the clip (2), the
    address and the add, with the max or the blend's 8 loads, multiplies,
    compares and adds."""
    if variant in SCHED_VARIANTS:
        return 9 + 4 + {"sched8_max": 1, "sched8_sum": 0,
                        "sched8_blend": 4 * SCHED}[variant]
    ops = 9 + 3 + (3 + 2 * CHUNK * 3) / ROUND
    if variant != "base":
        ops += 6 + 2 * W / RESET_EVERY
    if variant == "when_reset_refed":
        ops += 3
    return ops


def steps_run(it0: int, limit: int) -> int:
    """The steps of a run from ``it = it0`` while ``it < limit``: whole
    rounds of 16."""
    return ROUND * math.ceil((limit - it0) / ROUND) if it0 < limit else 0


# -- the plain version ---------------------------------------------------


def table_chain_reference(x, start, it0, *, variant: str, iters: int,
                          full: bool = False):
    """Plain version of :func:`table_chain`."""
    L = x.shape[1]
    dev = x.device
    lanes = torch.arange(L, device=dev)
    tab = torch.full((W, L), FILL, dtype=torch.int64, device=dev)
    build = variant in BUILD_VARIANTS
    tile = torch.zeros((TILE, L), dtype=torch.int64, device=dev)
    idx, acc = start.long()
    it = int(it0[0])
    k = None if build else x.long()
    rows = torch.arange(CHUNK, device=dev)[:, None]
    while it < iters:
        if build:  # the refill: chunks row0 and row0 + 1 of rows 0-127
            row0 = torch.div(idx, ROW_OF, rounding_mode="floor")
            for t in range(2):
                c = row0 + t
                inside = (c >= 0) & (c < CHUNKS)
                src = c.clamp(0, CHUNKS - 1)[None] * CHUNK + rows
                tile[t * CHUNK:(t + 1) * CHUNK] = torch.where(
                    inside[None], tab[src, lanes[None]], 0)
        for _ in range(ROUND):
            inside = (idx >= 0) & (idx < W)
            at = idx.clamp(0, W - 1)
            v = torch.where(inside, tab[at, lanes], 0)
            if build:
                w = inside & (acc > 0)
                tab[at[w], lanes[w]] = _wrap(v[w] + 1)
            else:
                kv = k[acc.clamp(0, SCHED - 1), lanes]
                v = v + (kv.clamp(min=0) if variant == "sched8_max" else kv)
            idx = torch.remainder(_wrap(idx + v), W)
            acc = _wrap(acc + 1)
            if build and variant != "base":
                flag = torch.remainder(acc, RESET_EVERY) == 0
                if variant == "when_reset_refed":
                    tile[0] = flag.long()
                tab[:, flag] = RESET
            it = _wrap(it + 1)
    out = idx.int()[None]
    if not full:
        return out
    res = {"table": tab.int(), "state": torch.stack([idx, acc]).int(),
           "it": torch.tensor([it], dtype=torch.int32, device=dev)}
    if build:
        res["tile"] = tile.int()
    return out, res


# -- launches ------------------------------------------------------------


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lzm4_error_string(rc).decode())


def _cuda_lib():
    from lzma_rs_tpu_torch.ops import build

    return build.load_mosaic4()


def launch_table_chain(lib, x, start, it0, *, variant: str, iters: int,
                       full: bool = False):
    """Run ``lib``'s ``lzm4_table_chain``: the nvcc build on a CUDA tensor,
    the g++ build of ``probe_mosaic4.cuh`` on a CPU one. One launch."""
    L = x.shape[1]
    dev = x.device
    build = variant in BUILD_VARIANTS
    k = None if build else x.contiguous()
    st0, i0 = start.contiguous(), it0.contiguous()
    tab = torch.empty((W, L), dtype=torch.int32, device=dev) if full else None
    tile = (torch.empty((TILE, L), dtype=torch.int32, device=dev)
            if full and build else None)
    state = torch.empty_like(st0)
    it = torch.empty(1, dtype=torch.int32, device=dev)
    rc = lib.lzm4_table_chain(
        _MODE[variant], None if k is None else k.data_ptr(), L,
        st0.data_ptr(), None if tab is None else tab.data_ptr(),
        None if tile is None else tile.data_ptr(), state.data_ptr(),
        i0.data_ptr(), it.data_ptr(), iters, _stream(x))
    _raise_on(lib, rc, "table_chain")
    out = state[0:1]
    if not full:
        return out
    res = {"table": tab, "state": state, "it": it}
    if build:
        res["tile"] = tile
    return out, res


def kernel_attributes(variant: str) -> dict:
    """The card build's attributes of ``variant``'s kernel: ``registers``
    and ``local_bytes`` a thread (spills),
    ``static_shared`` and ``max_dynamic_shared`` bytes
    (``cudaFuncGetAttributes`` after the opt-in), ``threads`` and ``lanes``
    a block and ``shared_bytes``, the dynamic shared memory of a block.
    Needs the card."""
    _check_mode("variant", variant, VARIANTS)
    out = (ctypes.c_int * 7)()
    lib = _cuda_lib()
    _raise_on(lib, lib.lzm4_kernel_attributes(_MODE[variant], out),
              "kernel_attributes")
    return dict(zip(("registers", "local_bytes", "static_shared",
                     "max_dynamic_shared", "threads", "lanes",
                     "shared_bytes"), out))


# -- the wrapper ---------------------------------------------------------


def table_chain(x, start, it0, *, variant: str, iters: int,
                full: bool = False):
    """The probe's loop over L lanes (one per column), from ``start`` ([2,
    L] int32: idx, acc) and ``it0`` ([1] int32): a ``[512, L]`` table filled
    with 7, then, while ``it < iters``, a round of 16 steps. ``x`` is
    ``build``'s ``[4, L]`` input (read only for its lane count, as the probe
    reads it as ``x * 0``) or ``build2``'s ``k`` ([8, L]).

    A step: ``v = table[idx]`` (0 for ``idx`` outside [0, 512));
    ``build``'s variants write ``table[idx] = v + 1`` where ``acc > 0``,
    ``build2``'s add ``max(k[ci], 0)`` (``sched8_max``) or ``k[ci]``
    (``sched8_sum``, ``sched8_blend``: ``sum_r k[r] (ci == r)``) to ``v``,
    ``ci = clip(acc, 0, 7)``; ``idx = (idx + v) % 512; acc += 1``; the
    reset variants then set the lane's column to 0x400 where ``acc % 17 ==
    0`` (``when_reset_refed`` through the tile's row 0); ``it += 1``.
    ``build``'s rounds start with a refill: ``tile[0:32]`` and
    ``tile[32:64]`` are chunks ``idx // 128`` and ``idx // 128 + 1`` of
    rows 0-127 (32 rows each, zeros for a chunk outside 0-3). The output is
    ``idx`` [1, L]."""
    _check_mode("variant", variant, VARIANTS)
    build = variant in BUILD_VARIANTS
    _check("x", x)
    if x.shape[0] != (4 if build else SCHED):
        raise ValueError(f"x {tuple(x.shape)}: {variant} wants "
                         f"[{4 if build else SCHED}, L]")
    _check("start", start)
    if tuple(start.shape) != (2, x.shape[1]):
        raise ValueError(f"start {tuple(start.shape)}: want [2, "
                         f"{x.shape[1]}]")
    _check("it0", it0, dim=1)
    if it0.shape[0] != 1:
        raise ValueError(f"it0 {tuple(it0.shape)}: want [1]")
    _check_same_device(x, start, it0)
    _check_int("iters", iters, 0)
    kw = {"variant": variant, "iters": iters, "full": full}
    if x.device.type == "cpu":
        return table_chain_reference(x, start, it0, **kw)
    res = launch_table_chain(_cuda_lib(), x, start, it0, **kw)
    table_chain.launches += 1
    return res


table_chain.launches = 0
table_chain.reference = table_chain_reference
WRAPPERS = (table_chain,)
