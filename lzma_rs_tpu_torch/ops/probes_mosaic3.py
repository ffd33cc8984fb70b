"""Mosaic3 probe kernels: four functions, asked on the card.

The port of the Pallas probes in ``tools/probe_mosaic3.py`` (twelve
functions, four functions on the card; the one-hot reads of the TPU probes
are direct indexed loads here, with the same results):

- :func:`vote_chain` (``p7`` P7, ``p8`` P8, ``p9`` P9): ``node += i & 1``
  while any lane has ``node < 5``, the exit voted over every lane each
  iteration (an ``any``, a max, or a flag computed after the update), all
  lanes in one warp (:func:`vote_slots` a thread);
- :func:`byte_chain` (``p11a`` P11a, ``p11b`` P11b): ``v = ((v >> 8 (v &
  3)) & 0xFF) + i``, by a variable per-lane byte pick (on the card one
  byte permute) or a 4-way select of constant shifts, a thread a lane;
- :func:`onehot_chain` (``p12(True)`` P12s, ``p12(False)`` P12m, ``p13``
  P13, ``p_small(8 | 64)`` P14, P15): a lane-carried index over a
  lane-minor ``[R, L]`` table, each next address waiting on the value read;
- :func:`window_chain` (``p10`` P10, ``p16`` P16): a max over 64 rows of
  the lane's column per step, rows 0-63 plus ``i`` (P10) or two 32-row
  chunks picked by a carried ``base`` (P16).

Each wrapper launches its hand-written kernel (``csrc/probes_mosaic3.cu``)
on a CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch
version (``*_reference``: direct indexing, every lane in lockstep).
``<wrapper>.launches`` counts kernel launches, ``<wrapper>.reference`` is
the plain version. Inputs are not changed. vote_chain, onehot_chain and
window_chain start from the probes' zeros (vote_chain from ``node0``),
and a call is one launch: the kernel writes its state, which
``full=True`` returns (onehot_chain: ``[2, L]``, acc and idx;
window_chain's P16: ``[2, L]``, acc and base, and its final ``[64, L]``
scratch; vote_chain: ``[2]``, the iterations run and the last vote).
onehot_chain's and window_chain's kernels hold each block's lanes' table
in shared memory, so one lane's column must fit a block's: ``R <=
58,112`` and, for P16, ``W <= 58,080`` (:data:`MAX_ONEHOT_ROWS`,
:data:`MAX_REFILL_ROWS`).

Integer semantics are the probes': wrapping int32, an arithmetic ``>>``,
and an index is jnp's ``%`` of a wrapped int32 (the floor mod).
"""

from __future__ import annotations

import ctypes

import torch

from lzma_rs_tpu_torch.ops.probes import _stream
from lzma_rs_tpu_torch.ops.probes_mosaic import (_check, _check_int,
                                                 _check_mode, _wrap)

__all__ = [
    "VOTE_MODES", "BYTE_MODES", "REDUCES", "UNROLLS", "WINDOW_MODES",
    "WRAPPERS", "VOTE_OPS", "BYTE_OPS", "ONEHOT_OPS", "WINDOW_OPS",
    "vote_iterations", "onehot_rows_read", "refill_rows_read",
    "MAX_ONEHOT_ROWS", "MAX_REFILL_ROWS", "onehot_attributes",
    "window_attributes", "vote_slots", "vote_attributes", "byte_attributes",
    "vote_chain", "vote_chain_reference", "byte_chain",
    "byte_chain_reference", "onehot_chain", "onehot_chain_reference",
    "window_chain", "window_chain_reference",
]

VOTE_MODES = ("any", "max", "flag")     # P7, P8, P9
BYTE_MODES = ("shift", "select")        # P11a, P11b
REDUCES = ("sum", "max")                # P12s; P12m, P13, P14, P15
UNROLLS = (1, 8)                        # reads per loop pass (P13: 8)
WINDOW_MODES = ("concat", "refill")     # P10, P16
VOTE_BELOW = 5
MAX_LANES = 1024                        # vote_chain: one warp
WARP = 32
WINDOW_ROWS = 64                        # P10's rows, P16's scratch
CHUNK = 32                              # P16: rows per chunk
BASE_ROW = 128                          # P16: row0 = base // 128
BASE_STEP = 129                         # P16: base += v + 129
# one lane's column in a block's 232,448 bytes of shared memory (P16's
# with a chunk of zeros after it)
MAX_ONEHOT_ROWS = 232448 // 4
MAX_REFILL_ROWS = 232448 // 4 - CHUNK

# Integer operations per lane and step, counted from the probes' code
# (for the bound). vote_chain, every mode alike (a max over 0/1 flags is
# an any): the test node < 5, its part of the vote, i < iters, i & 1, the
# add and i + 1. byte_chain: shift v & 3, * 8, the shift, & 0xFF, + i,
# i + 1, the loop test; select v & 3, three tests, three shifts, four
# ands, three selects, + i, i + 1, the loop test. onehot_chain: the
# address, (max: the max,) acc's add, idx + v, + 1, the mod. window_chain:
# concat per row the address, + i and the max, then acc's add and i + 1;
# refill base >> 7, the two chunk tests, per row of the two chunks the
# address and the max, base + v + 129 (two adds), the mod, acc's add.
VOTE_OPS = 6
BYTE_OPS = {"shift": 7, "select": 17}
ONEHOT_OPS = {"sum": 5, "max": 6}
WINDOW_OPS = {"concat": 3 * WINDOW_ROWS + 2, "refill": 3 + 2 * 2 * CHUNK + 4}


def vote_slots(lanes: int) -> int:
    """The lanes each of vote_chain's 32 threads holds for ``lanes`` lanes:
    ``ceil(lanes / 32)`` rounded up to a power of two (a copy of the
    kernel's rule, ``lzm3_vote_slots``)."""
    k = 1
    while WARP * k < lanes:
        k *= 2
    return k


# -- plain versions ------------------------------------------------------


def vote_chain_reference(node0, *, mode: str, iters: int,
                         full: bool = False):
    """Plain version of :func:`vote_chain`."""
    node = node0.long()
    i, flag = 0, 1
    while True:
        if mode != "flag":
            flag = int((node < VOTE_BELOW).any())
        if not flag or i >= iters:
            break
        node = _wrap(node + (i & 1))
        i += 1
        if mode == "flag":
            flag = int((node < VOTE_BELOW).any())
    out = node.int()[None]
    if not full:
        return out
    return out, {"state": torch.tensor([i, flag], dtype=torch.int32,
                                       device=node0.device)}


def byte_chain_reference(v0, *, mode: str, iters: int, full: bool = False):
    """Plain version of :func:`byte_chain`, each mode in its probe's form
    (the same value)."""
    v = v0.long()
    for i in range(iters):
        if mode == "shift":
            b = (v >> ((v & 3) * 8)) & 0xFF
        else:
            k = v & 3
            b = torch.where(k == 0, v & 0xFF, torch.where(
                k == 1, (v >> 8) & 0xFF, torch.where(
                    k == 2, (v >> 16) & 0xFF, (v >> 24) & 0xFF)))
        v = _wrap(b + i)
    out = v.int()[None]
    return (out, {}) if full else out


def onehot_chain_reference(x, *, reduce: str, unroll: int = 1, iters: int,
                           full: bool = False):
    """Plain version of :func:`onehot_chain` (the unroll does not change
    the result)."""
    R, L = x.shape
    lanes = torch.arange(L, device=x.device)
    idx = torch.zeros(L, dtype=torch.int64, device=x.device)
    acc = torch.zeros(L, dtype=torch.int64, device=x.device)
    for _ in range(iters):
        v = x[idx, lanes].long()
        if reduce == "max":
            v = v.clamp(min=0)
        acc = _wrap(acc + v)
        idx = torch.remainder(_wrap(idx + v + 1), R)
    out = acc.int()[None]
    if not full:
        return out
    return out, {"state": torch.stack([acc, idx]).int()}


def _chunks(x, row0):
    """P16's scratch for each lane: chunks ``row0`` and ``row0 + 1`` of 32
    rows of the lane's column, zeros for a chunk outside x ([64, L])."""
    W, L = x.shape
    n = W // CHUNK
    lanes = torch.arange(L, device=x.device)
    r = torch.arange(CHUNK, device=x.device)[:, None]
    parts = []
    for c in (row0, row0 + 1):
        inside = (c >= 0) & (c < n)
        rows = c.clamp(0, n - 1)[None] * CHUNK + r
        parts.append(torch.where(inside[None], x[rows, lanes[None]], 0))
    return torch.cat(parts)


def window_chain_reference(x, *, mode: str, iters: int, full: bool = False):
    """Plain version of :func:`window_chain`."""
    W, L = x.shape
    acc = torch.zeros(L, dtype=torch.int64, device=x.device)
    if mode == "concat":
        rows = x[:WINDOW_ROWS].long()
        for i in range(iters):
            acc = _wrap(acc + _wrap(rows + i).max(dim=0).values)
        out = acc.int()[None]
        return (out, {}) if full else out
    base = torch.zeros(L, dtype=torch.int64, device=x.device)
    t = torch.zeros((WINDOW_ROWS, L), dtype=torch.int32, device=x.device)
    for _ in range(iters):
        t = _chunks(x, base // BASE_ROW)
        v = t.max(dim=0).values.long()
        acc = _wrap(acc + v)
        base = torch.remainder(_wrap(base + v + BASE_STEP), 16 * W)
    out = acc.int()[None]
    if not full:
        return out
    return out, {"scratch": t, "state": torch.stack([acc, base]).int()}


# -- what this run's data needs (for the bound) ---------------------------


def vote_iterations(node0, *, mode: str, iters: int) -> int:
    """The iterations :func:`vote_chain` runs from ``node0`` (the plain
    version on the CPU)."""
    _, res = vote_chain_reference(node0.cpu(), mode=mode, iters=iters,
                                  full=True)
    return int(res["state"][0])


def onehot_rows_read(x, *, reduce: str, iters: int) -> int:
    """The distinct table words that :func:`onehot_chain`'s walk over ``x``
    ([R, L]) reads in ``iters`` steps, summed over lanes."""
    x = x.cpu()
    R, L = x.shape
    lanes = torch.arange(L)
    idx = torch.zeros(L, dtype=torch.int64)
    seen = torch.zeros((R, L), dtype=torch.bool)
    for _ in range(iters):
        seen[idx, lanes] = True
        v = x[idx, lanes].long()
        if reduce == "max":
            v = v.clamp(min=0)
        idx = torch.remainder(_wrap(idx + v + 1), R)
    return int(seen.sum())


def refill_rows_read(x, iters: int) -> int:
    """The distinct table words that P16's walk (:func:`window_chain`, mode
    ``refill``) over ``x`` ([W, L]) reads in ``iters`` steps, summed over
    lanes: 32 for every chunk inside the table that a lane visits."""
    x = x.cpu()
    W, L = x.shape
    n = W // CHUNK
    base = torch.zeros(L, dtype=torch.int64)
    seen = torch.zeros((n + 2, L), dtype=torch.bool)
    for _ in range(iters):
        row0 = base // BASE_ROW
        for c in (row0, row0 + 1):
            seen[c.clamp(max=n + 1), torch.arange(L)] = True
        v = _chunks(x, row0).max(dim=0).values.long()
        base = torch.remainder(_wrap(base + v + BASE_STEP), 16 * W)
    return CHUNK * int(seen[:n].sum())


# -- launches ------------------------------------------------------------


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lzm3_error_string(rc).decode())


def _cuda_lib():
    from lzma_rs_tpu_torch.ops import build

    return build.load_mosaic3()


# -- kernel launches (the nvcc build on a CUDA tensor, the g++ build of
# probe_mosaic3.cuh on a CPU one) ----------------------------------------


def launch_vote_chain(lib, node0, *, mode: str, iters: int,
                      full: bool = False):
    """Run ``lib``'s ``lzm3_vote_chain``."""
    n0 = node0.contiguous()
    node = torch.empty_like(n0)
    state = torch.empty(2, dtype=torch.int32, device=node0.device)
    rc = lib.lzm3_vote_chain(VOTE_MODES.index(mode), n0.data_ptr(),
                             n0.numel(), node.data_ptr(), state.data_ptr(),
                             iters, _stream(node0))
    _raise_on(lib, rc, "vote_chain")
    out = node.view(1, -1)
    return (out, {"state": state}) if full else out


def launch_byte_chain(lib, v0, *, mode: str, iters: int, full: bool = False):
    """Run ``lib``'s ``lzm3_byte_chain``."""
    s = v0.contiguous()
    v = torch.empty_like(s)
    rc = lib.lzm3_byte_chain(BYTE_MODES.index(mode), s.data_ptr(), s.numel(),
                             v.data_ptr(), iters, _stream(v0))
    _raise_on(lib, rc, "byte_chain")
    out = v.view(1, -1)
    return (out, {}) if full else out


def launch_onehot_chain(lib, x, *, reduce: str, unroll: int = 1, iters: int,
                        full: bool = False):
    """Run ``lib``'s ``lzm3_onehot_chain``: one launch, which writes the
    state."""
    t = x.contiguous()
    state = torch.empty((2, x.shape[1]), dtype=torch.int32, device=x.device)
    rc = lib.lzm3_onehot_chain(REDUCES.index(reduce), unroll, t.data_ptr(),
                               t.shape[0], t.shape[1], state.data_ptr(),
                               iters, _stream(x))
    _raise_on(lib, rc, "onehot_chain")
    out = state[0:1]
    return (out, {"state": state}) if full else out


def launch_window_chain(lib, x, *, mode: str, iters: int,
                        full: bool = False):
    """Run ``lib``'s ``lzm3_window_chain``: one launch, which writes the
    state (P10: acc alone) and, where asked, P16's scratch."""
    t = x.contiguous()
    L = x.shape[1]
    refill = mode == "refill"
    state = torch.empty((2 if refill else 1, L), dtype=torch.int32,
                        device=x.device)
    scratch = (torch.empty((WINDOW_ROWS, L), dtype=torch.int32,
                           device=x.device) if full and refill else None)
    rc = lib.lzm3_window_chain(
        WINDOW_MODES.index(mode), t.data_ptr(), t.shape[0], L,
        state.data_ptr(), None if scratch is None else scratch.data_ptr(),
        iters, _stream(x))
    _raise_on(lib, rc, "window_chain")
    out = state[0:1]
    if not full:
        return out
    return out, ({"scratch": scratch, "state": state} if refill else {})


_ATTRIBUTES = ("registers", "local_bytes", "static_shared",
               "max_dynamic_shared", "threads", "lanes", "shared_bytes")


def _attributes(fn, what: str, *args) -> dict:
    out = (ctypes.c_int * len(_ATTRIBUTES))()
    lib = _cuda_lib()
    _raise_on(lib, getattr(lib, fn)(*args, out), what)
    return dict(zip(_ATTRIBUTES, out))


def onehot_attributes(R: int, *, reduce: str, unroll: int = 1) -> dict:
    """The card build's attributes of the kernel that :func:`onehot_chain`
    launches on an ``[R, L]`` table: ``registers`` and ``local_bytes`` a
    thread (spills), ``static_shared`` and ``max_dynamic_shared`` bytes
    (``cudaFuncGetAttributes`` after the opt-in), ``threads`` and ``lanes``
    a block and ``shared_bytes``, the dynamic shared memory of a block.
    Needs the card."""
    _check_mode("reduce", reduce, REDUCES)
    _check_mode("unroll", unroll, UNROLLS)
    return _attributes("lzm3_onehot_attributes", "onehot_attributes",
                       REDUCES.index(reduce), unroll, R)


def window_attributes(W: int, *, mode: str) -> dict:
    """The same for :func:`window_chain`'s kernel on a ``[W, L]`` table."""
    _check_mode("mode", mode, WINDOW_MODES)
    return _attributes("lzm3_window_attributes", "window_attributes",
                       WINDOW_MODES.index(mode), W)


def byte_attributes(*, mode: str) -> dict:
    """The same for :func:`byte_chain`'s kernel: a thread a lane, 128
    (``threads`` and ``lanes``) a block, no shared memory."""
    _check_mode("mode", mode, BYTE_MODES)
    return _attributes("lzm3_byte_attributes", "byte_attributes",
                       BYTE_MODES.index(mode))


def vote_attributes(lanes: int, *, mode: str) -> dict:
    """The same for :func:`vote_chain`'s kernel at ``lanes`` lanes: one
    warp (``threads`` 32) holds them all (``lanes``), no shared memory."""
    _check_mode("mode", mode, VOTE_MODES)
    return _attributes("lzm3_vote_attributes", "vote_attributes",
                       VOTE_MODES.index(mode), lanes)


# -- wrappers ------------------------------------------------------------


def vote_chain(node0, *, mode: str, iters: int, full: bool = False):
    """From ``node0`` ([L] int32, L <= 1024, one lane each): while any lane
    has ``node < 5`` and ``i < iters``, ``node += i & 1; i += 1``. The exit
    is voted over all lanes each iteration: ``"any"`` (P7) and ``"max"``
    (P8) before the body, ``"flag"`` (P9) after it, from a flag that starts
    at 1 (so the body runs at least once). The output is ``node`` [1, L];
    ``full`` adds ``state`` [2]: the iterations run and the last vote. The
    kernel holds every lane in one warp, so L is at most 1,024."""
    _check("node0", node0, dim=1)
    _check_mode("mode", mode, VOTE_MODES)
    _check_int("iters", iters, 0)
    if node0.shape[0] > MAX_LANES:
        raise ValueError(f"node0 {tuple(node0.shape)}: at most {MAX_LANES} "
                         "lanes (one warp votes)")
    if node0.device.type == "cpu":
        return vote_chain_reference(node0, mode=mode, iters=iters, full=full)
    res = launch_vote_chain(_cuda_lib(), node0, mode=mode, iters=iters,
                            full=full)
    vote_chain.launches += 1
    return res


def byte_chain(v0, *, mode: str, iters: int, full: bool = False):
    """From ``v0`` ([L] int32), ``iters`` steps of ``v = ((v >> 8 (v & 3)) &
    0xFF) + i``: by a variable shift (``"shift"``, P11a) or a select of
    four constant shifts (``"select"``, P11b). The output is ``v`` [1, L].
    """
    _check("v0", v0, dim=1)
    _check_mode("mode", mode, BYTE_MODES)
    _check_int("iters", iters, 0)
    if v0.device.type == "cpu":
        return byte_chain_reference(v0, mode=mode, iters=iters, full=full)
    res = launch_byte_chain(_cuda_lib(), v0, mode=mode, iters=iters,
                            full=full)
    byte_chain.launches += 1
    return res


def onehot_chain(x, *, reduce: str, unroll: int = 1, iters: int,
                 full: bool = False):
    """``iters`` steps of a lane-carried ``idx`` (from 0) over ``x`` ([R, L]
    int32), one lane per column: ``v = x[idx]`` (``"sum"``, P12s) or
    ``max(x[idx], 0)`` (``"max"``: the one-hot's zeros take part, R >= 2);
    ``acc += v; idx = (idx + v + 1) % R``, ``unroll`` reads per loop pass
    (1, or 8 as P13; ``iters`` a multiple of it). At most
    :data:`MAX_ONEHOT_ROWS` rows. The output is ``acc`` [1, L]; ``full``
    adds ``state`` [2, L]: acc and idx."""
    _check("x", x)
    _check_mode("reduce", reduce, REDUCES)
    _check_mode("unroll", unroll, UNROLLS)
    _check_int("iters", iters, 0)
    if iters % unroll:
        raise ValueError(f"iters = {iters} is not a multiple of unroll = "
                         f"{unroll}")
    if reduce == "max" and x.shape[0] < 2:
        raise ValueError(f"x {tuple(x.shape)}: a max over the one-hot wants "
                         "at least 2 rows")
    if x.shape[0] > MAX_ONEHOT_ROWS:
        raise ValueError(f"x {tuple(x.shape)}: at most {MAX_ONEHOT_ROWS} "
                         "rows (one lane's column in a block's shared "
                         "memory)")
    kw = {"reduce": reduce, "unroll": unroll, "iters": iters, "full": full}
    if x.device.type == "cpu":
        return onehot_chain_reference(x, **kw)
    res = launch_onehot_chain(_cuda_lib(), x, **kw)
    onehot_chain.launches += 1
    return res


def window_chain(x, *, mode: str, iters: int, full: bool = False):
    """Over ``x`` ([W, L] int32), one lane per column. ``"concat"`` (P10,
    W >= 64): ``acc += max over r < 64 of (x[r] + i)``, the add wrapping per
    element before the max. ``"refill"`` (P16, W a multiple of 32, at most
    :data:`MAX_REFILL_ROWS`): ``row0 = base // 128``; ``v`` = the max over
    chunks ``row0`` and ``row0 + 1`` of 32 rows (zeros for a chunk past the
    table); ``acc += v; base = (base + v + 129) % 16 W``; ``full`` adds
    the last step's ``scratch`` [64, L] and ``state`` [2, L]: acc and base.
    The output is ``acc`` [1, L]."""
    _check("x", x)
    _check_mode("mode", mode, WINDOW_MODES)
    _check_int("iters", iters, 0)
    W = x.shape[0]
    if mode == "concat" and W < WINDOW_ROWS:
        raise ValueError(f"x {tuple(x.shape)}: want {WINDOW_ROWS} rows")
    if mode == "refill" and (W % CHUNK or W > MAX_REFILL_ROWS):
        raise ValueError(f"x {tuple(x.shape)}: want a multiple of {CHUNK} "
                         f"rows, at most {MAX_REFILL_ROWS} (one lane's "
                         "column and a chunk of zeros in a block's shared "
                         "memory)")
    if x.device.type == "cpu":
        return window_chain_reference(x, mode=mode, iters=iters, full=full)
    res = launch_window_chain(_cuda_lib(), x, mode=mode, iters=iters,
                              full=full)
    window_chain.launches += 1
    return res


for _w, _ref in ((vote_chain, vote_chain_reference),
                 (byte_chain, byte_chain_reference),
                 (onehot_chain, onehot_chain_reference),
                 (window_chain, window_chain_reference)):
    _w.launches = 0
    _w.reference = _ref
WRAPPERS = (vote_chain, byte_chain, onehot_chain, window_chain)
