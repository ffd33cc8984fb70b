"""Round4 probe kernels: two per-thread functions, asked on the card.

The port of the Pallas probes in ``tools/probe_round4.py`` (the twenty
rows of its ``CASES``: ``_mk`` over nine bodies, ``narrow_1`` and
``sel_s``), two functions on a thread-per-lane card (the one-hot selects
of the TPU probes are direct indexed loads and stores here, with the same
results). Each runs ``iters`` iterations per lane over a lane-minor table
``x`` ([R, L]: the probe's ``[R, S, 128]`` or folded ``[R / f, f S, 128]``
table is this memory) and four int32 state slots ``st`` ([4, L]; slot 0
the seed and the output). An index is the probe's ``_idx_mix`` of slot 0:
``m = clip((st0 * 40499) & mask, 0, R - 1)``, the multiply wrapping in
int32, and ``c(i) = clip(i, 0, R - 1)``.

- :func:`select_chain` reads the table: ``null`` (``st0 = (5 st0 + 1) &
  0xFFFF``), ``sel`` (n chained reads, each index from the slot the last
  read updated), ``par3`` (three independent reads at ``m``, ``c(m +
  17)``, ``c(m + 33)``), ``fused`` (n independent reads at ``c(m + 17
  j)``), ``gather`` (``x[st0 & 7]`` of lane ``l % 128``, whose chain lane
  ``l`` follows); the table int32, or int16 or int8 (``sel`` with n = 1),
  sign-extended.
- :func:`blend_chain` writes it, then reads it: ``par3`` and ``fused``
  (``x[c(m + 5)] = st1``, ``x[c(m + 9)] = st2``, then the reads of
  ``par3`` or ``fused``; ``st1 = (st1 + v0) & 0x7FF``, ``st2 = (st2 +
  v_{1 % n}) & 0x7FF``), ``mask`` (a masked merge of ``st1`` into
  ``x[m]``, then ``w0 = x[m + 1]``), ``oldw`` (``x[m] = st1``, then ``x[m +
  1]`` and ``x[m + 2]``); rows past the table read 0.

Each wrapper launches its hand-written kernel (``csrc/probes_round4.cu``)
on a CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch
version (``*_reference``). A kernel's block holds the whole columns of
:func:`lanes_per_block` lanes in shared memory (the rows
:func:`staged_rows` names, ``[rows, lb]`` lane-minor: the TPU probes' VMEM
scratch), so each iteration's chain waits on shared-memory latency, not
on L2; a column over 227 KB (:data:`MAX_SHARED`) is refused on the card
(the plain version takes any ``R``). ``<wrapper>.launches`` counts kernel launches,
``<wrapper>.reference`` is the plain version. Inputs are not changed
(``blend_chain`` writes its own copy of the table). The output is ``st0``
[1, L]; ``full=True`` also returns a dict: ``state`` [4, L], and
``blend_chain``'s final ``table``.

Integer semantics are the probes': wrapping int32 and an arithmetic
``>>``.
"""

from __future__ import annotations

import ctypes

import torch

from lzma_rs_tpu_torch.ops.probes import _stream
from lzma_rs_tpu_torch.ops.probes_mosaic import (_check, _check_int,
                                                 _check_mode,
                                                 _check_same_device, _wrap)

__all__ = [
    "SELECT_MODES", "BLEND_MODES", "MASKS", "WRAPPERS", "MAX_SHARED",
    "select_ops", "blend_ops", "rows_reached", "lanes_per_block",
    "staged_rows", "block_bytes", "kernel_attributes", "select_chain",
    "select_chain_reference", "blend_chain", "blend_chain_reference",
    "launch_select_chain", "launch_blend_chain",
]

SELECT_MODES = ("null", "sel", "par3", "fused", "gather")
BLEND_MODES = ("par3", "fused", "mask", "oldw")
# the reads per iteration each mode is built for (the first is the default)
SELECT_NS = {"null": (1,), "sel": (1, 2, 3, 4), "par3": (3,),
             "fused": (3,), "gather": (1,)}
BLEND_NS = {"par3": (3,), "fused": (3, 7), "mask": (1,), "oldw": (1,)}
MASKS = (1023, 2047)     # _idx_mix's and; 2047 for sel_s
MIX = 40499
STEP = 17                # fused: rows m + 17 j
PAR3 = (0, 17, 33)       # par3's rows
WRITES = (5, 9)          # the blends' rows m + 5, m + 9
GATHER_ROWS = 8
GATHER_LANES = 128       # gather: lane l follows lane l % 128
BLEND_ROWS = 10          # m + 9 inside the table
_ELEM = {torch.int32: 4, torch.int16: 2, torch.int8: 1}
MAX_LANES = 32           # lanes (threads) a block at most
MAX_SHARED = 232448      # dynamic shared memory a block may have (227 KB)
CHUNK = 16               # bytes a staging copy moves


def _offsets(mode: str, n: int) -> tuple:
    return PAR3 if mode == "par3" else tuple(STEP * j for j in range(n))


def select_ops(mode: str, n: int) -> float:
    """Integer operations per lane and iteration, counted from the probes'
    code (for the bound): the loop's add and test (2), then null the
    multiply, add and and (3); sel per read the mix (multiply, and, clip),
    + j, the clip, the address, the add and the and (8); par3 and fused the
    mix (3), per read + offset, clip, address and add (4), the add and the
    and of slot 0 (2); gather the and 7, the address, two adds and two
    ands (6)."""
    return 2 + {"null": 3, "sel": 8 * n, "par3": 3 + 4 * n + 2,
                "fused": 3 + 4 * n + 2, "gather": 6}[mode]


def blend_ops(mode: str, n: int) -> float:
    """As :func:`select_ops`, for :func:`blend_chain`: the loop (2) and the
    mix (3); par3 and fused two writes (offset, clip, address: 6), per read
    4, slot 0's add and and (2), slots 1 and 2 an add and an and each (4);
    mask a load, the merge (xor, and, or, xor), a store, the neighbour's
    add, test, address and load, slot 0's add and and, the shift and and
    (14); oldw a store, two neighbours (add, test, address, load: 8), slot
    0 (2), slot 1's two ands and or (3)."""
    return 5 + {"par3": 6 + 4 * n + 6, "fused": 6 + 4 * n + 6, "mask": 14,
                "oldw": 1 + 8 + 2 + 3}[mode]


def rows_reached(mode: str, n: int, mask: int, R: int, *,
                 blend: bool = False) -> int:
    """The table rows an index of ``mode`` can reach: the mix's ``[0,
    min(mask, R - 1)]`` plus the largest offset, within the table (gather:
    rows 0-7; null: none)."""
    if not blend and mode in ("null", "gather"):
        return 0 if mode == "null" else GATHER_ROWS
    top = {"sel": n - 1, "mask": 1, "oldw": 2}.get(
        mode, max(_offsets(mode, n) + (WRITES if blend else ())))
    return min(R, min(mask, R - 1) + top + 1)


def lanes_per_block(rows: int, elem: int) -> int:
    """Lanes a kernel's block holds: the largest power of two <= 32 whose
    columns of ``rows`` entries of ``elem`` bytes fit in
    :data:`MAX_SHARED`; 0 when one column does not (``probe_round4.cuh``'s
    ``lanes_per_block``)."""
    lb = MAX_LANES
    while lb and lb * rows * elem > MAX_SHARED:
        lb //= 2
    return lb


def staged_rows(mode: str, R: int, *, blend: bool = False) -> int:
    """The table rows a block stages: none for ``null`` (it reads no
    table), the gather's 8, else all ``R``."""
    if blend:
        return R
    return {"null": 0, "gather": GATHER_ROWS}.get(mode, R)


def block_bytes(rows: int, lb: int, elem: int) -> int:
    """A block's dynamic shared memory: ``rows`` x ``lb`` entries, in
    whole 16-byte chunks."""
    return -(-rows * lb * elem // CHUNK) * CHUNK


def kernel_attributes(mode: str, n: int | None = None, *, elem: int = 4,
                      blend: bool = False) -> dict:
    """The card build's attributes of the kernel of (``mode``, ``n``,
    ``elem``): ``registers`` and ``local_bytes`` a thread (spills),
    ``static_shared`` bytes and the ``max_dynamic_shared`` bytes it is
    opted in to (``cudaFuncGetAttributes``). Needs the card."""
    ns, modes = (BLEND_NS, BLEND_MODES) if blend else (SELECT_NS,
                                                       SELECT_MODES)
    n = ns[mode][0] if n is None else n
    out = (ctypes.c_int * 4)()
    lib = _cuda_lib()
    _raise_on(lib, lib.lzr4_kernel_attributes(
        int(blend), modes.index(mode), n, elem, out), "kernel_attributes")
    return dict(zip(("registers", "local_bytes", "static_shared",
                     "max_dynamic_shared"), out))


# -- plain versions ------------------------------------------------------


def _mix(s0, mask: int, R: int):
    return ((s0 * MIX) & mask).clamp(max=R - 1)


def select_chain_reference(x, st, *, mode: str, n: int | None = None,
                           mask: int = 1023, iters: int,
                           full: bool = False):
    """Plain version of :func:`select_chain`."""
    n = SELECT_NS[mode][0] if n is None else n
    R, L = x.shape
    lanes = torch.arange(L, device=x.device)
    xs = x.long()
    s = st.long().clone()
    s0 = s[0]
    c = s0[lanes % GATHER_LANES]
    offs = _offsets(mode, n)
    for _ in range(iters):
        if mode == "null":
            s0 = (s0 * 5 + 1) & 0xFFFF
        elif mode == "sel":
            acc = s0
            for j in range(n):
                idx = (_mix(s0, mask, R) + j).clamp(max=R - 1)
                acc = acc + xs[idx, lanes]
                s0 = acc & 0xFFFF
        elif mode == "gather":
            g = xs[c & (GATHER_ROWS - 1), lanes % GATHER_LANES]
            s0 = (s0 + g) & 0xFFFF
            c = (c + g) & 0xFFFF
        else:
            i0 = _mix(s0, mask, R)
            v = sum(xs[(i0 + o).clamp(max=R - 1), lanes] for o in offs)
            s0 = (s0 + v) & 0xFFFF
    s[0] = s0
    out = s0.int()[None]
    return (out, {"state": s.int()}) if full else out


def blend_chain_reference(x, st, *, mode: str, n: int | None = None,
                          iters: int, full: bool = False):
    """Plain version of :func:`blend_chain`."""
    n = BLEND_NS[mode][0] if n is None else n
    R, L = x.shape
    lanes = torch.arange(L, device=x.device)
    tab = x.long().clone()
    s = st.long().clone()
    s0, s1, s2 = s[0], s[1], s[2]
    offs = _offsets(mode, n)
    zero = torch.zeros(L, dtype=torch.int64, device=x.device)

    def past(rows):  # x[rows], 0 past the table
        return torch.where(rows < R, tab[rows.clamp(max=R - 1), lanes], zero)

    for _ in range(iters):
        m = _mix(s0, 1023, R)
        if mode in ("par3", "fused"):
            for w, val in zip(WRITES, (s1, s2)):  # the second write wins
                tab[(m + w).clamp(max=R - 1), lanes] = val
            v = [tab[(m + o).clamp(max=R - 1), lanes] for o in offs]
            s0 = (s0 + sum(v)) & 0xFFFF
            s1 = (s1 + v[0]) & 0x7FF
            s2 = (s2 + v[1 % n]) & 0x7FF
        elif mode == "mask":
            t = tab[m, lanes]
            tab[m, lanes] = t ^ ((t ^ s1) & (s2 | 0xFF))
            w0 = past(m + 1)
            s0 = (s0 + w0) & 0xFFFF
            s1, s2 = w0, (s1 >> 8) & 0xFFFF
        else:
            tab[m, lanes] = s1
            w0, old = past(m + 1), past(m + 2)
            s0 = (s0 + w0) & 0xFFFF
            s1 = (old & -256) | (w0 & 0xFF)
    s[0], s[1], s[2] = s0, _wrap(s1), _wrap(s2)
    out = s0.int()[None]
    if not full:
        return out
    return out, {"table": tab.int(), "state": s.int()}


# -- kernel launches (the nvcc build on a CUDA tensor, the g++ build of
# probe_round4.cuh on a CPU one) -----------------------------------------


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lzr4_error_string(rc).decode())


def _cuda_lib():
    from lzma_rs_tpu_torch.ops import build

    return build.load_round4()


def launch_select_chain(lib, x, st, *, mode: str, n: int | None = None,
                        mask: int = 1023, iters: int, full: bool = False):
    """Run ``lib``'s ``lzr4_select_chain``."""
    n = SELECT_NS[mode][0] if n is None else n
    t, s0 = x.contiguous(), st.contiguous()
    s = torch.empty_like(s0)
    rc = lib.lzr4_select_chain(
        SELECT_MODES.index(mode), n, _ELEM[x.dtype], t.data_ptr(),
        t.shape[0], t.shape[1], mask, s0.data_ptr(), s.data_ptr(), iters,
        _stream(x))
    _raise_on(lib, rc, "select_chain")
    out = s[0:1]
    return (out, {"state": s}) if full else out


def launch_blend_chain(lib, x, st, *, mode: str, n: int | None = None,
                       iters: int, full: bool = False):
    """Run ``lib``'s ``lzr4_blend_chain`` on a copy of ``x``."""
    n = BLEND_NS[mode][0] if n is None else n
    tab = x.clone(memory_format=torch.contiguous_format)
    s0 = st.contiguous()
    s = torch.empty_like(s0)
    rc = lib.lzr4_blend_chain(
        BLEND_MODES.index(mode), n, tab.data_ptr(), tab.shape[0],
        tab.shape[1], s0.data_ptr(), s.data_ptr(), iters, _stream(x))
    _raise_on(lib, rc, "blend_chain")
    out = s[0:1]
    return (out, {"table": tab, "state": s}) if full else out


# -- wrappers ------------------------------------------------------------


def _check_state(x, st):
    _check("st", st)
    if tuple(st.shape) != (4, x.shape[1]):
        raise ValueError(f"st {tuple(st.shape)}: want [4, {x.shape[1]}]")
    _check_same_device(x, st)


def _check_n(mode: str, n, ns: dict) -> int:
    n = ns[mode][0] if n is None else n
    if n not in ns[mode]:
        raise ValueError(f"n = {n!r}: {mode} is built for n in {ns[mode]}")
    return n


def select_chain(x, st, *, mode: str, n: int | None = None, mask: int = 1023,
                 iters: int, full: bool = False):
    """``iters`` iterations of a read-only round4 probe (``mode``, ``n``
    reads; the module docstring) over ``x`` ([R, L]: int32, or int16 or
    int8 for ``sel`` with n = 1) from ``st`` ([4, L] int32). The output is
    slot 0 [1, L]; ``full`` adds ``state`` [4, L] (slots 1-3 unchanged)."""
    _check_mode("mode", mode, SELECT_MODES)
    n = _check_n(mode, n, SELECT_NS)
    _check("x", x, dtypes=tuple(_ELEM) if (mode, n) == ("sel", 1) else
           (torch.int32,))
    _check_state(x, st)
    _check_mode("mask", mask, MASKS)
    _check_int("iters", iters, 0)
    if mode == "gather" and (x.shape[0] < GATHER_ROWS
                             or x.shape[1] % GATHER_LANES):
        raise ValueError(f"x {tuple(x.shape)}: gather wants {GATHER_ROWS} "
                         f"rows and whole {GATHER_LANES}-lane tiles")
    kw = {"mode": mode, "n": n, "mask": mask, "iters": iters, "full": full}
    if x.device.type == "cpu":
        return select_chain_reference(x, st, **kw)
    res = launch_select_chain(_cuda_lib(), x, st, **kw)
    select_chain.launches += 1
    return res


def blend_chain(x, st, *, mode: str, n: int | None = None, iters: int,
                full: bool = False):
    """``iters`` iterations of a round4 probe that writes the table
    (``mode``, ``n`` reads; the module docstring) over a copy of ``x`` ([R,
    L] int32, R >= 10) from ``st`` ([4, L] int32). The output is slot 0 [1,
    L]; ``full`` adds the final ``table`` [R, L] and ``state`` [4, L]."""
    _check_mode("mode", mode, BLEND_MODES)
    n = _check_n(mode, n, BLEND_NS)
    _check("x", x)
    _check_state(x, st)
    _check_int("iters", iters, 0)
    if x.shape[0] < BLEND_ROWS:
        raise ValueError(f"x {tuple(x.shape)}: want {BLEND_ROWS} rows")
    kw = {"mode": mode, "n": n, "iters": iters, "full": full}
    if x.device.type == "cpu":
        return blend_chain_reference(x, st, **kw)
    res = launch_blend_chain(_cuda_lib(), x, st, **kw)
    blend_chain.launches += 1
    return res


for _w, _ref in ((select_chain, select_chain_reference),
                 (blend_chain, blend_chain_reference)):
    _w.launches = 0
    _w.reference = _ref
WRAPPERS = (select_chain, blend_chain)
