"""Mosaic probe kernels: four per-thread functions, asked on the card.

The port of the Pallas probes in ``tools/probe_mosaic.py`` and
``tools/probe_mosaic2.py`` (twelve functions, four per-thread functions on
a thread-per-lane card; the one-hot masked reads and writes of the TPU
probes are direct indexed loads and stores here, with the same results):

- :func:`gather_sum` (``probe_gather_minor`` A, ``probe_gather_sublane``
  B, ``probe_onehot_read`` C, ``probe_dynrow`` F): each output element
  sums ``iters`` values of ``x`` along its row (``axis="minor"``) or its
  column (``"major"``) at ``(start + stride * i) % mod``;
- :func:`rw_chain` (``probe_onehot_write`` D, ``probe_scalar_rw`` E): a
  read-modify-write per step, a warp per row (D), or one serial
  load-after-store chain (E) over the row in one block's shared memory;
- :func:`row_chain` (``p1``/``p2``, ``p3``, ``p6``): a lane-carried index
  over a lane-minor ``[W, L]`` table, from 0: p6's walk over the bytes a
  serial chain a lane in shared memory, p1-p3's rows (whose index does
  not depend on the data) split over a block;
- :func:`segment_chain` (``p4``, ``p5``): a periodic two-row refill, or
  four segment updates with each segment's max.

Each wrapper launches its hand-written kernel (``csrc/probes_mosaic.cu``)
on a CUDA tensor, or raises; on a CPU tensor it runs its plain PyTorch
version (``*_reference``: direct indexing, every thread in lockstep).
The kernels run a thread per row or lane, with five exceptions.
``gather_sum`` splits an output's steps over a warp (the minor axis, and
the major axis below :data:`GATHER_THREAD_MIN` outputs) or gives each
output a thread (:func:`gather_launch`); ``rw_chain``'s D splits a row's
steps over a warp the same way (:func:`rw_launch`). E (``rw_chain``, mode
``"scalar"``) runs its chain in one block's shared memory, so its row
holds at most :data:`RW_MAX_COLS` words. p5's (``segment_chain``, mode
``"segments"``) runs a block of :data:`SEGMENT_THREADS` per lane, with
the lane's whole column in the block's shared memory and its rows split
over the threads; so its table holds at most :data:`SEGMENT_MAX_ROWS`
rows; p4's (mode ``"refill"``) runs a thread a lane with the lane's two
source words in registers. ``row_chain`` runs p1-p3 as blocks of :data:`ROW_THREADS` over
:data:`ROW_LANES` lanes, a lane's visited rows split over the block's
ranks (:func:`row_launch`), and p6 as a thread a lane over the first
quarter of its lanes' columns staged into the block's shared memory, so
its table holds at most :data:`ROW_MAX_BYTE_W` rows. The wrappers refuse
a larger E row, p5 column or p6 table on either device.
``<wrapper>.launches`` counts kernel launches, ``<wrapper>.reference`` is
the plain version. Inputs are not changed. ``row_chain`` and
``segment_chain`` start from the probes' zeros, and a call is one launch,
which writes the state and the final table. ``full=True`` also returns a
dict: the final table where the function writes one (E, p3, p5; D's output
is its final table) and the carried state (``[2, L]``: row_chain's acc and
idx, p4's two acc rows, p5's total and mask).

Integer semantics are the probes': wrapping int32 (uint8 for A's u8 row),
and an index is jnp's ``%`` of a wrapped int32 (the floor mod).
"""

from __future__ import annotations

import ctypes

import torch

from lzma_rs_tpu_torch.ops.probes import _stream

__all__ = [
    "AXES", "RW_MODES", "ROW_MODES", "SEGMENT_MODES", "WRAPPERS",
    "GATHER_OPS", "RW_OPS", "ROW_OPS", "segment_ops", "byte_rows_read",
    "SEGMENT_THREADS", "SEGMENT_MAX_ROWS", "segment_block_bytes",
    "segment_attributes", "GATHER_THREAD_MIN", "gather_launch",
    "RW_MAX_COLS", "rw_launch", "rw_attributes", "ROW_THREADS",
    "ROW_LANES", "BYTE_LANES", "ROW_MAX_BYTE_W", "row_launch",
    "row_copy_blocks", "row_attributes",
    "gather_sum", "gather_sum_reference", "rw_chain", "rw_chain_reference",
    "row_chain", "row_chain_reference", "segment_chain",
    "segment_chain_reference",
]

AXES = ("minor", "major")
RW_MODES = ("rows", "scalar")                   # D, E
ROW_MODES = ("clamp", "clamp_write", "byte")    # p1/p2, p3, p6
SEGMENT_MODES = ("refill", "segments")          # p4, p5
SCALAR_STRIDE = 37                              # E: j = 37 i % W
REFILL_EVERY = 8                                # p4
# p5's kernel (csrc/probe_mosaic.cuh): a block of SEGMENT_THREADS a lane,
# its shared memory SEGMENT_SLOTS int32 slots (16 steps x 4 segments'
# maxima) and the column, at most MAX_SHARED bytes in all
SEGMENT_THREADS = 256
SEGMENT_SLOTS = 64
MAX_SHARED = 232448
SEGMENT_MAX_ROWS = (MAX_SHARED // 4 - SEGMENT_SLOTS) // 4 * 4  # 58,048
# E's kernel: a block of RW_SCALAR_THREADS stages the row (at most
# RW_MAX_COLS words) into shared memory, one thread runs the chain
RW_SCALAR_THREADS = 256
RW_MAX_COLS = MAX_SHARED // 4  # 58,112
# row_chain's kernels (csrc/probe_mosaic.cuh): blocks of ROW_THREADS; p1-p3
# ROW_LANES lanes a block; p6 BYTE_LANES a block (8, 16 and 32 took the
# same time within 0.2 us on the H100, PERF.md), halved while the block's slice (rows
# [0, ceil(W / 4)) of its lanes' columns) passes SLICE_BYTES, its W at most
# ROW_MAX_BYTE_W (one lane's slice in MAX_SHARED)
ROW_THREADS = 256
ROW_LANES = 8
BYTE_LANES = 16
SLICE_BYTES = 65536
ROW_MAX_BYTE_W = 4 * (MAX_SHARED // 4)  # 232,448
# p3's blocks a lane group copy its unvisited rows in ranges of about
# COPY_ROWS rows, one a block (at most MAX_COPY_BLOCKS)
COPY_ROWS = 256
MAX_COPY_BLOCKS = 65535

# gather_sum's launch (csrc/probe_mosaic.cuh: gather_group, gather_block):
# a warp an output, or a thread an output on the major axis from
# GATHER_THREAD_MIN outputs; a warp a block below GATHER_SPREAD outputs and
# for a thread an output, else BLOCK threads (the mosaic kernels' block)
GATHER_WARP = 32
GATHER_THREAD_MIN = 4096
GATHER_SPREAD = 1024
BLOCK = 128

# Integer operations per thread and step, counted from the probes' code
# (for the bound). gather_sum: the index's add (F: multiply), its mod (A:
# and), the address, the sum. rw_chain: D the add, the mod, the address,
# the +1; E 37 i, its mod, j + 1, its mod, two addresses, v + carry,
# carry + v. row_chain: clamp the address, the max, acc's add, idx + 1,
# the mod; clamp_write also v & 1, the test, v + 1 and the select;
# byte idx >> 2, the address, idx & 3, * 8, the shift, & 0xFF, acc's add,
# idx's two adds, the mod.
GATHER_OPS = 4
RW_OPS = {"rows": 4, "scalar": 8}
ROW_OPS = {"clamp": 5, "clamp_write": 9, "byte": 10}


def segment_ops(mode: str, W: int) -> float:
    """p4: i % 8 and its test, acc's two adds, and every 8th step two adds
    and two addresses. p5: per row of W the address and the max, per row of
    the written segment the +1, per segment the mask's test and total's
    add, and the mask's add and mod."""
    if mode == "refill":
        return 4 + 4 / REFILL_EVERY
    return 2 * W + W // 4 + 4 * 2 + 2


def gather_launch(axis: str, n_out: int) -> tuple:
    """``gather_sum``'s launch for ``n_out`` outputs along ``axis``: the
    threads an output, the threads a block and the blocks (a copy of the
    kernel's rule, ``lzm_gather_launch``)."""
    group = (1 if axis == "major" and n_out >= GATHER_THREAD_MIN
             else GATHER_WARP)
    block = (BLOCK if group == GATHER_WARP and n_out >= GATHER_SPREAD
             else GATHER_WARP)
    return group, block, -(-n_out * group // block)


def rw_launch(mode: str, rows: int) -> tuple:
    """``rw_chain``'s launch for ``rows`` rows: the threads a row (D: a
    warp, gather_sum's launch for as many outputs; E: one thread runs the
    chain), the threads a block and the blocks (a copy of the kernel's
    rule, ``lzm_rw_launch``)."""
    if mode == "scalar":
        return 1, RW_SCALAR_THREADS, 1
    return (GATHER_WARP,) + gather_launch("minor", rows)[1:]


def _byte_rows(W: int) -> int:
    return -(-W // 4)


def row_launch(mode: str, W: int) -> tuple:
    """``row_chain``'s launch at ``W`` rows: the lanes a block (p6:
    :data:`BYTE_LANES` halved while the slice passes 64 KiB; p1-p3: :data:`ROW_LANES`, p3 with :func:`row_copy_blocks` a
    lane group), the threads a block and the dynamic shared memory a block
    (p6's slice; p1-p3 none): a copy of the kernel's rule,
    ``lzm_row_launch``."""
    if mode != "byte":
        return ROW_LANES, ROW_THREADS, 0
    lb = BYTE_LANES
    while lb > 1 and lb * _byte_rows(W) * 4 > SLICE_BYTES:
        lb //= 2
    return lb, ROW_THREADS, 4 * lb * _byte_rows(W)


def row_copy_blocks(mode: str, W: int, iters: int) -> int:
    """``row_chain``'s blocks a lane group: p3's unvisited rows
    ``[min(W, iters), W)`` in ranges of about :data:`COPY_ROWS`, one a
    block (the first also sums); 1 for p1, p2 (a copy of the kernel's rule,
    ``lzm_row_copy_blocks``)."""
    if mode != "clamp_write":
        return 1
    n = W - min(W, iters)
    return min(max(1, -(-n // COPY_ROWS)), MAX_COPY_BLOCKS)


def segment_block_bytes(W: int) -> int:
    """p5's shared memory a block (a lane) for a column of ``W`` rows."""
    return 4 * (SEGMENT_SLOTS + W)


def segment_attributes(mode: str, W: int) -> dict:
    """The card build's attributes of the kernel that :func:`segment_chain`
    launches on a ``[W, L]`` table: ``registers`` and ``local_bytes`` a
    thread (spills), ``static_shared`` bytes and the ``max_dynamic_shared``
    bytes it is opted in to (``cudaFuncGetAttributes``), and its ``lanes``
    and ``threads`` a block and ``shared_bytes``, the dynamic shared memory
    of a block (p4: 128 lanes and threads, none; p5: one lane, 256
    threads, :func:`segment_block_bytes`). Needs the card."""
    _check_mode("mode", mode, SEGMENT_MODES)
    return _attributes(
        lambda lib, out: lib.lzm_segment_attributes(
            SEGMENT_MODES.index(mode), W, out),
        "segment_attributes", ("lanes", "threads", "shared_bytes"))


def rw_attributes(mode: str) -> dict:
    """The card build's attributes of ``rw_chain``'s kernel for ``mode``:
    ``registers``, ``local_bytes``, ``static_shared`` and
    ``max_dynamic_shared``, as :func:`segment_attributes` gives them. Needs
    the card."""
    _check_mode("mode", mode, RW_MODES)
    return _attributes(
        lambda lib, out: lib.lzm_rw_attributes(RW_MODES.index(mode), out),
        "rw_attributes")


def row_attributes(mode: str, W: int) -> dict:
    """The card build's attributes of the kernel that :func:`row_chain`
    launches on a ``[W, L]`` table, as :func:`segment_attributes` gives
    them, its launch from :func:`row_launch`. Needs the card."""
    _check_mode("mode", mode, ROW_MODES)
    return _attributes(
        lambda lib, out: lib.lzm_row_attributes(ROW_MODES.index(mode), W,
                                                out),
        "row_attributes", ("lanes", "threads", "shared_bytes"))


def _attributes(query, what: str, more: tuple = ()) -> dict:
    names = ("registers", "local_bytes", "static_shared",
             "max_dynamic_shared") + more
    out = (ctypes.c_int * len(names))()
    lib = _cuda_lib()
    _raise_on(lib, query(lib, out), what)
    return dict(zip(names, out))


# -- plain versions ------------------------------------------------------


def _wrap(v):
    """int64 values -> the int32 values they wrap to (still int64)."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def _lines(shape, device, axis: str):
    """The x row (minor) or column (major) each output element reads."""
    r, c = shape
    if axis == "minor":
        return torch.arange(r, device=device)[:, None].expand(r, c)
    return torch.arange(c, device=device)[None, :].expand(r, c)


def gather_sum_reference(x, start, *, axis: str, mod: int, stride: int = 1,
                         iters: int, full: bool = False):
    """Plain version of :func:`gather_sum`."""
    acc = torch.zeros(start.shape, dtype=x.dtype, device=x.device)
    line = _lines(start.shape, x.device, axis)
    s = start.long()
    for i in range(iters):
        k = torch.remainder(_wrap(s + stride * i), mod)
        acc += x[line, k] if axis == "minor" else x[k, line]
    return (acc, {}) if full else acc


def rw_chain_reference(x, start=None, *, mode: str, iters: int,
                       full: bool = False):
    """Plain version of :func:`rw_chain`."""
    t = x.clone()
    W = t.shape[1]
    if mode == "rows":
        rows = torch.arange(t.shape[0], device=t.device)
        s = start.long()
        for i in range(iters):
            t[rows, torch.remainder(_wrap(s + i), W)] += 1
        return (t, {}) if full else t
    row = t[0]
    carry = torch.zeros((), dtype=torch.int32, device=t.device)
    for i in range(iters):
        j = _wrap(i * SCALAR_STRIDE) % W
        v = row[j].clone()
        row[(j + 1) % W] = v + carry
        carry = carry + v
    out = carry.reshape(1, 1)
    return (out, {"table": t}) if full else out


def row_chain_reference(x, *, mode: str, iters: int, full: bool = False):
    """Plain version of :func:`row_chain`."""
    W, L = x.shape
    t = x.clone() if mode == "clamp_write" else x
    lanes = torch.arange(L, device=x.device)
    idx = torch.zeros(L, dtype=torch.int64, device=x.device)
    acc = torch.zeros(L, dtype=torch.int32, device=x.device)
    for _ in range(iters):
        if mode == "byte":
            word = t[idx >> 2, lanes]
            byte = (word >> ((idx & 3) * 8).int()) & 0xFF
            acc += byte
            idx = (idx + byte + 1) % W
            continue
        v = t[idx, lanes].clamp(min=0)
        if mode == "clamp_write":
            odd = (v & 1) == 1
            t[idx[odd], lanes[odd]] = v[odd] + 1
        acc += v
        idx = (idx + 1) % W
    out = acc[None]
    if not full:
        return out
    res = {"state": torch.stack([acc, idx.int()])}
    if mode == "clamp_write":
        res["table"] = t
    return out, res


def segment_chain_reference(x, *, mode: str, iters: int, full: bool = False):
    """Plain version of :func:`segment_chain`."""
    W, L = x.shape
    if mode == "refill":
        acc = torch.zeros((2, L), dtype=torch.int32, device=x.device)
        scratch = acc
        for i in range(iters):
            if i % REFILL_EVERY == 0:
                scratch = x[0:2] + i
            acc = acc + scratch
        return (acc[0:1], {"state": acc}) if full else acc[0:1]
    t = x.clone()
    S = W // 4
    mask = torch.zeros(L, dtype=torch.int32, device=x.device)
    total = torch.zeros(L, dtype=torch.int32, device=x.device)
    for _ in range(iters):
        for s in range(4):
            seg = t[s * S:(s + 1) * S]
            seg.copy_(torch.where(mask[None] == s, seg + 1, seg))
            total += seg.max(dim=0).values
        mask = (mask + 1) % 4
    out = total[None]
    if not full:
        return out
    return out, {"table": t, "state": torch.stack([total, mask])}


def byte_rows_read(x, iters: int) -> int:
    """The distinct table rows that p6's walk (:func:`row_chain`, mode
    ``byte``) reads over ``x`` in ``iters`` steps, summed over lanes: the
    words this input needs (for the bound)."""
    x = x.cpu()
    W, L = x.shape
    lanes = torch.arange(L)
    idx = torch.zeros(L, dtype=torch.int64)
    seen = torch.zeros((W, L), dtype=torch.bool)
    for _ in range(iters):
        seen[idx >> 2, lanes] = True
        byte = (x[idx >> 2, lanes] >> ((idx & 3) * 8).int()) & 0xFF
        idx = (idx + byte + 1) % W
    return int(seen.sum())


# -- checks --------------------------------------------------------------


def _check(name, t, dtypes=(torch.int32,), dim: int = 2):
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: want {' or '.join(map(str, dtypes))}, "
                         f"got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: want {dim} dimensions, got "
                         f"{tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cuda or cpu, not {t.device}")
    if t.numel() >= 2**31 or any(n < 1 for n in t.shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} out of range")


def _check_same_device(*ts):
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs on {[str(t.device) for t in ts]}")


def _check_int(name: str, v: int, lo: int, hi: int = 2**31 - 1):
    if not (isinstance(v, int) and lo <= v <= hi):
        raise ValueError(f"{name} = {v!r} outside [{lo}, {hi}]")


def _check_mode(name: str, mode: str, modes: tuple):
    if mode not in modes:
        raise ValueError(f"{name} {mode!r} not in {modes}")


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lzm_error_string(rc).decode())


def _cuda_lib():
    from lzma_rs_tpu_torch.ops import build

    return build.load_mosaic()


# -- kernel launches (the nvcc build on a CUDA tensor, the g++ build of
# probe_mosaic.cuh on a CPU one) -----------------------------------------


def launch_gather_sum(lib, x, start, *, axis: str, mod: int, stride: int = 1,
                      iters: int, full: bool = False):
    """Run ``lib``'s ``lzm_gather_sum``."""
    xs, st = x.contiguous(), start.contiguous()
    out = torch.empty(start.shape, dtype=x.dtype, device=x.device)
    rc = lib.lzm_gather_sum(
        AXES.index(axis), int(x.dtype == torch.uint8), xs.data_ptr(),
        x.shape[0], x.shape[1], st.data_ptr(), stride, mod, out.data_ptr(),
        out.numel(), out.shape[1], iters, _stream(x))
    _raise_on(lib, rc, "gather_sum")
    return (out, {}) if full else out


def launch_rw_chain(lib, x, start=None, *, mode: str, iters: int,
                    full: bool = False):
    """Run ``lib``'s ``lzm_rw_chain`` on a copy of ``x``."""
    t = x.clone(memory_format=torch.contiguous_format)
    scalar = mode == "scalar"
    st = None if scalar else start.contiguous()
    out = torch.empty((1, 1), dtype=torch.int32, device=x.device)
    rc = lib.lzm_rw_chain(RW_MODES.index(mode), t.data_ptr(), t.shape[0],
                          t.shape[1], None if scalar else st.data_ptr(),
                          out.data_ptr(), iters, _stream(x))
    _raise_on(lib, rc, "rw_chain")
    if scalar:
        return (out, {"table": t}) if full else out
    return (t, {}) if full else t


def launch_row_chain(lib, x, *, mode: str, iters: int, full: bool = False):
    """Run ``lib``'s ``lzm_row_chain``: one launch, which writes the state
    and, for ``clamp_write``, the final table into a new tensor."""
    t = x.contiguous()
    state = torch.empty((2, x.shape[1]), dtype=torch.int32, device=x.device)
    table = torch.empty_like(t) if mode == "clamp_write" else None
    rc = lib.lzm_row_chain(ROW_MODES.index(mode), t.data_ptr(), t.shape[0],
                           t.shape[1], state.data_ptr(),
                           None if table is None else table.data_ptr(),
                           iters, _stream(x))
    _raise_on(lib, rc, "row_chain")
    out = state[0:1]
    if not full:
        return out
    res = {"state": state}
    if table is not None:
        res["table"] = table
    return out, res


def launch_segment_chain(lib, x, *, mode: str, iters: int,
                         full: bool = False):
    """Run ``lib``'s ``lzm_segment_chain``: one launch, which writes the
    state and, for ``segments``, the final table into a new tensor."""
    t = x.contiguous()
    state = torch.empty((2, x.shape[1]), dtype=torch.int32, device=x.device)
    table = torch.empty_like(t) if mode == "segments" else None
    rc = lib.lzm_segment_chain(SEGMENT_MODES.index(mode), t.data_ptr(),
                               t.shape[0], t.shape[1], state.data_ptr(),
                               None if table is None else table.data_ptr(),
                               iters, _stream(x))
    _raise_on(lib, rc, "segment_chain")
    out = state[0:1]
    if not full:
        return out
    res = {"state": state}
    if table is not None:
        res["table"] = table
    return out, res


# -- wrappers ------------------------------------------------------------


def gather_sum(x, start, *, axis: str, mod: int, stride: int = 1,
               iters: int, full: bool = False):
    """``out[r, c] = sum_i x[r, k]`` (``axis="minor"``) or ``x[k, c]``
    (``"major"``) for ``k = (start[r, c] + stride * i) % mod`` over ``iters``
    steps, the index wrapped to int32 before jnp's floor mod. ``x``:
    ``[rows, cols]`` int32 or uint8 (the sum wraps in its type);
    ``start``: int32 of the output's shape, ``[rows' <= rows, any]``
    (minor, ``mod <= cols``) or ``[any, cols]`` (major, ``mod <= rows``)."""
    _check("x", x, (torch.int32, torch.uint8))
    _check("start", start)
    _check_same_device(x, start)
    _check_mode("axis", axis, AXES)
    _check_int("iters", iters, 0)
    _check_int("stride", stride, -2**31)
    minor = axis == "minor"
    _check_int("mod", mod, 1, x.shape[1] if minor else x.shape[0])
    if (start.shape[0] > x.shape[0]) if minor else \
            (start.shape[1] != x.shape[1]):
        raise ValueError(f"start {tuple(start.shape)} does not fit x "
                         f"{tuple(x.shape)} along axis {axis!r}")
    kw = {"axis": axis, "mod": mod, "stride": stride, "iters": iters,
          "full": full}
    if x.device.type == "cpu":
        return gather_sum_reference(x, start, **kw)
    res = launch_gather_sum(_cuda_lib(), x, start, **kw)
    gather_sum.launches += 1
    return res


def rw_chain(x, start=None, *, mode: str, iters: int, full: bool = False):
    """``mode="rows"`` (D): for each row of ``x`` ([rows, W] int32) and step
    i, ``x[r, (start[r] + i) % W] += 1``; the output is the final table.
    ``"scalar"`` (E, ``x`` [1, W], no ``start``): ``j = 37 i % W;
    v = x[0, j]; x[0, (j + 1) % W] = v + carry; carry += v``; the output is
    ``carry`` [1, 1], and ``full`` adds the final table. E's kernel holds
    the row in one block's shared memory, so ``"scalar"`` takes at most
    :data:`RW_MAX_COLS` (58,112) words, on the CPU as on the card
    (ValueError beyond)."""
    _check("x", x)
    _check_mode("mode", mode, RW_MODES)
    _check_int("iters", iters, 0)
    if mode == "rows":
        _check("start", start, dim=1)
        _check_same_device(x, start)
        if start.shape[0] != x.shape[0]:
            raise ValueError(f"start {tuple(start.shape)}: want "
                             f"[{x.shape[0]}]")
    elif start is not None or x.shape[0] != 1:
        raise ValueError("mode 'scalar' takes x [1, W] and no start")
    elif x.shape[1] > RW_MAX_COLS:
        raise ValueError(f"x {tuple(x.shape)}: E's row of {x.shape[1]} "
                         "words does not fit a block's shared memory (at "
                         f"most {RW_MAX_COLS})")
    if x.device.type == "cpu":
        return rw_chain_reference(x, start, mode=mode, iters=iters,
                                  full=full)
    res = launch_rw_chain(_cuda_lib(), x, start, mode=mode, iters=iters,
                          full=full)
    rw_chain.launches += 1
    return res


def row_chain(x, *, mode: str, iters: int, full: bool = False):
    """``iters`` steps of a lane-carried ``idx`` (from 0) over ``x`` ([W, L]
    int32, W >= 2), one lane per column; the output is ``acc`` [1, L].
    ``"clamp"`` (p1/p2): ``v = max(x[idx], 0); acc += v; idx = (idx + 1) %
    W``; ``"clamp_write"`` (p3): also ``x[idx] = v + 1`` where ``v`` is odd;
    ``"byte"`` (p6): ``byte = x[idx >> 2] >> 8 (idx & 3) & 0xFF;
    acc += byte; idx = (idx + byte + 1) % W``; its kernel stages the first
    quarter of each lane's column into a block's shared memory, so
    ``"byte"`` takes at most :data:`ROW_MAX_BYTE_W` (232,448) rows, on the
    CPU as on the card (ValueError beyond). ``full`` adds ``state`` [2, L]
    (acc and idx) and, for ``"clamp_write"``, the final ``table``."""
    _check("x", x)
    _check_mode("mode", mode, ROW_MODES)
    _check_int("iters", iters, 0)
    if x.shape[0] < 2:
        raise ValueError(f"x {tuple(x.shape)}: want at least 2 rows")
    if mode == "byte" and x.shape[0] > ROW_MAX_BYTE_W:
        raise ValueError(f"x {tuple(x.shape)}: p6's quarter column of "
                         f"{_byte_rows(x.shape[0])} rows does not fit a "
                         f"block's shared memory (W at most "
                         f"{ROW_MAX_BYTE_W})")
    if x.device.type == "cpu":
        return row_chain_reference(x, mode=mode, iters=iters, full=full)
    res = launch_row_chain(_cuda_lib(), x, mode=mode, iters=iters,
                           full=full)
    row_chain.launches += 1
    return res


def segment_chain(x, *, mode: str, iters: int, full: bool = False):
    """Over ``x`` ([W, L] int32, W a multiple of 4), one lane per column.
    ``"refill"`` (p4): every 8th step ``s = x[0:2] + i``, each step
    ``acc += s``; the output is ``acc``'s row 0. ``"segments"`` (p5): each
    step, of four segments of W / 4 rows the one equal to the lane's
    ``mask`` (from 0) gets +1, ``total`` adds each segment's max, ``mask =
    (mask + 1) % 4``; the output is ``total``. Both [1, L]. p5's kernel
    holds a lane's column in one block's shared memory, so ``"segments"``
    takes at most :data:`SEGMENT_MAX_ROWS` (58,048) rows, on the CPU as on
    the card (ValueError beyond: there is no device-memory route)."""
    _check("x", x)
    _check_mode("mode", mode, SEGMENT_MODES)
    _check_int("iters", iters, 0)
    if x.shape[0] < 4 or x.shape[0] % 4:
        raise ValueError(f"x {tuple(x.shape)}: want a multiple of 4 rows")
    if mode == "segments" and x.shape[0] > SEGMENT_MAX_ROWS:
        raise ValueError(f"x {tuple(x.shape)}: p5's column of "
                         f"{x.shape[0]} rows does not fit a block's shared "
                         f"memory (at most {SEGMENT_MAX_ROWS})")
    if x.device.type == "cpu":
        return segment_chain_reference(x, mode=mode, iters=iters, full=full)
    res = launch_segment_chain(_cuda_lib(), x, mode=mode, iters=iters,
                               full=full)
    segment_chain.launches += 1
    return res


for _w, _ref in ((gather_sum, gather_sum_reference),
                 (rw_chain, rw_chain_reference),
                 (row_chain, row_chain_reference),
                 (segment_chain, segment_chain_reference)):
    _w.launches = 0
    _w.reference = _ref
WRAPPERS = (gather_sum, rw_chain, row_chain, segment_chain)
