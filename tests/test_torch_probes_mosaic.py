"""The mosaic probe kernels of the port against the JAX package's probes.

- Each of the twelve Pallas functions of ``tools/probe_mosaic.py`` and
  ``tools/probe_mosaic2.py`` (imported by path: ``tools/`` is not a
  package), run in interpret mode at every row of the tool, against its
  counterpart in ``lzma_rs_tpu_torch/tools/`` on the CPU (the plain
  versions of ``ops/probes_mosaic.py``): exact equality of the output and,
  for ``probe_mosaic2``, of the final table and carry (its
  ``while_loop`` opened by ``test_torch_probes.OpenLoop``), on the tool's
  own input and on two seeded ones: every input over its type's full
  range ("wide"), and int32 inputs within 1,024 of +-2^31 ("edge": start
  indices that wrap in int32 before the floor mod, sums and +1 that
  wrap). The tools' own inputs are all-ones or ``arange`` tables that
  show neither.
- Small-W cases whose writes are read back (at the tools' W none is):
  E and D at W = 64 (512 steps), p3 and p6 at W = 64 with 200 steps.
- A g++ build of ``csrc/probe_mosaic.cuh`` (``-DLZP_HOST_ENTRY``, the C
  interface of ``csrc/probes_mosaic.cu`` as host loops) against the plain
  versions, for every mode and element type: output and final table;
  ``gather_sum``'s split (an output's ranks and their sum in rank order)
  also against the Pallas probe on every gather row and input, at the
  tool's twelve row shapes at reduced steps, over strides and starts that
  wrap int32 mid-walk, and its launch rule against the Python copy;
  ``row_chain`` in the card's order (p6's staged quarter columns at every
  lanes a block a call may name, p1-p3's ranks and their block's sum,
  p3's table written into the output) at W from 2 to 2,048, 0 to 3 W + 7
  steps and 1 to 130 lanes, p6's row limit, and a call's one launch.
- The wrappers' checks, the tools' command lines, p6's row count for the
  bound, and (marked ``cuda``) each kernel against its plain version on
  the card. (``ops/build.py``'s per-library hash, the ``mosaic`` library
  included, is ``test_torch_probes.py``'s.)

JAX is imported only by the tests that run the Pallas probes, so the
``cuda`` tests run on a machine without it.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.ops import build
from lzma_rs_tpu_torch.ops import probes_mosaic as pm
from lzma_rs_tpu_torch.tools import probe_mosaic, probe_mosaic2, probe_rows

from test_torch_probes import (TOOLS, assert_same, jax_tool,  # noqa: F401
                               pallas)

REPO = os.path.dirname(TOOLS)
HEADER = os.path.join(REPO, "lzma_rs_tpu_torch", "csrc", "probe_mosaic.cuh")
INT32 = (-2**31, 2**31)
NEAR_LIMIT = (2**31 - 1024, 2**31 + 1024)
NP = {torch.int32: np.int32, torch.uint8: np.uint8}


def tpu_row_names(tool: str) -> list:
    """The row names of ``tools/<tool>.py``'s ``main`` list, in order."""
    with open(os.path.join(TOOLS, f"{tool}.py")) as f:
        return re.findall(r'^\s*\("([A-FP]\d*[a-z]? [^"]+)",', f.read(),
                          re.M)


def seeded(like: tuple, kind: str, seed: int) -> tuple:
    """Numpy inputs of ``like``'s shapes and types: "wide" over the type's
    full range, "edge" (int32) within 1,024 of +-2^31."""
    rng = np.random.default_rng(seed)
    out = []
    for t in like:
        if t.dtype == torch.uint8:
            lo, hi = 0, 256
        else:
            lo, hi = INT32 if kind == "wide" else NEAR_LIMIT
        a = rng.integers(lo, hi, size=tuple(t.shape), dtype=np.int64)
        out.append(a.astype(NP[t.dtype]))
    return tuple(out)


# probe_mosaic: row -> (function, the shape arguments, dtype). The JAX
# function takes (*shape, [dtype,] interpret), the port's (*shape,
# [dtype,] device).
MOSAIC_ROWS = {
    **{f"A gather-minor [{L},{W}] {t}": ("probe_gather_minor", (L, W), t)
       for L, W, t in ((8, 128, "i32"), (128, 128, "i32"), (8, 1024, "i32"),
                       (128, 1024, "i32"), (8, 128, "u8"))},
    **{f"B gather-sublane [{R},128] i32":
       ("probe_gather_sublane", (R, 128), "i32") for R in (8, 64, 512)},
    **{f"C onehot-read [128,{W}] i32": ("probe_onehot_read", (128, W), "i32")
       for W in (768, 2048)},
    **{f"D onehot-write [128,{W}] i32":
       ("probe_onehot_write", (128, W), "i32") for W in (768, 2048)},
    "E scalar-rw [1,4096]": ("probe_scalar_rw", (4096,), None),
    **{f"F dynrow pl.ds [{R},128]": ("probe_dynrow", (R, 128), None)
       for R in (512, 4096)},
    # small W: the writes are read back
    "E scalar-rw [1,64]": ("probe_scalar_rw", (64,), None),
    "D onehot-write [128,64] i32": ("probe_onehot_write", (128, 64), "i32"),
}
MOSAIC2_ROWS = {name: (name.split()[0].lower(), None)
                for name in tpu_row_names("probe_mosaic2")}
MOSAIC2_ROWS.update({  # (W, ITERS): the idx wraps, p3's writes are read
    "P3 W=64 200 steps": ("p3", (64, 200)),
    "P6 W=64 200 steps": ("p6", (64, 200)),
})
INPUTS = ("tool", "wide", "edge")


def test_the_rows_are_the_tpu_tools_rows():
    assert [n for n, _ in probe_mosaic.ROWS_OF_TOOL] == \
        tpu_row_names("probe_mosaic") == [
            n for n in MOSAIC_ROWS if not n.endswith(("[1,64]", ",64] i32"))]
    assert [n for n, _ in probe_mosaic2.ROWS_OF_TOOL] == \
        tpu_row_names("probe_mosaic2")
    assert len(MOSAIC_ROWS) == 17 and len(MOSAIC2_ROWS) == 8


def check_equal(got, want, what: str):
    got = got.numpy()
    assert got.dtype == want.dtype, what
    assert got.size == want.size, what
    assert np.array_equal(got, want.reshape(got.shape)), what


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("row", MOSAIC_ROWS)
def test_mosaic_port_equals_the_pallas_probe(row, kind, host_lib):
    import jax
    import jax.numpy as jnp

    fname, shape, t = MOSAIC_ROWS[row]
    jdt = {"i32": (jnp.int32,), "u8": (jnp.uint8,), None: ()}[t]
    pdt = {"i32": (torch.int32,), "u8": (torch.uint8,), None: ()}[t]
    jfn, jargs = getattr(jax_tool("probe_mosaic"), fname)(*shape, *jdt, True)
    pfn, pargs, _ = getattr(probe_mosaic, fname)(*shape, *pdt, device="cpu")
    assert pfn.iters == jax_tool("probe_mosaic").ITERS
    assert [tuple(a.shape) for a in pargs] == [a.shape for a in jargs]
    if kind == "tool":
        xs = tuple(np.array(a) for a in jargs)
        for p, x in zip(pargs, xs):
            check_equal(p, x, "the tool's input")
    else:
        xs = seeded(pargs, kind, sorted(MOSAIC_ROWS).index(row))
    want = np.asarray(jax.block_until_ready(jfn(*map(jnp.asarray, xs))))
    got, full = pfn(*map(torch.from_numpy, xs), full=True)
    check_equal(got, want, "out")
    if pfn.wrapper is pm.gather_sum:  # the kernel's split, its g++ build
        x, start = pfn.view(*map(torch.from_numpy, xs))
        check_equal(pm.launch_gather_sum(host_lib, x, start, iters=pfn.iters,
                                         **pfn.kwargs), want, "host build")
    if kind != "tool" and fname == "probe_onehot_write":
        # the edge input's +1 wraps at 2^31 - 1 somewhere
        assert (xs[0] == 2**31 - 1).any() or kind == "wide"


def pallas_final(fname: str, final: dict, iters: int) -> dict:
    """The Pallas probe's final table and carry as the port's ``full``
    entries: ``state`` is [acc, idx] (p1-p3, p6), p4's acc rows, or
    [total, mask] (p5)."""
    carry = final["carry"]
    if fname == "p4":  # carry i, acc [2, L]
        assert int(carry[0]) == iters
        return {"state": carry[1]}
    if fname == "p5":  # carry i, mask, acc
        assert int(carry[0]) == iters
        return {"table": final["x_ref"],
                "state": np.stack([carry[2], carry[1]])}
    idx, i, acc = carry
    assert int(i) == iters
    res = {"state": np.stack([acc.reshape(-1), idx.reshape(-1)])}
    if fname == "p3":
        res["table"] = final["x_ref"]
    return res


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("row", MOSAIC2_ROWS)
def test_mosaic2_port_equals_the_pallas_probe(row, kind, pallas,  # noqa: F811
                                              monkeypatch):
    import jax
    import jax.numpy as jnp

    fname, small = MOSAIC2_ROWS[row]
    tool = jax_tool("probe_mosaic2")
    if small is not None:
        for mod in (tool, probe_mosaic2):
            monkeypatch.setattr(mod, "W", small[0])
            monkeypatch.setattr(mod, "ITERS", small[1])
    jfn, jargs = getattr(tool, fname)()
    pfn, pargs, lanes = getattr(probe_mosaic2, fname)(device="cpu")
    assert lanes == tool.L and pfn.iters == tool.ITERS
    if kind == "tool":
        xs = (np.array(jargs[0]),)
        check_equal(pargs[0], xs[0], "the tool's input")
    else:
        xs = seeded(pargs, kind, sorted(MOSAIC2_ROWS).index(row))
    want = jfn(jnp.asarray(xs[0]))
    jax.block_until_ready(want)
    jax.effects_barrier()
    got, full = pfn(torch.from_numpy(xs[0]), full=True)
    check_equal(got, np.asarray(want), "out")
    final = pallas_final(fname, pallas.final, tool.ITERS)
    assert full.keys() == final.keys()
    for k, w in final.items():
        check_equal(full[k], w, k)


def test_the_tools_inputs_show_no_wrap():
    """Why the seeded inputs: on the tools' own inputs row A's u8 sum is 0
    everywhere and p1-p3 never clamp."""
    fn, args, _ = probe_mosaic.probe_gather_minor(8, 128, torch.uint8,
                                                  device="cpu")
    assert fn(*args).eq(0).all()
    fn, args, _ = probe_mosaic2.p1(device="cpu")
    assert fn(*args).eq(probe_mosaic2.ITERS).all()


# -- the g++ build of the header -----------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzm") / "liblzm_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZP_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    return build.bind_mosaic(ctypes.CDLL(so))


def ints(shape, seed: int, lo_hi=INT32, dtype=torch.int32):
    a = np.random.default_rng(seed).integers(*lo_hi, size=shape,
                                             dtype=np.int64)
    return torch.from_numpy(a.astype(NP[dtype]))


# gather_sum's starts over x [24, 40]: (shape, mod, stride, range) for
# each axis; the outputs of the first case have x's shape (A, B)
GATHER_STARTS = {
    "minor": (((24, 40), 40, 1, NEAR_LIMIT), ((10, 3), 7, 13, INT32),
              ((24, 1), 23, -5, NEAR_LIMIT)),
    "major": (((24, 40), 24, 1, NEAR_LIMIT), ((5, 40), 7, 13, INT32),
              ((1, 40), 23, -5, NEAR_LIMIT)),
}


# strides of the walks: the tools' 1 and 13, negative ones, and large ones
# whose walk wraps int32 every read or two (2^31 - 1, -2^31) or every few
GATHER_STRIDES = (1, 13, -5, -1, 2**31 - 1, -2**31, 2**30 + 3,
                  -(2**31 - 7), 123_456_789)


@pytest.mark.parametrize("dtype", (torch.int32, torch.uint8))
@pytest.mark.parametrize("axis", pm.AXES)
def test_host_build_gather_sum(axis, dtype, host_lib):
    """Each output's ranks (a warp's 32 or one thread) and their sum in
    rank order, at 300 steps and at 45 (not a multiple of 32: ranks 0-12
    take two, the rest one), over moduli that are not powers of two,
    starts within 1,024 of +-2^31 that wrap mid-walk, and every stride of
    GATHER_STRIDES."""
    x = ints((24, 40), 1, (0, 256) if dtype == torch.uint8 else INT32, dtype)
    for i, (shape, mod, stride, lo_hi) in enumerate(GATHER_STARTS[axis]):
        start = ints(shape, 2 + i, lo_hi)
        for st in (stride, *GATHER_STRIDES):
            for iters in (300, 45):
                kw = {"axis": axis, "mod": mod, "stride": st,
                      "iters": iters, "full": True}
                assert_same(pm.launch_gather_sum(host_lib, x, start, **kw),
                            pm.gather_sum_reference(x, start, **kw))


@pytest.mark.parametrize("dtype", (torch.int32, torch.uint8))
def test_host_build_gather_sum_a_thread_an_output(dtype, host_lib):
    """The major axis from GATHER_THREAD_MIN outputs: a thread an output
    (x [24, 256], start [16, 256]: 4,096 outputs), and one output fewer, a
    warp an output, on the same walks."""
    x = ints((24, 256), 3, (0, 256) if dtype == torch.uint8 else INT32,
             dtype)
    start = ints((16, 256), 4, NEAR_LIMIT)
    assert pm.gather_launch("major", start.numel())[0] == 1
    assert pm.gather_launch("major", start.numel() - 256)[0] == 32
    for st in (1, -5, 2**31 - 1, 123_456_789):
        for rows, mod in ((16, 24), (15, 17)):
            kw = {"axis": "major", "mod": mod, "stride": st, "iters": 45,
                  "full": True}
            s = start[:rows]
            assert_same(pm.launch_gather_sum(host_lib, x, s, **kw),
                        pm.gather_sum_reference(x, s, **kw))


GATHER_ROWS = [(i, n, m) for i, (n, m) in enumerate(probe_mosaic.ROWS_OF_TOOL)
               if n[0] in "ABCF"]


@pytest.mark.parametrize("steps", (0, 1, 31, 45))
@pytest.mark.parametrize("row", [n for _, n, _ in GATHER_ROWS])
def test_host_build_gather_sum_tool_rows(row, steps, host_lib):
    """The tool's twelve gather rows at their shapes, at reduced steps (a
    rank with none, one, or one or two), on the tool's input and the
    seeded one (starts within 1,024 of +-2^31)."""
    i, make = next((i, m) for i, n, m in GATHER_ROWS if n == row)
    fn, args, lanes = make("cpu")
    for xs in (args, fn.seeded_inputs(args, 70 + i)):
        x, start = fn.view(*xs)
        assert start.numel() == lanes
        kw = {**fn.kwargs, "iters": steps, "full": True}
        assert_same(pm.launch_gather_sum(host_lib, x, start, **kw),
                    pm.gather_sum_reference(x, start, **kw))


def test_gather_launch_is_the_kernels(host_lib):
    """The Python copy of the split against the header's
    (``lzm_gather_launch``), and the split of the tool's rows: C and F a
    warp an output and a warp a block (128 blocks), B [512, 128] a thread
    an output in 32-thread blocks."""
    for axis in pm.AXES:
        for n in (0, 1, 127, 128, 1023, 1024, 1025, 4095, 4096, 65536,
                  131072):
            out = (ctypes.c_int * 3)()
            assert host_lib.lzm_gather_launch(pm.AXES.index(axis), n,
                                              out) == 0
            assert tuple(out) == pm.gather_launch(axis, n), (axis, n)
    assert host_lib.lzm_gather_launch(2, 1, (ctypes.c_int * 3)()) != 0
    split = {n: pm.gather_launch(make("cpu")[0].kwargs["axis"],
                                 make("cpu")[2]) for _, n, make in GATHER_ROWS}
    assert split["C onehot-read [128,2048] i32"] == (32, 32, 128)
    assert split["F dynrow pl.ds [4096,128]"] == (32, 32, 128)
    assert split["A gather-minor [128,1024] i32"] == (32, 128, 32768)
    assert split["B gather-sublane [64,128] i32"] == (1, 32, 256)
    assert split["B gather-sublane [512,128] i32"] == (1, 32, 2048)


@pytest.mark.parametrize("mode", pm.RW_MODES)
def test_host_build_rw_chain(mode, host_lib):
    for i, (W, lo_hi) in enumerate(((64, INT32), (37, NEAR_LIMIT),
                                    (4096, INT32))):
        rows = 1 if mode == "scalar" else 9
        x = ints((rows, W), 10 + i, lo_hi)
        start = None if mode == "scalar" else ints((rows,), 20 + i,
                                                   NEAR_LIMIT)
        kw = {"mode": mode, "iters": 700, "full": True}
        got = pm.launch_rw_chain(host_lib, x, start, **kw)
        assert_same(got, pm.rw_chain_reference(x, start, **kw))
        if mode == "scalar" and W == 64:  # the writes are read back
            assert not torch.equal(got[1]["table"], x)


# D's widths below and at a warp, where one step's 32 adds hit a word
# more than once; E's widths where a load issued ahead hits a pending
# store (37 d = 1 mod W: W = 36 at d = 1, 73 at d = 2, 110 at d = 3; every
# load at W = 1 and 2), and the widest row E's kernel takes
RW_ROWS_W = (1, 5, 31, 32)
RW_SCALAR_W = (1, 2, 36, 73, 110, pm.RW_MAX_COLS)


def rw_rows_cases(W: int):
    """D's edge cases at width W: (x, start, iters) on 9 and 33 rows (not
    a multiple of 32), starts within 1,024 of +-2^31 and over the full
    range, iters 0, W - 1, W, 3 W + 1 and 700."""
    for rows in (9, 33):
        x = ints((rows, W), 90 + W + rows)
        for j, lo_hi in enumerate((NEAR_LIMIT, INT32)):
            start = ints((rows,), 95 + W + rows + j, lo_hi)
            for iters in sorted({0, max(W - 1, 0), W, 3 * W + 1, 700}):
                yield x, start, iters


@pytest.mark.parametrize("W", RW_ROWS_W)
def test_host_build_rw_rows_edges(W, host_lib):
    for x, start, iters in rw_rows_cases(W):
        kw = {"mode": "rows", "iters": iters, "full": True}
        assert_same(pm.launch_rw_chain(host_lib, x, start, **kw),
                    pm.rw_chain_reference(x, start, **kw))


SCALAR_ITERS = (0, 1, 2, 3, 4, 5, 7, 8, 9, 700)  # the look-ahead's ends


@pytest.mark.parametrize("W", RW_SCALAR_W)
def test_host_build_rw_scalar_edges(W, host_lib):
    x = ints((1, W), 100 + W % 97)
    for iters in SCALAR_ITERS:
        kw = {"mode": "scalar", "iters": iters, "full": True}
        got = pm.launch_rw_chain(host_lib, x, **kw)
        assert_same(got, pm.rw_chain_reference(x, **kw))
    if W in (36, 73, 110):  # iteration i + d reads what i stored
        assert [d for d in (1, 2, 3) if 37 * d % W == 1]


def wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def rw_scalar_model(row, v0: int, iters: int):
    """E with its walk from v0 (the probe's is 0), in Python integers: j =
    wrap(v0 + 37 i) floor-mod W; v = x[j]; x[(j + 1) % W] = v + carry;
    carry += v. Returns the row and carry."""
    x, carry = [int(v) for v in row], 0
    for i in range(iters):
        j = wrap32(v0 + 37 * i) % len(x)
        v = x[j]
        x[(j + 1) % len(x)] = wrap32(v + carry)
        carry = wrap32(carry + v)
    return x, carry


# walks that wrap int32 at their first few steps, in every place of a
# pass of four (and of the first loads): 37 n reaches INT32_MAX - e + 37 d
WRAP_STARTS = tuple(2**31 - 1 - 37 * d - e for d in range(10)
                    for e in (0, 1, 17, 36)) + (-5, 2**31 - 1, -2**31)
WRAP_ITERS = (1, 3, 4, 5, 8, 13, 61)


@pytest.mark.parametrize("W", (1, 2, 5, 36, 37, 73, 110))
def test_host_build_rw_scalar_across_the_wrap(W, host_lib):
    """E's walk wraps int32 only after ~58 M iterations from the probe's
    start, so the host build runs it from starts near INT32_MAX
    (lzm_rw_scalar_from): the step that handles a wrap (ScalarWalk::next
    with the check), the pass that may wrap and the straight-line pass
    against the model, with forwards where 37 d = 1 mod W."""
    fn = host_lib.lzm_rw_scalar_from
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_int]
    row = np.random.default_rng(300 + W).integers(
        *INT32, size=W, dtype=np.int64).astype(np.int32)
    for v0 in WRAP_STARTS:
        for iters in WRAP_ITERS:
            x, out = row.copy(), np.zeros(1, dtype=np.int32)
            assert fn(x.ctypes.data, W, v0, out.ctypes.data, iters) == 0
            want, carry = rw_scalar_model(row, v0, iters)
            assert (x.tolist(), int(out[0])) == (want, carry), (v0, iters)
    assert fn(row.ctypes.data, pm.RW_MAX_COLS + 1, 0,
              np.zeros(1, dtype=np.int32).ctypes.data, 1) == -1


@pytest.mark.parametrize("W", (1, 3, 36, 37, 4096))
def test_scalar_walk_steps_across_the_wrap(W, host_lib):
    """ScalarWalk's step (an add and a conditional subtract, the floor
    mod again where 37 n wraps) gives floor_mod(wrap(v0 + 37 i), W)."""
    fn = host_lib.lzm_scalar_walk
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int32, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int]
    n = 64
    for v0 in WRAP_STARTS:
        js = np.zeros(n, dtype=np.int32)
        assert fn(v0, W, js.ctypes.data, n) == 0
        assert js.tolist() == [wrap32(v0 + 37 * i) % W for i in range(n)]


def test_rw_launch_is_the_kernels(host_lib):
    """The Python copy of rw_chain's launch against the header's
    (``lzm_rw_launch``): D a warp a row, a warp a block below 1,024 rows
    (the tool's 128 rows on 128 SMs); E one block of 256 threads."""
    for mode in pm.RW_MODES:
        for rows in (0, 1, 9, 33, 128, 1023, 1024, 1025, 65536):
            out = (ctypes.c_int * 3)()
            assert host_lib.lzm_rw_launch(pm.RW_MODES.index(mode), rows,
                                          out) == 0
            assert tuple(out) == pm.rw_launch(mode, rows), (mode, rows)
    assert host_lib.lzm_rw_launch(2, 1, (ctypes.c_int * 3)()) != 0
    assert pm.rw_launch("rows", 128) == (32, 32, 128)
    assert pm.rw_launch("scalar", 1) == (1, 256, 1)
    assert host_lib.lzm_rw_max_cols() == pm.RW_MAX_COLS == 58112


# row_chain's edges: W powers of two and not (p6's floor mod and its
# ceil(W / 4) staged rows, from one row up), lanes from one through a
# part-filled block of 8 to past a block of 128, and the tables' ranges
# cycled over the lane counts
ROW_W = (2, 3, 5, 64, 100, 257, 2048)
ROW_LANES = (1, 7, 8, 9, 70, 130)
ROW_RANGES = (INT32, NEAR_LIMIT, (-4, 12))


def row_cases(W: int):
    """(x, iters) of row_chain's edge cases at W rows: every lane count of
    ROW_LANES, at 0, W - 1, W, W + 1 (p3's second pass), 3 W + 7 (its
    later passes) and 250 steps."""
    for k, L in enumerate(ROW_LANES):
        x = ints((W, L), 30 + 7 * k + W % 89, ROW_RANGES[k % 3])
        for iters in sorted({0, W - 1, W, W + 1, 3 * W + 7, 250}):
            yield x, iters


@pytest.mark.parametrize("W", ROW_W)
@pytest.mark.parametrize("mode", pm.ROW_MODES)
def test_host_build_row_chain(mode, W, host_lib):
    """The card's order on the host: p6 stages each block's rows, then
    runs its lanes; p1-p3 sum each rank's owned rows, then the block's
    parts (p3's table: its visited rows and the copied rest)."""
    for x, iters in row_cases(W):
        kw = {"mode": mode, "iters": iters, "full": True}
        assert_same(pm.launch_row_chain(host_lib, x, **kw),
                    pm.row_chain_reference(x, **kw))


@pytest.mark.parametrize("lanes", (1, 2, 4, 8, 16))
def test_host_build_row_chain_block_lanes(lanes, host_lib):
    """p6 at each lanes a block its rule gives (the widest W with that
    many, and 3 rows fewer), at 130 lanes: part-filled last blocks,
    staged in 16-byte chunks and word by word."""
    widest = 4 * (pm.SLICE_BYTES // (4 * lanes))
    for i, W in enumerate((widest, widest - 3)):
        assert pm.row_launch("byte", W)[0] == lanes
        x = ints((W, 130), 90 + i, (-9, 300))
        kw = {"mode": "byte", "iters": 300, "full": True}
        assert_same(pm.launch_row_chain(host_lib, x, **kw),
                    pm.row_chain_reference(x, **kw))


def test_row_launch_is_the_kernels(host_lib):
    """The Python copy of row_chain's launch against the header's
    (``lzm_row_launch``, ``lzm_row_copy_blocks``): p6 16 lanes a block up
    to 4,096 rows, halved while the staged slice passes 64 KiB; p1-p3 8
    lanes, 256 threads, p3's copy in blocks of about 256 rows."""
    for mode in pm.ROW_MODES:
        for W in (2, 5, 2048, 8192, 40_000, pm.ROW_MAX_BYTE_W):
            out = (ctypes.c_int * 3)()
            assert host_lib.lzm_row_launch(pm.ROW_MODES.index(mode), W,
                                           out) == 0
            assert tuple(out) == pm.row_launch(mode, W), (mode, W)
    assert pm.row_launch("byte", 2048) == (16, 256, 32768)
    assert pm.row_launch("byte", 40_000) == (1, 256, 40_000)
    assert pm.row_launch("clamp", 2048) == (8, 256, 0)
    assert host_lib.lzm_row_max_w() == pm.ROW_MAX_BYTE_W == 232_448
    for mode in pm.ROW_MODES:
        for W in (2, 257, 2048) + ((2**25,) if mode != "byte" else ()):
            for iters in (0, 1, W - 1, W, 64, 3 * W + 7):
                assert host_lib.lzm_row_copy_blocks(
                    pm.ROW_MODES.index(mode), W, iters) == \
                    pm.row_copy_blocks(mode, W, iters), (mode, W, iters)
    assert pm.row_copy_blocks("clamp_write", 2048, 64) == 8
    assert pm.row_copy_blocks("clamp_write", 2**25, 0) == 65535
    out = (ctypes.c_int * 3)()
    for mode, W in ((2, pm.ROW_MAX_BYTE_W + 1), (0, 1), (3, 64), (-1, 64)):
        assert host_lib.lzm_row_launch(mode, W, out) != 0


def test_host_build_row_chain_at_the_shared_memory_limit(host_lib):
    """p6's widest table runs (a lane's staged quarter column fills a
    block's shared memory); one row more is refused by the host build and
    by the wrapper on the CPU, so both devices take the same inputs; p1-p3
    take it."""
    W = pm.ROW_MAX_BYTE_W
    x = ints((W + 1, 2), 49, (-9, 300))
    kw = {"mode": "byte", "iters": 40, "full": True}
    assert_same(pm.launch_row_chain(host_lib, x[:W], **kw),
                pm.row_chain_reference(x[:W], **kw))
    with pytest.raises(RuntimeError, match="bad argument"):
        pm.launch_row_chain(host_lib, x, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        pm.row_chain(x, **kw)
    kw["mode"] = "clamp_write"
    assert_same(pm.launch_row_chain(host_lib, x, **kw),
                pm.row_chain_reference(x, **kw))


class DispatchedOps:
    """The PyTorch ops a block of code dispatches (their names)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append(func.overloadpacket.__name__)
                return func(*args, **(kwargs or {}))

        self.mode = Ops()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def only_outputs(self) -> bool:
        """Only outputs' ``torch.empty`` and views: no copy, no fill."""
        return bool(self.seen) and all(
            op.startswith("empty") or op in ("slice", "view")
            for op in self.seen)


def test_a_call_is_one_launch(host_lib):
    """A row_chain or segment_chain call makes no copy of its input and no
    zeroed state before the kernel: its state (and p3's and p5's tables)
    are ``torch.empty`` and the table goes in as it is, so on the card the
    kernel's launch is the call's only one; the input is not written."""
    x = ints((2048, 130), 47, (-3, 50))
    kept = x.clone()
    calls = [(pm.launch_row_chain, m) for m in pm.ROW_MODES]
    calls += [(pm.launch_segment_chain, m) for m in pm.SEGMENT_MODES]
    for launch, mode in calls:
        for full in (False, True):
            with DispatchedOps() as ops:
                launch(host_lib, x, mode=mode, iters=64, full=full)
            assert ops.only_outputs(), (mode, ops.seen)
    assert torch.equal(x, kept)


# segment_chain's cases: both modes at 70 lanes, and p4 at one lane and
# either side of a 128-thread block
SEGMENT_CASES = [(m, 70) for m in pm.SEGMENT_MODES] + [
    ("refill", n) for n in (1, 127, 128, 129)]
# p4's iterations: either side of a round of 8 and of 8 rounds, and long
REFILL_ITERS = (0, 1, 7, 8, 9, 41, 63, 64, 65, 500)


@pytest.mark.parametrize(
    "mode,lanes", SEGMENT_CASES,
    ids=[m if n == 70 else f"{m}-{n}" for m, n in SEGMENT_CASES])
def test_host_build_segment_chain(mode, lanes, host_lib):
    """p5's block (one a lane, 256 threads splitting the rows, a combine
    every 16 steps) at W from one row a segment (thread 0 alone) past the
    block's threads, tables that wrap on +1, 0 and 1 steps and a run that
    ends inside a chunk. p4 in the card's order (its two words read once,
    rounds of 8 steps, then the last round's) at the rounds' edges, on
    tables whose refill wraps."""
    refill = mode == "refill"
    widths = (4, 8, 64, 100, 2048) if lanes == 70 else (4, 64)
    for i, W in enumerate(widths):
        for j, lo_hi in enumerate((INT32, NEAR_LIMIT)):
            x = ints((W, lanes), 40 + 2 * i + j, lo_hi)
            for iters in REFILL_ITERS if refill else (0, 1, 41):
                kw = {"mode": mode, "iters": iters, "full": True}
                assert_same(pm.launch_segment_chain(host_lib, x, **kw),
                            pm.segment_chain_reference(x, **kw))


@pytest.mark.parametrize("mode", pm.SEGMENT_MODES)
def test_segment_chain_leaves_its_input_unchanged(mode, host_lib):
    """p5 writes its final column into a new table and p4 only reads: the
    host build's call (the card's C interface) and the wrapper leave x as
    it was, and p5's table is the plain version's."""
    x = ints((64, 130), 49, (-3, 50))
    kept = x.clone()
    kw = {"mode": mode, "iters": 41, "full": True}
    got = pm.launch_segment_chain(host_lib, x, **kw)
    assert_same(got, pm.segment_chain_reference(x, **kw))
    pm.segment_chain(x, **kw)
    assert torch.equal(x, kept)
    if mode == "segments":
        assert not torch.equal(got[1]["table"], x)  # 41 steps of +1


def test_host_build_segment_chain_at_the_shared_memory_limit(host_lib):
    """The largest column the block's shared memory holds runs; one more
    row step is refused by the host build and by the wrapper on the CPU,
    so both devices take the same inputs."""
    W = pm.SEGMENT_MAX_ROWS
    assert W == host_lib.lzm_segment_max_rows() == 58048
    assert pm.segment_block_bytes(W) == pm.MAX_SHARED
    x = ints((W, 2), 48, NEAR_LIMIT)
    kw = {"mode": "segments", "iters": 3, "full": True}
    assert_same(pm.launch_segment_chain(host_lib, x, **kw),
                pm.segment_chain_reference(x, **kw))
    assert torch.equal(pm.segment_chain(x, **kw)[0],
                       pm.segment_chain_reference(x, **kw)[0])
    over = torch.zeros((W + 4, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm.launch_segment_chain(host_lib, over, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        pm.segment_chain(over, **kw)
    # p4 keeps its thread a lane and takes any W
    kw["mode"] = "refill"
    assert_same(pm.launch_segment_chain(host_lib, over, **kw),
                pm.segment_chain_reference(over, **kw))


def test_host_build_refuses_bad_arguments(host_lib):
    x = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm.launch_row_chain(host_lib, x, mode="clamp", iters=-1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm.launch_gather_sum(host_lib, x, x, axis="minor", mod=5, iters=1)
    # E's row one word past a block's shared memory: refused by the host
    # build and by the wrapper on the CPU, so both devices take the same
    over = torch.zeros((1, pm.RW_MAX_COLS + 1), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm.launch_rw_chain(host_lib, over, mode="scalar", iters=1)
    with pytest.raises(ValueError, match="shared memory"):
        pm.rw_chain(over, mode="scalar", iters=1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm.launch_rw_chain(host_lib, x, x[:, 0], mode="rows", iters=-1)


# -- the wrappers and the tools ------------------------------------------


def test_wrappers_on_the_cpu_take_the_plain_version():
    before = [w.launches for w in pm.WRAPPERS]
    x = ints((16, 8), 50)
    kept = x.clone()
    start = ints((16, 8), 51, NEAR_LIMIT)
    assert torch.equal(
        pm.gather_sum(x, start, axis="minor", mod=8, iters=9),
        pm.gather_sum_reference(x, start, axis="minor", mod=8, iters=9))
    assert torch.equal(pm.rw_chain(x, start[:, 0], mode="rows", iters=9),
                       pm.rw_chain_reference(x, start[:, 0], mode="rows",
                                             iters=9))
    for mode in pm.ROW_MODES:
        assert torch.equal(pm.row_chain(x, mode=mode, iters=30),
                           pm.row_chain_reference(x, mode=mode, iters=30))
    for mode in pm.SEGMENT_MODES:
        assert torch.equal(pm.segment_chain(x, mode=mode, iters=9),
                           pm.segment_chain_reference(x, mode=mode,
                                                      iters=9))
    assert [w.launches for w in pm.WRAPPERS] == before
    assert torch.equal(x, kept)  # no wrapper changes its input


BAD = {
    "dtype": lambda x, s: pm.row_chain(x.long(), mode="clamp", iters=1),
    "u8 start": lambda x, s: pm.gather_sum(x, s.to(torch.uint8),
                                           axis="minor", mod=4, iters=1),
    "dims": lambda x, s: pm.row_chain(x[0], mode="clamp", iters=1),
    "device": lambda x, s: pm.segment_chain(
        torch.zeros((8, 4), dtype=torch.int32, device="meta"),
        mode="refill", iters=1),
    "mode": lambda x, s: pm.row_chain(x, mode="onehot", iters=1),
    "iters": lambda x, s: pm.segment_chain(x, mode="refill", iters=-1),
    "mod": lambda x, s: pm.gather_sum(x, s, axis="minor", mod=5, iters=1),
    "axis": lambda x, s: pm.gather_sum(x, s, axis="rows", mod=4, iters=1),
    "start rows": lambda x, s: pm.gather_sum(x, torch.cat([s, s]),
                                             axis="minor", mod=4, iters=1),
    "start cols": lambda x, s: pm.gather_sum(x, s[:, :3], axis="major",
                                             mod=4, iters=1),
    "rw start": lambda x, s: pm.rw_chain(x, s[:4, 0], mode="rows", iters=1),
    "scalar rows": lambda x, s: pm.rw_chain(x, mode="scalar", iters=1),
    "scalar cols": lambda x, s: pm.rw_chain(
        torch.zeros((1, pm.RW_MAX_COLS + 1), dtype=torch.int32),
        mode="scalar", iters=1),
    "segment rows": lambda x, s: pm.segment_chain(x[:6], mode="segments",
                                                  iters=1),
    "byte rows limit": lambda x, s: pm.row_chain(
        torch.zeros((pm.ROW_MAX_BYTE_W + 1, 1), dtype=torch.int32),
        mode="byte", iters=1),
}


@pytest.mark.parametrize("bad", BAD)
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    x, s = ints((8, 4), 60), ints((8, 4), 61)
    with pytest.raises(ValueError):
        BAD[bad](x, s)


@pytest.mark.parametrize("tool,which", ((probe_mosaic, "E"),
                                        (probe_mosaic2, "P4")))
def test_tool_entry_points_run_on_the_card_unless_asked(tool, which):
    """The tools' functions default to the card, and the command line
    stops without one; ``--device cpu`` runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tool.ROWS_OF_TOOL[0][1](None)
    with pytest.raises(SystemExit):
        probe_rows.main(tool.ROWS_OF_TOOL, [which])
    rows = probe_rows.main(tool.ROWS_OF_TOOL,
                           [which, "--device", "cpu", "--seed", "1"])
    name = [n for n, _ in tool.ROWS_OF_TOOL if n.startswith(which)][0]
    assert [(r["name"], r["input"]) for r in rows] == [
        (name, "tool"), (name, "seeded")]


@pytest.mark.parametrize("W", (768, 2048))
def test_d_library_call_is_the_function(W):
    """D's library call (``clone`` and ``scatter_add_`` over the walk's
    column index built outside the call) is D's function: its plain
    version on the tool's input, at both of the tool's widths."""
    call, fn, args = probe_mosaic.onehot_write_library(W, device="cpu")
    assert torch.equal(call(), fn.plain(*args))
    assert probe_mosaic.LIBRARY_ROW in dict(probe_mosaic.ROWS_OF_TOOL)


def test_p1_library_call_is_the_function():
    """P1's library call (``x[:iters].clamp(min=0).sum(0,
    dtype=torch.int32)``, the tool's iters <= W from idx 0) is P1's
    function: its plain version on the tool's input and a seeded one."""
    call, fn, args = probe_mosaic2.clamp_library(device="cpu")
    assert torch.equal(call(), fn.plain(*args)[0])
    seeded = fn.seeded_inputs(args, 3)
    call, _, _ = probe_mosaic2.clamp_library(seeded[0])
    assert torch.equal(call(), fn.plain(*seeded)[0])
    assert probe_mosaic2.LIBRARY_ROW in dict(probe_mosaic2.ROWS_OF_TOOL)


def test_p6_counts_the_rows_its_walk_reads():
    x = torch.ones((2048, 128), dtype=torch.int32)
    # all-ones: the walk reads bytes 1, 0, 0, 1, ...: idx 0, 2, 3, 4, 6, ...
    rows = pm.byte_rows_read(x, 64)
    assert rows == 128 * len({i >> 2 for i in _walk_ones(64)})
    fn, args, lanes = probe_mosaic2.p6(device="cpu")
    assert fn.words_for(*args) == rows / lanes + 1


def _walk_ones(iters):
    idx, seen = 0, []
    for _ in range(iters):
        seen.append(idx)
        idx += (1 >> (8 * (idx & 3))) + 1
    return seen


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


ALL_ROWS = probe_mosaic.ROWS_OF_TOOL + probe_mosaic2.ROWS_OF_TOOL


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [w.__name__ for w in pm.WRAPPERS])
def test_kernel_equals_plain_version_on_card(kernel, cuda_device):
    """Every row of the kernel, on the tool's input and a seeded one."""
    wrapper = getattr(pm, kernel)
    before, runs = wrapper.launches, 0
    for i, (name, make) in enumerate(ALL_ROWS):
        fn, args, _ = make(cuda_device)
        if fn.wrapper is not wrapper:
            continue
        for xs in (args, fn.seeded_inputs(args, 70 + i)):
            got = fn(*xs, full=True)
            torch.cuda.synchronize()
            assert_same(got, fn.plain(*xs, full=True))
            runs += 1
    assert runs and wrapper.launches == before + runs


@pytest.mark.cuda
def test_gather_kernel_edges_on_card(cuda_device):
    """The host tests' walks on the card: both axes and element types, a
    warp an output and a thread an output, strides that wrap int32 every
    read or two, 45 steps, starts within 1,024 of +-2^31."""
    before, runs = pm.gather_sum.launches, 0
    for dtype in (torch.int32, torch.uint8):
        lo_hi = (0, 256) if dtype == torch.uint8 else INT32
        for axis, xshape, sshape, mod in (("minor", (24, 40), (10, 3), 7),
                                          ("major", (24, 40), (5, 40), 23),
                                          ("major", (24, 256), (16, 256),
                                           17)):
            x = ints(xshape, 5, lo_hi, dtype).to(cuda_device)
            start = ints(sshape, 6, NEAR_LIMIT).to(cuda_device)
            for st in GATHER_STRIDES:
                kw = {"axis": axis, "mod": mod, "stride": st, "iters": 45,
                      "full": True}
                got = pm.gather_sum(x, start, **kw)
                torch.cuda.synchronize()
                assert_same(got, pm.gather_sum_reference(x, start, **kw))
                runs += 1
    assert pm.gather_sum.launches == before + runs


@pytest.mark.cuda
def test_rw_kernel_edges_on_card(cuda_device):
    """The host tests' rw_chain edges on the card: D at widths below and
    at a warp (adds of one step that hit a word more than once), rows not
    a multiple of 32, starts within 1,024 of +-2^31; E where a load issued
    ahead hits a pending store and at the widest row; neither kernel
    spills."""
    before, runs = pm.rw_chain.launches, 0
    for W in RW_ROWS_W:
        for x, start, iters in rw_rows_cases(W):
            x, start = x.to(cuda_device), start.to(cuda_device)
            kw = {"mode": "rows", "iters": iters, "full": True}
            got = pm.rw_chain(x, start, **kw)
            torch.cuda.synchronize()
            assert_same(got, pm.rw_chain_reference(x, start, **kw))
            runs += 1
    for W in RW_SCALAR_W:
        x = ints((1, W), 100 + W % 97).to(cuda_device)
        for iters in SCALAR_ITERS:
            kw = {"mode": "scalar", "iters": iters, "full": True}
            got = pm.rw_chain(x, **kw)
            torch.cuda.synchronize()
            assert_same(got, pm.rw_chain_reference(x, **kw))
            runs += 1
    assert pm.rw_chain.launches == before + runs
    for mode in pm.RW_MODES:
        assert pm.rw_attributes(mode)["local_bytes"] == 0
    assert pm.rw_attributes("scalar")["max_dynamic_shared"] == pm.MAX_SHARED


@pytest.mark.cuda
@pytest.mark.parametrize("W", ROW_W)
def test_row_kernel_edges_on_card(W, cuda_device):
    """The host build's row_chain edges on the card (every mode, lane count
    and step count of row_cases)."""
    before, runs = pm.row_chain.launches, 0
    for x, iters in row_cases(W):
        x = x.to(cuda_device)
        for mode in pm.ROW_MODES:
            kw = {"mode": mode, "iters": iters, "full": True}
            got = pm.row_chain(x, **kw)
            torch.cuda.synchronize()
            assert_same(got, pm.row_chain_reference(x, **kw))
            runs += 1
    assert pm.row_chain.launches == before + runs


@pytest.mark.cuda
def test_row_attributes_on_card(cuda_device):
    """row_chain's kernels: the launch of row_launch, no spills."""
    for mode in pm.ROW_MODES:
        for W in (5, 2048, pm.ROW_MAX_BYTE_W):
            a = pm.row_attributes(mode, W)
            assert (a["lanes"], a["threads"], a["shared_bytes"]) == \
                pm.row_launch(mode, W)
            assert a["local_bytes"] == 0


@pytest.mark.cuda
def test_a_call_is_one_launch_on_card(cuda_device):
    """On the card a row_chain or segment_chain call dispatches no PyTorch
    op but its outputs' ``torch.empty`` (and views), counts one launch and
    leaves its input as it was."""
    x = ints((2048, 130), 47, (-3, 50)).to(cuda_device)
    kept = x.clone()
    calls = [(pm.row_chain, m) for m in pm.ROW_MODES]
    calls += [(pm.segment_chain, m) for m in pm.SEGMENT_MODES]
    for wrapper, mode in calls:
        for full in (False, True):
            before = wrapper.launches
            with DispatchedOps() as ops:
                wrapper(x, mode=mode, iters=64, full=full)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert ops.only_outputs(), (mode, ops.seen)
    assert torch.equal(x, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", (1, 127, 128, 129, 70))
def test_refill_kernel_edges_on_card(lanes, cuda_device):
    """p4's host-build cases on the card: one lane and either side of a
    block, 0 to 500 iterations (every round's edge), tables whose refill
    wraps; its kernel's launch and no spills."""
    before, runs = pm.segment_chain.launches, 0
    for i, W in enumerate((4, 64)):
        for j, lo_hi in enumerate((INT32, NEAR_LIMIT)):
            x = ints((W, lanes), 40 + 2 * i + j, lo_hi).to(cuda_device)
            for iters in REFILL_ITERS:
                kw = {"mode": "refill", "iters": iters, "full": True}
                got = pm.segment_chain(x, **kw)
                torch.cuda.synchronize()
                assert_same(got, pm.segment_chain_reference(x, **kw))
                runs += 1
    assert pm.segment_chain.launches == before + runs
    a = pm.segment_attributes("refill", 64)
    assert (a["lanes"], a["threads"], a["shared_bytes"],
            a["local_bytes"]) == (128, 128, 0, 0)


@pytest.mark.cuda
def test_segments_kernel_edges_on_card(cuda_device):
    """p5's block at the CPU tests' edges on the card: one row a segment,
    rows past the block's threads, the largest column, at 1 and 130
    lanes, runs that end inside and at a chunk's end."""
    before, runs = pm.segment_chain.launches, 0
    for i, (W, L) in enumerate(((4, 130), (100, 1), (2048, 130),
                                (pm.SEGMENT_MAX_ROWS, 3))):
        x = ints((W, L), 80 + i, NEAR_LIMIT).to(cuda_device)
        for iters in (0, 1, 16, 41):
            kw = {"mode": "segments", "iters": iters, "full": True}
            got = pm.segment_chain(x, **kw)
            torch.cuda.synchronize()
            assert_same(got, pm.segment_chain_reference(x, **kw))
            runs += 1
    assert pm.segment_chain.launches == before + runs
    a = pm.segment_attributes("segments", 2048)
    assert a["local_bytes"] == 0
    assert a["max_dynamic_shared"] == pm.MAX_SHARED
    assert (a["lanes"], a["threads"], a["shared_bytes"]) == (
        1, pm.SEGMENT_THREADS, pm.segment_block_bytes(2048))
