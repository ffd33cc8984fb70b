"""The mosaic3 probe kernels of the port against the JAX package's probes.

- Each of the twelve Pallas functions of ``tools/probe_mosaic3.py``
  (imported by path), run in interpret mode with its ``while_loop``
  opened (``test_torch_probes.OpenLoop``), against its counterpart in
  ``lzma_rs_tpu_torch/tools/probe_mosaic3.py`` on the CPU (the plain
  versions of ``ops/probes_mosaic3.py``): exact equality of the output and
  the final carry (P7-P9's ``node``, ``i`` and P9's flag; P11's ``v``;
  the one-hots' ``idx`` and ``acc``; P16's ``base``, ``acc`` and its
  scratch), on the tool's input, "wide" (the full int32 range) and "edge"
  (within 1,024 of +-2^31: ``idx + v + 1``, ``x + i`` and ``base + v +
  129`` wrap before the floor mod). P7-P9 and P11 do not read ``x``: they
  run from seeded start carries instead (lanes that diverge and leave
  mid-loop, every lane already >= 5, one lane at -2^30, ``v0`` over the
  full int32 range).
- A g++ build of ``csrc/probe_mosaic3.cuh`` (``-DLZP_HOST_ENTRY``, the C
  interface of ``csrc/probes_mosaic3.cu`` as host loops over blocks,
  ranks and lanes) against the plain versions, for every mode, and for
  vote_chain as the card's one warp (each thread's slots, then the vote)
  at 1 to 1,024 lanes, and the shared-memory kernels at the blocks'
  edges (1, 70 and 130 lanes,
  tables of 8 to 20,000 rows, walks that straddle the table's end, drift
  apart and wrap), with the column limits; a call is one launch.
- The wrappers' checks, the tool's command line, the counts behind the
  bound, and (marked ``cuda``) each kernel against its plain version on
  the card, the edge cases there, a call's one launch and the kernels'
  attributes.

JAX is imported only by the tests that run the Pallas probes, so the
``cuda`` tests run on a machine without it.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.ops import build
from lzma_rs_tpu_torch.ops import probes_mosaic3 as pm3
from lzma_rs_tpu_torch.tools import probe_mosaic3, probe_rows

from test_torch_probes import (TOOLS, assert_same, jax_tool,  # noqa: F401
                               pallas)
from test_torch_probes_mosaic import (INT32, NEAR_LIMIT, DispatchedOps,
                                      tpu_row_names)

REPO = os.path.dirname(TOOLS)
HEADER = os.path.join(REPO, "lzma_rs_tpu_torch", "csrc",
                      "probe_mosaic3.cuh")
L = probe_mosaic3.L


def builders(name: str):
    """The TPU tool's and the port's builder of a function, by its name in
    the tools (``p12s`` is ``p12(True)``, ``p14`` is ``p_small(8)``)."""
    tool = jax_tool("probe_mosaic3")
    args = {"p12s": ("p12", True), "p12m": ("p12", False),
            "p14": ("p_small", 8), "p15": ("p_small", 64)}.get(name)
    if args is None:
        return getattr(tool, name), getattr(probe_mosaic3, name)
    return (getattr(tool, args[0])(args[1]),
            getattr(probe_mosaic3, args[0])(args[1]))


FUNCTIONS = ("p7", "p8", "p9", "p10", "p11a", "p11b", "p12s", "p12m", "p13",
             "p14", "p15", "p16")
VOTES, BYTES = ("p7", "p8", "p9"), ("p11a", "p11b")


def start(kind: str, seed: int) -> np.ndarray:
    """A seeded [L] start of P7-P9 (``node0``) or P11 (``v0``)."""
    rng = np.random.default_rng(seed)
    if kind == "diverge":  # lanes leave mid-loop, at different steps
        return rng.integers(-20, 11, size=L, dtype=np.int32)
    if kind == "above":    # every lane >= 5: P7/P8 run 0 steps, P9 one
        return rng.integers(5, 2**31, size=L, dtype=np.int64).astype(
            np.int32)
    if kind == "deep":     # one lane at -2^30: every step runs
        return probe_mosaic3.deep_start(rng, (L,))
    lo, hi = INT32 if kind == "wide" else NEAR_LIMIT
    return rng.integers(lo, hi, size=L, dtype=np.int64).astype(np.int32)


def table(kind: str, seed: int) -> np.ndarray:
    """The [W, L] input ``x``: the tool's all-ones, or seeded."""
    shape = (probe_mosaic3.W, L)
    if kind == "tool":
        return np.ones(shape, dtype=np.int32)
    lo, hi = INT32 if kind == "wide" else NEAR_LIMIT
    return np.random.default_rng(seed).integers(
        lo, hi, size=shape, dtype=np.int64).astype(np.int32)


CASES = [(f, k) for f in FUNCTIONS for k in (
    ("tool", "diverge", "above", "deep", "wide") if f in VOTES else
    ("tool", "wide", "edge"))]


def port_final(fname: str, final: dict, node) -> dict:
    """The Pallas probe's final carry and scratch as the port's ``full``
    entries; checks the loop counters the port does not return."""
    carry = final["carry"]
    if fname in VOTES:  # node, i (, active)
        i = int(carry[1])
        flag = (int(carry[2]) if fname == "p9"
                else int((node < pm3.VOTE_BELOW).any()))
        return {"state": np.array([i, flag], dtype=np.int32)}
    if fname in BYTES or fname == "p10":  # i, v or acc
        assert int(carry[0]) == probe_mosaic3.ITERS
        return {}
    if fname == "p16":  # i, base, acc
        assert int(carry[0]) == probe_mosaic3.ITERS
        return {"scratch": final["t_ref"],
                "state": np.stack([carry[2], carry[1]])}
    idx, i, acc = carry  # the one-hots
    passes = probe_mosaic3.ITERS // (8 if fname == "p13" else 1)
    assert int(i) == passes
    return {"state": np.stack([acc, idx])}


def check_equal(got, want, what: str):
    got = got.numpy()
    assert got.dtype == want.dtype, what
    assert got.size == want.size, what
    assert np.array_equal(got, want.reshape(got.shape)), what


@pytest.mark.parametrize("fname,kind", CASES)
def test_port_equals_the_pallas_probe(fname, kind, pallas):  # noqa: F811
    import jax
    import jax.numpy as jnp

    jbuild, pbuild = builders(fname)
    jfn, jargs = jbuild()
    pfn, pargs, lanes = pbuild(device="cpu")
    assert lanes == L and pfn.iters == jax_tool("probe_mosaic3").ITERS
    seed = CASES.index((fname, kind))
    reads_x = fname not in VOTES + BYTES
    x = table(kind if reads_x else "tool", seed)
    if kind == "tool":
        check_equal(torch.from_numpy(np.array(jargs[0])), x, "the input")
        port_in = pargs[0]
        if not reads_x:  # the probe's start
            assert not port_in.any()
    elif reads_x:
        port_in = torch.from_numpy(x)
    else:  # a seeded start carry: P7-P9's node, P11's v
        s = start(kind, seed)
        pallas.carry = {0 if fname in VOTES else 1: s}
        port_in = torch.from_numpy(s)
    want = jfn(jnp.asarray(x))
    jax.block_until_ready(want)
    jax.effects_barrier()
    got, full = pfn(port_in, full=True)
    check_equal(got, np.asarray(want), "out")
    final = port_final(fname, pallas.final, np.asarray(want))
    assert full.keys() == final.keys()
    for k, w in final.items():
        check_equal(full[k], w, k)
    if kind == "deep":
        assert int(full["state"][0]) == probe_mosaic3.ITERS
    if kind == "above":
        assert int(full["state"][0]) == (1 if fname == "p9" else 0)


def test_the_rows_are_the_tpu_tools_rows():
    names = tpu_row_names("probe_mosaic3")
    assert [n for n, _ in probe_mosaic3.ROWS_OF_TOOL] == names
    assert len(names) == len(FUNCTIONS) == 12


def test_the_seeded_inputs_show_what_the_tools_input_hides():
    """On the tool's all-ones P12s equals P12m, and P16's chunks stay
    inside the table but for the last step's second one (chunk 64, whose
    zeros do not change a max of ones); on "wide" P12s differs from P12m
    (negative entries: the max takes the one-hot's zeros) and P16's base
    leaves the table, so a lane's whole scratch is zeros. P7-P9 leave after
    10 steps from the tool's zeros, and lanes end apart on "diverge"."""
    ones, wide = (torch.from_numpy(table(k, 3)) for k in ("tool", "wide"))
    for x, same in ((ones, True), (wide, False)):
        s = pm3.onehot_chain(x, reduce="sum", iters=64)
        m = pm3.onehot_chain(x, reduce="max", iters=64)
        assert torch.equal(s, m) == same
        _, res = pm3.window_chain(x, mode="refill", iters=64, full=True)
        outside = (res["scratch"] == 0).all(dim=0).any()
        assert bool(outside) != same
    assert pm3.vote_iterations(torch.zeros(L, dtype=torch.int32), mode="any",
                               iters=64) == 10
    d = torch.from_numpy(start("diverge", 4))
    node = pm3.vote_chain(d, mode="any", iters=64)[0]
    assert len(set(node.tolist())) > 1  # lanes kept counting past 5


# -- the g++ build of the header -----------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzm3") / "liblzm3_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZP_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    return build.bind_mosaic3(ctypes.CDLL(so))


def ints(shape, seed: int, lo_hi=INT32):
    a = np.random.default_rng(seed).integers(*lo_hi, size=shape,
                                             dtype=np.int64)
    return torch.from_numpy(a.astype(np.int32))


VOTE_STARTS = ("zeros", "diverge", "above", "deep", "wide")


# vote_chain's lanes: a thread's one slot (1, 31, 32), two (33), a
# part-filled warp's slots (100, 1000) and the whole warp's (128, 1024),
# with each count's slots a thread
VOTE_LANES = {1: 1, 31: 1, 32: 1, 33: 2, 100: 4, 128: 4, 512: 16,
              513: 32, 1000: 32, 1024: 32}


@pytest.mark.parametrize("lanes", VOTE_LANES)
@pytest.mark.parametrize("mode", pm3.VOTE_MODES)
def test_host_build_vote_chain(mode, lanes, host_lib):
    """The card's order on the host: each of the warp's 32 threads steps
    its slots, then ORs them, then the warp votes."""
    assert host_lib.lzm3_vote_slots(lanes) == pm3.vote_slots(lanes) == \
        VOTE_LANES[lanes]
    for i, kind in enumerate(VOTE_STARTS):
        n0 = (torch.zeros(lanes, dtype=torch.int32) if kind == "zeros"
              else torch.from_numpy(np.resize(start(kind, 10 + i), lanes)))
        if kind == "deep":  # the lane that keeps the loop going, last
            n0[-1] = probe_mosaic3.DEEP
        for iters in (0, 7, 64, 300):
            kw = {"mode": mode, "iters": iters, "full": True}
            assert_same(pm3.launch_vote_chain(host_lib, n0, **kw),
                        pm3.vote_chain_reference(n0, **kw))


# byte_chain's first pick at its edges: every k = v & 3 against bytes with
# their high bit set (so an arithmetic shift would carry sign bits into the
# pick), and -1, INT32_MIN, INT32_MAX
BYTE_EDGES = [b | k for k in range(4) for b in (0x80808080, 0xFFFFFF00,
                                                0x7F80FF00, 0x00800000)]
BYTE_EDGES = [v - 2**32 if v >= 2**31 else v for v in BYTE_EDGES] + [
    -1, -2**31, 2**31 - 1]

# byte_chain's lanes: the tool's 130-lane case, one lane, and either side
# of a 128-thread block; iterations either side of a pass of four
# (the remainder's 0-3 steps) and long runs
BYTE_CASES = [(m, 130) for m in pm3.BYTE_MODES] + [
    (m, n) for n in (1, 127, 128, 129) for m in pm3.BYTE_MODES]
BYTE_ITERS = (0, 1, 3, 4, 5, 64, 131, 500)


def byte_starts(lanes: int) -> list:
    """byte_chain's starts at ``lanes`` lanes: seeded over the full range,
    near +-2^31 and small, and the edge words (repeated to the lanes)."""
    starts = [ints(lanes, 20 + i, lo_hi)
              for i, lo_hi in enumerate((INT32, NEAR_LIMIT, (-4, 4)))]
    edges = np.resize(np.array(BYTE_EDGES, dtype=np.int32), lanes)
    return starts + [torch.from_numpy(edges)]


@pytest.mark.parametrize(
    "mode,lanes", BYTE_CASES,
    ids=[m if n == 130 else f"{m}-{n}" for m, n in BYTE_CASES])
def test_host_build_byte_chain(mode, lanes, host_lib):
    """The card's order on the host: passes of four steps, then the
    remainder, the pick by the byte permute (P11a) or the select of four
    candidate bytes (P11b)."""
    for v0 in byte_starts(lanes):
        for iters in BYTE_ITERS:
            kw = {"mode": mode, "iters": iters, "full": True}
            assert_same(pm3.launch_byte_chain(host_lib, v0, **kw),
                        pm3.byte_chain_reference(v0, **kw))


@pytest.mark.parametrize("k", (0, 1, 2, 3, "own"))
def test_byte_perm_is_the_probes_shift(k, host_lib):
    """The byte permute's rule, as the host build writes the card's PRMT:
    by selector ``k | 0x4440`` it is ``(v >> 8 k) & 0xFF`` for 2^16 seeded
    int32 ``v`` and the edge words; by P11a's own selector ``(v & 3) |
    0x4440`` it is the probe's ``(v >> 8 (v & 3)) & 0xFF``."""
    v = np.concatenate([
        np.random.default_rng(90).integers(
            -2**31, 2**31, size=1 << 16, dtype=np.int64).astype(np.int32),
        np.array(BYTE_EDGES, dtype=np.int32)])
    out = np.empty_like(v)
    fn = host_lib.lzm3_byte_perm
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn(v.ctypes.data, v.size, -1 if k == "own" else k | 0x4440,
       out.ctypes.data)
    shift = (v & 3) * 8 if k == "own" else 8 * k
    assert np.array_equal(out, (v >> shift) & 0xFF)


@pytest.mark.parametrize("unroll", pm3.UNROLLS)
@pytest.mark.parametrize("reduce", pm3.REDUCES)
def test_host_build_onehot_chain(reduce, unroll, host_lib):
    for i, (R, lo_hi) in enumerate(((8, INT32), (64, NEAR_LIMIT),
                                    (100, (-9, 9)), (2048, INT32))):
        x = ints((R, 70), 30 + i, lo_hi)
        kw = {"reduce": reduce, "unroll": unroll, "iters": 200,
              "full": True}
        assert_same(pm3.launch_onehot_chain(host_lib, x, **kw),
                    pm3.onehot_chain_reference(x, **kw))


@pytest.mark.parametrize("mode", pm3.WINDOW_MODES)
def test_host_build_window_chain(mode, host_lib):
    for i, (W, lo_hi) in enumerate(((64, INT32), (96, NEAR_LIMIT),
                                    (2048, INT32), (2048, (-3, 50)))):
        x = ints((W, 70), 40 + i, lo_hi)
        for iters in (0, 41):
            kw = {"mode": mode, "iters": iters, "full": True}
            assert_same(pm3.launch_window_chain(host_lib, x, **kw),
                        pm3.window_chain_reference(x, **kw))


def test_host_build_refuses_bad_arguments(host_lib):
    """Bad modes and counts, and a column that does not fit a block's
    shared memory: R past 58,112 rows, P16's W past 58,080 (each limit
    itself runs)."""
    x = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm3.launch_onehot_chain(host_lib, x, reduce="max", unroll=8,
                                iters=12)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm3.launch_vote_chain(host_lib, torch.zeros(1025, dtype=torch.int32),
                              mode="any", iters=1)
    assert host_lib.lzm3_vote_slots(1025) == host_lib.lzm3_vote_slots(0) \
        == -1  # ERR_ARGS
    with pytest.raises(RuntimeError, match="bad argument"):
        pm3.launch_window_chain(host_lib, x[:40], mode="refill", iters=1)
    assert pm3.MAX_ONEHOT_ROWS == 58_112 and pm3.MAX_REFILL_ROWS == 58_080
    for reduce in pm3.REDUCES:
        tall = ints((pm3.MAX_ONEHOT_ROWS + 1, 1), 45, (-5, 9))
        with pytest.raises(RuntimeError, match="bad argument"):
            pm3.launch_onehot_chain(host_lib, tall, reduce=reduce, iters=8)
        kw = {"reduce": reduce, "iters": 8, "full": True}
        assert_same(pm3.launch_onehot_chain(host_lib, tall[:-1], **kw),
                    pm3.onehot_chain_reference(tall[:-1], **kw))
    tall = ints((pm3.MAX_REFILL_ROWS + pm3.CHUNK, 1), 46, (0, 5000))
    with pytest.raises(RuntimeError, match="bad argument"):
        pm3.launch_window_chain(host_lib, tall, mode="refill", iters=8)
    kw = {"mode": "refill", "iters": 8, "full": True}
    assert_same(pm3.launch_window_chain(host_lib, tall[:-pm3.CHUNK], **kw),
                pm3.window_chain_reference(tall[:-pm3.CHUNK], **kw))


# Edge tables of the shared-memory kernels: "climb" (small values, so
# P16's base climbs through every chunk to the table's end and the lanes
# drift apart), "wide" (the full int32 range) and "edge" (within 1,024 of
# +-2^31: idx + v + 1, x + i and base + v + 129 wrap).
EDGE_TABLES = {"climb": (-3, 50), "wide": INT32, "edge": NEAR_LIMIT}
# R: powers of two and not, from a block of 32 lanes (R = 8, 100) down to
# 4 (4,096, 3,000) and 1 (20,000)
ONEHOT_ROWS = (8, 100, 2048, 3000, 4096, 20_000)
# W: P10 reads rows 0-63 of any W >= 64; P16 takes multiples of 32
# (powers of two and not; 8 lanes a block at 64 and 96 rows, 4 at 2,048,
# 2 at 4,096, where it stages word by word)
WINDOW_ROWS_OF = {"concat": (64, 100, 2048), "refill": (64, 96, 2048, 4096)}
# one lane, part-filled last blocks of 8 and 32 lanes (staged word by
# word), and 136 lanes: whole blocks of 4 and 8 staged in 16-byte chunks
EDGE_LANES = (1, 70, 130, 136)


def edge_cases(kernel):
    """(table kind, x, iterations) of every edge case of ``kernel``: each
    table kind, row count and lane count, at 0 and 64 iterations."""
    rows = (ONEHOT_ROWS if kernel == "onehot" else
            WINDOW_ROWS_OF[kernel])
    for i, (kind, lo_hi) in enumerate(EDGE_TABLES.items()):
        for j, R in enumerate(rows):
            for lanes in EDGE_LANES:
                x = ints((R, lanes), 100 * i + 10 * j + lanes, lo_hi)
                for iters in (0, 64):
                    yield kind, x, iters


def launches_of(kernel):
    """(launch, plain, mode kwargs) of ``kernel``'s rows."""
    if kernel == "onehot":
        return [(pm3.launch_onehot_chain, pm3.onehot_chain_reference,
                 {"reduce": r, "unroll": u})
                for r in pm3.REDUCES for u in pm3.UNROLLS]
    return [(pm3.launch_window_chain, pm3.window_chain_reference,
             {"mode": kernel})]


def check_edges(lib, kernel, device):
    for _, x, iters in edge_cases(kernel):
        x = x.to(device)
        for launch, plain, mode in launches_of(kernel):
            kw = {**mode, "iters": iters}
            want = plain(x, full=True, **kw)
            got = launch(lib, x, full=True, **kw)
            out = launch(lib, x, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
            assert_same(got, want)
            assert torch.equal(out, want[0])


@pytest.mark.parametrize("kernel", ("onehot", "concat", "refill"))
def test_host_build_block_edges(kernel, host_lib):
    """The per-rank code (the staging, P16's and P10's ranks and their
    max) at 1, 70, 130 and 136 lanes (part-filled last blocks; whole
    blocks staged in 16-byte chunks), full=True and
    full=False, 0 and 64 iterations, row counts that are and are not
    powers of two, blocks of 32 lanes down to 1, on tables whose walks
    straddle the table's end, drift apart and wrap (the names of
    EDGE_TABLES hold: test_the_edge_tables_walk_as_named)."""
    check_edges(host_lib, kernel, torch.device("cpu"))


def refill_walk(x, iters: int):
    """P16's walk over ``x`` by the plain version's arithmetic: each step's
    row0 ([iters, L]) and whether any base + v + 129 left int32."""
    W, L = x.shape
    base = torch.zeros(L, dtype=torch.int64)
    rows, wrapped = [], False
    for _ in range(iters):
        row0 = base // pm3.BASE_ROW
        rows.append(row0)
        s = base + pm3._chunks(x, row0).max(dim=0).values.long() + \
            pm3.BASE_STEP
        wrapped |= bool(((s >= 2**31) | (s < -2**31)).any())
        base = torch.remainder(pm3._wrap(s), 16 * W)
    return torch.stack(rows), wrapped


def test_the_edge_tables_walk_as_named():
    """"climb": P16's walk reaches a step with one chunk in the table and
    one past it (row0 = W / 32 - 1), and lanes of one block in different
    chunks at one step; "edge": base + v + 129 wraps, P10's x + i wraps
    before the max, and the one-hot's idx + v + 1 wraps (by sum)."""
    for kind, x, iters in edge_cases("refill"):
        if iters == 0 or x.shape[1] == 1:
            continue
        rows, wrapped = refill_walk(x, iters)
        if kind == "climb":
            # lanes 0-3: one block at every W here
            assert any(len(set(r[:4].tolist())) > 1 for r in rows)
            if x.shape[0] <= 2048:  # 64 steps reach the end
                assert bool((rows == x.shape[0] // pm3.CHUNK - 1).any())
        assert wrapped == (kind == "edge")
    for kind, x, _ in edge_cases("concat"):
        if kind == "edge":  # x + i wraps within 64 steps
            assert int(x[:pm3.WINDOW_ROWS].max()) + 63 >= 2**31
    wraps = []
    for kind, x, iters in edge_cases("onehot"):
        if kind == "edge" and iters:  # idx + v + 1 wraps
            lanes, idx = torch.arange(x.shape[1]), torch.zeros(
                x.shape[1], dtype=torch.int64)
            for _ in range(iters):
                s = idx + x[idx, lanes].long() + 1
                wraps.append(bool((s >= 2**31).any()))
                idx = torch.remainder(pm3._wrap(s), x.shape[0])
    assert any(wraps)


def test_a_call_is_one_launch(host_lib):
    """A call makes no copy of its input and no zeroed state before the
    kernel: outputs are ``torch.empty`` and the table goes in as it is,
    so on the card the kernel's launch is the call's only one."""
    x = ints((2048, 130), 47, (-3, 50))
    calls = [(launch, mode) for kernel in ("onehot", "concat", "refill")
             for launch, _, mode in launches_of(kernel)]
    calls += [(pm3.launch_vote_chain, {"mode": m}) for m in pm3.VOTE_MODES]
    calls += [(pm3.launch_byte_chain, {"mode": m}) for m in pm3.BYTE_MODES]
    for launch, mode in calls:
        arg = x[0] if launch in (pm3.launch_vote_chain,
                                 pm3.launch_byte_chain) else x
        for full in (False, True):
            with DispatchedOps() as ops:
                launch(host_lib, arg, iters=64, full=full, **mode)
            assert ops.only_outputs(), (mode, ops.seen)


# -- the wrappers and the tool -------------------------------------------


def test_wrappers_on_the_cpu_take_the_plain_version():
    before = [w.launches for w in pm3.WRAPPERS]
    x, n0 = ints((64, 8), 50), ints(8, 51, (-20, 11))
    kept = (x.clone(), n0.clone())
    for mode in pm3.VOTE_MODES:
        assert torch.equal(pm3.vote_chain(n0, mode=mode, iters=30),
                           pm3.vote_chain_reference(n0, mode=mode, iters=30))
    for mode in pm3.BYTE_MODES:
        assert torch.equal(pm3.byte_chain(x[0], mode=mode, iters=9),
                           pm3.byte_chain_reference(x[0], mode=mode,
                                                    iters=9))
    for reduce in pm3.REDUCES:
        assert torch.equal(
            pm3.onehot_chain(x, reduce=reduce, unroll=8, iters=16),
            pm3.onehot_chain_reference(x, reduce=reduce, iters=16))
    for mode in pm3.WINDOW_MODES:
        assert torch.equal(pm3.window_chain(x, mode=mode, iters=9),
                           pm3.window_chain_reference(x, mode=mode, iters=9))
    assert [w.launches for w in pm3.WRAPPERS] == before
    assert torch.equal(x, kept[0]) and torch.equal(n0, kept[1])


BAD = {
    "dtype": lambda x, n: pm3.onehot_chain(x.long(), reduce="max", iters=1),
    "dims": lambda x, n: pm3.vote_chain(x, mode="any", iters=1),
    "device": lambda x, n: pm3.byte_chain(
        torch.zeros(4, dtype=torch.int32, device="meta"), mode="shift",
        iters=1),
    "mode": lambda x, n: pm3.vote_chain(n, mode="all", iters=1),
    "reduce": lambda x, n: pm3.onehot_chain(x, reduce="min", iters=1),
    "unroll": lambda x, n: pm3.onehot_chain(x, reduce="max", unroll=4,
                                            iters=8),
    "iters": lambda x, n: pm3.window_chain(x, mode="concat", iters=-1),
    "iters % unroll": lambda x, n: pm3.onehot_chain(x, reduce="max",
                                                    unroll=8, iters=12),
    "lanes": lambda x, n: pm3.vote_chain(
        torch.zeros(1025, dtype=torch.int32), mode="max", iters=1),
    "max rows": lambda x, n: pm3.onehot_chain(x[:1], reduce="max", iters=1),
    "concat rows": lambda x, n: pm3.window_chain(x[:63], mode="concat",
                                                 iters=1),
    "refill rows": lambda x, n: pm3.window_chain(x[:40], mode="refill",
                                                 iters=1),
    "onehot rows limit": lambda x, n: pm3.onehot_chain(
        torch.zeros((pm3.MAX_ONEHOT_ROWS + 1, 1), dtype=torch.int32),
        reduce="sum", iters=1),
    "refill rows limit": lambda x, n: pm3.window_chain(
        torch.zeros((pm3.MAX_REFILL_ROWS + pm3.CHUNK, 1), dtype=torch.int32),
        mode="refill", iters=1),
}


@pytest.mark.parametrize("bad", BAD)
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    x, n = ints((64, 4), 60), ints(4, 61)
    with pytest.raises(ValueError):
        BAD[bad](x, n)


def test_tool_entry_points_run_on_the_card_unless_asked():
    """The tool's functions default to the card, and the command line stops
    without one; ``--device cpu`` runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for _, make in probe_mosaic3.ROWS_OF_TOOL:
        with pytest.raises((RuntimeError, AssertionError)):
            make(None)
    with pytest.raises(SystemExit):
        probe_rows.main(probe_mosaic3.ROWS_OF_TOOL, ["P16"])
    rows = probe_rows.main(probe_mosaic3.ROWS_OF_TOOL,
                           ["P9", "--device", "cpu", "--seed", "1"])
    name = "P9 cond: carried scalar flag"
    assert [(r["name"], r["input"]) for r in rows] == [
        (name, "tool"), (name, "seeded")]


def test_the_counts_behind_the_bound():
    """The iterations a vote runs and the table words a walk reads, against
    a walk written out here; the seeded vote start runs every iteration."""
    fn, args, _ = probe_mosaic3.p7(device="cpu")
    assert fn.ran_for(*args, iters=64) == 10
    assert fn.ran_for(*args, iters=8) == 8
    deep, = fn.seeded_inputs(args, 2)
    assert int(deep.min()) == probe_mosaic3.DEEP
    assert fn.ran_for(deep, iters=probe_rows.LONG_ITERS) == \
        probe_rows.LONG_ITERS
    fn9, _, _ = probe_mosaic3.p9(device="cpu")
    assert fn9.ran_for(torch.full((L,), 5, dtype=torch.int32), iters=64) == 1
    # a vote's work is the function's, the same for every mode and lane
    # count: the test, the vote, i < iters, i & 1, the add, i + 1
    for make in (probe_mosaic3.p7, probe_mosaic3.p8, probe_mosaic3.p9):
        assert make(device="cpu")[0].ops == pm3.VOTE_OPS == 6
    ones = torch.ones((probe_mosaic3.W, L), dtype=torch.int32)
    # all-ones: idx 0, 2, 4, ...: 64 rows a lane
    assert pm3.onehot_rows_read(ones, reduce="max", iters=64) == 64 * L
    assert pm3.onehot_rows_read(ones[:8], reduce="max", iters=64) == 4 * L
    # all-ones: base 0, 130, 260, ...: row0 = base // 128
    chunks = {c for k in range(64) for c in (k * 130 // 128,
                                             k * 130 // 128 + 1) if c < 64}
    assert pm3.refill_rows_read(ones, 64) == 32 * len(chunks) * L


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [w.__name__ for w in pm3.WRAPPERS])
def test_kernel_equals_plain_version_on_card(kernel, cuda_device):
    """Every row of the kernel on the tool's input and a seeded one; the
    votes also from a diverging start, at 100 lanes (a part-filled warp)
    and at 0 iterations."""
    wrapper = getattr(pm3, kernel)
    before, runs = wrapper.launches, 0
    for i, (name, make) in enumerate(probe_mosaic3.ROWS_OF_TOOL):
        fn, args, _ = make(cuda_device)
        if fn.wrapper is not wrapper:
            continue
        cases = [(args, {}), (fn.seeded_inputs(args, 70 + i), {})]
        if wrapper is pm3.vote_chain:
            d = torch.from_numpy(start("diverge", 80 + i)).cuda()
            cases += [((d,), {}), ((d[:100],), {}), ((d,), {"iters": 0})]
        for xs, kw in cases:
            got = fn(*xs, full=True, **kw)
            torch.cuda.synchronize()
            assert_same(got, fn.plain(*xs, full=True, **kw))
            runs += 1
    assert runs and wrapper.launches == before + runs


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("onehot", "concat", "refill"))
def test_kernel_block_edges_on_card(kernel, cuda_device):
    """The host build's edge cases on the card (test_host_build_block_edges):
    1, 70, 130 and 136 lanes, full=True and full=False, 0 and 64 iterations,
    row counts that are and are not powers of two, blocks of 32 lanes
    down to 1, walks that straddle the table's end, drift apart and
    wrap."""
    check_edges(pm3._cuda_lib(), kernel, cuda_device)


@pytest.mark.cuda
def test_a_call_is_one_launch_on_card(cuda_device):
    """On the card a wrapper call dispatches no PyTorch op but its outputs'
    ``torch.empty`` (and views), and counts one launch."""
    x = ints((2048, 130), 47, (-3, 50)).to(cuda_device)
    calls = [(pm3.onehot_chain, {"reduce": r, "unroll": u})
             for r in pm3.REDUCES for u in pm3.UNROLLS]
    calls += [(pm3.window_chain, {"mode": m}) for m in pm3.WINDOW_MODES]
    calls += [(pm3.vote_chain, {"mode": m}) for m in pm3.VOTE_MODES]
    calls += [(pm3.byte_chain, {"mode": m}) for m in pm3.BYTE_MODES]
    for wrapper, kw in calls:
        arg = x[0] if wrapper in (pm3.vote_chain, pm3.byte_chain) else x
        for full in (False, True):
            before = wrapper.launches
            with DispatchedOps() as ops:
                wrapper(arg, iters=64, full=full, **kw)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            assert ops.only_outputs(), (kw, ops.seen)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", (1, 127, 128, 129, 130))
def test_byte_kernel_edges_on_card(lanes, cuda_device):
    """The host build's byte_chain cases on the card: each mode, its edge
    and seeded starts, 0 to 500 iterations (the passes' remainders)."""
    before, runs = pm3.byte_chain.launches, 0
    for v0 in byte_starts(lanes):
        v0 = v0.to(cuda_device)
        for mode in pm3.BYTE_MODES:
            for iters in BYTE_ITERS:
                kw = {"mode": mode, "iters": iters, "full": True}
                got = pm3.byte_chain(v0, **kw)
                torch.cuda.synchronize()
                assert_same(got, pm3.byte_chain_reference(v0, **kw))
                runs += 1
    assert pm3.byte_chain.launches == before + runs


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", VOTE_LANES)
def test_vote_kernel_lanes_on_card(lanes, cuda_device):
    """The host build's vote cases on the card: each lane count (its slots
    a thread), every mode and start, 0 to 300 iterations."""
    before, runs = pm3.vote_chain.launches, 0
    for i, kind in enumerate(VOTE_STARTS):
        n0 = (torch.zeros(lanes, dtype=torch.int32) if kind == "zeros"
              else torch.from_numpy(np.resize(start(kind, 10 + i), lanes)))
        if kind == "deep":
            n0[-1] = probe_mosaic3.DEEP
        n0 = n0.to(cuda_device)
        for mode in pm3.VOTE_MODES:
            for iters in (0, 7, 64, 300):
                kw = {"mode": mode, "iters": iters, "full": True}
                got = pm3.vote_chain(n0, **kw)
                torch.cuda.synchronize()
                assert_same(got, pm3.vote_chain_reference(n0, **kw))
                runs += 1
    assert pm3.vote_chain.launches == before + runs


@pytest.mark.cuda
def test_kernel_attributes_on_card(cuda_device):
    """Lanes a block from the table's rows (32 for R = 8 and 100, down to 1
    at 20,000; P16 8 down to 2 at W = 4,096; P10 8), 256 threads, the
    block's shared memory, and no spills."""
    for reduce in pm3.REDUCES:
        for unroll in pm3.UNROLLS:
            attrs = [pm3.onehot_attributes(R, reduce=reduce, unroll=unroll)
                     for R in ONEHOT_ROWS]
            assert [a["lanes"] for a in attrs] == [32, 32, 8, 4, 4, 1]
            for R, a in zip(ONEHOT_ROWS, attrs):
                assert (a["shared_bytes"], a["threads"], a["local_bytes"]) \
                    == (4 * R * a["lanes"], 256, 0)
    for W, lb in ((64, 8), (96, 8), (2048, 4), (4096, 2)):
        a = pm3.window_attributes(W, mode="refill")
        # the columns and, for lb a multiple of 4, the slice as it lands
        words = (W + pm3.CHUNK) * lb + (W * lb if lb % 4 == 0 else 0)
        assert (a["lanes"], a["shared_bytes"], a["local_bytes"]) == (
            lb, 4 * words, 0)
    a = pm3.window_attributes(2048, mode="concat")
    assert (a["lanes"], a["shared_bytes"], a["local_bytes"]) == (8, 0, 0)
    for mode in pm3.VOTE_MODES:  # one warp holds every lane
        for lanes in VOTE_LANES:
            a = pm3.vote_attributes(lanes, mode=mode)
            assert (a["lanes"], a["threads"], a["shared_bytes"],
                    a["static_shared"], a["local_bytes"]) == (
                        lanes, 32, 0, 0, 0)
    assert pm3.onehot_attributes(pm3.MAX_ONEHOT_ROWS, reduce="sum")[
        "shared_bytes"] == 232448
    for mode in pm3.BYTE_MODES:  # a thread a lane, 128 a block
        a = pm3.byte_attributes(mode=mode)
        assert (a["lanes"], a["threads"], a["shared_bytes"],
                a["local_bytes"]) == (128, 128, 0, 0)
