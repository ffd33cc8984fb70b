"""The mosaic4 probe kernel of the port against the JAX package's probes.

- Each of the seven Pallas functions of ``tools/probe_mosaic4.py``
  (``build``'s four variants, ``build2``'s three; imported by path), run in
  interpret mode with its outer ``while_loop`` opened
  (``test_torch_probes.OpenLoop``: the rounds' inner loop runs as it is),
  against its counterpart in ``lzma_rs_tpu_torch/tools/probe_mosaic4.py``
  on the CPU (the plain version of ``ops/probes_mosaic4.py``): exact
  equality of the output ``idx``, the final table and tile, and the carry
  (``idx``, ``acc``, ``it``), on the tool's input and from seeded starts:
  "wide" (idx outside [0, 512) on most lanes, acc negative on some, ``k``
  over the full int32 range, six rounds), "near" (idx and acc within 1,024
  of +-2^31: ``idx + v`` and ``acc + 1`` wrap; one round) and "done"
  (``it`` already at the limit: no round, ``idx`` out as it came in).
- A g++ build of ``csrc/probe_mosaic4.cuh`` (``-DLZP_HOST_ENTRY``, the C
  interface of ``csrc/probes_mosaic4.cu`` as a host loop) against the
  plain version, for every variant.
- The wrapper's checks, the tool's command line, the counts behind the
  bound, and (marked ``cuda``) the kernel against its plain version on
  the card.

JAX is imported only by the tests that run the Pallas probes, so the
``cuda`` test runs on a machine without it.
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
from lzma_rs_tpu_torch.ops import probes_mosaic4 as pm4
from lzma_rs_tpu_torch.tools import probe_mosaic4, probe_rows

from test_torch_probes import (TOOLS, assert_same, jax_tool,  # noqa: F401
                               pallas)
from test_torch_probes_mosaic import INT32, NEAR_LIMIT

REPO = os.path.dirname(TOOLS)
HEADER = os.path.join(REPO, "lzma_rs_tpu_torch", "csrc",
                      "probe_mosaic4.cuh")
L = probe_mosaic4.L
LIMIT = probe_mosaic4.ITERS
KINDS = ("tool", "wide", "near", "done")
IT0 = {"tool": 0, "wide": -21, "near": 50, "done": LIMIT}


def start(kind: str, seed: int) -> tuple:
    """Seeded inputs (numpy): ``k`` ([8, L]; its first 4 rows are build's
    ``x``, which the probe reads only as ``x * 0``), ``start`` ([2, L]: idx,
    acc) and ``it0`` ([1])."""
    rng = np.random.default_rng(seed)
    if kind == "tool":
        st = np.zeros((2, L), dtype=np.int32)
    elif kind == "near":
        st = rng.integers(*NEAR_LIMIT, size=(2, L), dtype=np.int64).astype(
            np.int32)
        st[1, ::3] = rng.integers(-20, 20, size=len(st[1, ::3]))
    else:
        st = probe_mosaic4.seeded_start(rng, (2, L))
    lo_hi = INT32 if kind == "wide" else NEAR_LIMIT
    k = rng.integers(*lo_hi, size=(pm4.SCHED, L), dtype=np.int64).astype(
        np.int32)
    return k, st, np.array([IT0[kind]], dtype=np.int32)


CASES = [(v, k) for v in pm4.VARIANTS for k in KINDS]


def tool_x(variant: str, kind: str, k: np.ndarray) -> np.ndarray:
    """The row's ``x``: the tool's zeros, else ``k`` (build: its first 4
    rows)."""
    x = k[:4] if variant in pm4.BUILD_VARIANTS else k
    return np.zeros_like(x) if kind == "tool" else x


def pallas_fn(variant: str):
    tool = jax_tool("probe_mosaic4")
    if variant in pm4.BUILD_VARIANTS:
        return tool.build(variant)
    return tool.build2(variant)


def check_equal(got, want, what: str):
    got = got.numpy()
    assert got.dtype == want.dtype, what
    assert got.size == want.size, what
    assert np.array_equal(got, want.reshape(got.shape)), what


@pytest.mark.parametrize("variant,kind", CASES)
def test_port_equals_the_pallas_probe(variant, kind, pallas):  # noqa: F811
    import jax
    import jax.numpy as jnp

    build_v = variant in pm4.BUILD_VARIANTS
    pfn, pargs, lanes = dict(probe_mosaic4.ROWS_OF_TOOL)[variant]("cpu")
    # the probe's loop runs while it < 64
    assert lanes == L == jax_tool("probe_mosaic4").L and pfn.iters == 64
    k, st, it0 = start(kind, CASES.index((variant, kind)))
    x = tool_x(variant, kind, k)
    if kind == "tool":
        for t, want in zip(pargs, (x, st, it0)):
            check_equal(t, want, "the tool's input")
    else:  # the loop's start carry: idx, acc, it
        pallas.carry = {0: st[0], 1: st[1], 2: it0.reshape(())}
    want = pallas_fn(variant)(jnp.asarray(x))
    jax.block_until_ready(want)
    jax.effects_barrier()
    got, full = pfn(*(torch.from_numpy(a) for a in (x, st, it0)), full=True)
    check_equal(got, np.asarray(want), "out")
    final = pallas.final
    carry = final["carry"]
    check_equal(full["state"], np.stack(carry[:2]), "state")
    check_equal(full["it"], np.asarray(carry[2]), "it")
    if build_v:
        check_equal(full["table"], final["tab_ref"], "table")
        check_equal(full["tile"], final["tile_ref"], "tile")
    else:  # build2 writes no table: it stays the fill
        assert "tab_ref" not in final and "tile" not in full
        assert full["table"].eq(pm4.FILL).all()
    ran = pfn.ran_for(*(torch.from_numpy(a) for a in (x, st, it0)),
                      iters=LIMIT)
    assert int(carry[2]) - int(it0[0]) == ran
    if kind == "done":
        assert ran == 0 and np.array_equal(np.asarray(want)[0], st[0])


def test_the_rows_are_the_tpu_tools_rows():
    """``VARIANTS`` and then ``main2``'s list, letter for letter; each of
    the latter is a branch of ``build2``."""
    tool = jax_tool("probe_mosaic4")
    with open(os.path.join(TOOLS, "probe_mosaic4.py")) as f:
        src = f.read()
    main2 = src[src.index("def main2"):]
    names2 = re.findall(r'"(sched8_\w+)"', main2[:main2.index("]")])
    assert [n for n, _ in probe_mosaic4.ROWS_OF_TOOL] == \
        tool.VARIANTS + names2
    assert all(f'variant == "{n}"' in src for n in names2)
    assert len(probe_mosaic4.ROWS_OF_TOOL) == len(pm4.VARIANTS) == 7


def run(variant, kind, seed=3, **kw):
    k, st, it0 = start(kind, seed)
    x = tool_x(variant, kind, k)
    return pm4.table_chain(*(torch.from_numpy(a) for a in (x, st, it0)),
                           variant=variant, iters=LIMIT, **kw)


def test_the_seeded_inputs_show_what_the_tools_input_hides():
    """On the tool's zeros every lane runs the same walk (one output) and
    ``k`` is zeros, so ``sched8_max`` equals ``sched8_sum``; from the
    seeded start lanes end apart, ``k``'s negative entries make the two
    differ, and idx starts outside the table on some lanes (an empty
    read, a refill of zeros)."""
    for kind, same in (("tool", True), ("wide", False)):
        assert (len(set(run("base", kind)[0].tolist())) == 1) == same
        assert torch.equal(run("sched8_max", kind),
                           run("sched8_sum", kind)) == same
    _, st, _ = start("wide", 3)
    assert ((st[0] < 0) | (st[0] >= pm4.W)).any() and (st[1] < 0).any()


# -- the g++ build of the header -----------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzm4") / "liblzm4_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZP_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    return build.bind_mosaic4(ctypes.CDLL(so))


@pytest.mark.parametrize("variant", pm4.VARIANTS)
def test_host_build_table_chain(variant, host_lib):
    """Every start kind, limits that end mid-round and at 0, 130 lanes (a
    part-filled block)."""
    for i, kind in enumerate(KINDS):
        k, st, it0 = start(kind, 10 + i)
        k, st = np.resize(k, (pm4.SCHED, 130)), np.resize(st, (2, 130))
        x = torch.from_numpy(tool_x(variant, kind, k))
        for limit in (0, 64, 100):
            args = (x, torch.from_numpy(st), torch.from_numpy(it0))
            kw = {"variant": variant, "iters": limit, "full": True}
            assert_same(pm4.launch_table_chain(host_lib, *args, **kw),
                        pm4.table_chain_reference(*args, **kw))


def test_host_build_refuses_bad_arguments(host_lib):
    """A mode out of range, no lane, a negative limit; build2 without k or
    with a tile; build with a table and no tile, or the reverse."""
    x = torch.zeros((4, 8), dtype=torch.int32)
    st, it0 = torch.zeros((2, 8), dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bad argument"):
        pm4.launch_table_chain(host_lib, x, st, it0, variant="base",
                               iters=-1)
    buf = torch.zeros(pm4.W * 8, dtype=torch.int32)
    end, it = torch.zeros((2, 8), dtype=torch.int32), torch.zeros(
        1, dtype=torch.int32)
    b, n = buf.data_ptr(), None
    for mode, k, L, tab, tile, limit in (
            (6, n, 8, b, b, 64), (-1, n, 8, b, b, 64), (0, n, 0, b, b, 64),
            (0, n, 8, b, b, -1), (0, n, 8, b, n, 64), (1, n, 8, n, b, 64),
            (3, n, 8, b, n, 64), (4, b, 8, b, b, 64)):
        assert host_lib.lzm4_table_chain(
            mode, k, L, st.data_ptr(), tab, tile, end.data_ptr(),
            it0.data_ptr(), it.data_ptr(), limit, None) == -1, mode
    # no table and no tile is the timed call: accepted
    assert host_lib.lzm4_table_chain(
        1, n, 8, st.data_ptr(), n, n, end.data_ptr(), it0.data_ptr(),
        it.data_ptr(), 64, None) == 0


def edge_start(kind: str, lanes: int, seed: int) -> tuple:
    """(k [8, lanes], start [2, lanes], it0 [1]) as numpy: "all" (the
    tool's zeros: every lane resets at the same steps), "apart" (the
    seeded start: lanes reset at different steps), "one" (acc 0 on every
    lane but one, at 8: that lane resets alone at its 9th step, and every
    17 steps after), "near" (idx and acc within 1,024 of +-2^31: idx + v
    and acc + 1 wrap, idx before the and)."""
    rng = np.random.default_rng(seed)
    base = {"all": "tool", "apart": "wide", "one": "tool", "near": "near"}
    k, st, it0 = start(base[kind], seed)
    k = np.resize(k, (pm4.SCHED, lanes))
    st = np.resize(st, (2, lanes)).copy()
    if kind == "one":
        st[1, rng.integers(0, lanes)] = 8
    if kind == "apart":
        it0 = np.array([5], dtype=np.int32)
    return k, st, it0


@pytest.mark.parametrize("variant", pm4.VARIANTS)
def test_host_build_block_edges(variant, host_lib):
    """The per-rank code (the fill, the warp's resets from the ballot's
    mask, the write-back) at 130 lanes (a part-filled last block) and at 1
    lane, with both row strides; full=True and full=False; limits that end
    mid-round (100: 7 rounds from 0) and at 0; every lane resetting at the
    same step, lanes resetting apart, one lane resetting alone, and walks
    that wrap idx."""
    for lanes in (130, 1):
        for i, kind in enumerate(("all", "apart", "one", "near")):
            k, st, it0 = edge_start(kind, lanes, 60 + i)
            args = tuple(torch.from_numpy(a) for a in (
                tool_x(variant, "wide", k), st, it0))
            kept = [a.clone() for a in args]
            for limit in (0, 100):
                kw = {"variant": variant, "iters": limit}
                want = pm4.table_chain_reference(*args, full=True, **kw)
                assert_same(pm4.launch_table_chain(
                    host_lib, *args, full=True, **kw), want)
                assert torch.equal(pm4.launch_table_chain(
                    host_lib, *args, **kw), want[0])
            assert all(torch.equal(a, b) for a, b in zip(args, kept))


def test_the_edge_starts_reset_as_named():
    """"all": every lane flags at the same steps; "one": some step flags
    exactly one lane; "apart": steps flag different lanes."""
    def flags(kind):
        _, st, it0 = edge_start(kind, 130, 61)
        acc = st[1].astype(np.int64)
        steps = pm4.steps_run(int(it0[0]), 100)
        return [set(np.flatnonzero((acc + j) % pm4.RESET_EVERY == 0))
                for j in range(1, steps + 1)]

    assert all(f in (set(), set(range(130))) for f in flags("all"))
    assert any(len(f) == 1 for f in flags("one"))
    apart = [f for f in flags("apart") if f]
    assert len(apart) > 17 and len({frozenset(f) for f in apart}) > 1


def test_a_call_is_one_launch(host_lib):
    """The timed call (full=False) makes no copy of its inputs before the
    kernel: outputs are ``torch.empty`` and the inputs go in as they are,
    so on the card the kernel's launch is the call's only one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    for variant in pm4.VARIANTS:
        args = inputs(variant)
        with Ops() as ops:
            pm4.launch_table_chain(host_lib, *args, variant=variant,
                                   iters=40)
        assert ops.seen and all(
            op.startswith("empty") or op in ("slice", "view")
            for op in ops.seen), (variant, ops.seen)


# -- the wrapper and the tool --------------------------------------------


def inputs(variant, seed=50):
    k, st, it0 = start("wide", seed)
    return tuple(torch.from_numpy(a) for a in (tool_x(variant, "wide", k),
                                                st, it0))


def test_wrappers_on_the_cpu_take_the_plain_version():
    before = pm4.table_chain.launches
    for variant in pm4.VARIANTS:
        args = inputs(variant)
        kept = [a.clone() for a in args]
        assert torch.equal(
            pm4.table_chain(*args, variant=variant, iters=40),
            pm4.table_chain_reference(*args, variant=variant, iters=40))
        assert all(torch.equal(a, b) for a, b in zip(args, kept))
    assert pm4.table_chain.launches == before


BAD = {
    "dtype": lambda x, s, i: (x.long(), s, i),
    "x rows": lambda x, s, i: (x[:3], s, i),
    "start": lambda x, s, i: (x, s[:1], i),
    "start lanes": lambda x, s, i: (x, s[:, :5], i),
    "it0": lambda x, s, i: (x, s, torch.zeros(2, dtype=torch.int32)),
    "device": lambda x, s, i: (x, s, torch.zeros(1, dtype=torch.int32,
                                                 device="meta")),
}


@pytest.mark.parametrize("bad", list(BAD) + ["variant", "iters"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    args = inputs("base")
    kw = {"variant": "base", "iters": 5}
    if bad in BAD:
        args = BAD[bad](*args)
    elif bad == "variant":
        kw["variant"] = "when_never"
    else:
        kw["iters"] = -1
    with pytest.raises(ValueError):
        pm4.table_chain(*args, **kw)


def test_tool_entry_points_run_on_the_card_unless_asked():
    """The tool's functions default to the card, and the command line stops
    without one; ``--device cpu`` runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for _, make in probe_mosaic4.ROWS_OF_TOOL:
        with pytest.raises((RuntimeError, AssertionError)):
            make(None)
    with pytest.raises(SystemExit):
        probe_rows.main(probe_mosaic4.ROWS_OF_TOOL, ["base"])
    rows = probe_rows.main(probe_mosaic4.ROWS_OF_TOOL,
                           ["sched8_blend", "--device", "cpu", "--seed", "1"])
    assert [(r["name"], r["input"]) for r in rows] == [
        ("sched8_blend", "tool"), ("sched8_blend", "seeded")]


def test_the_counts_behind_the_bound():
    """Steps run in whole rounds of 16 from ``it0``: the loop's own count
    (the carried ``it``) equals ``ran_for`` on the tool's and the seeded
    input, at the tool's limit and the long one; the slope's two counts
    are whole rounds; a reset step counts more operations than a plain
    one, the blend's 8 rows more than the sum."""
    assert [pm4.steps_run(i, 64) for i in (0, -21, 50, 63, 64, 90)] == [
        64, 96, 16, 16, 0, 0]
    fn, args, _ = probe_mosaic4.build("base", device="cpu")
    assert fn.iters % pm4.ROUND == 0 and fn.long_iters % pm4.ROUND == 0
    assert fn.long_iters == probe_rows.LONG_ITERS
    for xs in (args, fn.seeded_inputs(args, 2)):
        _, res = fn(*xs, full=True)
        assert int(res["it"][0]) - int(xs[2][0]) == fn.ran_for(
            *xs, iters=fn.iters)
    assert fn.ran_for(*args, iters=fn.long_iters) == fn.long_iters
    ops = {v: pm4.step_ops(v) for v in pm4.VARIANTS}
    assert ops["when_reset"] == ops["when_reset_hoisted"] > ops["base"]
    assert ops["when_reset_refed"] > ops["when_reset"]
    assert ops["sched8_blend"] > ops["sched8_max"] > ops["sched8_sum"]


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", pm4.VARIANTS)
def test_kernel_block_edges_on_card(variant, cuda_device):
    """The host build's edge cases on the card: 130 lanes (a part-filled
    block) and 1 lane, both row strides, full=True and full=False, limits
    100 and 0, every lane resetting at the same step, lanes apart, one
    lane alone, and walks that wrap idx."""
    lib = pm4._cuda_lib()
    for lanes in (130, 1):
        for i, kind in enumerate(("all", "apart", "one", "near")):
            k, st, it0 = edge_start(kind, lanes, 60 + i)
            args = tuple(torch.from_numpy(a).to(cuda_device) for a in (
                tool_x(variant, "wide", k), st, it0))
            for limit in (0, 100):
                kw = {"variant": variant, "iters": limit}
                want = pm4.table_chain_reference(*args, full=True, **kw)
                got = pm4.launch_table_chain(lib, *args, full=True, **kw)
                out = pm4.launch_table_chain(lib, *args, **kw)
                torch.cuda.synchronize()
                assert_same(got, want)
                assert torch.equal(out, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [w.__name__ for w in pm4.WRAPPERS])
def test_kernel_equals_plain_version_on_card(kernel, cuda_device):
    """Every row on the tool's input, a seeded one, and the test's
    starts ("near", "done"), at 130 lanes too (a part-filled block)."""
    wrapper = getattr(pm4, kernel)
    before, runs = wrapper.launches, 0
    for i, (name, make) in enumerate(probe_mosaic4.ROWS_OF_TOOL):
        fn, args, _ = make(cuda_device)
        cases = [args, fn.seeded_inputs(args, 70 + i)]
        for kind in ("near", "done"):
            k, st, it0 = start(kind, 80 + i)
            cases.append(tuple(torch.from_numpy(a).to(cuda_device) for a in (
                tool_x(name, kind, k), st, it0)))
        x, st, it0 = cases[1]
        cases.append((x.repeat(1, 2)[:, :130], st.repeat(1, 2)[:, :130],
                      it0))
        for xs in cases:
            got = fn(*xs, full=True)
            torch.cuda.synchronize()
            assert_same(got, fn.plain(*xs, full=True))
            runs += 1
    assert runs and wrapper.launches == before + runs
