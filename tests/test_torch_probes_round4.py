"""The round4 probe kernels of the port against the JAX package's probes.

- Each of the twenty rows of ``tools/probe_round4.py``'s ``CASES``
  (imported by path; ``ITERS`` and ``S`` monkeypatched small, ``ROWS``
  kept, since it sets the clip), run in interpret mode with its
  ``while_loop`` opened (``test_torch_probes.OpenLoop``), against its
  counterpart in ``lzma_rs_tpu_torch/tools/probe_round4.py`` on the CPU
  (the plain versions of ``ops/probes_round4.py``) at the same shapes:
  exact equality of the output, the final table and all four state slots,
  on the tool's input and on a seeded one ("wide": the table over its
  type's full range, every state slot over the full int32 range, written
  into the probe's state scratch before its loop: ``v * 40499`` wraps,
  sums wrap, ``>> 8`` sees negatives, ``blend_par3``'s clipped writes
  collide).
- A g++ build of ``csrc/probe_round4.cuh`` (``-DLZP_HOST_ENTRY``, the C
  interface of ``csrc/probes_round4.cu`` as host loops) against the plain
  versions, for every mode, read count and table type.
- The wrappers' checks, the tool's command line, the counts behind the
  bound, and (marked ``cuda``) each kernel against its plain version on
  the card.

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
from lzma_rs_tpu_torch.ops import probes_round4 as pr4
from lzma_rs_tpu_torch.tools import (probe_mosaic3, probe_rows, probe_round4,
                                     sass_chain)

from test_torch_probes import (TOOLS, assert_same, jax_tool,  # noqa: F401
                               pallas)
from test_torch_probes_mosaic import INT32

REPO = os.path.dirname(TOOLS)
HEADER = os.path.join(REPO, "lzma_rs_tpu_torch", "csrc",
                      "probe_round4.cuh")
SMALL = {"ITERS": 24, "S": 8}  # sel_s8 wants S >= 8
ROWS = list(probe_round4.CASES)
NARROW = ("i16_1", "i8_1")
SEL_S = {"sel_s2": 2, "sel_s8": 8, "sel_s2f4": 2}
NP = {torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8}


def small(monkeypatch):
    """Both tools at the small shape."""
    for mod in (jax_tool("probe_round4"), probe_round4):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


def wide(shape, dtype, seed: int) -> np.ndarray:
    """``shape`` over ``dtype``'s full range."""
    info = np.iinfo(NP[dtype])
    return np.random.default_rng(seed).integers(
        int(info.min), int(info.max) + 1, size=shape,
        dtype=np.int64).astype(NP[dtype])


def check_equal(got, want, what: str):
    got = got.numpy()
    assert got.dtype == want.dtype, what
    assert got.size == want.size, what
    assert np.array_equal(got, want.reshape(got.shape)), what


@pytest.mark.parametrize("kind", ("tool", "wide"))
@pytest.mark.parametrize("row", ROWS)
def test_port_equals_the_pallas_probe(row, kind, pallas,  # noqa: F811
                                      monkeypatch):
    import jax
    import jax.numpy as jnp

    small(monkeypatch)
    tool = jax_tool("probe_round4")
    jfn, jargs, _ = tool.CASES[row]()
    pfn, (x, st), lanes = probe_round4.CASES[row]("cpu")
    s_dim = SEL_S.get(row, SMALL["S"])
    assert lanes == s_dim * 128 and pfn.iters == SMALL["ITERS"]
    check_equal(x, np.asarray(jargs[0]), "the tool's table")
    if row in NARROW:  # no seed: the state starts at zero
        assert not st.any()
    else:  # the tool's first call: seed 1
        assert st[0].eq(1).all() and not st[1:].any()
    seed = ROWS.index(row)
    if kind == "wide":
        x = torch.from_numpy(wide(tuple(x.shape), x.dtype, seed))
        st = torch.from_numpy(wide(tuple(st.shape), torch.int32, seed + 50))
        pallas.start = {"st_ref": st.numpy()}  # slots 1-3 too
        if row == "blend_par3":  # some lanes' writes both clip to row 783
            m = ((st[0].long() * pr4.MIX) & 1023).clamp(max=tool.ROWS - 1)
            assert (m >= tool.ROWS - 1 - pr4.WRITES[1]).any()
    seed_in = np.zeros((SMALL["S"], 128), dtype=np.int32)
    seed_in[:s_dim] = st[0].numpy()
    args = (jnp.asarray(x.numpy()),) if row in NARROW else (
        jnp.asarray(x.numpy()), jnp.asarray(seed_in))
    want = jfn(*args)
    jax.block_until_ready(want)
    jax.effects_barrier()
    got, full = pfn(x, st, full=True)
    check_equal(got, np.asarray(want), "out")
    final = pallas.final
    assert [int(c) for c in final["carry"]] == [SMALL["ITERS"]]
    check_equal(full["state"], final["st_ref"], "state")
    if pfn.wrapper is pr4.blend_chain:
        check_equal(full["table"], final["tab_ref"], "table")
    else:  # the read-only rows leave the table as it came in
        assert "table" not in full
        check_equal(x, final["tab_ref"], "table")


def test_the_rows_are_the_tpu_tools_rows():
    assert ROWS == list(jax_tool("probe_round4").CASES)
    assert [n for n, _ in probe_round4.ROWS_OF_TOOL] == ROWS
    assert len(ROWS) == 20


def test_the_seeded_inputs_show_what_the_tools_input_hides():
    """The tool's narrow tables (``arange % 97``) are nonnegative, so a
    zero-extending read of ``i8_1``'s table would pass on them: on a
    full-range one it does not (``i16_1`` keeps 16 bits of the sum, which
    a sign cannot reach). ``blendmask512`` and ``blendoldw512`` start at a
    fixed point on the tool's input (``mix(1)`` clips to row 511, so every
    step reads past the table: 0, and slot 0 stays 1); seeded, they move.
    The tool's state starts every lane of ``null`` alike; seeded, lanes
    differ."""
    fn, (x, st), _ = probe_round4.CASES["i8_1"]("cpu")
    kw = {"mode": "sel", "n": 1, "iters": 40}
    x2, st2 = x.reshape(-1, 2048), st.reshape(4, -1)
    for t, same in ((x2, True), (torch.from_numpy(
            wide(tuple(x2.shape), torch.int8, 1)), False)):
        zext = (t.int() & 0xFF).contiguous()
        assert torch.equal(pr4.select_chain(t, st2, **kw),
                           pr4.select_chain(zext, st2, **kw)) == same
    for row in ("blendmask512", "blendoldw512"):
        fn, args, _ = probe_round4.CASES[row]("cpu")
        assert fn(*args, iters=50).eq(1).all()
        assert not fn(*fn.seeded_inputs(args, 2), iters=50).eq(1).all()
    fn, args, _ = probe_round4.CASES["null"]("cpu")
    assert len(set(fn(*args, iters=5)[0].tolist())) == 1
    assert len(set(fn(*fn.seeded_inputs(args, 2), iters=5)[0].tolist())) > 1


# -- the g++ build of the header -----------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzr4") / "liblzr4_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZP_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    return build.bind_round4(ctypes.CDLL(so))


def ints(shape, seed: int, lo_hi=INT32, dtype=torch.int32):
    a = np.random.default_rng(seed).integers(*lo_hi, size=shape,
                                             dtype=np.int64)
    return torch.from_numpy(a.astype(NP[dtype]))


SELECT_BUILDS = [(m, n) for m, ns in pr4.SELECT_NS.items() for n in ns]
BLEND_BUILDS = [(m, n) for m, ns in pr4.BLEND_NS.items() for n in ns]


# (R, L, mask, iterations): blocks of 32 lanes (784 int32 rows), 16
# (2,100), 8 (5,000) and 1 (58,112: one column of 232,448 B); whole,
# part-filled and single-lane last blocks (L 1, 31, 33, 130); rows that
# move in 16-byte chunks (L a multiple of 16) and entry by entry
TILINGS = ((784, 256, 1023, 60), (12, 256, 2047, 60), (2100, 130, 2047, 60),
           (784, 1, 1023, 60), (784, 31, 2047, 60), (784, 33, 1023, 60),
           (2100, 256, 2047, 60), (5000, 64, 1023, 40), (5000, 33, 2047, 40),
           (58112, 2, 1023, 8))


@pytest.mark.parametrize("mode,n", SELECT_BUILDS)
def test_host_build_select_chain(mode, n, host_lib):
    """Full-range and small tables and states, both masks, tables smaller
    and larger than the mask, the block tilings of ``TILINGS`` (256 lanes:
    two gather tiles, eight blocks of 32 gathering from four 32-lane
    slices of them; 130: a part-filled block); the narrow types for
    ``sel`` with n = 1 (int16 rows of 64 B, int8 rows of 32 B: chunks
    where L is a multiple of 8 or 16)."""
    dtypes = (torch.int32, torch.int16, torch.int8) if (mode, n) == (
        "sel", 1) else (torch.int32,)
    for i, (R, L, mask, iters) in enumerate(TILINGS):
        if mode == "gather" and L % 128:
            continue
        for dtype in dtypes:
            info = np.iinfo(NP[dtype])
            x = ints((R, L), 10 + i, (int(info.min), int(info.max) + 1),
                     dtype)
            for st in (ints((4, L), 20 + i), ints((4, L), 30 + i, (-9, 9))):
                kw = {"mode": mode, "n": n, "mask": mask, "iters": iters,
                      "full": True}
                assert_same(pr4.launch_select_chain(host_lib, x, st, **kw),
                            pr4.select_chain_reference(x, st, **kw))


@pytest.mark.parametrize("mode,n", BLEND_BUILDS)
def test_host_build_blend_chain(mode, n, host_lib):
    """Tables of 10 rows (every index clips), 512, 784 and 1,100 (past the
    mask), full-range and small, at 130 lanes; and the block tilings of
    ``TILINGS``, each block's slice written back (the final table)."""
    cases = [(R, 130, lo_hi, 60) for R, lo_hi in (
        (10, INT32), (512, INT32), (784, (-300, 300)), (1100, INT32))]
    cases += [(R, L, INT32, iters) for R, L, _, iters in TILINGS if R >= 10]
    for i, (R, L, lo_hi, iters) in enumerate(cases):
        x = ints((R, L), 40 + i, lo_hi)
        for st in (ints((4, L), 50 + i), ints((4, L), 60 + i, (0, 4))):
            kw = {"mode": mode, "n": n, "iters": iters, "full": True}
            got = pr4.launch_blend_chain(host_lib, x, st, **kw)
            assert_same(got, pr4.blend_chain_reference(x, st, **kw))
            assert not torch.equal(got[1]["table"], x)  # it writes


def test_lanes_per_block_of_the_host_build_equals_the_wrappers(host_lib):
    """``lzr4_lanes_per_block``, ``lzr4_staged_rows`` and
    ``lzr4_block_bytes`` of the g++ build against their Python copies
    :func:`pr4.lanes_per_block`, :func:`pr4.staged_rows` and
    :func:`pr4.block_bytes`: on each tool row's staged rows (32 lanes a
    block, 16 for ``sel_s``'s 2,048 rows), on ``TILINGS``' shapes in every
    entry size, and on a sweep of column sizes around each power of two's
    limit; a block's shared memory stays within 232,448 B."""
    want = {"sel_s2": 16, "sel_s8": 16, "sel_s2f4": 16}
    for row, make in probe_round4.ROWS_OF_TOOL:
        fn, args, _ = make("cpu")
        x, _ = fn.view(*args)
        blend = fn.wrapper is pr4.blend_chain
        mode, elem = fn.kwargs["mode"], x.element_size()
        rows = pr4.staged_rows(mode, x.shape[0], blend=blend)
        if not blend:
            assert rows == host_lib.lzr4_staged_rows(
                pr4.SELECT_MODES.index(mode), x.shape[0]), row
        lb = pr4.lanes_per_block(rows, elem)
        assert lb == host_lib.lzr4_lanes_per_block(rows, elem)
        assert lb == want.get(row, 32), row
        assert pr4.block_bytes(rows, lb, elem) == host_lib.lzr4_block_bytes(
            rows, lb, elem) <= pr4.MAX_SHARED
    for mode in pr4.SELECT_MODES:
        for R in (1, 8, 784, 2048, 58113):
            assert pr4.staged_rows(mode, R) == host_lib.lzr4_staged_rows(
                pr4.SELECT_MODES.index(mode), R), (mode, R)
    assert pr4.block_bytes(784, 32, 4) == 100352
    assert pr4.block_bytes(3, 1, 1) == 16
    got = {R: pr4.lanes_per_block(R, 4) for R, *_ in TILINGS}
    assert got == {784: 32, 12: 32, 2100: 16, 5000: 8, 58112: 1}
    assert pr4.lanes_per_block(58113, 4) == 0
    assert pr4.staged_rows("null", 784) == 0
    assert pr4.staged_rows("gather", 784) == 8
    sizes = sorted({c // elem + d for lb in (1, 2, 4, 8, 16, 32, 64)
                    for c in [pr4.MAX_SHARED // lb] for elem in (1, 2, 4)
                    for d in (-1, 0, 1)} | {0, 1, 2})
    for elem in (1, 2, 4):
        for R in sizes:
            lb = pr4.lanes_per_block(R, elem)
            assert host_lib.lzr4_lanes_per_block(R, elem) == lb, (R, elem)
            for b in {lb, 1, 32}:
                assert pr4.block_bytes(R, b, elem) == \
                    host_lib.lzr4_block_bytes(R, b, elem), (R, b, elem)
            assert lb * R * elem <= pr4.MAX_SHARED
            assert lb == 32 or lb == 0 and R * elem > pr4.MAX_SHARED \
                or 2 * lb * R * elem > pr4.MAX_SHARED


def test_host_build_refuses_bad_arguments(host_lib):
    x, st = ints((784, 256), 70), ints((4, 256), 71)
    for kw in ({"mode": "sel", "mask": 5}, {"mode": "par3", "n": 2},
               {"mode": "sel", "n": 5}):
        with pytest.raises(RuntimeError, match="bad argument"):
            pr4.launch_select_chain(host_lib, x, st, iters=1, **kw)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.launch_select_chain(host_lib, x.short(), st, mode="par3",
                                iters=1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.launch_select_chain(host_lib, x.char(), st, mode="sel", n=3,
                                iters=1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.launch_select_chain(host_lib, x, st, mode="fused", n=7, iters=1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.launch_select_chain(host_lib, x[:, :100], st[:, :100],
                                mode="gather", iters=1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.launch_blend_chain(host_lib, x[:9], st, mode="mask", iters=1)
    # one int32 column of 58,113 rows is 232,452 B: over a block's shared
    # memory (58,112 rows fit, one lane a block)
    big, st2 = ints((58113, 2), 72), ints((4, 2), 73)
    for mode in ("sel", "par3"):
        with pytest.raises(RuntimeError, match="bad argument"):
            pr4.launch_select_chain(host_lib, big, st2, mode=mode, iters=1)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.launch_blend_chain(host_lib, big, st2, mode="par3", iters=1)
    # null stages no rows and gather 8: such a table runs
    for mode, L in (("null", 2), ("gather", 128)):
        xs = (ints((58113, L), 75), ints((4, L), 76))
        kw = {"mode": mode, "iters": 5, "full": True}
        assert_same(pr4.launch_select_chain(host_lib, *xs, **kw),
                    pr4.select_chain_reference(*xs, **kw))


# -- the chain read from SASS -------------------------------------------

# a loop in the shape of sel1's (mix, clip, address, shared load, add,
# and; the counter), after a staging loop of cp.async copies
LISTING = [(0x10, "LDGSTS.E.BYPASS.128 [R5], desc[UR4][R2.64]"),
           (0x20, "IADD3 R5, R5, 0x10, RZ"),
           (0x30, "ISETP.NE.AND P0, PT, R5, R7, PT"),
           (0x40, "@P0 BRA 0x10"),
           (0x50, "IMAD R3, R2, 0x9e33, RZ"),
           (0x60, "LOP3.LUT R3, R3, 0x3ff, RZ, 0xc0, !PT"),
           (0x70, "VIMNMX R3, R3, 0x30f, PT"),
           (0x80, "LEA R3, R3, UR6, 0x7"),
           (0x90, "LDS R4, [R3]"),
           (0xa0, "IADD3 R0, R0, 0x1, RZ"),
           (0xb0, "IADD3 R2, R4, R2, RZ"),
           (0xc0, "ISETP.NE.AND P0, PT, R0, UR5, PT"),
           (0xd0, "LOP3.LUT R2, R2, 0xffff, RZ, 0xc0, !PT"),
           (0xe0, "@P0 BRA 0x50"),
           (0xf0, "STG.E desc[UR4][R8.64], R2")]


def test_chain_read_from_sass():
    """``tools/sass_chain.py`` on a hand-written listing: the two loops,
    the one that reads shared memory, and its chain (IMAD, LOP3, VIMNMX,
    LEA: 4 cycles each; LDS 30; IADD3, LOP3: 4 each: 54 cycles, the
    counter's IADD3 and ISETP off the chain); operands as destinations and
    sources."""
    assert sass_chain.loops(LISTING) == [(0x10, 0x40), (0x50, 0xe0)]
    body = sass_chain.loop_body(LISTING, sass_chain.reads_shared)
    assert body == [ins for a, ins in LISTING if 0x50 <= a <= 0xe0]
    assert not sass_chain.reads_shared([i for _, i in LISTING[:4]])
    assert sass_chain.loop_body(LISTING, lambda b: False) == []
    assert sass_chain.chain_cycles(body) == 54
    # two independent loads of one index overlap: one load time more
    wide = body[:5] + ["LDS R9, [R3+0x880]", "IADD3 R2, R9, R2, RZ"] + \
        body[5:]
    assert sass_chain.chain_cycles(wide) == 54 + 4 + 1
    assert sass_chain.parse("@!P1 IADD3 R4, P2, PT, R2.reuse, R3, RZ") == (
        "IADD3", ["R4", "P2"], ["P1", "R2", "R3"])
    assert sass_chain.parse("LDS.64 R4, [R3+UR4]") == (
        "LDS.64", ["R4", "R5"], ["R3", "UR4"])
    assert sass_chain.parse("STS [R3+0x4], R5") == ("STS", [], ["R3", "R5"])
    assert sass_chain.parse("PLOP3.LUT P0, P2, P1, PT, PT, 0x80, 0x0") == (
        "PLOP3.LUT", ["P0", "P2"], ["P1"])
    assert sass_chain.parse("LDG.E R5, desc[UR4][R2.64]")[2] == [
        "UR4", "R2", "R3"]


# -- the wrappers and the tool -------------------------------------------


def test_wrappers_on_the_cpu_take_the_plain_version():
    before = [w.launches for w in pr4.WRAPPERS]
    x, st = ints((784, 256), 80), ints((4, 256), 81)
    kept = (x.clone(), st.clone())
    for mode, n in SELECT_BUILDS:
        assert torch.equal(
            pr4.select_chain(x, st, mode=mode, n=n, iters=9),
            pr4.select_chain_reference(x, st, mode=mode, n=n, iters=9))
    for mode, n in BLEND_BUILDS:
        assert torch.equal(
            pr4.blend_chain(x, st, mode=mode, n=n, iters=9),
            pr4.blend_chain_reference(x, st, mode=mode, n=n, iters=9))
    assert [w.launches for w in pr4.WRAPPERS] == before
    assert torch.equal(x, kept[0]) and torch.equal(st, kept[1])


BAD = {
    "dtype": lambda x, s: pr4.select_chain(x.long(), s, mode="sel", iters=1),
    "narrow par3": lambda x, s: pr4.select_chain(x.short(), s, mode="par3",
                                                 iters=1),
    "narrow sel2": lambda x, s: pr4.select_chain(x.char(), s, mode="sel",
                                                 n=2, iters=1),
    "narrow blend": lambda x, s: pr4.blend_chain(x.short(), s, mode="mask",
                                                 iters=1),
    "state rows": lambda x, s: pr4.select_chain(x, s[:3], mode="sel",
                                                iters=1),
    "state lanes": lambda x, s: pr4.blend_chain(x, s[:, :9], mode="oldw",
                                                iters=1),
    "device": lambda x, s: pr4.select_chain(
        x, torch.zeros((4, 256), dtype=torch.int32, device="meta"),
        mode="sel", iters=1),
    "mode": lambda x, s: pr4.select_chain(x, s, mode="mask", iters=1),
    "blend mode": lambda x, s: pr4.blend_chain(x, s, mode="sel", iters=1),
    "n": lambda x, s: pr4.select_chain(x, s, mode="fused", n=4, iters=1),
    "blend n": lambda x, s: pr4.blend_chain(x, s, mode="par3", n=7,
                                            iters=1),
    "mask": lambda x, s: pr4.select_chain(x, s, mode="sel", mask=511,
                                          iters=1),
    "iters": lambda x, s: pr4.blend_chain(x, s, mode="mask", iters=-1),
    "gather rows": lambda x, s: pr4.select_chain(x[:7], s, mode="gather",
                                                 iters=1),
    "gather lanes": lambda x, s: pr4.select_chain(
        x[:, :100], s[:, :100], mode="gather", iters=1),
    "blend rows": lambda x, s: pr4.blend_chain(x[:9], s, mode="mask",
                                               iters=1),
}


@pytest.mark.parametrize("bad", BAD)
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    x, st = ints((784, 256), 90), ints((4, 256), 91)
    with pytest.raises(ValueError):
        BAD[bad](x, st)


def test_tool_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """The tool's functions default to the card, and the command line stops
    without one; ``--device cpu`` runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for _, make in probe_round4.ROWS_OF_TOOL:
        with pytest.raises((RuntimeError, AssertionError)):
            make(None)
    with pytest.raises(SystemExit):
        probe_rows.main(probe_round4.ROWS_OF_TOOL, ["sel1"])
    monkeypatch.setattr(probe_round4, "ITERS", 64)
    rows = probe_rows.main(probe_round4.ROWS_OF_TOOL,
                           ["gather", "--device", "cpu", "--seed", "1"])
    assert [(r["name"], r["input"]) for r in rows] == [
        ("gather_taa", "tool"), ("gather_taa", "seeded")]


def test_the_counts_behind_the_bound():
    """The rows' counts: a slope from 16,384 to 32,768 iterations (an
    earlier tool's rows keep 8,192), the kernel held at 1,024; the rows an
    index can reach (784 from ``& 1023`` clipped to 784 rows, 1,024 of a
    narrow table's 1,568 or 3,136, all 2,048 of ``sel_s``, 8 for the
    gather, none for ``null``); reads add operations."""
    fn, args, lanes = probe_round4.CASES["sel1"]("cpu")
    assert (fn.iters, fn.long_iters, fn.check_iters) == (16384, 32768, 1024)
    assert lanes == 2048 and tuple(args[0].shape) == (784, 16, 128)
    p3, _, _ = probe_mosaic3.p12(False)("cpu")
    assert p3.long_iters == probe_rows.LONG_ITERS == 8192
    assert p3.check_iters is None
    reach = {"sel4": 784, "i16_1": 1024 / 2, "i8_1": 1024 / 4,
             "sel_s8": 2048, "gather_taa": 8, "null": 0, "fusedb7": 784,
             "blendoldw512": 512}
    for row, rows in reach.items():
        f, a, _ = probe_round4.CASES[row]("cpu")
        assert f.words_for(*a) == rows + 5, row
    assert pr4.rows_reached("sel", 1, 1023, 2000) == 1024
    assert pr4.rows_reached("fused", 7, 1023, 2000) == 1023 + 102 + 1
    assert pr4.rows_reached("par3", 3, 1023, 2000, blend=True) == 1023 + 34
    ops = [pr4.select_ops("sel", n) for n in (1, 2, 3, 4)]
    assert ops == sorted(ops) and pr4.select_ops("par3", 3) < ops[2]
    assert pr4.blend_ops("fused", 7) > pr4.blend_ops("fused", 3) > \
        pr4.select_ops("fused", 3)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [w.__name__ for w in pr4.WRAPPERS])
def test_kernel_equals_plain_version_on_card(kernel, cuda_device):
    """Every row of the kernel on the tool's input and a seeded one, at
    the rows' check count; and at 130 lanes (a part-filled block)."""
    wrapper = getattr(pr4, kernel)
    before, runs = wrapper.launches, 0
    for i, (name, make) in enumerate(probe_round4.ROWS_OF_TOOL):
        fn, args, _ = make(cuda_device)
        if fn.wrapper is not wrapper:
            continue
        cases = [(args, fn.check_iters),
                 (fn.seeded_inputs(args, 70 + i), fn.check_iters)]
        for xs, iters in cases:
            got = fn(*xs, full=True, iters=iters)
            torch.cuda.synchronize()
            assert_same(got, fn.plain(*xs, full=True, iters=iters))
            runs += 1
        if fn.kwargs["mode"] != "gather":
            x, st = fn.view(*cases[1][0])
            kw = {**fn.kwargs, "iters": 300, "full": True}
            got = wrapper(x[:, :130].contiguous(), st[:, :130].contiguous(),
                          **kw)
            torch.cuda.synchronize()
            assert_same(got, wrapper.reference(x[:, :130], st[:, :130],
                                               **kw))
            runs += 1
    assert runs and wrapper.launches == before + runs


@pytest.mark.cuda
def test_kernel_tilings_on_card(cuda_device):
    """The block tilings of ``TILINGS`` on the card, every select and blend
    build against its plain version (the gather at 256 lanes; narrow
    tables for ``sel`` with n = 1), and a table that starts 4 bytes into
    its storage (the select kernel stages it entry by entry; the blend
    wrapper first clones it into an aligned copy, so the blends' entry-by-
    entry staging is covered by the part-filled blocks of L = 1, 31, 33
    and 130); a column over 232,448 B raises."""
    runs = 0
    for i, (R, L, mask, iters) in enumerate(TILINGS):
        x = ints((R, L), 100 + i).to(cuda_device)
        st = ints((4, L), 120 + i).to(cuda_device)
        for mode, n in SELECT_BUILDS + [("blend", m) for m in BLEND_BUILDS]:
            if mode == "gather" and L % 128:
                continue
            if mode == "blend":
                if R < pr4.BLEND_ROWS:
                    continue
                kw = {"mode": n[0], "n": n[1], "iters": iters, "full": True}
                got, want = pr4.blend_chain(x, st, **kw), \
                    pr4.blend_chain_reference(x, st, **kw)
            else:
                kw = {"mode": mode, "n": n, "mask": mask, "iters": iters,
                      "full": True}
                for t in [x] + ([x.short(), x.char()] if (mode, n) == (
                        "sel", 1) else []):
                    got = pr4.select_chain(t, st, **kw)
                    torch.cuda.synchronize()
                    assert_same(got, pr4.select_chain_reference(t, st, **kw))
                    runs += 1
                continue
            torch.cuda.synchronize()
            assert_same(got, want)
            runs += 1
    x = ints((785, 256), 140).to(cuda_device).view(-1)[1:].view(-1)
    x = x[:784 * 256].view(784, 256)  # 4 bytes into its storage
    st = ints((4, 256), 141).to(cuda_device)
    for kind in ("select", "blend"):
        kw = {"mode": "par3", "iters": 50, "full": True}
        w = pr4.select_chain if kind == "select" else pr4.blend_chain
        got = w(x, st, **kw)
        torch.cuda.synchronize()
        assert_same(got, w.reference(x, st, **kw))
    big = torch.zeros((58113, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="bad argument"):
        pr4.select_chain(big, st[:, :2], mode="sel", iters=1)
    assert runs > 50
