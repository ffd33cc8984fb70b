"""The probe kernels of the port against the JAX package's Pallas probes.

- Each of the seven Pallas functions of ``tools/probe_lane2d.py`` and
  ``tools/probe_state_in_ref.py`` (imported by path: ``tools/`` is not a
  package), run in interpret mode, against its counterpart in
  ``lzma_rs_tpu_torch/tools/`` on the CPU (the plain versions of
  ``ops/probes.py``): exact int32 equality of the output and of the final
  table, ring and state (the probe's scratch after its loop, and its
  carry), on the tool's own input and on two seeded ones that reach the
  wrapping and sign paths (the full int32 range; tables with entries
  above 0x7FF and negative). From the y-series' zero state every bit is 1
  and the output is 255 in every lane, so on the seeded inputs the
  y-series' loops also start from a seeded scratch state and ring.
- A g++ build of ``csrc/probe_lane.cuh`` (``-DLZP_HOST_ENTRY``, the C
  interface of ``csrc/probes.cu`` as host loops) against the plain
  versions: output, final table, ring and state, for every table
  placement and state placement, from the probes' starts and seeded
  ones.
- The wrappers' checks, the tools' command line, ``ops/build.py``'s
  per-library hash, and (marked ``cuda``) every row's kernel against its
  plain version on the card.

JAX is imported only by the tests that run the Pallas probes, so the
``cuda`` tests run on a machine without it.
"""

import ctypes
import functools
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.ops import build, probes
from lzma_rs_tpu_torch.tools import (probe_lane2d, probe_rows,
                                     probe_state_in_ref)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
HEADER = os.path.join(REPO, "lzma_rs_tpu_torch", "csrc", "probe_lane.cuh")
INT32 = (-2**31, 2**31)


def load_tool(name: str):
    """``tools/<name>.py`` as a module. The tools put a directory of their
    own at the head of ``sys.path`` when imported; it is put back."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


jax_tool = functools.lru_cache(maxsize=None)(load_tool)


class OpenLoop:
    """``jax.lax.while_loop`` with a Pallas probe's loop opened (any other
    loop runs as it is): ``start`` (scratch ref name -> array) is written
    into the kernel's scratch just before the loop, ``carry`` (leaf index
    -> array) replaces those leaves of the loop's start carry, and after it
    ``final`` holds every scratch ref the loop's body uses and the loop's
    carry (``"carry"``: its leaves). Only the outermost loop of a probe is
    opened: a loop inside its body (``tools/probe_mosaic4.py``'s rounds of
    16 steps) runs as it is. The probes' own code is not changed."""

    def __init__(self, real):
        self.real, self.start, self.carry, self.final = real, {}, {}, None
        self.inside = False  # tracing an opened loop's body

    def __call__(self, cond, body, init):
        import jax

        code = body.__code__
        if self.inside or not code.co_filename.startswith(TOOLS + os.sep):
            return self.real(cond, body, init)
        refs = {n: c.cell_contents for n, c in
                zip(code.co_freevars, body.__closure__ or ())
                if n.endswith("_ref")}
        for n, v in self.start.items():
            # through a callback: a kernel may not capture an array
            refs[n][...] = jax.pure_callback(
                lambda v=v: v, jax.ShapeDtypeStruct(v.shape, v.dtype))
        if self.carry:
            leaves, tree = jax.tree.flatten(init)
            for k, v in self.carry.items():
                assert (v.shape, v.dtype) == (leaves[k].shape,
                                              leaves[k].dtype), k
                leaves[k] = jax.pure_callback(
                    lambda v=v: v, jax.ShapeDtypeStruct(v.shape, v.dtype))
            init = jax.tree.unflatten(tree, leaves)
        self.inside = True
        try:
            out = self.real(cond, body, init)
        finally:
            self.inside = False
        jax.debug.callback(self._record,
                           {n: r[...] for n, r in refs.items()}, out)
        return out

    def _record(self, refs, carry):
        import jax

        self.final = {n: np.asarray(v) for n, v in refs.items()}
        self.final["carry"] = [np.asarray(c) for c in jax.tree.leaves(carry)]


@pytest.fixture
def pallas(monkeypatch):
    """Every ``pallas_call`` in interpret mode and every probe's loop
    opened (:class:`OpenLoop`), for this test only."""
    import jax
    from jax.experimental import pallas as pallas_mod

    monkeypatch.setattr(
        pallas_mod, "pallas_call",
        functools.partial(pallas_mod.pallas_call, interpret=True))
    loop = OpenLoop(jax.lax.while_loop)
    monkeypatch.setattr(jax.lax, "while_loop", loop)
    return loop


# (tool, function, arguments) at small shapes; the port's function has the
# same name and arguments, plus ``device``
CASES = {
    "tinyops_only_1d": ("probe_lane2d", (256,)),
    "tinyops_only_2d": ("probe_lane2d", (2,)),
    "bitdecode_1d": ("probe_lane2d", (256,)),
    "bitdecode_2d": ("probe_lane2d", (2,)),
    "y1": ("probe_state_in_ref", (2,)),
    "y2": ("probe_state_in_ref", ()),
    "y4-30": ("probe_state_in_ref", (1, 30)),
    "y4-500": ("probe_state_in_ref", (1, 500)),
}
PORT_TOOLS = {"probe_lane2d": probe_lane2d,
              "probe_state_in_ref": probe_state_in_ref}
# seeded inputs: the full int32 range, and a narrow one (tinyops: small
# values near zero; tables: 12-bit values, half of them above 0x7FF)
INPUTS = ("tool", "wide", "narrow")


def seeded(shape, kind: str, tinyops: bool, seed: int):
    lo, hi = INT32 if kind == "wide" else (
        (-2**16, 2**16) if tinyops else (0, 4096))
    return np.random.default_rng(seed).integers(lo, hi, size=shape,
                                                dtype=np.int32)


Y_STATE = {"y1": ("st_ref",),
           "y2": ("idx_ref", "acc_ref", "rng_ref", "cod_ref")}


def y_start(fname: str, lanes: tuple, kind: str, seed: int) -> tuple:
    """A seeded start of a y-series loop: the scratch for the Pallas probe
    (ref name -> array) and the port's keyword arguments to match."""
    rng = np.random.default_rng(seed)
    lo, hi = INT32 if kind == "wide" else (-2**16, 2**16)

    def words(n):
        return rng.integers(lo, hi, size=(n, *lanes), dtype=np.int32)

    if fname == "y1":  # idx, acc, rng, cod in slots 0-3 of [NST, S, 128]
        st = words(probes.NST)
        return {"st_ref": st}, {"init": tuple(map(torch.from_numpy, st[:4]))}
    if fname == "y2":
        st = words(4)
        return (dict(zip(Y_STATE["y2"], st)),
                {"init": tuple(map(torch.from_numpy, st))})
    # y4: idx, acc, rng, cod, a, b, d in slots 0-6 of [16, S, 128]
    st, ring = words(16), words(probes.RING)
    return ({"st_ref": st, "ring_ref": ring},
            {"init": torch.from_numpy(st[:7].copy()),
             "ring": torch.from_numpy(ring)})


def pallas_final(fname: str, final: dict) -> dict:
    """The Pallas probe's final scratch and carry as the port's ``full``
    entries (in the probe's layout)."""
    carry = final["carry"]
    if fname.startswith("tinyops"):  # carry a, b, d, i
        assert int(carry[-1]) == probes.ITERS
        return {"state": np.stack(carry[:3])}
    if fname.startswith("bitdecode"):  # carry idx, acc, rng, cod, i
        assert int(carry[-1]) == probes.ITERS
        return {"table": final["tab_ref"], "state": np.stack(carry[:4])}
    assert [int(c) for c in carry] == [probes.ITERS]
    if fname == "y1":
        return {"table": final["tab_ref"], "state": final["st_ref"][:4]}
    if fname == "y2":
        return {"table": final["tab_ref"],
                "state": np.stack([final[n] for n in Y_STATE["y2"]])}
    return {"table": final["tab_ref"], "ring": final["ring_ref"],
            "state": final["st_ref"][:7]}


@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("case", CASES)
def test_port_equals_the_pallas_probe(case, kind, pallas):
    import jax
    import jax.numpy as jnp

    tool, args = CASES[case]
    fname = case.split("-")[0]
    jfn, jargs, jlanes = getattr(jax_tool(tool), fname)(*args)
    pfn, pargs, planes = getattr(PORT_TOOLS[tool], fname)(
        *args, device="cpu")
    assert planes == jlanes
    assert tuple(pargs[0].shape) == tuple(jargs[0].shape)
    seed = sorted(CASES).index(case)
    x = (np.array(jargs[0]) if kind == "tool" else
         seeded(tuple(jargs[0].shape), kind, fname.startswith("tiny"), seed))
    if kind == "tool":
        assert np.array_equal(pargs[0].numpy(), x)
    start = {}
    if kind != "tool" and fname.startswith("y"):
        pallas.start, start = y_start(fname, x.shape[1:], kind, seed + 100)
    want = jfn(jnp.asarray(x))
    jax.block_until_ready(want)
    jax.effects_barrier()
    want = np.asarray(want)
    got, full = pfn(torch.from_numpy(x), full=True, **start)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    final = pallas_final(fname, pallas.final)
    assert full.keys() == final.keys()
    for k, w in final.items():
        g = full[k]
        assert g.dtype == torch.int32 and g.numel() == w.size, k
        assert np.array_equal(g.numpy(), w.reshape(g.shape)), k


def test_loading_a_tool_leaves_sys_path_as_it_was():
    before = list(sys.path)
    load_tool("probe_state_in_ref")
    assert sys.path == before


def test_the_y_series_saturates_as_the_tpu_probe_does():
    """rng = cod = 0 makes every bit 1: acc is 255 in every lane, so the
    y-series' output alone cannot tell a wrong port from a right one."""
    fn, args, _ = probe_state_in_ref.y1(1, device="cpu")
    assert fn(args[0]).eq(255).all()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzp") / "liblzp_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZP_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    return build.bind_probes(ctypes.CDLL(so))


def table(lo: int, hi: int, seed: int, lanes=(2, 50)):
    """[ROWS, *lanes]; 100 lanes: one whole 64-lane shared block, one
    part-filled."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        lo, hi, size=(probes.ROWS, *lanes), dtype=np.int32))


def assert_same(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("kind", ("wide", "narrow"))
def test_host_build_tinyops(kind, host_lib):
    x = torch.from_numpy(seeded((2, 50), kind, True, 11))
    assert_same(probes.launch_tinyops(host_lib, x, iters=40, full=True),
                probes.tinyops_reference(x, iters=40, full=True))


def lane_words(n: int, seed: int, lanes=(2, 50)):
    """[n, *lanes] int32 over the full range: a seeded start."""
    return table(*INT32, seed, lanes)[:n].clone()


@pytest.mark.parametrize("state", probes.STATES)
@pytest.mark.parametrize("placement", probes.PLACEMENTS)
def test_host_build_bitdecode(placement, state, host_lib):
    for i, (lo, hi) in enumerate((INT32, (0, 4096))):
        tab = table(lo, hi, 20 + i)
        for init in (probes.BITDECODE_INIT, probes.Y_INIT,
                     tuple(lane_words(4, 25 + i))):
            assert_same(
                probes.launch_bitdecode(host_lib, tab, init=init, iters=120,
                                        placement=placement, state=state,
                                        full=True),
                probes.bitdecode_reference(tab, init=init, iters=120,
                                           full=True))


@pytest.mark.parametrize("rounds", (10, 166))
def test_host_build_realweight(rounds, host_lib):
    for i, (lo, hi) in enumerate((INT32, (0, 4096))):
        tab = table(lo, hi, 30 + i)
        start = {"init": lane_words(7, 35 + i),
                 "ring": table(*INT32, 37 + i)[:probes.RING].clone()}
        for kw in ({}, start):
            assert_same(
                probes.launch_realweight(host_lib, tab, rounds=rounds,
                                         iters=60, full=True, **kw),
                probes.realweight_reference(tab, rounds=rounds, iters=60,
                                            full=True, **kw))


def test_host_build_refuses_bad_arguments(host_lib):
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="bad argument"):
        probes.launch_tinyops(host_lib, x, iters=-1)


def test_wrappers_on_the_cpu_take_the_plain_version():
    before = [w.launches for w in probes.WRAPPERS]
    tab = table(0, 2048, 40, lanes=(1, 128))
    x = torch.arange(-64, 64, dtype=torch.int32)
    assert torch.equal(probes.tinyops_chain(x, iters=3),
                       probes.tinyops_reference(x, iters=3))
    for placement in probes.PLACEMENTS:
        assert torch.equal(
            probes.bitdecode_chain(tab, iters=20, placement=placement),
            probes.bitdecode_reference(tab, iters=20))
    assert torch.equal(probes.realweight_step(tab, rounds=4, iters=9),
                       probes.realweight_reference(tab, rounds=4, iters=9))
    start = {"init": lane_words(7, 42, (1, 128)),
             "ring": table(*INT32, 43, (1, 128))[:probes.RING].clone()}
    kept = {k: v.clone() for k, v in start.items()}
    assert torch.equal(
        probes.realweight_step(tab, rounds=4, iters=9, **start),
        probes.realweight_reference(tab, rounds=4, iters=9, **start))
    assert [w.launches for w in probes.WRAPPERS] == before
    assert tab.eq(table(0, 2048, 40, lanes=(1, 128))).all()  # not changed
    assert all(torch.equal(start[k], kept[k]) for k in start)


@pytest.mark.parametrize("bad", ("dtype", "rows", "placement", "state",
                                 "iters", "device", "init"))
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    tab = table(0, 2048, 41, lanes=(4,))
    kw = {"placement": "minor", "state": "registers", "iters": 5}
    err = ValueError
    if bad == "dtype":
        tab = tab.long()
    elif bad == "rows":
        tab = tab[:-1]
    elif bad == "device":
        tab = torch.zeros(tab.shape, dtype=torch.int32, device="meta")
    elif bad == "iters":
        kw["iters"] = -1
    elif bad == "init":  # a start of another lane count
        kw["init"] = (0, 0, 0, torch.zeros(5, dtype=torch.int32))
    else:
        kw[bad] = "nowhere"
    with pytest.raises(err):
        probes.bitdecode_chain(tab, **kw)


@pytest.mark.parametrize("bad", ("init", "ring"))
def test_realweight_rejects_a_start_of_another_shape(bad):
    tab = table(0, 2048, 44, lanes=(4,))
    rows = 7 if bad == "init" else probes.RING
    with pytest.raises(ValueError, match=bad):
        probes.realweight_step(tab, rounds=2, iters=3, **{
            bad: torch.zeros((rows, 5), dtype=torch.int32)})


def test_tool_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """The tools' functions default to the card, and the command line
    stops without one; ``--device cpu`` runs the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        probe_lane2d.bitdecode_1d(256)
    with pytest.raises(SystemExit):
        probe_rows.main(probe_state_in_ref.ROWS_OF_TOOL, ["y2"])
    rows = probe_rows.main(probe_state_in_ref.ROWS_OF_TOOL,
                           ["y2", "--device", "cpu", "--seed", "1"])
    assert [(r["name"], r["input"]) for r in rows] == [
        ("y2 state-in-4-refs [S,128]", "tool"),
        ("y2 state-in-4-refs [S,128]", "seeded")]


def test_the_tools_list_the_tpu_probes_rows():
    names = [n for n, _ in probe_lane2d.ROWS_OF_TOOL]
    assert names[:6] == [
        "tinyops(150) 1d L=256", "tinyops(150) 2d S=8 (1024 lanes)",
        "tinyops(150) 2d S=32 (4096 lanes)", "bitdecode 1d L=256",
        "bitdecode 2d S=8 (1024 lanes)", "bitdecode 2d S=16 (2048 lanes)"]
    assert [n.split()[0] for n, _ in probe_state_in_ref.ROWS_OF_TOOL] == [
        "y1", "y2", "y3", "y4", "y5", "y6"]


@pytest.mark.parametrize("edited,changed", (
    ("probes.cu", "probes"), ("probe_lane.cuh", "probes"),
    ("lzma_lane.cuh", "segdec"), ("decode_segments.cu", "segdec"),
    ("segment_kernel.cuh", "segdec"), ("decode_variants.cu", "segvar"),
    ("probes_mosaic.cu", "mosaic"), ("probe_mosaic.cuh", "mosaic"),
    ("probes_mosaic3.cu", "mosaic3"), ("probe_mosaic3.cuh", "mosaic3"),
    ("probes_mosaic4.cu", "mosaic4"), ("probe_mosaic4.cuh", "mosaic4"),
    ("probes_round4.cu", "round4"), ("probe_round4.cuh", "round4"),
    ("probes_bisect.cu", "bisect"), ("probe_bisect.cuh", "bisect"),
    ("step_cost.cu", "stepcost")))
def test_an_edit_rebuilds_only_its_library(edited, changed, tmp_path):
    """An edit rebuilds the libraries whose sources hold the file, and no
    other: ``changed``, and ``mosaic3``, ``mosaic4`` and ``round4`` too for
    ``probe_mosaic.cuh``, which their headers include, and ``bisect`` for
    ``probe_lane.cuh``, which its header includes; ``segvar`` and
    ``stepcost`` too for the decoder's two headers, which its variants and
    its step-cost builds instantiate."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    libs = build.LIBRARIES
    before = {lib.name: build.source_hash(lib, str(csrc)) for lib in libs}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {lib.name: build.source_hash(lib, str(csrc)) for lib in libs}
    also = {"probe_mosaic.cuh": {"mosaic3", "mosaic4", "round4"},
            "probe_lane.cuh": {"bisect"},
            "lzma_lane.cuh": {"segvar", "stepcost"},
            "segment_kernel.cuh": {"segvar", "stepcost"}}.get(edited, set())
    assert {n for n in before if before[n] != after[n]} == {changed} | also


def test_each_library_has_its_own_cached_file(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    paths = []
    for lib in build.LIBRARIES:
        path = tmp_path / f"liblzl_{lib.name}-{build.source_hash(lib)}.so"
        path.write_bytes(b"")
        paths.append(str(path))
    # cached: no nvcc is asked for
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc called"))
    assert [build.build_library(lib).path
            for lib in build.LIBRARIES] == paths


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


ALL_ROWS = probe_lane2d.ROWS_OF_TOOL + probe_state_in_ref.ROWS_OF_TOOL


@pytest.mark.cuda
@pytest.mark.parametrize("row", [n for n, _ in ALL_ROWS])
def test_kernel_equals_plain_version_on_card(row, cuda_device):
    """On the tool's input, a seeded one, and (bit decode, realweight) the
    seeded one from a seeded start."""
    fn, args, _ = dict(ALL_ROWS)[row](cuda_device)
    before = fn.wrapper.launches
    x, = fn.seeded_inputs(args, 7)
    lanes = tuple(fn.view(x)[0].shape[1:])
    runs = [(args[0], {}), (x, {})]
    if fn.wrapper is probes.bitdecode_chain:
        runs.append((x, {"init": tuple(lane_words(4, 8, lanes).cuda())}))
    if fn.wrapper is probes.realweight_step:
        runs.append((x, {"init": lane_words(7, 8, lanes).cuda(),
                         "ring": table(*INT32, 9, lanes)[:probes.RING]
                         .cuda()}))
    for x, kw in runs:
        got = fn(x, full=True, **kw)
        torch.cuda.synchronize()
        want = fn.plain(x, full=True, **kw)
        assert_same(tuple(got), tuple(want))
    assert fn.wrapper.launches == before + len(runs)
