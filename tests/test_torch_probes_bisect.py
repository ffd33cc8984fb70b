"""The bisect probe kernel of the port against the JAX package's probe.

- Each of the sixteen bodies of ``tools/probe_lane2d_bisect.py``
  (imported by path), run through the tool's own ``try_case`` in
  interpret mode with its ``while_loop`` opened
  (``test_torch_probes.OpenLoop``), against its counterpart in
  ``lzma_rs_tpu_torch/tools/probe_lane2d_bisect.py`` on the CPU (the plain
  version of ``ops/probes_bisect.py``): exact equality of the output (what
  ``try_case`` hands to ``jax.block_until_ready``, recorded through
  ``monkeypatch``), the final carry (idx, acc, rng, cod) and the final
  table, on three inputs: the tool's (``full(1024)`` and the probe's start
  in every lane), a full-range table, and full-range starts (idx near
  2^31 - 1 on some lanes, so the climb and the step wrap before the clip)
  over a full-range table. ``try_case`` prints ``OK`` or ``FAIL`` and
  swallows the error: a test fails on anything but ``OK``. The tool's
  ``S`` and ``ITERS`` are monkeypatched smaller; ``ROWS`` (648) stays, as
  it sets the clip.
- A g++ build of ``csrc/probe_bisect.cuh`` (``-DLZP_HOST_ENTRY``, the C
  interface of ``csrc/probes_bisect.cu`` as a host loop) against the plain
  version, for every body.
- The wrapper's checks, the tool's command line and row names, the counts
  behind the bound, the ``bisect`` library's own cached file, and (marked
  ``cuda``) every row's kernel against its plain version on the card.

JAX is imported only by the tests that run the Pallas probe, so the
``cuda`` test runs on a machine without it.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.ops import build, probes
from lzma_rs_tpu_torch.ops import probes_bisect as pb
from lzma_rs_tpu_torch.tools import probe_lane2d_bisect, probe_rows

from test_torch_probes import (TOOLS, assert_same, jax_tool,  # noqa: F401
                               pallas)

REPO = os.path.dirname(TOOLS)
HEADER = os.path.join(REPO, "lzma_rs_tpu_torch", "csrc",
                      "probe_bisect.cuh")
S = 1        # the tool's S, monkeypatched: 128 lanes
ITERS = 24   # the tool's ITERS, monkeypatched
KINDS = ("tool", "table", "starts")
INT32 = (-2**31, 2**31)
NAMES = probe_lane2d_bisect.NAMES


def inputs(kind: str, seed: int, s: int = S) -> tuple:
    """(table [648, s, 128], start [4, s, 128]) as numpy int32."""
    rng = np.random.default_rng(seed)
    table = np.full((pb.ROWS, s, 128), 1024, dtype=np.int32)
    start = np.broadcast_to(np.array(pb.INIT, dtype=np.int32)[:, None, None],
                            (4, s, 128)).copy()
    if kind != "tool":
        table = rng.integers(*INT32, size=table.shape, dtype=np.int32)
    if kind == "starts":
        start = probe_lane2d_bisect.seeded_start(rng, start.shape)
    return table, start


def reads_the_table(body: str) -> bool:
    return pb.STAGES[body][1] in ("row", "max0", "column", "const_row",
                                  "mask7_row")


CASES = [(n, k) for n in NAMES for k in KINDS]


@pytest.mark.parametrize("name,kind", CASES)
def test_port_equals_the_pallas_probe(name, kind, pallas, monkeypatch,
                                      capsys):  # noqa: F811
    import jax

    tool = jax_tool("probe_lane2d_bisect")
    monkeypatch.setattr(tool, "S", S)
    monkeypatch.setattr(tool, "ITERS", ITERS)
    monkeypatch.setattr(probe_lane2d_bisect, "S", S)
    monkeypatch.setattr(probe_lane2d_bisect, "ITERS", ITERS)
    body = name.split()[0]
    table, start = inputs(kind, CASES.index((name, kind)))
    if kind != "tool":
        # the loop's start: a seeded carry, and the seeded table written
        # over the scratch the kernel copied its full(1024) input into
        pallas.carry = dict(enumerate(start))
        if reads_the_table(body):
            pallas.start = {"tab_ref": table}
    seen = []
    real = jax.block_until_ready

    def record(x):
        seen.append(np.asarray(real(x)))
        return x

    monkeypatch.setattr(jax, "block_until_ready", record)
    tool.try_case(name, getattr(tool, body))
    jax.effects_barrier()
    printed = capsys.readouterr().out.split()
    assert printed[-1] == "OK" and "FAIL" not in printed, printed
    want, = seen

    fn, (t0, s0), lanes = dict(probe_lane2d_bisect.ROWS_OF_TOOL)[name]("cpu")
    assert lanes == S * 128 and fn.iters == ITERS
    if kind == "tool":  # the tool's input is the probe's
        assert np.array_equal(t0.numpy(), table)
        assert np.array_equal(s0.numpy(), start)
    got, full = fn(torch.from_numpy(table), torch.from_numpy(start),
                   full=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    final = pallas.final
    carry = final["carry"]
    assert int(carry[4]) == ITERS
    assert np.array_equal(full["state"].numpy(), np.stack(carry[:4]))
    assert ("tab_ref" in final) == reads_the_table(body)
    if "tab_ref" in final:
        assert np.array_equal(full["table"].numpy(), final["tab_ref"])
    if not pb.STAGES[body][3]:  # a body that does not write
        assert np.array_equal(full["table"].numpy(), table)


def test_a_failing_body_fails_the_test(monkeypatch, capsys):
    """``try_case`` prints ``FAIL`` and returns: the output check above
    sees it, and no result reaches ``jax.block_until_ready``."""
    import jax

    tool = jax_tool("probe_lane2d_bisect")
    seen = []
    monkeypatch.setattr(jax, "block_until_ready", seen.append)

    def broken(tab_ref, rows):
        def body(c):
            raise ValueError("a body that does not trace")
        return body

    tool.try_case("broken", broken)
    printed = capsys.readouterr().out.split()
    assert "FAIL" in printed and printed[-1] != "OK" and seen == []


def test_the_rows_are_the_tpu_tools_rows():
    with open(os.path.join(TOOLS, "probe_lane2d_bisect.py")) as f:
        src = f.read()
    main = src[src.index('if __name__ == "__main__":'):]
    listed = main[main.index("names = ["):]
    listed = listed[:listed.index("]")]
    assert [n for n, _ in probe_lane2d_bisect.ROWS_OF_TOOL] == list(NAMES)
    assert all(f'"{n}"' in listed for n in NAMES) and len(NAMES) == 16
    assert [n.split()[0] for n in NAMES] == list(pb.BODIES)
    tool = jax_tool("probe_lane2d_bisect")
    assert (tool.ITERS, tool.ROWS, tool.S) == (
        pb.ITERS, pb.ROWS, probe_lane2d_bisect.S)


def run(body, kind, seed=3, iters=ITERS, **kw):
    table, start = inputs(kind, seed, s=2)
    return pb.bisect_chain(torch.from_numpy(table), torch.from_numpy(start),
                           body=body, iters=iters, **kw)


def test_the_seeded_inputs_show_what_the_tools_input_hides():
    """On the tool's input every bit is 0 (``p & 1`` of 1024 is 0, and
    ``cod`` stays under ``bound``), so v2 = v2max = v3 there;
    a full-range table tells them apart, makes w1's column sum wrap, and
    full-range starts keep an idx outside the table in w1 and w2, whose
    index stage is empty."""
    for body in ("v2max", "v3"):
        assert torch.equal(run(body, "tool"), run("v2", "tool"))
    assert not torch.equal(run("v2max", "table"), run("v2", "table"))
    assert not torch.equal(run("v3", "table"), run("v2", "table"))
    table, start = inputs("starts", 3, s=2)
    assert (np.abs(table.astype(np.int64).sum(0)) >= 2**31).any()
    for body in ("w1", "w2"):
        _, full = run(body, "starts", full=True)
        assert np.array_equal(full["state"][0].numpy(), start[0])
        assert ((start[0] < 0) | (start[0] >= pb.ROWS)).any()
    # idx within 10 of 2^31 - 1: the climb and the step wrap to < 0, and
    # the clip takes them to row 0, not row 647
    near = start[0] > 2**31 - 12
    assert near.any()
    for body in ("v1", "w3"):
        _, full = run(body, "starts", iters=1, full=True)
        count = (np.clip(start[1], 0, 10) if body == "v1"
                 else start[1] & 1)
        wraps = start[0].astype(np.int64) + count > 2**31 - 1
        idx = full["state"][0].numpy()
        assert wraps.any() and (near & ~wraps).any()
        assert (idx[wraps] == 0).all() and (idx[near & ~wraps] == 647).all()


# -- the g++ build of the header -----------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzb") / "liblzb_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZP_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    return build.bind_bisect(ctypes.CDLL(so))


@pytest.mark.parametrize("body", pb.BODIES)
def test_host_build_bisect(body, host_lib):
    """Every input kind, 0, 1 and 70 iterations, 3 x 128 lanes."""
    for i, kind in enumerate(KINDS):
        table, start = (torch.from_numpy(a) for a in inputs(kind, 20 + i,
                                                               s=3))
        for iters in (0, 1, 70):
            kw = {"body": body, "iters": iters, "full": True}
            assert_same(pb.launch_bisect(host_lib, table, start, **kw),
                        pb.bisect_reference(table, start, **kw))


def test_host_build_refuses_bad_arguments(host_lib):
    """A mode out of range, no lane, negative iterations."""
    table, start = (torch.from_numpy(a) for a in inputs("tool", 0))
    with pytest.raises(RuntimeError, match="bad argument"):
        pb.launch_bisect(host_lib, table, start, body="v2", iters=-1)
    buf = torch.zeros(pb.ROWS * 128, dtype=torch.int32)
    st = torch.zeros((4, 128), dtype=torch.int32)
    end = torch.zeros((4, 128), dtype=torch.int32)
    out = torch.zeros(128, dtype=torch.int32)
    for mode, L, iters in ((11, 128, 4), (-1, 128, 4), (1, 0, 4),
                           (1, 128, -1)):
        assert host_lib.lzb_bisect(
            mode, buf.data_ptr(), None, st.data_ptr(), end.data_ptr(),
            out.data_ptr(), L, iters, None) == -1, mode
    # v4 without a table to write back is the timed call: accepted
    assert host_lib.lzb_bisect(4, buf.data_ptr(), None, st.data_ptr(),
                               end.data_ptr(), out.data_ptr(), 128, 4,
                               None) == 0


def edge_inputs(kind: str, lanes: int, seed: int) -> tuple:
    """(table [648, lanes], start [4, lanes]) tensors: the tool's, a
    full-range table, full-range starts (idx within 10 of 2^31 - 1 on
    every eighth lane: the climb and the step wrap before the clip), or
    "wraps": a table whose every column sums past 2^32 (w1's sum wraps)
    under seeded starts."""
    table, start = inputs("starts" if kind == "wraps" else kind, seed, s=2)
    table = table.reshape(pb.ROWS, -1)[:, :lanes]
    start = start.reshape(4, -1)[:, :lanes]
    if kind == "wraps":
        rng = np.random.default_rng(seed)
        table = rng.integers(2**30, 2**31, size=table.shape,
                             dtype=np.int64).astype(np.int32)
    return (torch.from_numpy(np.ascontiguousarray(table)),
            torch.from_numpy(np.ascontiguousarray(start)))


@pytest.mark.parametrize("body", pb.BODIES)
def test_host_build_block_edges(body, host_lib):
    """The per-rank code (staging, w1's split sum, the write-back) at 130
    lanes (a part-filled last block: 4 whole blocks and 2 lanes) and at 1
    lane; full=True and full=False; 0, 1 and 37 iterations; on the seeded
    starts, whose walks wrap idx before the clip, and a table whose column
    sums wrap uint32."""
    for lanes in (130, 1):
        for i, kind in enumerate(("starts", "wraps")):
            table, start = edge_inputs(kind, lanes, 40 + i)
            kept = (table.clone(), start.clone())
            for iters in (0, 1, 37):
                kw = {"body": body, "iters": iters}
                want = pb.bisect_reference(table, start, full=True, **kw)
                assert_same(pb.launch_bisect(host_lib, table, start,
                                             full=True, **kw), want)
                assert torch.equal(pb.launch_bisect(
                    host_lib, table, start, **kw), want[0])
            assert torch.equal(table, kept[0]) and torch.equal(start, kept[1])


def test_w1_sums_wrap_uint32():
    """The "wraps" table's columns sum past 2^32, so w1's read is the
    wrapped sum; its low bit differs from lane to lane."""
    table, start = edge_inputs("wraps", 130, 41)
    sums = table.long().sum(0)
    assert (sums >= 2**32).all()
    bits = (sums & 1).unique()
    assert bits.tolist() == [0, 1]


def test_a_call_is_one_launch(host_lib):
    """The timed call (full=False) makes no copy of its inputs before the
    kernel: outputs are ``torch.empty`` and the inputs go in as views, so
    on the card the kernel's launch is the call's only one."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    table, start = (torch.from_numpy(a) for a in inputs("starts", 7, s=2))
    for body in pb.BODIES:
        with Ops() as ops:
            pb.launch_bisect(host_lib, table, start, body=body, iters=3)
        assert ops.seen and all(
            op.startswith("empty") or op in ("view", "_unsafe_view",
                                             "_reshape_alias")
            for op in ops.seen), (body, ops.seen)


# -- the wrapper, the tool, the bound, the library -----------------------


def test_wrappers_on_the_cpu_take_the_plain_version():
    before = pb.bisect_chain.launches
    table, start = (torch.from_numpy(a) for a in inputs("starts", 50, s=2))
    kept = (table.clone(), start.clone())
    for body in pb.BODIES:
        assert torch.equal(
            pb.bisect_chain(table, start, body=body, iters=9),
            pb.bisect_reference(table, start, body=body, iters=9))
    assert torch.equal(table, kept[0]) and torch.equal(start, kept[1])
    assert pb.bisect_chain.launches == before


BAD = {
    "dtype": lambda t, s: (t.long(), s),
    "rows": lambda t, s: (t[:-1], s),
    "start rows": lambda t, s: (t, s[:3]),
    "start lanes": lambda t, s: (t, s[:, :, :5]),
    "device": lambda t, s: (t, torch.zeros(s.shape, dtype=torch.int32,
                                           device="meta")),
}


@pytest.mark.parametrize("bad", list(BAD) + ["body", "iters"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    args = tuple(torch.from_numpy(a) for a in inputs("tool", 0))
    kw = {"body": "v4", "iters": 5}
    if bad in BAD:
        args = BAD[bad](*args)
    elif bad == "body":
        kw["body"] = "v6"
    else:
        kw["iters"] = -1
    with pytest.raises(ValueError):
        pb.bisect_chain(*args, **kw)


def test_tool_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """The tool's rows default to the card, and the command line stops
    without one; ``--device cpu`` runs the plain version, and the filter
    is the TPU tool's substring match."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr(probe_lane2d_bisect, "S", 1)
    for _, make in probe_lane2d_bisect.ROWS_OF_TOOL:
        with pytest.raises((RuntimeError, AssertionError)):
            make(None)
    with pytest.raises(SystemExit):
        probe_lane2d_bisect.main(probe_lane2d_bisect.ROWS_OF_TOOL, ["v2"],
                                 substring=True)
    rows = probe_rows.main(probe_lane2d_bisect.ROWS_OF_TOOL,
                           ["reduce", "--device", "cpu", "--seed", "1"],
                           substring=True)
    reduce = [n for n in NAMES if "reduce" in n]
    assert len(reduce) == 7  # v2max and w1, w3, w4 (no-reduce), w5-w7
    assert [(r["name"], r["input"]) for r in rows] == [
        (n, w) for n in reduce for w in ("tool", "seeded")]
    assert all(isinstance(r["checksum"], int) for r in rows)
    # the other tools keep their prefix filter
    assert probe_rows.main(probe_lane2d_bisect.ROWS_OF_TOOL,
                           ["2", "--device", "cpu"]) == []


def test_the_counts_behind_the_bound():
    """v4 is ops/probes.py's bit decode; each stage adds operations in the
    probe's order."""
    ops = {b: pb.body_ops(b) for b in pb.BODIES}
    assert ops["v4"] == ops["v5"] == probes.BITDECODE_OPS
    assert ops["v1"] < ops["v2"] < ops["v3"] < ops["v4"]
    assert ops["v2"] == ops["v2m"] == ops["v2bt"] < ops["v2max"]
    assert ops["w5"] == ops["w6"] == ops["w7"] and ops["w3"] < ops["w4"]
    assert ops["w1"] > ops["v4"]  # the column's 648 adds


def walked_rows(table, start, body, iters):
    """The rows ``tab[idx]`` each lane reads, one plain iteration at a
    time from the carried state and table: their count over the lanes."""
    seen = set()
    tab, st = table, start
    for _ in range(iters):
        _, got = pb.bisect_reference(tab, st, body=body, iters=1, full=True)
        tab, st = got["table"], got["state"]
        seen |= set(enumerate(st[0].reshape(-1).tolist()))
    return len(seen)


@pytest.mark.parametrize("iters", [0, 1, 32, 200])
def test_the_words_are_what_the_walk_reads(iters):
    """The bound counts the table rows this run reaches, not the column:
    for the bodies that read ``tab[idx]``, the count equals a walk of one
    plain iteration at a time, on the tool's input and on the seeded one.
    On the tool's input at its 32 iterations the climb reaches a new row
    every iteration (32 rows; it climbs 220 rows in all) and the step one
    row every 9 (4 rows: ``acc & 1`` is 1 once in acc's cycle of 9).
    Without ``full`` no table is written back."""
    S = 1
    table = torch.full((pb.ROWS, S, 128), 1024, dtype=torch.int32)
    start = torch.tensor(pb.INIT, dtype=torch.int32)[:, None, None].expand(
        4, S, 128).contiguous()
    rng = np.random.default_rng(5)
    seeded = (torch.from_numpy(rng.integers(-2**31, 2**31, table.shape,
                                            dtype=np.int64).astype(np.int32)),
              torch.from_numpy(probe_lane2d_bisect.seeded_start(
                  rng, tuple(start.shape))))
    fixed = {"column": pb.ROWS, "const_row": 1, "mask7_row": 1}
    for b in pb.BODIES:
        read = pb.STAGES[b][1]
        for xs in ((table, start), seeded):
            words = pb.body_words(*xs, body=b, iters=iters)
            if read in ("row", "max0"):
                rows = walked_rows(*xs, b, iters)
            else:
                rows = fixed.get(read, 0) * 128 if iters else 0
            assert words == rows / 128 + 9, b
    if iters == 32:
        assert pb.rows_read(table, start, body="v4", iters=32) == 32 * 128
        assert pb.rows_read(table, start, body="w5", iters=32) == 4 * 128


def test_the_bisect_library_has_its_own_cached_file(monkeypatch, tmp_path):
    """``bisect`` is built into a file of its own, keyed by its sources'
    hash (an edit of the shared ``probe_lane.cuh`` rebuilds it and
    ``probes`` alone), and a cached build is loaded without nvcc."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    lib = build.BISECT
    assert lib in build.LIBRARIES and lib.sources[0] == "probes_bisect.cu"
    path = tmp_path / f"liblzl_bisect-{build.source_hash(lib)}.so"
    path.write_bytes(b"")
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("nvcc called"))
    assert build.build_library(lib).path == str(path)
    others = {build.source_hash(x) for x in build.LIBRARIES if x is not lib}
    assert build.source_hash(lib) not in others


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("body", pb.BODIES)
def test_kernel_block_edges_on_card(body, cuda_device):
    """The host build's edge cases on the card: 130 lanes (a part-filled
    block) and 1 lane, full=True and full=False, 0, 1 and 37 iterations,
    starts that wrap idx before the clip and columns whose sums wrap
    uint32."""
    lib = pb._cuda_lib()
    for lanes in (130, 1):
        for i, kind in enumerate(("starts", "wraps")):
            table, start = (t.to(cuda_device)
                            for t in edge_inputs(kind, lanes, 40 + i))
            for iters in (0, 1, 37):
                kw = {"body": body, "iters": iters}
                want = pb.bisect_reference(table, start, full=True, **kw)
                got = pb.launch_bisect(lib, table, start, full=True, **kw)
                out = pb.launch_bisect(lib, table, start, **kw)
                torch.cuda.synchronize()
                assert_same(got, want)
                assert torch.equal(out, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernel_equals_plain_version_on_card(name, cuda_device):
    """The row on the tool's input and the seeded one (full-range table
    and starts), at 130 lanes too (a part-filled block), at 0, 1, 32 and
    500 iterations."""
    fn, args, _ = dict(probe_lane2d_bisect.ROWS_OF_TOOL)[name](cuda_device)
    before, runs = fn.wrapper.launches, 0
    seeded = fn.seeded_inputs(args, 71)
    table, start = seeded
    cut = (table.reshape(pb.ROWS, -1)[:, :130].contiguous(),
           start.reshape(4, -1)[:, :130].contiguous())
    for xs in (args, seeded, cut):
        for iters in (0, 1, 32, 500):
            got = fn(*xs, full=True, iters=iters)
            torch.cuda.synchronize()
            assert_same(got, fn.plain(*xs, full=True, iters=iters))
            runs += 1
    assert fn.wrapper.launches == before + runs
