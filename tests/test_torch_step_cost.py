"""The decoder's step-cost builds (spin mode and the ablations) and the two
step-cost tools.

``csrc/lzma_lane.cuh``'s option bits, built for the host by g++ (codes 16-22
of ``lzl_decode_segments_host``, ``ops/build.py::load_host``), against the
plain version ``ops/step_cost.py::decode_ablated_reference`` exactly: win,
err, outp, steps and each lane's restarts, on valid and corrupt lanes at a
small bucket (L 8, W 4096), with budgets that restart lanes many times.
With no bits set the plain version is the decoder's. Spin runs every lane
to its budget and restarts a clean lane once a full pass. The tools'
arguments and RESULT lines go through the CPU path of the ops function;
both tools raise without a card. The ``cuda`` tests hold each case's
kernel against its plain version on the card.

It imports only the port (no JAX), so its ``cuda`` tests run on the card.
"""

import functools
import math
import re
import shutil

import pytest
import torch

from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops import step_cost as stc
from lzma_rs_tpu_torch.ops.lzma_consts import prob_layout
from lzma_rs_tpu_torch.tools import probe_step_cost, probe_step_cost2

from test_torch_kernel_hostbuild import (
    assert_same,
    host_decode,
    port_inputs,
    reference,
)

CASES = sorted(stc.ABLATIONS)
BUDGET = 1500  # below the longest lanes of both batches: some lanes
               # restart, the longest never finishes a pass


@pytest.fixture(scope="module")
def host_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    from lzma_rs_tpu_torch.ops import build

    return build.load_host()


def host_ablated(lib, case, cfg, inbuf, win_init, *tables, max_steps):
    """Case ``case`` through the host build (code 16 + its number)."""
    nprobs = prob_layout(cfg.NLIT).total
    win = win_init.clone()
    probs = torch.empty((cfg.L, nprobs), dtype=torch.uint16)
    err, outp, steps, restarts = (torch.empty(cfg.L, dtype=torch.int32)
                                  for _ in range(4))
    rc = lib.lzl_decode_segments_host(
        inbuf.data_ptr(), win.data_ptr(), probs.data_ptr(),
        *(t.data_ptr() for t in tables),
        err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
        restarts.data_ptr(), cfg.L, cfg.W_IN, cfg.W, nprobs, cfg.NLIT,
        cfg.K, max_steps, 16 + stc.ABLATIONS[case].code,
    )
    assert rc == 0
    return win, err, outp, steps, restarts


@functools.lru_cache(maxsize=None)
def plain(case, name, max_steps=BUDGET):
    cfg, tensors, _ = port_inputs(name)
    return stc.decode_ablated_reference(case, *tensors, config=cfg,
                                        max_steps=max_steps)


def assert_same5(got, want, where=""):
    for what, g, w in zip(("win", "err", "outp", "steps", "restarts"), got,
                          want):
        assert torch.equal(g, w), f"{where} {what}"


def test_the_cases_are_the_jax_tools_cases():
    """Every JAX case but the ring's flush is a build; the ablations'
    bits are the header's, each case spins, and the last holds all five."""
    assert list(probe_step_cost.CASES) == [
        "spin", "spin,probread", "spin,probread,probwrite", "spin,port",
        "spin,winwrite", "spin,refill", "spin,flush",
        "spin,probread,probwrite,port,winwrite,refill"]
    assert set(probe_step_cost.CASES) == set(stc.ABLATIONS) | set(
        stc.NOT_PORTED)
    assert sorted(a.code for a in stc.ABLATIONS.values()) == list(range(7))
    assert all(a.opts & sd.SPIN for a in stc.ABLATIONS.values())
    bits = {"probread": sd.NO_PROB_READ, "probwrite": sd.NO_PROB_WRITE,
            "port": sd.NO_PORT, "winwrite": sd.NO_WIN_WRITE,
            "refill": sd.NO_INPUT}
    for case, a in stc.ABLATIONS.items():
        want = sd.SPIN
        for part in case.split(",")[1:]:
            want |= bits[part]
        assert a.opts == want, case


@pytest.mark.parametrize("name", ("corrupt", "structure"))
@pytest.mark.parametrize("case", CASES)
def test_host_build_matches_the_plain_version(case, name, host_lib):
    """Each case's code (the decoder with the case's bits) equals its plain
    version exactly, restarts included; every lane runs the budget and
    ends with ERR_STEP_CAP."""
    cfg, tensors, _ = port_inputs(name)
    want = plain(case, name)
    got = host_ablated(host_lib, case, cfg, *tensors, max_steps=BUDGET)
    assert_same5(got, want, case)
    assert want[3].eq(BUDGET).all() and want[1].eq(1).all()
    # the corrupt lanes' errors and the short lanes' ends restart them
    assert want[4].gt(0).any()


def test_no_bits_is_the_decoders_plain_version():
    """The shared lockstep code with no option bits is
    decode_segments_reference, with no restarts."""
    cfg, tensors, _ = port_inputs("props")
    got = sd.lockstep_reference(*tensors, config=cfg, max_steps=700, opts=0)
    assert_same(got[:4], reference("props", 700))
    assert got[4].eq(0).all()


def test_spin_before_any_lane_ends_is_the_decoder(host_lib):
    """At a budget below every lane's end, spin is the decoder itself: the
    same windows, outp and steps, and no restarts."""
    cfg, tensors, _ = port_inputs("props")
    want = reference("props", 700)
    assert want[3].eq(700).all()
    got = host_ablated(host_lib, "spin", cfg, *tensors, max_steps=700)
    assert_same(got[:4], want)
    assert got[4].eq(0).all()


@pytest.mark.parametrize("budget", (3000, 7001))
def test_spin_restarts_a_clean_lane_once_a_pass(budget, host_lib):
    """A clean lane's pass costs the decoder's steps to its end; under spin
    it restarts ceil(budget / pass) - 1 times and ends at the budget with
    ERR_STEP_CAP (code 1, which ERR_EOF shares), at the outp that many
    steps into its last pass give."""
    cfg, tensors, seg_lens = port_inputs("structure")
    full = host_decode(host_lib, cfg, *tensors)
    passes = full[3].long()
    got = host_ablated(host_lib, "spin", cfg, *tensors, max_steps=budget)
    assert got[3].eq(budget).all() and got[1].eq(1).all()
    for lane in range(len(seg_lens)):  # the lanes that hold a segment
        n = int(passes[lane])
        assert int(got[4][lane]) == math.ceil(budget / n) - 1, lane
        left = budget - (math.ceil(budget / n) - 1) * n
        part = host_decode(host_lib, cfg, *tensors, max_steps=left)
        assert int(got[2][lane]) == int(part[2][lane]), lane
    # an empty lane (no chunk) restarts on every step but the last
    empty = [i for i in range(cfg.L) if i >= len(seg_lens)]
    assert empty and all(int(got[4][i]) == budget - 1 for i in empty)


@pytest.mark.parametrize("case", CASES)
def test_the_wrapper_on_cpu_is_the_plain_version(case):
    cfg, tensors, _ = port_inputs("corrupt")
    before = stc.decode_ablated.launches
    got = stc.decode_ablated(case, *tensors, config=cfg, max_steps=300)
    assert stc.decode_ablated.launches == before
    assert_same5(got, plain(case, "corrupt", 300), case)


RESULT = re.compile(
    r"^RESULT (\S+) (\d+\.\d{4}) us/step \((\d+) steps(, \d+\.\d{3} ms/call)?"
    r"\); cycles not measured \(cpu\); (\d+) restarts \((\d+\.\d{3}) a lane"
    r" per 1000 steps\)$")


@pytest.mark.parametrize("tool,chained", ((probe_step_cost, False),
                                          (probe_step_cost2, True)))
def test_the_tools_print_a_result_for_every_case(tool, chained, capsys,
                                                 monkeypatch):
    """Positional L W RING NLIT NPS UNROLL, then --device: seven timed
    RESULT lines (us and, off the card, no cycles a step; gen-2's with ms
    a call) and the flush case as not applicable. The plain versions run
    40 steps a lane here, not the tools' 4,096."""
    monkeypatch.setattr(probe_step_cost, "STEPS", 40)
    results = tool.main(["3", "4096", "1024", "1", "4", "4", "--device",
                         "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cpu: L=3 W=4096 W_IN=4096 NLIT=1 NPS=4 ")
    assert "RING=1024, UNROLL=4: no counterpart" in out[0]
    lines = [ln for ln in out if ln.startswith("RESULT ")]
    assert len(lines) == 8
    assert lines[6] == ("RESULT spin,flush " + stc.NOT_PORTED["spin,flush"])
    timed = [RESULT.match(ln) for ln in lines[:6] + lines[7:]]
    assert all(timed), lines
    assert [m.group(1) for m in timed] == [r.case for r in results] == [
        c for c in probe_step_cost.CASES if c in stc.ABLATIONS]
    assert all(bool(m.group(4)) == chained for m in timed)
    assert all(m.group(3) == "40" and r.steps == 40 and r.cycles_per_step
               is None for m, r in zip(timed, results))


def test_the_tools_default_arguments():
    a = probe_step_cost.parse([], 256)
    assert (a.L, a.W, a.RING, a.NLIT, a.NPS, a.UNROLL, a.device) == (
        256, 8192, 2048, 1, 4, 2, None)
    assert probe_step_cost.STEPS == 4096
    assert probe_step_cost.parse(["1024"], 256).L == 1024


@pytest.mark.parametrize("tool", (probe_step_cost, probe_step_cost2))
def test_the_tools_raise_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tool.main(["2", "4096"])


def test_nothing_of_the_port_reads_the_jax_ablation_switch():
    """The ablations are builds: no module of the port reads
    ``LZMA_RS_TPU_ABLATE`` (the JAX kernel's switch, read at import), and
    its C++ and CUDA sources name it only in the comments that say what
    they replace."""
    import ast
    import os

    port = os.path.dirname(os.path.dirname(stc.__file__))
    found = []
    for root, dirs, names in os.walk(port):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for n in names:
            path = os.path.join(root, n)
            if n.endswith(".py"):
                with open(path) as f:
                    tree = ast.parse(f.read())
                found += [path for node in ast.walk(tree)
                          if isinstance(node, ast.Constant)
                          and node.value == "LZMA_RS_TPU_ABLATE"]
            elif n.endswith((".cu", ".cuh", ".cpp")):
                with open(path) as f:
                    if "ABLATE" in f.read().replace(
                            "LZMA_RS_TPU_ABLATE switches", ""):
                        found.append(path)
    assert found == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("corrupt", "structure"))
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_the_plain_version_on_card(case, name, cuda_device):
    cfg, tensors, _ = port_inputs(name, device=cuda_device)
    before = stc.decode_ablated.launches
    got = stc.decode_ablated(case, *tensors, config=cfg, max_steps=BUDGET)
    torch.cuda.synchronize()
    assert stc.decode_ablated.launches == before + 1
    assert_same5([g.cpu() for g in got], plain(case, name), case)
    assert stc.ablated_occupancy(case, cfg) >= 1
