"""The lane engine through the runtime: ``engine="cuda-lane"`` against the
JAX package's ``engine="tpu-lane"``.

``runtime.xz_decode`` and ``runtime.lzma2_decode`` with ``engine=
"cuda-lane", device="cpu"`` (the kernel's plain version) must give the
JAX package's bytes, or its error (type and message), and its
``stats.fallbacks``, on stdlib ``lzma`` archives of 128 KiB blocks (beyond
the ``cuda`` engine's 64 KiB bucket), on the port's ``tpu_profile``
archive, on a raw LZMA2 stream of one 80 KB segment, and on corrupt
versions of each (a payload byte flipped: the lane errs and both replay on
the host). Then the engine's rules: without a card and without ``device``
it raises; ``auto`` never picks it; ``cuda`` still sends a large-block
archive to ``native`` with its ``vmem-ineligible`` record;
``execute_plan`` names the first erring lane in plan order with the JAX
code, fills the JAX ``stats`` fields and runs its stages. Multi-process:
``xz_decode_multihost(engine="cuda-lane")`` in one process and in a gloo
group of two (``tests/test_torch_multihost.py``'s ranks), where a corrupt
block raises ``_KernelError`` on the rank that owns it. The data are
cheap to decode (text with long repeats), since the plain version runs
every lane's steps on the CPU. Tests marked ``cuda`` run the engine on a
card. The JAX package is imported only inside the tests that need it.
"""

import hashlib

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.ops import lane_decoder as ld
from lzma_rs_tpu_torch.parallel import multihost, runtime
from lzma_rs_tpu_torch.tools import corpus as corpus_mod
from lzma_rs_tpu_torch.utils import stats

from test_torch_kernel_hostbuild import text

CPU = torch.device("cpu")


def repeats(n: int, seed: int) -> bytes:
    """``n`` bytes of seeded text: 1 KiB pieces of a 2 KiB text, each copy
    with one byte changed, so long matches, reps and a few literals."""
    rng = np.random.default_rng(seed)
    base = text(2048, seed)
    out = bytearray()
    while len(out) < n:
        a = int(rng.integers(0, len(base) - 1024))
        piece = bytearray(base[a:a + 1024])
        piece[int(rng.integers(0, 1024))] = int(rng.integers(32, 127))
        out += piece
    return bytes(out[:n])


def flip_lane(x: bytes, plans, lane_no: int = 0) -> bytes:
    """``x`` with one byte flipped in the middle of a lane's first chunk."""
    lane = [lane for p in plans for lane in p.lanes][lane_no]
    b = bytearray(x)
    b[(lane.in_start[0] + lane.in_end[0]) // 2] ^= 0x5A
    return bytes(b)


def cases() -> dict:
    """name -> (kind, stream, decoded bytes or None for a corrupt one)."""
    d128 = repeats(128 * 1024 + 4096, 1)
    x128 = corpus_mod.stock_archive(d128, block_size=128 * 1024)
    dtpu = repeats(12_000, 2)
    xtpu = corpus_mod.tpu_archive(dtpu)
    d2 = repeats(80_000, 3)
    s2 = corpus_mod.raw_lzma2(d2)
    plan2, _ = runtime.plan_lzma2_stream(s2, 0, 0)
    return {
        "stock-128k": ("xz", x128, d128),
        "stock-128k-corrupt": ("xz", flip_lane(
            x128, runtime.plan_xz(x128)[0], 0), None),
        "tpu-profile": ("xz", xtpu, dtpu),
        "tpu-profile-corrupt": ("xz", flip_lane(
            xtpu, runtime.plan_xz(xtpu)[0], 1), None),
        "lzma2-80k": ("lzma2", s2, d2),
        "lzma2-80k-corrupt": ("lzma2", flip_lane(s2, [plan2]), None),
    }


CASES = cases()


def outcome(fn, st_mod, x, **kw):
    with st_mod.collect() as st:
        try:
            out = ["ok", hashlib.sha256(fn(x, **kw)).hexdigest()]
        except Exception as e:  # the outcome under test
            out = [type(e).__name__, str(e)]
    return out, list(st.fallbacks), st


@pytest.mark.parametrize("name", sorted(CASES))
def test_runtime_equals_tpu_lane(name):
    from lzma_rs_tpu.parallel import runtime as jrt
    from lzma_rs_tpu.utils import stats as jstats

    kind, x, data = CASES[name]
    fn, jfn = ((runtime.xz_decode, jrt.xz_decode) if kind == "xz"
               else (runtime.lzma2_decode, jrt.lzma2_decode))
    got, got_fb, st = outcome(fn, stats, x, engine="cuda-lane", device=CPU)
    want, want_fb, _ = outcome(jfn, jstats, x, engine="tpu-lane")
    assert got == want
    assert got_fb == want_fb
    if data is not None:
        assert got == ["ok", hashlib.sha256(data).hexdigest()]
        assert got_fb == [] and st.engine == "cpu-lane"
    else:
        assert len(got_fb) == 1 and got_fb[0].startswith(
            "host replay: lane error code ")


def test_large_lanes_are_beyond_the_cuda_bucket():
    plans = runtime.plan_xz(CASES["stock-128k"][1])[0]
    seg = max(lane.out_end[-1] - lane.seg_base for p in plans
              for lane in p.lanes)
    assert seg == 128 * 1024 > 65536


def test_without_a_card_the_engine_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = CASES["tpu-profile"][1]
    for fn in (runtime.xz_decode, multihost.xz_decode_multihost):
        with pytest.raises(RuntimeError, match="'cuda-lane' needs a CUDA"):
            fn(x, engine="cuda-lane")
    with pytest.raises(RuntimeError, match="'cuda-lane' needs a CUDA"):
        runtime.lzma2_decode(CASES["lzma2-80k"][1], engine="cuda-lane")


@pytest.mark.parametrize("name", ["stock-128k", "tpu-profile"])
def test_auto_never_picks_the_lane_engine(name, monkeypatch):
    monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_LANES", "1")
    monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_OUT", "1")
    plans = runtime.plan_xz(CASES[name][1])[0]
    with stats.collect():
        assert runtime._resolve_auto(plans, CPU) in ("cuda", "native")
    with stats.collect() as st:
        out = runtime.xz_decode(CASES[name][1], engine="auto", device=CPU)
    assert out == CASES[name][2] and st.engine in ("cpu", "native")


def test_cuda_still_sends_large_blocks_to_native():
    with stats.collect() as st:
        out = runtime.xz_decode(CASES["stock-128k"][1], engine="cuda",
                                device=CPU)
    assert out == CASES["stock-128k"][2]
    assert st.engine == "native"
    assert st.fallbacks == [
        "vmem-ineligible: segment 131072 B > window bucket 65536 B"]


def test_execute_plan_names_the_first_lane_in_plan_order():
    """Two corrupt lanes, the later one in plan order the bigger (the
    ``cuda`` engine's staging would sort it first): the error names the
    first in plan order, with the JAX kernel's code for it."""
    from lzma_rs_tpu.parallel import runtime as jrt

    sa = corpus_mod.raw_lzma2(repeats(3000, 5))
    sb = corpus_mod.raw_lzma2(repeats(9000, 6))
    blob = bytearray(sa + sb)
    for s_off, s in ((0, sa), (len(sa), sb)):
        blob[s_off + len(s) // 2] ^= 0x5A
    blob = bytes(blob)

    def plans_of(rt):
        pa, _ = rt.plan_lzma2_stream(blob, 0, 0)
        pb, _ = rt.plan_lzma2_stream(blob, len(sa), pa.total_out)
        return [pa, pb]

    plans = plans_of(runtime)
    lanes = [lane for p in plans for lane in p.lanes]
    assert len(lanes) == 2 and runtime._packed(lanes[1]) > \
        runtime._packed(lanes[0])
    with pytest.raises(runtime._KernelError) as got:
        runtime.execute_plan(blob, plans, CPU)
    with pytest.raises(jrt._KernelError) as want:
        jrt.execute_plan(blob, plans_of(jrt))
    assert (got.value.lane, got.value.code) == \
        (want.value.lane, want.value.code)
    assert got.value.lane == 0 and got.value.code != 0


def test_execute_plan_stats_and_stages():
    x, data = CASES["tpu-profile"][1], CASES["tpu-profile"][2]
    plans = runtime.plan_xz(x)[0]
    seen = []
    with stats.collect() as st, runtime.stage_hook(
            lambda name, start: start and seen.append(name)):
        out = runtime.execute_plan(x, plans, CPU)
    assert out == data
    lanes = [lane for p in plans for lane in p.lanes]
    assert st.engine == "cpu-lane" and st.lanes == len(lanes)
    assert st.chunks == sum(len(lane.in_start) for lane in lanes)
    assert st.packed_bytes == len(x) and st.unpacked_bytes == len(data)
    assert st.prefill_bytes == sum(n for p in plans for _, _, n in p.prefill)
    assert st.kernel_iters > 0 and st.launch_seconds > 0
    assert seen == ["lane_tables", "h2d", "decode_lanes", "d2h"]


def test_outputs_past_int32_are_refused():
    plan = runtime.DecodePlan(lanes=[], prefill=[], total_out=2**31)
    with pytest.raises(ValueError, match="int32"):
        runtime.lane_tables(b"", [plan])


def test_no_lanes_no_launch():
    with stats.collect() as st:
        assert runtime.execute_plan(b"", [], CPU) == b""
    assert st.lanes == 0 and st.kernel_iters == 0


def test_multihost_one_process():
    x, data = CASES["tpu-profile"][1], CASES["tpu-profile"][2]
    with stats.collect() as st:
        assert multihost.xz_decode_multihost(x, "cuda-lane", CPU) == data
    assert st.engine == "cpu-lane"


def two_block_archive(corrupt: bool) -> bytes:
    d = repeats(6000, 9)
    x = corpus_mod.tpu_archive(d, block_size=3000)
    if corrupt:  # both blocks, so that each rank raises before its gather
        plans = runtime.plan_xz(x)[0]
        x = flip_lane(flip_lane(x, plans, 0), plans, 1)
    return x


def test_multihost_two_ranks(tmp_path):
    """Two gloo ranks: the lane engine's waves give the JAX package's
    bytes and gathered waves; with both blocks corrupt, each rank raises
    ``_KernelError`` from its own wave (no rank waits in a collective)."""
    import test_torch_multihost as tm

    good, bad = two_block_archive(False), two_block_archive(True)
    jobs = [tm.job("lane-waves", None, "cuda-lane", wave_bytes=3000, x=good),
            tm.job("lane-corrupt", None, "cuda-lane", x=bad)]
    for j in jobs:
        j["archive"] = "small-512"  # unused: x is set
    ranks = tm.run_group(tmp_path, 2, [dict(j) for j in jobs])
    want = tm.expected(jobs[0], 2)
    codes = []
    for rank, res in enumerate(ranks):
        got = res["lane-waves"]
        assert got["out"] == want["out"] == tm.digest(repeats(6000, 9))
        assert got["gathered"] == want["gathered"]
        assert got["fallbacks"] == [] and got["engine"] == "cpu-lane"
        assert res["jax loaded"] == []
        err = res["lane-corrupt"]["out"]
        assert err[0] == "_KernelError" and err[1].startswith(
            "lane 0 error code ")
        codes.append(err[1])
    assert len(codes) == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_engine_on_card(name, cuda_device):
    kind, x, data = CASES[name]
    fn = runtime.xz_decode if kind == "xz" else runtime.lzma2_decode
    before = ld.decode_lanes.launches
    got, fb, st = outcome(fn, stats, x, engine="cuda-lane")
    assert ld.decode_lanes.launches == before + 1
    want, want_fb, _ = outcome(fn, stats, x, engine="cuda-lane", device=CPU)
    assert got == want and fb == want_fb
    if data is not None:
        assert st.engine == "cuda-lane"


def test_repeats_is_deterministic():
    assert repeats(5000, 4) == repeats(5000, 4) != repeats(5000, 5)
    assert len(repeats(5000, 4)) == 5000
