"""The CUDA kernel's own source, built for the host, against the plain
PyTorch version.

``csrc/lzma_lane.cuh`` holds the kernel's per-lane decoder; g++ compiles it
(``-x c++ -DLZL_HOST_ENTRY``) into a small library, loaded with ctypes, that
runs the same decoder lane by lane on the CPU: the decoder's build (a warp
a lane, played by one thread rank by rank: the refill and the match copies
with the card's index arithmetic) and the builds of the variants V0 (also
S3's), V4 and V5 (``ops/segment_variants.py``). Each must match
``decode_segments_reference`` exactly: windows, err, outp and steps, also
with budgets that stop a lane inside a copy or a literal and chunk ends
that cut a match. The copy split and the shared-memory sizes are checked
alone. This checks the kernel's logic without a card; nothing on the main
path loads the host build.

This file also holds the segment-decoder cases (seeded numpy data through
stdlib ``lzma`` and the repo's encoder) and their staging, which
tests/test_torch_segment_decoder.py shares, and the on-card checks of the
real kernel and its variants (marked ``cuda``). It imports only the port
(no JAX, nothing of ``lzma_rs_tpu``), so it runs on a machine without
them.
"""

import ctypes
import functools
import lzma as liblzma
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lzma_rs_tpu_torch.encode import lzma2_enc
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops import segment_variants as sv
from lzma_rs_tpu_torch.ops.lzma_consts import (
    SegmentConfig,
    pack_chunk_meta,
    prob_layout,
)
from lzma_rs_tpu_torch.parallel import runtime

CFG = SegmentConfig(L=8, W=4096, W_IN=4096, NLIT=8, K=4, NPS=16)
HEADER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "lzma_rs_tpu_torch", "csrc", "lzma_lane.cuh",
)


def text(n: int, seed: int) -> bytes:
    """Words of random letters from a seeded generator, drawn with
    rank-decaying weights: literals, matches and reps."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, size=int(k)))
             for k in rng.integers(2, 10, size=4000)]
    weights = 1.0 / (np.arange(len(vocab)) + 10.0)
    words = rng.choice(len(vocab), size=n // 3, p=weights / weights.sum())
    return b" ".join(vocab[i] for i in words)[:n]


def runs(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    parts = [bytes([int(b)]) * int(k)
             for b, k in zip(rng.integers(0, 256, 64), rng.integers(1, 90, 64))]
    return (b"".join(parts) + bytes(range(256)) * 4)[:n]


def raw(data: bytes, preset: int = 6, **props) -> bytes:
    filt = {"id": liblzma.FILTER_LZMA2, "preset": preset, **props}
    return liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=[filt])


def flip(stream: bytes, frac: float) -> bytes:
    """The stream with one payload byte (at ``frac`` of its length)
    changed."""
    s = bytearray(stream)
    s[int(len(s) * frac)] ^= 0x5A
    return bytes(s)


def stored_mid_segment() -> bytes:
    rnd = np.random.default_rng(3).integers(0, 256, 512, np.uint8).tobytes()
    data = text(512, 30) + rnd + text(512, 31)
    stream = lzma2_enc.lzma2_compress(data, level=6, chunk_size=512)
    plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
    assert plan.prefill and len(plan.lanes) == 1
    return stream


def periodic(periods, seed: int) -> bytes:
    """For each period p: a random p-byte pattern repeated over 120-700
    bytes, then a few random bytes. The encoder copies each run from p
    back (overlapping for p < the length) in matches of up to 273 bytes."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in periods:
        pat = rng.integers(0, 256, int(p), np.uint8).tobytes()
        n = int(rng.integers(120, 700))
        parts.append((pat * (n // p + 1))[:n])
        parts.append(rng.integers(0, 256, 3, np.uint8).tobytes())
    return b"".join(parts)


# Each batch is one L=8 call, built on first use (nothing runs at import).
# An entry is a stream, or (stream, truncate): truncate = (chunk index, new
# in_end relative to in_start, or -n for n bytes off the end).
BATCH_NAMES = ("corrupt", "props", "structure")
# Batches the host build and the card hold against the plain version
# beyond the ones tests/test_torch_segment_decoder.py shares: "overlap",
# copies from 1-40 bytes back of up to 273 bytes.
EXTRA_BATCHES = ("overlap",)


@functools.lru_cache(maxsize=None)
def batch(name: str) -> list:
    if name == "props":
        return [
            raw(text(2000, 1), preset=1),
            raw(text(2000, 2), preset=6),
            raw(text(2000, 3), preset=9),
            raw(text(1800, 4), lc=1, lp=2, pb=1),
            raw(text(1800, 5), lc=0, lp=0, pb=0),
            raw(text(1800, 6), lc=2, lp=1, pb=3),
            raw(text(1500, 7), lc=0, lp=3, pb=4),
            raw(runs(2000, 8)),
        ]
    if name == "structure":
        return [
            # three dict-reset segments in one stream (terminators dropped)
            raw(text(900, 10))[:-1] + raw(runs(900, 11))[:-1]
            + raw(text(900, 12)),
            # one segment of several LZMA chunks
            lzma2_enc.lzma2_compress(text(2000, 13), level=6,
                                     chunk_size=512),
            # a stored chunk in the middle of a segment (prefilled window)
            stored_mid_segment(),
            # the lc=0 distance-capped profile of xz_compress(tpu_profile)
            lzma2_enc.lzma2_compress(text(2000, 14), level=6, props=90,
                                     dist_cap=512),
        ]
    if name == "corrupt":
        return [
            flip(raw(text(1500, 20)), 0.1),
            flip(raw(text(1500, 21)), 0.5),
            flip(raw(text(1500, 22), lc=0, lp=0, pb=0), 0.8),
            flip(raw(runs(1500, 23)), 0.3),
            (raw(text(1500, 24)), (0, -1)),
            (raw(text(1500, 25)), (0, -40)),
            (raw(text(1500, 26)), (0, 4)),
            (lzma2_enc.lzma2_compress(text(1500, 27), level=6,
                                      chunk_size=512), (1, -8)),
        ]
    if name == "overlap":
        return [raw(periodic(range(1 + 5 * i, 6 + 5 * i), 40 + i))
                for i in range(8)]
    raise KeyError(name)


def stage(entries, cfg2):
    """Stage streams as lanes in the JAX kernel's layout (the staging of
    lzma_rs_tpu/parallel/runtime.py::_execute_plan_vmem) for a bucket with
    ``L, K, W, W_IN``. Returns the seven kernel inputs (numpy) and each
    lane's segment length."""
    L, K = cfg2.L, cfg2.K
    inbuf = np.zeros((L, cfg2.W_IN), np.uint8)
    win = np.zeros((L, cfg2.W), np.uint8)
    t = {k: np.zeros((L, K), np.int32)
         for k in ("is", "ie", "os", "oe", "rs", "lc", "lp", "pb", "v")}
    seg_lens = []
    i = 0
    for entry in entries:
        stream, cut = entry if isinstance(entry, tuple) else (entry, None)
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        src = np.frombuffer(stream, np.uint8)
        for lane in plan.lanes:
            seg_len = lane.out_end[-1] - lane.seg_base
            seg_lens.append(seg_len)
            for s_off, d_off, n in plan.prefill:
                if lane.seg_base <= d_off < lane.seg_base + seg_len:
                    d = d_off - lane.seg_base
                    win[i, d:d + n] = src[s_off:s_off + n]
            cum = 0
            for j, (a, b) in enumerate(zip(lane.in_start, lane.in_end)):
                inbuf[i, cum:cum + b - a] = src[a:b]
                t["is"][i, j] = cum
                cum += b - a
                t["ie"][i, j] = cum
                t["os"][i, j] = lane.out_start[j] - lane.seg_base
                t["oe"][i, j] = lane.out_end[j] - lane.seg_base
                t["rs"][i, j] = lane.reset_state[j]
                t["lc"][i, j] = lane.lc[j]
                t["lp"][i, j] = lane.lp[j]
                t["pb"][i, j] = lane.pb[j]
            t["v"][i, : len(lane.in_start)] = 1
            if cut is not None:
                j, new = cut
                t["ie"][i, j] = (t["ie"][i, j] + new if new < 0
                                 else t["is"][i, j] + new)
            i += 1
    assert i <= L
    meta = pack_chunk_meta(t["rs"], t["lc"], t["lp"], t["pb"], t["v"])

    def words(a):
        return np.ascontiguousarray(a.view("<i4").T)

    args = (words(inbuf), words(win)) + tuple(
        np.ascontiguousarray(t[k].T) for k in ("is", "ie", "os", "oe")
    ) + (np.ascontiguousarray(meta.T),)
    return args, seg_lens


def port_inputs(name, device=None):
    args, seg_lens = stage(batch(name), CFG)
    cfg, *tensors = sd.from_jax_layout(CFG, *args, device=device)
    return cfg, tensors, seg_lens


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = str(tmp_path_factory.mktemp("lzl") / "liblzl_host.so")
    subprocess.run(
        [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
         "-Wall", "-Werror", "-DLZL_HOST_ENTRY", HEADER, "-o", so],
        check=True, capture_output=True, timeout=120,
    )
    lib = ctypes.CDLL(so)
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.lzl_decode_segments_host.restype = ci
    lib.lzl_decode_segments_host.argtypes = [vp] * 11 + [ci] * 8
    lib.lzl_match_copy_host.restype = ci
    lib.lzl_match_copy_host.argtypes = [vp] + [ci] * 7 + [vp]
    lib.lzl_probs_bytes_host.restype = ci
    lib.lzl_probs_bytes_host.argtypes = [ci]
    return lib


# The host build's decoder builds (lzl_decode_segments_host's code): the
# decoder (a warp a lane; V1-V3 differ only in placement, which the host
# build does not model) and the variants that change the code (S3 runs
# V0's: a thread a lane, one byte copied a step).
DECODER = 1
CODES = {"V0": 0, "V4": 4, "V5": 5}


def host_decode(lib, cfg, inbuf, win_init, *tables, max_steps=None,
                code=DECODER):
    max_steps = max_steps or sd.default_max_steps(cfg)
    nprobs = prob_layout(cfg.NLIT).total
    win = win_init.clone()
    probs = torch.empty((cfg.L, nprobs), dtype=torch.uint16)
    err, outp, steps = (torch.empty(cfg.L, dtype=torch.int32)
                        for _ in range(3))
    rc = lib.lzl_decode_segments_host(
        inbuf.data_ptr(), win.data_ptr(), probs.data_ptr(),
        *(t.data_ptr() for t in tables),
        err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
        cfg.L, cfg.W_IN, cfg.W, nprobs, cfg.NLIT, cfg.K, max_steps, code,
    )
    assert rc == 0
    return win, err, outp, steps


def assert_same(got, want, where=""):
    for what, g, w in zip(("win", "err", "outp", "steps"), got, want):
        assert torch.equal(g, w), f"{where} {what}"


@functools.lru_cache(maxsize=None)
def reference(name, max_steps=None):
    """The plain version's outputs on a batch (computed once a budget)."""
    cfg, tensors, _ = port_inputs(name)
    return sd.decode_segments_reference(*tensors, config=cfg,
                                        max_steps=max_steps)


@pytest.mark.parametrize("name", BATCH_NAMES + EXTRA_BATCHES)
def test_host_build_matches_reference(name, host_lib):
    cfg, tensors, seg_lens = port_inputs(name)
    got = host_decode(host_lib, cfg, *tensors)
    assert_same(got, reference(name))
    if name != "corrupt":
        assert got[1][: len(seg_lens)].eq(0).all()
        assert got[2][: len(seg_lens)].tolist() == seg_lens


@pytest.mark.parametrize("name", BATCH_NAMES + EXTRA_BATCHES)
@pytest.mark.parametrize("variant", sorted(CODES))
def test_host_build_variants_match_reference(variant, name, host_lib):
    """The variants whose code differs from the decoder's (a thread a lane
    copying a byte a step; one thread copying; the input look-ahead)
    compute the same function."""
    cfg, tensors, _ = port_inputs(name)
    got = host_decode(host_lib, cfg, *tensors, code=CODES[variant])
    assert_same(got, reference(name), variant)


def outp_curve(lib, cfg, tensors, n):
    """Each lane's outp after a budget of b steps, b = 0..n-1, by the host
    build: [n, L]."""
    return np.array([host_decode(lib, cfg, *tensors, max_steps=b)[2].numpy()
                     if b else np.zeros(cfg.L, np.int32)
                     for b in range(n)])


def copy_budgets(curve):
    """Budgets that stop some lane at each kind of point: just before a
    copy's first byte, after a copy's first byte, inside a copy, on a copy's
    last byte, and inside a literal. A step that writes a byte is a copy's
    byte or a literal's last bit; two such steps in a row are one copy's.
    Returns {kind: budget}, the smallest budget of each kind."""
    d = np.diff(curve, axis=0)  # d[b - 1]: bytes step b wrote
    wrote = d > 0
    kinds = {}
    for b in range(2, len(d) - 1):
        nxt, cur, prev = wrote[b], wrote[b - 1], wrote[b - 2]
        for kind, hit in (
            ("before a copy", ~cur & nxt & wrote[b + 1]),
            ("first byte", ~prev & cur & nxt),
            ("inside a copy", prev & cur & nxt),
            ("last byte", prev & cur & ~nxt),
            ("inside a literal", ~prev & ~cur & ~nxt),
        ):
            if hit.any() and kind not in kinds:
                kinds[kind] = b
    return kinds


@pytest.mark.parametrize("name", ("props", "overlap"))
def test_host_build_budget_inside_copies(name, host_lib):
    """Budgets that stop lanes just before, inside and at the end of a
    match copy, and inside a literal: outp, steps and ERR_STEP_CAP as the
    plain version's, one byte a step, for the decoder and every variant."""
    cfg, tensors, _ = port_inputs(name)
    kinds = copy_budgets(outp_curve(host_lib, cfg, tensors, 1200))
    assert set(kinds) == {"before a copy", "first byte", "inside a copy",
                          "last byte", "inside a literal"}, kinds
    for kind, b in sorted(kinds.items()):
        want = reference(name, b)
        assert want[1].eq(1).any() and want[3].max() == b
        for code in (DECODER, *CODES.values()):
            got = host_decode(host_lib, cfg, *tensors, max_steps=b,
                              code=code)
            assert_same(got, want, f"{kind} (budget {b}, code {code})")


@pytest.mark.parametrize("name", ("props", "overlap"))
def test_host_build_chunk_end_cuts_a_match(name, host_lib):
    """Each lane's chunk ends inside a match copy: ERR_SIZE after the
    bytes left in the chunk and one more step, as the plain version says,
    for the decoder and every variant."""
    cfg, tensors, _ = port_inputs(name)
    curve = outp_curve(host_lib, cfg, tensors, 1200)
    wrote = np.diff(curve, axis=0) > 0
    inside = wrote[:-2] & wrote[1:-1] & wrote[2:]  # steps b+1..b+3 copy
    out_end = tensors[5].clone()
    cut = []
    for lane in range(cfg.L):
        hits = np.nonzero(inside[:, lane])[0]
        if hits.size and (int(tensors[6][lane, 1]) >> 12) & 1 == 0:
            out_end[lane, 0] = int(curve[hits[0] + 2, lane])  # mid-copy
            cut.append(lane)
    assert len(cut) >= 4, cut
    cut_tensors = tensors[:5] + [out_end] + tensors[6:]
    want = sd.decode_segments_reference(*cut_tensors, config=cfg)
    assert want[1][cut].eq(4).all()  # ERR_SIZE
    assert torch.equal(want[2][cut], out_end[cut, 0])
    for code in (DECODER, *CODES.values()):
        got = host_decode(host_lib, cfg, *cut_tensors, code=code)
        assert_same(got, want, f"code {code}")


def byte_loop_copy(win, outp, outend, dist, length, steps, max_steps):
    """A match copy as the lockstep decoder runs it: for each byte one step
    (ERR_STEP_CAP once the budget is spent), then the chunk-end test
    (ERR_SIZE), then the byte."""
    err = 0
    for _ in range(length):
        if steps >= max_steps:
            err = 1
            break
        steps += 1
        if outp >= outend:
            err = 4
            break
        win[outp] = win[outp - dist]
        outp += 1
    return outp, steps, err


@pytest.mark.parametrize("branch", ("whole", "budget", "chunk end"))
def test_copy_split_matches_byte_loop(branch, host_lib):
    """The decoder's copy (split_copy, then 32 ranks' copy_rank, in either
    order: no rank may read a byte another writes) against a byte-by-byte
    loop: every distance 1-40 and 97, lengths 1-273, with the budget or the
    chunk's end before, at and inside the copy."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, 1024, np.uint8)
    res = (ctypes.c_int32 * 3)()
    n_cases = 0
    for dist in list(range(1, 41)) + [97]:
        for length in (1, 2, 5, 31, 32, 33, 64, 100, 273):
            outp = 300
            if branch == "whole":
                limits = [(length + extra, length + extra2)
                          for extra in (0, 3) for extra2 in (0, 5)]
            elif branch == "budget":  # steps left s <= bytes left o, s < len
                limits = [(s, s + extra) for s in range(length)
                          for extra in (0, 2)][:12]
            else:  # bytes left o < steps left s, o < len
                limits = [(o + extra, o) for o in range(length)
                          for extra in (1, 4)][:12]
            for s_left, o_left in limits:
                steps, max_steps = 1000, 1000 + s_left
                outend = outp + o_left
                want = base.copy()
                w = byte_loop_copy(want, outp, outend, dist, length, steps,
                                   max_steps)
                for reverse in (0, 1):  # the ranks in either order
                    got = base.copy()
                    host_lib.lzl_match_copy_host(
                        got.ctypes.data, outp, outend, dist, length, steps,
                        max_steps, reverse, res)
                    case = (dist, length, s_left, o_left, reverse)
                    assert tuple(res) == w, case
                    assert np.array_equal(got, want), case
                assert (w[2] == 0) == (branch == "whole")
                n_cases += 1
    assert n_cases > 1000


@pytest.mark.parametrize("nlit", (1, 2, 4, 8))
def test_shared_memory_fits_every_bucket(nlit, host_lib):
    """Every bucket choose_config can return (W and W_IN 2-64 KiB, NLIT
    1-8) fits one block's shared memory: the table (the header's size) and
    the window."""
    assert sd.probs_bytes(nlit) == host_lib.lzl_probs_bytes_host(nlit)
    assert sd.probs_bytes(nlit) % 16 == 0
    assert 0 <= sd.probs_bytes(nlit) - 2 * prob_layout(nlit).total < 16
    for w in (2048 << i for i in range(6)):
        for w_in in (2048 << i for i in range(6)):
            cfg = SegmentConfig(L=1, W=w, W_IN=w_in, NLIT=nlit)
            need = sd.smem_bytes(cfg)
            assert need == sd.probs_bytes(nlit) + w <= 232_448
            assert sd.check_fits(cfg) == need
            assert sd.lanes_per_sm(cfg) >= 2
            for name in sv.VARIANTS:
                assert sv.smem_bytes(name, cfg) <= need


@pytest.mark.parametrize("name", sorted(sv.VARIANTS))
def test_variant_shared_memory(name):
    """Each variant's shared memory a block at (a)'s and (b)'s buckets: the
    table where it is shared, then the window where it is shared; with
    both shared, what the decoder takes."""
    v = sv.VARIANTS[name]
    for cfg in (SegmentConfig(L=1954, W=8192, W_IN=4096, NLIT=1),
                SegmentConfig(L=245, W=65536, W_IN=32768, NLIT=8)):
        want = (sd.probs_bytes(cfg.NLIT) * v.probs_shared
                + cfg.W * v.win_shared)
        assert sv.smem_bytes(name, cfg) == want
        assert ((want == sd.smem_bytes(cfg))
                == (v.probs_shared and v.win_shared))


@pytest.mark.parametrize("name", sorted(sv.VARIANTS))
def test_variant_on_cpu_is_the_plain_version(name):
    """On CPU tensors a variant's wrapper runs the decoder's plain version
    and launches nothing."""
    cfg, tensors, _ = port_inputs("props")
    before = sv.decode_variant.launches
    got = sv.decode_variant(name, *tensors, config=cfg, max_steps=700)
    assert sv.decode_variant.launches == before
    assert_same(got, reference("props", 700), name)


def test_archive_buckets_are_resident_in_one_wave():
    """(a)'s bucket (8 KiB windows, NLIT 1) leaves 16 lanes an SM, (b)'s
    (64 KiB, NLIT 8) 2: all 1,954 and 245 lanes on the 132 SMs at once."""
    a = SegmentConfig(L=1954, W=8192, W_IN=4096, NLIT=1)
    b = SegmentConfig(L=245, W=65536, W_IN=32768, NLIT=8)
    assert (sd.smem_bytes(a), sd.smem_bytes(b)) == (13_424, 81_520)
    assert (sd.lanes_per_sm(a), sd.lanes_per_sm(b)) == (16, 2)
    assert 132 * sd.lanes_per_sm(a) >= a.L and 132 * sd.lanes_per_sm(b) >= b.L


def test_a_bucket_beyond_shared_memory_raises():
    with pytest.raises(ValueError, match="shared memory"):
        sd.check_fits(SegmentConfig(L=1, W=1 << 18, W_IN=4096, NLIT=1))
    with pytest.raises(ValueError, match="shared memory"):
        sd.check_fits(SegmentConfig(L=1, W=232_448 - 4000, W_IN=4096,
                                    NLIT=8))


def test_host_build_step_cap(host_lib):
    cfg, tensors, _ = port_inputs("props")
    got = host_decode(host_lib, cfg, *tensors, max_steps=700)
    want = sd.decode_segments_reference(*tensors, config=cfg, max_steps=700)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].tolist() == [1] * 8 and got[3].tolist() == [700] * 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", BATCH_NAMES + EXTRA_BATCHES)
def test_kernel_matches_reference_on_card(name, cuda_device):
    cfg, tensors, _ = port_inputs(name, device=cuda_device)
    before = sd.decode_segments.launches
    got = sd.decode_segments(*tensors, config=cfg)
    torch.cuda.synchronize()
    assert sd.decode_segments.launches == before + 1
    want = sd.decode_segments_reference(*tensors, config=cfg)
    for what, g, w in zip(("win", "err", "outp", "steps"), got, want):
        assert torch.equal(g.cpu(), w.cpu()), what


@pytest.mark.cuda
@pytest.mark.parametrize("name", BATCH_NAMES + EXTRA_BATCHES)
@pytest.mark.parametrize("variant", sorted(sv.VARIANTS))
def test_variant_matches_reference_on_card(variant, name, cuda_device):
    cfg, tensors, _ = port_inputs(name, device=cuda_device)
    before = sv.decode_variant.launches
    got = sv.decode_variant(variant, *tensors, config=cfg)
    torch.cuda.synchronize()
    assert sv.decode_variant.launches == before + 1
    assert_same([g.cpu() for g in got], reference(name), variant)
