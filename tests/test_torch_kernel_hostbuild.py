"""The CUDA kernel's own source, built for the host, against the plain
PyTorch version.

``csrc/lzma_lane.cuh`` holds the kernel's per-lane decoder; g++ compiles it
(``-x c++ -DLZL_HOST_ENTRY``) into a small library, loaded with ctypes, that
runs the same decoder lane by lane on the CPU. It must match
``decode_segments_reference`` exactly: windows, err, outp and steps. This
checks the kernel's logic without a card; nothing on the main path loads
the host build.

This file also holds the segment-decoder cases (seeded numpy data through
stdlib ``lzma`` and the repo's encoder) and their staging, which
tests/test_torch_segment_decoder.py shares, and the on-card check of the
real kernel (marked ``cuda``). It imports only the port (no JAX, nothing
of ``lzma_rs_tpu``), so it runs on a machine without them.
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


# Each batch is one L=8 call, built on first use (nothing runs at import).
# An entry is a stream, or (stream, truncate): truncate = (chunk index, new
# in_end relative to in_start, or -n for n bytes off the end).
BATCH_NAMES = ("corrupt", "props", "structure")


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
    lib.lzl_decode_segments_host.restype = ctypes.c_int
    lib.lzl_decode_segments_host.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
    )
    return lib


def host_decode(lib, cfg, inbuf, win_init, *tables, max_steps=None):
    max_steps = max_steps or sd.default_max_steps(cfg)
    nprobs = prob_layout(cfg.NLIT).total
    win = win_init.clone()
    probs = torch.empty((cfg.L, nprobs), dtype=torch.uint16)
    err, outp, steps = (torch.empty(cfg.L, dtype=torch.int32)
                        for _ in range(3))
    lib.lzl_decode_segments_host(
        inbuf.data_ptr(), win.data_ptr(), probs.data_ptr(),
        *(t.data_ptr() for t in tables),
        err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
        cfg.L, cfg.W_IN, cfg.W, nprobs, cfg.NLIT, cfg.K, max_steps,
    )
    return win, err, outp, steps


@pytest.mark.parametrize("name", BATCH_NAMES)
def test_host_build_matches_reference(name, host_lib):
    cfg, tensors, seg_lens = port_inputs(name)
    got = host_decode(host_lib, cfg, *tensors)
    want = sd.decode_segments_reference(*tensors, config=cfg)
    for what, g, w in zip(("win", "err", "outp", "steps"), got, want):
        assert torch.equal(g, w), what
    if name != "corrupt":
        assert got[1][: len(seg_lens)].eq(0).all()
        assert got[2][: len(seg_lens)].tolist() == seg_lens


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
@pytest.mark.parametrize("name", BATCH_NAMES)
def test_kernel_matches_reference_on_card(name, cuda_device):
    cfg, tensors, _ = port_inputs(name, device=cuda_device)
    before = sd.decode_segments.launches
    got = sd.decode_segments(*tensors, config=cfg)
    torch.cuda.synchronize()
    assert sd.decode_segments.launches == before + 1
    want = sd.decode_segments_reference(*tensors, config=cfg)
    for what, g, w in zip(("win", "err", "outp", "steps"), got, want):
        assert torch.equal(g.cpu(), w.cpu()), what
