"""The port's runtime and public API against the JAX package's host engine
and stdlib ``lzma``.

The device path runs here on CPU tensors (``device=cpu``: the kernel's
plain PyTorch version) and must give what ``lzma_rs_tpu`` gives under
``LZMA_RS_TPU_BACKEND=native``: the same bytes, the same fallback reasons,
the same exception class name and message for a corrupt archive. Each
package is observed through its own stats collector and given its own
option and cursor objects. Data comes from a seeded numpy generator;
archives are small (1 KiB blocks) because the plain version advances
every lane one micro-op per iteration.
"""

import lzma as liblzma
import os
import struct
import subprocess
import sys

import pytest
import torch

import lzma_rs_tpu
import lzma_rs_tpu_torch
from lzma_rs_tpu.parallel import runtime as jax_runtime
from lzma_rs_tpu.utils import stats as jax_stats
from lzma_rs_tpu_torch.formats.lzma_header import read_header
from lzma_rs_tpu_torch.ops import build
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.parallel import runtime
from lzma_rs_tpu_torch.utils import stats
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.options import (
    CompressOptions,
    Options,
    WriteUnpackedSize,
)

from test_torch_kernel_hostbuild import text

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = text(65536, 0)


def native(fn, data, monkeypatch):
    """``lzma_rs_tpu.<fn>`` under the native backend: (output or
    exception, fallbacks)."""
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "native")
    with jax_stats.collect() as s:
        try:
            out = getattr(lzma_rs_tpu, fn)(data)
        except Exception as e:  # the parity object under test
            out = e
    monkeypatch.delenv("LZMA_RS_TPU_BACKEND")
    return out, s.fallbacks


def open_small_workload_gate(monkeypatch):
    monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_LANES", "1")
    monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_OUT", "1")


@pytest.mark.parametrize(
    "check,profile", [(1, True), (4, False), (10, False)],
    ids=["crc32-tpu_profile", "crc64", "sha256"],
)
def test_xz_device_path_matches_native_and_stdlib(check, profile,
                                                   monkeypatch):
    xz = lzma_rs_tpu.xz_compress(DATA, block_size=1024, check_method=check,
                                 tpu_profile=profile)
    before = sd.decode_segments.launches
    with stats.collect() as s:
        out = runtime.xz_decode(xz, engine="cuda", device=CPU)
    assert out == DATA
    assert out == liblzma.decompress(xz)
    assert out == native("xz_decompress", xz, monkeypatch)[0]
    assert s.engine == "cpu" and s.fallbacks == [] and s.lanes == 64
    assert sd.decode_segments.launches == before  # no kernel on the CPU


def test_lzma2_device_path_matches_native_and_stdlib(monkeypatch):
    parts = [text(1500, 1), text(1800, 2), text(1200, 3)]
    filt = [{"id": liblzma.FILTER_LZMA2, "preset": 6}]
    streams = [liblzma.compress(p, format=liblzma.FORMAT_RAW, filters=filt)
               for p in parts]
    # three dict-reset segments in one stream
    stream = streams[0][:-1] + streams[1][:-1] + streams[2]
    with stats.collect() as s:
        out = runtime.lzma2_decode(stream, engine="cuda", device=CPU)
    assert out == b"".join(parts)
    assert out == liblzma.decompress(stream, format=liblzma.FORMAT_RAW,
                                     filters=filt)
    assert out == native("lzma2_decompress", stream, monkeypatch)[0]
    assert s.lanes == 3 and s.fallbacks == []
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "native")
    assert lzma_rs_tpu_torch.lzma2_decompress(stream) == out


def test_raw_lzma_device_path():
    data = text(600, 4)
    raw = lzma_rs_tpu_torch.lzma_compress_with_options(
        data, CompressOptions(WriteUnpackedSize.write_to_header(len(data)))
    )
    cursor = ByteCursor(raw)
    params = read_header(cursor, Options())
    out = runtime.lzma_raw_decode_device(raw, cursor.pos, params, device=CPU)
    assert out == data == lzma_rs_tpu_torch.lzma_decompress(raw)
    assert out == liblzma.decompress(raw, format=liblzma.FORMAT_ALONE)


def test_raw_lzma_beyond_the_literal_tables_decodes_on_the_host():
    # lc=4: the kernel's largest literal bucket holds lc+lp <= 3
    data = text(3000, 7)
    filt = [{"id": liblzma.FILTER_LZMA1, "preset": 6, "lc": 4, "lp": 0,
             "pb": 2}]
    raw = bytearray(liblzma.compress(data, format=liblzma.FORMAT_ALONE,
                                     filters=filt))
    raw[5:13] = struct.pack("<Q", len(data))  # a known unpacked size
    raw = bytes(raw)
    cursor = ByteCursor(raw)
    params = read_header(cursor, Options())
    with stats.collect() as s:
        out = runtime.lzma_raw_decode_device(raw, cursor.pos, params,
                                             device=CPU)
    assert out == data == liblzma.decompress(raw, format=liblzma.FORMAT_ALONE)
    assert s.fallbacks == [
        "raw-lzma vmem-ineligible: lc+lp=4 > literal-table budget 3 (NLIT=8)"
    ]


def test_ineligible_archive_gives_the_same_fallback_reason(monkeypatch):
    # one 70,000-byte segment: beyond the 64 KiB window bucket
    data = text(70000, 5)
    xz = lzma_rs_tpu.xz_compress(data, block_size=1 << 20, check_method=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # both auto routers, with their small-workload gate opened
    open_small_workload_gate(monkeypatch)
    with stats.collect() as s:
        assert lzma_rs_tpu_torch.xz_decompress(xz) == data
    with jax_stats.collect() as j:
        assert lzma_rs_tpu.xz_decompress(xz) == data
    assert s.engine == j.engine == "native"
    assert s.fallbacks == j.fallbacks == [
        "auto->native: segment 70000 B > window bucket 65536 B"
    ]
    with stats.collect() as c:
        assert runtime.xz_decode(xz, engine="cuda", device=CPU) == data
    assert c.fallbacks == [
        "vmem-ineligible: segment 70000 B > window bucket 65536 B"
    ]


def test_corrupt_archive_gives_the_same_error(monkeypatch):
    xz = bytearray(lzma_rs_tpu.xz_compress(DATA, block_size=1024,
                                           check_method=4))
    plans = runtime.plan_xz(bytes(xz))[0]
    xz[plans[9].lanes[0].in_start[0] + 60] ^= 0x5A
    xz = bytes(xz)
    want, _ = native("xz_decompress", xz, monkeypatch)
    assert isinstance(want, Exception)
    with stats.collect() as s:
        with pytest.raises(Exception) as got:
            runtime.xz_decode(xz, engine="cuda", device=CPU)
    # the port's exception classes are its own: compare name and message
    assert (type(got.value).__name__, str(got.value)) == (
        type(want).__name__, str(want))
    assert any(f.startswith("host replay: lane error code")
               for f in s.fallbacks)


def test_choose_config_follows_the_jax_bucket_rules():
    for xz in (
        lzma_rs_tpu.xz_compress(DATA, check_method=1, tpu_profile=True),
        lzma_rs_tpu.xz_compress(DATA, block_size=16384, props=3 + 9 * 5 * 3),
    ):
        plans = runtime.plan_xz(xz)[0]
        cfg = runtime.choose_config(plans)
        ref = jax_runtime.choose_vmem_config(jax_runtime.plan_xz(xz)[0],
                                             for_eligibility=True)
        assert (cfg.W, cfg.W_IN, cfg.NLIT, cfg.K, cfg.NPS) == (
            ref.W, ref.W_IN, ref.NLIT, ref.K, ref.NPS)
        assert cfg.L == sum(len(p.lanes) for p in plans)


def gen1_plans(rt):
    """Plans (of the runtime module ``rt``) whose gen-1 buckets differ: the
    tpu_profile shape (8 KiB window, 4 KiB packed), 16 KiB blocks at lc=3,
    and a hand-made lane whose 3,000 packed bytes outgrow its 1,000-byte
    window bucket (a stored-chunk-free encoder never writes one, so only
    the rule is checked here)."""
    for xz in (
        lzma_rs_tpu.xz_compress(DATA, check_method=1, tpu_profile=True),
        lzma_rs_tpu.xz_compress(DATA, block_size=16384, props=3 + 9 * 5 * 3),
    ):
        yield rt.plan_xz(xz)[0]
    lane = rt.LanePlan(
        in_start=[0], in_end=[3000], out_start=[0], out_end=[1000],
        reset_state=[1], lc=[3], lp=[0], pb=[2], seg_base=0, size_known=1,
        dict_size=0xFFFFFFFF,
    )
    yield [rt.DecodePlan(lanes=[lane], prefill=[], total_out=1000)]


def test_choose_config_follows_the_jax_gen1_bucket_rules(monkeypatch):
    monkeypatch.setenv("LZMA_RS_TPU_VMEM_GEN", "1")
    buckets = []
    for plans, jax_plans in zip(gen1_plans(runtime),
                                gen1_plans(jax_runtime)):
        cfg = runtime.choose_config(plans)
        ref = jax_runtime.choose_vmem_config(jax_plans)
        assert type(ref).__name__ == "KernelConfig"  # the gen-1 config
        assert (cfg.W, cfg.W_IN, cfg.NLIT, cfg.K, cfg.NPS) == (
            ref.W, ref.W_IN, ref.NLIT, ref.K, ref.NPS)
        assert cfg.W == cfg.W_IN
        buckets.append(cfg.W)
        monkeypatch.delenv("LZMA_RS_TPU_VMEM_GEN")
        gen2 = runtime.choose_config(plans)
        monkeypatch.setenv("LZMA_RS_TPU_VMEM_GEN", "1")
        assert cfg.W == max(gen2.W, gen2.W_IN)
        assert (cfg.L, cfg.NLIT, cfg.K, cfg.NPS) == (
            gen2.L, gen2.NLIT, gen2.K, gen2.NPS)
    assert buckets == [8192, 16384, 4096]


def test_gen1_device_path_matches_the_jax_gen1_kernel(monkeypatch):
    from lzma_rs_tpu.ops.vmem_decoder import KernelConfig

    monkeypatch.setenv("LZMA_RS_TPU_VMEM_GEN", "1")
    data = DATA[:8192]
    xz = lzma_rs_tpu.xz_compress(data, block_size=1024, check_method=1)
    with stats.collect() as s:
        out = runtime.xz_decode(xz, engine="cuda", device=CPU)
    assert s.engine == "cpu" and s.fallbacks == [] and s.lanes == 8
    cfg = runtime.choose_config(runtime.plan_xz(xz)[0])
    assert cfg.W == cfg.W_IN == 2048
    jcfg = KernelConfig(L=8, W=cfg.W, W_IN=cfg.W_IN, NLIT=cfg.NLIT, K=cfg.K,
                        NPS=cfg.NPS)
    want = jax_runtime.execute_plan_vmem(
        xz, jax_runtime.plan_xz(xz)[0], config=jcfg, interpret=True)
    assert out == want == data


def test_auto_without_cuda_takes_native(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    open_small_workload_gate(monkeypatch)
    xz = lzma_rs_tpu.xz_compress(DATA, block_size=2048, check_method=1)
    with stats.collect() as s:
        assert lzma_rs_tpu_torch.xz_decompress(xz) == DATA
    assert s.engine == "native"
    assert s.fallbacks == []  # as the JAX router without a TPU


def test_auto_small_workload_matches_the_jax_router(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    xz = lzma_rs_tpu.xz_compress(DATA, block_size=2048, check_method=1)
    with stats.collect() as s:
        assert lzma_rs_tpu_torch.xz_decompress(xz) == DATA
    with jax_stats.collect() as j:
        assert lzma_rs_tpu.xz_decompress(xz) == DATA
    assert s.engine == j.engine == "native"
    assert s.fallbacks == j.fallbacks == [
        "auto->native: small workload (32 lanes, 65536 B out)"
    ]


def test_auto_without_the_kernel_build_takes_native(monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    open_small_workload_gate(monkeypatch)
    xz = lzma_rs_tpu.xz_compress(DATA, block_size=2048, check_method=1)
    build.unavailable.cache_clear()
    try:
        with stats.collect() as s:
            assert lzma_rs_tpu_torch.xz_decompress(xz) == DATA
        # the verdict is kept: a second decode does not try again
        with stats.collect() as s2:
            assert lzma_rs_tpu_torch.xz_decompress(xz) == DATA
    finally:
        build.unavailable.cache_clear()
    assert s.engine == s2.engine == "native"
    assert s.fallbacks == s2.fallbacks == [
        "auto->native: CUDA kernel unavailable: nvcc not found (PATH or "
        "/usr/local/cuda/bin)"
    ]


@pytest.mark.cuda
def test_auto_takes_the_card_for_a_large_archive(monkeypatch, tmp_path):
    """At the router's defaults (no calibration file), a 16 MiB
    tpu_profile archive is modeled faster on the card
    (``test_torch_calibration.py`` pins the crossing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(tmp_path / "none.json"))
    for _, env, _ in runtime._CAL_KEYS:
        monkeypatch.delenv(env, raising=False)
    data = text(16 << 20, 8)
    xz = lzma_rs_tpu.xz_compress(data, check_method=1, tpu_profile=True)
    before = sd.decode_segments.launches
    with stats.collect() as s:
        assert lzma_rs_tpu_torch.xz_decompress(xz) == data
    assert s.engine == "cuda" and s.fallbacks == [] and s.lanes >= 64
    assert sd.decode_segments.launches == before + 1


def test_cuda_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xz = lzma_rs_tpu.xz_compress(DATA[:4096], check_method=1)
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "cuda")
    for fn, arg in (
        (lzma_rs_tpu_torch.xz_decompress, xz),
        (lzma_rs_tpu_torch.lzma2_decompress, lzma_rs_tpu.lzma2_compress(b"x")),
        (lzma_rs_tpu_torch.lzma_decompress, lzma_rs_tpu.lzma_compress(b"x")),
    ):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fn(arg)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        runtime.xz_decode(xz, engine="cuda")


def test_unknown_backend_is_refused(monkeypatch):
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "tpu")
    with pytest.raises(ValueError, match="LZMA_RS_TPU_BACKEND"):
        lzma_rs_tpu_torch.xz_decompress(lzma_rs_tpu.xz_compress(b"x"))


def test_package_imports_no_jax():
    code = (
        "import sys, torch\n"
        "import lzma_rs_tpu_torch\n"
        "from lzma_rs_tpu_torch.parallel import runtime\n"
        "from lzma_rs_tpu_torch.ops import build, segment_decoder\n"
        "data = b'lane ' * 300\n"
        "xz = lzma_rs_tpu_torch.xz_compress(data, check_method=1)\n"
        "assert runtime.xz_decode(xz, engine='cuda',\n"
        "                         device=torch.device('cpu')) == data\n"
        "assert lzma_rs_tpu_torch.xz_decompress(xz) == data\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
