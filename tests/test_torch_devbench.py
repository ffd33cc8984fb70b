"""The port's measurement modules on the CPU: ``parallel/devbench.py``
against the JAX package's staging, the runtime's stage helpers against
``execute_plan_device``, the stage breakdown
(``tools/probe_vmem2_time.py``) and the timeline
(``tools/profile_pipeline.py``).

Timing paths run here only where a test asks for the CPU (``device="cpu"``:
the kernel's plain version, labelled ``cpu``); without that they must
raise. Archives are small (1 KiB blocks) because the plain version
advances every lane one micro-op per iteration. Tests marked ``cuda``
decide inside the test whether there is a card.
"""

import gc
import json
import os

import numpy as np
import pytest
import torch

import lzma_rs_tpu
from lzma_rs_tpu.parallel import devbench as jax_devbench
from lzma_rs_tpu_torch.parallel import devbench, runtime
from lzma_rs_tpu_torch.tools import corpus
from lzma_rs_tpu_torch.tools import probe_vmem2_time as pv
from lzma_rs_tpu_torch.tools import profile_pipeline as pp

from test_torch_kernel_hostbuild import text

CPU = torch.device("cpu")
# every stage the main path names, in the order it starts them
STAGE_ORDER = ["xz_decode", "plan_xz", "stage_plans", "slabs", "h2d",
               "decode_segments", "d2h", "placement", "check_blocks",
               "check_footer"]


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("L,K", [(8, 4), (6, 8)], ids=["padded", "exact"])
def test_stage_first_batch_equals_the_jax_staging(L, K):
    from lzma_rs_tpu.ops.vmem2_decoder import KernelConfig2

    data = text(12000, 21)
    arch = lzma_rs_tpu.xz_compress(data, block_size=2048, tpu_profile=True,
                                   check_method=1)
    cfg = KernelConfig2(L=L, W=2048, W_IN=2048, NLIT=1, K=K, NPS=4, TB=2,
                        TILE=384)
    _, args, out_bytes = jax_devbench.stage_first_batch(arch, cfg)
    staged, inputs = devbench.stage_first_batch(arch, CPU)
    n, c = len(staged.lanes), staged.config
    assert n == 6 and (c.L, c.W, c.W_IN, c.NLIT, c.NPS) == (6, 2048, 2048, 1,
                                                            4)
    assert out_bytes == int(staged.seg_lens.sum()) == len(data)
    # the JAX [W_IN/4, L] words, transposed back to u8 rows
    jax_in = np.ascontiguousarray(np.asarray(args[0]).T).view(np.uint8)
    np.testing.assert_array_equal(inputs[0].numpy(), jax_in[:n])
    assert not jax_in[n:].any()
    assert not inputs[1].any() and tuple(inputs[1].shape) == (n, c.W)
    # in_start, in_end, out_start, out_end, chunk_meta (the same packing)
    for port_t, jax_t in zip(inputs[2:], args[2:]):
        jt = np.asarray(jax_t).T
        k = min(K, c.K)
        np.testing.assert_array_equal(port_t.numpy()[:, :k], jt[:n, :k])
        assert not port_t.numpy()[:, k:].any() and not jt[n:].any()


@pytest.mark.parametrize("fn", ["device_throughput", "sharding_overhead",
                                "stage_first_batch"])
def test_no_timing_path_runs_on_the_cpu_unasked(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = lzma_rs_tpu.xz_compress(text(4096, 2), block_size=1024)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        getattr(devbench, fn)(arch)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pv.breakdown(arch)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pp.capture(arch)


def stage_helpers(data, plans, device):
    """execute_plan_device's stages, called one by one."""
    staged = runtime.stage_plans(data, plans)
    per_slab, devs = runtime.slab_devices(len(staged.lanes), device)
    launches = runtime.run_slabs(staged, per_slab, devs)
    return runtime.place_results(staged, launches), launches


@pytest.mark.parametrize("slabs", [None, "3"], ids=["one-slab", "3-slabs"])
def test_the_stage_helpers_equal_execute_plan_device(slabs, monkeypatch):
    if slabs:
        monkeypatch.setenv("LZMA_RS_TPU_DEVICES", slabs)
    data = text(16384, 5)
    arch = lzma_rs_tpu.xz_compress(data, block_size=1024, check_method=4)
    plans = runtime.plan_xz(arch)[0]
    out, launches = stage_helpers(arch, plans, CPU)
    assert out == runtime.execute_plan_device(arch, plans, CPU) == data
    assert [len(r) for r in launches] == ([1] if slabs is None else [3])


def test_the_stage_helpers_raise_the_same_lane_error():
    data = text(8192, 6)
    arch = bytearray(lzma_rs_tpu.xz_compress(data, block_size=1024,
                                             check_method=1))
    plans = runtime.plan_xz(bytes(arch))[0]
    lane = plans[3].lanes[0]
    arch[(lane.in_start[0] + lane.in_end[0]) // 2] ^= 0x5A
    arch = bytes(arch)
    errors = []
    for run in (lambda: runtime.execute_plan_device(arch, plans, CPU),
                lambda: stage_helpers(arch, plans, CPU)):
        with pytest.raises(runtime._KernelError) as e:
            run()
        errors.append((e.value.lane, e.value.code))
    assert errors[0] == errors[1]


def test_the_breakdown_on_the_cpu():
    data = text(1 << 18, 7)
    arch = corpus.tpu_archive(data, 1024)
    r = pv.breakdown(arch, CPU, calls=2, expected=data)
    assert r["device"] == {"name": "cpu", "count": 1}
    assert r["out_bytes"] == len(data) and r["calls"] == 2
    assert list(r["stages"]) == list(pv.STAGES)
    for v in list(r["stages"].values()) + [r["slabs"], r["xz_decode"]]:
        assert len(v["samples"]) == len(v["gc_samples"]) == 2
        assert v["min"] <= v["median"] <= v["max"] and v["min"] >= 0
        assert all(0 <= g <= t for g, t in zip(v["gc_samples"],
                                                v["samples"]))
    assert len(r["collect_ms"]["samples"]) == 4  # before each call
    assert r["stage_sum_ms"] == pytest.approx(
        sum(v["median"] for v in r["stages"].values()))
    assert r["sum_over_call"] == pytest.approx(
        r["stage_sum_ms"] / r["xz_decode"]["median"])
    assert r["device_stage_share"] == pytest.approx(sum(
        r["stages"][s]["median"] for s in ("h2d", "decode_segments", "d2h"))
        / r["xz_decode"]["median"])
    assert "the whole call" in pv.stage_text(r)


def test_the_breakdown_refuses_other_bytes():
    data = text(4096, 8)
    arch = corpus.tpu_archive(data, 1024)
    with pytest.raises(RuntimeError, match="differs"):
        pv.breakdown(arch, CPU, calls=1, expected=data[:-1] + b"?")


def test_the_crc_rows_on_the_cpu():
    data = text(40000, 9)
    r = pv.crc_rows(corpus.stock_archive(data, 16384), CPU, reps=1)
    assert (r["blocks"], r["block_bytes"], r["width"], r["out_bytes"]) == (
        3, 16384, 64, len(data))
    assert r["device"]["name"] == "cpu"
    assert all(r[k] >= 0 for k in ("device_ms", "product_ms", "host_ms"))
    # 4 + 4 + 1 full chunks, 2 x 32,768 x 64 operations each, at the int8
    # tensor-core rate (and beside it at the float32 rate)
    assert r["bound_by"] == "operations"
    assert r["bound_ms"] == pytest.approx(2 * 9 * 32768 * 64 / 1979e12 * 1e3)
    assert r["fp32_ops_ms"] == pytest.approx(2 * 9 * 32768 * 64 / 67e12
                                             * 1e3)
    # the kernel's rows: on the CPU crc_raw is its plain version (no
    # launch); its bound is the 9 chunks' bytes read once
    assert r["chunks"] == 9 and r["launches"] == 0 and r["max_abs_err"] == 0
    assert all(r[k] >= 0 for k in ("kernel_ms", "one_launch_ms",
                                   "wrapper_ms", "plain_ms"))
    assert r["kernel_bound_ms"] == pytest.approx(
        (9 * 4096 + 8) / 3.35e12 * 1e3)
    assert "max_abs_err 0" in pv.crc_text(r)


def test_the_crc_rows_of_a_crc32_archive_on_the_cpu():
    data = text(40000, 15)
    r = pv.crc_rows(corpus.tpu_archive(data, 16384), CPU, reps=1)
    assert (r["blocks"], r["width"], r["chunks"]) == (3, 32, 9)
    assert r["launches"] == 0 and r["max_abs_err"] == 0
    # the product's operations at CRC32 take less than the block's bytes
    assert r["bound_by"] == "bytes"
    assert r["bound_ms"] == pytest.approx(len(data) / 3.35e12 * 1e3)


def test_devbench_on_the_cpu():
    data = text(4096, 10)
    arch = corpus.tpu_archive(data, 1024)
    r = devbench.device_throughput(arch, CPU, reps=1, verify=data)
    assert r["device"]["name"] == "cpu" and r["cycles_per_step"] is None
    assert r["lanes"] == 4 and r["out_bytes"] == len(data)
    assert r["steps"] > 0
    assert r["us_per_step"] == pytest.approx(r["ms"] * 1e3 / r["steps"])
    with pytest.raises(RuntimeError, match="wrong bytes"):
        devbench.device_throughput(arch, CPU, reps=1, verify=data[::-1])
    oh = devbench.sharding_overhead(arch, CPU, reps=1)
    assert oh["n"] == 1 and oh["lanes_per_slab"] == 4
    assert oh["plain_ms"] > 0 and oh["slabs_ms"] > 0


def event(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur}


HAND_TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "x"}},
    event("user_annotation", "xz_decode", 1000.0, 1000.0),
    event("user_annotation", "plan_xz", 1010.0, 190.0),
    event("user_annotation", "stage_plans", 1200.0, 100.0),
    event("user_annotation", "slabs", 1300.0, 400.0),
    event("user_annotation", "placement", 1700.0, 50.0),
    event("user_annotation", "check_blocks", 1750.0, 200.0),
    event("user_annotation", "check_footer", 1950.0, 10.0),
    event("cpu_op", "aten::to", 1310.0, 60.0),
    event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1320.0, 50.0),
    event("kernel", "void lzl::segments_kernel<lzl::Warp, 1, true, true>("
          "lzl::SegmentArgs)", 1380.0, 220.0),
    event("gpu_memset", "Memset (Device)", 1590.0, 15.0),
    event("kernel", "void at::native::vectorized_elementwise_kernel", 1600.0,
          10.0),
    event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1620.0, 20.0),
    event("kernel", "void lzl::segments_kernel<>", 2100.0, 100.0),  # after
]}


def test_the_trace_summary_of_a_hand_written_trace():
    s = pp.summarize(HAND_TRACE)
    assert s["span_ms"] == pytest.approx(1.0)
    assert s["device_events"] == 5
    # busy: [1320,1370] + [1380,1610] + [1620,1640] = 300 us
    assert s["busy_ms"] == pytest.approx(0.3)
    assert s["idle_share"] == pytest.approx(0.7)
    assert s["launches"] == 1 and s["kernel_ms"] == pytest.approx(0.22)
    assert s["kernels"] == [(pytest.approx(0.38), pytest.approx(0.22))]
    assert s["htod"] == {"count": 1, "ms": pytest.approx(0.05)}
    assert s["dtoh"] == {"count": 1, "ms": pytest.approx(0.02)}
    assert [(g["start_ms"], g["ms"], g["stage"]) for g in s["gaps"]] == [
        (pytest.approx(0.64), pytest.approx(0.36), "check_blocks"),
        (pytest.approx(0.0), pytest.approx(0.32), "plan_xz"),
        (pytest.approx(0.37), pytest.approx(0.01), "slabs"),
        (pytest.approx(0.61), pytest.approx(0.01), "slabs"),
    ]
    assert pp.summarize(HAND_TRACE, top=2)["gaps"] == s["gaps"][:2]
    assert "idle share 0.7000" in pp.summary_text(s)


def test_a_trace_without_device_events_measures_no_idle_share():
    trace = {"traceEvents": [e for e in HAND_TRACE["traceEvents"]
                             if e.get("cat") in ("user_annotation",
                                                 "cpu_op")]}
    s = pp.summarize(trace)
    assert s["device_events"] == 0 and s["idle_share"] is None
    assert s["launches"] == 0 and s["busy_ms"] == 0
    assert s["gaps"] == [{"start_ms": 0.0, "ms": pytest.approx(1.0),
                          "stage": "slabs"}]
    assert pp.summary_text(s) == (
        "not measured (no device events in the trace)")


def test_the_timeline_names_the_main_paths_stages(tmp_path):
    data = text(8192, 11)
    arch = corpus.tpu_archive(data, 1024)
    trace, out, launches = pp.capture(arch, CPU, str(tmp_path / "t.json"))
    assert out == data and launches == 0  # the plain version: no kernel
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    # the timeline's spans are the breakdown's stages, no more, no fewer
    assert names == set(STAGE_ORDER) == set(pv.STAGES) | {pv.SLABS,
                                                          pv.WHOLE}
    assert pp.summarize(trace)["idle_share"] is None


def test_the_stage_hook_sees_the_main_paths_stages_in_order():
    data = text(8192, 17)
    arch = corpus.tpu_archive(data, 1024)
    seen = []
    with runtime.stage_hook(lambda name, start: seen.append((name, start))):
        assert runtime.xz_decode(arch, engine="cuda", device=CPU) == data
    assert [n for n, start in seen if start] == STAGE_ORDER
    assert sorted(seen) == sorted((n, s) for n in STAGE_ORDER
                                  for s in (True, False))
    assert runtime._stage_hook is None  # removed on leaving


def test_the_breakdown_refuses_a_stage_it_does_not_know(monkeypatch):
    data = text(4096, 18)
    arch = corpus.tpu_archive(data, 1024)
    place = runtime.place_results

    def renamed(staged, launches):
        with runtime.stage("placement_v2"):
            return place(staged, launches)

    monkeypatch.setattr(runtime, "place_results", renamed)
    with pytest.raises(RuntimeError, match="not the breakdown's"):
        pv.staged_call(arch, CPU)


@pytest.mark.cuda
def test_devbench_on_the_card():
    dev = card()
    data = text(1 << 17, 12)
    arch = corpus.tpu_archive(data, 1024)
    r = devbench.device_throughput(arch, dev, reps=3, verify=data)
    assert r["device"]["name"] == torch.cuda.get_device_name(dev)
    assert r["ms"] > 0 and r["cycles_per_step"] > 0 and r["lanes"] == 128
    oh = devbench.sharding_overhead(arch, dev, reps=3)
    assert oh["n"] == torch.cuda.device_count() and oh["slabs_ms"] > 0


@pytest.mark.cuda
def test_the_breakdown_and_the_timeline_on_the_card(tmp_path):
    dev = card()
    data = text(1 << 18, 13)
    arch = corpus.tpu_archive(data, 1024)
    r = pv.breakdown(arch, dev, calls=2, expected=data)
    assert list(r["stages"]) == list(pv.STAGES)
    assert r["stages"]["decode_segments"]["median"] > 0
    trace, out, launches = pp.capture(arch, dev, str(tmp_path / "t.json"))
    assert out == data and launches == 1
    s = pp.summarize(trace)
    if s["device_events"]:
        assert s["launches"] == launches and 0 <= s["idle_share"] < 1


@pytest.mark.cuda
def test_the_crc_rows_on_the_card():
    dev = card()
    data = text(3 << 20, 14)
    r = pv.crc_rows(corpus.stock_archive(data, 1 << 20), dev, reps=2)
    assert r["blocks"] == 3 and r["product_ms"] > 0
    # one kernel launch a block on the checks' path
    assert r["launches"] == 3 and r["kernel_ms"] > 0 and r["chunks"] == 768
    assert r["max_abs_err"] == 0


def test_time_vmem_step_on_the_cpu(capsys):
    from lzma_rs_tpu_torch.tools import time_vmem_step

    r = time_vmem_step.main(["0.001", "1024", "tpu", "--device", "cpu"])
    assert r["device"]["name"] == "cpu" and r["lanes"] == 1
    # one launch: the main path's steps are device_throughput's
    assert r["kernel_iters"] == r["steps"] > 0
    assert r["cycles_per_step"] is None
    assert r["bytes_per_step"] == pytest.approx(1000 / r["steps"])
    assert r["us_per_step"] == pytest.approx(
        r["device_ms"] * 1e3 / r["steps"])
    assert '"kernel_iters"' in capsys.readouterr().out.splitlines()[-1]


def test_time_vmem_step_needs_the_card_unless_asked(monkeypatch):
    from lzma_rs_tpu_torch.tools import time_vmem_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        time_vmem_step.main(["0.002", "1024"])


@pytest.mark.parametrize("engine", ["native", "spec"])
def test_profile_decode_prints_the_stats(engine, tmp_path, capsys):
    from lzma_rs_tpu_torch.tools import profile_decode

    data = text(20000, 15)
    path = tmp_path / "x.xz"
    path.write_bytes(lzma_rs_tpu.xz_compress(data, block_size=4096,
                                             check_method=4))
    d = profile_decode.main([str(path), "--engine", engine, "--trace",
                             str(tmp_path / "trace")])
    assert d["wall_seconds"] > 0 and d["wall_mb_s"] > 0
    with open(tmp_path / "trace" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    if engine == "native":  # the parallel runtime, with its stages named
        assert d["engine"] == "native" and d["unpacked_bytes"] == len(data)
        assert {"xz_decode", "plan_xz"} <= names
    assert json.loads(capsys.readouterr().out) == d


def test_profile_decode_needs_the_card_unless_asked(tmp_path,
                                                    monkeypatch):
    from lzma_rs_tpu_torch.tools import profile_decode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LZMA_RS_TPU_BACKEND", raising=False)
    path = tmp_path / "x.xz"
    path.write_bytes(lzma_rs_tpu.xz_compress(text(4096, 16),
                                             block_size=1024))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profile_decode.main([str(path)])
    assert "LZMA_RS_TPU_BACKEND" not in os.environ


@pytest.mark.cuda
def test_profile_decode_runs_on_the_card_by_default(tmp_path, monkeypatch):
    from lzma_rs_tpu_torch.tools import profile_decode

    card()
    monkeypatch.delenv("LZMA_RS_TPU_BACKEND", raising=False)
    data = text(1 << 16, 19)
    path = tmp_path / "x.xz"
    path.write_bytes(corpus.tpu_archive(data, 1024))
    d = profile_decode.main([str(path)])
    assert d["engine"] == "cuda" and not d["fallbacks"]
    assert d["unpacked_bytes"] == len(data)


def test_the_gc_clock_times_collections():
    with pv.GcClock() as clock:
        junk = [[i] for i in range(200000)]
        for j in junk:
            j.append(j)  # cycles, so a collection has work
        del junk
        gc.collect()
    assert clock.ms > 0 and clock not in gc.callbacks
