"""The port's auto router: its calibration, its cost model and its verdicts
against the JAX package's router.

- The calibration helpers are copies (``parallel/runtime.py``): env var >
  file > default, as ``tests/test_calibration.py`` holds them for the
  JAX package, with the port's own defaults and default file.
- ``_estimate_engine_seconds`` is held against the JAX model where the two
  designs coincide (one step cost for every lane, the port's wave as
  large as the JAX batch), and its other terms against their formulas.
- ``_resolve_auto`` gives the JAX router's verdict and record at both
  extreme calibrations and at its gates; at the port's defaults (measured
  on the H100) it routes the shapes that ``chip_smoke.py`` phase 16 ran
  as pinned here.

Inputs: seeded numpy text, stdlib ``lzma`` (``tools/corpus.py``) and the
port's encoder; each package plans with its own planner.
"""

import functools
import json
import os
import re

import pytest
import torch

from lzma_rs_tpu.parallel import runtime as jax_runtime
from lzma_rs_tpu.utils import stats as jax_stats
import lzma_rs_tpu_torch
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.parallel import runtime
from lzma_rs_tpu_torch.tools import calibrate
from lzma_rs_tpu_torch.tools import corpus as corpus_mod
from lzma_rs_tpu_torch.utils import stats

from test_torch_kernel_hostbuild import text

MODELED = re.compile(
    r"^auto->native: modeled device [0-9.]+ ms vs native [0-9.]+ ms$")
KEYS = [k for k, _, _ in runtime._CAL_KEYS]


@pytest.fixture
def no_calibration(monkeypatch, tmp_path):
    """No calibration file and no constant pinned by the environment."""
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(tmp_path / "none.json"))
    for _, env, _ in runtime._CAL_KEYS:
        monkeypatch.delenv(env, raising=False)
    monkeypatch.delenv("LZMA_RS_TPU_DEVICES", raising=False)
    monkeypatch.delenv("LZMA_RS_TPU_VMEM_L", raising=False)
    return tmp_path


# -- the copies' behaviour (tests/test_calibration.py's cases) ------------


def test_defaults_without_file(no_calibration):
    cal = runtime._auto_calibration()
    assert cal == {k: d for k, _, d in runtime._CAL_KEYS}
    assert cal["native_mbs"] == 305.666
    assert cal["step_b"] == 0.00125614


def test_file_beats_default(no_calibration, monkeypatch):
    path = no_calibration / "cal.json"
    path.write_text(json.dumps({"native_mbs": 333.0, "link_mbs": 9.0}))
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(path))
    cal = runtime._auto_calibration()
    assert cal["native_mbs"] == 333.0
    assert cal["link_mbs"] == 9.0
    assert cal["step_a"] == 0.0669242  # unmeasured key falls to default


def test_env_beats_file(no_calibration, monkeypatch):
    path = no_calibration / "cal.json"
    path.write_text(json.dumps({"native_mbs": 333.0}))
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(path))
    monkeypatch.setenv("LZMA_RS_TPU_CAL_NATIVE_MBS", "77")
    assert runtime._auto_calibration()["native_mbs"] == 77.0


def test_write_calibration_merges(no_calibration, monkeypatch):
    path = no_calibration / "cal.json"
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(path))
    runtime.write_calibration(native_mbs=100.0)
    runtime.write_calibration(link_mbs=20.0)
    assert json.loads(path.read_text()) == {"native_mbs": 100.0,
                                            "link_mbs": 20.0}


def test_router_uses_written_calibration(no_calibration, monkeypatch):
    # a written file claiming an absurdly fast native engine sends a
    # stream the defaults put on the card to the host
    path = no_calibration / "cal.json"
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(path))
    plans = shaped("a")
    assert runtime._resolve_auto(plans, "cpu") == "cuda"
    runtime.write_calibration(native_mbs=1e9, native_lane_us=0.0)
    assert runtime._auto_calibration()["native_mbs"] == 1e9
    assert runtime._auto_calibration()["native_lane_us"] == 0.0
    with stats.collect() as s:
        assert runtime._resolve_auto(plans, "cpu") == "native"
    assert len(s.fallbacks) == 1 and MODELED.match(s.fallbacks[0])


def test_the_default_file_and_keys_are_the_ports(monkeypatch):
    monkeypatch.delenv("LZMA_RS_TPU_CAL_FILE", raising=False)
    port, jax_path = runtime.calibration_path(), \
        jax_runtime.calibration_path()
    assert port != jax_path
    assert port.endswith(os.path.join(".cache", "lzma_rs_tpu_torch",
                                      "calibration.json"))
    # the JAX keys, then the native engine's cost a lane (the JAX model
    # has no such term)
    assert [(k, env) for k, env, _ in runtime._CAL_KEYS] == \
        [(k, env) for k, env, _ in jax_runtime._CAL_KEYS] + \
        [("native_lane_us", "LZMA_RS_TPU_CAL_NATIVE_LANE_US")]
    assert [d for *_, d in runtime._CAL_KEYS] != \
        [d for *_, d in jax_runtime._CAL_KEYS]


# -- the model against the JAX model -------------------------------------


@functools.lru_cache(maxsize=None)
def archives():
    data = text(48 * 1024, 3)
    return {
        "tpu_profile 1 KiB blocks": lzma_rs_tpu_torch.xz_compress(
            data, tpu_profile=True, check_method=1, block_size=1024),
        "stock 2 KiB blocks": corpus_mod.stock_archive(data, 2048),
        "port encoder 2 KiB blocks, level 9": lzma_rs_tpu_torch.xz_compress(
            data[:40000], check_method=4, block_size=2048, level=9),
    }


def pin(monkeypatch, **cal):
    """Both packages' routers read these constants (the env names are
    shared)."""
    for key, env, _ in runtime._CAL_KEYS:
        monkeypatch.setenv(env, repr(float(cal[key])))


BASE = {"native_mbs": 250.0, "link_mbs": 900.0, "step_a": 0.07,
        "step_b": 0.0, "steps_per_byte": 3.5, "native_lane_us": 0.0}


@pytest.mark.parametrize("name", list(archives()))
@pytest.mark.parametrize("n_devices", [1, 3])
def test_kernel_term_equals_the_jax_models(name, n_devices, no_calibration,
                                           monkeypatch):
    """With one step cost for every lane (``step_b`` = 0) and the port's
    wave as large as the JAX batch (one lane an SM, ``cfg.L`` SMs), the
    two models' kernel terms agree; the transfer term is priced away."""
    x = archives()[name]
    monkeypatch.setenv("LZMA_RS_TPU_VMEM_L", "8")  # the JAX batch
    jplans, plans = jax_runtime.plan_xz(x)[0], runtime.plan_xz(x)[0]
    jcfg = jax_runtime.choose_vmem_config(jplans, for_eligibility=True)
    cfg = runtime.choose_config(plans)
    assert jcfg.L == 8 and sum(len(p.lanes) for p in plans) > 2 * jcfg.L
    monkeypatch.setattr(sd, "lanes_per_sm", lambda c: 1)
    pin(monkeypatch, **{**BASE, "link_mbs": 1e30})
    jdev, jnat = jax_runtime._estimate_engine_seconds(jplans, jcfg,
                                                      n_devices)
    dev, nat = runtime._estimate_engine_seconds(plans, cfg, n_devices,
                                                jcfg.L)
    assert dev == pytest.approx(jdev, rel=1e-12) and dev > 0
    assert nat == pytest.approx(jnat, rel=1e-12)


@pytest.mark.parametrize("name", list(archives()))
def test_terms_follow_their_formulas(name, no_calibration, monkeypatch):
    x = archives()[name]
    plans = runtime.plan_xz(x)[0]
    cfg = runtime.choose_config(plans)
    lanes = sorted((lane for p in plans for lane in p.lanes),
                   key=runtime._packed, reverse=True)
    total_out = sum(p.total_out for p in plans)
    sms, per_sm = 1, sd.lanes_per_sm(cfg)
    # transfers alone: no kernel time
    pin(monkeypatch, **{**BASE, "steps_per_byte": 0.0})
    dev, nat = runtime._estimate_engine_seconds(plans, cfg, 2, sms)
    assert dev == pytest.approx(
        len(lanes) * (cfg.W_IN + 2 * cfg.W) / (BASE["link_mbs"] * 1e6),
        rel=1e-12)
    assert nat == pytest.approx(total_out / (BASE["native_mbs"] * 1e6),
                                rel=1e-12)
    # the native engine's cost a lane on top of its bytes
    pin(monkeypatch, **{**BASE, "native_lane_us": 12.5})
    _, nat = runtime._estimate_engine_seconds(plans, cfg, 2, sms)
    assert nat == pytest.approx(total_out / (BASE["native_mbs"] * 1e6)
                                + len(lanes) * 12.5e-6, rel=1e-12)
    # the kernel alone: waves of sms * per_sm lanes, each priced at its
    # longest lane and its resident lanes an SM, over the devices
    cal = {**BASE, "step_b": 0.004, "link_mbs": 1e30}
    pin(monkeypatch, **cal)
    dev, _ = runtime._estimate_engine_seconds(plans, cfg, 2, sms)
    wave, want = sms * per_sm, 0.0
    for i in range(0, len(lanes), wave):
        batch = lanes[i:i + wave]
        resident = min(per_sm, -(-len(batch) // sms))
        want += (max(l.out_end[-1] - l.seg_base for l in batch)
                 * cal["steps_per_byte"]
                 * (cal["step_a"] + cal["step_b"] * resident))
    assert len(lanes) > wave
    assert dev == pytest.approx(want * 1e-6 / 2, rel=1e-12)


# -- the router against the JAX router -----------------------------------


def route_both(x, monkeypatch):
    """(port's route, its fallbacks), (JAX route, its fallbacks): the port
    under ``device="cpu"``, the JAX router with a TPU pretended."""
    import jax  # here: the card's machine has no JAX for the cuda test

    monkeypatch.setattr(jax_runtime, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    with stats.collect() as s:
        port = runtime._resolve_auto(runtime.plan_xz(x)[0], "cpu")
    with jax_stats.collect() as j:
        ref = jax_runtime._resolve_auto_engine(jax_runtime.plan_xz(x)[0])
    return (port, s.fallbacks), (ref, j.fallbacks)


@pytest.mark.parametrize("case", ["host much faster", "card much faster",
                                  "small workload", "ineligible"])
def test_router_agrees_with_the_jax_router(case, no_calibration,
                                           monkeypatch):
    x = archives()["stock 2 KiB blocks"]
    if case == "ineligible":  # one 70,000-byte segment
        x = lzma_rs_tpu_torch.xz_compress(text(70000, 5), check_method=4,
                                          block_size=1 << 20)
    if case != "small workload":
        monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_LANES", "1")
        monkeypatch.setenv("LZMA_RS_TPU_AUTO_MIN_OUT", "1")
    native_mbs = 1e-3 if case == "card much faster" else 1e9
    pin(monkeypatch, **{**BASE, "native_mbs": native_mbs})
    (port, got), (ref, want) = route_both(x, monkeypatch)
    if case == "card much faster":
        assert (port, ref) == ("cuda", "tpu-vmem")
        assert got == want == []
        return
    assert port == ref == "native"
    if case == "host much faster":
        assert len(got) == len(want) == 1
        assert MODELED.match(got[0]) and MODELED.match(want[0])
    else:
        assert got == want and len(got) == 1


@pytest.mark.parametrize("native_over_device,route", [(1 / 0.95, "native"),
                                                      (1 / 0.85, "cuda")])
def test_the_router_keeps_ten_percent_headroom(native_over_device, route,
                                               no_calibration, monkeypatch):
    """The card only on a clear modeled win: ``device_s < native_s * 0.9``
    (``lzma_rs_tpu/parallel/runtime.py:1238``)."""
    plans = shaped("b")
    cfg = runtime.choose_config(plans)
    pin(monkeypatch, **BASE)
    device_s, native_s = runtime._estimate_engine_seconds(plans, cfg, 1,
                                                          runtime.CPU_SMS)
    # the native rate that puts native_s at the ratio asked for
    mbs = BASE["native_mbs"] * native_s / (device_s * native_over_device)
    pin(monkeypatch, **{**BASE, "native_mbs": mbs})
    with stats.collect() as s:
        assert runtime._resolve_auto(plans, "cpu") == route
    assert len(s.fallbacks) == (route == "native")


# -- the crossing at the port's defaults ---------------------------------


def lane(out, packed, lc):
    return runtime.LanePlan(
        in_start=[0], in_end=[packed], out_start=[0], out_end=[out],
        reset_state=[1], lc=[lc], lp=[0], pb=[2], seg_base=0, size_known=1,
        dict_size=1 << 26)


# chip_smoke.py phase 16's shapes: 16,000,000 B of the stdlib corpus as the
# stock archive (liblzma preset 6, lc=3, 64 KiB blocks; the tail block
# 9,216 B; packed <= 32 KiB) and as the tpu_profile one (lc=0, 8 KiB
# blocks; packed <= 4 KiB), and the ladder's smaller rungs.
SHAPES = {
    "b": ([65536] * 244 + [9216], 20000, 3),
    "stock 64 blocks": ([65536] * 64, 20000, 3),
    "stock 128 blocks": ([65536] * 128, 20000, 3),
    "a": ([8192] * 1953 + [1024], 3000, 0),
    "tpu_profile 1 MiB": ([8192] * 128, 3000, 0),
}


def shaped(name):
    sizes, packed, lc = SHAPES[name]
    return [runtime.DecodePlan([lane(n, packed if i == 0 else packed // 2,
                                     lc)], [], n)
            for i, n in enumerate(sizes)]


# The defaults' verdicts (the model's arithmetic). On the H100, phase 16
# (PERF.md, the routing ladder) measured the 64-block rung faster on the
# host (1.37-1.66x) or, on a loaded host, on the card (1.27-1.83x), (a)
# faster on the card (1.31-2.22x), and (b) faster on the card by
# 1.05-2.20x, which the defaults send to the host by 1%: the native
# engine's cost a lane (``native_lane_us``) takes (a) and its first 1 MiB
# to the card.
CROSSING = {
    "b": "auto->native: modeled device 59.7 ms vs native 65.6 ms",
    "stock 64 blocks": "auto->native: modeled device 27.9 ms vs native "
                       "17.2 ms",
    "stock 128 blocks": "auto->native: modeled device 39.0 ms vs native "
                        "34.4 ms",
    "a": None,
    "tpu_profile 1 MiB": None,
}


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_crossing_at_the_defaults(name, no_calibration):
    plans = shaped(name)
    cfg = runtime.choose_config(plans)
    assert (cfg.W, cfg.NLIT) == ((65536, 8) if name.startswith(("b", "s"))
                                 else (8192, 1))
    with stats.collect() as s:
        route = runtime._resolve_auto(plans, "cpu")
    want = CROSSING[name]
    assert route == ("cuda" if want is None else "native")
    assert s.fallbacks == ([] if want is None else [want])


# -- tools/calibrate.py --------------------------------------------------


def test_measure_native_writes_native_mbs_alone(no_calibration,
                                                monkeypatch):
    path = no_calibration / "cal.json"
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(path))
    r = calibrate.measure_native(1)
    assert r["bytes"] == 1_000_000 and r["blocks"] == 1
    vals = json.loads(path.read_text())
    assert list(vals) == ["native_mbs"] and vals["native_mbs"] > 0
    assert vals["native_mbs"] == r["native_mbs"]


@pytest.mark.parametrize("native_mbs", [1e9, 1e-3])
def test_measure_native_lanes_writes_native_lane_us_alone(
        native_mbs, no_calibration, monkeypatch):
    """The engine's time less the checks' and the bytes' over the lanes, 0
    where the bytes alone take longer than the engine."""
    path = no_calibration / "cal.json"
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(path))
    data = text(64 * 1024, 7)
    x = corpus_mod.tpu_archive(data)
    r = calibrate.measure_native_lanes(x, native_mbs, data)
    plans = runtime.plan_xz(x)[0]
    assert r["lanes"] == sum(len(p.lanes) for p in plans) > 1
    assert r["out"] == len(data)
    assert r["engine_ms"] > 0 and r["checks_ms"] > 0
    want = (r["engine_ms"] - r["checks_ms"] - r["bytes_ms"]) / r["lanes"]
    assert r["native_lane_us"] == pytest.approx(max(0.0, want * 1e3))
    if native_mbs < 1:  # the bytes alone: 65 s
        assert r["native_lane_us"] == 0.0
    vals = json.loads(path.read_text())
    assert vals == {"native_lane_us": r["native_lane_us"]}
    with pytest.raises(RuntimeError, match="other bytes"):
        calibrate.measure_native_lanes(x, native_mbs, data[:-1])


def test_fit_takes_the_slope_of_a_and_the_intercept_of_b():
    a = [{"resident": r, "us_per_step": 0.08 + 0.002 * r} for r in
         (1, 2, 4, 8, 15)]
    b = [{"resident": r, "us_per_step": 0.065 + 0.002 * r} for r in (1, 2)]
    step_a, step_b = calibrate.fit_steps(a, b)
    assert step_b == pytest.approx(0.002) and step_a == pytest.approx(0.065)
    flat = [{"resident": r, "us_per_step": 0.09 - 0.001 * r} for r in (1, 8)]
    assert calibrate.fit_steps(flat, b[:1])[1] == 0.0


def test_the_tool_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(tmp_path / "cal.json"))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        calibrate.main(["--mb", "1"])
    with pytest.raises(RuntimeError, match="measures a CUDA card"):
        calibrate.calibrate("cpu")
    assert not (tmp_path / "cal.json").exists()


@pytest.mark.cuda
def test_the_tool_on_the_card(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path / "cal.json"
    monkeypatch.setenv("LZMA_RS_TPU_CAL_FILE", str(out))  # main sets it
    calibrate.main(["--mb", "4", "--out", str(out)])
    vals = json.loads(out.read_text())
    assert sorted(vals) == sorted(KEYS)
    assert all(v > 0 for k, v in vals.items()
               if k not in ("step_b", "native_lane_us"))
    assert vals["step_b"] >= 0 and vals["native_lane_us"] >= 0
