"""Measure the auto router's constants on this machine's card, and write them.

The port of ``tools/calibrate.py``. The router (``parallel/runtime.py``,
``_resolve_auto`` / ``_estimate_engine_seconds``) reads five constants,
each from its environment variable, else the calibration file
(``runtime.calibration_path()``: ``LZMA_RS_TPU_CAL_FILE``, else
``~/.cache/lzma_rs_tpu_torch/calibration.json``), else the built-in
default. This tool measures all five on the stdlib corpus
(``tools/corpus.py``) and merges them into that file
(``runtime.write_calibration``):

- ``native_mbs``: the native engine on ``--mb`` MB in 1 MiB blocks
  (liblzma preset 6, CRC64), best of 3 (:func:`measure_native`, the host
  half);
- ``step_a`` / ``step_b``: the residency ladder. The kernel runs a lane a
  block, so a launch of ``n`` lanes keeps ``ceil(n / SMs)`` of them
  resident on an SM, up to what shared memory allows. The ladder times
  prefixes of (a), the tpu_profile archive (the biggest lanes first, as
  the main path sorts them), at SMs x {1, 2, 4, 8} lanes and the whole
  batch, and (b), the stock 64 KiB-block archive, at SMs lanes and the
  whole batch: CUDA events around ``decode_segments``, microseconds and
  cycles (at the max SM clock) a step of the launch's longest lane.
  ``step_b`` is the least-squares slope of (a)'s microseconds a step over
  its resident lanes, where every point decodes the same kind of data
  (0 if the slope is not positive), and ``step_a`` the intercept that fits
  (b)'s points on that slope: the stock shape is the one the router must
  place;
- ``steps_per_byte``: the longest lane's steps over its bytes on (b);
  (a)'s is printed beside it;
- ``link_mbs``: the device path's host-side rate, the bytes the model
  counts a lane (``W_IN + 2 * W``) over the median time of the
  ``stage_plans``, ``h2d``, ``d2h`` and ``placement`` stages of the main
  path's own call (``tools/probe_vmem2_time.py``, through
  ``runtime.stage_hook``), on (a) and (b); the lower rate is written.

Usage (on the card; it raises without one)::

    python -m lzma_rs_tpu_torch.tools.calibrate [--mb 16] [--out PATH]

``--out`` writes there instead of ``calibration_path()``. The last line
of standard output is one JSON object with every point and constant.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.parallel import devbench, runtime
from lzma_rs_tpu_torch.tools import corpus as corpus_mod

HOST_BLOCK = 1 << 20
A_LADDER = (1, 2, 4, 8)  # lanes an SM of (a)'s prefixes; then the whole
B_LADDER = (1,)          # of (b)'s; then the whole
HOST_STAGES = ("stage_plans", "h2d", "d2h", "placement")
NATIVE_REPS = 3  # best of
LADDER_REPS = 5  # launches between the two events


def measure_native(mb: float = 16, data=None) -> dict:
    """``native_mbs``: the native engine on ``data`` (by default ``mb`` MB
    of the corpus) in 1 MiB blocks, best of :data:`NATIVE_REPS`, written
    to the calibration file. Runs on the host alone."""
    if data is None:
        data = corpus_mod.stdlib_corpus(int(mb * 1e6))[0]
    archive = corpus_mod.stock_archive(data, HOST_BLOCK)
    best = float("inf")
    for _ in range(NATIVE_REPS):
        t = time.perf_counter()
        out = runtime.xz_decode(archive, engine="native")
        best = min(best, time.perf_counter() - t)
        if out != data:
            raise RuntimeError("the native engine decoded other bytes")
    native_mbs = len(data) / 1e6 / best
    path = runtime.write_calibration(native_mbs=native_mbs)
    return {"native_mbs": native_mbs, "native_ms": best * 1e3,
            "bytes": len(data), "blocks": -(-len(data) // HOST_BLOCK),
            "path": path}


def ladder_point(staged, n: int, device, peaks) -> dict:
    """The kernel on the first ``n`` lanes of ``staged``: a checked warm
    launch, then :data:`LADDER_REPS` launches between two CUDA events."""
    cfg = staged.slab_config(0, n)
    inputs = staged.tensors(device, 0, n)
    outs = sd.decode_segments(*inputs, config=cfg)
    err, outp, steps = (t.cpu().numpy() for t in outs[1:])
    if (err != 0).any() or (outp != staged.seg_lens[:n]).any():
        raise RuntimeError(f"the first {n} lanes did not decode clean")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LADDER_REPS):
        sd.decode_segments(*inputs, config=cfg)
    stop.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(stop) / LADDER_REPS
    longest = int(np.argmax(steps))
    per_sm = sd.lanes_per_sm(cfg)
    return {
        "lanes": n, "resident": min(per_sm, -(-n // peaks.sms)),
        "lanes_per_sm": per_sm, "ms": ms, "steps": int(steps[longest]),
        "lane_bytes": int(staged.seg_lens[longest]),
        "us_per_step": ms * 1e3 / int(steps[longest]),
        "cycles_per_step": ms * 1e-3 * peaks.clock_mhz * 1e6
        / int(steps[longest]),
    }


def fit_steps(a_points: list, b_points: list) -> tuple:
    """``(step_a, step_b)``: ``step_b`` the least-squares slope of (a)'s
    microseconds a step over resident lanes (0 unless positive),
    ``step_a`` the mean intercept of (b)'s points on it."""
    r = np.array([p["resident"] for p in a_points], dtype=float)
    us = np.array([p["us_per_step"] for p in a_points])
    slope = float(np.polyfit(r, us, 1)[0]) if len(set(r)) > 1 else 0.0
    step_b = max(0.0, slope)
    step_a = statistics.mean(p["us_per_step"] - step_b * p["resident"]
                             for p in b_points)
    return step_a, step_b


def host_rate(archive: bytes, device, expected: bytes) -> dict:
    """The device path's host-side rate on ``archive``: the model's bytes a
    lane over the median ms of :data:`HOST_STAGES` (3 calls of the stage
    breakdown)."""
    from lzma_rs_tpu_torch.tools import probe_vmem2_time as pv

    b = pv.breakdown(archive, device, calls=3, expected=expected)
    cfg = runtime.choose_config(runtime.plan_xz(archive)[0])
    ms = sum(b["stages"][s]["median"] for s in HOST_STAGES)
    nbytes = cfg.L * (cfg.W_IN + 2 * cfg.W)
    return {"lanes": cfg.L, "bytes": nbytes, "host_ms": ms,
            "stage_ms": {s: b["stages"][s]["median"] for s in HOST_STAGES},
            "mb_s": nbytes / 1e3 / ms}


def measure_device(device, corpus: bytes, xa: bytes, xb: bytes) -> dict:
    """``step_a``, ``step_b``, ``steps_per_byte`` and ``link_mbs`` on the
    card from (a) and (b) of ``corpus``, written to the calibration
    file."""
    from lzma_rs_tpu_torch.tools import probe_rows

    peaks = probe_rows.card_peaks(device)
    ladder = {}
    for key, x, rungs in (("a", xa, A_LADDER), ("b", xb, B_LADDER)):
        staged = runtime.stage_plans(x, runtime.plan_xz(x)[0])
        L = staged.config.L
        sizes = [r * peaks.sms for r in rungs if r * peaks.sms < L] + [L]
        ladder[key] = [ladder_point(staged, n, device, peaks) for n in sizes]
        del staged
        torch.cuda.empty_cache()
    step_a, step_b = fit_steps(ladder["a"], ladder["b"])
    spb = {k: v[-1]["steps"] / v[-1]["lane_bytes"] for k, v in ladder.items()}
    link = {k: host_rate(x, device, corpus) for k, x in (("a", xa),
                                                          ("b", xb))}
    cal = {"step_a": step_a, "step_b": step_b, "steps_per_byte": spb["b"],
           "link_mbs": min(v["mb_s"] for v in link.values())}
    path = runtime.write_calibration(**cal)
    return {**cal, "steps_per_byte_a": spb["a"], "ladder": ladder,
            "link": link, "sms": peaks.sms, "clock_mhz": peaks.clock_mhz,
            "path": path}


def calibrate(device=None, mb: float = 16, corpus=None, xa=None,
              xb=None) -> dict:
    """Every constant, measured on the card ``device`` (by default the
    current CUDA device; it raises without one) and written to
    ``calibration_path()``. ``corpus`` and its archives (a) and (b) are
    made from ``mb`` MB of the stdlib sources unless given."""
    device = devbench.timing_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"calibration measures a CUDA card, not {device}")
    if corpus is None:
        corpus = corpus_mod.stdlib_corpus(int(mb * 1e6))[0]
    xa = corpus_mod.tpu_archive(corpus) if xa is None else xa
    xb = corpus_mod.stock_archive(corpus) if xb is None else xb
    native = measure_native(data=corpus)
    dev = measure_device(device, corpus, xa, xb)
    return {**native, **dev, "device": devbench.device_info(device)}


def point_text(key: str, p: dict) -> str:
    return (f"({key}) {p['lanes']} lanes, {p['resident']} an SM (of "
            f"{p['lanes_per_sm']}): {p['ms']:.3f} ms over {p['steps']} steps"
            f" = {p['us_per_step'] * 1e3:.2f} ns, {p['cycles_per_step']:.1f} "
            "cycles a step")


def report(cal: dict) -> list:
    """The lines :func:`main` prints for a calibration."""
    lines = [point_text(k, p) for k in ("a", "b") for p in cal["ladder"][k]]
    model = cal["step_a"] * 1e3, cal["step_b"] * 1e3
    lines.append(f"fit: a step {model[0]:.3f} ns + {model[1]:.4f} ns a "
                 "resident lane; at each point (ns, measured / model): "
                 + "; ".join(
                     f"({k}) {p['lanes']}: {p['us_per_step'] * 1e3:.2f} / "
                     f"{model[0] + model[1] * p['resident']:.2f}"
                     for k in ("a", "b") for p in cal["ladder"][k]))
    lines.append(f"steps_per_byte {cal['steps_per_byte']:.4f} on (b) "
                 f"({cal['steps_per_byte_a']:.4f} on (a))")
    for k, v in cal["link"].items():
        lines.append(f"host-side rate ({k}): {v['lanes']} lanes x W_IN + 2W "
                     f"= {v['bytes']} B over {v['host_ms']:.2f} ms ("
                     + ", ".join(f"{s} {ms:.2f}"
                                 for s, ms in v["stage_ms"].items())
                     + f") = {v['mb_s']:.2f} MB/s")
    lines.append(f"native_mbs {cal['native_mbs']:.2f} ({cal['bytes']} B in "
                 f"{cal['blocks']} blocks, best of 3, {cal['native_ms']:.2f}"
                 f" ms); link_mbs {cal['link_mbs']:.2f}; step_a "
                 f"{cal['step_a']:.6f} us; step_b {cal['step_b']:.6f} us")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mb", type=float, default=16)
    ap.add_argument("--out", help="write here, not calibration_path()")
    args = ap.parse_args(argv)
    if args.out:
        os.environ["LZMA_RS_TPU_CAL_FILE"] = os.path.abspath(args.out)
    cal = calibrate(mb=args.mb)
    for line in report(cal):
        print(line, flush=True)
    print(f"wrote {cal['path']}", flush=True)
    print(json.dumps(cal), flush=True)


if __name__ == "__main__":
    main()
