"""A device timeline of one `.xz` decode on the card, and its summary.

The port of ``tools/profile_pipeline.py``. :func:`capture` runs one warm
``runtime.xz_decode(engine="cuda")`` under ``torch.profiler`` (host and
CUDA activity) and returns the chrome trace. :func:`summarize`, a pure
function of that trace, reports:

- the decoder's kernel windows, matched by its CUDA symbol
  ``segments_kernel`` (``csrc/segment_kernel.cuh``), and their count;
- the host-to-device and device-to-host copies;
- the device's busy time over the call's span (the ``xz_decode``
  ``record_function`` span of ``parallel/runtime.py``) and its idle
  share;
- the longest gaps in the device's activity, each with the main path's
  stage (its ``record_function`` span) that ran on the host longest
  during it.

Usage (on the card)::

    python -m lzma_rs_tpu_torch.tools.profile_pipeline [MB] [--out DIR]

MB (default 16) of the stdlib corpus as (a) the tpu_profile archive and
(b) the stock-shaped one; the traces go to ``DIR`` (default
``profile_traces``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os

KERNEL = "segments_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "xz_decode"


def capture(archive: bytes, device=None, path: str = "trace.json") -> tuple:
    """One warm ``xz_decode(engine="cuda")`` of ``archive`` under
    ``torch.profiler`` (after a full collection of the warm call's
    garbage), its trace written to ``path``. Returns ``(trace dict,
    decoded bytes, decode_segments launches in the traced call)``."""
    import torch

    from lzma_rs_tpu_torch.ops import segment_decoder as sd
    from lzma_rs_tpu_torch.parallel import devbench, runtime

    device = devbench.timing_device(device)
    runtime.xz_decode(archive, engine="cuda", device=device)  # warm
    gc.collect()  # the warm call's garbage, as the breakdown does
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    before = sd.decode_segments.launches
    with torch.profiler.profile(activities=acts) as prof:
        out = runtime.xz_decode(archive, engine="cuda", device=device)
    launches = sd.decode_segments.launches - before
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f), out, launches


def _merge(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(a: float, b: float, c: float, d: float) -> float:
    return max(0.0, min(b, d) - max(a, c))


def summarize(trace: dict, top: int = 5) -> dict:
    """The summary of a chrome trace (``ts`` and ``dur`` in µs), in ms.

    ``span_ms``: the first ``xz_decode`` span (else from the first event
    to the last); ``device_events``: device events in it (kernels,
    copies, memsets); ``busy_ms``: the union of their windows within the
    span; ``idle_share``: 1 - busy / span, None without device events (a
    trace without a device timeline measures no idle share);
    ``launches``, ``kernel_ms`` and ``kernels`` (start ms from the span's
    start, ms): the decoder's kernel windows; ``htod``/``dtoh``: count
    and ms of the copies; ``gaps``: the ``top`` longest stretches of the
    span without device activity, longest first, each ``{"start_ms",
    "ms", "stage"}``, the stage being the named span (other than the
    call) that overlaps it most, the innermost of those that overlap it
    as much (``decode_segments`` within ``slabs``), or the call itself."""
    ev = [e for e in trace.get("traceEvents", [])
          if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in ev
             if e.get("cat") == "user_annotation" and e["name"] == CALL]
    if calls:
        t0, t1 = calls[0]["ts"], calls[0]["ts"] + calls[0]["dur"]
    elif ev:
        t0 = min(e["ts"] for e in ev)
        t1 = max(e["ts"] + e["dur"] for e in ev)
    else:
        t0 = t1 = 0.0

    def within(e):
        return e["ts"] < t1 and e["ts"] + e["dur"] > t0

    device = [e for e in ev if e.get("cat") in DEVICE_CATS and within(e)]
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in device])
    busy_us = sum(b - a for a, b in busy)
    kernels = sorted((e["ts"], e["dur"]) for e in device
                     if e["cat"] == "kernel" and KERNEL in e["name"])

    def copies(kind):
        c = [e for e in device
             if e["cat"] == "gpu_memcpy" and kind in e["name"]]
        return {"count": len(c), "ms": sum(e["dur"] for e in c) / 1e3}

    stages = [e for e in ev if e.get("cat") == "user_annotation"
              and e["name"] != CALL and within(e)]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        best = max(stages, default=None, key=lambda e: (
            _overlap(a, b, e["ts"], e["ts"] + e["dur"]), -e["dur"]))
        stage = (best["name"] if best is not None and _overlap(
            a, b, best["ts"], best["ts"] + best["dur"]) > 0 else CALL)
        gaps.append({"start_ms": (a - t0) / 1e3, "ms": (b - a) / 1e3,
                     "stage": stage})
    gaps.sort(key=lambda g: -g["ms"])
    span_us = t1 - t0
    return {
        "span_ms": span_us / 1e3,
        "device_events": len(device),
        "busy_ms": busy_us / 1e3,
        "idle_share": (1 - busy_us / span_us) if device and span_us else None,
        "launches": len(kernels),
        "kernel_ms": sum(d for _, d in kernels) / 1e3,
        "kernels": [((a - t0) / 1e3, d / 1e3) for a, d in kernels],
        "htod": copies("HtoD"),
        "dtoh": copies("DtoH"),
        "gaps": gaps[:top],
    }


def summary_text(s: dict) -> str:
    """One line of a summary."""
    if s["idle_share"] is None:
        return "not measured (no device events in the trace)"
    gaps = "; ".join(f"{g['ms']:.2f} ms at +{g['start_ms']:.2f} "
                     f"({g['stage']})" for g in s["gaps"])
    return (f"span {s['span_ms']:.2f} ms, device busy {s['busy_ms']:.2f} ms"
            f", idle share {s['idle_share']:.4f}; {s['launches']} kernel "
            f"launches ({s['kernel_ms']:.3f} ms); HtoD {s['htod']['count']} "
            f"({s['htod']['ms']:.3f} ms), DtoH {s['dtoh']['count']} "
            f"({s['dtoh']['ms']:.3f} ms); longest gaps: {gaps}")


def main(argv=None) -> None:
    """The command line: one traced call and its summary."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mb", nargs="?", type=float, default=16.0)
    ap.add_argument("--out", default="profile_traces")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    from lzma_rs_tpu_torch.tools import corpus

    data, _ = corpus.stdlib_corpus(int(args.mb * 1e6))
    report = {}
    for key, x in (("a", corpus.tpu_archive(data)),
                   ("b", corpus.stock_archive(data))):
        trace, out, launches = capture(
            x, args.device, os.path.join(args.out, f"trace_{key}.json"))
        if out != data:
            raise RuntimeError(f"({key}) the decode differs from the corpus")
        s = summarize(trace)
        print(f"({key}) {launches} launches in the call; timeline: "
              f"{summary_text(s)}", flush=True)
        report[key] = s
    print(json.dumps(report))


if __name__ == "__main__":
    main()
