"""Profile one `.xz` decode: its stats and, optionally, a timeline.

The port of ``tools/profile_decode.py``. Decodes FILE through
``xz_decompress`` under the engine asked for (``LZMA_RS_TPU_BACKEND``;
``cuda`` by default, which raises without a card: the host engines
``native`` and ``spec`` run only where the caller asks for them),
prints the call's stats (``utils/stats.py``) with its wall time, and with
``--trace DIR`` writes a ``torch.profiler`` chrome trace (host and, on a
card, CUDA activity) of the call to ``DIR/trace.json``; the main path's
stages are named in it (``parallel/runtime.py``'s ``record_function``
spans).

Usage::

    python -m lzma_rs_tpu_torch.tools.profile_decode FILE.xz
        [--engine cuda|native|spec] [--trace DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> dict:
    """The command line: decode FILE under the profiler."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("file")
    ap.add_argument("--engine", default="cuda",
                    choices=["native", "cuda", "spec"])
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    import torch

    import lzma_rs_tpu_torch
    from lzma_rs_tpu_torch.utils import stats

    with open(args.file, "rb") as f:
        data = f.read()
    prof = contextlib.nullcontext()
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    old = os.environ.get("LZMA_RS_TPU_BACKEND")
    os.environ["LZMA_RS_TPU_BACKEND"] = args.engine
    try:
        with prof:
            t = time.perf_counter()
            with stats.collect() as s:
                out = lzma_rs_tpu_torch.xz_decompress(data)
            wall = time.perf_counter() - t
    finally:
        if old is None:
            del os.environ["LZMA_RS_TPU_BACKEND"]
        else:
            os.environ["LZMA_RS_TPU_BACKEND"] = old
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}", file=sys.stderr)
    d = s.to_dict()
    d["wall_seconds"] = round(wall, 4)
    d["wall_mb_s"] = round(len(out) / 1e6 / wall, 2)
    print(json.dumps(d, indent=2))
    return d


if __name__ == "__main__":
    main()
