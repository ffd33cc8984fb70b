"""The segment kernel's cost a step on the card.

The port of ``tools/time_vmem_step.py``: decodes an archive of the
stdlib corpus through ``runtime.execute_plan_device`` with stats on and
reports ``stats.kernel_iters`` (over the launches, each launch's longest
lane's steps: a launch lasts its longest lane's chain) and, from
``devbench.device_throughput`` (one launch of the whole batch between
CUDA events), the kernel's device time, its steps (the batch's longest
lane's: on a one-card host the main path's one launch, so equal to
``kernel_iters``), the µs and cycles (at the card's max SM clock) a step,
and the decoded bytes a step.

Usage (on the card; ``--device cpu`` runs the kernel's plain version,
timed by the host clock)::

    python -m lzma_rs_tpu_torch.tools.time_vmem_step [MB] [BLOCK] [PROFILE]
        [--device cpu]

MB (default 2) of the stdlib corpus in BLOCK-byte blocks (default 8192),
PROFILE ``tpu`` (default: the tpu_profile encoder) or ``stock`` (the
port's encoder at level 6).
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    """The command line: the kernel's time a step on the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mb", nargs="?", type=float, default=2.0)
    ap.add_argument("block", nargs="?", type=int, default=8192)
    ap.add_argument("profile", nargs="?", default="tpu",
                    choices=("tpu", "stock"))
    ap.add_argument("--device", default=None,
                    help="cpu: the kernel's plain version (default: the "
                         "current CUDA device)")
    args = ap.parse_args(argv)

    import lzma_rs_tpu_torch
    from lzma_rs_tpu_torch.parallel import devbench, runtime
    from lzma_rs_tpu_torch.tools import corpus
    from lzma_rs_tpu_torch.utils import stats as stats_mod

    device = devbench.timing_device(args.device)
    data, _ = corpus.stdlib_corpus(int(args.mb * 1e6))
    if args.profile == "tpu":
        archive = corpus.tpu_archive(data, args.block)
    else:
        archive = lzma_rs_tpu_torch.xz_compress(data, block_size=args.block,
                                                level=6)
    plans = runtime.plan_xz(archive)[0]
    print(f"{len(data) / 1e6:.1f} MB, block {args.block} ({args.profile}): "
          f"{sum(len(p.lanes) for p in plans)} lanes, config "
          f"{runtime.choose_config(plans)}", flush=True)

    if runtime.execute_plan_device(archive, plans, device) != data:  # warm
        raise RuntimeError("the decode differs from the corpus")
    best, iters = float("inf"), 0
    for _ in range(3):
        with stats_mod.collect() as st:
            t = time.perf_counter()
            out = runtime.execute_plan_device(archive, plans, device)
            dt = time.perf_counter() - t
        if out != data:
            raise RuntimeError("the decode differs from the corpus")
        if dt < best:
            best, iters = dt, st.kernel_iters
    dev = devbench.device_throughput(archive, device, reps=5, verify=data)
    res = {
        "device": dev["device"], "mb": len(data) / 1e6, "block": args.block,
        "profile": args.profile, "lanes": dev["lanes"],
        "kernel_iters": iters, "steps": dev["steps"], "wall_ms": best * 1e3,
        "device_ms": dev["ms"], "us_per_step": dev["us_per_step"],
        "cycles_per_step": dev["cycles_per_step"],
        "bytes_per_step": len(data) / dev["steps"],
    }
    cyc = res["cycles_per_step"]
    print(f"warm {len(data) / 1e6 / best:.2f} MB/s end to end "
          f"({best * 1e3:.1f} ms), {iters} steps, kernel {dev['ms']:.3f} ms"
          f" for {dev['steps']} steps"
          f" = {res['us_per_step']:.4f} us a step"
          + ("" if cyc is None else f" ({cyc:.1f} cycles)")
          + f", {res['bytes_per_step']:.2f} bytes a step (whole corpus); "
          f"{dev['device']['name']}", flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
