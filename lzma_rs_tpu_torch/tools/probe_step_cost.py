"""The segment decoder's cost a step, part by part, on the card.

The port of ``tools/probe_step_cost.py`` (gen-1's bucket, ``W_IN = W``):
runs the decoder in spin mode (every lane exactly 4,096 steps of real
decoding, the JAX tools' iterations, restarting its segment at its end or on an error) with
parts of the step taken out, one build a case (``ops/step_cost.py``,
``csrc/step_cost.cu``), and prints each case's time a step. The
differences between cases price the parts: the probability read and
store, the window's read port and stores, the input byte's load. The JAX
tool set ``LZMA_RS_TPU_ABLATE`` and ran each case in a fresh process;
here every case is a build of its own and all run in one process.

Usage (on the card; ``--device cpu`` runs the plain versions, timed by
the host clock)::

    python -m lzma_rs_tpu_torch.tools.probe_step_cost [L] [W] [RING]
        [NLIT] [NPS] [UNROLL] [--device cpu]

L lanes (default 256) of ``W``-byte windows (default 8192; ``W_IN = W``),
``NLIT`` literal contexts (1), ``NPS`` pos-states (4); ``RING`` and
``UNROLL`` are accepted and have no counterpart (the decoder keeps its
whole window, and has no unrolled inner loop). The lanes are the first L
of ``xz_compress(corpus, block_size=W // 2, tpu_profile=True)`` over the
interpreter's stdlib sources (``tools/corpus.py``), staged by
``runtime.stage_plans``. Each case is timed best of 3 with CUDA events
after a warm call and printed as ``RESULT <case> <x> us/step (<n> steps)``
with its cycles a step (at the card's max SM clock) and the lanes'
restarts. ``spin,flush`` is printed as not applicable: this decoder has no
ring to flush. ``probe_step_cost2`` runs the same cases at gen-2's
default width with chained timing.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

STEPS = 4096  # a lane's steps in every case: the JAX tools' iterations
# The JAX tools' cases, in their order: the port's builds, and the case
# with no counterpart (printed, not timed).
CASES = ("spin", "spin,probread", "spin,probread,probwrite", "spin,port",
         "spin,winwrite", "spin,refill", "spin,flush",
         "spin,probread,probwrite,port,winwrite,refill")


def parse(argv, default_lanes: int):
    """The tools' arguments; ``default_lanes`` is L's default."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, default in (("L", default_lanes), ("W", 8192), ("RING", 2048),
                          ("NLIT", 1), ("NPS", 4), ("UNROLL", 2)):
        ap.add_argument(name, nargs="?", type=int, default=default)
    ap.add_argument("--device", default=None,
                    help="cpu: the plain versions (default: the current "
                         "CUDA device)")
    return ap.parse_args(argv)


def staged_lanes(L: int, W: int, nlit: int, nps: int, device):
    """The first ``L`` lanes of the tool's archive in the bucket ``L, W,
    W_IN = W, NLIT, NPS`` on ``device``: ``(config, inputs)``."""
    from lzma_rs_tpu_torch import xz_compress
    from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig
    from lzma_rs_tpu_torch.parallel import runtime
    from lzma_rs_tpu_torch.tools import corpus

    data, _ = corpus.stdlib_corpus(L * (W // 2))
    archive = xz_compress(data, block_size=W // 2, tpu_profile=True)
    staged = runtime.stage_plans(archive, runtime.plan_xz(archive)[0])
    if len(staged.lanes) < L:
        raise ValueError(f"the archive holds {len(staged.lanes)} lanes, "
                         f"not {L}")
    cfg = SegmentConfig(L=L, W=W, W_IN=W, NLIT=nlit, K=staged.config.K,
                        NPS=nps)
    inbuf = np.zeros((L, W), dtype=np.uint8)
    inbuf[:, :staged.config.W_IN] = staged.inbuf[:L]
    win = np.zeros((L, W), dtype=np.uint8)
    if staged.win_init is not None:
        win[:, :staged.config.W] = staged.win_init[:L]
    arrays = (inbuf, win) + tuple(t[:L] for t in staged.tables)
    return cfg, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in arrays)


def time_calls(fn, device, reps: int) -> float:
    """Milliseconds of ``reps`` calls of ``fn`` (CUDA events on the card,
    the host clock on the CPU), each call's result fed to the next."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(reps)
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop)
    t = time.perf_counter()
    fn(reps)
    return (time.perf_counter() - t) * 1e3


@dataclasses.dataclass
class Result:
    case: str
    steps: int            # steps a lane ran (the budget)
    ms: float             # one call's time
    us_per_step: float
    cycles_per_step: float | None  # None on the CPU
    restarts: int         # over every lane
    restarts_per_1000: float  # a lane's restarts a 1,000 steps

    def line(self, chained: bool) -> str:
        call = f", {self.ms:.3f} ms/call" if chained else ""
        cyc = ("cycles not measured (cpu)" if self.cycles_per_step is None
               else f"{self.cycles_per_step:.1f} cycles/step")
        return (f"RESULT {self.case} {self.us_per_step:.4f} us/step "
                f"({self.steps} steps{call}); {cyc}; {self.restarts} "
                f"restarts ({self.restarts_per_1000:.3f} a lane per 1000 "
                "steps)")


def run(argv=None, *, chained: bool = False, default_lanes: int = 256):
    """Both tools' body: every case on the tool's lanes. ``chained``
    (gen-2's tool) times 8 calls, each call's window fed back as the next
    call's initial window; otherwise best of 3 single calls. Prints the
    RESULT lines and returns the :class:`Result` of each timed case."""
    args = parse(argv, default_lanes)
    from lzma_rs_tpu_torch.ops import step_cost as stc
    from lzma_rs_tpu_torch.parallel import devbench

    device = devbench.timing_device(args.device)
    cfg, inputs = staged_lanes(args.L, args.W, args.NLIT, args.NPS, device)
    clock = None
    if device.type == "cuda":
        from lzma_rs_tpu_torch.tools import probe_rows

        clock = probe_rows.card_peaks(device).clock_mhz
    name = devbench.device_info(device)["name"]
    print(f"{name}: L={cfg.L} W={cfg.W} W_IN={cfg.W_IN} NLIT={cfg.NLIT} "
          f"NPS={cfg.NPS} K={cfg.K}, {STEPS} steps a lane"
          + ("" if clock is None else f", max SM clock {clock:.0f} MHz")
          + f"; RING={args.RING}, UNROLL={args.UNROLL}: no counterpart "
          "(the decoder keeps its whole window and has no unrolled loop)",
          flush=True)
    results = []
    for case in CASES:
        if case in stc.NOT_PORTED:
            print(f"RESULT {case} {stc.NOT_PORTED[case]}", flush=True)
            continue
        out = {}

        def call(reps, case=case):
            win = inputs[1]
            for _ in range(reps):
                out["r"] = stc.decode_ablated(
                    case, inputs[0], win, *inputs[2:], config=cfg,
                    max_steps=STEPS)
                if chained:
                    win = out["r"][0]

        call(1)  # warm (and, on the card, the build)
        if chained:
            ms = time_calls(call, device, 8) / 8
        else:
            ms = min(time_calls(call, device, 1) for _ in range(3))
        _, _, _, steps, restarts = out["r"]
        n = int(steps.max())
        if int(steps.min()) != n or n != STEPS:
            raise RuntimeError(f"{case}: lanes ran {int(steps.min())}-{n} "
                               f"steps, not {STEPS}")
        total = int(restarts.long().sum())
        r = Result(case, n, ms, ms * 1e3 / n,
                   None if clock is None else ms * 1e-3 * clock * 1e6 / n,
                   total, total / cfg.L / n * 1000)
        print(r.line(chained), flush=True)
        results.append(r)
    return results


def main(argv=None):
    """The command line (gen-1's tool: best of 3 single calls)."""
    return run(argv, chained=False, default_lanes=256)


if __name__ == "__main__":
    main()
