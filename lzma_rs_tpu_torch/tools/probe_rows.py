"""Rows of the probe tools: what a row runs, how it is timed, its bound.

A probe tool (``probe_lane2d``, ``probe_state_in_ref``, ``probe_mosaic``,
``probe_mosaic2``, ``probe_mosaic3``, ``probe_mosaic4``, ``probe_round4``,
``probe_lane2d_bisect``) is a list of rows ``(name, build)``;
``build(device)`` returns ``(fn, args, lanes)`` as the JAX package's tools
do, where ``fn`` is a :class:`Probe`, ``args`` its inputs and ``lanes``
its threads. :func:`run` times every row (CUDA events on the card, the host clock for
the plain version on the CPU) and prints the tools' columns, plus, on the
card, the time per iteration of a long run and the least time the card
could take (``bound_ms``); every row also prints its output's checksum.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import probes

LONG_ITERS = 8192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64    # Hopper architecture white paper


_NUMPY = {torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8,
          torch.uint8: np.uint8}


@dataclasses.dataclass(frozen=True)
class Probe:
    """One row's function: ``wrapper(*view(*inputs), iters=iters, **kwargs,
    **layout)``.

    ``kwargs`` are the function's parameters (initial state, rounds, mode);
    ``layout`` is where the kernel keeps its table and state, which does
    not change the result; ``iters`` is the tool's iteration count.
    ``ops`` is the integer operations per lane (thread) and iteration,
    ``words`` the 4-byte words per lane that the function moves once
    (inputs read once, outputs written once), or a function of the inputs
    that counts the words those inputs need, where the walk depends on the
    data. ``seeded`` is one range per input for a seeded random one
    (drawn, then wrapped to the input's type), or a function ``(rng,
    shape) -> array`` that draws it. ``ran``, where the loop can end early,
    is ``ran(*inputs, iters=n)``: the iterations the function runs on those
    inputs when asked for ``n``. ``long_iters`` is the second count of the
    slope (above ``iters``); ``check_iters``, where set, the count at which
    a kernel is held against its plain version (``iters`` otherwise: a
    smaller count where the plain version at the tool's would take
    minutes)."""

    wrapper: Callable
    view: Callable
    kwargs: dict
    layout: dict
    ops: float
    words: Union[float, Callable]
    seeded: tuple
    iters: int = probes.ITERS
    ran: Optional[Callable] = None
    long_iters: int = LONG_ITERS
    check_iters: Optional[int] = None

    def __call__(self, *xs, **kw):
        """The row on its inputs; ``kw`` may override the parameters."""
        return self.wrapper(*self.view(*xs), **{
            "iters": self.iters, **self.kwargs, **self.layout, **kw})

    def plain(self, *xs, **kw):
        """The plain PyTorch version, on the inputs' device."""
        return self.wrapper.reference(*self.view(*xs), **{
            "iters": self.iters, **self.kwargs, **kw})

    def words_for(self, *xs) -> float:
        return self.words(*xs) if callable(self.words) else self.words

    def ran_for(self, *xs, iters: int) -> int:
        """The iterations the row runs on ``xs`` when asked for ``iters``."""
        return iters if self.ran is None else self.ran(*xs, iters=iters)

    def seeded_inputs(self, like: tuple, seed: int) -> tuple:
        """Random inputs of ``like``'s shapes, types and device, from
        ``seed``."""
        rng = np.random.default_rng(seed)
        out = []
        for t, spec in zip(like, self.seeded):
            if callable(spec):
                a = spec(rng, tuple(t.shape))
            else:
                lo, hi = spec
                wide = lo < -2**31 or hi > 2**31
                a = rng.integers(lo, hi, size=tuple(t.shape),
                                 dtype=np.int64 if wide else np.int32)
            out.append(torch.from_numpy(a.astype(_NUMPY[t.dtype]))
                       .to(t.device))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Peaks:
    sms: int
    clock_mhz: float   # the card's max SM clock (nvidia-smi)
    int32_ops_per_s: float
    bytes_per_s: float


def card_peaks(device) -> Peaks:
    """The card's INT32 rate, SMs x 64 INT32 lanes x the max SM clock,
    and the memory rate of the H100 SXM. The INT32 rate is a lower
    estimate of the card's integer issue rate: integer multiply-adds also
    issue on the FP32 pipe, so a mix with multiplies can go up to twice as
    fast, and a bound from this rate can be up to twice the true floor."""
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(device.index or 0),
         "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return Peaks(sms, mhz, sms * INT32_LANES_PER_SM * mhz * 1e6,
                 HBM_BYTES_PER_S)


def bound(fn: Probe, lanes: int, iters: int, peaks: Peaks,
          xs: tuple = ()) -> tuple:
    """(ms, "bytes" or "operations", bytes ms, operations ms): the least
    time of ``iters`` iterations (those the row runs on ``xs``, where its
    loop can end early) over ``lanes`` lanes (threads: one per
    output element where the work is per element, one for a single
    chain) on the inputs ``xs``, operations over the INT32 rate of
    :func:`card_peaks` (a lower estimate of the rate, so the operations'
    time is an upper estimate of their floor). For a single thread this is
    a throughput figure that one dependent chain cannot approach."""
    t_bytes = 4 * fn.words_for(*xs) * lanes / peaks.bytes_per_s
    t_ops = (fn.ops * lanes * fn.ran_for(*xs, iters=iters)
             / peaks.int32_ops_per_s)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


HOLD_CYCLES = 4_000_000  # ~2 ms: longer than the host takes to enqueue


def median_ms(call, reps: int = 5) -> float:
    """Median device milliseconds of ``call()`` over ``reps`` calls, each
    between its own CUDA events (after one warm call). The stream is held
    busy before each start event, so the call's work is enqueued before
    the card reaches it: the time is the device's, without the host's
    Python between launches."""
    call()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        call()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def measure(name: str, fn: Probe, xs: tuple, lanes: int, *,
            what: str = "tool", peaks: Peaks | None = None) -> dict:
    """Time one row on one set of inputs. On the card: the first call
    (with the library's build when it is the first), the median of 5 at
    the tool's iterations (``ms``: the whole wrapper call, its copy of the
    table and its state set-up included), at 0 iterations (``setup_ms``:
    that set-up and an empty launch) and at the row's ``long_iters``
    (LONG_ITERS unless the row sets another), and the slope
    between the two (set-up and launch drop out), per iteration run where
    the row's loop can end early. On the CPU: one call of the plain
    version."""
    its = fn.iters
    dev = xs[0].device
    r = {"name": name, "input": what, "kernel": fn.wrapper.__name__,
         "lanes": lanes, "iters": its, "device": str(dev)}
    t = time.perf_counter()
    out = fn(*xs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        r["first_s"] = time.perf_counter() - t
        r["ms"] = median_ms(lambda: fn(*xs))
        r["setup_ms"] = median_ms(lambda: fn(*xs, iters=0))
        r["ms_long"] = median_ms(lambda: fn(*xs, iters=fn.long_iters))
        r["iters_run"] = fn.ran_for(*xs, iters=its)
        r["iters_run_long"] = fn.ran_for(*xs, iters=fn.long_iters)
        if r["iters_run_long"] > r["iters_run"]:
            r["ns_per_iter"] = ((r["ms_long"] - r["ms"]) * 1e6
                                / (r["iters_run_long"] - r["iters_run"]))
            r["cycles_per_iter"] = r["ns_per_iter"] * peaks.clock_mhz / 1e3
            r["cycles_per_op"] = r["cycles_per_iter"] / fn.ops
        else:  # the loop ends early at both counts: no slope to read
            r["ns_per_iter"] = r["cycles_per_iter"] = None
            r["cycles_per_op"] = None
        b = bound(fn, lanes, its, peaks, xs)
        r["bound_ms"], r["bound_by"] = b[0], b[1]
    else:
        r["ms"] = (time.perf_counter() - t) * 1e3
    r["us_per_it"] = r["ms"] * 1e3 / its
    r["ns_per_lane_bit"] = r["ms"] * 1e6 / its / lanes
    r["checksum"] = int(out.long().sum())  # the output's, as int64
    return r


def row_text(r: dict) -> str:
    """One probe row's result as a line of text."""
    head = (f"{r['name'] + ' [' + r['input'] + ']':52s} OK  sum "
            f"{r['checksum']}  ")
    if "ms_long" not in r:
        return (head + f"cpu plain version {r['us_per_it']:9.3f} us/it  "
                f"{r['ns_per_lane_bit']:9.3f} ns/lane-bit")
    if r["ns_per_iter"] is None:
        long = (f"long: {r['iters_run']} iterations run at both counts, "
                "no slope")
    else:
        long = (f"long {r['ns_per_iter']:8.2f} ns/it "
                f"({r['cycles_per_iter']:7.1f} cyc, "
                f"{r['cycles_per_op']:5.2f} cyc/op)")
    return (head + f"first {r['first_s']:6.2f}s  {r['us_per_it']:8.3f} "
            f"us/it  {r['ns_per_lane_bit']:7.4f} ns/lane-bit  set-up "
            f"{r['setup_ms'] * 1e3:.1f} us  {long}  bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")


def run(rows, device, *, seed: int | None = None) -> list:
    """Time every row on its tool's input and, with ``seed``, on a seeded
    random one; print each row and return the measurements."""
    peaks = card_peaks(device) if device.type == "cuda" else None
    results = []
    for i, (name, build) in enumerate(rows):
        fn, args, lanes = build(device)
        inputs = [("tool", args)]
        if seed is not None:
            inputs.append(("seeded", fn.seeded_inputs(args, seed + i)))
        for what, xs in inputs:
            r = measure(name, fn, xs, lanes, what=what, peaks=peaks)
            print(row_text(r), flush=True)
            results.append(r)
    return results


def main(rows, argv=None, prog=None, substring: bool = False) -> list:
    """The tools' command line: ``[which] [--device cuda|cpu] [--seed N]``;
    ``which`` picks the rows whose name starts with it, or holds it where
    ``substring`` is set (the bisect tool's filter)."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("which", nargs="?", default="",
                    help="run only the rows whose name "
                    + ("holds" if substring else "starts with") + " this")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=None,
                    help="also run each row on a seeded random input")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu for the plain "
                         "versions)")
    device = torch.device(a.device, 0) if a.device == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        print("device:", torch.cuda.get_device_name(device), flush=True)
    picked = [r for r in rows if (a.which in r[0] if substring
                                  else r[0].startswith(a.which))]
    return run(picked, device, seed=a.seed)
