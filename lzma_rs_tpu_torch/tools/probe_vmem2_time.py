"""Where the time of one `.xz` decode on the card goes, stage by stage.

The port of ``tools/probe_vmem2_time.py`` (the kernel's device time
against packing and transfers), widened to the whole call. The stages are
the main path's own: one ``runtime.xz_decode(engine="cuda")`` a call, its
named stages (``runtime.stage``, ``parallel/runtime.py``) timed where
they run through ``runtime.stage_hook``, for ``calls`` warm calls:

- ``plan_xz``: the container walk, ``runtime.plan_xz`` with
  ``check_index``;
- ``stage_plans``: the lanes packed into one batch;
- ``h2d``: ``StagedLanes.tensors`` (a slab's copy to the card);
- ``decode_segments``: the kernel's launch, timed between CUDA events;
- ``d2h``: ``runtime.copy_back``;
- ``placement``: ``runtime.place_results``;
- ``check_blocks``: ``runtime.check_blocks``, the main path's pool;
- ``check_footer``: the stream footer.

The card is synchronized at each stage's start and end, so a stage's time
holds its own device work; ``slabs`` (``runtime.run_slabs``, which holds
``h2d``, ``decode_segments`` and ``d2h``) is reported beside them as a
cross-check. A stage the main path adds, drops or renames fails the
breakdown. Beside
them, the whole call without the hook, timed by the host clock in turn
with the staged call. Each stage's median, min and max, and the stages'
sum against the whole call. On a one-card host the slab is the whole
batch. Each call starts from a full collection of the interpreter's
garbage (timed: the garbage the call before left), so a collection that
earlier calls set off does not land in one side of the comparison at
random; the time the collector runs inside each stage is recorded beside
it (``gc.callbacks``).

:func:`crc_rows` prices the device CRC (``ops/crc_device.py``: the
``crc_blocks`` kernel beside its plain version and the plain version's
product) against ``check_blocks``' host hashing of the same blocks. The
reference sends only blocks of 1 MiB or more to its device CRC
(``lzma_rs_tpu/parallel/runtime.py:1628-1633``), so it runs on archives in
1 MiB blocks.

Usage (on the card; ``--device cpu`` runs the kernel's plain version,
labelled ``cpu``)::

    python -m lzma_rs_tpu_torch.tools.probe_vmem2_time [MB] [BLOCK]
        [--calls N] [--device cpu]

MB (default 16) of the stdlib corpus as (a) the tpu_profile archive in
BLOCK-byte blocks (default 8192) and (b) the stock-shaped 64 KiB-block
one; the CRC rows on (c), the same bytes in 1 MiB blocks (CRC64), and on
the tpu_profile archive in 1 MiB blocks (CRC32).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time
from typing import Optional

import numpy as np
import torch

from lzma_rs_tpu_torch.formats import xz as xz_fmt
from lzma_rs_tpu_torch.ops import crc_device
from lzma_rs_tpu_torch.parallel import devbench, runtime
from lzma_rs_tpu_torch.tools import probe_rows
from lzma_rs_tpu_torch.utils import stats

KERNEL = "decode_segments"  # the kernel's stage
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12   # H100 SXM data sheet, int8 tensor cores, dense
FP32_FLOP_PER_S = 67e12    # H100 SXM data sheet, float32 without tensor cores
KERNEL_REPS = 5  # the CRC kernel's and its plain version's times: median
STAGES = ("plan_xz", "stage_plans", "h2d", KERNEL, "d2h", "placement",
          "check_blocks", "check_footer")
WHOLE = "xz_decode"
SLABS = "slabs"  # h2d, the kernel and d2h of every slab, and the synchronize
DEVICE_STAGES = ("h2d", KERNEL, "d2h")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GcClock:
    """Milliseconds the interpreter's cyclic garbage collector ran while
    installed (``with``), through ``gc.callbacks``."""

    def __init__(self):
        self.ms = 0.0
        self._t = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def staged_call(archive: bytes, device: torch.device) -> tuple:
    """One ``runtime.xz_decode(engine="cuda")`` with each of the main
    path's stages timed where it runs (``runtime.stage_hook``): the card
    synchronized at each stage's start and end, the kernel between CUDA
    events, a stage that runs once a slab summed over the slabs. Raises if
    the call left the device path, skipped a stage of :data:`STAGES` or
    ran one the breakdown does not know. Returns ``(output, {stage: ms},
    {stage: ms of it the collector ran})``, the stages with ``slabs``."""
    ms, gc_ms, open_ = {}, {}, {}
    clock = GcClock()

    def hook(name: str, start: bool) -> None:
        ev = None
        if name == KERNEL and device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        _sync(device)
        now = time.perf_counter()
        if start:
            open_[name] = (now, clock.ms, ev)
            return
        t, g, ev0 = open_.pop(name)
        took = ev0.elapsed_time(ev) if ev is not None else (now - t) * 1e3
        ms[name] = ms.get(name, 0.0) + took
        gc_ms[name] = gc_ms.get(name, 0.0) + clock.ms - g

    with stats.collect() as st, clock, runtime.stage_hook(hook):
        out = runtime.xz_decode(archive, engine="cuda", device=device)
    if st.engine != device.type or st.fallbacks:
        raise RuntimeError(f"the call left the device path: engine "
                           f"{st.engine!r}, fallbacks {st.fallbacks}")
    known = set(STAGES) | {SLABS, WHOLE}
    if set(ms) != known:
        raise RuntimeError(f"the call's stages {sorted(ms)} are not the "
                           f"breakdown's {sorted(known)}")
    del ms[WHOLE], gc_ms[WHOLE]
    return out, ms, gc_ms


def whole_call(archive: bytes, device: torch.device) -> tuple:
    """``runtime.xz_decode(engine="cuda")`` timed by the host clock (it
    ends in a synchronize); raises if it left the device path. Returns
    ``(output, ms, ms of it the collector ran)``."""
    with stats.collect() as st, GcClock() as clock:
        t = time.perf_counter()
        out = runtime.xz_decode(archive, engine="cuda", device=device)
        secs = time.perf_counter() - t
    if st.engine != device.type or st.fallbacks:
        raise RuntimeError(f"the call left the device path: engine "
                           f"{st.engine!r}, fallbacks {st.fallbacks}")
    return out, secs * 1e3, clock.ms


def collect_ms() -> float:
    """A full collection (``gc.collect()``), in ms: the garbage the call
    before left."""
    t = time.perf_counter()
    gc.collect()
    return (time.perf_counter() - t) * 1e3


def spread(samples: list, gc_samples: Optional[list] = None) -> dict:
    """Median, min and max of ``samples``, and the collector's ms in
    each."""
    r = {"median": statistics.median(samples), "min": min(samples),
         "max": max(samples), "samples": samples}
    if gc_samples is not None:
        r["gc_samples"] = gc_samples
    return r


def breakdown(archive: bytes, device=None, calls: int = 5,
              expected: Optional[bytes] = None) -> dict:
    """Each stage's median, min and max over ``calls`` warm calls, in
    milliseconds, the whole call's, and the stages' sum (of medians) over
    the whole call. Raises when a call's bytes differ from ``expected``
    (where given) or from each other, or when it leaves the device
    path."""
    device = devbench.timing_device(device)
    first = whole_call(archive, device)[0]  # warm
    if expected is not None and first != expected:
        raise RuntimeError("the decode differs from the expected bytes")
    samples = {s: [] for s in STAGES + (SLABS, WHOLE)}
    gc_samples = {s: [] for s in STAGES + (SLABS, WHOLE)}
    collects = []
    for _ in range(calls):
        collects.append(collect_ms())
        out, ms, gc_ms = staged_call(archive, device)
        collects.append(collect_ms())
        out2, call_ms, call_gc = whole_call(archive, device)
        for s in STAGES + (SLABS,):
            samples[s].append(ms[s])
            gc_samples[s].append(gc_ms[s])
        samples[WHOLE].append(call_ms)
        gc_samples[WHOLE].append(call_gc)
        if out != first or out2 != first:
            raise RuntimeError("a call decoded other bytes than the first")
    result = {s: spread(v, gc_samples[s]) for s, v in samples.items()}
    stage_sum = sum(result[s]["median"] for s in STAGES)
    call = result[WHOLE]["median"]
    return {
        "device": devbench.device_info(device),
        "calls": calls,
        "out_bytes": len(first),
        "stages": {s: result[s] for s in STAGES},
        SLABS: result[SLABS],
        WHOLE: result[WHOLE],
        "collect_ms": spread(collects),
        "stage_sum_ms": stage_sum,
        "sum_over_call": stage_sum / call,
        # the stages that wait on the card, over the call: at most the
        # device's busy share (h2d also holds the host's copy)
        "device_stage_share": sum(result[s]["median"] for s in DEVICE_STAGES)
        / call,
    }


def crc_rows(archive: bytes, device=None, reps: int = 3) -> dict:
    """The device CRC of every block of ``archive`` (CRC32 or CRC64 checks)
    against the host's ``check_blocks`` on the same decoded blocks.

    First the path a caller runs: every block through ``crc32_device`` /
    ``crc64_device``, each equal to its stored check or it raises, with
    ``crc_raw.launches`` set to 0 just before and read just after
    (``launches``). Then ``crc_raw`` (the kernel on the card) against
    ``crc_raw_reference`` (its plain version) on every block's full chunks,
    already on the device: ``max_abs_err``, the largest difference of the
    two registers over the blocks (0 when every block agrees bit for bit).
    Returns the best of ``reps`` of ``device_ms``, every block through the
    check functions from ``bytes`` (copy in, one launch, 8 bytes back, the
    host's tail and correction), ``product_ms`` (``crc_parity``, the plain
    version's float32 product, on every block's chunks) and ``host_ms``,
    ``check_blocks``; the median of ``KERNEL_REPS`` of ``kernel_ms``, the
    card's time for ``crc_raw`` on every block's chunks (a launch a block,
    the host's calls enqueued before the card reaches them),
    ``one_launch_ms``, the same for all the blocks' chunks as one tensor,
    ``wrapper_ms``, a launch a block as the host issues them (the wrapper's
    host time included), and ``plain_ms`` (``crc_raw_reference`` on every
    block's chunks); CUDA events on the card, the host clock on the CPU.
    Bounds on an H100: ``kernel_bound_ms``, the chunks' bytes read once and
    the register written over 3.35 TB/s (a table CRC's two integer
    operations a byte, at 132 SMs x 64 INT32 lanes x 1.98 GHz, take 0.12
    ps a byte against the read's 0.30 ps, so bytes bound it on every
    input); ``bound_ms`` (by ``bound_by``) the product's, its operations at
    the int8 tensor-core rate, and ``fp32_ops_ms`` the same operations at
    the float32 rate."""
    device = devbench.timing_device(device)
    (plans, block_spans, header_flags, records,
     cursor) = runtime.plan_xz(archive)
    method = header_flags.check_method
    if method not in (xz_fmt.CHECK_CRC32, xz_fmt.CHECK_CRC64):
        raise ValueError(f"check method {method}: CRC32 or CRC64 only")
    width = 32 if method == xz_fmt.CHECK_CRC32 else 64
    fn = crc_device.crc32_device if width == 32 else crc_device.crc64_device
    out = runtime.xz_decode(archive, engine="native")
    blocks = [(out[o:o + n], int.from_bytes(
        archive[c:c + width // 8], "little")) for _, c, o, n in block_spans]
    crc_device.crc_raw.launches = 0
    for i, (block, stored) in enumerate(blocks):  # also the warm call
        got = fn(block, device)
        if got != stored:
            raise RuntimeError(f"block {i}: device CRC {got:#x} != stored "
                               f"{stored:#x}")
    launches = crc_device.crc_raw.launches
    C = crc_device.CHUNK
    chunks = [torch.from_numpy(np.frombuffer(b, dtype=np.uint8)[
        :len(b) // C * C].reshape(-1, C).copy()).to(device)
        for b, _ in blocks if len(b) >= C]
    max_abs_err = max(abs(
        crc_device.register(crc_device.crc_raw(c, width))
        - crc_device.register(crc_device.crc_raw_reference(c, width)))
        for c in chunks)
    best = {"device_ms": float("inf"), "product_ms": float("inf"),
            "host_ms": float("inf")}
    for _ in range(reps):
        t = time.perf_counter()
        for block, _ in blocks:
            fn(block, device)
        best["device_ms"] = min(best["device_ms"],
                                (time.perf_counter() - t) * 1e3)
        best["product_ms"] = min(best["product_ms"], _chunks_ms(
            chunks, crc_device.crc_parity, width, device))
        t = time.perf_counter()
        runtime.check_blocks(archive, out, block_spans, header_flags)
        best["host_ms"] = min(best["host_ms"],
                              (time.perf_counter() - t) * 1e3)
    every = [torch.cat(chunks)]

    def median(rows: list, fn, hold: bool) -> float:
        return statistics.median(_chunks_ms(rows, fn, width, device, hold)
                                 for _ in range(KERNEL_REPS))

    times = {"kernel_ms": median(chunks, crc_device.crc_raw, True),
             "one_launch_ms": median(every, crc_device.crc_raw, True),
             "wrapper_ms": median(chunks, crc_device.crc_raw, False),
             "plain_ms": median(chunks, crc_device.crc_raw_reference,
                                False)}
    del every
    nchunks = sum(c.shape[0] for c in chunks)
    # the product's floor: each byte read once, and 2 x 32,768 x width
    # operations a chunk over the chunks this archive has, at the card's
    # fastest exact rate for 0/1 operands: int8 tensor cores with int32
    # sums (a sum is at most 32,768). ``fp32_ops_ms``: the same operations
    # at the float32 rate the plain version's product runs at.
    ops = 2 * nchunks * C * 8 * width
    t_bytes, t_ops = len(out) / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return {"device": devbench.device_info(device), "blocks": len(blocks),
            "block_bytes": max(len(b) for b, _ in blocks), "width": width,
            "out_bytes": len(out), "chunks": nchunks, **best,
            "launches": launches, "max_abs_err": max_abs_err, **times,
            "kernel_bound_ms": (nchunks * C + 8) / HBM_BYTES_PER_S * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fp32_ops_ms": ops / FP32_FLOP_PER_S * 1e3}


def _chunks_ms(chunks: list, fn, width: int, device: torch.device,
               hold: bool = False) -> float:
    """Milliseconds of ``fn(c, width)`` over every block's chunks ``c``:
    CUDA events on the card, the host clock on the CPU. ``hold`` keeps the
    card's stream busy before the start event, so every call is enqueued
    before the card reaches it and the time is the card's alone."""
    if device.type != "cuda":
        t = time.perf_counter()
        for c in chunks:
            fn(c, width)
        return (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(probe_rows.HOLD_CYCLES)
    start.record()
    for c in chunks:
        fn(c, width)
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop)


def crc_text(c: dict) -> str:
    """One line of :func:`crc_rows`."""
    return (f"{c['blocks']} blocks of <= {c['block_bytes']} B, "
            f"CRC{c['width']}: each block's device CRC == its stored check "
            f"({c['launches']} launches); crc_raw against its plain version "
            f"on every block's chunks: max_abs_err {c['max_abs_err']}; "
            f"kernel {c['kernel_ms']:.4f} ms on the card over the "
            f"{c['chunks']} chunks, a launch a block ({c['one_launch_ms']:.4f}"
            f" ms in one launch; {c['wrapper_ms']:.4f} ms with the wrapper's "
            f"host time; median of {KERNEL_REPS}), bound "
            f"{c['kernel_bound_ms']:.4f} ms by bytes; plain version "
            f"{c['plain_ms']:.2f} ms, its product (library_ms) "
            f"{c['product_ms']:.3f} ms (the product's bound "
            f"{c['bound_ms']:.4f} ms by {c['bound_by']} at the int8 rate, "
            f"{c['fp32_ops_ms']:.3f} ms of float32 operations); the whole "
            f"check functions {c['device_ms']:.2f} ms against the host "
            f"checks {c['host_ms']:.2f} ms (each the best of its calls)")


def _text(name: str, v: dict) -> str:
    gc_max = max(v["gc_samples"])
    return (f"{name} {v['median']:.2f} ({v['min']:.2f}-{v['max']:.2f}"
            + (f", collector up to {gc_max:.2f}" if gc_max >= 0.01 else "")
            + ")")


def stage_text(r: dict) -> str:
    """One line of a breakdown: every stage's median (min-max, and the
    most the collector ran in it) in ms."""
    c = r["collect_ms"]
    return (f"{'; '.join(_text(s, v) for s, v in r['stages'].items())}; "
            f"{_text('slabs (h2d, decode_segments, d2h)', r[SLABS])}; "
            f"{_text('the whole call', r[WHOLE])} ms; stages' sum "
            f"{r['stage_sum_ms']:.2f} ms = {r['sum_over_call']:.3f} x the "
            f"call; h2d, kernel and d2h {r['device_stage_share']:.4f} of "
            f"the call; a full collection before each call "
            f"{c['median']:.2f} ({c['min']:.2f}-{c['max']:.2f}) ms")


def main(argv=None) -> None:
    """The command line: the stage breakdown on the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mb", nargs="?", type=float, default=16.0)
    ap.add_argument("block", nargs="?", type=int, default=8192)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu: the kernel's plain version (default: the "
                         "current CUDA device)")
    args = ap.parse_args(argv)
    from lzma_rs_tpu_torch.tools import corpus

    device = devbench.timing_device(args.device)
    data, _ = corpus.stdlib_corpus(int(args.mb * 1e6))
    archives = {"a": corpus.tpu_archive(data, args.block),
                "b": corpus.stock_archive(data)}
    report = {"device": devbench.device_info(device), "mb": args.mb}
    for key, x in archives.items():
        r = breakdown(x, device, calls=args.calls, expected=data)
        print(f"({key}) {len(x)} B, {args.calls} calls: {stage_text(r)}",
              flush=True)
        report[key] = r
    c = crc_rows(corpus.stock_archive(data, 1 << 20), device)
    print(f"(c) {crc_text(c)}", flush=True)
    report["c_crc"] = c
    c = crc_rows(corpus.tpu_archive(data, 1 << 20), device)
    print(f"(c32) {crc_text(c)}", flush=True)
    report["c32_crc"] = c
    print(json.dumps(report))


if __name__ == "__main__":
    main()
