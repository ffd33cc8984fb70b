#!/usr/bin/env python3
"""Drive the PyTorch port's `.xz` decode once on one CUDA card, and check it.

Run from the root of a checkout, on a machine with a CUDA card, the CUDA
toolkit (nvcc) and g++:

    python3 chip_smoke.py

It imports only ``lzma_rs_tpu_torch`` (no JAX, nothing of ``lzma_rs_tpu``),
builds the segment-decoder kernel, its variants, its step-cost builds,
the probe kernels, the lane engine and the device CRC from
``lzma_rs_tpu_torch/csrc`` and
the port's native host library into
``lzma_rs_tpu_torch/build/``, then runs:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the kernel (nvcc, ptxas summary) and the native host library;
3. kernel against plain version: ~32 lanes of <= 4 KiB segments (stdlib
   ``lzma`` raw LZMA2 at presets 1/6/9 and several lc/lp/pb, a multi-
   segment stream, a multi-chunk segment, a stored chunk mid-segment, the
   lc=0 distance-capped profile, flipped bytes, truncated inputs) through
   ``decode_segments`` and ``decode_segments_reference`` on the card;
4. the main path at full size: ``xz_decompress`` with
   ``LZMA_RS_TPU_BACKEND=cuda`` on 16,000,000 bytes of the interpreter's
   stdlib sources (cycled if the installation holds fewer;
   ``lzma_rs_tpu_torch/tools/corpus.py``), as (a) the
   tpu_profile archive (8 KiB blocks, lc=0) and (b) a stock-shaped archive
   (stdlib ``lzma`` preset 6 per 64 KiB block, CRC64); end-to-end,
   kernel-only and native MB/s; the kernel's cycles a step (its time at
   the max SM clock over the longest lane's steps), its shared memory a
   lane and the lanes resident on an SM (the CUDA occupancy query, held
   to every lane in one wave); the kernel against its plain version in
   each archive's own bucket: (a)'s whole batch, and four lanes of (b)
   (its tail block whole, three lanes cut to that length: the plain
   version's time is its longest lane's); then the default ``auto``
   engine: the card for (a), the host for a 64 KiB archive (the
   small-workload gate);
5. a corrupt archive: the same exception and message as the native engine;
6. the gen-1 configuration: (a) through ``xz_decompress`` under
   ``LZMA_RS_TPU_VMEM_GEN=1`` (one bucket for window and staged input,
   W == W_IN); the kernel at that bucket against the gen-2 bucket (time,
   and the whole batch's outputs) and against its plain version on 32
   lanes of it (the tail block whole, 31 lanes cut to its length);
7. the probe kernels (``csrc/probes.cu``): every row of the two probe
   tools (``lzma_rs_tpu_torch/tools/probe_lane2d.py``, its three table
   placements at 2,048 lanes included, and ``probe_state_in_ref.py``) on
   the tool's input and on a seeded random one, timed at the tools' 256
   iterations, at 8,192 and at 0 (the wrapper's table copy and state
   set-up, ``setup_ms`` beside ``ms``; CUDA events, median of 5); then
   every row's kernel against its plain version on both inputs, bit for
   bit (output, final table, ring and state); bitdecode_chain's ns and
   cycles an iteration on every row (its pipelined lane: both candidate
   rows loaded before the bit) with each kernel's registers and spills
   (none allowed), the main row's beside its time before that design;
   realweight_step's registers
   and spills (none allowed), blocks, threads and shared memory a block,
   and an iteration's split into a round's ns and a fixed part from y4's
   and y6's slopes; tinyops_chain's ns and cycles a round from its main
   row's slope, and (a model at assumed latencies) the loop's SASS chain
   a round (``tools/sass_chain.py``);
8. the mosaic probe kernels (``csrc/probes_mosaic.cu``): every row of
   ``lzma_rs_tpu_torch/tools/probe_mosaic.py`` (15) and
   ``probe_mosaic2.py`` (6) on the tool's input and on a seeded one
   (tables over the full int32 range, start indices within 1,024 of
   +-2^31, so they wrap in int32 before the floor mod), timed as in
   phase 7 at the tool's own iterations (512, 64), 8,192 and 0; then each
   row's kernel against its plain version on both inputs, bit for bit
   (output, final table, carried state); P4's kernel (a thread a lane,
   its two source words in registers) and P5's (a block a lane, the
   column in shared memory) with their lanes and threads a block, blocks,
   SMs, registers and spills (none allowed) and shared memory a block,
   each row's ns and cycles an iteration, call and set-up, and P4's loop
   from ``cuobjdump -sass`` (no load inside it, none allowed; its chain
   at assumed latencies, a model); gather_sum's threads an
   output, threads a block, blocks and SMs a row, and the library call on
   its main row (C [128, 2048]: ``torch.gather`` and a sum, the index
   built outside the timed region, held equal to the kernel's output;
   ``library_ms``); rw_chain's D (a warp a row) and E (the row in shared
   memory) with their threads a row, threads a block, blocks, SMs,
   registers and spills (none allowed), and D's library call on its main
   row (D [128, 2048]: ``clone`` and ``scatter_add_``, the index built
   outside, held equal to the kernel's output; ``library_ms``); each
   row_chain row's kernel (lanes and threads a block, blocks, SMs,
   registers, spills, none allowed, shared memory a block), and P1's
   library call (``clamp`` and ``sum`` over the rows the walk visits,
   held equal to the kernel's output; beside P1's kernel time under the
   kernel line's ``library_of``: no PyTorch call computes P6, the main
   row, so its ``library_ms`` is null);
9. the mosaic3 probe kernels (``csrc/probes_mosaic3.cu``): the 12 rows of
   ``lzma_rs_tpu_torch/tools/probe_mosaic3.py`` on the tool's input and
   on a seeded one (tables over the full int32 range; P7-P9 from a start
   with one lane at -2^30, so every iteration runs; P11 from a start over
   the full int32 range), timed as in phase 8 at 64 iterations, 8,192
   and 0 (per iteration run: from the tool's zeros P7-P9 leave after 10
   at both counts, and have no slope); each row's kernel against its
   plain version on both inputs, bit for bit (output, carried state,
   P16's scratch); the kernel of each row (P7-P9 one warp for all lanes,
   P10, P11a/b a thread a lane, P12s-P16) with its lanes and threads a
   block, blocks, SMs, registers, spills (none allowed) and shared memory
   a block; and from ``cuobjdump -sass`` whether nvcc made one SASS of
   P11a's byte pick and P11b's select, and each one's pass of four steps:
   its PRMTs, variable shifts and selects (P11a must hold a PRMT a step
   and no variable shift);
10. the mosaic4 probe kernel (``csrc/probes_mosaic4.cu``): the 7 rows of
    ``lzma_rs_tpu_torch/tools/probe_mosaic4.py`` (``build``'s four
    variants, ``build2``'s three) on the tool's input (zeros) and on a
    seeded start (idx outside the table on some lanes, acc negative on
    some, ``k`` over the full int32 range, ``it`` from [0, 56)), timed at
    the tool's limit of 64 steps, 8,192 and 0 (per step run); each row's
    kernel against its plain version on both inputs, bit for bit (output,
    final table and tile, carry); each kernel's lanes a block, threads a
    block, blocks, SMs, registers, spills (none allowed) and shared memory
    a block;
11. the round4 probe kernels (``csrc/probes_round4.cu``): the 20 rows of
    ``lzma_rs_tpu_torch/tools/probe_round4.py`` on the tool's input and on
    a seeded one (tables over their type's full range, all four state
    slots over the full int32 range), timed at the tool's 16,384
    iterations, 32,768 and 0; each row's kernel against its plain version
    on both inputs at 1,024 iterations (the plain version at 16,384 would
    take minutes), bit for bit (output, final table, four state slots);
    each row's lanes a block, shared memory a block, registers and spills
    beside its ns and cycles an iteration; every chain kernel's loop read
    from ``cuobjdump -sass`` (shared-memory loads, no global ones); the
    measured cost of one more chained read (sel1-sel4's slope); and, as a
    model at assumed latencies, the SASS chain of sel1 and blend_par3
    (``tools/sass_chain.py``);
12. the bisect probe kernel (``csrc/probes_bisect.cu``): the 16 rows of
    ``lzma_rs_tpu_torch/tools/probe_lane2d_bisect.py`` (the bit decode's
    stages added one by one) on the tool's input and on a seeded one (a
    table and starts over the full int32 range), timed at the tool's 32
    iterations, 8,192 and 0; each row's kernel against its plain version
    on both inputs, bit for bit (output, final table, final state); the
    stage costs (differences between rows) beside the first design's,
    and whether nvcc kept w1's and w2's loop-invariant loads (global and
    shared) inside the loop (``cuobjdump -sass``); each kernel's lanes a
    block, threads a block, blocks, SMs, registers, spills (none allowed)
    and shared memory a block;
13. lane batching: (a) through ``xz_decompress`` with
    ``LZMA_RS_TPU_VMEM_L=256``, 8 launches on one card (bit-exact, engine
    ``cuda``, no fallbacks, ``stats.devices == 1``), its slabs' summed
    kernel time beside phase 4's single launch; the dry run
    (``graft_entry.dryrun_multichip(1)``: flagship-shaped, stock-shaped
    and corrupt archives in slabs); ``graft_entry.entry()`` once against
    its plain version;
14. the decoder's variants (``csrc/decode_variants.cu``,
    ``ops/segment_variants.py``: V0 a thread a lane with everything in
    global memory, V1 a warp a lane, V2 the table in shared memory, V3 the
    window too (the decoder), V4 one thread copying, V5 the input
    look-ahead, S3 V4 run by one thread a lane and a block, without the
    warp team) on (a)'s and (b)'s whole batch, in turns (V0, V3, V1, ...,
    V1, V3, V0), CUDA events, median of 3 a visit;
    each variant's outputs held equal to the decoder's (which phases 3, 4
    and 6 hold against the plain version); ms and cycles a step of each,
    and the differences as stage costs;
15. the measurement modules, on (a) and (b) and on (c), the corpus in
    1 MiB blocks (stdlib ``lzma`` preset 6, CRC64):
    ``parallel/devbench.device_throughput`` on each batch (bit-exact, its
    kernel time within 10% of phase 4's); the stage breakdown
    (``tools/probe_vmem2_time.py``, 3 calls: each stage's median, min and
    max, the bytes equal to the corpus, the stages' sum within 0.5-1.5 x
    the whole call); the device CRC (``ops/crc_device.py``, the
    ``crc_blocks`` kernel of ``csrc/crc_blocks.cu``) of every (c) block
    (CRC64) and of every block of the tpu_profile archive in 1 MiB blocks
    (CRC32) through ``crc64_device`` / ``crc32_device``, each equal to its
    stored check, one launch a block (counted from 0 over that run); the
    kernel against its plain version on every block's chunks, bit for bit
    (``max_abs_err`` 0); the kernel's time on the card (CUDA events after
    the host has enqueued its calls, median of 5, a launch a block; beside
    it all blocks in one launch and the calls with the wrapper's host time)
    against its bound, the plain version's and its product's
    (``library_ms``), and the check functions from bytes against the host
    checks (best of 3); a
    ``torch.profiler`` timeline of one (a) call
    (``tools/profile_pipeline.py``: its kernel events, where the trace
    holds device events, equal to the call's launches; the device's busy
    time and idle share; the longest gaps and the stage in each);
16. the router: the auto router's constants measured by
    ``lzma_rs_tpu_torch/tools/calibrate.py`` (the residency ladder, the
    fitted step cost, steps a byte, the device path's host-side rate,
    the native rate) into a temporary calibration file
    (``LZMA_RS_TPU_CAL_FILE``; nothing is left in the home directory);
    then stock-shaped archives of 64, 128 and 245 blocks of 64 KiB, (a)
    and (a) at 1 MiB through ``xz_decompress`` under ``auto`` with it:
    each archive's route and the model's device and native ms, held to
    the bytes, to ``stats.engine`` and to the JAX router's record, beside
    the measured ms of ``engine="cuda"`` and ``engine="native"`` (best of
    3 after a warm call, the two in alternating turns, so the host's load
    falls on both alike); where those differ by more than 2x, the route
    must be the faster engine. Phase 4's ``auto`` check runs before it,
    with no calibration file: the port's defaults route there;
17. multi-process decode: two ranks (``chip_smoke.py --multihost-rank``,
    spawned with a free port on 127.0.0.1, a gloo group with a timeout,
    both on ``cuda:0``; where the host has two or more cards, one rank a
    card over NCCL as well) decode (a) and (b) with
    ``parallel/multihost.py::xz_decode_multihost(engine="cuda")`` at the
    default wave size (one wave a rank) and in 1 MiB waves (about eight),
    best of 2 after a warm call; each rank holds each call to the corpus's
    sha256, engine ``cuda``, one launch a wave that holds its blocks and
    no ``jax``; rank 0 prints the wall ms, each rank's decode and
    gather-wait seconds and the single-process ``runtime.xz_decode``
    beside them. A rank that fails, hangs or exits nonzero fails the run;
18. the CLI: ``python -m lzma_rs_tpu_torch decompress`` of (a) under
    ``LZMA_RS_TPU_BACKEND=cuda`` gives the corpus (its process imports no
    ``jax``), ``info`` counts 1,954 blocks, and ``compress --block-size
    65536`` then ``decompress`` round-trips 1 MiB of the corpus;
19. the step-cost builds (``csrc/step_cost.cu``, ``ops/step_cost.py``: the
    decoder spinning, alone and with the probability read, its store, the
    window's reads, its stores, the input byte's load or all five taken
    out): ``python -m lzma_rs_tpu_torch.tools.probe_step_cost`` and
    ``probe_step_cost2`` at their defaults (their RESULT lines); then the
    seven builds and the decoder in turns (CUDA events, median of 3 a
    visit) on (a)'s first 264 lanes and (b)'s 245, about 2 lanes an SM,
    every build running every lane for the shortest lane's steps (the
    decoder capped there): µs and cycles a step, restarts, and each part's
    cost as ``spin`` less the case; every spinning lane ends at its budget,
    ``spin`` within 15% of the decoder, and each build's kernel equals its
    plain version bit for bit (restarts too) on 4 lanes of (a) at 4,096
    steps;
20. mutants on the card: 220 seeded mutants (single, stacked 1-4 deep,
    splices) of each of two 1 MiB archives, the tpu_profile one (128
    blocks) and a stock-shaped one (16 blocks of 64 KiB), through
    ``xz_decompress`` with ``LZMA_RS_TPU_BACKEND=cuda``: the same bytes or
    error class as the native engine, the same verdict as liblzma (the
    two sides' one-sided cases counted apart), nothing but typed errors,
    every launch within the step budget; then 256 mutated lanes of the
    first (input bytes flipped or set, chunk ends moved) in one
    ``decode_segments`` launch, equal to the g++ host build of
    ``lzma_lane.cuh`` (win, err, outp, steps), to the native engine's
    per-lane verdict and clean bytes, and, on the 8 that stop soonest, to
    the plain version;
21. the lane engine (``engine="cuda-lane"``: ``ops/lane_decoder.py`` over
    ``csrc/decode_lanes.cu``): the kernel against its plain version (run
    on a host copy of the same inputs) bit for bit on 8 far lanes of
    ~110 KiB (past 64 KiB of output and a match more than 65,536 B back:
    with a 64 KiB dictionary each stops with ERR_DIST_DICT) and on 8 of
    (c)'s lanes at a budget of 12,000 steps; then ``runtime.xz_decode``
    with ``engine="cuda-lane"`` on (c) in 1 MiB blocks (16 lanes), the
    corpus in 4 MiB blocks (4 lanes), one block (stdlib ``lzma.compress``
    at preset 6, an 8 MiB dictionary, one lane), (a) and (b): bytes equal
    to the corpus, engine ``cuda-lane``, no fallbacks, one launch each;
    each one's kernel time (CUDA events), cycles a step over its longest
    lane beside the kernel's recorded time before its lead-chain design
    (``LANE_BEFORE_MS``; cycles from the same steps, which the design
    leaves as they were), bound, and end to end best of 3 beside
    ``native`` (and ``cuda`` on (a) and (b)); a corrupt (c): the native
    engine's error and a host replay recorded.

The eleven kernel libraries build in parallel (one nvcc per library, with
the native host library's g++) in phase 2, which then holds the SASS of
the decoder's libraries (``segdec``, ``segvar``, ``stepcost``: 15
kernels) to the digests recorded in
``lzma_rs_tpu_torch/tools/decoder_sass.json`` (``tools/sass_compare.py``),
and fails on a kernel that differs when this nvcc and the flags are the
recording's.

Every phase checks its result; any failure exits nonzero before the result
lines. The last three lines are the card's name and power limit, the
kernel JSON line (one entry per TPU kernel the port replaces, with the
least time the card could take for the same work, ``bound_ms``: bytes
over the memory rate or integer operations over the INT32 rate, SMs x 64
INT32 lanes x the card's max SM clock, as ``tools/probe_rows.py`` reads
it) and the device JSON line.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPUS_BYTES = 16_000_000
PROBE_SEED = 5
# A range-coder bit, the cheapest micro-op: a multiply, a compare, two
# subtracts or a move, the probability's shift and add, the step count and
# the normalisation test.
OPS_PER_STEP = 8
T0 = time.perf_counter()


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase} +{time.perf_counter() - T0:.1f}s] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def best_seconds(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t)
    return best


def held_equal(got, want, where: str) -> int:
    """Fail unless the kernel's outputs equal the plain version's; returns
    the largest absolute difference (0)."""
    worst = 0
    for what, g, w in zip(("win", "err", "outp", "steps"), got, want):
        diff = (g.long() - w.long()).abs().max().item()
        worst = max(worst, diff)
        check(diff == 0, f"{where}: kernel and plain version differ in "
              f"{what}")
    return worst


def cut_lanes(torch, staged, dev, spread: int = 3):
    """Lanes of a staged batch in the batch's own bucket, at a size the
    plain version runs in minutes (its time is the longest lane's steps):
    the shortest lane whole, then ``spread`` lanes spread over the batch
    with their first chunk ending at that lane's length and later chunks
    dropped. Returns (config, inputs on ``dev``, picked lane indices)."""
    import dataclasses

    import numpy as np

    L = staged.config.L
    tail = int(np.argmin(staged.seg_lens))
    n = int(staged.seg_lens[tail])
    spaced = dict.fromkeys(i * L // spread for i in range(spread))
    picks = [tail] + [i for i in spaced if i != tail][:spread]
    sub = np.array(picks)
    ins, ine, outs, oute, meta = (t[sub] for t in staged.tables)
    oute[1:, 0] = np.minimum(oute[1:, 0], n)
    meta[1:, 1:] = 0  # no valid chunk after the first: the lane ends
    win = (np.zeros((len(picks), staged.config.W), dtype=np.uint8)
           if staged.win_init is None else staged.win_init[sub])
    arrays = (staged.inbuf[sub], win, ins, ine, outs, oute, meta)
    return (dataclasses.replace(staged.config, L=len(picks)),
            tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in arrays), picks)


def check_lanes(got, staged, picks, corpus: bytes, where: str) -> None:
    """Every picked lane's bytes equal the corpus up to its ``outp``, and
    the first (a whole lane) decoded clean to its end."""
    win_h, err_h, outp_h = (t.cpu().numpy() for t in got[:3])
    for r, i in enumerate(picks):
        base, n = staged.lanes[i].seg_base, int(outp_h[r])
        check(win_h[r, :n].tobytes() == corpus[base:base + n],
              f"{where}: lane {i} decoded wrong bytes")
    check(err_h[0] == 0 and outp_h[0] == staged.seg_lens[picks[0]],
          f"{where}: lane {picks[0]} err {err_h[0]}")


def bound(staged, steps, peaks) -> tuple:
    """The least time (ms) the card could take for one ``decode_segments``
    call on a staged batch, what sets it ("bytes" or "operations"), and
    the two times (ms) it is the larger of.
    Bytes: each lane's compressed input read once, its chunk tables read
    once, its decoded bytes and three result words written once, over the
    HBM3 peak. Operations: OPS_PER_STEP integer operations for every
    micro-op the lanes ran (``steps``, this run's data), over the card's
    INT32 rate (``peaks``: SMs x 64 INT32 lanes x the max SM clock; the
    Hopper white paper gives an SM half as many INT32 lanes as FP32, and
    the data sheet's 67 T/s counts an FP32 FMA as two operations)."""
    L, K = staged.config.L, staged.config.K
    packed = int(staged.tables[1].max(axis=1).sum())  # lane-local in_end
    nbytes = packed + int(staged.seg_lens.sum()) + L * K * 4 * 5 + L * 12
    ops = OPS_PER_STEP * int(steps.long().sum())
    t_bytes = nbytes / peaks.bytes_per_s
    t_ops = ops / peaks.int32_ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


def bound_text(b) -> str:
    return (f"bound {b[0] * 1e3:.2f} us ({b[1]}; bytes {b[2] * 1e3:.2f} us,"
            f" operations {b[3] * 1e3:.2f} us)")


PROBE_REPLACES = {
    "tinyops_chain": "tools/probe_lane2d.py:177,209",
    "bitdecode_chain": "tools/probe_lane2d.py:97,145; "
                       "tools/probe_state_in_ref.py:83,141",
    "realweight_step": "tools/probe_state_in_ref.py:211",
}
# the row whose time, plain time and bound stand in the kernel line
PROBE_MAIN_ROW = {
    "tinyops_chain": "tinyops(150) 2d S=32 (4096 lanes)",
    "bitdecode_chain": "bitdecode 2d S=16 (2048 lanes)",
    "realweight_step": "y4 real-weight S=8 nops=500",
}
MOSAIC_REPLACES = {
    "gather_sum": [f"tools/probe_mosaic.py:{n}" for n in (109, 144, 182,
                                                          271)],
    "rw_chain": [f"tools/probe_mosaic.py:{n}" for n in (211, 242)],
    "row_chain": [f"tools/probe_mosaic2.py:{n}" for n in (63, 95, 129,
                                                          233)],
    "segment_chain": [f"tools/probe_mosaic2.py:{n}" for n in (162, 198)],
}
MOSAIC_MAIN_ROW = {
    "gather_sum": "C onehot-read [128,2048] i32",
    "rw_chain": "D onehot-write [128,2048] i32",
    "row_chain": "P6 packed-word read + shift extract",
    "segment_chain": "P5 static-slice swap with carried mask",
}
MOSAIC3_REPLACES = {
    "vote_chain": ["tools/probe_mosaic3.py:42"],
    "byte_chain": ["tools/probe_mosaic3.py:42"],
    "onehot_chain": ["tools/probe_mosaic3.py:42"],
    "window_chain": [f"tools/probe_mosaic3.py:{n}" for n in (42, 289)],
}
# (row, input): P7 on the seeded start, where every iteration runs
MOSAIC3_MAIN_ROW = {
    "vote_chain": ("P7 cond: jnp.any over carried vec", "seeded"),
    "byte_chain": "P11a variable per-lane shift",
    "onehot_chain": "P12m one-hot max-reduce [2048,128]",
    "window_chain": "P16 refill mask-select + concat + scratch",
}
MOSAIC4_REPLACES = {
    "table_chain": [f"tools/probe_mosaic4.py:{n}" for n in (108, 193)],
}
MOSAIC4_MAIN_ROW = {"table_chain": "when_reset"}
ROUND4_REPLACES = {
    "select_chain": [f"tools/probe_round4.py:{n}" for n in (88, 271, 430)],
    "blend_chain": ["tools/probe_round4.py:88"],
}
ROUND4_MAIN_ROW = {"select_chain": "sel1", "blend_chain": "blend_par3"}
BISECT_REPLACES = {"bisect_chain": ["tools/probe_lane2d_bisect.py:33"]}
BISECT_MAIN_ROW = {"bisect_chain": "v4 +masked-write"}
# stage costs: (what, row, the row it adds to)
BISECT_STAGES = (("the climb over the step", "v1 idx-only", "w3 mask-reduce"),
                 ("the load", "v2 +onehot-read", "v1 idx-only"),
                 ("the range coder", "v3 +uint-arith", "v2 +onehot-read"),
                 ("the store", "v4 +masked-write", "v3 +uint-arith"),
                 ("a load without the climb", "w5 sel-tab-reduce",
                  "w3 mask-reduce"))
# cycles an iteration of the rows behind the stage costs in the first
# design (a thread a lane, the table in device memory), on the tool's
# input (PERF.md §6; H100 80GB HBM3 at 700.00 W)
BISECT_FIRST_CYCLES = {"v1 idx-only": 107.0, "v2 +onehot-read": 156.8,
                       "v3 +uint-arith": 176.8, "v4 +masked-write": 184.9,
                       "w3 mask-reduce": 38.0, "w5 sel-tab-reduce": 98.9}
# rows that are one function on the card, timed apart
BISECT_CONTROLS = (("v2 +onehot-read", "v2m mult-mask", "v2bt broadcast_to"),
                   ("w5 sel-tab-reduce", "w6 mult-tab-reduce",
                    "w7 split-reduce"),
                   ("v4 +masked-write", "v5 blend-write"))


def slope_text(r: dict) -> str:
    """A row's time per iteration run, or why it has none."""
    if r["ns_per_iter"] is None:
        return (f"no slope ({r['iters_run']} iterations run at both "
                "counts)")
    return (f"{r['ns_per_iter']:.2f} ns/iteration ({r['cycles_per_iter']:.1f}"
            f" cycles at the max SM clock, {r['cycles_per_op']:.2f} per "
            "counted op)")


def block_lines(phase: str, kernels: dict, lanes: int, entries: list,
                main, peaks) -> None:
    """Each kernel's launch and attributes (``kernels``: a label and its
    ``kernel_attributes`` dict): lanes and threads a block, blocks and SMs
    at the tool's ``lanes``, registers, spills (a spill fails the phase)
    and shared memory a block. The entry of ``entries`` named ``main`` (or
    each named in a tuple ``main``) gets its kernel's registers and
    spills."""
    mains = (main,) if isinstance(main, str) else main
    for label, a in kernels.items():
        check(a["local_bytes"] == 0, f"phase {phase}: {label}'s kernel "
              f"spills ({a['local_bytes']} B local a thread)")
        blocks = -(-lanes // a["lanes"])
        say(f"{phase} probes", f"{label}: {a['lanes']} lanes and "
            f"{a['threads']} threads a block, {blocks} blocks on "
            f"{min(blocks, peaks.sms)} SMs at "
            f"{lanes} lanes; {a['registers']} registers, {a['local_bytes']} B"
            f" local a thread (spills), {a['shared_bytes']} B of dynamic "
            f"shared memory a block (opted in to {a['max_dynamic_shared']} B)")
    for e in entries:
        if e["name"] in mains:
            a = kernels[e["row"]]
            e["registers"], e["local_bytes"] = a["registers"], a["local_bytes"]


def mosaic3_attributes(dev) -> dict:
    """The attributes of the kernel each row of the mosaic3 tool
    launches, by row."""
    from lzma_rs_tpu_torch.ops import probes_mosaic3 as pm3
    from lzma_rs_tpu_torch.tools import probe_mosaic3

    out = {}
    for name, make in probe_mosaic3.ROWS_OF_TOOL:
        fn, args, _ = make(dev)
        rows = fn.view(*args)[0].shape[0]
        if fn.wrapper is pm3.onehot_chain:
            out[name] = pm3.onehot_attributes(rows, **fn.kwargs)
        elif fn.wrapper is pm3.window_chain:
            out[name] = pm3.window_attributes(rows, **fn.kwargs)
        elif fn.wrapper is pm3.vote_chain:
            out[name] = pm3.vote_attributes(rows, **fn.kwargs)
        else:
            out[name] = pm3.byte_attributes(**fn.kwargs)
    return out


def probes_phase(torch, dev, phase: str, rows, wrappers, source: str,
                 replaces: dict, main_row: dict) -> tuple:
    """Phases 7-12: the probe tools' rows on the card, then each row's
    kernel against its plain version (at the row's ``check_iters`` where
    it sets one). Returns the kernel-line entries and the measurements by
    (row, input)."""
    from lzma_rs_tpu_torch.tools import probe_rows

    for w in wrappers:
        w.launches = 0  # count the tools' runs only
    results = probe_rows.run(rows, dev, seed=PROBE_SEED)
    launches = {w.__name__: w.launches for w in wrappers}
    check(all(launches.values()), f"phase {phase}: launches {launches}")
    say(f"{phase} probes", f"{len(rows)} rows x 2 inputs through the tools; "
        f"launches {launches}")

    plain_ms, worst, checked_at = {}, dict.fromkeys(launches, 0), {}
    for i, (name, make) in enumerate(rows):
        fn, args, lanes = make(dev)
        kname = fn.wrapper.__name__
        checked_at[name] = fn.check_iters
        check_kw = {} if fn.check_iters is None else {
            "iters": fn.check_iters}
        for what, xs in (("tool", args),
                         ("seeded", fn.seeded_inputs(args, PROBE_SEED + i))):
            got = fn(*xs, full=True, **check_kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = fn.plain(*xs, full=True, **check_kw)
            torch.cuda.synchronize()
            plain_ms[name, what] = (time.perf_counter() - t) * 1e3
            pairs = [("out", got[0], want[0])] + [
                (k, got[1][k], want[1][k]) for k in want[1]]
            check(got[1].keys() == want[1].keys(), f"phase {phase}: {name} "
                  f"[{what}] returns {sorted(got[1])}, want {sorted(want[1])}")
            for k, g, w in pairs:
                check(g.shape == w.shape and g.dtype == w.dtype,
                      f"phase {phase}: {name} [{what}] {k} "
                      f"{g.dtype}{tuple(g.shape)} != {w.dtype}"
                      f"{tuple(w.shape)}")
                diff = int((g.long() - w.long()).abs().max())
                worst[kname] = max(worst[kname], diff)
                check(diff == 0, f"phase {phase}: {name} [{what}]: kernel "
                      f"and plain version differ in {k} (max {diff})")
        at = f" at {fn.check_iters} iterations" if check_kw else ""
        say(f"{phase} probes", f"{name}: kernel == plain version bit for bit"
            f" on both inputs{at} ({', '.join(k for k, _, _ in pairs)}); "
            f"plain {plain_ms[name, 'tool']:.0f} / "
            f"{plain_ms[name, 'seeded']:.0f} ms")

    by = {(r["name"], r["input"]): r for r in results}
    for name, _ in rows:
        t, z = by[name, "tool"], by[name, "seeded"]
        say(f"{phase} probes", f"{name}: tool's input {slope_text(t)}, "
            f"seeded {slope_text(z)}; a call at {t['iters']} iterations "
            f"(run {t['iters_run']} / {z['iters_run']}) {t['ms'] * 1e3:.1f}"
            f" / {z['ms'] * 1e3:.1f} us, of which set-up "
            f"{t['setup_ms'] * 1e3:.1f} / {z['setup_ms'] * 1e3:.1f} us; "
            f"{t['lanes']} threads, bound {t['bound_ms'] * 1e3:.3f} / "
            f"{z['bound_ms'] * 1e3:.3f} us ({t['bound_by']} / "
            f"{z['bound_by']}); plain {plain_ms[name, 'tool']:.1f} / "
            f"{plain_ms[name, 'seeded']:.1f} ms")
    entries = []
    for kname, row in main_row.items():
        row, what = (row, "tool") if isinstance(row, str) else row
        r = by[row, what]
        entries.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces[kname],
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": r["ms"], "setup_ms": r["setup_ms"],
            "plain_ms": plain_ms[row, what],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,  # no PyTorch call computes these chains
                                 # (gather_sum's: gather_lines; rw_chain's
                                 # D: rw_lines)
            "row": row, "input": what,
            "ms_per_iter_long": (None if r["ns_per_iter"] is None
                                 else r["ns_per_iter"] / 1e6),
        })
        if checked_at[row] is not None:  # the plain version's count
            entries[-1]["iters"] = r["iters"]
            entries[-1]["plain_iters"] = checked_at[row]
    return entries, by


# y4 (166 rounds) and y6 (83 rounds): one kernel at 1,024 lanes, so their
# slopes split an iteration into its rounds and a fixed part
REALWEIGHT_SPLIT = ("y4 real-weight S=8 nops=500", 166,
                    "y6 real-weight S=8 nops=250", 83)
SEGMENTS_ROWS = {"refill": "P4 pl.when ref write in while",
                 "segments": "P5 static-slice swap with carried mask"}


def realweight_split(by: dict, what: str) -> tuple:
    """(ns a round, ns fixed) of an iteration of realweight_step, from the
    slopes of y4 and y6 on input ``what``."""
    y4, r4, y6, r6 = REALWEIGHT_SPLIT
    a, b = by[y4, what]["ns_per_iter"], by[y6, what]["ns_per_iter"]
    per_round = (a - b) / (r4 - r6)
    return per_round, a - r4 * per_round


def realweight_lines(by: dict, entries: list, peaks) -> None:
    """Phase 7's lines for realweight_step: its build's registers and
    spills (none allowed), blocks, threads and shared memory a block, and
    the split of an iteration into rounds and a fixed part (from y4's and
    y6's slopes)."""
    import math

    from lzma_rs_tpu_torch.ops import probes

    a = probes.realweight_attributes()
    check(a["local_bytes"] == 0, f"phase 7: realweight_step spills "
          f"{a['local_bytes']} B a thread")
    for e in entries:
        if e["name"] == "realweight_step":
            e.update(registers=a["registers"], local_bytes=a["local_bytes"])
    lanes = by[PROBE_MAIN_ROW["realweight_step"], "tool"]["lanes"]
    say("7 probes", f"realweight_step: {a['registers']} registers, "
        f"{a['local_bytes']} B local a thread (spills); {probes.BLOCK} "
        f"threads (lanes) a block, {math.ceil(lanes / probes.BLOCK)} blocks "
        f"at {lanes} lanes, {a['static_shared']} B of shared memory a block")
    for what in ("tool", "seeded"):
        per_round, fixed = realweight_split(by, what)
        say("7 probes", f"realweight_step [{what}], measured: a round "
            f"{per_round:.2f} ns ({per_round * peaks.clock_mhz / 1e3:.1f} "
            f"cycles), the fixed part of an iteration {fixed:.1f} ns "
            f"({fixed * peaks.clock_mhz / 1e3:.0f} cycles) ((y4 - y6) / 83 "
            f"and y4 - 166 x that, from the slopes)")


def segments_lines(by: dict, entries: list, path: str, peaks) -> None:
    """Phase 8's lines for segment_chain: each kernel's launch and
    attributes (P4 a thread a lane, P5 a block a lane with its column in
    shared memory; registers and spills, none allowed), each row's ns and
    cycles an iteration, its call and set-up, and P4's loop from its SASS:
    no load inside it (none allowed), and its dependent chain a round at
    assumed latencies (a model)."""
    from lzma_rs_tpu_torch.ops import probes_mosaic as pm
    from lzma_rs_tpu_torch.tools import probe_mosaic2

    W, L = probe_mosaic2.W, probe_mosaic2.L
    block_lines("8", {SEGMENTS_ROWS[m]: pm.segment_attributes(m, W)
                      for m in pm.SEGMENT_MODES}, L, entries,
                "segment_chain", peaks)
    for mode, row in SEGMENTS_ROWS.items():
        for what in ("tool", "seeded"):
            r = by[row, what]
            say("8 probes", f"{row.split()[0]} ({mode}) [{what}]: "
                f"{r['ns_per_iter']:.2f} ns ({r['cycles_per_iter']:.1f} "
                f"cycles) an iteration, the slope from {r['iters']} to "
                f"8,192; a call at {r['iters']} iterations "
                f"{r['ms'] * 1e3:.2f} us ({r['setup_ms'] * 1e3:.2f} us "
                f"set-up); bound {r['bound_ms'] * 1e3:.4f} us "
                f"({r['bound_by']})")
    say("8 probes", "P4's loop: " + refill_sass_text(path))


TINY_ROUNDS = 50  # a tinyops iteration's rounds (probe_lane.cuh)


def tinyops_lines(by: dict, entries: list, path: str, peaks) -> None:
    """Phase 7's lines for tinyops_chain: a round's ns and cycles from the
    main row's slope (an iteration is 50 rounds), and, as a model at
    assumed latencies (printed only), the
    dependent chain of the loop's SASS (``tools/sass_chain.py``, integer 4
    cycles) a round. The kernel line's entry gets the measured cycles."""
    from lzma_rs_tpu_torch.tools import sass_chain

    row = PROBE_MAIN_ROW["tinyops_chain"]
    for what in ("tool", "seeded"):
        r = by[row, what]
        ns = r["ns_per_iter"] / TINY_ROUNDS
        cyc = ns * peaks.clock_mhz / 1e3
        say("7 probes", f"tinyops_chain [{what}], measured: a round {ns:.2f} "
            f"ns ({cyc:.1f} cycles; the slope from {r['iters']} to 8,192 "
            f"iterations of {TINY_ROUNDS} rounds)")
        if what == "tool":
            for e in entries:
                if e["name"] == "tinyops_chain":
                    e["cycles_per_round"] = cyc
    kern = [v for k, v in sass_listing(path).items()
            if "tinyops_chain_kernel" in k]
    if len(kern) != 1:
        say("7 probes", f"tinyops_chain's SASS chain: not read "
            f"({len(kern)} kernels found)")
        return
    body = sass_chain.loop_body(kern[0], lambda b: len(b) > TINY_ROUNDS)
    cyc = sass_chain.chain_cycles(body) / TINY_ROUNDS
    say("7 probes", f"tinyops_chain: a model, not a measurement: the loop's "
        f"{len(body)} instructions ({len(body) / TINY_ROUNDS:.1f} a round) "
        f"hold a chain of {cyc:.2f} cycles a round at {sass_chain.ALU} "
        f"cycles an integer instruction ({cyc / sass_chain.ALU:.2f} "
        "dependent instructions a round)")


# gather_sum's main row's function as PyTorch computes it: the walk's
# index built outside the timed region, then torch.gather and a sum
GATHER_ROW = "C onehot-read [128,2048] i32"


def gather_lines(torch, dev, by: dict, entries: list, peaks) -> None:
    """Phase 8's lines for gather_sum: each row's threads an output,
    threads a block, blocks and SMs (``probes_mosaic.gather_launch``) beside
    its time; and the library call on the main row (C [128, 2048], the
    tool's input): ``torch.gather(x, 1, idx).sum(1, dtype=torch.int32)``,
    two calls, held equal to the kernel's output and timed as the kernel
    is (``probe_rows.median_ms``), the kernel line's ``library_ms``."""
    from lzma_rs_tpu_torch.ops import probes_mosaic as pm
    from lzma_rs_tpu_torch.tools import probe_mosaic, probe_rows

    for name, make in probe_mosaic.ROWS_OF_TOOL:
        fn, args, lanes = make(dev)
        if fn.wrapper is not pm.gather_sum:
            continue
        group, block, blocks = pm.gather_launch(fn.kwargs["axis"], lanes)
        t, z = by[name, "tool"], by[name, "seeded"]
        say("8 probes", f"{name}: {lanes} outputs, {group} "
            f"thread{'s' * (group > 1)} an output, {block} a block, {blocks} "
            "blocks on "
            f"{min(blocks, peaks.sms)} SMs; {t['ms'] * 1e3:.1f} / "
            f"{z['ms'] * 1e3:.1f} us (tool's / seeded input)")
    fn, (x, idx), _ = probe_mosaic.probe_onehot_read(128, 2048, torch.int32,
                                                      device=dev)
    _, start = fn.view(x, idx)
    steps = torch.arange(fn.iters, device=dev)
    walk = (start.long() + steps + 2**31) % 2**32 - 2**31  # wrapped int32
    cols = torch.remainder(walk, fn.kwargs["mod"])

    def library():
        return torch.gather(x, 1, cols).sum(1, dtype=torch.int32)

    want = fn(x, idx)
    check(torch.equal(library(), want[:, 0]), "phase 8: torch.gather and "
          "sum differ from gather_sum on the main row")
    ms = probe_rows.median_ms(library)
    for e in entries:
        if e["name"] == "gather_sum":
            e["library_ms"] = ms
    kernel_ms = by[GATHER_ROW, "tool"]["ms"]
    say("8 probes", f"gather_sum [{GATHER_ROW}], the library call "
        f"(torch.gather and sum, the index built outside): {ms * 1e3:.1f} us"
        f" against the kernel's {kernel_ms * 1e3:.1f} us")


def rw_lines(torch, dev, by: dict, entries: list, peaks) -> None:
    """Phase 8's lines for rw_chain: D's and E's threads a row, threads a
    block, blocks and SMs (``probes_mosaic.rw_launch``) and their kernels'
    registers and spills (none allowed) beside their times; and the
    library call on D's main row (the tool's input):
    ``x.clone().scatter_add_(1, cols, ones)``, the index built outside
    the timed call, two calls, held equal to the kernel's output and timed
    as the kernel is (``tools/probe_mosaic.py::library_row``), the kernel
    line's ``library_ms``."""
    from lzma_rs_tpu_torch.ops import probes_mosaic as pm
    from lzma_rs_tpu_torch.tools import probe_mosaic

    attrs = {m: pm.rw_attributes(m) for m in pm.RW_MODES}
    check(all(a["local_bytes"] == 0 for a in attrs.values()),
          f"phase 8: rw_chain's kernels spill: {attrs}")
    for name, make in probe_mosaic.ROWS_OF_TOOL:
        fn, args, _ = make("cpu")
        if fn.wrapper is not pm.rw_chain:
            continue
        mode = fn.kwargs["mode"]
        per, block, blocks = pm.rw_launch(mode, args[0].shape[0])
        a, t, z = attrs[mode], by[name, "tool"], by[name, "seeded"]
        say("8 probes", f"{name}: {per} thread{'s' * (per > 1)} a row, "
            f"{block} a block, {blocks} block{'s' * (blocks > 1)} on "
            f"{min(blocks, peaks.sms)} SM{'s' * (blocks > 1)}; "
            f"{a['registers']} registers, {a['local_bytes']} B local a "
            f"thread; {t['ms'] * 1e3:.1f} / {z['ms'] * 1e3:.1f} us (tool's "
            f"/ seeded input), set-up {t['setup_ms'] * 1e3:.1f} us, "
            f"{slope_text(t)}")
    lib = probe_mosaic.library_row(dev)
    check(lib["equal"], "phase 8: clone and scatter_add_ differ from "
          "rw_chain on D's main row")
    for e in entries:
        if e["name"] == "rw_chain":
            a = attrs["rows"]
            e.update(library_ms=lib["ms"], registers=a["registers"],
                     local_bytes=a["local_bytes"])
    kernel_ms = by[probe_mosaic.LIBRARY_ROW, "tool"]["ms"]
    say("8 probes", f"rw_chain [{probe_mosaic.LIBRARY_ROW}], the library "
        f"call (clone and scatter_add_, the index built outside): "
        f"{lib['ms'] * 1e3:.1f} us against the kernel's "
        f"{kernel_ms * 1e3:.1f} us")


def row_lines(torch, dev, by: dict, entries: list, peaks) -> None:
    """Phase 8's lines for row_chain: each row's kernel (lanes and threads
    a block, blocks, SMs, registers, spills, shared memory;
    ``probes_mosaic.row_attributes``; a spill fails), and P1's library call
    (``x[:iters].clamp(min=0).sum(0, dtype=torch.int32)``,
    ``tools/probe_mosaic2.py::library_row``), held equal to the kernel's
    output. The kernel line's ``library_ms`` stays null (its times are the
    main row's, P6, which no PyTorch call computes); P1's kernel and
    library times go under ``library_of``."""
    from lzma_rs_tpu_torch.ops import probes_mosaic as pm
    from lzma_rs_tpu_torch.tools import probe_mosaic2

    attrs = {}
    for name, make in probe_mosaic2.ROWS_OF_TOOL:
        fn, args, _ = make("cpu")
        if fn.wrapper is pm.row_chain:
            mode, W = fn.kwargs["mode"], args[0].shape[0]
            attrs[name] = pm.row_attributes(mode, W)
            if mode == "clamp_write":
                y = pm.row_copy_blocks(mode, W, fn.iters)
                say("8 probes", f"{name}: {y} blocks a lane group at "
                    f"{fn.iters} iterations (the first sums, each copies "
                    f"its range of the unvisited rows), {y} x the lane "
                    "groups' blocks in all")
    block_lines("8", attrs, probe_mosaic2.L, entries, "row_chain", peaks)
    lib = probe_mosaic2.library_row(dev)
    check(lib["equal"], "phase 8: clamp and sum differ from row_chain on "
          "P1")
    kernel_ms = by[probe_mosaic2.LIBRARY_ROW, "tool"]["ms"]
    for e in entries:
        if e["name"] == "row_chain":
            e["library_of"] = {"row": lib["name"], "ms": kernel_ms,
                               "library_ms": lib["ms"]}
    say("8 probes", f"row_chain [{probe_mosaic2.LIBRARY_ROW}], the library "
        f"call (clamp and sum of the rows the walk visits): "
        f"{lib['ms'] * 1e3:.1f} us against the kernel's "
        f"{kernel_ms * 1e3:.1f} us")


# bitdecode_chain's main row before the pipelined lane: ns an iteration
# (the slope; the earlier build in turns with this one in one call, on
# one H100 80GB HBM3 at 700.00 W; PERF.md §6)
BITDECODE_BEFORE_NS = 89.73


def bitdecode_lines(by: dict, entries: list, peaks) -> None:
    """Phase 7's lines for bitdecode_chain: every row's ns and cycles an
    iteration (the slope from 256 to 8,192 iterations) and its kernel's
    registers and spills (none allowed), blocks and threads; the main
    row's beside its time before the pipelined lane. The kernel line's
    entry gets the main row's registers, spills and cycles."""
    import math

    from lzma_rs_tpu_torch.ops import probes
    from lzma_rs_tpu_torch.tools import probe_lane2d, probe_state_in_ref

    main = PROBE_MAIN_ROW["bitdecode_chain"]
    for name, make in (probe_lane2d.ROWS_OF_TOOL
                       + probe_state_in_ref.ROWS_OF_TOOL):
        fn, _, lanes = make("cpu")
        if fn.wrapper is not probes.bitdecode_chain:
            continue
        place = fn.layout.get("placement", "minor")
        state = fn.layout.get("state", "registers")
        a = probes.bitdecode_attributes(place, state)
        check(a["local_bytes"] == 0, f"phase 7: bitdecode_chain ({place}, "
              f"{state}) spills {a['local_bytes']} B a thread")
        t, z = by[name, "tool"], by[name, "seeded"]
        say("7 probes", f"bitdecode_chain {name} ({place}, {state}): "
            f"{a['registers']} registers, {a['local_bytes']} B local a "
            f"thread, {math.ceil(lanes / probes.BLOCK)} blocks of "
            f"{probes.BLOCK} lanes; tool's input {slope_text(t)}; seeded "
            f"{slope_text(z)}; a call {t['ms'] * 1e3:.1f} / "
            f"{z['ms'] * 1e3:.1f} us, set-up {t['setup_ms'] * 1e3:.1f} us")
        if name == main:
            for e in entries:
                if e["name"] == "bitdecode_chain":
                    e.update(registers=a["registers"],
                             local_bytes=a["local_bytes"],
                             cycles_per_iter=t["cycles_per_iter"])
            say("7 probes", f"bitdecode_chain [{main}]: "
                f"{t['ns_per_iter']:.2f} ns an iteration against "
                f"{BITDECODE_BEFORE_NS} before the pipelined lane "
                f"({BITDECODE_BEFORE_NS / t['ns_per_iter']:.2f}x)")


# the round4 kernels of the kernel line's rows (mangled-name parts)
ROUND4_SASS = {"select_chain": "select_chain_kernelIiLi1ELi1EE",
               "blend_chain": "blend_chain_kernelILi0ELi3EE"}


def round4_blocks(dev, by: dict, entries: list, path: str, peaks) -> None:
    """Phase 11's blocks: each row's lanes a block, shared memory a block
    and its kernel's registers and spills (``cudaFuncGetAttributes``)
    beside its time an iteration; every chain kernel's iteration loop
    reading shared memory and no global memory (``cuobjdump -sass``); the
    measured cost of one more chained read (the slope of sel1-sel4's
    cycles an iteration); and for the kernel line's rows (sel1,
    blend_par3) a model, printed only: the tool's iterations x the cycles
    of one iteration's dependent chain in the SASS at assumed latencies
    (``tools/sass_chain.py``) over the max SM clock. The entries of
    ``entries`` get the registers and spills their builds report."""
    import numpy as np

    from lzma_rs_tpu_torch.ops import probes_round4 as pr4
    from lzma_rs_tpu_torch.tools import probe_round4, sass_chain

    attrs = {}
    for name, make in probe_round4.ROWS_OF_TOOL:
        fn, args, _ = make(dev)
        x, _ = fn.view(*args)
        blend = fn.wrapper is pr4.blend_chain
        mode, elem = fn.kwargs["mode"], x.element_size()
        rows = pr4.staged_rows(mode, x.shape[0], blend=blend)
        lb = pr4.lanes_per_block(rows, elem)
        a = attrs[name] = pr4.kernel_attributes(mode, fn.kwargs.get("n"),
                                                elem=elem, blend=blend)
        t, z = by[name, "tool"], by[name, "seeded"]
        per_it = "; ".join(
            f"{w} {r['ns_per_iter']:.2f} ns, {r['cycles_per_iter']:.1f} "
            "cycles an iteration" if r["ns_per_iter"] is not None else
            f"{w} no slope" for w, r in (("tool's", t), ("seeded", z)))
        say("11 probes", f"{name}: [{x.shape[0]}, {x.shape[1]}] "
            f"{x.dtype}, {lb} lanes a block ({-(-x.shape[1] // lb)} "
            f"blocks), {pr4.block_bytes(rows, lb, elem)} B of shared memory "
            f"a block ({rows} rows); {a['registers']} registers, "
            f"{a['local_bytes']} B local a thread (spills), opted in to "
            f"{a['max_dynamic_shared']} B; {per_it}")
    sel = [by[f"sel{n}", "tool"]["cycles_per_iter"] for n in range(1, 5)]
    if None not in sel:
        link = float(np.polyfit(range(1, 5), sel, 1)[0])
        say("11 probes", f"one more chained read (address, shared load, add, "
            f"and) costs {link:.1f} cycles, measured: the slope of sel1-sel4 "
            f"({', '.join(f'{c:.1f}' for c in sel)} cycles an iteration)")
    sass = sass_listing(path)
    if not sass:
        say("11 probes", "chain model: not read (no cuobjdump)")
    else:
        chains = {k: v for k, v in sass.items() if "chain_kernel" in k
                  and "select_chain_kernelIiLi0ELi1EE" not in k}  # not null
        shared = {k: bool(sass_chain.loop_body(v, sass_chain.reads_shared))
                  for k, v in chains.items()}
        check(len(chains) == 14 and all(shared.values()), "phase 11: chain "
              "loops without shared-memory loads or with global ones: "
              f"{[k for k, ok in shared.items() if not ok]} of "
              f"{len(chains)}")
        say("11 probes", f"{len(chains)} chain kernels (all but null): each "
            "iteration loop reads shared memory and no global memory")
    for e in entries:
        a = attrs[e["row"]]
        e.update(registers=a["registers"], local_bytes=a["local_bytes"])
        if not sass:
            continue
        part = ROUND4_SASS[e["name"]]
        kern = [v for k, v in sass.items() if part in k]
        check(len(kern) == 1, f"phase 11: {len(kern)} kernels {part}")
        body = sass_chain.loop_body(kern[0], sass_chain.reads_shared)
        cyc = sass_chain.chain_cycles(body)
        n_lds = sum(sass_chain.parse(i)[0].startswith("LDS") for i in body)
        model_us = e["iters"] * cyc / peaks.clock_mhz
        say("11 probes", f"{e['name']} ({e['row']}): a model, not a "
            f"measurement: the loop's {len(body)} instructions ({n_lds} "
            f"shared loads) hold a chain of {cyc:.1f} cycles an iteration "
            f"at assumed latencies (integer {sass_chain.ALU}, shared load "
            f"{sass_chain.LATENCY['LDS']}), {model_us:.1f} us at "
            f"{e['iters']} iterations; measured {e['ms'] * 1e3:.1f} us, "
            f"the bound {e['bound_ms'] * 1e3:.2f} us ({e['bound_by']})")


def sass_listing(path: str) -> dict:
    """Each kernel's SASS in ``path`` (``cuobjdump -sass``), by mangled
    name: (address, instruction) pairs; {} without cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    out = subprocess.run([exe, "-sass", path], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    kernels = {}
    for part in out.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        kernels[name.strip()] = [
            (int(m.group(1), 16), " ".join(m.group(2).split()))
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    return kernels


def opcode(ins: str) -> str:
    return next(w for w in ins.split() if not w.startswith("@"))


def loads_in_loops(listing) -> tuple:
    """(loads inside a loop, loads) of one kernel's SASS, global (LDG,
    LDGSTS) and shared (LDS) alike: a loop spans a backward branch's
    target to the branch."""
    from lzma_rs_tpu_torch.tools import sass_chain

    spans = sass_chain.loops(listing)
    loads = [a for a, ins in listing
             if opcode(ins).startswith(("LDG", "LDS"))]
    return sum(any(lo <= a <= hi for lo, hi in spans) for a in loads), \
        len(loads)


def bisect_sass_text(path: str) -> str:
    """Whether nvcc kept w1's column loads and w2's row-5 load (reads of
    a table nobody writes: w1's in shared memory, w2's in the table
    itself, which it reads unstaged) inside the iteration loop."""
    sass = sass_listing(path)
    out = []
    for row, mode in (("w1", 5), ("w2", 6)):
        key = f"bisect_chain_kernelILi{mode}EE"
        kern = [v for k, v in sass.items() if key in k]
        if len(kern) != 1:
            return f"not measured (cuobjdump found {len(kern)} {row} kernels)"
        inside, total = loads_in_loops(kern[0])
        out.append(f"{row}: {inside} of its {total} loads inside a loop "
                   + ("(kept in the loop)" if inside else "(hoisted out)"))
    return "; ".join(out)


def main_loop(listing) -> list:
    """The instructions of a kernel's longest loop (its unrolled passes)."""
    from lzma_rs_tpu_torch.tools import sass_chain

    spans = sass_chain.loops(listing)
    if not spans:
        return []
    lo, hi = max(spans, key=lambda s: s[1] - s[0])
    return [ins for a, ins in listing if lo <= a <= hi]


def variable_shift(ins: str) -> bool:
    """A shift by a register: SHF whose shift-count operand (the third) is
    one, not an immediate."""
    if ins.startswith("@"):  # the guard predicate
        ins = ins.split(None, 1)[1]
    op, _, rest = ins.partition(" ")
    ops = [o.strip() for o in rest.split(",")]
    return op.startswith("SHF") and len(ops) > 2 and \
        re.fullmatch(r"-?R\d+(\.\w+)*", ops[2]) is not None


def byte_sass_text(path: str) -> tuple:
    """Whether nvcc made one SASS of byte_chain's two modes, and each
    mode's pass of four steps (its longest loop): PRMTs, variable shifts
    and selects. Returns the text and P11a's (PRMTs, variable shifts), or
    None where the SASS was not read."""
    sass = sass_listing(path)
    pair = [sass[k] for k in sorted(sass) if "byte_chain_kernel" in k]
    if len(pair) != 2:
        return (f"not measured (cuobjdump found {len(pair)} byte kernels)",
                None)
    same = [i for _, i in pair[0] if i != "NOP"] == \
        [i for _, i in pair[1] if i != "NOP"]
    counts, out = {}, []
    # template argument 0 (shift, P11a) sorts first
    for mode, listing in zip(("P11a shift", "P11b select"), pair):
        body = main_loop(listing)
        ops = [opcode(i).split(".")[0] for i in body]
        n = (ops.count("PRMT"), sum(map(variable_shift, body)),
             ops.count("SEL") + sum(i.startswith("@") for i in body))
        counts[mode] = n
        out.append(f"{mode}: {len(body)} instructions a pass of 4 steps, "
                   f"{n[0]} PRMT ({'holds a PRMT' if n[0] else 'no PRMT'}),"
                   f" {n[1]} variable shifts, {n[2]} selects or predicated "
                   "instructions")
    head = "one SASS for both modes" if same else "two SASS"
    return f"{head}; " + "; ".join(out), counts["P11a shift"][:2]


def refill_sass_text(path: str) -> str:
    """P4's kernel (``refill_kernel`` of the mosaic library): its loads
    inside a loop (a global load on its chain fails the phase), and its
    pass of 8 steps' dependent chain at assumed latencies (a model,
    ``tools/sass_chain.py``)."""
    from lzma_rs_tpu_torch.tools import sass_chain

    kern = [v for k, v in sass_listing(path).items() if "refill_kernel" in k]
    if len(kern) != 1:
        return f"not measured (cuobjdump found {len(kern)} refill kernels)"
    inside, total = loads_in_loops(kern[0])
    check(inside == 0, f"phase 8: P4's loop holds {inside} loads")
    body = main_loop(kern[0])
    adds = sum(opcode(i).startswith(("IADD", "IMAD.IADD")) for i in body)
    cyc = sass_chain.chain_cycles(body)
    return (f"{inside} of its {total} loads inside a loop (the two source "
            f"words read before it); the pass of 8 steps {len(body)} "
            f"instructions, {adds} adds; a model, not a measurement: its "
            f"chain {cyc:.1f} cycles a pass at {sass_chain.ALU} cycles an "
            f"integer instruction ({cyc / sass_chain.ALU / 8:.2f} dependent "
            "instructions a step)")


def ptxas_summary(log: str) -> str:
    """Each kernel's registers and spills from ``-Xptxas -v``."""
    if not log:
        return "cached build"
    out, kernel, spills = [], "?", ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill stores" in ln:
            spills = ln.split(",", 1)[1].strip() if "," in ln else ln
        elif "Used" in ln and "registers" in ln:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{kernel}: {regs}, {spills}")
    return "; ".join(out) or log.strip()[-300:]


def cycles_per_step(ms: float, longest: int, peaks) -> float:
    """Cycles at the max SM clock a step of the longest lane takes, when a
    launch lasts that lane's serial chain."""
    return ms * 1e-3 * peaks.clock_mhz * 1e6 / longest


# Visits of phase 14: the first design and the decoder at both ends.
VARIANT_TURNS = ("V0", "V3", "V1", "V2", "V4", "V5", "S3")
# Stage costs: (what, variant, the variant it changes)
VARIANT_STAGES = (("a warp a lane over every SM", "V1", "V0"),
                  ("tables to shared memory", "V2", "V1"),
                  ("the window to shared memory", "V3", "V2"),
                  ("one thread copying", "V4", "V3"),
                  ("the look-ahead", "V5", "V3"),
                  ("the warp team beyond copies", "V4", "S3"),
                  ("the warp team", "V3", "S3"))


def median_ms(torch, fn, reps: int = 3) -> float:
    """Median device milliseconds of ``reps`` single calls (CUDA events)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return sorted(times)[len(times) // 2]


def variants_phase(torch, dev, archives, peaks, runtime, sd) -> None:
    """Phase 14: every variant on each archive's whole batch, held equal to
    the decoder's outputs and timed in turns."""
    from lzma_rs_tpu_torch.ops import segment_variants as sv

    sv.decode_variant.launches = 0
    for key, x in archives.items():
        staged = runtime.stage_plans(x, runtime.plan_xz(x)[0])
        cfg = staged.config
        inputs = staged.tensors(dev)
        want = sd.decode_segments(*inputs, config=cfg)
        torch.cuda.synchronize()
        longest = int(want[3].max())
        occ = {}
        for name in VARIANT_TURNS:
            got = sv.decode_variant(name, *inputs, config=cfg)
            held_equal(got, want, f"phase 14 ({key}) {name} against the "
                       "decoder")
            occ[name] = sv.variant_occupancy(name, cfg)
            del got
        t = {name: [] for name in VARIANT_TURNS}
        for name in VARIANT_TURNS + VARIANT_TURNS[::-1]:
            t[name].append(median_ms(torch, lambda: sv.decode_variant(
                name, *inputs, config=cfg)))
        cyc = {n: cycles_per_step(sum(v) / len(v), longest, peaks)
               for n, v in t.items()}
        for name in VARIANT_TURNS:
            say(f"14 variants ({key})", f"{name} ({sv.VARIANTS[name].what}):"
                f" {' / '.join(f'{ms:.2f}' for ms in t[name])} ms, "
                f"{cyc[name]:.1f} cycles a step; {occ[name]} blocks an SM; "
                "== the decoder (win, err, outp, steps)")
        say(f"14 variants ({key})", f"{cfg.L} lanes, W={cfg.W} NLIT="
            f"{cfg.NLIT}, longest lane {longest} steps; stage costs, cycles a"
            " step: " + "; ".join(f"{what} ({a} - {b}) {cyc[a] - cyc[b]:.1f}"
                                  for what, a, b in VARIANT_STAGES))
        del inputs, want
        torch.cuda.empty_cache()
    launches = sv.decode_variant.launches
    check(launches == len(archives) * len(VARIANT_TURNS) * 7,
          f"phase 14: {launches} variant launches")


def measurement_phase(torch, dev, archives, corpus: bytes, kernel_ms: dict,
                      sd) -> dict:
    """Phase 15: devbench, the stage breakdown, the device CRC and the
    timeline on phase 4's archives, and (c), the corpus in 1 MiB blocks.
    Returns the kernel line's ``crc_blocks`` entry, from (c)."""
    from lzma_rs_tpu_torch.parallel import devbench
    from lzma_rs_tpu_torch.tools import corpus as corpus_mod
    from lzma_rs_tpu_torch.tools import probe_vmem2_time as pv
    from lzma_rs_tpu_torch.tools import profile_pipeline as pp

    for key, x in archives.items():
        r = devbench.device_throughput(x, dev, verify=corpus)
        ratio = r["ms"] / kernel_ms[key]
        check(abs(ratio - 1) <= 0.10, f"phase 15 ({key}): device_throughput "
              f"{r['ms']:.3f} ms against phase 4's {kernel_ms[key]:.3f} ms")
        say(f"15 devbench ({key})", f"bit-exact; {r['mb_s']:.2f} MB/s "
            f"device-resident (warm L2), {r['ms']:.3f} ms a launch "
            f"({ratio:.3f} x phase 4's), {r['cycles_per_step']:.1f} cycles a "
            f"step over {r['steps']} steps, {r['lanes']} lanes")
    for key, x in archives.items():
        b = pv.breakdown(x, dev, calls=3, expected=corpus)
        check(list(b["stages"]) == list(pv.STAGES)
              and all(len(v["samples"]) == 3 for v in b["stages"].values()),
              f"phase 15 ({key}): stages {list(b['stages'])}")
        check(0.5 <= b["sum_over_call"] <= 1.5, f"phase 15 ({key}): the "
              f"stages sum to {b['sum_over_call']:.3f} x the call")
        say(f"15 breakdown ({key})", f"{b['calls']} calls, bytes == corpus, "
            f"ms, median (min-max): {pv.stage_text(b)}")
    # the device CRC: every block through the check functions (the path,
    # its launches counted from 0; raises unless each equals its stored
    # check), the kernel against its plain version on every block, then
    # timed
    rows = {}
    for key, x in (("(c)", corpus_mod.stock_archive(corpus, 1 << 20)),
                   ("crc32 1 MiB", corpus_mod.tpu_archive(corpus, 1 << 20))):
        c = rows[key] = pv.crc_rows(x, dev)
        check(c["launches"] == c["blocks"] and c["kernel_ms"] > 0,
              f"phase 15 ({key}): {c['launches']} crc_blocks launches for "
              f"{c['blocks']} blocks")
        check(c["max_abs_err"] == 0, f"phase 15 ({key}): crc_blocks "
              f"differs from its plain version by {c['max_abs_err']:#x}")
        say(f"15 crc {key}", f"{len(x)} B, {pv.crc_text(c)}")
    c = rows["(c)"]
    with tempfile.TemporaryDirectory() as tmp:
        sd.decode_segments.launches = 0  # the warm call's and the traced
        trace, out, traced = pp.capture(archives["a"], dev,
                                        os.path.join(tmp, "trace.json"))
        launches = sd.decode_segments.launches
    check(out == corpus and traced == 1 and launches == 2,
          f"phase 15: the traced call (bytes equal {out == corpus}, "
          f"{traced} launches; {launches} with the warm call)")
    s = pp.summarize(trace)
    if s["device_events"]:
        check(s["launches"] == traced, f"phase 15: the trace holds "
              f"{s['launches']} kernel events for {traced} launches")
    say("15 timeline (a)", f"one call, {traced} launch: "
        f"{pp.summary_text(s)}")
    return {"name": "crc_blocks", "route": "cuda",
            "source": "lzma_rs_tpu_torch/csrc/crc_blocks.cu",
            "replaces": "lzma_rs_tpu/ops/crc_device.py:226",
            "launches": c["launches"], "max_abs_err": c["max_abs_err"],
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["kernel_bound_ms"], "bound_by": "bytes",
            "library_ms": c["product_ms"], "one_launch_ms": c["one_launch_ms"],
            "wrapper_ms": c["wrapper_ms"], "blocks": c["blocks"],
            "width": c["width"], "product_bound_ms": c["bound_ms"],
            "crc32": {k: rows["crc32 1 MiB"][k] for k in (
                "blocks", "launches", "max_abs_err", "kernel_ms",
                "one_launch_ms", "wrapper_ms", "plain_ms", "kernel_bound_ms",
                "product_ms")}}


# the JAX router's record of a modeled route to the host
MODELED_NATIVE = re.compile(
    r"^auto->native: modeled device [0-9.]+ ms vs native [0-9.]+ ms$")


def router_phase(torch, dev, corpus: bytes, archives: dict, runtime,
                 stats) -> None:
    """Phase 16: the auto router's constants measured into a temporary
    calibration file, then a ladder of archives routed with them through
    ``xz_decompress`` (``auto``), each beside both engines' measured
    time."""
    import lzma_rs_tpu_torch
    from lzma_rs_tpu_torch.tools import calibrate
    from lzma_rs_tpu_torch.tools import corpus as corpus_mod

    block = 65536
    ladder = [(f"stock {n} blocks", corpus_mod.stock_archive(
        corpus[:n * block]), corpus[:n * block]) for n in (64, 128)]
    ladder += [(f"stock {-(-len(corpus) // block)} blocks (b)",
                archives["b"], corpus),
               ("tpu_profile 16 MB (a)", archives["a"], corpus),
               ("tpu_profile 1 MiB", corpus_mod.tpu_archive(
                   corpus[:1 << 20]), corpus[:1 << 20])]
    home_file = os.path.join(os.path.expanduser("~"), ".cache",
                             "lzma_rs_tpu_torch", "calibration.json")
    home_before = os.path.exists(home_file)
    old = os.environ.get("LZMA_RS_TPU_CAL_FILE")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["LZMA_RS_TPU_CAL_FILE"] = os.path.join(tmp, "cal.json")
        try:
            cal = calibrate.calibrate(dev, corpus=corpus, xa=archives["a"],
                                      xb=archives["b"])
            for line in calibrate.report(cal):
                say("16 calibration", line)
            check(runtime._auto_calibration() == {
                k: cal[k] for k, _, _ in runtime._CAL_KEYS},
                "phase 16: the router does not read the calibration")
            for what, x, want in ladder:
                route_rung(dev, what, x, want, runtime, stats,
                           lzma_rs_tpu_torch)
        finally:
            if old is None:
                del os.environ["LZMA_RS_TPU_CAL_FILE"]
            else:
                os.environ["LZMA_RS_TPU_CAL_FILE"] = old
    check(os.path.exists(home_file) == home_before,
          f"phase 16 left {home_file} behind")


def route_rung(dev, what: str, x: bytes, want: bytes, runtime, stats,
               package) -> None:
    """One archive of phase 16's ladder: its route under ``auto`` and the
    model's two times, against both engines' best of 3 after a warm call,
    the engines measured in alternating turns."""
    plans = runtime.plan_xz(x)[0]
    cfg = runtime.choose_config(plans)
    device_s, native_s = runtime._estimate_engine_seconds(
        plans, cfg, runtime._n_local_devices(dev), runtime.sm_count(dev))
    route = "cuda" if device_s < native_s * 0.9 else "native"
    ran_on = {"cuda": dev.type, "native": "native"}  # stats.engine
    with stats.collect() as st:
        out = package.xz_decompress(x)
    routed = st.fallbacks
    check(out == want, f"phase 16 ({what}): auto decoded other bytes")
    check(st.engine == ran_on[route], f"phase 16 ({what}): engine "
          f"{st.engine!r}, the model's route {route}")
    if route == "native":
        check(len(routed) == 1 and MODELED_NATIVE.match(routed[0]),
              f"phase 16 ({what}): fallbacks {routed}")
    else:
        check(routed == [], f"phase 16 ({what}): fallbacks {routed}")
    engines = ("native", "cuda")
    for engine in engines:  # each engine's warm call, checked
        with stats.collect() as st:
            out = runtime.xz_decode(x, engine=engine)
        check(out == want and st.engine == ran_on[engine]
              and st.fallbacks == [],
              f"phase 16 ({what}): engine {engine} gave engine "
              f"{st.engine!r}, fallbacks {st.fallbacks}")
    # best of 3 each, in turns (native, cuda, native, ...), so that the
    # host's load falls on both engines alike
    measured = dict.fromkeys(engines, float("inf"))
    for _ in range(3):
        for engine in engines:
            measured[engine] = min(measured[engine], best_seconds(
                lambda: runtime.xz_decode(x, engine=engine), reps=1) * 1e3)
    faster = min(measured, key=measured.get)
    ratio = max(measured.values()) / min(measured.values())
    if ratio > 2:
        check(route == faster, f"phase 16 ({what}): routed to {route}, but "
              f"{faster} is {ratio:.2f}x faster ({measured})")
    say("16 router", f"{what}: {len(x)} B, {cfg.L} lanes, W={cfg.W}: route "
        f"{route} (modeled device {device_s * 1e3:.2f} ms, native "
        f"{native_s * 1e3:.2f} ms); measured cuda {measured['cuda']:.2f} ms, "
        f"native {measured['native']:.2f} ms: {faster} faster by "
        f"{ratio:.2f}x; fallbacks {routed}")


# phase 17's wave sizes: the default (one wave a rank on (a) and (b)) and
# 1 MiB (about eight a rank)
MULTIHOST_WAVES = (None, 1 << 20)


def multihost_rank(argv) -> None:
    """One rank of phase 17, run as ``chip_smoke.py --multihost-rank RANK
    WORLD PORT BACKEND DIR``: (a) and (b) (``DIR/{a,b}.xz``) through
    ``xz_decode_multihost(engine="cuda")`` at each of
    :data:`MULTIHOST_WAVES`, best of 2 after a warm call, each call held to
    the corpus's sha256 (``DIR/sha256``), to engine ``cuda`` and to one
    launch a wave that holds blocks of this rank. Rank 0 prints every
    rank's numbers and the single-process ``runtime.xz_decode(engine=
    "cuda")`` of each archive beside them."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from lzma_rs_tpu_torch.ops import segment_decoder as sd
    from lzma_rs_tpu_torch.parallel import multihost, runtime
    from lzma_rs_tpu_torch.tools import multihost_demo
    from lzma_rs_tpu_torch.utils import stats

    rank, world, port = (int(a) for a in argv[:3])
    backend, tmp = argv[3], argv[4]
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    with open(os.path.join(tmp, "sha256")) as f:
        want = f.read().strip()
    archives = {}
    for key in ("a", "b"):
        with open(os.path.join(tmp, f"{key}.xz"), "rb") as f:
            archives[key] = f.read()
    multihost_demo.init_group(rank, world, port, backend, timeout_s=120)
    rows = []
    try:
        multihost.xz_decode_multihost(archives["b"], "cuda", dev)  # warm
        for key, x in archives.items():
            _, spans, _ = multihost.scan_blocks(x)
            owner = multihost.assign_blocks(spans, world)
            for wave in MULTIHOST_WAVES:
                host_waves, sizes = multihost.plan_waves(
                    spans, owner, world, wave or multihost.WAVE_BYTES)
                mine = sum(1 for w in host_waves[rank] if w)
                best = None
                for _ in range(2):
                    dist.barrier()
                    before = sd.decode_segments.launches
                    with stats.collect() as st:
                        t = time.perf_counter()
                        out = multihost.xz_decode_multihost(
                            x, "cuda", dev, wave_bytes=wave)
                        wall = time.perf_counter() - t
                    launches = sd.decode_segments.launches - before
                    what = f"phase 17 rank {rank} ({key}, waves {wave})"
                    check(hashlib.sha256(out).hexdigest() == want,
                          f"{what}: output differs from the corpus")
                    check(st.engine == "cuda" and st.fallbacks == [],
                          f"{what}: engine {st.engine!r}, fallbacks "
                          f"{st.fallbacks}")
                    check(launches == mine, f"{what}: {launches} launches "
                          f"for {mine} waves that hold blocks")
                    check(st.multihost_waves == len(sizes),
                          f"{what}: {st.multihost_waves} waves, planned "
                          f"{len(sizes)}")
                    if best is None or wall < best[0]:
                        best = (wall, st.multihost_decode_seconds,
                                st.multihost_gather_wait_seconds)
                rows.append({"key": key, "wave": wave, "waves": len(sizes),
                             "launches": mine, "wall": best[0],
                             "decode": best[1], "wait": best[2]})
        check("jax" not in sys.modules, f"phase 17 rank {rank}: jax loaded")
        every = [None] * world
        dist.all_gather_object(every, rows)
    finally:
        dist.destroy_process_group()
    if rank != 0:
        return
    single = {key: best_seconds(lambda: runtime.xz_decode(
        x, engine="cuda", device=dev)) for key, x in archives.items()}
    for i, row in enumerate(rows):
        ranks = "; ".join(
            f"rank {r}: decode {every[r][i]['decode']:.4f} s, gather wait "
            f"{every[r][i]['wait']:.4f} s, {every[r][i]['launches']} "
            "launches" for r in range(world))
        print(f"({row['key']}) waves of "
              f"{row['wave'] or multihost.WAVE_BYTES} B ({row['waves']} "
              f"a rank): {world} ranks over {backend}: wall "
              f"{max(every[r][i]['wall'] for r in range(world)) * 1e3:.1f} "
              f"ms (the slowest rank, best of 2); {ranks}; single process "
              f"runtime.xz_decode(engine='cuda') "
              f"{single[row['key']] * 1e3:.1f} ms (best of 3)", flush=True)


def multihost_phase(torch, archives: dict, corpus: bytes) -> None:
    """Phase 17: two ranks over gloo, both on ``cuda:0``, run
    :func:`multihost_rank`; where the host has two or more cards, one rank
    a card over NCCL too. A rank that fails, hangs past the group's
    timeout or exits nonzero fails the phase."""
    from lzma_rs_tpu_torch.tools import multihost_demo

    arms = [("gloo", 2)]
    cards = torch.cuda.device_count()
    if cards >= 2:
        arms.append(("nccl", cards))
    else:
        say("17 multihost", "the NCCL arm (one rank a card) did not run: "
            f"{cards} card")
    with tempfile.TemporaryDirectory() as tmp:
        for key, x in archives.items():
            with open(os.path.join(tmp, f"{key}.xz"), "wb") as f:
                f.write(x)
        with open(os.path.join(tmp, "sha256"), "w") as f:
            f.write(hashlib.sha256(corpus).hexdigest())
        for backend, world in arms:
            port = multihost_demo.free_port()
            t = time.perf_counter()
            try:
                res = multihost_demo.launch(
                    [[sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                      "--multihost-rank", str(r), str(world), str(port),
                      backend, tmp] for r in range(world)], timeout_s=300,
                    env={**os.environ, "PYTHONPATH": ROOT})
            except RuntimeError as e:
                fail(f"phase 17 ({backend}): {e}")
            for r, (rc, out, err) in enumerate(res):
                check(rc == 0, f"phase 17 ({backend}): rank {r} exited {rc}"
                      f": {out[-1000:]} {err[-3000:]}")
            for line in res[0][1].splitlines():
                say("17 multihost", line)
            say("17 multihost", f"{world} ranks over {backend}: bytes equal "
                "the corpus, engine cuda, one launch a wave, no jax; "
                f"{time.perf_counter() - t:.1f} s with the ranks' start")


def cli_phase(corpus: bytes, xa: bytes) -> None:
    """Phase 18: ``python -m lzma_rs_tpu_torch`` under
    ``LZMA_RS_TPU_BACKEND=cuda``: ``decompress`` of (a) gives the corpus
    (its process imports no jax), ``info`` counts (a)'s 1,954 blocks, and
    ``compress --block-size 65536`` then ``decompress`` round-trips 1 MiB
    of the corpus."""
    env = {**os.environ, "PYTHONPATH": ROOT, "LZMA_RS_TPU_BACKEND": "cuda"}

    def cli(*args, python=()):
        r = subprocess.run([sys.executable, *python, "-m",
                            "lzma_rs_tpu_torch", *args], cwd=ROOT, env=env,
                           capture_output=True, timeout=300)
        check(r.returncode == 0, f"phase 18: {' '.join(args[:1])} exited "
              f"{r.returncode}: {r.stderr.decode()[-3000:]}")
        return r

    with tempfile.TemporaryDirectory() as tmp:
        path = {k: os.path.join(tmp, k) for k in ("a.xz", "a.out", "m.txt",
                                                  "m.xz", "m.out")}
        with open(path["a.xz"], "wb") as f:
            f.write(xa)
        t = time.perf_counter()
        r = cli("decompress", path["a.xz"], "-o", path["a.out"],
                python=("-X", "importtime"))
        secs = time.perf_counter() - t
        with open(path["a.out"], "rb") as f:
            check(f.read() == corpus, "phase 18: decompress of (a) differs "
                  "from the corpus")
        mods = re.findall(rb"\|\s*(\S+)\s*$", r.stderr, re.M)
        check(not [m for m in mods if m == b"jax" or m.startswith(b"jax.")
                   or m == b"lzma_rs_tpu" or m.startswith(b"lzma_rs_tpu.")],
              "phase 18: the CLI imported jax or the JAX package")
        r = cli("info", path["a.xz"])
        check(b"blocks: 1954 " in r.stdout, "phase 18: info printed "
              f"{r.stdout[:80]!r}")
        with open(path["m.txt"], "wb") as f:
            f.write(corpus[:1 << 20])
        cli("compress", "--block-size", "65536", path["m.txt"], "-o",
            path["m.xz"])
        cli("decompress", path["m.xz"], "-o", path["m.out"])
        with open(path["m.out"], "rb") as f:
            check(f.read() == corpus[:1 << 20], "phase 18: 1 MiB did not "
                  "round-trip")
        say("18 cli", f"decompress of (a) under LZMA_RS_TPU_BACKEND=cuda == "
            f"the corpus ({secs:.1f} s with the interpreter's start; no "
            "jax imported); info: blocks: 1954; compress --block-size "
            "65536 + decompress round-trips 1 MiB")


# Phase 19's lanes: (a)'s first 264 and (b)'s 245, about 2 lanes an SM on
# 132 SMs, a rung of phase 16's residency ladder (PERF.md: (a) 162-163 and
# (b) 135-137 cycles a step there); and the bit-for-bit check's lanes and
# steps.
STEP_COST_LANES = {"a": 264, "b": 245}
STEP_COST_CHECK = (4, 4096)


def step_cost_phase(torch, dev, archives, peaks, runtime, sd) -> None:
    """Phase 19: the two step-cost tools at their defaults; then every
    step-cost case on (a)'s and (b)'s lanes of ``STEP_COST_LANES``, in
    turns with the decoder on the same lanes and the same budget: the
    shortest lane's steps, so that the decoder ends no lane early and
    every build runs every lane for the same steps (spinning for the
    longest lane's would set a launch's time by the lane dearest a step,
    where the decoder's is set by the longest lane); and each case's
    kernel against its plain version bit for bit on (a)'s first lanes."""
    from lzma_rs_tpu_torch.ops import step_cost as stc
    from lzma_rs_tpu_torch.tools import probe_step_cost, probe_step_cost2

    timed = [c for c in probe_step_cost.CASES if c in stc.ABLATIONS]
    for tool in (probe_step_cost, probe_step_cost2):
        t = time.perf_counter()
        res = tool.main([])
        check([r.case for r in res] == timed and all(
            r.steps == probe_step_cost.STEPS for r in res),
            f"phase 19: {tool.__name__} gave {[r.case for r in res]}")
        say("19 step cost", f"{tool.__name__.rsplit('.', 1)[1]} at its "
            f"defaults: {len(res)} timed cases and the flush case in "
            f"{time.perf_counter() - t:.1f} s")
    stc.decode_ablated.launches = 0
    turns = ("decoder",) + tuple(stc.ABLATIONS)
    for key, x in archives.items():
        staged = runtime.stage_plans(x, runtime.plan_xz(x)[0])
        n = min(STEP_COST_LANES[key], len(staged.lanes))
        cfg = staged.slab_config(0, n)
        inputs = staged.tensors(dev, 0, n)
        whole = sd.decode_segments(*inputs, config=cfg)[3]
        budget, longest = int(whole.min()), int(whole.max())
        whole_ms = median_ms(torch, lambda: sd.decode_segments(
            *inputs, config=cfg))
        runs = {"decoder": lambda: sd.decode_segments(
            *inputs, config=cfg, max_steps=budget)}
        for case in stc.ABLATIONS:
            runs[case] = lambda case=case: stc.decode_ablated(
                case, *inputs, config=cfg, max_steps=budget)
        restarts = {}
        for case in stc.ABLATIONS:
            got = runs[case]()
            torch.cuda.synchronize()
            check(bool((got[3] == budget).all()), f"phase 19 ({key}) {case}:"
                  f" lanes ran {int(got[3].min())}-{int(got[3].max())} "
                  f"steps, not {budget}")
            check(bool((got[1] == 1).all()), f"phase 19 ({key}) {case}: "
                  "a lane did not end at the step cap")
            restarts[case] = int(got[4].long().sum())
            del got
        t = {c: [] for c in turns}
        for c in turns + turns[::-1]:
            t[c].append(median_ms(torch, runs[c]))
        cyc = {c: cycles_per_step(sum(v) / len(v), budget, peaks)
               for c, v in t.items()}
        occ = stc.ablated_occupancy("spin", cfg)
        say(f"19 step cost ({key})", f"{n} lanes, W={cfg.W} NLIT="
            f"{cfg.NLIT}, {occ} lanes an SM by the occupancy query "
            f"({n / peaks.sms:.2f} a SM placed); every build runs every "
            f"lane {budget} steps, the shortest lane's (the decoder capped "
            f"there), and every spinning lane ran them and ended at the "
            f"step cap; the decoder uncapped {whole_ms:.3f} ms, "
            f"{cycles_per_step(whole_ms, longest, peaks):.1f} cycles a step "
            f"over the longest lane's {longest}")
        for c in turns:
            r = ("" if c == "decoder" else
                 f"; {restarts[c]} restarts "
                 f"({restarts[c] / n / budget * 1000:.3f} a lane per 1000 "
                 "steps)")
            say(f"19 step cost ({key})", f"{c}: "
                f"{' / '.join(f'{ms:.3f}' for ms in t[c])} ms, "
                f"{sum(t[c]) / len(t[c]) * 1e3 / budget:.4f} us and "
                f"{cyc[c]:.1f} cycles a step" + r)
        say(f"19 step cost ({key})", "each part's cost, spin - case, cycles"
            " a step: " + "; ".join(
                f"{c.split(',', 1)[1]} {cyc['spin'] - cyc[c]:.1f}"
                for c in stc.ABLATIONS if c != "spin"))
        ratio = cyc["spin"] / cyc["decoder"]
        check(abs(ratio - 1) <= 0.15, f"phase 19 ({key}): spin "
              f"{cyc['spin']:.1f} cycles a step against the decoder's "
              f"{cyc['decoder']:.1f}")
        del inputs, runs
        torch.cuda.empty_cache()
    lanes, steps = STEP_COST_CHECK
    staged = runtime.stage_plans(archives["a"],
                                 runtime.plan_xz(archives["a"])[0])
    cfg = staged.slab_config(0, lanes)
    inputs = staged.tensors(dev, 0, lanes)
    host = tuple(x.cpu() for x in inputs)
    t = time.perf_counter()
    for case in stc.ABLATIONS:
        got = stc.decode_ablated(case, *inputs, config=cfg, max_steps=steps)
        want = stc.decode_ablated_reference(case, *host, config=cfg,
                                            max_steps=steps)
        for what, g, w in zip(("win", "err", "outp", "steps", "restarts"),
                              got, want):
            check(torch.equal(g.cpu(), w), f"phase 19: {case} kernel and "
                  f"plain version differ in {what}")
    say("19 step cost", f"every case's kernel == its plain version bit for "
        f"bit (win, err, outp, steps, restarts) on {lanes} lanes of (a) at "
        f"{steps} steps (plain versions {time.perf_counter() - t:.1f} s on "
        f"the host); {stc.decode_ablated.launches} step-cost launches")


MUTANT_SEED = 20


def mutants_phase(torch, dev, corpus: bytes, runtime, stats, decode,
                  sd) -> None:
    """Phase 20: seeded mutants of a 1 MiB tpu_profile archive and a 1 MiB
    stock-shaped one through ``xz_decompress`` on the card against
    liblzma and the native engine; then 256 mutated lanes in one
    ``decode_segments`` launch against the host build, the native engine
    and, on the 8 that stop soonest, the plain version."""
    import lzma
    import random

    import numpy as np

    from lzma_rs_tpu_torch.native import loader
    from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig
    from lzma_rs_tpu_torch.tools import corpus as corpus_mod
    from lzma_rs_tpu_torch.tools import mutate
    from lzma_rs_tpu_torch.utils.errors import LzmaRsError

    rng = random.Random(MUTANT_SEED)
    mib = corpus[:1 << 20]
    seeds = {"(a) 1 MiB": corpus_mod.tpu_archive(mib),
             "stock 1 MiB": corpus_mod.stock_archive(mib)}
    # no launch may run past the largest bucket's budget
    budget = sd.default_max_steps(SegmentConfig(L=1, W=65536, W_IN=65536))

    def outcome(engine, x):
        try:
            return True, decode(x, engine)
        except LzmaRsError as e:
            return False, type(e).__name__

    divergences, counts, longest = [], {}, 0
    t = time.perf_counter()
    for what, seed in seeds.items():
        cases = list(mutate.mutations(rng, seed, 100))
        cases += list(mutate.mutations(rng, seed, 100, stacked=True))
        cases += list(mutate.splices(rng, list(seeds.values()), 20))
        c = dict.fromkeys(("mutants", "both decode", "both fail",
                           "liblzma alone differs", "vmem-ineligible",
                           "lane replays", "launches"), 0)
        for x in cases:
            c["mutants"] += 1
            before = sd.decode_segments.launches
            try:
                with stats.collect() as st:
                    dev_out = outcome("cuda", x)
                nat = outcome("native", x)
            except Exception as e:  # an untyped error is the finding
                divergences.append(f"{what}: {type(e).__name__}: {e}")
                continue
            c["launches"] += sd.decode_segments.launches - before
            longest = max(longest, st.kernel_iters)
            c["vmem-ineligible"] += any(f.startswith("vmem-ineligible")
                                        for f in st.fallbacks)
            c["lane replays"] += any(f.startswith("host replay: lane")
                                     for f in st.fallbacks)
            if dev_out != nat:
                divergences.append(f"{what}: cuda {str(dev_out)[:60]} vs "
                                   f"native {str(nat)[:60]}")
                continue
            try:
                lib_out = (True, lzma.decompress(x, format=lzma.FORMAT_XZ))
            except lzma.LZMAError:
                lib_out = (False, None)
            if dev_out[0] and lib_out[0]:
                if dev_out[1] != lib_out[1]:
                    divergences.append(f"{what}: cuda and liblzma decoded "
                                       "other bytes")
                    continue
                c["both decode"] += 1
            elif dev_out[0] == lib_out[0]:
                c["both fail"] += 1
            else:  # the reference's known differences, native's as well
                c["liblzma alone differs"] += 1
        counts[what] = c
    secs = time.perf_counter() - t
    n_mut = sum(c["mutants"] for c in counts.values())
    for what, c in counts.items():
        say("20 mutants", f"{what}: " + ", ".join(f"{k} {v}"
                                                 for k, v in c.items()))
    say("20 mutants", f"{n_mut} mutants in {secs:.1f} s "
        f"({n_mut / secs:.1f} a second) through xz_decompress on the card, "
        f"each beside the native engine and liblzma; longest launch "
        f"{longest} steps (budget {budget}); {len(divergences)} divergences")
    check(not divergences, f"phase 20: {divergences[:5]}")
    check(all(c["mutants"] >= 200 for c in counts.values()) and n_mut >= 400,
          f"phase 20: {n_mut} mutants")
    check(longest <= budget, f"phase 20: a launch ran {longest} steps")

    xa = seeds["(a) 1 MiB"]
    pool = runtime.stage_plans(xa, runtime.plan_xz(xa)[0])
    cfg, arrays, seg_lens = mutate.mutate_lanes(rng, pool, 256, True)
    inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrays)
    sd.decode_segments.launches = 0
    got = sd.decode_segments(*inputs, config=cfg)
    torch.cuda.synchronize()
    check(sd.decode_segments.launches == 1, "phase 20: the lanes took "
          f"{sd.decode_segments.launches} launches")
    t = time.perf_counter()
    host = mutate.host_decode(cfg, arrays)
    host_s = time.perf_counter() - t
    held_equal([g.cpu() for g in got], host,
               "phase 20: the kernel against the host build")
    verdicts = mutate.lane_verdicts(loader.load(), got, arrays, seg_lens)
    check(not verdicts, f"phase 20: against the native engine {verdicts[:5]}")
    short = torch.argsort(got[3].cpu(), stable=True)[:8].to(dev)
    cfg8 = pool.slab_config(0, 8)
    want = sd.decode_segments_reference(*(x[short] for x in inputs),
                                        config=cfg8)
    held_equal([g[short] for g in got], want,
               "phase 20: the kernel against its plain version")
    err = got[1].cpu()
    codes = {int(k): int((err == k).sum()) for k in err.unique()}
    say("20 lanes", f"{cfg.L} mutated lanes of (a)'s 1 MiB (W={cfg.W}, "
        f"W_IN={cfg.W_IN}) in one launch: == the host build (win, err, "
        f"outp, steps; host build {host_s:.1f} s), every lane's verdict and "
        f"clean bytes == the native engine, the 8 that stop soonest "
        f"(longest {int(want[3].max())} steps) == the plain version; "
        f"lanes by error code {codes}; 0 divergences")


def sass_phase(build, paths: dict) -> None:
    """Phase 2's SASS check of the decoder's three libraries against the
    recorded digests (``tools/sass_compare.py::check_recorded``)."""
    from lzma_rs_tpu_torch.tools import sass_compare

    names = ("segdec", "segvar", "stepcost")
    comparable, rows = sass_compare.check_recorded(
        {n: paths[n] for n in names})
    same = sum(r[2] for r in rows)
    if comparable:
        check(rows and same == len(rows), "phase 2: the decoder's SASS "
              "differs from the recorded build: " + ", ".join(
                  f"{r[0]} {r[1]} ({r[3]} / {r[4]} instructions)"
                  for r in rows if not r[2]))
    say("2 sass", f"{same} of {len(rows)} kernels of {', '.join(names)} "
        "identical to the recorded SASS (tools/decoder_sass.json)"
        + ("" if comparable else "; not comparable: another nvcc or other "
           "flags than the recording's"))


# decode_lanes' kernel ms on phase 21's archives before its lead-chain
# design (commit 06b9774; H100 80GB HBM3, 700.00 W), beside this run's.
LANE_BEFORE_MS = {"(c) 1 MiB blocks": 199.48, "4 MiB blocks": 676.99,
                  "one block": 2136.95, "(a)": 7.85, "(b)": 17.88}


# Phase 21: (c)'s lanes against the plain version at this budget, and the
# lanes of the far batch whole (the plain version runs every step on the
# host: ~10-20 s each at about a millisecond an iteration of 8 lanes).
LANE_CUT_BUDGET = 12_000
LANE_CUT_LANES = 8


def far_lanes(corpus: bytes, runtime, n: int = LANE_CUT_LANES):
    """``n`` LZMA2 streams of ~110 KiB, one lane each: 2 KiB of the corpus,
    66 KiB of a repeated line, the 2 KiB again (matches more than 65,536 B
    back), 36 KiB of another line and the 2 KiB with every 97th byte
    changed, so that a lane passes 64 KiB of output and a distance above
    65,536 at a cost the plain version can pay. Returns (archive bytes,
    plans, payloads)."""
    from lzma_rs_tpu_torch.tools import corpus as corpus_mod

    blob, plans, payloads, out0 = bytearray(), [], [], 0
    for i in range(n):
        a = (i * 1_234_567) % (len(corpus) - 2048)
        t = corpus[a:a + 2048]
        line1 = b"%02d 0123456789abcdefghijklmnopqrstuvwxyz\n" % i
        line2 = b"-=+*/ lane %02d THE QUICK BROWN FOX\n" % i
        tail = bytearray(t)
        for k in range(0, len(tail), 97):
            tail[k] = 33 + k % 90
        payload = (t + (line1 * 2000)[:66_000] + t
                   + (line2 * 1200)[:36_000] + bytes(tail))
        stream = corpus_mod.raw_lzma2(payload)
        plan, _ = runtime.plan_lzma2_stream(bytes(blob) + stream, len(blob),
                                            out0)
        check(len(plan.lanes) == 1, f"phase 21: far lane {i} is "
              f"{len(plan.lanes)} lanes")
        blob += stream
        plans.append(plan)
        payloads.append(payload)
        out0 += plan.total_out
    return bytes(blob), plans, payloads


def replanned(x: bytes, runtime, picks) -> tuple:
    """The ``.xz`` blocks ``picks`` of ``x`` planned as one batch, each
    block's output right after the previous one's. Returns (plans, the
    blocks' output offsets in ``x``'s output)."""
    from lzma_rs_tpu_torch.parallel import multihost

    _, spans, _ = multihost.scan_blocks(x)
    plans, bases, out0 = [], [], 0
    for i in picks:
        plan, _ = runtime.plan_lzma2_stream(x, spans[i].payload_start, out0)
        plans.append(plan)
        bases.append(spans[i].out_base)
        out0 += plan.total_out
    return plans, bases


def lane_bound(lt, steps, peaks) -> tuple:
    """As :func:`bound`, for one ``decode_lanes`` call on ``lt``
    (``runtime.lane_tables``): each chunk's compressed bytes read once,
    the chunk tables and the per-lane words read once, the output written
    once, three result words a lane; OPS_PER_STEP integer operations for
    every step this run's lanes took."""
    import numpy as np

    ins, ine = lt.tables[0], lt.tables[1]
    valid = (np.arange(ins.shape[1])[None, :]
             < lt.per_lane[0][:, None])
    packed = int(((ine - ins) * valid).sum())
    L, K = ins.shape
    nbytes = packed + len(lt.out) + L * K * 4 * 8 + L * (3 * 4 + 8) + L * 12
    ops = OPS_PER_STEP * int(steps.long().sum())
    t_bytes = nbytes / peaks.bytes_per_s
    t_ops = ops / peaks.int32_ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


def lane_phase(torch, dev, corpus: bytes, archives: dict, peaks, runtime,
               stats) -> dict:
    """Phase 21: the lane engine (``engine="cuda-lane"``): the kernel
    against its plain version bit for bit on two cut batches, full decodes
    of five archives through ``runtime.xz_decode``, their times beside
    ``native``'s (and ``cuda``'s on (a) and (b)), and a corrupt archive.
    Returns the kernel line's entry."""
    import lzma

    from lzma_rs_tpu_torch.ops import lane_decoder as ld
    from lzma_rs_tpu_torch.tools import corpus as corpus_mod

    # -- the kernel against its plain version (run on the host's copy)
    def against_plain(lt, what, max_steps=None):
        inputs = lt.tensors(dev)
        got = ld.decode_lanes(*inputs, max_steps=max_steps)
        torch.cuda.synchronize()
        got = [g.cpu() for g in got]
        t = time.perf_counter()
        want = ld.decode_lanes_reference(
            *lt.tensors("cpu"), max_steps=max_steps)
        plain_s = time.perf_counter() - t
        return got, want, plain_s, held_equal(got, want, f"phase 21 ({what})")

    blob, plans, payloads = far_lanes(corpus, runtime)
    lt = runtime.lane_tables(blob, plans)
    got, want, far_plain_s, worst = against_plain(lt, "far lanes")
    out_h, err_h, outp_h, steps_h = got
    check(err_h.tolist() == [0] * len(plans) and out_h.numpy().tobytes()
          == b"".join(payloads), "phase 21: the far lanes decoded wrong")
    lt.dict_size[:] = 65536  # a 64 KiB dictionary: a farther match errs
    inputs = lt.tensors(dev)
    d64 = [t.cpu() for t in ld.decode_lanes(*inputs)]
    stops = [int(o) - lane.seg_base for o, lane in zip(d64[2], lt.lanes)]
    check(d64[1].tolist() == [ld.ERR_DIST_DICT] * len(plans)
          and min(stops) > 65536,
          f"phase 21: far lanes with a 64 KiB dictionary: err "
          f"{d64[1].tolist()}")
    say("21 lanes", f"{len(plans)} far lanes ({len(payloads[0])} B each): "
        f"kernel == plain version bit for bit (out, err, outp, steps), == "
        f"the payloads; {int(steps_h.max())} steps the longest; plain "
        f"{far_plain_s:.1f} s; with dict_size 65,536 every lane stops with "
        f"ERR_DIST_DICT past {min(stops)} B of output (a match more than "
        "65,536 B back)")

    xc = corpus_mod.stock_archive(corpus, 1 << 20)
    picks = list(range(0, 2 * LANE_CUT_LANES, 2))
    cplans, bases = replanned(xc, runtime, picks)
    lt_c = runtime.lane_tables(xc, cplans)
    got, want, cut_plain_s, w2 = against_plain(
        lt_c, "(c) lanes at the budget", max_steps=LANE_CUT_BUDGET)
    worst = max(worst, w2)
    check(got[1].tolist() == [ld.ERR_STEP_CAP] * len(picks)
          and got[3].tolist() == [LANE_CUT_BUDGET] * len(picks),
          f"phase 21: (c)'s cut lanes err {got[1].tolist()}")
    for lane, o, base in zip(lt_c.lanes, got[2], bases):
        n = int(o) - lane.seg_base
        check(got[0].numpy()[lane.seg_base:lane.seg_base + n].tobytes()
              == corpus[base:base + n], "phase 21: a cut lane of (c) "
              "decoded wrong bytes")
    say("21 lanes", f"{len(picks)} lanes of (c) (blocks {picks}) at a "
        f"budget of {LANE_CUT_BUDGET} steps: kernel == plain version bit "
        f"for bit, every lane at its budget (ERR_STEP_CAP), bytes == the "
        f"corpus up to outp; plain {cut_plain_s:.1f} s")

    # -- full decodes through the runtime: the main path of the engine
    t = time.perf_counter()
    full = {"(c) 1 MiB blocks": xc,
            "4 MiB blocks": corpus_mod.stock_archive(corpus, 4 << 20),
            "one block": lzma.compress(corpus, preset=6),
            "(a)": archives["a"], "(b)": archives["b"]}
    say("21 archives", f"encoded in {time.perf_counter() - t:.1f} s: "
        + ", ".join(f"{k} {len(x)} B" for k, x in full.items()))
    ld.decode_lanes.launches = 0  # count the main path's launches only
    for key, x in full.items():
        with stats.collect() as st:
            out = runtime.xz_decode(x, engine="cuda-lane")
        check(out == corpus, f"phase 21 ({key}): output differs from corpus")
        check(st.engine == "cuda-lane" and st.fallbacks == [],
              f"phase 21 ({key}): engine {st.engine!r}, fallbacks "
              f"{st.fallbacks}")
    launches = ld.decode_lanes.launches
    check(launches == len(full), f"phase 21: {launches} launches for "
          f"{len(full)} decodes")
    say("21 main", f"{len(full)} archives through xz_decode(engine="
        f"'cuda-lane'): bytes == corpus, no fallbacks, {launches} launches;"
        f" {ld.lanes_occupancy()} lanes an SM (occupancy query), "
        f"{ld.smem_bytes()} B of shared memory a lane")
    entry = {}
    for key, x in full.items():
        plans_x = runtime.plan_xz(x)[0]
        lt_x = runtime.lane_tables(x, plans_x)
        inputs = lt_x.tensors(dev)
        steps_x = ld.decode_lanes(*inputs)[3]
        reps = 1 if len(lt_x.lanes) < 4 else 3
        k_ms = cuda_ms(torch, lambda: ld.decode_lanes(*inputs), reps)
        longest = int(steps_x.max())
        b_x = lane_bound(lt_x, steps_x, peaks)
        secs = best_seconds(lambda: runtime.xz_decode(x, engine="cuda-lane"))
        n_s = best_seconds(lambda: runtime.xz_decode(x, engine="native"))
        cuda = ""
        if key in ("(a)", "(b)"):
            c_s = best_seconds(lambda: runtime.xz_decode(x, engine="cuda"))
            cuda = (f"; cuda {len(corpus) / 1e6 / c_s:.2f} MB/s "
                    f"({c_s * 1e3:.1f} ms)")
        cyc = cycles_per_step(k_ms, longest, peaks)
        before = LANE_BEFORE_MS[key]
        say(f"21 main {key}", f"{len(lt_x.lanes)} lanes, "
            f"K={lt_x.tables.shape[2]}; kernel {k_ms:.2f} ms = {cyc:.1f} "
            f"cycles a step over the longest lane's {longest} steps "
            f"({int(steps_x.long().sum())} in all; before the lead chain "
            f"{before:.2f} ms = "
            f"{cycles_per_step(before, longest, peaks):.1f} cycles), "
            f"{bound_text(b_x)}; end to end {len(corpus) / 1e6 / secs:.2f} "
            f"MB/s ({secs * 1e3:.1f} ms, best of 3) against native "
            f"{len(corpus) / 1e6 / n_s:.2f} MB/s ({n_s * 1e3:.1f} ms){cuda}")
        if key == "(c) 1 MiB blocks":
            entry = {"ms": k_ms, "bound_ms": b_x[0], "bound_by": b_x[1],
                     "cycles_per_step": cyc, "longest_lane_steps": longest}
        del inputs, steps_x
        torch.cuda.empty_cache()

    # -- a corrupt archive: the host engine's error, replayed
    plans_c = runtime.plan_xz(xc)[0]
    lane = plans_c[5].lanes[0]
    bad = bytearray(xc)
    bad[(lane.in_start[0] + lane.in_end[0]) // 2] ^= 0x5A
    errors = {}
    for engine in ("cuda-lane", "native"):
        with stats.collect() as st:
            try:
                runtime.xz_decode(bytes(bad), engine=engine)
            except Exception as e:  # the error itself is what is compared
                errors[engine] = (type(e), str(e), st.fallbacks)
    check(set(errors) == {"cuda-lane", "native"}, "phase 21: the corrupt "
          f"archive decoded without an error on "
          f"{set(errors) ^ {'cuda-lane', 'native'}}")
    check(errors["cuda-lane"][:2] == errors["native"][:2],
          f"phase 21: cuda-lane {errors['cuda-lane'][:2]} != native "
          f"{errors['native'][:2]}")
    fb = errors["cuda-lane"][2]
    check(len(fb) == 1 and fb[0].startswith("host replay: lane error code"),
          f"phase 21: corrupt archive fallbacks {fb}")
    say("21 corrupt", f"{errors['native'][0].__name__}: "
        f"{errors['native'][1]!r} on both engines; cuda-lane fallbacks {fb}")
    return {"name": "decode_lanes", "route": "cuda",
            "source": "lzma_rs_tpu_torch/csrc/decode_lanes.cu",
            "replaces": "lzma_rs_tpu/ops/lane_decoder.py:105",
            "launches": launches, "max_abs_err": worst, **entry,
            "plain_ms": far_plain_s * 1e3, "plain_lanes": len(plans),
            "library_ms": None}


def phase3_lanes(corpus: bytes, runtime):
    """Streams for the kernel-against-plain check, planned into one blob.
    Returns (blob, plans, expected output, corrupted seg_bases,
    truncations {seg_base: new in_end relative to in_start or -n})."""
    from lzma_rs_tpu_torch.encode.lzma2_enc import lzma2_compress
    from lzma_rs_tpu_torch.tools.corpus import raw_lzma2

    def piece(k: int, n: int = 4096) -> bytes:
        off = (k * 389_017) % (len(corpus) - n)
        return corpus[off:off + n]

    entries = []  # (stream, original data, flip fraction, truncation)
    k = 0
    for preset in (1, 6, 9):
        for lc, lp, pb in ((3, 0, 2), (0, 0, 2), (1, 2, 1), (2, 1, 3)):
            d = piece(k)
            k += 1
            entries.append((raw_lzma2(d, preset, lc=lc, lp=lp, pb=pb), d,
                            None, None))
    for lc, lp, pb in ((3, 0, 4), (0, 3, 0)):
        d = piece(k)
        k += 1
        entries.append((raw_lzma2(d, 6, lc=lc, lp=lp, pb=pb), d, None, None))
    segs = [piece(k + i, 1365) for i in range(3)]  # one stream, 3 segments
    k += 3
    entries.append((raw_lzma2(segs[0])[:-1] + raw_lzma2(segs[1])[:-1]
                    + raw_lzma2(segs[2]), b"".join(segs), None, None))
    d = piece(k)
    k += 1
    entries.append((lzma2_compress(d, level=6, chunk_size=1024), d,
                    None, None))  # one segment of four LZMA chunks
    rnd = b"".join(hashlib.sha256(bytes([i])).digest() for i in range(32))
    d = piece(k, 1024) + rnd + piece(k + 1, 1024)
    k += 2
    entries.append((lzma2_compress(d, level=6, chunk_size=1024), d,
                    None, None))  # a stored chunk inside the segment
    d = piece(k)
    k += 1
    entries.append((lzma2_compress(d, level=6, props=90, dist_cap=2048),
                    d, None, None))  # lc=0 distance-capped profile
    for frac in (0.02, 0.2, 0.4, 0.6, 0.8, 0.97):
        d = piece(k)
        k += 1
        entries.append((raw_lzma2(d), d, frac, None))
    for cut in (-40, -200, 4, 0, 600, 1200):
        d = piece(k)
        k += 1
        entries.append((raw_lzma2(d), d, None, cut))

    blob, plans, expected = bytearray(), [], bytearray()
    flips, cuts = {}, {}
    for stream, data, frac, cut in entries:
        plan, _ = runtime.plan_lzma2_stream(bytes(blob) + stream, len(blob),
                                            len(expected))
        base = plan.lanes[0].seg_base
        if frac is not None:
            lane = plan.lanes[0]
            span = lane.in_end[0] - lane.in_start[0]
            flips[base] = lane.in_start[0] + 5 + int(frac * (span - 6))
        if cut is not None:
            cuts[base] = cut
        blob += stream
        expected += data
        plans.append(plan)
    check(sum(len(p.lanes) for p in plans) == 32, "phase-3 lane count")
    check(any(p.prefill and p.lanes for p in plans), "no stored chunk lane")
    corrupted = set(flips) | set(cuts)
    for pos in flips.values():
        blob[pos] ^= 0x5A
    return bytes(blob), plans, bytes(expected), corrupted, cuts


def main() -> None:
    import torch

    # -- 1. device -----------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    import lzma_rs_tpu_torch
    from lzma_rs_tpu_torch.native import loader as native_loader
    from lzma_rs_tpu_torch.ops import build
    from lzma_rs_tpu_torch.ops import segment_decoder as sd
    from lzma_rs_tpu_torch.parallel import runtime
    from lzma_rs_tpu_torch.tools import corpus as corpus_mod
    from lzma_rs_tpu_torch.tools import probe_rows
    from lzma_rs_tpu_torch.utils import stats

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    say("1 device", f"{name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    print(smi_line, flush=True)

    peaks = probe_rows.card_peaks(dev)
    say("1 device", f"{peaks.sms} SMs, max SM clock {peaks.clock_mhz:.0f} "
        f"MHz: INT32 rate {peaks.int32_ops_per_s / 1e12:.2f} T/s")

    # -- 2. build: both kernel libraries and the native one, in parallel
    def native():
        t = time.perf_counter()
        check(native_loader.load() is not None,
              "the native host library did not build or load (g++?)")
        return time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=len(build.LIBRARIES) + 1) as pool:
        jobs = [pool.submit(build.build_library, lib)
                for lib in build.LIBRARIES]
        native_s = pool.submit(native)
        built_libs = [j.result() for j in jobs]
        native_s = native_s.result()
    build.load()
    build.load_variants()
    build.load_probes()
    build.load_mosaic()
    build.load_mosaic3()
    build.load_mosaic4()
    build.load_round4()
    build.load_bisect()
    build.load_step_cost()
    build.load_lanes()
    build.load_crc()
    for lib, b in zip(build.LIBRARIES, built_libs):
        say("2 build", f"{lib.sources[0]} -> {os.path.relpath(b.path, ROOT)}"
            f" in {b.seconds:.2f} s; {ptxas_summary(b.log)}")
    sass_phase(build, dict(zip((lib.name for lib in build.LIBRARIES),
                               (b.path for b in built_libs))))
    say("2 build", f"native host library "
        f"{os.path.relpath(native_loader._so_path(), ROOT)} ready in "
        f"{native_s:.1f} s")

    corpus, distinct = corpus_mod.stdlib_corpus(CORPUS_BYTES)
    say("4 corpus", f"{len(corpus)} B of stdlib sources ({distinct} B "
        f"distinct, cycled), sha256 {hashlib.sha256(corpus).hexdigest()}")

    # -- 3. kernel against plain version on the card ------------------
    blob, plans, expected, corrupted, cuts = phase3_lanes(
        corpus, runtime)
    staged = runtime.stage_plans(blob, plans)
    cfg = staged.config
    index = {lane.seg_base: i for i, lane in enumerate(staged.lanes)}
    for base, cut in cuts.items():
        i = index[base]
        ins, ine = staged.tables[0], staged.tables[1]
        ine[i, 0] = ine[i, 0] + cut if cut < 0 else ins[i, 0] + cut
    inputs = staged.tensors(dev)
    got = sd.decode_segments(*inputs, config=cfg)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    want = sd.decode_segments_reference(*inputs, config=cfg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
    max_abs_err = held_equal(got, want, "phase 3")
    win_h, err_h, outp_h = (t.cpu().numpy() for t in got[:3])
    for i, lane in enumerate(staged.lanes):
        n = int(staged.seg_lens[i])
        if lane.seg_base in corrupted:
            continue
        check(err_h[i] == 0 and outp_h[i] == n,
              f"phase 3: clean lane {i} err {err_h[i]} outp {outp_h[i]}")
        check(win_h[i, :n].tobytes()
              == expected[lane.seg_base:lane.seg_base + n],
              f"phase 3: clean lane {i} decoded wrong bytes")
    cut_err = [int(err_h[index[b]]) for b in cuts]
    check(all(cut_err), f"phase 3: a truncated lane decoded clean {cut_err}")
    kernel_ms = cuda_ms(torch, lambda: sd.decode_segments(*inputs,
                                                         config=cfg), 20)
    flip_err = [int(err_h[i]) for i, lane in enumerate(staged.lanes)
                if lane.seg_base in corrupted and lane.seg_base not in cuts]
    say("3 kernel", f"{cfg.L} lanes (W={cfg.W}, W_IN={cfg.W_IN}, "
        f"NLIT={cfg.NLIT}, NPS={cfg.NPS}): kernel == plain version bit for "
        f"bit (win, err, outp, steps); clean lanes == stdlib; err codes "
        f"flipped {flip_err} truncated {cut_err}; kernel {kernel_ms:.3f} ms,"
        f" plain {plain_ms:.1f} ms ({int(want[3].max())} lockstep steps)")

    # -- 4. the main path at full size --------------------------------
    t = time.perf_counter()
    xa = lzma_rs_tpu_torch.xz_compress(corpus, tpu_profile=True,
                                       check_method=1)
    xb = corpus_mod.stock_archive(corpus)
    say("4 archives", f"(a) tpu_profile {len(xa)} B, (b) stock-shaped "
        f"{len(xb)} B, encoded in {time.perf_counter() - t:.1f} s")
    archives = {"a": xa, "b": xb}

    def decode(x, backend):
        os.environ["LZMA_RS_TPU_BACKEND"] = backend
        try:
            return lzma_rs_tpu_torch.xz_decompress(x)
        finally:
            del os.environ["LZMA_RS_TPU_BACKEND"]

    sd.decode_segments.launches = 0  # count the main path's launches only
    e2e = {}
    for key, x in archives.items():
        with stats.collect() as st:
            out = decode(x, "cuda")
        check(out == corpus, f"phase 4 ({key}): output differs from corpus")
        check(st.engine == "cuda", f"phase 4 ({key}): engine {st.engine!r}")
        check(st.fallbacks == [], f"phase 4 ({key}): fallbacks "
              f"{st.fallbacks}")
        e2e[key] = (best_seconds(lambda: decode(x, "cuda")), st.lanes,
                    st.kernel_iters)
    launches = sd.decode_segments.launches
    check(launches >= 8, f"phase 4: {launches} kernel launches on the "
          "main path")

    main_a = {}  # the gen-2 entry: the kernel on (a)'s whole batch
    cycles = {}  # cycles a step of the kernel on each archive
    kernel_ms = {}  # the kernel's ms on each archive's whole batch
    for key, x in archives.items():
        staged_x = runtime.stage_plans(x, runtime.plan_xz(x)[0])
        inputs_x = staged_x.tensors(dev)
        run = lambda: sd.decode_segments(*inputs_x, config=staged_x.config)
        steps_x = run()[3]
        b_x = bound(staged_x, steps_x, peaks)  # this run's steps, whole batch
        k_ms = kernel_ms[key] = cuda_ms(torch, run, 3)
        n_s = best_seconds(lambda: decode(x, "native"))
        secs, lanes, steps = e2e[key]
        c = staged_x.config
        longest = int(steps_x.max())
        cycles[key] = cycles_per_step(k_ms, longest, peaks)
        occ = sd.decoder_occupancy(c)
        check(occ * peaks.sms >= c.L, f"phase 4 ({key}): {occ} lanes an SM "
              f"x {peaks.sms} SMs < {c.L} lanes: not one wave")
        say(f"4 main ({key})", f"kernel {k_ms:.2f} ms = "
            f"{cycles[key]:.1f} cycles a step at {peaks.clock_mhz:.0f} MHz "
            f"over the longest lane's {longest} steps; shared memory "
            f"{sd.smem_bytes(c)} B a lane: {occ} lanes an SM by the "
            f"occupancy query ({sd.lanes_per_sm(c)} by shared memory alone), "
            f"{occ * peaks.sms} >= {c.L} lanes in one wave")
        say(f"4 main ({key})", f"bit-exact, engine cuda, no fallbacks; "
            f"{lanes} lanes, W={c.W} W_IN={c.W_IN} NLIT={c.NLIT}, longest "
            f"lane {steps} steps; end-to-end {len(corpus) / 1e6 / secs:.2f} "
            f"MB/s (best of 3, {secs * 1e3:.1f} ms); kernel-only "
            f"{len(corpus) / 1e3 / k_ms:.2f} MB/s ({k_ms:.1f} ms), "
            f"{bound_text(b_x)}; native host engine "
            f"{len(corpus) / 1e6 / n_s:.2f} MB/s ({os.cpu_count()} host "
            "cores)")
        # the kernel against its plain version in the main path's bucket
        if key == "a":
            cfg_x, inputs_c, picks = c, inputs_x, range(c.L)
            what_x = f"the whole batch ({c.L} lanes)"
        else:
            cfg_x, inputs_c, picks = cut_lanes(torch, staged_x, dev)
            what_x = (f"{cfg_x.L} lanes in the W={c.W} bucket (the "
                      f"{int(staged_x.seg_lens[picks[0]])} B tail block "
                      "whole, three lanes cut to its length)")
        got_x = sd.decode_segments(*inputs_c, config=cfg_x)
        t = time.perf_counter()
        want_x = sd.decode_segments_reference(*inputs_c, config=cfg_x)
        torch.cuda.synchronize()
        x_plain_s = time.perf_counter() - t
        max_abs_err = max(max_abs_err, held_equal(got_x, want_x,
                                                  f"phase 4 ({key})"))
        check_lanes(got_x, staged_x, picks, corpus, f"phase 4 ({key})")
        say(f"4 main ({key})", f"kernel == plain version bit for bit on "
            f"{what_x}; err {sorted(set(got_x[1].tolist()))}, longest lane "
            f"{int(want_x[3].max())} steps; plain {x_plain_s:.1f} s")
        if key == "a":
            main_a = {"ms": k_ms, "plain_ms": x_plain_s * 1e3,
                      "plain_lanes": c.L, "cycles_per_step": cycles["a"],
                      "longest_lane_steps": longest, "bound_ms": b_x[0],
                      "bound_by": b_x[1], "win": got_x[0].cpu(),
                      "res": [t.cpu() for t in got_x[1:]]}
        del inputs_x, inputs_c, staged_x, got_x, want_x
        torch.cuda.empty_cache()

    # -- 4. auto: the card for a large archive, the host for a small one
    small = lzma_rs_tpu_torch.xz_compress(corpus[:65536], check_method=1)
    for what, x, engine in (("(a)", xa, "cuda"), ("small", small, "native")):
        with stats.collect() as st:
            out = decode(x, "auto")
        check(out == corpus[:len(out)] and len(out) in (65536, len(corpus)),
              f"phase 4 auto {what}: output differs from corpus")
        check(st.engine == engine, f"phase 4 auto {what}: engine "
              f"{st.engine!r}, fallbacks {st.fallbacks}")
        say("4 auto", f"{what}: engine {st.engine}, fallbacks "
            f"{st.fallbacks}")

    # -- 5. a corrupt archive -----------------------------------------
    plans_a = runtime.plan_xz(xa)[0]
    lane = plans_a[len(plans_a) // 2].lanes[0]
    bad = bytearray(xa)
    bad[(lane.in_start[0] + lane.in_end[0]) // 2] ^= 0x5A
    bad = bytes(bad)
    errors = {}
    for backend in ("cuda", "native"):
        with stats.collect() as st:
            try:
                decode(bad, backend)
            except Exception as e:  # the error itself is what is compared
                errors[backend] = (type(e), str(e), st.fallbacks)
    check(set(errors) == {"cuda", "native"}, "phase 5: corrupt archive "
          f"decoded without an error on {set(errors) ^ {'cuda', 'native'}}")
    check(errors["cuda"][:2] == errors["native"][:2],
          f"phase 5: cuda {errors['cuda'][:2]} != native "
          f"{errors['native'][:2]}")
    say("5 corrupt", f"{errors['cuda'][0].__name__}: {errors['cuda'][1]!r} "
        f"on both engines; cuda fallbacks {errors['cuda'][2]}")

    # -- 6. the gen-1 configuration: (a) under LZMA_RS_TPU_VMEM_GEN=1 --
    os.environ["LZMA_RS_TPU_VMEM_GEN"] = "1"
    try:
        sd.decode_segments.launches = 0  # count the gen-1 path's launches
        with stats.collect() as st:
            out = decode(xa, "cuda")
        check(out == corpus, "phase 6: output differs from corpus")
        check(st.engine == "cuda", f"phase 6: engine {st.engine!r}")
        check(st.fallbacks == [], f"phase 6: fallbacks {st.fallbacks}")
        secs1 = best_seconds(lambda: decode(xa, "cuda"))
        launches1 = sd.decode_segments.launches
        check(launches1 >= 1, "phase 6: no kernel launch on the gen-1 path")
        staged1 = runtime.stage_plans(xa, plans_a)
    finally:
        del os.environ["LZMA_RS_TPU_VMEM_GEN"]
    c1 = staged1.config
    check(c1.W == c1.W_IN, f"phase 6: bucket W={c1.W} W_IN={c1.W_IN}")
    say("6 gen-1", f"(a) through xz_decompress: bit-exact, engine cuda, no "
        f"fallbacks, {launches1} launches; bucket W={c1.W} == W_IN="
        f"{c1.W_IN}, NLIT={c1.NLIT}, {c1.L} lanes; end-to-end "
        f"{len(corpus) / 1e6 / secs1:.2f} MB/s (best of 3, "
        f"{secs1 * 1e3:.1f} ms)")
    # the kernel at the gen-1 bucket against the gen-2 bucket, in turns
    staged2 = runtime.stage_plans(xa, plans_a)
    in1, in2 = staged1.tensors(dev), staged2.tensors(dev)
    run1 = lambda: sd.decode_segments(*in1, config=c1)
    run2 = lambda: sd.decode_segments(*in2, config=staged2.config)
    got1 = run1()
    run2()
    t2a, t1a, t1b, t2b = (cuda_ms(torch, f, 3)
                          for f in (run2, run1, run1, run2))
    gen1_ms = (t1a + t1b) / 2
    # the whole gen-1 batch equals the gen-2 batch that phase 4 held
    # against the plain version (same lane order, same outputs)
    check(torch.equal(got1[0].cpu(), main_a["win"])
          and all(torch.equal(g.cpu(), w)
                  for g, w in zip(got1[1:], main_a["res"])),
          "phase 6: the kernel at the gen-1 bucket differs from gen-2's")
    b1 = bound(staged1, got1[3], peaks)
    say("6 gen-1", f"kernel on the whole batch == the gen-2 bucket's "
        f"(win, err, outp, steps); kernel {t1a:.2f} / {t1b:.2f} ms at "
        f"W_IN={c1.W_IN} against {t2a:.2f} / {t2b:.2f} ms at W_IN="
        f"{staged2.config.W_IN} (gen-2, gen-1, gen-1, gen-2); "
        f"{bound_text(b1)}")
    del in1, in2, got1, staged2
    torch.cuda.empty_cache()
    cfg_c, inputs_c, picks = cut_lanes(torch, staged1, dev, spread=31)
    got_c = sd.decode_segments(*inputs_c, config=cfg_c)
    t = time.perf_counter()
    want_c = sd.decode_segments_reference(*inputs_c, config=cfg_c)
    torch.cuda.synchronize()
    gen1_plain_s = time.perf_counter() - t
    gen1_err = held_equal(got_c, want_c, "phase 6")
    check_lanes(got_c, staged1, picks, corpus, "phase 6")
    say("6 gen-1", f"kernel == plain version bit for bit on {cfg_c.L} lanes "
        f"of the W={c1.W} W_IN={c1.W_IN} bucket (the "
        f"{int(staged1.seg_lens[picks[0]])} B tail block whole, {cfg_c.L - 1}"
        f" lanes cut to its length); err "
        f"{sorted(set(got_c[1].tolist()))}, longest lane "
        f"{int(want_c[3].max())} steps; plain {gen1_plain_s:.1f} s")

    # -- 7. the probe kernels ----------------------------------------
    from lzma_rs_tpu_torch.ops import probes, probes_mosaic
    from lzma_rs_tpu_torch.tools import (probe_lane2d, probe_mosaic,
                                         probe_mosaic2, probe_state_in_ref)

    probe_entries, by = probes_phase(
        torch, dev, "7", probe_lane2d.ROWS_OF_TOOL
        + probe_state_in_ref.ROWS_OF_TOOL, probes.WRAPPERS,
        "lzma_rs_tpu_torch/csrc/probes.cu", PROBE_REPLACES, PROBE_MAIN_ROW)
    realweight_lines(by, probe_entries, peaks)
    bitdecode_lines(by, probe_entries, peaks)
    tinyops_lines(by, probe_entries, build.build_library(build.PROBES).path,
                  peaks)

    # -- 8. the mosaic probe kernels ---------------------------------
    entries, by = probes_phase(
        torch, dev, "8", probe_mosaic.ROWS_OF_TOOL
        + probe_mosaic2.ROWS_OF_TOOL, probes_mosaic.WRAPPERS,
        "lzma_rs_tpu_torch/csrc/probes_mosaic.cu", MOSAIC_REPLACES,
        MOSAIC_MAIN_ROW)
    segments_lines(by, entries, build.build_library(build.MOSAIC).path,
                   peaks)
    gather_lines(torch, dev, by, entries, peaks)
    rw_lines(torch, dev, by, entries, peaks)
    row_lines(torch, dev, by, entries, peaks)
    probe_entries += entries

    # -- 9. the mosaic3 probe kernels --------------------------------
    from lzma_rs_tpu_torch.ops import probes_mosaic3
    from lzma_rs_tpu_torch.tools import probe_mosaic3

    entries = probes_phase(
        torch, dev, "9", probe_mosaic3.ROWS_OF_TOOL, probes_mosaic3.WRAPPERS,
        "lzma_rs_tpu_torch/csrc/probes_mosaic3.cu", MOSAIC3_REPLACES,
        MOSAIC3_MAIN_ROW)[0]
    block_lines("9", mosaic3_attributes(dev), probe_mosaic3.L, entries,
                ("vote_chain", "byte_chain", "onehot_chain", "window_chain"),
                peaks)
    probe_entries += entries
    text, shift = byte_sass_text(build.build_library(build.MOSAIC3).path)
    say("9 probes", "byte_chain (P11a shift, P11b select): " + text)
    check(shift is None or shift == (4, 0), "phase 9: P11a's pass of four "
          f"steps holds {shift} (PRMTs, variable shifts), want (4, 0)")

    # -- 10. the mosaic4 probe kernel --------------------------------
    from lzma_rs_tpu_torch.ops import probes_mosaic4, probes_round4
    from lzma_rs_tpu_torch.tools import probe_mosaic4, probe_round4

    entries = probes_phase(
        torch, dev, "10", probe_mosaic4.ROWS_OF_TOOL, probes_mosaic4.WRAPPERS,
        "lzma_rs_tpu_torch/csrc/probes_mosaic4.cu", MOSAIC4_REPLACES,
        MOSAIC4_MAIN_ROW)[0]
    pm4 = probes_mosaic4
    block_lines("10", {v: pm4.kernel_attributes(v) for v in pm4.VARIANTS},
                probe_mosaic4.L, entries, "table_chain", peaks)
    probe_entries += entries

    # -- 11. the round4 probe kernels --------------------------------
    entries, by = probes_phase(
        torch, dev, "11", probe_round4.ROWS_OF_TOOL, probes_round4.WRAPPERS,
        "lzma_rs_tpu_torch/csrc/probes_round4.cu", ROUND4_REPLACES,
        ROUND4_MAIN_ROW)
    round4_blocks(dev, by, entries, build.build_library(build.ROUND4).path,
                  peaks)
    probe_entries += entries

    # -- 12. the bisect probe kernel ---------------------------------
    from lzma_rs_tpu_torch.ops import probes_bisect
    from lzma_rs_tpu_torch.tools import probe_lane2d_bisect

    entries, by = probes_phase(
        torch, dev, "12", probe_lane2d_bisect.ROWS_OF_TOOL,
        probes_bisect.WRAPPERS, "lzma_rs_tpu_torch/csrc/probes_bisect.cu",
        BISECT_REPLACES, BISECT_MAIN_ROW)
    pb = probes_bisect
    block_lines("12", {n: pb.kernel_attributes(n.split()[0])
                       for n, _ in probe_lane2d_bisect.ROWS_OF_TOOL},
                probe_lane2d_bisect.S * 128, entries, "bisect_chain", peaks)
    probe_entries += entries
    cyc = {k: r["cycles_per_iter"] for k, r in by.items()}
    first = BISECT_FIRST_CYCLES
    say("12 probes", "stage costs, cycles per iteration (tool's / seeded "
        "input; the first design's on the tool's input): " + "; ".join(
            f"{what} ({row.split()[0]} - {base.split()[0]}) "
            f"{cyc[row, 'tool'] - cyc[base, 'tool']:.1f} / "
            f"{cyc[row, 'seeded'] - cyc[base, 'seeded']:.1f} (first "
            f"{first[row] - first[base]:.1f})"
            for what, row, base in BISECT_STAGES))
    say("12 probes", "one function, timed apart (largest spread over the "
        "smallest, tool's / seeded): " + "; ".join(
            " = ".join(r.split()[0] for r in rows) + " " + " / ".join(
                f"{(max(c) / min(c) - 1) * 100:.1f}%" for c in (
                    [cyc[r, w] for r in rows] for w in ("tool", "seeded")))
            for rows in BISECT_CONTROLS))
    say("12 probes", "loop-invariant reads: "
        + bisect_sass_text(build.build_library(build.BISECT).path))

    # -- 13. lane batching: (a) in slabs, the dry run, entry() -------
    from lzma_rs_tpu_torch import graft_entry

    os.environ["LZMA_RS_TPU_VMEM_L"] = "256"
    try:
        sd.decode_segments.launches = 0  # count this path's launches
        with stats.collect() as st:
            out = decode(xa, "cuda")
        slab_launches = sd.decode_segments.launches
        secs13 = best_seconds(lambda: decode(xa, "cuda"))
    finally:
        del os.environ["LZMA_RS_TPU_VMEM_L"]
    check(out == corpus, "phase 13: output differs from corpus")
    check(st.engine == "cuda" and st.fallbacks == [] and st.devices == 1,
          f"phase 13: engine {st.engine!r}, fallbacks {st.fallbacks}, "
          f"devices {st.devices}")
    staged13 = runtime.stage_plans(xa, plans_a)
    n13 = len(staged13.lanes)
    slabs13 = [ab for launch in runtime.slab_launches(n13, 256, 1)
               for ab in launch]
    check(slab_launches == len(slabs13) == 8,
          f"phase 13: {slab_launches} launches for {len(slabs13)} slabs")
    slab_ms = []
    for a, b in slabs13:
        inputs13 = staged13.tensors(dev, a, b)
        cfg13 = staged13.slab_config(a, b)
        slab_ms.append(cuda_ms(torch, lambda: sd.decode_segments(
            *inputs13, config=cfg13), 3))
    del inputs13, staged13
    say("13 slabs", f"(a) with LZMA_RS_TPU_VMEM_L=256: {slab_launches} "
        f"launches of {[b - a for a, b in slabs13]} lanes on one card, "
        f"bit-exact, engine cuda, no fallbacks, stats.devices 1; summed "
        f"kernel time {sum(slab_ms):.1f} ms "
        f"({', '.join(f'{t:.1f}' for t in slab_ms)}) against phase 4's "
        f"single launch {main_a['ms']:.1f} ms; end to end "
        f"{len(corpus) / 1e6 / secs13:.2f} MB/s (best of 3, "
        f"{secs13 * 1e3:.1f} ms) against phase 4's "
        f"{len(corpus) / 1e6 / e2e['a'][0]:.2f}")
    t = time.perf_counter()
    for line in graft_entry.dryrun_multichip(1):
        say("13 dry run", line)
    say("13 dry run", f"three classes passed in {time.perf_counter() - t:.1f}"
        " s")
    fn13, args13 = graft_entry.entry()
    sd.decode_segments.launches = 0
    win13 = fn13(*args13)
    check(sd.decode_segments.launches == 1, "phase 13: entry() launches "
          f"{sd.decode_segments.launches}")
    want13 = fn13.reference(*args13)
    check(torch.equal(win13.cpu(), want13.cpu()),
          "phase 13: entry() differs from its plain version")
    say("13 entry", f"entry(): decode_segments on {args13[0].shape[0]} "
        f"lanes == its plain version ({tuple(win13.shape)} window)")

    # -- 14. the decoder's variants, in turns --------------------------
    variants_phase(torch, dev, archives, peaks, runtime, sd)

    # -- 15. the measurement modules ----------------------------------
    crc_entry = measurement_phase(torch, dev, archives, corpus, kernel_ms,
                                  sd)

    # -- 16. the router -------------------------------------------------
    router_phase(torch, dev, corpus, archives, runtime, stats)

    # -- 17. multi-process decode on the card --------------------------
    multihost_phase(torch, archives, corpus)

    # -- 18. the CLI ----------------------------------------------------
    cli_phase(corpus, xa)

    # -- 19. the step-cost builds and tools ----------------------------
    step_cost_phase(torch, dev, archives, peaks, runtime, sd)

    # -- 20. mutants on the card ---------------------------------------
    mutants_phase(torch, dev, corpus, runtime, stats, decode, sd)

    # -- 21. the lane engine --------------------------------------------
    lane_entry = lane_phase(torch, dev, corpus, archives, peaks, runtime,
                            stats)

    check("jax" not in sys.modules, "jax was imported")
    jax_pkg = sorted(m for m in sys.modules
                     if m == "lzma_rs_tpu" or m.startswith("lzma_rs_tpu."))
    check(not jax_pkg, f"the JAX package was imported: {jax_pkg}")
    print(smi_line, flush=True)
    common = {"route": "cuda",
              "source": "lzma_rs_tpu_torch/csrc/decode_segments.cu",
              "library_ms": None}  # no PyTorch call decodes LZMA
    print(json.dumps({"kernels": [
        {"name": "decode_segments", **common,
         "replaces": "lzma_rs_tpu/ops/vmem2_decoder.py:2121",
         "launches": launches, "max_abs_err": max_abs_err,
         **{k: main_a[k] for k in ("ms", "plain_ms", "plain_lanes",
                                   "cycles_per_step", "longest_lane_steps",
                                   "bound_ms", "bound_by")}},
        {"name": "decode_segments (gen-1 bucket)", **common,
         "replaces": "lzma_rs_tpu/ops/vmem_decoder.py:1087",
         "launches": launches1, "max_abs_err": gen1_err, "ms": gen1_ms,
         "plain_ms": gen1_plain_s * 1e3, "plain_lanes": cfg_c.L,
         "bound_ms": b1[0], "bound_by": b1[1]},
        *probe_entries,
        lane_entry,
        crc_entry,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-rank"]:
        multihost_rank(sys.argv[2:])
    else:
        main()
