"""Parallel decode runtime of the port: segments -> lanes -> the CUDA kernel.

Two halves:

- The host half is a copy of the JAX package's JAX-free host code
  (``lzma_rs_tpu/parallel/runtime.py``), each block marked with the lines it
  was copied from and changed only in its imports: the container walk and
  chunk scan (``plan_xz``, ``plan_lzma2_stream``), the eligibility gate,
  the native host engines, and the host replays that give the reference's
  exact errors.
- The device half: :func:`choose_config` picks the shape bucket with the
  JAX package's rules (gen-2's by default, gen-1's under
  ``LZMA_RS_TPU_VMEM_GEN=1``), and :func:`execute_plan_device` stages every
  lane of the plans, cuts them into slabs (by default one slab a card,
  so one launch of every lane on a one-card host; ``LZMA_RS_TPU_VMEM_L``
  lanes a slab where set) and runs ``ops/segment_decoder.decode_segments``
  on each slab.

Engines: ``cuda`` (the kernel on ``device``, by default the current CUDA
device; it raises when there is none or the kernel does not build),
``native`` (the host thread pool) and ``auto`` (``cuda`` when the workload
is large enough, the plans pass the eligibility gate, a CUDA device is
present, the kernel builds and the cost model, calibrated on the card,
finds the card clearly faster; ``native`` otherwise, with the reason in
``stats.fallbacks``: :func:`_resolve_auto`). An explicit CPU ``device``
runs the same path through the kernel's plain PyTorch version; the tests
use it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from lzma_rs_tpu_torch.formats import lzma2 as lzma2_fmt
from lzma_rs_tpu_torch.formats import xz as xz_fmt
from lzma_rs_tpu_torch.ops import build
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig, pack_chunk_meta
from lzma_rs_tpu_torch.parallel import mesh
from lzma_rs_tpu_torch.utils import logging as log
from lzma_rs_tpu_torch.utils import stats as stats_mod
from lzma_rs_tpu_torch.utils.cursor import ByteCursor
from lzma_rs_tpu_torch.utils.errors import IoError, LzmaError, XzError


# -- copied from lzma_rs_tpu/parallel/runtime.py:38-137

@dataclasses.dataclass
class LanePlan:
    """One lane = one dict-reset segment (or one raw-LZMA stream)."""

    in_start: List[int]
    in_end: List[int]
    out_start: List[int]
    out_end: List[int]
    reset_state: List[int]
    lc: List[int]
    lp: List[int]
    pb: List[int]
    seg_base: int
    size_known: int
    dict_size: int


@dataclasses.dataclass
class DecodePlan:
    lanes: List[LanePlan]
    prefill: List[Tuple[int, int, int]]  # (src_off, dst_off, length)
    total_out: int
    # Chunk-header error deferred by the scanner (formats/lzma2.py): the
    # reference's sequential loop decodes the recorded prefix before
    # reaching the broken header, so plan executors must not surface
    # this ahead of prefix decode errors — they replay sequentially.
    pending_error: Optional[Exception] = None


class UnparallelizableStream(Exception):
    """The stream carries probability state across a dict-reset boundary
    (legal per the reference: an uncompressed dict-reset chunk does not
    touch the probability model, decode/lzma2.rs:195-228, and a following
    reset_mode-0 chunk continues it). Segments are then not independent
    and the stream must decode sequentially."""


def plan_lzma2_stream(
    data: bytes, start: int, out_base: int
) -> Tuple[DecodePlan, int]:
    """Plan one LZMA2 chunk stream; returns (plan, consumed_bytes).

    Output offsets are absolute (``out_base`` + position in this stream).

    Raises :class:`UnparallelizableStream` when a non-initial segment's
    first LZMA chunk does not reset the probability model — parallel
    engines fall back to the sequential host decoder for exactness.
    """
    cursor = ByteCursor(data, start)
    table = lzma2_fmt.scan(cursor)

    lanes: List[LanePlan] = []
    prefill: List[Tuple[int, int, int]] = []
    lane: Optional[LanePlan] = None

    # Props inheritance: LZMA2 starts from lc=0, lp=0, pb=0
    # (decode/lzma2.rs:23-34).
    lc, lp, pb = 0, 0, 0
    abs_out = out_base

    for chunk in table.chunks:
        if chunk.reset_dict or lane is None:
            lane = LanePlan(
                in_start=[], in_end=[], out_start=[], out_end=[],
                reset_state=[], lc=[], lp=[], pb=[],
                seg_base=abs_out, size_known=1,
                dict_size=0xFFFFFFFF,  # LZMA2 has no distance cap per se
            )
            lanes.append(lane)
        if (
            chunk.kind == lzma2_fmt.KIND_LZMA
            and not chunk.reset_state
            and not lane.in_start
            and len(lanes) > 1
        ):
            # first LZMA chunk of a later segment continues the previous
            # segment's probability model: segments are not independent
            raise UnparallelizableStream()
        if chunk.kind == lzma2_fmt.KIND_UNCOMPRESSED:
            prefill.append((chunk.data_off, abs_out, chunk.unpacked_size))
        else:
            if chunk.reset_props:
                lc, lp, pb = chunk.props.lc, chunk.props.lp, chunk.props.pb
            lane.in_start.append(chunk.data_off)
            lane.in_end.append(chunk.data_off + chunk.packed_size)
            lane.out_start.append(abs_out)
            lane.out_end.append(abs_out + chunk.unpacked_size)
            lane.reset_state.append(1 if chunk.reset_state else 0)
            lane.lc.append(lc)
            lane.lp.append(lp)
            lane.pb.append(pb)
        abs_out += chunk.unpacked_size

    plan = DecodePlan(
        lanes=[l for l in lanes if l.in_start],  # drop all-uncompressed lanes
        prefill=prefill,
        total_out=abs_out - out_base,
        pending_error=table.pending_error,
    )
    return plan, table.end_off - start


# -- copied from lzma_rs_tpu/parallel/runtime.py:265-436

def execute_plan_native(
    data: bytes, plans: List[DecodePlan], threads: Optional[int] = None
) -> bytes:
    """Segment-parallel decode on the host: a thread pool drives the native
    C++ flat decoder, one call per dict-reset segment, all writing disjoint
    ranges of one shared output buffer (ctypes releases the GIL, so threads
    scale across cores). This is the CPU twin of the TPU lane kernel."""
    import ctypes
    import os
    from concurrent.futures import ThreadPoolExecutor

    from lzma_rs_tpu_torch.native import loader

    lib = loader.load()
    if lib is None:
        raise RuntimeError("native library unavailable")

    total_out = sum(p.total_out for p in plans)
    lanes: List[LanePlan] = []
    prefill: List[Tuple[int, int, int]] = []
    for p in plans:
        lanes.extend(p.lanes)
        prefill.extend(p.prefill)

    out = bytearray(total_out)
    src = np.frombuffer(data, dtype=np.uint8)
    outv = np.frombuffer(out, dtype=np.uint8)
    for src_off, dst_off, n in prefill:
        outv[dst_off : dst_off + n] = src[src_off : src_off + n]

    from lzma_rs_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.engine = "native"
        st.lanes += len(lanes)
        st.chunks += sum(len(l.in_start) for l in lanes)
        st.prefill_bytes += sum(n for _, _, n in prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += total_out

    if not lanes:
        return bytes(out)

    base_addr = ctypes.addressof(ctypes.c_char.from_buffer(out))

    def run(lane: LanePlan):
        seg_cap = lane.out_end[-1] - lane.seg_base
        chunks = [
            (
                lane.in_start[i],
                lane.in_end[i],
                lane.out_start[i] - lane.seg_base,
                lane.out_end[i] - lane.seg_base,
                lane.reset_state[i],
                lane.lc[i],
                lane.lp[i],
                lane.pb[i],
            )
            for i in range(len(lane.in_start))
        ]
        lib.lzma2_decode_segment(
            data, chunks, base_addr + lane.seg_base, seg_cap
        )

    nthreads = threads or min(32, (os.cpu_count() or 1))
    with stats_mod.launch_timer(st):
        if nthreads <= 1 or len(lanes) == 1:
            for lane in lanes:
                run(lane)
        else:
            with ThreadPoolExecutor(max_workers=nthreads) as pool:
                for f in [pool.submit(run, lane) for lane in lanes]:
                    f.result()
    return bytes(out)


def _execute_native_blockwise(
    data: bytes,
    plans: List[DecodePlan],
    block_spans: List[Tuple[int, int, int, int]],
    header_flags,
) -> bytes:
    """Decode + verify per block in one fused task pipeline."""
    import ctypes
    import os
    from concurrent.futures import ThreadPoolExecutor

    from lzma_rs_tpu_torch.native import loader
    from lzma_rs_tpu_torch.utils import stats as stats_mod

    lib = loader.load()
    if lib is None:
        raise RuntimeError("native library unavailable")

    total_out = sum(p.total_out for p in plans)
    out = bytearray(total_out)
    outv_np = np.frombuffer(out, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    for p in plans:
        for src_off, dst_off, n in p.prefill:
            outv_np[dst_off : dst_off + n] = src[src_off : src_off + n]

    base_addr = ctypes.addressof(ctypes.c_char.from_buffer(out))
    outv = memoryview(out)

    st = stats_mod.current()
    if st is not None:
        st.engine = "native"
        st.lanes += sum(len(p.lanes) for p in plans)
        st.chunks += sum(len(l.in_start) for p in plans for l in p.lanes)
        st.prefill_bytes += sum(n for p in plans for _, _, n in p.prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += total_out

    def run_block(plan: DecodePlan, span):
        _, check_off, out0, outn = span
        for lane in plan.lanes:
            seg_cap = lane.out_end[-1] - lane.seg_base
            chunks = [
                (
                    lane.in_start[i], lane.in_end[i],
                    lane.out_start[i] - lane.seg_base,
                    lane.out_end[i] - lane.seg_base,
                    lane.reset_state[i], lane.lc[i], lane.lp[i], lane.pb[i],
                )
                for i in range(len(lane.in_start))
            ]
            lib.lzma2_decode_segment(
                data, chunks, base_addr + lane.seg_base, seg_cap
            )
        xz_fmt.validate_block_check(
            ByteCursor(data, check_off),
            outv[out0 : out0 + outn],
            header_flags.check_method,
        )

    nthreads = min(32, os.cpu_count() or 1)
    with stats_mod.launch_timer(st):
        if nthreads <= 1 or len(plans) == 1:
            for plan, span in zip(plans, block_spans):
                run_block(plan, span)
        else:
            with ThreadPoolExecutor(max_workers=nthreads) as pool:
                futures = [
                    pool.submit(run_block, plan, span)
                    for plan, span in zip(plans, block_spans)
                ]
                for f in futures:  # stream order: first error wins
                    f.result()
    return bytes(out)


class VmemIneligible(Exception):
    """The plan does not fit the VMEM kernel's static budget (segment or
    staged input larger than the window bucket, too many chunks per
    segment, or literal contexts beyond the table size). Carries the
    specific reason; runtimes record it in stats so fallbacks are never
    silent."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _record_fallback(reason: str) -> None:
    from lzma_rs_tpu_torch.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.fallbacks.append(reason)
    log.debug("fallback: %s", reason)


# -- copied from lzma_rs_tpu/parallel/runtime.py:606-614

def _lane_gap_free(lane: LanePlan) -> bool:
    """True when the lane's chunks are output-contiguous from seg_base —
    no mid-segment stored chunks (prefill) the ring would never learn."""
    pos = lane.seg_base
    for s, e in zip(lane.out_start, lane.out_end):
        if s != pos:
            return False
        pos = e
    return True


# -- copied from lzma_rs_tpu/parallel/runtime.py:703-742

def check_vmem_eligibility(lanes: List[LanePlan], cfg) -> None:
    """Raise :class:`VmemIneligible` if any lane exceeds the VMEM kernel's
    static budget under ``cfg``. Shared by the staging path and the
    ``auto`` engine router (which must know eligibility before committing
    to a device launch)."""
    import math

    max_lclp = int(math.log2(cfg.NLIT))
    for lane in lanes:
        seg_len = lane.out_end[-1] - lane.seg_base
        packed = sum(e - s for s, e in zip(lane.in_start, lane.in_end))
        if seg_len > cfg.W:
            raise VmemIneligible(
                f"segment {seg_len} B > window bucket {cfg.W} B"
            )
        if packed > cfg.W_IN:
            raise VmemIneligible(
                f"segment packed input {packed} B > input bucket {cfg.W_IN} B"
            )
        if len(lane.in_start) > cfg.K:
            raise VmemIneligible(
                f"segment has {len(lane.in_start)} chunks > K={cfg.K}"
            )
        for lc, lp in zip(lane.lc, lane.lp):
            if lc + lp > max_lclp:
                raise VmemIneligible(
                    f"lc+lp={lc + lp} > literal-table budget {max_lclp} "
                    f"(NLIT={cfg.NLIT})"
                )
        for pb in lane.pb:
            if (1 << pb) > cfg.NPS:
                raise VmemIneligible(
                    f"pb={pb} exceeds the pos-state table width NPS="
                    f"{cfg.NPS}"
                )
        if cfg.RING and not _lane_gap_free(lane):
            raise VmemIneligible(
                "ring mode needs gap-free segments (mid-segment stored "
                "chunks present)"
            )


# -- copied from lzma_rs_tpu/parallel/runtime.py:1033-1040

class _KernelError(Exception):
    """Internal: a lane flagged an error; host replay produces the exact
    reference error."""

    def __init__(self, lane: int, code: int):
        super().__init__(f"lane {lane} error code {code}")
        self.lane = lane
        self.code = code


# -- copied from lzma_rs_tpu/parallel/runtime.py:1049-1057

def _host_lzma2(data: bytes) -> bytes:
    from lzma_rs_tpu_torch.native import loader

    lib = loader.load()
    if lib is not None:
        return lib.lzma2_decode(data)
    from lzma_rs_tpu_torch.models.codecs import Lzma2Decoder

    return Lzma2Decoder().decompress(ByteCursor(data))


# -- copied from lzma_rs_tpu/parallel/runtime.py:1377-1528

def plan_xz(data: bytes, stop_on_error: bool = False):
    """Pass 1 of `.xz` decode: walk the container (headers + chunk tables,
    no payload decoding) and return
    ``(plans, block_spans, header_flags, records, cursor)`` with the
    cursor parked at the index. Each block's plan carries absolute output
    offsets, so placement is known before any decode.

    ``stop_on_error`` (the bounded corrupt-archive path): block-scope
    errors — a malformed block header, size mismatches, or a deferred
    chunk-header error behind decodable chunks — stop the walk instead
    of raising, and a SIXTH element carries the deferred exception. The
    returned plans then cover exactly what the reference's sequential
    decoder would decode before hitting the error (complete prefix
    blocks, plus the erroring block's decodable chunk prefix whose span
    has check_off=None); the caller decodes/verifies that prefix and
    re-raises. An adversarial input no longer costs a full sequential
    replay unless the prefix itself fails (VERDICT r4 weak #8)."""
    from lzma_rs_tpu_torch.utils.errors import IoError

    cursor = ByteCursor(data)
    header_flags = xz_fmt.parse_stream_header(cursor)

    plans: List[DecodePlan] = []
    block_spans: List[Tuple[int, int, int, int]] = []  # start, payload, out0, outn
    records: List[xz_fmt.Record] = []
    out_base = 0
    deferred: Optional[Exception] = None

    while True:
        block_start = cursor.pos
        try:
            info = xz_fmt.read_block_header_at(cursor)
            if info is None:
                break
            filt = info.header.filters[0]
            if len(filt.props) != 1:
                raise XzError("Invalid properties for filter Lzma2")
            payload_start = cursor.pos
            plan, consumed = plan_lzma2_stream(data, payload_start, out_base)
            if plan.pending_error is not None:
                # A chunk-header error behind decodable chunks: the
                # reference surfaces prefix decode errors (then this
                # error) before any container-level size validation.
                if not stop_on_error:
                    raise UnparallelizableStream()
                deferred = plan.pending_error
                if plan.lanes or plan.prefill:
                    plans.append(plan)
                    block_spans.append(
                        (block_start, None, out_base, plan.total_out)
                    )
                break
            cursor.pos = payload_start + consumed
            if (
                info.header.packed_size is not None
                and consumed != info.header.packed_size
            ):
                raise XzError(
                    f"Invalid compressed size: expected "
                    f"{info.header.packed_size} but got {consumed}"
                )
            if (
                info.header.unpacked_size is not None
                and plan.total_out != info.header.unpacked_size
            ):
                raise XzError(
                    f"Invalid decompressed size: expected "
                    f"{info.header.unpacked_size} but got {plan.total_out}"
                )
            count = cursor.pos - block_start
            pad = xz_fmt.padding_size(count)
            xz_fmt.read_padding(cursor, pad, "block")
            check_off = cursor.pos
            cursor.skip(xz_fmt.check_size(header_flags.check_method))
        except UnparallelizableStream:
            raise
        except (LzmaError, XzError, IoError) as e:
            if not stop_on_error:
                raise
            deferred = e
            break
        plans.append(plan)
        block_spans.append((block_start, check_off, out_base, plan.total_out))
        records.append(
            xz_fmt.Record(
                unpadded_size=cursor.pos - block_start - pad,
                unpacked_size=plan.total_out,
            )
        )
        out_base += plan.total_out

    if stop_on_error:
        return plans, block_spans, header_flags, records, cursor, deferred
    return plans, block_spans, header_flags, records, cursor


def _sequential_xz_replay(data: bytes) -> bytes:
    """Reference-ordered sequential `.xz` decode for error replay.

    Uses the spec container walk (exact reference errors) with the
    NATIVE sequential LZMA2 chunk loop as the payload decoder when
    available — pure-Python payload decode is ~0.1 MB/s, which made
    replaying a large corrupt archive take minutes."""
    from lzma_rs_tpu_torch.models.codecs import xz_decode_stream
    from lzma_rs_tpu_torch.native import loader

    lib = loader.load()
    hook = None
    if lib is not None:
        buf = data

        def hook(cursor):
            out, consumed = lib.lzma2_decode_at(buf, cursor.pos)
            cursor.pos += consumed
            return out

    return xz_decode_stream(ByteCursor(data), decode_lzma2=hook)


def _bounded_error_replay(
    data: bytes, plans, block_spans, header_flags, deferred: Exception
) -> bytes:
    """Bounded corrupt-archive path: the planner stopped at a block-scope
    error with a clean prefix plan. Decode the prefix with the parallel
    NATIVE engine and verify its checks in stream order; if everything
    is clean the reference's first error IS the deferred one — raise it
    without replaying the archive sequentially. Any prefix failure falls
    back to the full sequential replay (exact reference ordering)."""
    try:
        if plans:
            out = execute_plan_native(data, plans)
            outv = memoryview(out)
            for block_start, check_off, out0, outn in block_spans:
                if check_off is None:
                    continue  # the erroring block never reaches its check
                xz_fmt.validate_block_check(
                    ByteCursor(data, check_off), outv[out0 : out0 + outn],
                    header_flags.check_method,
                )
    except (LzmaError, XzError) as e:
        # a prefix error surfaces before the deferred one — but only the
        # sequential decoder guarantees the reference's exact ordering
        # for multi-error prefixes
        _record_fallback(
            f"host replay: prefix error before deferred ({e})"
        )
        return _sequential_xz_replay(data)
    except Exception:
        _record_fallback("host replay: prefix decode failed (bounded path)")
        return _sequential_xz_replay(data)
    _record_fallback("bounded replay: clean prefix, raising deferred error")
    raise deferred


# -- the device half ---------------------------------------------------------

ENGINES = ("auto", "cuda", "native")


def cuda_device(device=None) -> torch.device:
    """The device of the ``cuda`` engine: ``device`` when given, else the
    current CUDA device. Raises when no CUDA device is present: the engine
    never runs on the CPU in the card's place."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "engine 'cuda' needs a CUDA device; torch.cuda.is_available() "
            "is False"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _packed(lane: LanePlan) -> int:
    return sum(e - s for s, e in zip(lane.in_start, lane.in_end))


def choose_config(plans: List[DecodePlan]) -> SegmentConfig:
    """The shape bucket for a set of plans, by the JAX package's rules
    (``choose_vmem_config``): the smallest window bucket (2-64 KiB) that
    holds every segment, an independent input bucket, ``NLIT`` from the
    largest lc+lp and ``NPS`` from the largest pb. One batch holds every
    lane, so ``L`` is the lane count.

    Under ``LZMA_RS_TPU_VMEM_GEN=1`` the bucket is gen-1's
    (``lzma_rs_tpu/parallel/runtime.py:500-510``): one bucket for window
    and staged input, the window bucket grown while it is below the
    longest lane's packed input (capped at 64 KiB). The same kernel runs
    either bucket."""
    need_w = need_in = 1
    max_lclp = max_pb = n_lanes = 0
    for p in plans:
        for lane in p.lanes:
            n_lanes += 1
            need_w = max(need_w, lane.out_end[-1] - lane.seg_base)
            need_in = max(need_in, _packed(lane))
            for lc, lp in zip(lane.lc, lane.lp):
                max_lclp = max(max_lclp, lc + lp)
            max_pb = max(max_pb, max(lane.pb, default=0))
    bucket = 2048
    while bucket < need_w and bucket < 65536:
        bucket *= 2
    if os.environ.get("LZMA_RS_TPU_VMEM_GEN") == "1":
        while bucket < need_in and bucket < 65536:
            bucket *= 2
        bucket_in = bucket
    else:
        bucket_in = 2048
        while bucket_in < need_in and bucket_in < 65536:
            bucket_in *= 2
    return SegmentConfig(
        L=max(1, n_lanes), W=bucket, W_IN=bucket_in,
        NLIT=1 << min(max_lclp, 3), K=8, NPS=4 if max_pb <= 2 else 16,
    )


def _prefill_test(prefill):
    """``lane -> bool``: does the lane's segment overlap a stored chunk?"""
    if not prefill:
        return lambda lane, seg_len: False
    spans = sorted((d, d + n) for _, d, n in prefill if n > 0)
    starts = np.array([s for s, _ in spans], dtype=np.int64)
    ends_max = np.maximum.accumulate(np.array([e for _, e in spans],
                                              dtype=np.int64))

    def overlaps(lane, seg_len):
        idx = int(np.searchsorted(starts, lane.seg_base + seg_len))
        return idx > 0 and ends_max[idx - 1] > lane.seg_base

    return overlaps


@dataclasses.dataclass
class StagedLanes:
    """Every lane of a set of plans in ``decode_segments``'s lane-major
    layout (numpy), biggest segment first."""

    config: SegmentConfig
    lanes: List[LanePlan]
    seg_lens: np.ndarray     # [L] int64, each lane's segment length
    out: np.ndarray          # the whole output, stored chunks placed
    inbuf: np.ndarray        # [L, W_IN] u8
    win_init: Optional[np.ndarray]  # [L, W] u8; None: no stored chunks
    tables: Tuple[np.ndarray, ...]  # in_start, in_end, out_start, out_end,
                                    # chunk_meta: [L, K] i32
    prefilled: np.ndarray    # [L] bool: the lanes win_init holds bytes of

    def slab_config(self, a: int, b: int) -> SegmentConfig:
        """The bucket of lanes ``a:b``: the batch's, at ``b - a`` lanes."""
        return dataclasses.replace(self.config, L=b - a)

    def tensors(self, device, a: int = 0, b: Optional[int] = None) -> tuple:
        """The seven ``decode_segments`` inputs of lanes ``a:b`` (all by
        default) on ``device``. A window of zeros is made there when none
        of those lanes holds a stored chunk."""
        b = len(self.lanes) if b is None else b
        cfg = self.slab_config(a, b)

        def put(arr):
            return torch.from_numpy(arr[a:b]).to(device)

        if self.win_init is None or not self.prefilled[a:b].any():
            win = torch.zeros((cfg.L, cfg.W), dtype=torch.uint8,
                              device=device)
        else:
            win = put(self.win_init)
        return (put(self.inbuf), win) + tuple(put(t) for t in self.tables)


def stage_plans(data: bytes, plans: List[DecodePlan]) -> StagedLanes:
    """Place the stored chunks and stage every lane of ``plans`` into one
    batch. Raises :class:`VmemIneligible` when a lane does not fit the
    bucket rules, or when a chunk's input runs past the end of ``data``
    (a corrupt packed size: staged, the lane would decode the zeros after
    the stream's end; the host engine raises the reference's error)."""
    cfg = choose_config(plans)
    lanes = [lane for p in plans for lane in p.lanes]
    prefill = [f for p in plans for f in p.prefill]
    check_vmem_eligibility(lanes, cfg)
    past = max((e for lane in lanes for e in lane.in_end), default=0)
    if past > len(data):
        raise VmemIneligible(f"chunk input ends {past - len(data)} B past "
                             "the stream")
    # biggest first, so neighbouring lanes (one warp) carry similar work
    lanes.sort(key=_packed, reverse=True)

    out = np.zeros(sum(p.total_out for p in plans), dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    for s_off, d_off, n in prefill:
        out[d_off:d_off + n] = src[s_off:s_off + n]

    L, K = len(lanes), cfg.K
    inbuf = np.zeros((L, cfg.W_IN), dtype=np.uint8)
    tabs = np.zeros((8, L, K), dtype=np.int32)
    (in_start, in_end, out_start, out_end, reset, lcs, lps, pbs) = tabs
    valid = np.zeros((L, K), dtype=np.int32)
    win_init = None  # only when a lane's segment holds a stored chunk
    overlaps = _prefill_test(prefill)
    prefilled = np.zeros(L, dtype=bool)
    seg_lens = np.zeros(L, dtype=np.int64)
    for i, lane in enumerate(lanes):
        seg_len = lane.out_end[-1] - lane.seg_base
        seg_lens[i] = seg_len
        if overlaps(lane, seg_len):
            prefilled[i] = True
            if win_init is None:
                win_init = np.zeros((L, cfg.W), dtype=np.uint8)
            win_init[i, :seg_len] = out[lane.seg_base:lane.seg_base + seg_len]
        cum = 0
        for j, (s, e) in enumerate(zip(lane.in_start, lane.in_end)):
            inbuf[i, cum:cum + e - s] = src[s:e]
            in_start[i, j] = cum
            cum += e - s
            in_end[i, j] = cum
            out_start[i, j] = lane.out_start[j] - lane.seg_base
            out_end[i, j] = lane.out_end[j] - lane.seg_base
            reset[i, j] = lane.reset_state[j]
            lcs[i, j], lps[i, j], pbs[i, j] = lane.lc[j], lane.lp[j], lane.pb[j]
        valid[i, : len(lane.in_start)] = 1
    meta = pack_chunk_meta(reset, lcs, lps, pbs, valid)
    return StagedLanes(cfg, lanes, seg_lens, out, inbuf, win_init,
                       (in_start, in_end, out_start, out_end, meta),
                       prefilled)


def _n_local_devices(device=None) -> int:
    """Devices the decode runtime may spread slabs over: the CUDA cards
    from ``device``'s on (``torch.cuda.device_count()`` less the cards
    before it), capped by ``LZMA_RS_TPU_DEVICES``. Under an explicit CPU
    ``device`` the variable alone sets the count (default 1): the CPU
    slabs stand in for cards, as the reference's tests' XLA host devices
    do (``lzma_rs_tpu/parallel/runtime.py:650``)."""
    cap = os.environ.get("LZMA_RS_TPU_DEVICES")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return max(1, int(cap)) if cap else 1
    n = 1
    if torch.cuda.is_available():
        n = torch.cuda.device_count() - mesh.first_card(device)
    if cap:
        n = min(n, max(1, int(cap)))
    return max(1, n)


def slab_lanes(n_lanes: int, n_dev: int) -> int:
    """Lanes a slab: one slab a device (``ceil(n_lanes / n_dev)``), so one
    launch of every lane where there is one device; or
    ``LZMA_RS_TPU_VMEM_L`` where set.

    The reference sizes its slab by window bucket (256 / 128 / 32 lanes,
    ``lzma_rs_tpu/parallel/runtime.py:489``) to fit the TPU's scoped VMEM,
    and ``LZMA_RS_TPU_VMEM_L`` overrides that (``:494-496``). A card keeps
    each lane's window and tables in device memory and has no such budget,
    so the port splits the lanes evenly over the devices it has. The
    variable stays for launches of a fixed lane count: the dry run's
    shape classes (``graft_entry.py``) and ``chip_smoke.py``'s slab
    timing set it."""
    env = os.environ.get("LZMA_RS_TPU_VMEM_L")
    if env:
        return max(1, int(env))
    return max(1, -(-n_lanes // max(1, n_dev)))


def slab_launches(n_lanes: int, lanes: int, n_dev: int) -> List[list]:
    """The launches of ``n_lanes`` sorted lanes in slabs of ``lanes`` over
    ``n_dev`` devices, as at ``lzma_rs_tpu/parallel/runtime.py:926-931``:
    each launch takes ``lanes * n_dev`` lanes, slab ``j`` of a launch
    (lanes ``a:b`` of the sorted list) goes to device ``j``; the last
    launch may hold fewer slabs, and its last slab fewer lanes."""
    step = lanes * n_dev
    return [
        [(a, min(a + lanes, n_lanes))
         for a in range(base, min(base + step, n_lanes), lanes)]
        for base in range(0, n_lanes, step)
    ]


_stage_hook = None


@contextlib.contextmanager
def stage(name: str):
    """One named stage of the main path: a ``torch.profiler`` span, so that
    a timeline names the host work in each device gap, and, while a
    measurement has set a hook (:func:`stage_hook`), a call of it at the
    stage's start and end (``hook(name, True)``, ``hook(name, False)``)."""
    hook = _stage_hook
    if hook is not None:
        hook(name, True)
    with torch.profiler.record_function(name):
        yield
    if hook is not None:
        hook(name, False)


@contextlib.contextmanager
def stage_hook(hook):
    """Call ``hook`` at every :func:`stage`'s start and end, in any thread,
    while the ``with`` lasts: the stage breakdown
    (``tools/probe_vmem2_time.py``) times the main path's own stages so."""
    global _stage_hook
    old, _stage_hook = _stage_hook, hook
    try:
        yield
    finally:
        _stage_hook = old


def slab_devices(n_lanes: int, device: torch.device,
                 max_devices: Optional[int] = None) -> tuple:
    """``(lanes a slab, devices)`` for ``n_lanes`` sorted lanes: one slab a
    device (:func:`slab_lanes`) over the devices from ``device``'s on
    (:func:`_n_local_devices`, at most one device a slab, and at most
    ``max_devices``), so one launch of every lane on a one-card host."""
    have = _n_local_devices(device)
    if max_devices is not None:
        have = min(have, max(1, max_devices))
    per_slab = slab_lanes(n_lanes, have)
    n_dev = min(have, -(-n_lanes // per_slab))
    return per_slab, [device] if n_dev == 1 else mesh.devices(n_dev, device)


def copy_back(outs: tuple, cols: int) -> list:
    """Start the copy of one launch's results to the host: the window's
    first ``cols`` columns (the slab's longest segment) and the per-lane
    ``err``, ``outp`` and ``steps``. The copies do not wait for the
    device; synchronize before reading them."""
    win, err, outp, steps = outs
    return [t.to("cpu", non_blocking=True)
            for t in (win[:, :cols], err, outp, steps)]


def run_slabs(staged: StagedLanes, per_slab: int, devices: list) -> list:
    """The slab stage of :func:`execute_plan_device`: every slab of
    ``staged`` put on its device, decoded by ``decode_segments`` and its
    results copied back (:func:`copy_back`), every slab launched before
    any result is read, then every card synchronized. Returns one list a
    launch of ``(a, b, host results)`` in lane order."""
    with stage("slabs"):
        launches = []
        for slabs in slab_launches(len(staged.lanes), per_slab, len(devices)):
            launches.append([])
            for (a, b), dev in zip(slabs, devices):
                with stage("h2d"):
                    inputs = staged.tensors(dev, a, b)
                with stage("decode_segments"):
                    outs = sd.decode_segments(
                        *inputs, config=staged.slab_config(a, b))
                with stage("d2h"):
                    host = copy_back(outs, int(staged.seg_lens[a:b].max()))
                launches[-1].append((a, b, host))
        for dev in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)
    return launches


def place_results(staged: StagedLanes, launches: list) -> bytes:
    """The placement stage of :func:`execute_plan_device`: each lane's
    decoded bytes into the output at its segment's offset. Raises
    ``_KernelError`` (with the lane's index in the whole sorted list) at
    the first lane in lane order that flagged an error or stopped short."""
    lanes, seg_lens, out = staged.lanes, staged.seg_lens, staged.out
    with stage("placement"):
        for a, b, host in (slab for r in launches for slab in r):
            win_h, err_h, outp_h, _ = (t.numpy() for t in host)
            bad = np.nonzero((err_h != 0) | (outp_h != seg_lens[a:b]))[0]
            if bad.size:
                i = int(bad[0])
                # a lane that stopped short without a code counts as
                # corrupt (1)
                raise _KernelError(a + i, int(err_h[i]) or 1)
            for i in range(b - a):
                lane, n = lanes[a + i], int(seg_lens[a + i])
                out[lane.seg_base:lane.seg_base + n] = win_h[i, :n]
        return out.tobytes()


def execute_plan_device(
    data: bytes, plans: List[DecodePlan], device: torch.device,
    max_devices: Optional[int] = None,
) -> bytes:
    """Decode the plans' lanes with ``decode_segments``; returns the
    concatenated output. Three stages, each a function of its own that the
    measurement tools time: :func:`stage_plans`; :func:`run_slabs`, the
    lanes, biggest first, in slabs of :func:`slab_lanes` lanes, one slab a
    device, over ``n_dev`` devices a launch (:func:`slab_devices`: by
    default one slab a card, so one launch of every lane on a one-card
    host; the slabs go to ``n_dev`` cards from ``device``'s on, or to
    ``n_dev`` CPU slabs under a CPU ``device``); and
    :func:`place_results`. ``max_devices`` caps the devices (the
    multi-process path holds each rank to its own card with 1). Raises
    :class:`VmemIneligible` when a lane does not fit the bucket rules and
    ``_KernelError`` (with the lane's index in the whole sorted list) when
    a lane fails; the caller replays on the host."""
    device = torch.device(device)
    with stage("stage_plans"):
        staged = stage_plans(data, plans)
    lanes = staged.lanes
    st = stats_mod.current()
    if st is not None:
        st.engine = device.type
        st.lanes += len(lanes)
        st.chunks += sum(len(lane.in_start) for lane in lanes)
        st.prefill_bytes += sum(n for p in plans for _, _, n in p.prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += len(staged.out)
        st.devices = max(st.devices, 1)
    if not lanes:
        return staged.out.tobytes()

    per_slab, devs = slab_devices(len(lanes), device, max_devices)
    if st is not None:
        st.devices = max(st.devices, len(devs))
    with stats_mod.launch_timer(st):
        launches = run_slabs(staged, per_slab, devs)
    if st is not None:  # a launch lasts as long as its longest lane
        st.kernel_iters += sum(max(int(host[3].max()) for _, _, host in r)
                               for r in launches)
    return place_results(staged, launches)


# -- the auto router's cost model
#
# The copy of lzma_rs_tpu/parallel/runtime.py:1081-1104 with three edits:
# the defaults are the port's, its file is ~/.cache/lzma_rs_tpu_torch/, so
# that constants of one package never reach the other's router, and a sixth
# constant prices the native engine's work a lane beyond its bytes. Every
# default was measured by ``python -m lzma_rs_tpu_torch.tools.calibrate``
# on one "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi
# --query-gpu=name,power.limit; 132 SMs, 1,980 MHz max SM clock, 8 host
# cores), 16 MB of the interpreter's stdlib sources.

_CAL_KEYS = (
    # (key, env var, default measured on the H100 above)
    # the native engine, 16 blocks of 1 MiB: 52.34 ms
    ("native_mbs", "LZMA_RS_TPU_CAL_NATIVE_MBS", 305.666),
    # the device path's host side: 1,954 lanes x (W_IN + 2 W) over the
    # 42.47 ms of stage_plans, h2d, d2h and placement on the tpu_profile
    # archive (the lower of it and the stock archive's 2,051.75 MB/s)
    ("link_mbs", "LZMA_RS_TPU_CAL_LINK_MBS", 942.246),
    # us a step = step_a + step_b x resident lanes an SM: the slope of the
    # tpu_profile prefixes (163.9-197.6 cycles a step at 1-15 lanes an
    # SM), the intercept of the stock archive's (135.1, 137.4 at 1, 2)
    ("step_a", "LZMA_RS_TPU_CAL_STEP_A", 0.0669242),
    ("step_b", "LZMA_RS_TPU_CAL_STEP_B", 0.00125614),
    # the stock archive's longest lane: 246,299 steps for 65,536 B
    ("steps_per_byte", "LZMA_RS_TPU_CAL_STEPS_PER_B", 3.75822),
    # the native engine a lane beyond its bytes at native_mbs and beyond
    # the block checks that the card's path runs too, on the tpu_profile
    # archive's 1,954 lanes of 8 KiB: 249.84 ms of the engine, less 84.28
    # ms of checks and 59.62 ms of bytes at that run's native_mbs (268.35)
    ("native_lane_us", "LZMA_RS_TPU_CAL_NATIVE_LANE_US", 54.213),
)


def calibration_path() -> str:
    """Measured-calibration file location (host-specific cache;
    LZMA_RS_TPU_CAL_FILE overrides)."""
    import os

    return os.environ.get(
        "LZMA_RS_TPU_CAL_FILE",
        os.path.join(
            os.path.expanduser("~"), ".cache", "lzma_rs_tpu_torch",
            "calibration.json",
        ),
    )


# -- copied from lzma_rs_tpu/parallel/runtime.py:1107-1152

def write_calibration(**vals) -> str:
    """Merge measured constants into the calibration file (bench.py and
    tools/calibrate.py call this so the auto-router's model reflects
    THIS host, not the v5e defaults)."""
    import json
    import os

    path = calibration_path()
    data = {}
    try:
        with open(path) as f:
            data = json.load(f)
    except Exception:
        pass
    data.update({k: float(v) for k, v in vals.items() if v is not None})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, path)
    return path


def _auto_calibration() -> dict:
    """Auto-router model constants. Precedence per key: env var >
    measured calibration file (``calibration_path()``) > built-in v5e
    default — so a bench/calibrate run fixes the model for this host
    while explicit env pins still win."""
    import json
    import os

    file_vals = {}
    try:
        with open(calibration_path()) as f:
            file_vals = json.load(f)
    except Exception:
        pass
    out = {}
    for key, env, default in _CAL_KEYS:
        if env in os.environ:
            out[key] = float(os.environ[env])
        elif key in file_vals:
            out[key] = float(file_vals[key])
        else:
            out[key] = default
    return out


# the SMs the model prices an explicit CPU device at: one H100 SXM's
CPU_SMS = 132


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (a CUDA card, or
    :data:`CPU_SMS` for a CPU device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _estimate_engine_seconds(
    plans: List[DecodePlan], cfg, n_devices: int, sms: int
) -> Tuple[float, float]:
    """(device_seconds, native_seconds) modeled from the plan: the JAX
    model (``lzma_rs_tpu/parallel/runtime.py:1155-1193``) for the Hopper
    kernel.

    Device = kernel time + the device path's host-side work. The kernel
    runs a lane a block, and shared memory leaves ``sd.lanes_per_sm(cfg)``
    of them resident on an SM, so a card decodes the lanes, sorted as the
    JAX model and the executor sort them (biggest first), in waves of
    ``sms * lanes_per_sm`` lanes; a wave lasts as long as its longest
    lane: its output bytes x ``steps_per_byte`` x the microseconds a step,
    ``step_a + step_b * r``, where ``r`` is the wave's resident lanes an
    SM, ``min(lanes_per_sm, ceil(wave lanes / sms))``. Kernel time divides
    over ``n_devices``, as in the JAX model. The rest is priced per lane at
    the bytes the JAX model counts, ``W_IN + 2 * W``, over ``link_mbs``:
    a rate fitted over the device path's staging, copies and placement
    (``tools/calibrate.py``), so far below the link's own. Native =
    ``total_out / native_mbs`` plus ``native_lane_us`` a lane: the JAX
    model's flat rate alone prices a thousand 8 KiB lanes several times
    too fast, since each lane is a call of its own on the host's pool."""
    cal = _auto_calibration()
    lanes = sorted((lane for p in plans for lane in p.lanes), key=_packed,
                   reverse=True)
    total_out = sum(p.total_out for p in plans)
    per_sm = sd.lanes_per_sm(cfg)
    wave = sms * per_sm
    kernel_us = 0.0
    for i in range(0, len(lanes), wave):
        batch = lanes[i:i + wave]
        resident = min(per_sm, -(-len(batch) // sms))
        us_per_step = cal["step_a"] + cal["step_b"] * resident
        max_out = max(lane.out_end[-1] - lane.seg_base for lane in batch)
        kernel_us += max_out * cal["steps_per_byte"] * us_per_step
    transfer_bytes = len(lanes) * (cfg.W_IN + 2 * cfg.W)
    device_s = (
        kernel_us * 1e-6 / max(1, n_devices)
        + transfer_bytes / (cal["link_mbs"] * 1e6)
    )
    native_s = (total_out / (cal["native_mbs"] * 1e6)
                + len(lanes) * cal["native_lane_us"] * 1e-6)
    return device_s, native_s


def _resolve_auto(plans: List[DecodePlan], device) -> str:
    """``auto``: the JAX router (``_resolve_auto_engine``,
    ``lzma_rs_tpu/parallel/runtime.py:1196-1244``) on the card. In order:

    1. the small-workload gate (``LZMA_RS_TPU_AUTO_MIN_LANES``, default 64
       lanes, and ``LZMA_RS_TPU_AUTO_MIN_OUT``, default 1 MiB out), else
       ``native`` with the reason recorded;
    2. the eligibility gate, else ``native`` with its reason;
    3. a device: without a CUDA device and without ``device``, ``native``
       with no record (the JAX router records none without a TPU); for a
       card, the kernel library must build or load, else ``native`` with
       the reason;
    4. the cost model (:func:`_estimate_engine_seconds`, ``sm_count``
       SMs): ``cuda`` only on a clear modeled win, ``device_s < native_s *
       0.9`` (the JAX router's 10% headroom, ``:1235-1238``), else
       ``native`` with the two modeled times recorded in the JAX
       router's words (``:1240-1243``).

    Nothing is staged before the verdict."""
    lanes = [lane for p in plans for lane in p.lanes]
    min_lanes = int(os.environ.get("LZMA_RS_TPU_AUTO_MIN_LANES", "64"))
    min_out = int(os.environ.get("LZMA_RS_TPU_AUTO_MIN_OUT", str(1 << 20)))
    total_out = sum(p.total_out for p in plans)
    if len(lanes) < min_lanes or total_out < min_out:
        _record_fallback(
            f"auto->native: small workload ({len(lanes)} lanes, "
            f"{total_out} B out)"
        )
        return "native"
    cfg = choose_config(plans)
    try:
        check_vmem_eligibility(lanes, cfg)
    except VmemIneligible as e:
        _record_fallback(f"auto->native: {e.reason}")
        return "native"
    if device is None and not torch.cuda.is_available():
        return "native"  # no record, as the JAX router without a TPU
    if device is None or torch.device(device).type == "cuda":
        why = build.unavailable()
        if why is not None:
            _record_fallback(f"auto->native: CUDA kernel unavailable: {why}")
            return "native"
    device = cuda_device(device)
    device_s, native_s = _estimate_engine_seconds(
        plans, cfg, _n_local_devices(device), sm_count(device))
    if device_s < native_s * 0.9:
        return "cuda"
    _record_fallback(
        f"auto->native: modeled device {device_s * 1e3:.1f} ms "
        f"vs native {native_s * 1e3:.1f} ms"
    )
    return "native"


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: expected one of {ENGINES}")


def lzma2_decode(data: bytes, engine: str = "auto", device=None) -> bytes:
    """Parallel LZMA2 decode of a full chunk stream."""
    _check_engine(engine)
    if engine == "cuda":
        device = cuda_device(device)
    data = bytes(data)
    try:
        plan, _ = plan_lzma2_stream(data, 0, 0)
    except UnparallelizableStream:
        _record_fallback("host: stream carries prob state across dict reset")
        return _host_lzma2(data)
    if plan.pending_error is not None:
        # a chunk-header error behind decodable chunks: only the sequential
        # host loop reproduces the reference's error ordering
        _record_fallback("host replay: chunk-header error after prefix")
        return _host_lzma2(data)
    if engine == "auto":
        engine = _resolve_auto([plan], device)
    if engine == "native":
        try:
            return execute_plan_native(data, [plan])
        except Exception:
            # exact reference-parity error (or output) via sequential host
            return _host_lzma2(data)
    try:
        return execute_plan_device(data, [plan], cuda_device(device))
    except VmemIneligible as e:
        _record_fallback(f"vmem-ineligible: {e.reason}")
        try:
            return execute_plan_native(data, [plan])
        except Exception:
            return _host_lzma2(data)
    except _KernelError as e:
        _record_fallback(f"host replay: lane error code {e.code}")
        return _host_lzma2(data)


def lzma_raw_decode_device(data: bytes, payload_off: int, params,
                           device=None) -> bytes:
    """Raw LZMA on the device path (one lane, one chunk). Needs a known
    unpacked size; a stream whose dictionary is smaller than its output
    keeps the reference's distance-cap semantics on the host, and one the
    bucket rules refuse (lc+lp beyond the literal tables) decodes there
    too."""
    device = cuda_device(device)
    p = params.properties
    if params.unpacked_size is None:
        raise ValueError("the device path needs a known unpacked size")
    total_out = int(params.unpacked_size)
    lane = LanePlan(
        in_start=[payload_off], in_end=[len(data)], out_start=[0],
        out_end=[total_out], reset_state=[1], lc=[p.lc], lp=[p.lp],
        pb=[p.pb], seg_base=0, size_known=1,
        dict_size=min(params.dict_size, 0xFFFFFFFF),
    )
    plan = DecodePlan(lanes=[lane], prefill=[], total_out=total_out)

    def host_replay() -> bytes:
        from lzma_rs_tpu_torch.models.codecs import LzmaDecoder
        from lzma_rs_tpu_torch.native import loader

        lib = loader.load()
        if lib is not None:
            res = lib.lzma_decode(data, payload_off, params, None)
            if res is not None:
                return res
        return LzmaDecoder(params, None).decompress(
            ByteCursor(data, payload_off)
        )

    if params.dict_size < total_out:
        _record_fallback(
            "raw-lzma vmem-ineligible: dict_size < unpacked size "
            "(distance-cap semantics)"
        )
        return host_replay()
    try:
        return execute_plan_device(data, [plan], device)
    except VmemIneligible as e:
        _record_fallback(f"raw-lzma vmem-ineligible: {e.reason}")
        return host_replay()
    except _KernelError as e:
        _record_fallback(f"host replay: lane error code {e.code}")
        return host_replay()


def xz_decode(data: bytes, engine: str = "auto", device=None) -> bytes:
    """Parallel `.xz` decode: every block's segments in one launch."""
    _check_engine(engine)
    if engine == "cuda":
        device = cuda_device(device)
    data = bytes(data)
    try:
        with stage("xz_decode"):
            return _xz_decode_parallel(data, engine, device)
    except UnparallelizableStream:
        _record_fallback("host: stream carries prob state across dict reset")
        return _sequential_xz_replay(data)


def check_blocks(data: bytes, out: bytes, block_spans, header_flags) -> None:
    """The block checks of a decoded archive, on the host: each block's
    stored check against its bytes of ``out``, hashed on a small thread
    pool, one task a block; the first error in stream order wins."""
    outv = memoryview(out)

    def check_one(span):
        _, check_off, out0, outn = span
        xz_fmt.validate_block_check(
            ByteCursor(data, check_off), outv[out0:out0 + outn],
            header_flags.check_method,
        )

    with stage("check_blocks"):
        if len(block_spans) > 1:
            with ThreadPoolExecutor(
                    max_workers=min(8, os.cpu_count() or 1)) as pool:
                for f in [pool.submit(check_one, s) for s in block_spans]:
                    f.result()  # stream order: the first error wins
        else:
            for span in block_spans:
                check_one(span)


def _xz_decode_parallel(data: bytes, engine: str, device) -> bytes:
    try:
        with stage("plan_xz"):
            (plans, block_spans, header_flags, records, cursor,
             deferred) = plan_xz(data, stop_on_error=True)
            if deferred is None:
                index_size = xz_fmt.check_index(cursor, records)
        if deferred is not None:
            # malformed archive with a decodable prefix: decode and check
            # the prefix in parallel, then raise the deferred error
            return _bounded_error_replay(
                data, plans, block_spans, header_flags, deferred
            )
    except (LzmaError, XzError, IoError):
        _record_fallback("host replay: container error during planning")
        return _sequential_xz_replay(data)

    if engine == "auto":
        engine = _resolve_auto(plans, device)
    if engine == "cuda":
        try:
            out = execute_plan_device(data, plans, cuda_device(device))
        except VmemIneligible as e:
            _record_fallback(f"vmem-ineligible: {e.reason}")
            engine = "native"
        except _KernelError as e:
            _record_fallback(f"host replay: lane error code {e.code}")
            return _sequential_xz_replay(data)
    if engine == "native":
        # decode and check block by block on the host thread pool
        try:
            out = _execute_native_blockwise(
                data, plans, block_spans, header_flags
            )
        except Exception:
            return _sequential_xz_replay(data)
        xz_fmt.check_footer(cursor, header_flags, index_size)
        return out

    check_blocks(data, out, block_spans, header_flags)
    with stage("check_footer"):
        xz_fmt.check_footer(cursor, header_flags, index_size)
    return out
