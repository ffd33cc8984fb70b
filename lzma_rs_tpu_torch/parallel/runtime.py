"""Parallel decode runtime of the port: segments -> lanes -> the CUDA kernel.

The host side is the JAX package's, imported as it is
(``lzma_rs_tpu/parallel/runtime.py``, whose top level imports no JAX): the
container walk and chunk scan (``plan_xz``, ``plan_lzma2_stream``), the
eligibility gate, the native host engines, the host replays that give the
reference's exact errors, and the host block checks. What this module adds
is the device path: :func:`choose_config` picks the shape bucket with the
JAX package's rules, and :func:`execute_plan_device` stages every lane of the
plans into one batch on a torch device and runs
``ops/segment_decoder.decode_segments`` on it.

Engines: ``cuda`` (the kernel on ``device``, by default the current CUDA
device; it raises when there is none or the kernel does not build),
``native`` (the host thread pool) and ``auto`` (``cuda`` when the workload
is large enough, the plans pass the eligibility gate, a CUDA device is
present and the kernel builds; ``native`` otherwise, with the reason in
``stats.fallbacks``). An explicit CPU ``device`` runs the same path through
the kernel's plain PyTorch version; the tests use it.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from lzma_rs_tpu.formats import xz as xz_fmt
from lzma_rs_tpu.parallel.runtime import (  # the shared, JAX-free host side
    DecodePlan,
    LanePlan,
    UnparallelizableStream,
    VmemIneligible,
    _KernelError,
    _bounded_error_replay,
    _execute_native_blockwise,
    _host_lzma2,
    _record_fallback,
    _sequential_xz_replay,
    check_vmem_eligibility,
    execute_plan_native,
    plan_lzma2_stream,
    plan_xz,
)
from lzma_rs_tpu.utils import stats as stats_mod
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import IoError, LzmaError, XzError
from lzma_rs_tpu_torch.ops import build
from lzma_rs_tpu_torch.ops import segment_decoder as sd
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig, pack_chunk_meta

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
    lane, so ``L`` is the lane count."""
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

    def tensors(self, device) -> tuple:
        """The seven ``decode_segments`` inputs on ``device`` (a window of
        zeros is made there when no lane holds a stored chunk)."""
        cfg = self.config
        win = (
            torch.zeros((cfg.L, cfg.W), dtype=torch.uint8, device=device)
            if self.win_init is None
            else torch.from_numpy(self.win_init).to(device)
        )
        return (torch.from_numpy(self.inbuf).to(device), win) + tuple(
            torch.from_numpy(t).to(device) for t in self.tables
        )


def stage_plans(data: bytes, plans: List[DecodePlan]) -> StagedLanes:
    """Place the stored chunks and stage every lane of ``plans`` into one
    batch. Raises :class:`VmemIneligible` when a lane does not fit the
    bucket rules."""
    cfg = choose_config(plans)
    lanes = [lane for p in plans for lane in p.lanes]
    prefill = [f for p in plans for f in p.prefill]
    check_vmem_eligibility(lanes, cfg)
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
    prefilled = _prefill_test(prefill)
    seg_lens = np.zeros(L, dtype=np.int64)
    for i, lane in enumerate(lanes):
        seg_len = lane.out_end[-1] - lane.seg_base
        seg_lens[i] = seg_len
        if prefilled(lane, seg_len):
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
                       (in_start, in_end, out_start, out_end, meta))


def execute_plan_device(
    data: bytes, plans: List[DecodePlan], device: torch.device
) -> bytes:
    """Decode the plans' lanes in one ``decode_segments`` call on
    ``device``; returns the concatenated output. Raises
    :class:`VmemIneligible` when a lane does not fit the bucket rules and
    ``_KernelError`` when a lane fails (the caller replays on the host)."""
    device = torch.device(device)
    staged = stage_plans(data, plans)
    lanes, seg_lens, out = staged.lanes, staged.seg_lens, staged.out
    st = stats_mod.current()
    if st is not None:
        st.engine = device.type
        st.lanes += len(lanes)
        st.chunks += sum(len(lane.in_start) for lane in lanes)
        st.prefill_bytes += sum(n for p in plans for _, _, n in p.prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += len(out)
        st.devices = max(st.devices, 1)
    if not lanes:
        return out.tobytes()

    with stats_mod.launch_timer(st):
        win, err, outp, steps = sd.decode_segments(
            *staged.tensors(device), config=staged.config
        )
        # copy back the used columns and the per-lane results only
        cols = int(seg_lens.max())
        host = [t.to("cpu", non_blocking=True)
                for t in (win[:, :cols], err, outp, steps)]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        win_h, err_h, outp_h, steps_h = (t.numpy() for t in host)
    if st is not None:
        st.kernel_iters += int(steps_h.max())

    bad = np.nonzero((err_h != 0) | (outp_h != seg_lens))[0]
    if bad.size:
        i = int(bad[0])
        # a lane that stopped short without a code counts as corrupt (1)
        raise _KernelError(i, int(err_h[i]) or 1)
    for i, lane in enumerate(lanes):
        n = int(seg_lens[i])
        out[lane.seg_base:lane.seg_base + n] = win_h[i, :n]
    return out.tobytes()


def _resolve_auto(plans: List[DecodePlan], device) -> str:
    """``auto``: ``cuda`` when the workload passes the JAX package's
    small-workload gate (``LZMA_RS_TPU_AUTO_MIN_LANES``, default 64 lanes,
    and ``LZMA_RS_TPU_AUTO_MIN_OUT``, default 1 MiB out) and the
    eligibility gate, a CUDA device is present (or ``device`` is given)
    and the kernel library builds or loads; else ``native`` with the
    reason recorded. Nothing is staged before the verdict."""
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
    try:
        check_vmem_eligibility(lanes, choose_config(plans))
    except VmemIneligible as e:
        _record_fallback(f"auto->native: {e.reason}")
        return "native"
    if device is None and not torch.cuda.is_available():
        _record_fallback("auto->native: no CUDA device")
        return "native"
    if device is None or torch.device(device).type == "cuda":
        why = build.unavailable()
        if why is not None:
            _record_fallback(f"auto->native: CUDA kernel unavailable: {why}")
            return "native"
    return "cuda"


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
        from lzma_rs_tpu.models.codecs import LzmaDecoder
        from lzma_rs_tpu.native import loader

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
        return _xz_decode_parallel(data, engine, device)
    except UnparallelizableStream:
        _record_fallback("host: stream carries prob state across dict reset")
        return _sequential_xz_replay(data)


def _xz_decode_parallel(data: bytes, engine: str, device) -> bytes:
    try:
        (plans, block_spans, header_flags, records, cursor,
         deferred) = plan_xz(data, stop_on_error=True)
        if deferred is not None:
            # malformed archive with a decodable prefix: decode and check
            # the prefix in parallel, then raise the deferred error
            return _bounded_error_replay(
                data, plans, block_spans, header_flags, deferred
            )
        index_size = xz_fmt.check_index(cursor, records)
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

    # block checks on the host, hashed on a small pool, errors in order
    outv = memoryview(out)

    def check_one(span):
        _, check_off, out0, outn = span
        xz_fmt.validate_block_check(
            ByteCursor(data, check_off), outv[out0:out0 + outn],
            header_flags.check_method,
        )

    if len(block_spans) > 1:
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            for f in [pool.submit(check_one, s) for s in block_spans]:
                f.result()  # stream order: the first error wins
    else:
        for span in block_spans:
            check_one(span)
    xz_fmt.check_footer(cursor, header_flags, index_size)
    return out
