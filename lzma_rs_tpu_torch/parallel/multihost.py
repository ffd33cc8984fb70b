"""Multi-process block-parallel `.xz` decode over ``torch.distributed``.

The port of ``lzma_rs_tpu/parallel/multihost.py``: :class:`BlockSpan`,
:func:`scan_blocks`, :func:`assign_blocks`, :data:`WAVE_BYTES`,
:func:`plan_waves` and :func:`stitch_waves` are copies (only the imports
differ); :func:`xz_decode_multihost` is written for PyTorch. `.xz` blocks
decode independently (each carries its own filter chain, window and
check, and the index records each block's sizes), so

1. every process walks the container and derives the same block table and
   absolute output offsets, with no communication;
2. blocks are assigned greedily by packed size (static, deterministic);
3. each process decodes its blocks in waves: a wave's blocks in one launch
   of the segment kernel on the process's own card (``engine="cuda"``) or
   of the lane engine (``engine="cuda-lane"``), or on the native host
   engine;
4. each wave's output is exchanged with one ``all_gather``, issued
   asynchronously, so that wave w's gather overlaps wave w+1's decode, and
   stitched by the precomputed offsets; every process then verifies the
   block checks, the index and the footer.

The caller creates the process group (``torch.distributed.
init_process_group``, with a ``timeout``) and, on a card, selects the
rank's own device (``torch.cuda.set_device``) before calling
:func:`xz_decode_multihost`; without a group the call is the
single-process decode. The gather's buffers follow the group's backend:
CPU tensors under gloo, the rank's card under NCCL. NCCL refuses two ranks
on one card, so ranks that share a card (a one-card host) run gloo, every
rank on ``cuda:0``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from lzma_rs_tpu_torch.formats import xz as xz_fmt
from lzma_rs_tpu_torch.utils.cursor import ByteCursor


@dataclasses.dataclass(frozen=True)
class BlockSpan:
    header_off: int
    payload_start: int
    payload_len: int
    check_off: int
    out_base: int
    out_len: int


def scan_blocks(data: bytes) -> Tuple[xz_fmt.StreamFlags, List[BlockSpan], int]:
    """Walk the container once; every host derives the identical table."""
    from lzma_rs_tpu_torch.parallel import runtime as rt

    cursor = ByteCursor(data)
    flags = xz_fmt.parse_stream_header(cursor)
    spans: List[BlockSpan] = []
    out_base = 0
    while True:
        header_off = cursor.pos
        info = xz_fmt.read_block_header_at(cursor)
        if info is None:
            break
        payload_start = cursor.pos
        plan, consumed = rt.plan_lzma2_stream(data, payload_start, 0)
        if plan.pending_error is not None:
            # A chunk-header error behind decodable chunks: only a
            # sequential decode reproduces the reference's error
            # ordering (the prefix's own decode errors come first) —
            # same rule as runtime.plan_xz / lzma2_decode.
            raise rt.UnparallelizableStream()
        cursor.pos = payload_start + consumed
        pad = xz_fmt.padding_size(cursor.pos - header_off)
        cursor.skip(pad)
        check_off = cursor.pos
        cursor.skip(xz_fmt.check_size(flags.check_method))
        spans.append(
            BlockSpan(
                header_off=header_off,
                payload_start=payload_start,
                payload_len=consumed,
                check_off=check_off,
                out_base=out_base,
                out_len=plan.total_out,
            )
        )
        out_base += plan.total_out
    return flags, spans, out_base


def assign_blocks(spans: List[BlockSpan], n_hosts: int) -> List[int]:
    """Greedy size-balanced, deterministic owner per block."""
    loads = [0] * n_hosts
    owner = []
    for s in spans:
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        owner.append(h)
        loads[h] += s.payload_len
    return owner


#: Target decoded bytes per gather wave: small enough that the first
#: gather starts early (communication overlaps later waves' decode),
#: large enough that per-collective latency amortizes. Tunable via
#: LZMA_RS_TPU_WAVE_BYTES for slice-specific DCN characteristics.
import os as _os

WAVE_BYTES = int(_os.environ.get("LZMA_RS_TPU_WAVE_BYTES", 8 << 20))


def plan_waves(
    spans: List[BlockSpan], owner: List[int], n_hosts: int,
    wave_bytes: int = WAVE_BYTES,
) -> Tuple[List[List[List[BlockSpan]]], List[int]]:
    """Deterministic wave schedule, identical on every host.

    Returns ``(host_waves, wave_sizes)``: ``host_waves[h][w]`` is host
    h's block list for wave w (contiguous in stream order), and
    ``wave_sizes[w]`` the padded per-host buffer size of wave w's
    all-gather (max over hosts). Collectives must execute in the same
    order with the same shapes on every process, so the schedule is a
    pure function of the shared block table."""
    per_host = [
        [s for s, o in zip(spans, owner) if o == h] for h in range(n_hosts)
    ]
    max_owned = max(
        (sum(s.out_len for s in hs) for hs in per_host), default=0
    )
    n_waves = max(1, -(-max_owned // wave_bytes))
    host_waves: List[List[List[BlockSpan]]] = []
    for hs in per_host:
        total = sum(s.out_len for s in hs)
        groups: List[List[BlockSpan]] = [[] for _ in range(n_waves)]
        acc = 0
        for s in hs:
            w = min(n_waves - 1, acc * n_waves // max(total, 1))
            groups[w].append(s)
            acc += s.out_len
        host_waves.append(groups)
    wave_sizes = [
        max(
            (sum(s.out_len for s in host_waves[h][w]) for h in range(n_hosts)),
            default=0,
        )
        for w in range(n_waves)
    ]
    return host_waves, wave_sizes


def stitch_waves(
    host_waves: List[List[List[BlockSpan]]],
    gathered_waves: List[np.ndarray],
    n_hosts: int,
    total_out: int,
) -> np.ndarray:
    """Reassemble the ordered stream from per-wave gathered buffers.

    ``gathered_waves[w]`` is the wave-w all-gather result, shape
    ``[n_hosts, wave_sizes[w]]``: each host's dense concatenation of its
    wave-w blocks (padded with zeros to the wave size). Placement is
    known before decode (``BlockSpan.out_base`` comes from the shared
    block table), so stitching is pure bookkeeping — walk each wave's
    spans in stream order, consuming each owner's dense buffer
    sequentially."""
    full = np.zeros(total_out, dtype=np.uint8)
    for w, gathered in enumerate(gathered_waves):
        for h in range(n_hosts):
            c = 0
            for s in host_waves[h][w]:
                full[s.out_base : s.out_base + s.out_len] = gathered[
                    h, c : c + s.out_len
                ]
                c += s.out_len
    return full


def xz_decode_multihost(
    data: bytes, engine: str = "cuda", device=None,
    wave_bytes: int | None = None,
) -> bytes:
    """Decode `.xz` with its blocks shared out over the processes of the
    default ``torch.distributed`` group; every process must call this with
    identical ``data``, and every process returns the whole output.

    ``engine`` is the runtime's: ``cuda`` (the segment kernel on
    ``device``, else on the current card; raises without one),
    ``cuda-lane`` (the lane engine, by the same rule), ``native`` or
    ``auto`` (routed once a wave, the unit a launch decodes; never to
    ``cuda-lane``). A wave's blocks go to one
    :func:`runtime.execute_plan_device` call, held to the rank's own
    device; a wave the kernel cannot take (ineligible, or a lane error)
    decodes on the native engine, which raises the reference's error for a
    corrupt block. Under ``cuda-lane`` a wave is one
    :func:`runtime.execute_plan` launch, and a lane error raises
    ``runtime._KernelError`` on the rank that owns the block, as the JAX
    package's ``tpu-lane`` wave does (``lzma_rs_tpu/parallel/
    multihost.py:236-239``, no ``try``). ``wave_bytes`` (default
    :data:`WAVE_BYTES`) is the decoded bytes a process aims at a wave.
    Without a group (or with one process) this is
    ``runtime.xz_decode(data, engine, device)``.

    A corrupt payload makes the rank that owns its block raise before its
    gather; the other ranks then wait in the collective until the group's
    timeout, as the JAX package's processes do."""
    import os
    import time

    import torch
    import torch.distributed as dist

    from lzma_rs_tpu_torch.parallel import runtime as rt
    from lzma_rs_tpu_torch.utils import stats as stats_mod

    rt._check_engine(engine)
    if engine == "cuda":
        device = rt.cuda_device(device)
    elif engine == "cuda-lane":
        device = rt.lane_device(device)
    data = bytes(data)
    n_hosts, host = 1, 0
    if dist.is_available() and dist.is_initialized():
        n_hosts, host = dist.get_world_size(), dist.get_rank()
    if n_hosts == 1:
        return rt.xz_decode(data, engine=engine, device=device)

    try:
        flags, spans, total_out = scan_blocks(data)
    except rt.UnparallelizableStream:
        # Deterministic on every process (identical data, identical
        # raise), so none reaches a collective: each decodes sequentially
        # and returns the same result or error.
        return rt.xz_decode(data, engine=engine, device=device)
    owner = assign_blocks(spans, n_hosts)
    host_waves, wave_sizes = plan_waves(
        spans, owner, n_hosts,
        WAVE_BYTES if wave_bytes is None else wave_bytes)
    threads = max(1, (os.cpu_count() or 1) // n_hosts)
    if dist.get_backend() == "nccl":
        comm = (device if device is not None
                and torch.device(device).type == "cuda"
                else torch.device("cuda", torch.cuda.current_device()))
    else:
        comm = torch.device("cpu")

    def decode_wave(wave_spans, size):
        local = np.zeros(size, dtype=np.uint8)
        plans, off = [], 0
        for s in wave_spans:
            plan, _ = rt.plan_lzma2_stream(data, s.payload_start, off)
            if plan.pending_error is not None:  # scan_blocks screened it
                raise plan.pending_error
            plans.append(plan)
            off += s.out_len
        if not plans:
            return local
        # routed once a wave, the unit one launch decodes; deterministic
        # per wave, and the collective schedule never depends on it
        eng = rt._resolve_auto(plans, device) if engine == "auto" else engine
        if eng == "cuda":
            try:
                # this rank's device only: its neighbours own the others
                out = rt.execute_plan_device(
                    data, plans, rt.cuda_device(device), max_devices=1)
            except (rt.VmemIneligible, rt._KernelError):
                out = rt.execute_plan_native(data, plans, threads=threads)
        elif eng == "cuda-lane":
            out = rt.execute_plan(data, plans, device)
        else:
            out = rt.execute_plan_native(data, plans, threads=threads)
        local[:off] = np.frombuffer(out, dtype=np.uint8)
        return local

    st = stats_mod.current()
    t_decode = 0.0
    pending = []
    for w, size in enumerate(wave_sizes):
        t0 = time.perf_counter()
        local = decode_wave(host_waves[host][w], size)
        t_decode += time.perf_counter() - t0
        if size == 0:
            # every process knows the wave is empty: nothing to exchange
            pending.append(None)
            continue
        outs = [torch.empty(size, dtype=torch.uint8, device=comm)
                for _ in range(n_hosts)]
        work = dist.all_gather(outs, torch.from_numpy(local).to(comm),
                               async_op=True)
        pending.append((work, outs))
    t0 = time.perf_counter()
    gathered_waves = []
    for p in pending:
        if p is None:
            gathered_waves.append(np.zeros((n_hosts, 0), dtype=np.uint8))
            continue
        work, outs = p
        work.wait()
        gathered_waves.append(torch.stack(outs).cpu().numpy())
    t_gather_wait = time.perf_counter() - t0
    if st is not None:
        st.multihost_decode_seconds += t_decode
        st.multihost_gather_wait_seconds += t_gather_wait
        st.multihost_waves += len(wave_sizes)

    full = stitch_waves(host_waves, gathered_waves, n_hosts, total_out)

    # Every host verifies checks + index + footer on the assembled result.
    for s in spans:
        chk = ByteCursor(data, s.check_off)
        xz_fmt.validate_block_check(
            chk, bytes(full[s.out_base : s.out_base + s.out_len]),
            flags.check_method,
        )
    records = [
        xz_fmt.Record(
            unpadded_size=(
                s.check_off
                + xz_fmt.check_size(flags.check_method)
                - s.header_off
                - xz_fmt.padding_size(s.payload_start + s.payload_len - s.header_off)
            ),
            unpacked_size=s.out_len,
        )
        for s in spans
    ]
    cursor = ByteCursor(data)
    if spans:
        cursor.pos = (
            spans[-1].check_off + xz_fmt.check_size(flags.check_method)
        )
    else:
        xz_fmt.parse_stream_header(cursor)
    index_size = xz_fmt.check_index(cursor, records)
    xz_fmt.check_footer(cursor, flags, index_size)
    return bytes(full)
