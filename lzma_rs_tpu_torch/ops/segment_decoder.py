"""Segment decoder: L independent LZMA2 dict-reset segments to completion.

The port of ``lzma_rs_tpu/ops/vmem2_decoder.py::decode_segments_vmem2``
(gen-2) and, at gen-1's bucket (``W_IN == W``), of
``lzma_rs_tpu/ops/vmem_decoder.py::decode_segments_vmem`` (gen-1): the two
TPU kernels compute one function with one contract and differ only in
Mosaic layout and workarounds, which a kernel of one CUDA warp per lane
has neither of. Gen-1's ring mode (``ERR_RING`` and its full-window retry)
is such a workaround and has no counterpart here.

- :func:`decode_segments` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel (``csrc/decode_segments.cu``: one warp a lane, its
  probability table and window in shared memory) or raises; on a CPU
  tensor it runs :func:`decode_segments_reference`.
  ``decode_segments.launches`` counts kernel launches.
- :func:`smem_bytes` is the shared memory a lane takes on the card,
  :func:`lanes_per_sm` how many lanes that leaves resident on an SM, and
  :func:`check_fits` raises for a bucket that does not fit a block.
- :func:`decode_segments_reference` is the plain PyTorch version: every
  lane advances one micro-op per iteration (one range-coder bit, one
  copied byte or one chunk setup) under masks, the lockstep design of
  ``lzma_rs_tpu/ops/lane_decoder.py``.
- :func:`from_jax_layout` / :func:`to_jax_layout` convert between the JAX
  kernel's ``[words, L]`` int32 layout and the port's lane-major tensors.

Layout (lane-major): staged input ``[L, W_IN]`` u8, window ``[L, W]`` u8
pre-filled with the segment's stored chunks, chunk tables ``[L, K]`` i32
(lane-local offsets; ``chunk_meta`` from ``pack_chunk_meta``). Outputs:
the decoded window ``[L, W]`` u8 and ``err``, ``outp``, ``steps`` ``[L]``
i32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import lzma_consts as C
from lzma_rs_tpu_torch.ops.lzma_consts import SegmentConfig, prob_layout

__all__ = [
    "check_fits",
    "decode_segments",
    "decode_segments_reference",
    "decoder_occupancy",
    "default_max_steps",
    "from_jax_layout",
    "lanes_per_sm",
    "probs_bytes",
    "smem_bytes",
    "to_jax_layout",
]

_U32 = 0xFFFFFFFF

# Hopper's shared memory (sm_90, the CUDA C++ programming guide): a block
# may take 227 KB (above 48 KB only as dynamic shared memory after the
# opt-in), an SM holds 228 KB, of which the runtime reserves 1 KB a
# block, and at most 32 blocks are resident on an SM.
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1_024
MAX_BLOCKS_PER_SM = 32


def probs_bytes(nlit: int) -> int:
    """Bytes of a lane's probability table in shared memory: the u16
    table rounded up to 16, so the window after it is 16-byte aligned
    (``csrc/lzma_lane.cuh::probs_bytes``)."""
    return (2 * prob_layout(nlit).total + 15) & ~15


def smem_bytes(cfg: SegmentConfig) -> int:
    """Dynamic shared memory of one lane (one block) of the kernel: its
    probability table, then its ``W``-byte window."""
    return probs_bytes(cfg.NLIT) + cfg.W


def lanes_per_sm(cfg: SegmentConfig) -> int:
    """Lanes of ``cfg``'s bucket that shared memory leaves resident on one
    SM (a one-warp block uses few registers, so shared memory is the
    limit)."""
    return min(MAX_BLOCKS_PER_SM,
               SMEM_PER_SM // (smem_bytes(cfg) + SMEM_RESERVED_PER_BLOCK))


def check_fits(cfg: SegmentConfig) -> int:
    """``smem_bytes(cfg)``, or ValueError when a lane's table and window
    do not fit one block's shared memory."""
    need = smem_bytes(cfg)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"bucket W={cfg.W} NLIT={cfg.NLIT} needs {need} B of shared "
            f"memory a lane; a block holds {SMEM_PER_BLOCK}"
        )
    return need


def default_max_steps(cfg: SegmentConfig) -> int:
    """Step budget per lane. A symbol emits at least one byte or stops the
    lane, and costs at most 44 micro-ops for 2 bytes (a length-2 match at
    the farthest distance), so no lane, valid or corrupt, exceeds
    ``22 * W + K + 1`` steps: the budget is a guard, never the verdict."""
    return 24 * cfg.W + 2 * cfg.K + 64


def _check_inputs(cfg, inbuf, win_init, tables, max_steps):
    dev = inbuf.device
    want = [
        ("inbuf", inbuf, torch.uint8, (cfg.L, cfg.W_IN)),
        ("win_init", win_init, torch.uint8, (cfg.L, cfg.W)),
    ] + [
        (name, t, torch.int32, (cfg.L, cfg.K))
        for name, t in zip(
            ("in_start", "in_end", "out_start", "out_end", "chunk_meta"),
            tables,
        )
    ]
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, inbuf on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < max_steps < 2**31:
        raise ValueError(f"max_steps={max_steps} outside (0, 2^31)")


def decode_segments(
    inbuf, win_init, in_start, in_end, out_start, out_end, chunk_meta,
    *, config: SegmentConfig, max_steps: int | None = None,
):
    """Decode every lane. Returns ``(win, err, outp, steps)``.

    CUDA tensors launch the kernel on the current stream (asynchronously)
    or raise; CPU tensors take the plain PyTorch version."""
    if max_steps is None:
        max_steps = default_max_steps(config)
    tables = (in_start, in_end, out_start, out_end, chunk_meta)
    _check_inputs(config, inbuf, win_init, tables, max_steps)
    dev = inbuf.device
    if dev.type == "cpu":
        return decode_segments_reference(
            inbuf, win_init, *tables, config=config, max_steps=max_steps
        )
    if dev.type != "cuda":
        raise ValueError(f"decode_segments runs on cuda or cpu, not {dev}")

    from lzma_rs_tpu_torch.ops import build

    smem = check_fits(config)
    lib = build.load()
    L = config.L
    with torch.cuda.device(dev):
        win = torch.empty_like(win_init)
        err, outp, steps = (
            torch.empty(L, dtype=torch.int32, device=dev) for _ in range(3)
        )
        rc = lib.lzl_decode_segments(
            inbuf.data_ptr(), win_init.data_ptr(), win.data_ptr(),
            *(t.data_ptr() for t in tables),
            err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
            L, config.W_IN, config.W, config.NLIT, config.K,
            int(max_steps), smem, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            "decode_segments kernel launch failed: "
            + lib.lzl_error_string(rc).decode()
        )
    decode_segments.launches += 1
    return win, err, outp, steps


decode_segments.launches = 0


def decoder_occupancy(cfg: SegmentConfig) -> int:
    """Lanes of ``cfg``'s bucket that the CUDA runtime keeps resident on one
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` with the kernel's
    attributes set); needs the card."""
    from lzma_rs_tpu_torch.ops import build

    lib = build.load()
    blocks = ctypes.c_int(0)
    rc = lib.lzl_decoder_occupancy(check_fits(cfg), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("decoder occupancy query failed: "
                           + lib.lzl_error_string(rc).decode())
    return blocks.value


def decode_segments_reference(
    inbuf, win_init, in_start, in_end, out_start, out_end, chunk_meta,
    *, config: SegmentConfig, max_steps: int | None = None,
):
    """The plain PyTorch version of the kernel (same contract, any device).

    Range-coder arithmetic is 32-bit unsigned, done in int64 with explicit
    masks. All lanes advance one micro-op per iteration; a handler whose
    node no lane occupies is skipped (its masked update would be a no-op).
    """
    if max_steps is None:
        max_steps = default_max_steps(config)
    tables = (in_start, in_end, out_start, out_end, chunk_meta)
    _check_inputs(config, inbuf, win_init, tables, max_steps)
    dev = inbuf.device
    L, W, W_IN, K, NLIT = config.L, config.W, config.W_IN, config.K, config.NLIT
    lay = prob_layout(NLIT)
    P = lay.total
    i64 = torch.int64
    where = torch.where

    # column W of the window is a dump slot for masked-off writes
    win = torch.zeros((L, W + 1), dtype=torch.uint8, device=dev)
    win[:, :W] = win_init
    probs = torch.full((L, P), C.PROB_INIT, dtype=i64, device=dev)
    t_is, t_ie, t_os, t_oe, t_meta = (t.to(i64) for t in tables)
    init_off = torch.arange(1, 5, device=dev)

    # registers are replaced, never written in place, so they may start
    # out as one shared zero tensor
    zero = torch.zeros(L, dtype=i64, device=dev)
    no = zero != 0
    node = torch.full((L,), C.N_CHUNK, dtype=i64, device=dev)
    rng = torch.full((L,), _U32, dtype=i64, device=dev)
    (err, cod, inp, inend, outp, outend, state, rep0, rep1, rep2, rep3,
     acc, cnt, rev, tmp, length, dist, mbyte, lit_base, tree_base,
     tree_size, len_base, rep_flag, chunk_i, lc, lpmask, pbmask,
     steps) = (zero,) * 28

    def gather1(table, idx):
        return table.gather(1, idx[:, None])[:, 0]

    after_lit, after_match, after_rep, after_shortrep = (
        f(torch.arange(12, device=dev))
        for f in (C.after_lit, C.after_match, C.after_rep, C.after_shortrep)
    )

    it = 0
    while True:
        if it % 32 == 0 and not bool((node < C.N_DONE).any()):
            break
        it += 1
        active = node < C.N_DONE
        capped = active & (steps >= max_steps)
        steps = steps + (active & ~capped)
        # fault: the error code a lane hits in this iteration (at most one;
        # applied to err and node at the end of the iteration)
        fault = capped * C.ERR_STEP_CAP
        node0 = node = where(capped, C.N_ERROR, node)
        present = torch.bincount(node0, minlength=C.N_ERROR + 1).tolist()

        def has(*nodes):
            return any(present[n] for n in nodes)

        # ---- one range-coder bit for the bit-decoding nodes -------------
        bit, eof = zero, no
        if has(*range(C.N_ALIGN + 1)):
            is_prob = (node0 <= C.N_ALIGN) & (node0 != C.N_DIRECT)
            is_direct = node0 == C.N_DIRECT
            pos_state = outp & pbmask & 15
            st4 = (state << 4) + pos_state
            match_bit = (mbyte >> 7) & 1
            pidx = tree_base + acc
            for n, idx in (
                (C.N_ISMATCH, lambda: lay.is_match + st4),
                (C.N_LIT, lambda: lit_base + acc),
                (C.N_LITM, lambda: lit_base + ((1 + match_bit) << 8) + acc),
                (C.N_ISREP, lambda: lay.is_rep + state),
                (C.N_ISREPG0, lambda: lay.is_rep_g0 + state),
                (C.N_ISREP0LONG, lambda: lay.is_rep_0long + st4),
                (C.N_ISREPG1, lambda: lay.is_rep_g1 + state),
                (C.N_ISREPG2, lambda: lay.is_rep_g2 + state),
                (C.N_LEN_CHOICE, lambda: len_base),
                (C.N_LEN_CHOICE2, lambda: len_base + 1),
            ):
                if present[n]:
                    pidx = where(node0 == n, idx(), pidx)
            pidx = pidx.clamp(0, P - 1)
            p = gather1(probs, pidx)
            bound = (rng >> 11) * p
            pbit = cod >= bound
            new_p = where(pbit, p - (p >> 5), p + ((0x800 - p) >> 5))
            probs.scatter_(1, pidx[:, None], where(is_prob, new_p, p)[:, None])
            rng_d = rng >> 1
            dbit = cod >= rng_d
            bit = where(is_prob, pbit, dbit).to(i64)
            rng = where(
                is_prob, where(pbit, rng - bound, bound),
                where(is_direct, rng_d, rng),
            )
            cod = where(
                is_prob, where(pbit, cod - bound, cod),
                where(is_direct & dbit, cod - rng_d, cod),
            )
            need = (is_prob | is_direct) & (rng < (1 << 24))
            eof = need & (inp >= inend)
            fault = where(eof, C.ERR_EOF, fault)
            do = need & ~eof
            byte = gather1(inbuf, inp.clamp(0, W_IN - 1)).to(i64)
            rng = where(do, rng << 8, rng)
            cod = where(do, ((cod << 8) & _U32) | byte, cod)
            inp = inp + do
        ok = ~eof

        # ---- window reads: the previous byte and the port ---------------
        # (matched-literal byte for N_ISMATCH lanes, copy source for N_COPY)
        if has(C.N_ISMATCH, C.N_COPY):
            rpos = where(node0 == C.N_COPY, outp - dist, outp - 1 - rep0)
            port = gather1(win, rpos.clamp(0, W - 1)).to(i64)

        done_lit = sc = no  # sc: lanes that start a match copy
        sc_len = zero
        if present[C.N_ISMATCH]:
            m = ok & (node0 == C.N_ISMATCH)
            m0 = m & (bit == 0)
            prev = where(
                outp > 0, gather1(win, (outp - 1).clamp(min=0)).to(i64), 0
            )
            ctx = (((outp & lpmask) << lc) + (prev >> (8 - lc))) & (NLIT - 1)
            lit_base = where(m0, ctx * C.LIT_ROW, lit_base)
            acc = where(m0, 1, acc)
            matched = m0 & (state >= 7)
            bad_md = matched & (rep0 + 1 > outp)
            fault = where(bad_md, C.ERR_MATCHDIST, fault)
            mbyte = where(matched & ~bad_md, port, mbyte)
            node = where(
                m0 & ~bad_md, where(state >= 7, C.N_LITM, C.N_LIT), node
            )
            node = where(m & (bit == 1), C.N_ISREP, node)
        if present[C.N_LITM]:
            m = ok & (node0 == C.N_LITM)
            match_bit = (mbyte >> 7) & 1
            acc = where(m, (acc << 1) | bit, acc)
            mbyte = where(m, (mbyte << 1) & 0xFF, mbyte)
            done_m = m & (acc >= 0x100)
            node = where(m & ~done_m & (bit != match_bit), C.N_LIT, node)
            done_lit = done_lit | done_m
        if present[C.N_LIT]:
            m = ok & (node0 == C.N_LIT)
            acc = where(m, (acc << 1) | bit, acc)
            done_lit = done_lit | (m & (acc >= 0x100))
        state = where(done_lit, after_lit[state], state)

        if present[C.N_ISREP]:
            m = ok & (node0 == C.N_ISREP)
            m0 = m & (bit == 0)
            rep3 = where(m0, rep2, rep3)
            rep2 = where(m0, rep1, rep2)
            rep1 = where(m0, rep0, rep1)
            len_base = where(m0, lay.len_coder, len_base)
            rep_flag = where(m0, 0, rep_flag)
            node = where(m0, C.N_LEN_CHOICE, node)
            node = where(m & (bit == 1), C.N_ISREPG0, node)
        if present[C.N_ISREPG0]:
            m = ok & (node0 == C.N_ISREPG0)
            node = where(m, where(bit == 0, C.N_ISREP0LONG, C.N_ISREPG1), node)
        if present[C.N_ISREP0LONG]:
            m = ok & (node0 == C.N_ISREP0LONG)
            short = m & (bit == 0)
            state = where(short, after_shortrep[state], state)
            sc = sc | short
            sc_len = where(short, 1, sc_len)
            long0 = m & (bit == 1)
            len_base = where(long0, lay.rep_len_coder, len_base)
            rep_flag = where(long0, 1, rep_flag)
            node = where(long0, C.N_LEN_CHOICE, node)
        if present[C.N_ISREPG1]:
            m = ok & (node0 == C.N_ISREPG1)
            sel1 = m & (bit == 0)
            rep0, rep1 = where(sel1, rep1, rep0), where(sel1, rep0, rep1)
            len_base = where(sel1, lay.rep_len_coder, len_base)
            rep_flag = where(sel1, 1, rep_flag)
            node = where(sel1, C.N_LEN_CHOICE, node)
            node = where(m & (bit == 1), C.N_ISREPG2, node)
        if present[C.N_ISREPG2]:
            m = ok & (node0 == C.N_ISREPG2)
            sel2 = m & (bit == 0)
            sel3 = m & (bit == 1)
            r0, r1, r2, r3 = rep0, rep1, rep2, rep3
            rep0 = where(sel2, r2, where(sel3, r3, r0))
            rep1 = where(m, r0, r1)
            rep2 = where(m, r1, r2)
            rep3 = where(sel3, r2, r3)
            len_base = where(m, lay.rep_len_coder, len_base)
            rep_flag = where(m, 1, rep_flag)
            node = where(m, C.N_LEN_CHOICE, node)
        if present[C.N_LEN_CHOICE]:
            m = ok & (node0 == C.N_LEN_CHOICE)
            low = m & (bit == 0)
            tree_base = where(low, len_base + 2 + pos_state * 8, tree_base)
            tree_size = where(low, 8, tree_size)
            cnt = where(low, 3, cnt)
            acc = where(low, 1, acc)
            tmp = where(low, 0, tmp)  # len_add
            node = where(m, where(bit == 0, C.N_LEN_TREE, C.N_LEN_CHOICE2),
                         node)
        if present[C.N_LEN_CHOICE2]:
            m = ok & (node0 == C.N_LEN_CHOICE2)
            mid = m & (bit == 0)
            high = m & (bit == 1)
            tree_base = where(mid, len_base + 2 + 128 + pos_state * 8,
                              tree_base)
            tree_base = where(high, len_base + 2 + 256, tree_base)
            tree_size = where(mid, 8, where(high, 256, tree_size))
            cnt = where(mid, 3, where(high, 8, cnt))
            acc = where(m, 1, acc)
            tmp = where(mid, 8, where(high, 16, tmp))
            node = where(m, C.N_LEN_TREE, node)
        if present[C.N_LEN_TREE]:
            m = ok & (node0 == C.N_LEN_TREE)
            acc = where(m, (acc << 1) | bit, acc)
            cnt = where(m, cnt - 1, cnt)
            done_len = m & (cnt == 0)
            length = where(done_len, tmp + acc - tree_size, length)
            repdone = done_len & (rep_flag == 1)
            state = where(repdone, after_rep[state], state)
            sc = sc | repdone
            sc_len = where(repdone, length + 2, sc_len)
            matchdone = done_len & (rep_flag == 0)
            state = where(matchdone, after_match[state], state)
            tree_base = where(
                matchdone, lay.pos_slot + torch.clamp(length, max=3) * 64,
                tree_base,
            )
            tree_size = where(matchdone, 64, tree_size)
            cnt = where(matchdone, 6, cnt)
            acc = where(matchdone, 1, acc)
            node = where(matchdone, C.N_POSSLOT, node)

        fin, field = no, zero  # fin: lanes whose distance field is complete
        if present[C.N_POSSLOT]:
            m = ok & (node0 == C.N_POSSLOT)
            acc = where(m, (acc << 1) | bit, acc)
            cnt = where(m, cnt - 1, cnt)
            done_ps = m & (cnt == 0)
            slot = acc - 64
            small = done_ps & (slot < 4)
            fin = fin | small
            field = where(small, slot, field)
            big = done_ps & (slot >= 4)
            ndirect = (slot >> 1) - 1
            base_dist = (2 | (slot & 1)) << ndirect.clamp(0, 31)
            dist = where(big, base_dist, dist)
            midrange = big & (slot < 14)
            tree_base = where(midrange, lay.spec_pos + base_dist - slot,
                              tree_base)
            vast = big & (slot >= 14)
            cnt = where(midrange, ndirect, where(vast, ndirect - 4, cnt))
            acc = where(midrange, 1, where(vast, 0, acc))
            rev = where(midrange, 0, rev)
            tmp = where(midrange, 1, tmp)
            node = where(midrange, C.N_SPECPOS,
                         where(vast, C.N_DIRECT, node))
        if present[C.N_DIRECT]:
            m = ok & (node0 == C.N_DIRECT)
            acc = where(m, (acc << 1) | bit, acc)
            cnt = where(m, cnt - 1, cnt)
            done_d = m & (cnt == 0)
            dist = where(done_d, dist + (acc << 4), dist)
            tree_base = where(done_d, lay.align, tree_base)
            cnt = where(done_d, 4, cnt)
            acc = where(done_d, 1, acc)
            rev = where(done_d, 0, rev)
            tmp = where(done_d, 1, tmp)
            node = where(done_d, C.N_ALIGN, node)
        if has(C.N_SPECPOS, C.N_ALIGN):
            m = ok & ((node0 == C.N_SPECPOS) | (node0 == C.N_ALIGN))
            acc = where(m, (acc << 1) | bit, acc)
            rev = where(m, rev | (bit * tmp), rev)
            tmp = where(m, tmp << 1, tmp)
            cnt = where(m, cnt - 1, cnt)
            done_t = m & (cnt == 0)
            fin = fin | done_t
            field = where(done_t, dist + rev, field)
        if has(C.N_POSSLOT, C.N_SPECPOS, C.N_ALIGN):
            # end marker: symbols run only while outp < outend, so a
            # finished coder here still leaves the chunk short
            marker = fin & (field == _U32)
            fin_ok = (cod == 0) & (inp >= inend)
            fault = where(marker & fin_ok, C.ERR_SIZE, fault)
            fault = where(marker & ~fin_ok, C.ERR_EOS_EXTRA, fault)
            normal = fin & ~marker
            rep0 = where(normal, field, rep0)
            sc = sc | normal
            sc_len = where(normal, length + 2, sc_len)

        # ---- match start: validate the distance, enter N_COPY -----------
        bad = sc & (rep0 + 1 > outp)
        fault = where(bad, C.ERR_DIST_OUT, fault)
        good = sc & ~bad
        node = where(good, C.N_COPY, node)
        length = where(good, sc_len, length)
        dist = where(good, rep0 + 1, dist)

        # ---- window write: emitted literals and copied bytes ------------
        wmask, wval, sym_done = done_lit, acc - 0x100, done_lit
        if present[C.N_COPY]:
            m = node0 == C.N_COPY
            over = m & (outp >= outend)
            fault = where(over, C.ERR_SIZE, fault)
            m_w = m & ~over
            wmask = wmask | m_w
            wval = where(m_w, port, wval)
            length = where(m_w, length - 1, length)
            sym_done = sym_done | (m_w & (length == 0))
        win.scatter_(
            1, where(wmask, outp, W)[:, None],
            (wval & 0xFF).to(torch.uint8)[:, None],
        )
        outp = outp + wmask
        node = where(
            sym_done, where(outp == outend, C.N_CHUNK, C.N_ISMATCH), node
        )

        # ---- chunk setup ------------------------------------------------
        if present[C.N_CHUNK]:
            m = node0 == C.N_CHUNK
            ci = chunk_i.clamp(0, K - 1)
            cmeta = where(chunk_i < K, gather1(t_meta, ci), 0)
            have = m & (((cmeta >> 12) & 1) == 1)
            node = where(m & ~have, C.N_DONE, node)
            cin, cend = gather1(t_is, ci), gather1(t_ie, ci)
            cos, coe = gather1(t_os, ci), gather1(t_oe, ci)
            off_buf = (
                (cin < 0) | (cend > W_IN) | (cos < 0) | (cos > coe)
                | (coe > W) | (cend - cin < 5)
            )
            fault = where(have & off_buf, C.ERR_SHORT, fault)
            go = have & ~off_buf
            reset = go & ((cmeta & 3) == 1)
            if bool(reset.any()):
                probs[reset] = C.PROB_INIT
            state = where(reset, 0, state)
            rep0, rep1, rep2, rep3 = (
                where(reset, 0, r) for r in (rep0, rep1, rep2, rep3)
            )
            clp = (cmeta >> 6) & 7
            lc = where(go, torch.clamp((cmeta >> 2) & 15, max=8), lc)
            lpmask = where(go, (torch.ones_like(clp) << clp) - 1, lpmask)
            cpb = (cmeta >> 9) & 7
            pbmask = where(go, (torch.ones_like(cpb) << cpb) - 1, pbmask)
            ib = inbuf.gather(
                1, (cin[:, None] + init_off).clamp(0, W_IN - 1)
            ).to(i64)
            code0 = (ib[:, 0] << 24) | (ib[:, 1] << 16) | (ib[:, 2] << 8) \
                | ib[:, 3]
            rng = where(go, _U32, rng)
            cod = where(go, code0, cod)
            inp = where(go, cin + 5, inp)
            inend = where(go, cend, inend)
            outp = where(go, cos, outp)
            outend = where(go, coe, outend)
            chunk_i = chunk_i + go
            node = where(go, where(cos == coe, C.N_CHUNK, C.N_ISMATCH), node)

        err = err | fault  # err is 0 on every lane that was still active
        node = where(fault != 0, C.N_ERROR, node)

    return (
        win[:, :W].contiguous(),
        err.to(torch.int32),
        outp.to(torch.int32),
        steps.to(torch.int32),
    )


def from_jax_layout(
    config2, inbuf_w, win_init_w, in_start, in_end, out_start, out_end,
    chunk_meta, device=None,
):
    """The JAX kernel's numpy inputs as the port's config and tensors.

    ``config2`` is a gen-2 ``KernelConfig2`` or a gen-1 ``KernelConfig``
    (``lzma_rs_tpu/ops/vmem_decoder.py``) as it is: only their shared
    budget fields ``W, W_IN, NLIT, K, NPS`` are read (``L`` comes from the
    arrays). ``[W/4, L]`` int32 words (little-endian bytes) become
    ``[L, W]`` u8; ``[K, L]`` tables become ``[L, K]``. Returns
    ``(config, inbuf, win_init, in_start, in_end, out_start, out_end,
    chunk_meta)``."""
    device = torch.device("cpu") if device is None else device
    L = int(np.shape(inbuf_w)[1])
    cfg = SegmentConfig(
        L=L, W=config2.W, W_IN=config2.W_IN, NLIT=config2.NLIT,
        K=config2.K, NPS=config2.NPS,
    )

    def bytes_lane_major(words):
        a = np.ascontiguousarray(np.asarray(words, dtype="<i4").T)
        return torch.from_numpy(a.view(np.uint8).copy()).to(device)

    def table(t):
        a = np.ascontiguousarray(np.asarray(t, dtype=np.int32).T)
        return torch.from_numpy(a.copy()).to(device)

    return (
        cfg,
        bytes_lane_major(inbuf_w),
        bytes_lane_major(win_init_w),
        *(table(t) for t in (in_start, in_end, out_start, out_end,
                             chunk_meta)),
    )


def to_jax_layout(win, err, outp):
    """The port's outputs in the JAX kernel's layout (numpy):
    ``win [W/4, L]`` int32, ``err`` and ``outp`` ``[1, L]`` int32."""
    w = win.detach().cpu().contiguous().numpy()
    return (
        np.ascontiguousarray(w.view("<i4").T),
        err.detach().cpu().numpy().astype(np.int32)[None, :],
        outp.detach().cpu().numpy().astype(np.int32)[None, :],
    )
