"""The lane engine: L dict-reset segments of any size decoded in place.

The port of ``lzma_rs_tpu/ops/lane_decoder.py::decode_lanes`` (``:105``),
the JAX package's XLA lane kernel, which its runtime reaches only when a
caller names the engine ``tpu-lane``; here the engine is ``cuda-lane``
(``parallel/runtime.py::execute_plan``). Where ``decode_segments`` keeps a
lane's window in shared memory and so takes segments of at most 64 KiB
with lc + lp <= 3, this engine's lanes decode in the flat output itself:

- the output is one flat uint8 tensor (JAX's ``out_init`` without its dump
  slot, the stored chunks placed), and a lane's LZ window is its own slice
  of it, from ``seg_base`` to its last chunk's ``out_end``: any dictionary
  size;
- the input is the flat archive; chunk tables are ``[L, K]`` int32 with
  absolute offsets, K the batch's own largest chunk count;
- the probability table is the LAYOUT_LCLP4 one: lc + lp <= 4;
- a distance beyond the lane's ``dict_size`` is ``ERR_DIST_DICT``, tested
  before ``ERR_DIST_OUT``;
- a lane with ``size_known`` 0 (a raw stream with an end marker) decodes
  its first chunk up to the marker, or up to a finished coder after a
  symbol or right after the chunk's setup (the JAX kernel's ``insta_fin``).

:func:`decode_lanes` is the wrapper, with the JAX function's arguments in
its order. On CUDA tensors it launches the hand-written kernel
(``csrc/decode_lanes.cu``: a block of two warps a lane, over
``csrc/lane_engine.cuh`` and ``csrc/lzma_lane.cuh``) or raises; on CPU
tensors it runs
:func:`decode_lanes_reference`, the plain PyTorch version. Both decode in
place: the returned ``out`` is ``out_init``. ``decode_lanes.launches``
counts kernel launches. :func:`from_jax_args` and :func:`to_jax_outputs`
carry the JAX function's numpy inputs and outputs across (its power-of-two
padding and its dump slot at ``out_init[-1]``).

Where the port differs from the JAX function, on inputs the JAX runtime's
plans never hold, so that every access stays inside the buffers: a chunk
off the input, off the lane's window or shorter than 5 bytes is
``ERR_SHORT``; props are clamped to their fields (lc <= 8, lp and pb <=
7); a symbol of a lane of unknown size past its chunk's ``out_end`` is
``ERR_SIZE``; a lane stops with ``ERR_STEP_CAP`` when its step budget
(:func:`lane_budgets`, int64 like the step count: it never stops a valid
lane) is spent. And on one the plans do hold: a chunk's
output starts at its ``out_start``. The JAX kernel carries ``outp`` on
from the previous chunk, so a stored chunk between two LZMA chunks of a
segment makes its lane decode over the stored bytes and fail (its runtime
then replays the stream on the host); here such a lane decodes.

What bounds the kernel on the H100 is the serial chain of each lane (a
range-coder bit waits on the one before) and lane parallelism: a launch
lasts its longest lane's steps times the cycles a step, and 16 lanes of 1
MiB blocks occupy 16 of the 132 SMs. Bytes and operations bound it at
microseconds (``chip_smoke.py`` phase 21). The format fixes the lanes, so
the kernel shortens the chain of a step: one thread of each lane's block,
the lead, runs the chain alone with no barrier a bit and no test a bit far
from the budget's and the chunk's ends, every bit tree's probabilities are
loaded two levels ahead, the literal context's byte stays in a register,
and the block's second warp refills the table and copies matches longer
than 8 bytes while the lead decodes on (``csrc/lane_engine.cuh`` gives the
whole design).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lzma_rs_tpu_torch.ops import lzma_consts as C
from lzma_rs_tpu_torch.ops.lzma_consts import prob_layout

__all__ = [
    "ERR_DIST_DICT",
    "NLIT",
    "decode_lanes",
    "decode_lanes_reference",
    "from_jax_args",
    "lane_budgets",
    "lanes_occupancy",
    "smem_bytes",
    "to_jax_outputs",
]

# The JAX lane kernel's error codes, 0-7 (lane_decoder.py:68-76); a lane
# that spends its step budget stops with ERR_STEP_CAP, which shares code 1
# with ERR_EOF.
ERR_NONE = C.ERR_NONE
ERR_EOF = C.ERR_EOF
ERR_DIST_OUT = C.ERR_DIST_OUT
ERR_DIST_DICT = 3
ERR_SIZE = C.ERR_SIZE
ERR_EOS_EXTRA = C.ERR_EOS_EXTRA
ERR_SHORT = C.ERR_SHORT
ERR_MATCHDIST = C.ERR_MATCHDIST
ERR_STEP_CAP = C.ERR_STEP_CAP

NLIT = 16  # literal contexts: lc + lp <= 4 (LAYOUT_LCLP4)
LAYOUT = prob_layout(NLIT)
# The kernel's table: LAYOUT's cells in csrc/lane_engine.cuh's own order
# (LaneTable, every bit tree 8-byte aligned), 14,152 probabilities in an
# allocation of 14,920 (a tree's last level loads past its leaves).
TABLE_ENTRIES = 14_920
MAIL_BYTES = 144  # the lead's mailbox to its helper warp (lane_engine.cuh)
_U32 = 0xFFFFFFFF
_I32_MAX = 0x7FFFFFFF
_TABLES = ("in_start", "in_end", "out_start", "out_end", "reset_state",
           "lc", "lp", "pb")



def smem_bytes() -> int:
    """Dynamic shared memory of one lane (one block) of the kernel: its
    probability table, rounded up to 16 bytes, and its mailbox
    (``csrc/lane_engine.cuh::lane_smem_bytes``)."""
    return ((2 * TABLE_ENTRIES + 15) & ~15) + MAIL_BYTES


def lane_budgets(w, nchunks, max_steps: int | None = None):
    """Each lane's step budget, int64: ``24 * w + 2 * nchunks + 64`` for a
    window of ``w`` bytes (int64 tensors), at most ``max_steps`` where
    given. A symbol emits at least one byte or stops the lane and costs at
    most 44 micro-ops for 2 bytes, so no lane takes more than ``22 * w + K
    + 1`` steps: the budget never stops a valid stream, for every ``w <
    2**31`` (``ERR_STEP_CAP`` is code 1, ``ERR_EOF``'s).
    ``csrc/lane_engine.cuh::lane_budget`` computes the same."""
    b = 24 * w + 2 * nchunks + 64
    if max_steps is not None:
        b = b.clamp(max=int(max_steps))
    return b


def _check_inputs(args, max_steps):
    inbytes, out_init = args[0], args[1]
    dev = inbytes.device
    tables = args[2:10]
    L, K = (tuple(tables[0].shape) + (0, 0))[:2] if tables[0].dim() == 2 \
        else (-1, -1)
    want = [("inbytes", inbytes, torch.uint8, (inbytes.numel(),)),
            ("out_init", out_init, torch.uint8, (out_init.numel(),))]
    want += [(n, t, torch.int32, (L, K)) for n, t in zip(_TABLES, tables)]
    want += [(n, t, torch.int32, (L,)) for n, t in
             zip(("nchunks", "seg_base", "size_known"), args[10:13])]
    want += [("dict_size", args[13], torch.int64, (L,))]
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, inbytes on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("inbytes", inbytes), ("out_init", out_init)):
        if t.numel() >= 2**31:
            raise ValueError(f"{name} holds {t.numel()} bytes: the lane "
                             "engine's offsets are int32 (< 2^31)")
    if max_steps is not None and not 0 < max_steps < 2**63:
        raise ValueError(f"max_steps={max_steps} outside (0, 2^63)")


def decode_lanes(
    inbytes, out_init, in_start, in_end, out_start, out_end, reset_state,
    lc, lp, pb, nchunks, seg_base, size_known, dict_size, *,
    max_steps: int | None = None,
):
    """Decode every lane into ``out_init``, in place. Returns ``(out, err,
    outp, steps)``: ``out`` is ``out_init``; ``err`` and ``outp``
    (absolute) are ``[L]`` int32, ``steps`` ``[L]`` int64.

    Tensors: ``inbytes`` ``[IN]`` and ``out_init`` ``[OUT]`` uint8 (IN, OUT
    < 2^31); the eight chunk tables ``[L, K]`` int32; ``nchunks``,
    ``seg_base``, ``size_known`` ``[L]`` int32; ``dict_size`` ``[L]`` int64.
    ``max_steps`` caps every lane's budget (:func:`lane_budgets`). CUDA
    tensors launch the kernel on the current stream (asynchronously) or
    raise; CPU tensors take the plain PyTorch version."""
    args = (inbytes, out_init, in_start, in_end, out_start, out_end,
            reset_state, lc, lp, pb, nchunks, seg_base, size_known,
            dict_size)
    _check_inputs(args, max_steps)
    dev = inbytes.device
    if dev.type == "cpu":
        return decode_lanes_reference(*args, max_steps=max_steps)
    if dev.type != "cuda":
        raise ValueError(f"decode_lanes runs on cuda or cpu, not {dev}")

    from lzma_rs_tpu_torch.ops import build

    lib = build.load_lanes()
    L, K = in_start.shape
    with torch.cuda.device(dev):
        err, outp = (torch.empty(L, dtype=torch.int32, device=dev)
                     for _ in range(2))
        steps = torch.empty(L, dtype=torch.int64, device=dev)
        if L == 0:
            return out_init, err, outp, steps
        rc = lib.lzl_decode_lanes(
            inbytes.data_ptr(), out_init.data_ptr(),
            *(t.data_ptr() for t in args[2:]),
            err.data_ptr(), outp.data_ptr(), steps.data_ptr(),
            L, K, inbytes.numel(), out_init.numel(),
            0 if max_steps is None else int(max_steps),
            lib.lzl_lanes_smem_bytes(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError("decode_lanes kernel launch failed: "
                           + lib.lzl_lanes_error_string(rc).decode())
    decode_lanes.launches += 1
    return out_init, err, outp, steps


decode_lanes.launches = 0


def lanes_occupancy() -> int:
    """Lanes the CUDA runtime keeps resident on one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` with the kernel's
    attributes set); needs the card."""
    from lzma_rs_tpu_torch.ops import build

    lib = build.load_lanes()
    blocks = ctypes.c_int(0)
    rc = lib.lzl_lanes_occupancy(smem_bytes(), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError("lane occupancy query failed: "
                           + lib.lzl_lanes_error_string(rc).decode())
    return blocks.value


def decode_lanes_reference(
    inbytes, out_init, in_start, in_end, out_start, out_end, reset_state,
    lc, lp, pb, nchunks, seg_base, size_known, dict_size, *,
    max_steps: int | None = None,
):
    """The plain PyTorch version of the kernel (same contract, any device;
    decodes into ``out_init`` in place).

    All lanes advance together: a range-coder bit or a chunk setup is one
    iteration and one step, as in the JAX function; a match copy moves in
    one iteration and counts a step a byte, ending as the kernel's
    ``split_copy`` does (whole, at the budget with ``ERR_STEP_CAP``, or at
    the chunk's end with ``ERR_SIZE`` after one more step). Range-coder
    arithmetic is 32-bit unsigned, done in int64 with explicit masks; a
    handler whose node no lane occupies is skipped."""
    args = (inbytes, out_init, in_start, in_end, out_start, out_end,
            reset_state, lc, lp, pb, nchunks, seg_base, size_known,
            dict_size)
    _check_inputs(args, max_steps)
    dev = inbytes.device
    L, K = in_start.shape
    IN, OUT = inbytes.numel(), out_init.numel()
    lay = LAYOUT
    P = lay.total
    i64 = torch.int64
    where = torch.where

    inb = inbytes if IN else torch.zeros(1, dtype=torch.uint8, device=dev)
    out = torch.zeros(OUT + 1, dtype=torch.uint8, device=dev)  # dump: OUT
    out[:OUT] = out_init
    probs = torch.full((L, P), C.PROB_INIT, dtype=i64, device=dev)
    t_is, t_ie = in_start.to(i64), in_end.to(i64)
    n = nchunks.to(i64).clamp(0, K)
    base = seg_base.to(i64)
    in_out = (base >= 0) & (base <= OUT)
    last = (out_end.to(i64).gather(1, (n - 1).clamp(min=0)[:, None])[:, 0]
            if K else torch.zeros(L, dtype=i64, device=dev))
    w = where((n > 0) & in_out & (last >= base) & (last <= OUT),
              last - base, 0)
    at = where(in_out, base, 0)  # the lane's window starts at out[at]
    t_os = (out_start.to(i64) - base[:, None]).clamp(-1, _I32_MAX)
    t_oe = (out_end.to(i64) - base[:, None]).clamp(-1, _I32_MAX)
    t_reset = reset_state == 1
    t_lc = lc.to(i64).clamp(0, 8)
    t_lp = lp.to(i64).clamp(0, 7)
    t_pb = pb.to(i64).clamp(0, 7)
    budget = lane_budgets(w, n, max_steps)
    dict_lim = dict_size.clamp(0, _U32)
    open_ = size_known == 0
    init_off = torch.arange(1, 5, device=dev)

    zero = torch.zeros(L, dtype=i64, device=dev)
    no = zero != 0
    node = torch.full((L,), C.N_CHUNK, dtype=i64, device=dev)
    rng = torch.full((L,), _U32, dtype=i64, device=dev)
    (err, cod, inp, inend, outp, outend, state, rep0, rep1, rep2, rep3,
     acc, cnt, rev, tmp, length, dist, mbyte, lit_base, tree_base,
     tree_size, len_base, rep_flag, chunk_i, lcr, lpmask, pbmask,
     steps) = (zero,) * 28

    def gather1(table, idx):
        return table.gather(1, idx[:, None])[:, 0]

    def win_at(pos):  # window bytes at lane-local positions
        return out[(at + pos).clamp(0, OUT)].to(i64)

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
        capped = active & (steps >= budget)
        steps = steps + (active & ~capped)
        # fault: the error code a lane hits in this iteration (at most one;
        # applied to err and node at the end of the iteration)
        fault = capped * ERR_STEP_CAP
        node0 = node = where(capped, C.N_ERROR, node)
        present = torch.bincount(node0, minlength=C.N_ERROR + 1).tolist()

        def has(*nodes):
            return any(present[k] for k in nodes)

        # ---- one range-coder bit for the bit-decoding nodes -------------
        bit, eof = zero, no
        if has(*range(C.N_ALIGN + 1)):
            is_prob = (node0 <= C.N_ALIGN) & (node0 != C.N_DIRECT)
            is_direct = node0 == C.N_DIRECT
            pos_state = outp & pbmask & 15
            st4 = (state << 4) + pos_state
            match_bit = (mbyte >> 7) & 1
            pidx = tree_base + acc
            for k, idx in (
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
                if present[k]:
                    pidx = where(node0 == k, idx(), pidx)
            pidx = pidx.clamp(0, P - 1)
            p = gather1(probs, pidx)
            bound = (rng >> 11) * p
            pbit = cod >= bound
            new_p = where(pbit, p - (p >> 5), p + ((0x800 - p) >> 5))
            probs.scatter_(1, pidx[:, None],
                           where(is_prob, new_p, p)[:, None])
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
            fault = where(eof, ERR_EOF, fault)
            do = need & ~eof
            byte = inb[inp.clamp(0, max(IN - 1, 0))].to(i64)
            rng = where(do, rng << 8, rng)
            cod = where(do, ((cod << 8) & _U32) | byte, cod)
            inp = inp + do
        ok = ~eof

        done_lit = sc = no  # sc: lanes that start a match copy
        sc_len = zero
        if present[C.N_ISMATCH]:
            m = ok & (node0 == C.N_ISMATCH)
            m0 = m & (bit == 0)
            prev = where(outp > 0, win_at(outp - 1), 0)
            ctx = (((outp & lpmask) << lcr) + (prev >> (8 - lcr))) \
                & (NLIT - 1)
            lit_base = where(m0, ctx * C.LIT_ROW, lit_base)
            acc = where(m0, 1, acc)
            matched = m0 & (state >= 7)
            bad_md = matched & (rep0 + 1 > outp)
            fault = where(bad_md, ERR_MATCHDIST, fault)
            mbyte = where(matched & ~bad_md, win_at(outp - 1 - rep0), mbyte)
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
            node = where(m, where(bit == 0, C.N_ISREP0LONG, C.N_ISREPG1),
                         node)
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
        finished = (cod == 0) & (inp >= inend)  # the coder at its chunk's end
        if has(C.N_POSSLOT, C.N_SPECPOS, C.N_ALIGN):
            # the end marker: an open lane's end; a sized chunk's symbols
            # run only while outp < outend, so a finished coder still
            # leaves it short
            marker = fin & (field == _U32)
            fault = where(marker & finished & ~open_, ERR_SIZE, fault)
            fault = where(marker & ~finished, ERR_EOS_EXTRA, fault)
            node = where(marker & finished & open_, C.N_DONE, node)
            normal = fin & ~marker
            rep0 = where(normal, field, rep0)
            sc = sc | normal
            sc_len = where(normal, length + 2, sc_len)

        # ---- match start: validate the distance, enter N_COPY -----------
        if bool(sc.any()):
            bad_dict = sc & (rep0 + 1 > dict_lim)
            fault = where(bad_dict, ERR_DIST_DICT, fault)
            bad = sc & ~bad_dict & (rep0 + 1 > outp)
            fault = where(bad, ERR_DIST_OUT, fault)
            good = sc & ~bad_dict & ~bad
            node = where(good, C.N_COPY, node)
            length = where(good, sc_len, length)
            dist = where(good, rep0 + 1, dist)

        # ---- literals: past an open lane's capacity, or stored ----------
        any_lit = bool(done_lit.any())
        if any_lit:
            over_lit = done_lit & (outp >= outend)
            fault = where(over_lit, ERR_SIZE, fault)
            done_lit = done_lit & ~over_lit
            out[where(done_lit, at + outp, OUT)] = \
                ((acc - 0x100) & 0xFF).to(torch.uint8)
            outp = outp + done_lit

        # ---- match copies, a whole copy an iteration -------------------
        copied = no
        if present[C.N_COPY]:
            m = node0 == C.N_COPY
            s_left = budget - (steps - 1)  # before this iteration's step
            o_left = outend - outp
            whole = m & (length <= s_left) & (length <= o_left)
            at_cap = m & ~whole & (s_left <= o_left)
            at_end = m & ~whole & ~at_cap
            nb = where(whole, length, where(at_cap, s_left,
                                            where(at_end, o_left, 0)))
            steps = steps + where(
                whole, length - 1, where(at_cap, s_left - 1,
                                         where(at_end, o_left, 0)))
            fault = where(at_cap, ERR_STEP_CAP, fault)
            fault = where(at_end, ERR_SIZE, fault)
            top = int(nb.max())
            if top > 0:  # byte i of lane l's copy: out[pos - d + i % d]
                i = torch.arange(top, device=dev)[None, :]
                sel = i < nb[:, None]
                pos = (at + outp)[:, None]
                d = dist.clamp(min=1)[:, None]
                out[(pos + i)[sel]] = out[(pos - d + i % d)[sel]]
            outp = outp + nb
            length = length - nb
            copied = whole

        # ---- a symbol ends: the next symbol, chunk or the lane's end ----
        sym_done = done_lit | copied
        if any_lit or bool(copied.any()):
            node = where(
                sym_done,
                where(open_, where(finished, C.N_DONE, C.N_ISMATCH),
                      where(outp == outend, C.N_CHUNK, C.N_ISMATCH)),
                node,
            )

        # ---- chunk setup ------------------------------------------------
        if present[C.N_CHUNK]:
            m = node0 == C.N_CHUNK
            ci = chunk_i.clamp(0, max(K - 1, 0))
            have = m & (chunk_i < n)
            node = where(m & ~have, C.N_DONE, node)
            if K:
                cin, cend = gather1(t_is, ci), gather1(t_ie, ci)
                cos, coe = gather1(t_os, ci), gather1(t_oe, ci)
                creset = gather1(t_reset, ci)
                clc, clp, cpb = (gather1(t, ci) for t in (t_lc, t_lp, t_pb))
            else:
                cin = cend = cos = coe = clc = clp = cpb = zero
                creset = no
            off_buf = (
                (cin < 0) | (cend > IN) | (cos < 0) | (cos > coe)
                | (coe > w) | (cend - cin < 5)
            )
            fault = where(have & off_buf, ERR_SHORT, fault)
            go = have & ~off_buf
            reset = go & creset
            if bool(reset.any()):
                probs[reset] = C.PROB_INIT
            state = where(reset, 0, state)
            rep0, rep1, rep2, rep3 = (
                where(reset, 0, r) for r in (rep0, rep1, rep2, rep3)
            )
            lcr = where(go, clc, lcr)
            lpmask = where(go, (torch.ones_like(clp) << clp) - 1, lpmask)
            pbmask = where(go, (torch.ones_like(cpb) << cpb) - 1, pbmask)
            ib = inb[(cin[:, None] + init_off).clamp(0, max(IN - 1, 0))] \
                .to(i64)
            code0 = (ib[:, 0] << 24) | (ib[:, 1] << 16) | (ib[:, 2] << 8) \
                | ib[:, 3]
            rng = where(go, _U32, rng)
            cod = where(go, code0, cod)
            inp = where(go, cin + 5, inp)
            inend = where(go, cend, inend)
            outp = where(go, cos, outp)
            outend = where(go, coe, outend)
            chunk_i = chunk_i + go
            insta_fin = (code0 == 0) & (cin + 5 >= cend)
            node = where(
                go,
                where(open_, where(insta_fin, C.N_DONE, C.N_ISMATCH),
                      where(cos == coe, C.N_CHUNK, C.N_ISMATCH)),
                node,
            )

        err = err | fault  # err is 0 on every lane that was still active
        node = where(fault != 0, C.N_ERROR, node)

    out_init.copy_(out[:OUT])
    return (
        out_init,
        err.to(torch.int32),
        (at + outp).to(torch.int32),
        steps,
    )


def from_jax_args(
    inbytes, out_init, in_start, in_end, out_start, out_end, reset_state,
    lcs, lps, pbs, nchunks, seg_base, size_known, dict_size, device=None,
):
    """The JAX function's inputs (numpy, as ``lzma_rs_tpu/parallel/
    runtime.py::execute_plan`` builds them: ``inbytes`` padded to a power
    of two, ``out_init`` of ``next_pow2(total_out + 1)`` bytes whose last is
    the dump slot, tables ``[L, K]`` with L and K padded to powers of two)
    as :func:`decode_lanes`' tensors on ``device``. The dump slot is
    dropped; the padding stays (padded lanes have no chunks, padded bytes
    are never a chunk's)."""
    device = torch.device("cpu") if device is None else device

    def put(a, dtype):
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(a).astype(dtype))).to(device)

    return (
        put(inbytes, np.uint8),
        put(np.asarray(out_init)[:-1], np.uint8),
        *(put(t, np.int32) for t in (in_start, in_end, out_start, out_end,
                                     reset_state, lcs, lps, pbs)),
        *(put(t, np.int32) for t in (nchunks, seg_base, size_known)),
        put(np.asarray(dict_size, dtype=np.uint32), np.int64),
    )


def to_jax_outputs(out, err, outp, steps, out_init):
    """The port's outputs as the JAX function returns them (numpy):
    ``out`` with the dump slot of the JAX ``out_init`` appended, ``err``
    and ``outp`` int32, and the loop's iteration count, which is the
    longest lane's steps (int64; every lane steps once an iteration until
    it stops)."""
    o = out.detach().cpu().numpy()
    tail = np.asarray(out_init, dtype=np.uint8)[-1:]
    s = steps.detach().cpu().numpy()
    return (
        np.concatenate([o, tail]),
        err.detach().cpu().numpy().astype(np.int32),
        outp.detach().cpu().numpy().astype(np.int32),
        int(s.max()) if s.size else 0,
    )
