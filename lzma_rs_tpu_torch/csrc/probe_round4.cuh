// One thread of each round4 probe kernel: the per-lane functions of the
// JAX package's Pallas probes tools/probe_round4.py, in scalar code.
//
// Compiled for the card by probes_round4.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_round4.cu as host loops over threads, so the logic
// is checked on the CPU against the plain PyTorch versions
// (ops/probes_round4.py).
//
// Every probe keeps a lane's state in four int32 slots st[0..3] (slot 0
// the seed, the output) and runs `iters` iterations over a lane-minor
// table x ([R, L]: row r of lane l at r L + l). An index is the probes'
// _idx_mix of slot 0: clip((st0 * 40499) & mask, 0, R - 1), the multiply
// wrapping in int32 (mask 1023, or 2047 for sel_s). Integer semantics are
// the probes': wrapping int32 (every add and multiply that can wrap is done
// in uint32_t and converted back) and an arithmetic >> of int32. A narrow
// table entry (int16, int8) is sign-extended to int32.
#ifndef LZMA_RS_TPU_TORCH_PROBE_ROUND4_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_ROUND4_CUH_

#include "probe_mosaic.cuh"

namespace lzr4 {

using lzm::wrap;

constexpr int kBlock = 128;          // threads per block
constexpr uint32_t kMixMul = 40499;  // _idx_mix's multiplier
constexpr int kGatherLanes = 128;    // gather_taa: lane l follows l % 128
constexpr int kGatherRows = 8;       // gather_taa: rows st0 & 7
constexpr int kStep = 17;            // fused_n: row i0 + 17 j
constexpr int kPar3Last = 33;        // par3, blend_par3: i0, +17, +33
constexpr int kWrite0 = 5;           // blend: writes at i0 + 5, i0 + 9
constexpr int kWrite1 = 9;
constexpr int ERR_ARGS = -1;         // a bad argument: nothing was launched

// select_chain: null; sel_n (n chained reads: each index waits on the
// last value read); par3 (reads i0, +17, +33, independent); fused_n (n
// independent reads i0 + 17 j); gather_taa (row st0 & 7 of the lane's
// 128-lane column).
enum { SEL_NULL = 0, SEL_CHAIN = 1, SEL_PAR3 = 2, SEL_FUSED = 3,
       SEL_GATHER = 4 };
// blend_chain: blend_par3 and fused_n with its blend (two writes, then n
// reads of the written table), blend_mask (a masked merge into one word,
// then its neighbour), blend_oldw (a write, then its two neighbours).
enum { BLEND_PAR3 = 0, BLEND_FUSED = 1, BLEND_MASK = 2, BLEND_OLDW = 3 };

LZM_FN int32_t clip_hi(int32_t v, int32_t hi) { return v > hi ? hi : v; }

// _idx_mix: clip((v * 40499) & mask, 0, R - 1); the and makes it >= 0.
LZM_FN int32_t mix(int32_t v, int32_t mask, int32_t R) {
  return clip_hi(wrap(uint32_t(v) * kMixMul) & mask, R - 1);
}

// The row offset of read j: par3's 0, 17, 33, or fused_n's 17 j.
template <bool kPar3>
LZM_FN constexpr int32_t offset(int j) {
  return kPar3 && j == 2 ? kPar3Last : kStep * j;
}

// The read-only probes for lane `lane` of L over x ([R, L], element T);
// st0: [4, L], the start; st: [4, L], the end (only slot 0 changes).
// Separate buffers: gather_taa's threads read another lane's start.
//   SEL_NULL:   st0 = (5 st0 + 1) & 0xFFFF
//   SEL_CHAIN:  acc = st0; for j < n: acc += x[clip(mix(st0) + j)];
//               st0 = acc & 0xFFFF
//   SEL_PAR3 / SEL_FUSED: st0 = (st0 + sum over j < n of
//               x[clip(mix(st0) + offset(j))]) & 0xFFFF
//   SEL_GATHER: v = x[c & 7] of lane l % 128, where c is that lane's st0;
//               st0 = (st0 + v) & 0xFFFF, and c likewise (each thread
//               carries lane l % 128's chain itself from its start: no
//               thread waits on another).
template <class T, int kMode, int kN>
LZM_FN void select_chain_lane(const T* x, int R, int L, int lane,
                              int32_t mask, const int32_t* st0, int32_t* st,
                              int iters) {
  const size_t sL = size_t(L);
  int32_t s0 = st0[lane];
  if (kMode == SEL_NULL) {
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) s0 = wrap(uint32_t(s0) * 5u + 1u) & 0xFFFF;
  } else if (kMode == SEL_CHAIN) {
    const T* col = x + lane;
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      uint32_t acc = uint32_t(s0);
      LZM_UNROLL(unroll)
      for (int j = 0; j < kN; ++j) {
        const int32_t idx = clip_hi(mix(s0, mask, R) + j, R - 1);
        acc += uint32_t(int32_t(col[idx * sL]));
        s0 = wrap(acc) & 0xFFFF;
      }
    }
  } else if (kMode == SEL_PAR3 || kMode == SEL_FUSED) {
    const T* col = x + lane;
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      const int32_t i0 = mix(s0, mask, R);
      uint32_t sum = uint32_t(s0);
      LZM_UNROLL(unroll)
      for (int j = 0; j < kN; ++j)
        sum += uint32_t(int32_t(
            col[clip_hi(i0 + offset<kMode == SEL_PAR3>(j), R - 1) * sL]));
      s0 = wrap(sum) & 0xFFFF;
    }
  } else {  // SEL_GATHER
    const int l0 = lane % kGatherLanes;
    const T* col = x + l0;
    int32_t c = st0[l0];
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      const uint32_t g = uint32_t(int32_t(col[(c & (kGatherRows - 1)) * sL]));
      s0 = wrap(uint32_t(s0) + g) & 0xFFFF;
      c = wrap(uint32_t(c) + g) & 0xFFFF;
    }
  }
  st[lane] = s0;
  for (int k = 1; k < 4; ++k) st[k * sL + lane] = st0[k * sL + lane];
}

// The probes that write the table, for lane `lane` of L over x ([R, L]
// int32, written in place: the caller's copy); st0: [4, L], the start;
// st: [4, L], the end (slot 3 unchanged). i0 = mix(st0, 1023, R).
//   BLEND_PAR3 / BLEND_FUSED: x[clip(i0 + 5)] = st1, then x[clip(i0 + 9)]
//               = st2 (the second wins where both clip to R - 1); v_j =
//               x[clip(i0 + offset(j))] for j < n; st0 = (st0 + sum v) &
//               0xFFFF; st1 = (old st1 + v_0) & 0x7FF; st2 = (old st2 +
//               v_{1 % n}) & 0x7FF
//   BLEND_MASK: t = x[i0]; x[i0] = t ^ ((t ^ st1) & (st2 | 0xFF)); w0 =
//               x[i0 + 1] (0 past the table); st0 = (st0 + w0) & 0xFFFF;
//               st1 = w0; st2 = (old st1 >> 8) & 0xFFFF
//   BLEND_OLDW: x[i0] = st1; w0 = x[i0 + 1], old = x[i0 + 2] (0 past the
//               table); st0 = (st0 + w0) & 0xFFFF; st1 = (old & -256) |
//               (w0 & 0xFF)
template <int kMode, int kN>
LZM_FN void blend_chain_lane(int32_t* x, int R, int L, int lane,
                             const int32_t* st0, int32_t* st, int iters) {
  const size_t sL = size_t(L);
  int32_t* col = x + lane;
  int32_t s0 = st0[lane], s1 = st0[sL + lane], s2 = st0[2 * sL + lane];
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    const int32_t i0 = mix(s0, 1023, R);
    if (kMode == BLEND_PAR3 || kMode == BLEND_FUSED) {
      col[clip_hi(i0 + kWrite0, R - 1) * sL] = s1;
      col[clip_hi(i0 + kWrite1, R - 1) * sL] = s2;
      int32_t v[kN];
      uint32_t sum = uint32_t(s0);
      LZM_UNROLL(unroll)
      for (int j = 0; j < kN; ++j) {
        v[j] = col[clip_hi(i0 + offset<kMode == BLEND_PAR3>(j), R - 1) * sL];
        sum += uint32_t(v[j]);
      }
      s0 = wrap(sum) & 0xFFFF;
      s1 = wrap(uint32_t(s1) + uint32_t(v[0])) & 0x7FF;
      s2 = wrap(uint32_t(s2) + uint32_t(v[1 % kN])) & 0x7FF;
    } else if (kMode == BLEND_MASK) {
      const int32_t t = col[i0 * sL];
      col[i0 * sL] = t ^ ((t ^ s1) & (s2 | 0xFF));
      const int32_t w0 = i0 + 1 < R ? col[(i0 + 1) * sL] : 0;
      s0 = wrap(uint32_t(s0) + uint32_t(w0)) & 0xFFFF;
      s2 = (s1 >> 8) & 0xFFFF;
      s1 = w0;
    } else {  // BLEND_OLDW
      col[i0 * sL] = s1;
      const int32_t w0 = i0 + 1 < R ? col[(i0 + 1) * sL] : 0;
      const int32_t old = i0 + 2 < R ? col[(i0 + 2) * sL] : 0;
      s0 = wrap(uint32_t(s0) + uint32_t(w0)) & 0xFFFF;
      s1 = (old & -256) | (w0 & 0xFF);
    }
  }
  st[lane] = s0;
  st[sL + lane] = s1;
  st[2 * sL + lane] = s2;
  st[3 * sL + lane] = st0[3 * sL + lane];
}

// Argument checks shared by the card's and the host's C interface: the
// modes and read counts each kernel is built for (the tool's rows).
// elem: the table's bytes per entry (4, or 2 and 1 for sel1 only).
// gather_taa needs 8 rows and whole 128-lane tiles.
LZM_FN bool bad_select(int mode, int n, int elem, int32_t mask, int R, int L,
                       int iters) {
  if (mode < SEL_NULL || mode > SEL_GATHER || R < 1 || L < 1 || iters < 0)
    return true;
  if (mask != 1023 && mask != 2047) return true;
  if (elem != 4 && !((elem == 2 || elem == 1) && mode == SEL_CHAIN && n == 1))
    return true;
  if (mode == SEL_GATHER && (R < kGatherRows || L % kGatherLanes)) return true;
  if (mode == SEL_CHAIN) return n < 1 || n > 4;
  return n != (mode == SEL_PAR3 || mode == SEL_FUSED ? 3 : 1);
}

// The blends need 10 rows (i0 + 9 inside the table).
LZM_FN bool bad_blend(int mode, int n, int R, int L, int iters) {
  if (mode < BLEND_PAR3 || mode > BLEND_OLDW || R < 10 || L < 1 || iters < 0)
    return true;
  if (mode == BLEND_FUSED) return n != 3 && n != 7;
  return n != (mode == BLEND_PAR3 ? 3 : 1);
}

}  // namespace lzr4

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_round4.cu's C interface as host loops over threads (tests only).
// The stream argument is ignored.
extern "C" {

int lzr4_select_chain(int mode, int n, int elem, const void* x, int R, int L,
                      int mask, const int32_t* st0, int32_t* st, int iters,
                      void* /*stream*/) {
  using namespace lzr4;
  if (bad_select(mode, n, elem, mask, R, L, iters)) return ERR_ARGS;
  const int32_t* x32 = static_cast<const int32_t*>(x);
  const int16_t* x16 = static_cast<const int16_t*>(x);
  const int8_t* x8 = static_cast<const int8_t*>(x);
  for (int l = 0; l < L; ++l) {
    const int key = elem == 4 ? mode * 16 + n : (elem == 2 ? 128 : 256) + n;
    switch (key) {
#define LZR4_SEL(k, T, xp, m, nn)                                         \
  case k:                                                                 \
    select_chain_lane<T, m, nn>(xp, R, L, l, mask, st0, st, iters);       \
    break;
      LZR4_SEL(SEL_NULL * 16 + 1, int32_t, x32, SEL_NULL, 1)
      LZR4_SEL(SEL_CHAIN * 16 + 1, int32_t, x32, SEL_CHAIN, 1)
      LZR4_SEL(SEL_CHAIN * 16 + 2, int32_t, x32, SEL_CHAIN, 2)
      LZR4_SEL(SEL_CHAIN * 16 + 3, int32_t, x32, SEL_CHAIN, 3)
      LZR4_SEL(SEL_CHAIN * 16 + 4, int32_t, x32, SEL_CHAIN, 4)
      LZR4_SEL(SEL_PAR3 * 16 + 3, int32_t, x32, SEL_PAR3, 3)
      LZR4_SEL(SEL_FUSED * 16 + 3, int32_t, x32, SEL_FUSED, 3)
      LZR4_SEL(SEL_GATHER * 16 + 1, int32_t, x32, SEL_GATHER, 1)
      LZR4_SEL(128 + 1, int16_t, x16, SEL_CHAIN, 1)
      LZR4_SEL(256 + 1, int8_t, x8, SEL_CHAIN, 1)
#undef LZR4_SEL
    }
  }
  return 0;
}

int lzr4_blend_chain(int mode, int n, int32_t* x, int R, int L,
                     const int32_t* st0, int32_t* st, int iters,
                     void* /*stream*/) {
  using namespace lzr4;
  if (bad_blend(mode, n, R, L, iters)) return ERR_ARGS;
  for (int l = 0; l < L; ++l) {
    switch (mode * 16 + n) {
#define LZR4_BLEND(m, nn)                                                 \
  case m * 16 + nn:                                                       \
    blend_chain_lane<m, nn>(x, R, L, l, st0, st, iters);                  \
    break;
      LZR4_BLEND(BLEND_PAR3, 3)
      LZR4_BLEND(BLEND_FUSED, 3)
      LZR4_BLEND(BLEND_FUSED, 7)
      LZR4_BLEND(BLEND_MASK, 1)
      LZR4_BLEND(BLEND_OLDW, 1)
#undef LZR4_BLEND
    }
  }
  return 0;
}

const char* lzr4_error_string(int code) {
  return code == lzr4::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_ROUND4_CUH_
