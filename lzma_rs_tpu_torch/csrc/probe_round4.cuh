// One block of each round4 probe kernel: the per-lane functions of the
// JAX package's Pallas probes tools/probe_round4.py, in scalar code, over
// the block's slice of the table in shared memory.
//
// Compiled for the card by probes_round4.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_round4.cu as host loops over blocks and threads
// (the same staging, lane and write-back code), so the logic is checked
// on the CPU against the plain PyTorch versions (ops/probes_round4.py).
//
// Every probe keeps a lane's state in four int32 slots st[0..3] (slot 0
// the seed, the output) and runs `iters` iterations over a lane-minor
// table x ([R, L]: row r of lane l at r L + l). An index is the probes'
// _idx_mix of slot 0: clip((st0 * 40499) & mask, 0, R - 1), the multiply
// wrapping in int32 (mask 1023, or 2047 for sel_s). Integer semantics are
// the probes': wrapping int32 (every add and multiply that can wrap is done
// in uint32_t and converted back) and an arithmetic >> of int32. A narrow
// table entry (int16, int8) is sign-extended to int32.
//
// A block is `lb` lanes (lanes_per_block) and holds their whole columns,
// [rows, lb] lane-minor (row r of the block's lane t at r lb + t), the
// TPU probes' VMEM scratch: the block stages its slice in, its lanes run
// their chains over it, and blend_chain writes it back.
#ifndef LZMA_RS_TPU_TORCH_PROBE_ROUND4_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_ROUND4_CUH_

#include <string.h>

#include "probe_mosaic.cuh"

namespace lzr4 {

using lzm::wrap;

constexpr int kMaxLanes = 32;         // lanes a block at most
constexpr int kThreads = 128;         // threads a block: they all stage the
                                      // slice, the first lb run the lanes
constexpr int kMaxShared = 232448;    // dynamic shared memory a block may
                                      // have on sm_90 (227 KB)
constexpr int kChunk = 16;            // bytes a staging copy moves
constexpr uint32_t kMixMul = 40499;   // _idx_mix's multiplier
constexpr int kGatherLanes = 128;     // gather_taa: lane l follows l % 128
constexpr int kGatherRows = 8;        // gather_taa: rows st0 & 7
constexpr int kStep = 17;             // fused_n: row i0 + 17 j
constexpr int kPar3Last = 33;         // par3, blend_par3: i0, +17, +33
constexpr int kWrite0 = 5;            // blend: writes at i0 + 5, i0 + 9
constexpr int kWrite1 = 9;
constexpr int ERR_ARGS = -1;          // a bad argument: nothing was launched

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

// Lanes a block: the largest power of two <= 32 whose columns of `rows`
// entries of `elem` bytes fit in kMaxShared; 0 when one column does not.
LZM_FN int lanes_per_block(int rows, int elem) {
  const long long col = static_cast<long long>(rows) * elem;
  int lb = kMaxLanes;
  while (lb > 0 && lb * col > kMaxShared) lb >>= 1;
  return lb;
}

// The table rows a select mode stages: none for null (it reads no
// table), gather's 8, else the whole column. blend_chain stages all R.
LZM_FN int staged_rows(int mode, int R) {
  return mode == SEL_NULL ? 0 : mode == SEL_GATHER ? kGatherRows : R;
}

// Dynamic shared memory of a block: rows x lb entries, in whole chunks.
LZM_FN size_t block_bytes(int rows, int lb, int elem) {
  return (size_t(rows) * lb * elem + kChunk - 1) / kChunk * kChunk;
}

// A block's slice: rows [0, rows) of the nl columns from lane0 of a table
// of L lanes, held as [rows, lb].
struct Slice {
  int rows, lb, L, lane0, nl;
};

// Block `b`'s slice: its own lanes' columns, or for gather the columns
// of lane % 128 (128 % lb == 0 and L % 128 == 0, so they are lb
// neighbours).
LZM_FN Slice select_slice(int mode, int R, int L, int b, int lb) {
  const int lane0 = b * lb;
  if (mode == SEL_GATHER) return {kGatherRows, lb, L, lane0 % kGatherLanes,
                                  lb};
  return {staged_rows(mode, R), lb, L, lane0,
          L - lane0 < lb ? L - lane0 : lb};
}

LZM_FN Slice blend_slice(int R, int L, int b, int lb) {
  const int lane0 = b * lb;
  return {R, lb, L, lane0, L - lane0 < lb ? L - lane0 : lb};
}

// Whether the slice moves in 16-byte chunks: whole rows of lb entries
// that are whole chunks, at 16-byte aligned addresses on both sides.
template <class T>
LZM_FN bool chunked(const T* x, const Slice& s) {
  return s.nl == s.lb && (s.lb * sizeof(T)) % kChunk == 0 &&
         (size_t(s.L) * sizeof(T)) % kChunk == 0 &&
         reinterpret_cast<uintptr_t>(x + s.lane0) % kChunk == 0;
}

// One chunk from the table into the slice: cp.async on the card (the
// block waits in stage_in), a copy on the host.
LZM_FN void chunk_in(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, kChunk);
#endif
}

LZM_FN void chunk_out(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#else
  memcpy(dst, src, kChunk);
#endif
}

// log2 of a power of two.
LZM_FN int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// Thread `tid` of `nt` copies its share of slice `s` of x into sm: in
// chunks, row by row (neighbouring threads on neighbouring chunks), or
// entry by entry where chunked() does not hold (a part-filled block,
// unaligned rows). Returns once this thread's copies have landed; the
// block then meets at a barrier.
template <class T>
LZM_FN void stage_in(T* sm, const T* x, const Slice& s, int tid, int nt) {
  if (chunked(x, s)) {
    const int per_row = s.lb * int(sizeof(T)) / kChunk;
    const int sh = log2_of(per_row), n = s.rows * per_row;
    for (int i = tid; i < n; i += nt) {
      const int r = i >> sh, c = i & (per_row - 1);
      chunk_in(reinterpret_cast<char*>(sm + r * s.lb) + c * kChunk,
               reinterpret_cast<const char*>(x + size_t(r) * s.L + s.lane0) +
                   c * kChunk);
    }
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  } else {
    const int sh = log2_of(s.lb), n = s.rows * s.lb;
    for (int i = tid; i < n; i += nt) {
      const int r = i >> sh, t = i & (s.lb - 1);
      if (t < s.nl) sm[i] = x[size_t(r) * s.L + s.lane0 + t];
    }
  }
}

// The way back: thread `tid` of `nt` writes its share of the slice into
// x, after the block's barrier.
template <class T>
LZM_FN void stage_out(T* x, const T* sm, const Slice& s, int tid, int nt) {
  if (chunked(x, s)) {
    const int per_row = s.lb * int(sizeof(T)) / kChunk;
    const int sh = log2_of(per_row), n = s.rows * per_row;
    for (int i = tid; i < n; i += nt) {
      const int r = i >> sh, c = i & (per_row - 1);
      chunk_out(reinterpret_cast<char*>(x + size_t(r) * s.L + s.lane0) +
                    c * kChunk,
                reinterpret_cast<const char*>(sm + r * s.lb) + c * kChunk);
    }
  } else {
    const int sh = log2_of(s.lb), n = s.rows * s.lb;
    for (int i = tid; i < n; i += nt) {
      const int r = i >> sh, t = i & (s.lb - 1);
      if (t < s.nl) x[size_t(r) * s.L + s.lane0 + t] = sm[i];
    }
  }
}

LZM_FN int32_t clip_hi(int32_t v, int32_t hi) { return v > hi ? hi : v; }

// Row `idx` of a column whose rows lie `sb` bytes apart: one multiply-add
// makes the address.
template <class T>
LZM_FN const T& at(const T* col, int32_t idx, int sb) {
  return *reinterpret_cast<const T*>(reinterpret_cast<const char*>(col) +
                                     idx * sb);
}

LZM_FN int32_t& at(int32_t* col, int32_t idx, int sb) {
  return *reinterpret_cast<int32_t*>(reinterpret_cast<char*>(col) +
                                     idx * sb);
}

// _idx_mix: clip((v * 40499) & mask, 0, R - 1); the and makes it >= 0.
LZM_FN int32_t mix(int32_t v, int32_t mask, int32_t R) {
  return clip_hi(wrap(uint32_t(v) * kMixMul) & mask, R - 1);
}

// The row offset of read j: par3's 0, 17, 33, or fused_n's 17 j.
template <bool kPar3>
LZM_FN constexpr int32_t offset(int j) {
  return kPar3 && j == 2 ? kPar3Last : kStep * j;
}

// The read-only probes for lane `lane` of L, over its column `col` of
// the slice (rows `sb` bytes apart, the slice's lb entries; for gather,
// the column of lane % 128), element T; st0: [4, L], the start; st: [4,
// L], the end (only slot 0 changes). Separate buffers: gather_taa's
// threads read another lane's start.
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
LZM_FN void select_chain_lane(const T* col, int sb, int R, int L,
                              int lane, int32_t mask, const int32_t* st0,
                              int32_t* st, int iters) {
  const size_t sL = size_t(L);
  int32_t s0 = st0[lane];
  if (kMode == SEL_NULL) {
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) s0 = wrap(uint32_t(s0) * 5u + 1u) & 0xFFFF;
  } else if (kMode == SEL_CHAIN) {
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      uint32_t acc = uint32_t(s0);
      LZM_UNROLL(unroll)
      for (int j = 0; j < kN; ++j) {
        const int32_t idx = clip_hi(mix(s0, mask, R) + j, R - 1);
        acc += uint32_t(int32_t(at(col, idx, sb)));
        s0 = wrap(acc) & 0xFFFF;
      }
    }
  } else if (kMode == SEL_PAR3 || kMode == SEL_FUSED) {
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      const int32_t i0 = mix(s0, mask, R);
      uint32_t sum = uint32_t(s0);
      LZM_UNROLL(unroll)
      for (int j = 0; j < kN; ++j)
        sum += uint32_t(int32_t(
            at(col, clip_hi(i0 + offset<kMode == SEL_PAR3>(j), R - 1), sb)));
      s0 = wrap(sum) & 0xFFFF;
    }
  } else {  // SEL_GATHER
    int32_t c = st0[lane % kGatherLanes];
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      const uint32_t g =
          uint32_t(int32_t(at(col, c & (kGatherRows - 1), sb)));
      s0 = wrap(uint32_t(s0) + g) & 0xFFFF;
      c = wrap(uint32_t(c) + g) & 0xFFFF;
    }
  }
  st[lane] = s0;
  for (int k = 1; k < 4; ++k) st[k * sL + lane] = st0[k * sL + lane];
}

// The probes that write the table, for lane `lane` of L over its column
// `col` of the slice (int32, rows `sb` bytes apart, written in place;
// the block writes it back); st0: [4, L], the start; st: [4, L], the end
// (slot 3 unchanged). i0 = mix(st0, 1023, R).
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
LZM_FN void blend_chain_lane(int32_t* col, int sb, int R, int L,
                             int lane, const int32_t* st0, int32_t* st,
                             int iters) {
  const size_t sL = size_t(L);
  int32_t s0 = st0[lane], s1 = st0[sL + lane], s2 = st0[2 * sL + lane];
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    const int32_t i0 = mix(s0, 1023, R);
    if (kMode == BLEND_PAR3 || kMode == BLEND_FUSED) {
      at(col, clip_hi(i0 + kWrite0, R - 1), sb) = s1;
      at(col, clip_hi(i0 + kWrite1, R - 1), sb) = s2;
      int32_t v[kN];
      uint32_t sum = uint32_t(s0);
      LZM_UNROLL(unroll)
      for (int j = 0; j < kN; ++j) {
        v[j] = at(col, clip_hi(i0 + offset<kMode == BLEND_PAR3>(j), R - 1),
                  sb);
        sum += uint32_t(v[j]);
      }
      s0 = wrap(sum) & 0xFFFF;
      s1 = wrap(uint32_t(s1) + uint32_t(v[0])) & 0x7FF;
      s2 = wrap(uint32_t(s2) + uint32_t(v[1 % kN])) & 0x7FF;
    } else if (kMode == BLEND_MASK) {
      const int32_t t = at(col, i0, sb);
      at(col, i0, sb) = t ^ ((t ^ s1) & (s2 | 0xFF));
      const int32_t w0 = i0 + 1 < R ? at(col, i0 + 1, sb) : 0;
      s0 = wrap(uint32_t(s0) + uint32_t(w0)) & 0xFFFF;
      s2 = (s1 >> 8) & 0xFFFF;
      s1 = w0;
    } else {  // BLEND_OLDW
      at(col, i0, sb) = s1;
      const int32_t w0 = i0 + 1 < R ? at(col, i0 + 1, sb) : 0;
      const int32_t old = i0 + 2 < R ? at(col, i0 + 2, sb) : 0;
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
// modes and read counts each kernel is built for (the tool's rows), and a
// staged column that fits a block's shared memory.
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
  if (lanes_per_block(staged_rows(mode, R), elem) == 0) return true;
  if (mode == SEL_CHAIN) return n < 1 || n > 4;
  return n != (mode == SEL_PAR3 || mode == SEL_FUSED ? 3 : 1);
}

// The blends need 10 rows (i0 + 9 inside the table).
LZM_FN bool bad_blend(int mode, int n, int R, int L, int iters) {
  if (mode < BLEND_PAR3 || mode > BLEND_OLDW || R < 10 || L < 1 || iters < 0)
    return true;
  if (lanes_per_block(R, 4) == 0) return true;
  if (mode == BLEND_FUSED) return n != 3 && n != 7;
  return n != (mode == BLEND_PAR3 ? 3 : 1);
}

// The builds, as types: the element, the mode and the read count.
template <class T, int kMode, int kN>
struct Build {
  using Elem = T;
  static constexpr int mode = kMode, n = kN;
};

// f(Build<...>{}) for the select build of (mode, n, elem), or ERR_ARGS.
template <class F>
int with_select(int mode, int n, int elem, F&& f) {
  const int key = elem == 4 ? mode * 16 + n : (elem == 2 ? 128 : 256) + n;
  switch (key) {
    case SEL_NULL * 16 + 1: return f(Build<int32_t, SEL_NULL, 1>{});
    case SEL_CHAIN * 16 + 1: return f(Build<int32_t, SEL_CHAIN, 1>{});
    case SEL_CHAIN * 16 + 2: return f(Build<int32_t, SEL_CHAIN, 2>{});
    case SEL_CHAIN * 16 + 3: return f(Build<int32_t, SEL_CHAIN, 3>{});
    case SEL_CHAIN * 16 + 4: return f(Build<int32_t, SEL_CHAIN, 4>{});
    case SEL_PAR3 * 16 + 3: return f(Build<int32_t, SEL_PAR3, 3>{});
    case SEL_FUSED * 16 + 3: return f(Build<int32_t, SEL_FUSED, 3>{});
    case SEL_GATHER * 16 + 1: return f(Build<int32_t, SEL_GATHER, 1>{});
    case 128 + 1: return f(Build<int16_t, SEL_CHAIN, 1>{});
    case 256 + 1: return f(Build<int8_t, SEL_CHAIN, 1>{});
  }
  return ERR_ARGS;
}

// f(Build<int32_t, mode, n>{}) for the blend build of (mode, n), or
// ERR_ARGS.
template <class F>
int with_blend(int mode, int n, F&& f) {
  switch (mode * 16 + n) {
    case BLEND_PAR3 * 16 + 3: return f(Build<int32_t, BLEND_PAR3, 3>{});
    case BLEND_FUSED * 16 + 3: return f(Build<int32_t, BLEND_FUSED, 3>{});
    case BLEND_FUSED * 16 + 7: return f(Build<int32_t, BLEND_FUSED, 7>{});
    case BLEND_MASK * 16 + 1: return f(Build<int32_t, BLEND_MASK, 1>{});
    case BLEND_OLDW * 16 + 1: return f(Build<int32_t, BLEND_OLDW, 1>{});
  }
  return ERR_ARGS;
}

}  // namespace lzr4

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
#include <vector>

// probes_round4.cu's C interface as host loops over blocks and their
// threads (tests only): each block stages its slice into a buffer of
// stride lb, runs its lanes over it and (blend) writes it back. The
// stream argument is ignored.
extern "C" {

int lzr4_lanes_per_block(int rows, int elem) {
  return lzr4::lanes_per_block(rows, elem);
}

// The table rows a select mode stages (blend_chain stages all R).
int lzr4_staged_rows(int mode, int R) { return lzr4::staged_rows(mode, R); }

// A block's dynamic shared memory for `rows` x `lb` entries of `elem`
// bytes.
long long lzr4_block_bytes(int rows, int lb, int elem) {
  return static_cast<long long>(lzr4::block_bytes(rows, lb, elem));
}

int lzr4_select_chain(int mode, int n, int elem, const void* x, int R, int L,
                      int mask, const int32_t* st0, int32_t* st, int iters,
                      void* /*stream*/) {
  using namespace lzr4;
  if (bad_select(mode, n, elem, mask, R, L, iters)) return ERR_ARGS;
  return with_select(mode, n, elem, [&](auto build) {
    using B = decltype(build);
    using T = typename B::Elem;
    const T* xt = static_cast<const T*>(x);
    const int lb = lanes_per_block(staged_rows(B::mode, R), sizeof(T));
    std::vector<T> sm(size_t(staged_rows(B::mode, R)) * lb);
    for (int b = 0; b * lb < L; ++b) {
      const Slice s = select_slice(B::mode, R, L, b, lb);
      stage_in(sm.data(), xt, s, 0, 1);
      for (int t = 0; t < lb && b * lb + t < L; ++t)
        select_chain_lane<T, B::mode, B::n>(sm.data() + t,
                                            lb * int(sizeof(T)), R, L,
                                            b * lb + t, mask, st0, st,
                                            iters);
    }
    return 0;
  });
}

int lzr4_blend_chain(int mode, int n, int32_t* x, int R, int L,
                     const int32_t* st0, int32_t* st, int iters,
                     void* /*stream*/) {
  using namespace lzr4;
  if (bad_blend(mode, n, R, L, iters)) return ERR_ARGS;
  return with_blend(mode, n, [&](auto build) {
    using B = decltype(build);
    const int lb = lanes_per_block(R, 4);
    std::vector<int32_t> sm(size_t(R) * lb);
    for (int b = 0; b * lb < L; ++b) {
      const Slice s = blend_slice(R, L, b, lb);
      stage_in(sm.data(), x, s, 0, 1);
      for (int t = 0; t < s.nl; ++t)
        blend_chain_lane<B::mode, B::n>(sm.data() + t, lb * 4, R, L,
                                        b * lb + t, st0, st, iters);
      stage_out(x, sm.data(), s, 0, 1);
    }
    return 0;
  });
}

const char* lzr4_error_string(int code) {
  return code == lzr4::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_ROUND4_CUH_
