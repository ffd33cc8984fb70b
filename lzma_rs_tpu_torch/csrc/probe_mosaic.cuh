// One thread of each mosaic probe kernel, one rank of gather_sum's group
// and one block of p5's: the per-lane functions of the JAX package's
// Pallas probes tools/probe_mosaic.py and tools/probe_mosaic2.py, in scalar
// code.
//
// Compiled for the card by probes_mosaic.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_mosaic.cu as host loops over threads (gather_sum:
// over each output's ranks, their partial sums added in rank order; D:
// over each row's 32 ranks in turn; p5: over blocks, warps and their 32
// ranks, with the same staging, step and combine code; row_chain: p6's
// staging then its lanes, p1-p3's ranks then their block's sum), so the
// logic is checked on the CPU against the plain PyTorch versions
// (ops/probes_mosaic.py).
//
// Integer semantics are the probes': wrapping int32 (and uint8 for the
// gather's u8 row). Every add and multiply that can wrap is done in
// uint32_t and converted back (modular on g++ and nvcc, and defined so
// from C++20). An index is jnp's `%` of a wrapped int32: the floor mod of
// the wrapped value (floor_mod), not C's truncating `%` of the unwrapped
// sum; `& (W - 1)` (row A) is the same function because W is a power of
// two there.
#ifndef LZMA_RS_TPU_TORCH_PROBE_MOSAIC_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_MOSAIC_CUH_

#include <stddef.h>
#include <stdint.h>

#include "probe_stage.cuh"  // LZM_FN, LZM_UNROLL; P6's staging

namespace lzm {

constexpr int kBlock = 128;        // threads per block
constexpr int kScalarStride = 37;  // row E: j = 37 i % W
constexpr int ERR_ARGS = -1;       // a bad argument: nothing was launched
constexpr int kMaxShared = 232448; // a block's shared memory at most (227 KB)
// E's block: its threads stage the row into shared memory and back; the
// row is at most kScalarMaxCols words
constexpr int kScalarThreads = 256;
constexpr int kScalarMaxCols = kMaxShared / 4;
static_assert((-64 >> 5) == -2, "needs an arithmetic >> of int32");

// gather_sum's axis: the output element (r, c) reads along its row
// (minor: x[r, k]) or along its column (major: x[k, c]).
enum { AXIS_MINOR = 0, AXIS_MAJOR = 1 };
enum { ELEM_I32 = 0, ELEM_U8 = 1 };           // gather_sum's element type
enum { RW_ROWS = 0, RW_SCALAR = 1 };          // rw_chain: D, E
enum { ROW_CLAMP = 0, ROW_CLAMP_WRITE = 1, ROW_BYTE = 2 };  // row_chain
enum { SEG_REFILL = 0, SEG_SEGMENTS = 1 };    // segment_chain: p4, p5

LZM_FN int32_t wrap(uint32_t v) { return static_cast<int32_t>(v); }

// jnp's `a % m` for m > 0: the floor mod.
LZM_FN int32_t floor_mod(int32_t a, int32_t m) {
  const int32_t r = a % m;
  return r < 0 ? r + m : r;
}

LZM_FN bool pow2(int32_t m) { return m > 0 && (m & (m - 1)) == 0; }

// jnp's s % m of a wrapped int32 s (m > 0): an and where m is a power of
// two (kPow2), else the floor mod, an integer division.
template <bool kPow2>
LZM_FN int32_t index_mod(int32_t s, int32_t m) {
  return kPow2 ? s & (m - 1) : floor_mod(s, m);
}

// walk(start, stride, i, mod) below names the i-th index of a walk from
// `start` by `stride`: floor_mod(wrap(start + stride i), mod), the sum
// wrapped to int32, then the floor mod.

// A, B, C, F: out[e] sums, over `iters` steps i, x at walk(start[e],
// stride, i, mod) along one line of x ([rows, cols], row-major): row
// `line` (minor) or column `line` (major). The sum wraps in T (uint8 or
// int32). The loads are independent of each other; only the sum carries,
// and a wrapping add gives the same bits in any order. So an output's
// steps are split over a group of G threads: rank r of the group takes
// steps r, r + G, r + 2 G, ..., and the group's partial sums are added
// (on the card a warp's __reduce_add_sync; the uint8 sum is the low byte
// of the uint32 one).
//
// The split is a function of the row's shape (gather_group), set by
// measuring each row both ways on the H100 (PERF.md): a warp an
// output (kGatherWarp) along the minor axis, where a warp's 32 reads of a
// step are 32 neighbouring words of one row and coalesce, and along the
// major axis below kGatherThreadMin outputs (B [8, 128], F: 1,024 and 128
// outputs); a thread an output on the major axis from there (B [64, 128],
// B [512, 128]: a warp's threads are 32 columns of one row of outputs,
// whose reads coalesce where their rows agree). Blocks (gather_block): a
// warp a block below kGatherSpread outputs, so C's and F's 128 outputs run
// on 128 SMs, not one; otherwise kBlock threads a block for a warp an
// output and one warp a block for a thread an output (B [512, 128] on
// random rows ran faster so).
constexpr int kGatherWarp = 32;
constexpr int kGatherThreadMin = 4096;
constexpr int kGatherSpread = 1024;

LZM_FN int gather_group(int axis, int n_out) {
  return axis == AXIS_MAJOR && n_out >= kGatherThreadMin ? 1 : kGatherWarp;
}

LZM_FN int gather_block(int group, int n_out) {
  return group == kGatherWarp && n_out >= kGatherSpread ? kBlock
                                                         : kGatherWarp;
}

LZM_FN int gather_blocks(int group, int n_out) {
  const int block = gather_block(group, n_out);
  return int(((long long)(n_out) * group + block - 1) / block);
}

// The steps that rank r of a group of G takes of `iters`.
LZM_FN int gather_count(int r, int G, int iters) {
  return r < iters ? (iters - r + G - 1) / G : 0;
}

// Rank r walks from wrap(start + stride r) by S = wrap(stride G).
LZM_FN int32_t gather_first(int32_t start, int32_t stride, int r) {
  return wrap(uint32_t(start) + uint32_t(stride) * uint32_t(r));
}

LZM_FN int32_t gather_stride(int32_t stride, int G) {
  return wrap(uint32_t(stride) * uint32_t(G));
}

// The reads of a walk from v by S that stay inside int32 before it wraps:
// count, or fewer (at least 1 where count is). Between wraps v + S j is
// the integer sum, so floor_mod(v + S j, mod) advances by floor_mod(S,
// mod) a read.
LZM_FN int no_wrap_reads(int32_t v, int32_t S, int count) {
  if (S == 0) return count;
  const uint32_t room = S > 0 ? 0x7FFFFFFFu - uint32_t(v)
                              : uint32_t(v) - 0x80000000u;
  const uint32_t mag = S > 0 ? uint32_t(S) : 0u - uint32_t(S);
  if (uint64_t(mag) * uint64_t(count - 1) <= room) return count;
  return int(room / mag) + 1;
}

// floor_mod(v + S, mod) from k = floor_mod(v, mod) and step =
// floor_mod(S, mod), where v + S does not wrap: k + step less mod where
// that is smaller (k + step < 2 mod <= 2^32, so the sum does not wrap).
// The same on k, step and mod scaled by a row pitch.
LZM_FN uint32_t next_index(uint32_t k, uint32_t step, uint32_t mod) {
  const uint32_t n = k + step, w = n - mod;
  return w < n ? w : n;
}

// One rank's partial sum: `count` reads of line `line` at the walk from
// v by S, whose index steps by step = floor_mod(S, mod) (the launch's, the
// same for every rank): the element offset (the index times the line's
// pitch, below rows x cols < 2^31) steps by an add and a conditional
// subtract. floor_mod's integer divide runs at the walk's start and after
// each int32 wrap only (none on most walks, one every read or two where
// |S| nears 2^31). The line's first element is held in a register (an
// empty asm): left to itself nvcc rebuilt each read's 64-bit address from
// the line and the row length, two instructions more a read.
template <int kAxis, class T>
LZM_FN uint32_t gather_part(const T* x, int cols, int line, int32_t v,
                            int32_t S, uint32_t step, int32_t mod,
                            int count) {
  const T* base = kAxis == AXIS_MINOR ? x + size_t(line) * cols : x + line;
#if defined(__CUDA_ARCH__)
  asm("" : "+l"(base));
#endif
  const uint32_t pitch = kAxis == AXIS_MINOR ? 1u : uint32_t(cols);
  const uint32_t step_p = step * pitch, mod_p = uint32_t(mod) * pitch;
  uint32_t acc = 0;
  while (count > 0) {
    const int run = no_wrap_reads(v, S, count);
    uint32_t q = uint32_t(floor_mod(v, mod)) * pitch;
    LZM_UNROLL(unroll 4)
    for (int j = 0; j < run; ++j) {
      acc += uint32_t(base[q]);
      q = next_index(q, step_p, mod_p);
    }
    v = wrap(uint32_t(v) + uint32_t(S) * uint32_t(run));
    count -= run;
  }
  return acc;
}

// The line of x that output e reads: its row (minor) or its column
// (major).
template <int kAxis>
LZM_FN int gather_line(int e, int out_cols) {
  return kAxis == AXIS_MINOR ? e / out_cols : e % out_cols;
}

// D: `iters` read-modify-writes of each row: x[r, walk(start[r], 1, i,
// cols)] += 1. The addresses do not depend on the data and a wrapping add
// commutes, so the adds may land in any order, and two that hit one word
// (iters > cols, or cols < 32) give its sum either way. So a row's steps
// are split over a warp as gather_sum splits an output's (kGatherWarp
// ranks, rank r taking steps r, r + 32, ...; the launch is gather_sum's for
// as many outputs as rows: a warp a block below kGatherSpread rows, so the
// probe's 128 rows run on 128 SMs), and each step is an atomic add whose
// result is not read (RED on the card; on the host the ranks run in turn).
// A warp's 32 adds of a step are 32 neighbouring words of the row and
// coalesce. The index steps by an add and a conditional subtract, the
// divide only at a walk's start and its int32 wraps (gather_part).
LZM_FN void add_one(int32_t* p) {
#if defined(__CUDA_ARCH__)
  atomicAdd(reinterpret_cast<unsigned int*>(p), 1u);
#else
  *p = wrap(uint32_t(*p) + 1u);
#endif
}

// One rank's `count` adds along `row`, at the walk from v by S whose index
// steps by step = floor_mod(S, mod).
LZM_FN void rw_part(int32_t* row, int32_t v, int32_t S, uint32_t step,
                    int32_t mod, int count) {
#if defined(__CUDA_ARCH__)
  asm("" : "+l"(row));
#endif
  while (count > 0) {
    const int run = no_wrap_reads(v, S, count);
    uint32_t q = uint32_t(floor_mod(v, mod));
    LZM_UNROLL(unroll 4)
    for (int j = 0; j < run; ++j) {
      add_one(row + q);
      q = next_index(q, step, uint32_t(mod));
    }
    v = wrap(uint32_t(v) + uint32_t(S) * uint32_t(run));
    count -= run;
  }
}

// Rank r (of kGatherWarp) of row `row`'s warp: its steps of the row's walk
// from `start` by 1; step = floor_mod(kGatherWarp, cols), the launch's.
LZM_FN void rw_rank(int32_t* row, int cols, int32_t start, uint32_t step,
                    int r, int iters) {
  const int count = gather_count(r, kGatherWarp, iters);
  if (count > 0)
    rw_part(row, gather_first(start, 1, r), gather_stride(1, kGatherWarp),
            step, cols, count);
}

// E: one serial chain, j = 37 i % W; v = x[j]; x[(j + 1) % W] = v + carry;
// carry += v, over the row in a block's shared memory (so W is at most
// kScalarMaxCols words); returns carry. The chain of carries is what the
// probe prices and stays serial, but the load addresses do not depend on
// the data, so each iteration's load is issued kScalarAhead iterations
// early, after the store of the iteration that issues it. A load issued so
// misses the stores of the kScalarAhead - 1 iterations between; when its
// word is one of theirs (j_i = j_m + 1 mod W for m in i - kScalarAhead + 1
// .. i - 1: 37 d = 1 mod W for a d below kScalarAhead, as at W = 36, 73 or
// 110), the newest such store's word is taken from registers instead. The
// word stored at iteration m is carry after it, so a match costs a select
// on the chain, and an iteration's chain is that select and carry's add.
// Loads, stores and their indices sit in slot i % kScalarAhead of small
// arrays; the loop runs kScalarAhead iterations a pass, so every slot is a
// constant and the arrays stay in registers.
constexpr int kScalarAhead = 4;
constexpr uint32_t kNoStore = 0xFFFFFFFFu;  // a slot before the first store

// The walk of E: v = wrap(37 n) and j = floor_mod(v, W), to n + 1: an add
// and a conditional subtract, the divide only where 37 n wraps int32.
// kMayWrap false leaves the wrap's test out: a pass of kScalarAhead steps
// that cannot wrap (may_wrap) is then one block of straight-line code,
// which the compiler can schedule across steps (a test and branch in each
// step kept each step's instructions behind the last one's: 54 cycles an
// iteration on the H100).
struct ScalarWalk {
  int32_t v;
  uint32_t j;
  template <bool kMayWrap>
  LZM_FN void next(uint32_t step, int32_t W) {
    const int32_t n = wrap(uint32_t(v) + uint32_t(kScalarStride));
    if (kMayWrap && n < v)
      j = uint32_t(floor_mod(n, W));
    else
      j = next_index(j, step, uint32_t(W));
    v = n;
  }
  // Whether 37 n may wrap in the next kScalarAhead steps.
  LZM_FN bool may_wrap() const {
    return v > INT32_MAX - kScalarStride * kScalarAhead;
  }
};

struct ScalarSlots {
  uint32_t lj[kScalarAhead];  // the index of the load in the slot
  uint32_t lw[kScalarAhead];  // its word, as loaded
  uint32_t sj[kScalarAhead];  // the index of the store in the slot
  uint32_t sw[kScalarAhead];  // its word (carry after it)
};

// Iteration i (s = i % kScalarAhead, a constant once the caller's loop
// is unrolled) of E: its word (the slot's load, or the newest pending
// store to its index), carry's add and the store; then the load of
// iteration i + kScalarAhead into the slot.
template <bool kMayWrap>
LZM_FN void scalar_step(int32_t* x, int32_t W, uint32_t step, ScalarSlots& q,
                        ScalarWalk& w, uint32_t& carry, int s) {
  constexpr int K = kScalarAhead;
  uint32_t v = q.lw[s];
  LZM_UNROLL(unroll)
  for (int t = 1; t < K; ++t) {  // stores i - K + 1 .. i - 1, oldest first
    const int m = (s + t) % K;
    v = q.sj[m] == q.lj[s] ? q.sw[m] : v;
  }
  carry += v;
  const uint32_t a = q.lj[s] + 1u == uint32_t(W) ? 0u : q.lj[s] + 1u;
  x[a] = wrap(carry);
  q.sj[s] = a;
  q.sw[s] = carry;
  q.lj[s] = w.j;
  q.lw[s] = uint32_t(x[w.j]);
  w.template next<kMayWrap>(step, W);
}

// The probe's walk starts at v0 = 0, where 37 n first wraps after ~58 M
// iterations; the host build's tests start it near INT32_MAX
// (lzm_rw_scalar_from) so that it wraps within a few.
LZM_FN int32_t rw_scalar(int32_t* x, int cols, int iters, int32_t v0 = 0) {
  constexpr int K = kScalarAhead;
  const uint32_t step = uint32_t(floor_mod(kScalarStride, cols));
  ScalarSlots q;
  ScalarWalk w{v0, uint32_t(floor_mod(v0, cols))};
  LZM_UNROLL(unroll)
  for (int s = 0; s < K; ++s) {  // the loads of iterations 0 .. K - 1
    q.sj[s] = kNoStore;
    q.sw[s] = 0;
    q.lj[s] = w.j;
    q.lw[s] = uint32_t(x[w.j]);
    w.next<true>(step, cols);
  }
  uint32_t carry = 0;
  int i = 0;
  LZM_UNROLL(unroll 1)
  for (; iters - i >= K; i += K) {
    if (w.may_wrap()) {
      LZM_UNROLL(unroll)
      for (int s = 0; s < K; ++s)
        scalar_step<true>(x, cols, step, q, w, carry, s);
    } else {
      LZM_UNROLL(unroll)
      for (int s = 0; s < K; ++s)
        scalar_step<false>(x, cols, step, q, w, carry, s);
    }
  }
  LZM_UNROLL(unroll)
  for (int s = 0; s < K; ++s)
    if (s < iters - i) scalar_step<true>(x, cols, step, q, w, carry, s);
  return wrap(carry);
}

// row_chain: p1/p2, p3, p6 on a lane-minor table x ([W, L]), each lane
// from the probes' idx = acc = 0; state: [2, L], acc then idx, written.
//   ROW_CLAMP:       v = max(x[idx], 0); acc += v; idx = (idx + 1) % W
//   ROW_CLAMP_WRITE: the same, and x[idx] = v + 1 where v is odd (into the
//                    output table: x is not changed)
//   ROW_BYTE:        word = x[idx >> 2]; byte = word >> 8 (idx & 3) & 0xFF;
//                    acc += byte; idx = (idx + byte + 1) % W
//
// p6 (ROW_BYTE): each load's row waits on the byte before it, so a lane's
// steps stay one serial chain, a thread a lane. idx < W, so the walk
// reaches rows [0, byte_rows(W)) only: a block of kRowThreads stages that
// quarter of its lanes' columns into shared memory (probe_stage.cuh:
// stage_minor, lane-minor, 16-byte cp.async), meets once at a barrier,
// and its first threads run the chains there. A step is a dependent
// ld.shared through a base in a register, the shift, the and, acc's add,
// idx + byte + 1 and the mod (an and where W is a power of two, else the
// floor mod); idx + byte + 1 < W + 256 does not wrap, since a lane's
// rows must fit a block's shared memory (W <= kByteMaxW). Lanes a block:
// kByteLanes (16: 8, 16 and 32 took the same time within 0.2 us on the
// H100), halved while the slice exceeds lzs::kSliceBytes (byte_lanes).
//
// p1-p3: the probes start at idx = 0, so step i reads row i % W: the
// addresses do not depend on the data. A block of kRowThreads takes
// kRowLanes lanes (a row's 8 lanes fill a 32-byte sector), thread t rank
// t / kRowLanes of kRowRanks of lane t % kRowLanes. Rank r owns rows r,
// r + kRowRanks, ... of the rows [0, min(W, iters)) the walk visits, and
// walks each owned row's visits i = j, j + W, ... < iters in step order
// (row_rank), so p3's write and its later reads of a row stay in one
// thread, in registers; the split is by row, not by step, and p3 stays
// exact when iters > W. The ranks' partial sums meet by shuffles inside a
// warp, then through shared memory (a wrapping add: the order is free);
// idx ends at iters % W. p3 writes its table into the output: each owned
// visited row after its visits, and the unvisited rows [min(W, iters), W)
// copied in ranges of about kCopyRows rows, one a block of the lane
// group's copy_blocks (the grid's y; block 0 also sums: a 1 MiB table on
// 16 blocks took 3.7 us more than p1 on the H100), by row_copy: 16-byte
// chunks where the group is whole and aligned, else word by word.
constexpr int kRowThreads = 256;
constexpr int kRowLanes = 8;
constexpr int kRowRanks = kRowThreads / kRowLanes;  // 32
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kByteLanes = 16;
constexpr int kByteMaxRows = kMaxShared / 4;        // 58,112
constexpr int kByteMaxW = 4 * kByteMaxRows;         // 232,448
constexpr int kCopyRun = 8;                         // chunks in flight
constexpr int kCopyRows = 256;                      // p3: rows a copy block
constexpr int kMaxCopyBlocks = 65535;               // the grid's y at most
static_assert(32 % kRowLanes == 0 && kRowLanes % 4 == 0,
              "whole groups in a warp, whole chunks in a row");

// The rows p6's walk can reach, and its lanes a block.
LZM_FN int byte_rows(int W) { return (W + 3) / 4; }
LZM_FN int byte_lanes(int W) {
  return lzs::lanes_per_block(byte_rows(W), kByteLanes);
}

// p6, one lane: its column's rows [0, byte_rows(W)) in shared memory from
// byte `col`, rows `sb` bytes apart.
template <bool kPow2>
LZM_FN void byte_chain_lane(const lzs::Shared& sm, uint32_t col, uint32_t sb,
                            int32_t W, int iters, uint32_t& acc_out,
                            int32_t& idx_out) {
  uint32_t acc = 0;
  int32_t idx = 0;
  LZM_UNROLL(unroll 4)
  for (int i = 0; i < iters; ++i) {
    const int32_t word = sm.ld(col + uint32_t(idx >> 2) * sb);
    const int32_t byte = (word >> ((idx & 3) * 8)) & 0xFF;
    acc += uint32_t(byte);
    idx = index_mod<kPow2>(idx + byte + 1, W);
  }
  acc_out = acc;
  idx_out = idx;
}

// p1-p3: `visits` visits of one row whose word is w: v = max(w, 0) added
// each time; p3 writes v + 1 back where v is odd. Returns their sum.
template <int kMode>
LZM_FN uint32_t row_visits(int32_t& w, int visits) {
  uint32_t acc = 0;
  LZM_UNROLL(unroll 1)
  for (int k = 0; k < visits; ++k) {
    const int32_t v = w > 0 ? w : 0;
    if (kMode == ROW_CLAMP_WRITE && (v & 1)) w = wrap(uint32_t(v) + 1u);
    acc += uint32_t(v);
  }
  return acc;
}

// p1-p3, rank r of lane `lane`: its rows' visits, in step order; p3 also
// stores each of its visited rows into `table`. Returns its partial sum.
template <int kMode>
LZM_FN uint32_t row_rank(const int32_t* __restrict__ x,
                         int32_t* __restrict__ table, int W, int L, int lane,
                         int r, int iters) {
  const int V = iters < W ? iters : W;
  uint32_t acc = 0;
  LZM_UNROLL(unroll 4)
  for (int j = r; j < V; j += kRowRanks) {
    const size_t at = size_t(j) * L + lane;
    int32_t w = x[at];
    // visits i = j, j + W, ... < iters
    acc += row_visits<kMode>(
        w, int((uint32_t(iters) - 1u - uint32_t(j)) / uint32_t(W)) + 1);
    if (kMode == ROW_CLAMP_WRITE) table[at] = w;
  }
  return acc;
}

// 16 bytes of the table: one 128-bit load or store on the card.
struct alignas(16) Chunk {
  int32_t w[4];
};

LZM_FN Chunk load_chunk(const int32_t* p) {
#if defined(__CUDA_ARCH__)
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  return {{v.x, v.y, v.z, v.w}};
#else
  Chunk c;
  memcpy(&c, p, sizeof c);
  return c;
#endif
}

LZM_FN void store_chunk(int32_t* p, const Chunk& c) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int4*>(p) = make_int4(c.w[0], c.w[1], c.w[2], c.w[3]);
#else
  memcpy(p, &c, sizeof c);
#endif
}

// p3's blocks a lane group: the unvisited rows [min(W, iters), W) in
// ranges of about kCopyRows; 1 for p1, p2.
LZM_FN int copy_blocks(int mode, int W, int iters) {
  if (mode != ROW_CLAMP_WRITE) return 1;
  const int n = W - (iters < W ? iters : W);
  const int b = n / kCopyRows + (n % kCopyRows != 0);
  return b < 1 ? 1 : b > kMaxCopyBlocks ? kMaxCopyBlocks : b;
}

// Block y of `blocks`' range [r0, r1) of p3's unvisited rows.
LZM_FN void copy_range(int W, int iters, int y, int blocks, int& r0,
                       int& r1) {
  const int V = iters < W ? iters : W, n = W - V;
  const long long per = n / blocks + (n % blocks != 0);
  r0 = V + int(per * y < n ? per * y : n);
  r1 = V + int(per * (y + 1) < n ? per * (y + 1) : n);
}

// p3, rank `tid` of the block's kRowThreads: its share of rows [V, E) of
// the block's lanes (nl of kRowLanes from lane0), from x into table. In
// 16-byte chunks, kCopyRun loaded before any is stored, where the group
// is whole and its rows 16-byte aligned; else word by word.
LZM_FN void row_copy(const int32_t* __restrict__ x,
                     int32_t* __restrict__ table, int L, int lane0, int nl,
                     int V, int E, int tid) {
  constexpr int nt = kRowThreads, per = kRowLanes / 4;
  const int32_t* const from = x + lane0;
  int32_t* const to = table + lane0;
  const size_t sL = size_t(L);
  if (nl == kRowLanes && L % 4 == 0 &&
      reinterpret_cast<uintptr_t>(from) % lzs::kCopy == 0 &&
      reinterpret_cast<uintptr_t>(to) % lzs::kCopy == 0) {
    const int n = (E - V) * per;
    auto at = [&](int i) { return size_t(V + i / per) * sL + (i % per) * 4; };
    int i = tid;
    LZM_UNROLL(unroll 1)
    for (; i + (kCopyRun - 1) * nt < n; i += kCopyRun * nt) {
      Chunk c[kCopyRun];
      LZM_UNROLL(unroll)
      for (int e = 0; e < kCopyRun; ++e)
        c[e] = load_chunk(from + at(i + e * nt));
      LZM_UNROLL(unroll)
      for (int e = 0; e < kCopyRun; ++e)
        store_chunk(to + at(i + e * nt), c[e]);
    }
    LZM_UNROLL(unroll 1)
    for (; i < n; i += nt) store_chunk(to + at(i), load_chunk(from + at(i)));
  } else {
    const int n = (E - V) * kRowLanes;
    LZM_UNROLL(unroll 1)
    for (int i = tid; i < n; i += nt) {
      const int f = i % kRowLanes;
      const size_t a = size_t(V + i / kRowLanes) * sL + f;
      if (f < nl) to[a] = from[a];
    }
  }
}

// row_chain's launch: out[0] lanes a block (p6: byte_lanes(W); p1-p3:
// kRowLanes), out[1] threads a block, out[2] dynamic shared memory a
// block (p6's slice; p1-p3 none).
LZM_FN void row_launch(int mode, int W, int* out) {
  const bool byte = mode == ROW_BYTE;
  out[0] = byte ? byte_lanes(W) : kRowLanes;
  out[1] = kRowThreads;
  out[2] = byte ? out[0] * byte_rows(W) * 4 : 0;
}

// p4's step on its two rows: acc += s. On the card an empty asm after
// each step keeps nvcc from folding a round's eight adds into one multiply
// (a closed form). ptxas still builds the adds its own way: in the H100
// build row 1 takes x1 + i into each step's add, one IADD3 a step, eight
// dependent a round, and row 0 adds s twice in one IADD3, four a round
// (chip_smoke.py phase 8 models the loop's chain from its SASS). Row 1's
// chain sets the step's time.
LZM_FN void refill_add(uint32_t& acc0, uint32_t& acc1, uint32_t s0,
                       uint32_t s1) {
  acc0 += s0;
  acc1 += s1;
#if defined(__CUDA_ARCH__)
  asm volatile("" : "+r"(acc0), "+r"(acc1));
#endif
}

constexpr int kRefillEvery = 8;  // p4: s = x[0:2] + i where i % 8 == 0

// p4 on a lane-minor table x ([W, L]), one lane, from acc = 0: every 8th
// step s = x[0:2] + i; acc += s. Nothing writes x, so the lane's two
// source words are read once, before the loop, into registers (the TPU
// probe's x_ref in VMEM), and its scratch s is two registers. Rounds of
// 8 steps, the refill at each round's start (i % 8 == 0 there), then the
// last round's steps; state: [2, L], the acc of rows 0 and 1, written.
LZM_FN void refill_lane(const int32_t* x, int L, int lane, int32_t* state,
                        int iters) {
  const size_t sL = size_t(L);
  const uint32_t x0 = uint32_t(x[lane]), x1 = uint32_t(x[sL + lane]);
  uint32_t acc0 = 0, acc1 = 0;
  int i = 0;
  LZM_UNROLL(unroll 1)
  for (; i < iters - (kRefillEvery - 1); i += kRefillEvery) {
    const uint32_t s0 = x0 + uint32_t(i), s1 = x1 + uint32_t(i);
    LZM_UNROLL(unroll)
    for (int k = 0; k < kRefillEvery; ++k) refill_add(acc0, acc1, s0, s1);
  }
  if (i < iters) {
    const uint32_t s0 = x0 + uint32_t(i), s1 = x1 + uint32_t(i);
    LZM_UNROLL(unroll 1)
    for (; i < iters; ++i) refill_add(acc0, acc1, s0, s1);
  }
  state[lane] = wrap(acc0);
  state[sL + lane] = wrap(acc1);
}

// p5, one block a lane. The lane's column (W rows of a lane-minor [W, L]
// table x) lives in the block's shared memory from staging to the write
// into the output table; each step, of its four segments of S = W / 4
// rows the one equal to `mask` gets +1 (written back), total adds each
// segment's max, and mask = (mask + 1) % 4, from total = mask = 0.
// state: [2, L], total then mask, written.
//
// Warp w walks segment w % 4 (two warps a segment): thread t is rank
// seg_rank(t) of its segment's kSegGroup threads and owns rows u, u +
// kSegGroup, ... of it, which it loads kSegRun at a time before it stores
// any (so that many loads are in flight) and which no other thread
// touches, so the steps need no barrier. A warp's max (__reduce_max_sync)
// is the same in all its lanes; lane k keeps step k's of a chunk of
// kSegChunk steps. At a chunk's end (or the run's) each lane posts what it
// kept into slot (k, s) of `red` ([kSegChunk][4] int32) by a shared
// atomicMax, so the two warps of a segment meet there; the block meets at
// a barrier, threads t < 4 k' (k' steps in the chunk) add slot t to their
// `part` and reset it, and the block meets again. total is the start's
// plus every part (mod 2^32: the order is free).
constexpr int kSegThreads = 256;                 // threads a p5 block
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegGroup = kSegThreads / 4;       // threads a segment
constexpr int kSegRun = 8;                       // rows loaded together
constexpr int kSegChunk = 16;                    // steps between combines
constexpr int kSegSlots = kSegChunk * 4;         // red's slots
// The most rows a column may have: red and the column in kMaxShared.
constexpr int kSegMaxRows = (kMaxShared / 4 - kSegSlots) / 4 * 4;
static_assert(kSegThreads % 128 == 0, "whole warps for each segment");
static_assert(kSegChunk <= 32 && kSegSlots <= kSegThreads,
              "a lane a step, a thread a slot");

// A p5 block's dynamic shared memory: red, then the column.
LZM_FN size_t seg_block_bytes(int W) {
  return (size_t(kSegSlots) + size_t(W)) * sizeof(int32_t);
}

// Thread t's rows (r = t, t + kSegThreads, ...) of the lane's column:
// from the input x into the block's copy col, or at the end from col into
// the output table (x is not written). The block meets at a barrier
// between the staging and the steps.
LZM_FN void seg_stage(const int32_t* x, int W, int L, int lane,
                      int32_t* col, int t) {
  for (int r = t; r < W; r += kSegThreads)
    col[r] = x[size_t(r) * L + lane];
}

LZM_FN void seg_write(const int32_t* col, int W, int L, int lane,
                      int32_t* table, int t) {
  for (int r = t; r < W; r += kSegThreads)
    table[size_t(r) * L + lane] = col[r];
}

LZM_FN int32_t max_of(int32_t a, int32_t b) { return a > b ? a : b; }

// Thread t's segment (its warp's) and its rank among the segment's
// kSegGroup threads.
LZM_FN int seg_of(int t) { return (t >> 5) & 3; }
LZM_FN int seg_rank(int t) { return ((t >> 7) << 5) | (t & 31); }

// One step of a thread over its rows u, u + kSegGroup, ... < S of its
// segment `seg` (seg_of, seg_rank): +1 on each where `add` (its segment is
// the step's mask), and their max (INT32_MIN where it owns none).
LZM_FN int32_t seg_step(int32_t* seg, int S, int u, bool add) {
  constexpr int G = kSegGroup;
  int32_t m = INT32_MIN;
  int j = u;
  LZM_UNROLL(unroll 1)
  for (; j + (kSegRun - 1) * G < S; j += kSegRun * G) {
    int32_t v[kSegRun];
    LZM_UNROLL(unroll)
    for (int e = 0; e < kSegRun; ++e) v[e] = seg[j + e * G];
    if (add) {
      LZM_UNROLL(unroll)
      for (int e = 0; e < kSegRun; ++e) {
        v[e] = wrap(uint32_t(v[e]) + 1u);
        seg[j + e * G] = v[e];
      }
    }
    LZM_UNROLL(unroll)
    for (int e = 0; e < kSegRun; ++e) m = max_of(m, v[e]);
  }
  LZM_UNROLL(unroll 1)
  for (; j < S; j += G) {
    int32_t v = seg[j];
    if (add) {
      v = wrap(uint32_t(v) + 1u);
      seg[j] = v;
    }
    m = max_of(m, v);
  }
  return m;
}

// The mask of the next step (mask is in [0, 4)).
LZM_FN int seg_next(int mask) { return (mask + 1) & 3; }

// What lane r keeps after step i: the warp's max m of the step if r is
// the step's place in its chunk, else what it kept.
LZM_FN int32_t seg_keep(int32_t kept, int r, int i, int32_t m) {
  return r == i % kSegChunk ? m : kept;
}

// A lane's kept max into slot (k, s) of red: atomicMax on the card (two
// warps a segment), a max on the host (which runs one block at a time).
LZM_FN void seg_post(int32_t* red, int k, int s, int32_t v) {
#if defined(__CUDA_ARCH__)
  atomicMax(red + k * 4 + s, v);
#else
  red[k * 4 + s] = max_of(red[k * 4 + s], v);
#endif
}

// Thread t (< kSegSlots) after a chunk's barrier: slot t into its part,
// and the slot reset for the next chunk.
LZM_FN void seg_take(int32_t* red, int t, uint32_t* part) {
  *part += uint32_t(red[t]);
  red[t] = INT32_MIN;
}

// After the last barrier, with each thread's part in red[t] (t <
// kSegSlots): the lane's total, from 0.
LZM_FN int32_t seg_total(const int32_t* red) {
  uint32_t total = 0;
  for (int t = 0; t < kSegSlots; ++t) total += uint32_t(red[t]);
  return wrap(total);
}

// The combine is due after step i: a chunk's last step, or the run's.
LZM_FN bool seg_chunk_end(int i, int iters) {
  return i % kSegChunk == kSegChunk - 1 || i == iters - 1;
}

// Argument checks shared by the card's and the host's C interface.
LZM_FN bool bad_gather(int axis, int elem, int x_rows, int x_cols,
                       int mod, int n_out, int out_cols, int iters) {
  if ((axis != AXIS_MINOR && axis != AXIS_MAJOR) ||
      (elem != ELEM_I32 && elem != ELEM_U8) || x_rows < 1 || x_cols < 1 ||
      mod < 1 || n_out < 0 || out_cols < 1 || n_out % out_cols || iters < 0)
    return true;
  if (axis == AXIS_MINOR) return mod > x_cols || n_out / out_cols > x_rows;
  return mod > x_rows || out_cols != x_cols;
}

// E's row must fit a block's shared memory (kScalarMaxCols).
LZM_FN bool bad_rw(int mode, int rows, int cols, int iters) {
  return (mode != RW_ROWS && mode != RW_SCALAR) || rows < 0 || cols < 1 ||
         iters < 0 ||
         (mode == RW_SCALAR && (rows != 1 || cols > kScalarMaxCols));
}

// rw_chain's launch: out[0] the threads a row (D; 1 for E's one chain),
// out[1] the threads a block, out[2] the blocks.
LZM_FN void rw_launch(int mode, int rows, int* out) {
  if (mode == RW_SCALAR) {
    out[0] = 1;
    out[1] = kScalarThreads;
    out[2] = 1;
    return;
  }
  out[0] = kGatherWarp;
  out[1] = gather_block(kGatherWarp, rows);
  out[2] = gather_blocks(kGatherWarp, rows);
}

// p6's rows must fit a block's shared memory (W <= kByteMaxW).
LZM_FN bool bad_row(int mode, int W, int L, int iters) {
  return mode < ROW_CLAMP || mode > ROW_BYTE || W < 2 || L < 0 ||
         iters < 0 || (mode == ROW_BYTE && W > kByteMaxW);
}

// p5's column must fit a block's shared memory (kSegMaxRows).
LZM_FN bool bad_segment(int mode, int W, int L, int iters) {
  return (mode != SEG_REFILL && mode != SEG_SEGMENTS) || W < 4 || W % 4 ||
         L < 0 || iters < 0 || (mode == SEG_SEGMENTS && W > kSegMaxRows);
}

}  // namespace lzm

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
#include <algorithm>
#include <vector>

// gather_sum as the card splits it (gather_group), one output at a time:
// each rank of the output's group sums its steps, and the ranks' partial
// sums are added in rank order, as the warp's __reduce_add_sync adds them.
template <int kAxis, class T>
void host_gather(const T* x, int x_cols, const int32_t* start, int stride,
                 int mod, T* out, int n_out, int out_cols, int iters) {
  const int G = lzm::gather_group(kAxis, n_out);
  const int32_t S = lzm::gather_stride(stride, G);
  const uint32_t step = uint32_t(lzm::floor_mod(S, mod));
  for (int e = 0; e < n_out; ++e) {
    const int line = lzm::gather_line<kAxis>(e, out_cols);
    uint32_t acc = 0;
    for (int r = 0; r < G; ++r) {
      const int count = lzm::gather_count(r, G, iters);
      if (count > 0)
        acc += lzm::gather_part<kAxis, T>(
            x, x_cols, line, lzm::gather_first(start[e], stride, r), S, step,
            mod, count);
    }
    out[e] = static_cast<T>(acc);
  }
}

// row_chain as the card runs it, block by block. p6: every rank stages
// the block's slice, then each of its lanes runs its chain. p1-p3: each
// thread's owned rows; a warp's ranks summed into its part (the card's
// shuffles), p3's copy of the unvisited rows block by block, then the
// parts summed.
template <bool kPow2>
void host_byte(const int32_t* x, int W, int L, int32_t* state, int iters) {
  using namespace lzm;
  const int rows = byte_rows(W), lb = byte_lanes(W);
  std::vector<int32_t> sm(size_t(rows) * lb);
  const lzs::Shared m{reinterpret_cast<uintptr_t>(sm.data())};
  for (int b = 0; b * lb < L; ++b) {
    const lzs::Slice s = lzs::block_slice(rows, lb, L, b);
    for (int t = 0; t < kRowThreads; ++t)
      lzs::stage_minor(sm.data(), x, s, t, kRowThreads);
    for (int f = 0; f < s.nl; ++f) {
      uint32_t acc;
      int32_t idx;
      byte_chain_lane<kPow2>(m, uint32_t(f) * 4, uint32_t(lb) * 4, W, iters,
                             acc, idx);
      state[s.lane0 + f] = wrap(acc);
      state[size_t(L) + s.lane0 + f] = idx;
    }
  }
}

template <int kMode>
void host_rows(const int32_t* x, int W, int L, int32_t* state,
               int32_t* table, int iters) {
  using namespace lzm;
  for (int lane0 = 0; lane0 < L; lane0 += kRowLanes) {
    const int nl = std::min(kRowLanes, L - lane0);
    uint32_t part[kRowWarps][kRowLanes] = {};
    for (int t = 0; t < kRowThreads; ++t) {
      const int f = t % kRowLanes;
      if (f < nl)
        part[t / 32][f] += row_rank<kMode>(x, table, W, L, lane0 + f,
                                           t / kRowLanes, iters);
    }
    const int blocks = copy_blocks(kMode, W, iters);
    for (int y = 0; kMode == ROW_CLAMP_WRITE && y < blocks; ++y) {
      int r0, r1;
      copy_range(W, iters, y, blocks, r0, r1);
      for (int t = 0; t < kRowThreads; ++t)
        row_copy(x, table, L, lane0, nl, r0, r1, t);
    }
    for (int f = 0; f < nl; ++f) {
      uint32_t acc = 0;
      for (int w = 0; w < kRowWarps; ++w) acc += part[w][f];
      state[lane0 + f] = wrap(acc);
      state[size_t(L) + lane0 + f] = iters % W;
    }
  }
}

// probes_mosaic.cu's C interface as host loops over threads (tests only;
// gather_sum over each output's ranks). The stream argument is ignored.
extern "C" {

int lzm_gather_sum(int axis, int elem, const void* x, int x_rows, int x_cols,
                   const int32_t* start, int stride, int mod, void* out,
                   int n_out, int out_cols, int iters, void* /*stream*/) {
  if (lzm::bad_gather(axis, elem, x_rows, x_cols, mod, n_out, out_cols,
                      iters))
    return lzm::ERR_ARGS;
  if (elem == lzm::ELEM_U8) {
    const uint8_t* xs = static_cast<const uint8_t*>(x);
    uint8_t* o = static_cast<uint8_t*>(out);
    if (axis == lzm::AXIS_MINOR)
      host_gather<lzm::AXIS_MINOR>(xs, x_cols, start, stride, mod, o, n_out,
                                   out_cols, iters);
    else
      host_gather<lzm::AXIS_MAJOR>(xs, x_cols, start, stride, mod, o, n_out,
                                   out_cols, iters);
  } else {
    const int32_t* xs = static_cast<const int32_t*>(x);
    int32_t* o = static_cast<int32_t*>(out);
    if (axis == lzm::AXIS_MINOR)
      host_gather<lzm::AXIS_MINOR>(xs, x_cols, start, stride, mod, o, n_out,
                                   out_cols, iters);
    else
      host_gather<lzm::AXIS_MAJOR>(xs, x_cols, start, stride, mod, o, n_out,
                                   out_cols, iters);
  }
  return 0;
}

// gather_sum's launch for `n_out` outputs along `axis`: out[0] the threads
// an output, out[1] the threads a block, out[2] the blocks.
int lzm_gather_launch(int axis, int n_out, int* out) {
  if ((axis != lzm::AXIS_MINOR && axis != lzm::AXIS_MAJOR) || n_out < 0)
    return lzm::ERR_ARGS;
  out[0] = lzm::gather_group(axis, n_out);
  out[1] = lzm::gather_block(out[0], n_out);
  out[2] = lzm::gather_blocks(out[0], n_out);
  return 0;
}

// D as host loops over rows and each row's 32 ranks, in rank order; E on
// x itself (the card's staged copy holds the same words).
int lzm_rw_chain(int mode, int32_t* x, int rows, int cols,
                 const int32_t* start, int32_t* out, int iters,
                 void* /*stream*/) {
  using namespace lzm;
  if (bad_rw(mode, rows, cols, iters)) return ERR_ARGS;
  if (mode == RW_SCALAR) {
    *out = rw_scalar(x, cols, iters);
    return 0;
  }
  const uint32_t step = uint32_t(floor_mod(kGatherWarp, cols));
  for (int e = 0; e < rows; ++e)
    for (int r = 0; r < kGatherWarp; ++r)
      rw_rank(x + size_t(e) * cols, cols, start[e], step, r, iters);
  return 0;
}

int lzm_rw_launch(int mode, int rows, int* out) {
  if ((mode != lzm::RW_ROWS && mode != lzm::RW_SCALAR) || rows < 0)
    return lzm::ERR_ARGS;
  lzm::rw_launch(mode, rows, out);
  return 0;
}

int lzm_rw_max_cols() { return lzm::kScalarMaxCols; }

// Host build only, for the tests of E's int32 wrap: E's chain on x with
// its walk from v0 (the probe's is 0), and the first n indices of that
// walk as ScalarWalk steps it (next<true>, the step that handles a wrap).
int lzm_rw_scalar_from(int32_t* x, int cols, int32_t v0, int32_t* out,
                       int iters) {
  if (lzm::bad_rw(lzm::RW_SCALAR, 1, cols, iters)) return lzm::ERR_ARGS;
  *out = lzm::rw_scalar(x, cols, iters, v0);
  return 0;
}

int lzm_scalar_walk(int32_t v0, int cols, int32_t* js, int n) {
  if (cols < 1 || n < 0) return lzm::ERR_ARGS;
  const uint32_t step = uint32_t(lzm::floor_mod(lzm::kScalarStride, cols));
  lzm::ScalarWalk w{v0, uint32_t(lzm::floor_mod(v0, cols))};
  for (int i = 0; i < n; ++i) {
    js[i] = int32_t(w.j);
    w.next<true>(step, cols);
  }
  return 0;
}

// x: [W, L], not changed; table: [W, L], p3's output (else null); state:
// [2, L], written.
int lzm_row_chain(int mode, const int32_t* x, int W, int L, int32_t* state,
                  int32_t* table, int iters, void* /*stream*/) {
  using namespace lzm;
  if (bad_row(mode, W, L, iters) ||
      (mode == ROW_CLAMP_WRITE) != (table != nullptr))
    return ERR_ARGS;
  if (mode == ROW_BYTE) {
    if (pow2(W))
      host_byte<true>(x, W, L, state, iters);
    else
      host_byte<false>(x, W, L, state, iters);
  } else if (mode == ROW_CLAMP) {
    host_rows<ROW_CLAMP>(x, W, L, state, table, iters);
  } else {
    host_rows<ROW_CLAMP_WRITE>(x, W, L, state, table, iters);
  }
  return 0;
}

int lzm_row_launch(int mode, int W, int* out) {
  if (lzm::bad_row(mode, W, 1, 0)) return lzm::ERR_ARGS;
  lzm::row_launch(mode, W, out);
  return 0;
}

int lzm_row_max_w() { return lzm::kByteMaxW; }

int lzm_row_copy_blocks(int mode, int W, int iters) {
  if (lzm::bad_row(mode, W, 1, iters)) return lzm::ERR_ARGS;
  return lzm::copy_blocks(mode, W, iters);
}

// p4 lane by lane (its two words read, then its rounds); p5 as host
// loops over blocks (lanes), warps and their 32 ranks: each block stages
// its column, runs every step (a warp's max over its ranks for
// __reduce_max_sync, kept by the lane of the step's place), posts and
// combines at each chunk's end and writes the column into `table`.
int lzm_segment_chain(int mode, const int32_t* x, int W, int L,
                      int32_t* state, int32_t* table, int iters,
                      void* /*stream*/) {
  using namespace lzm;
  if (bad_segment(mode, W, L, iters) ||
      (mode == SEG_SEGMENTS) != (table != nullptr))
    return ERR_ARGS;
  if (mode == SEG_REFILL) {
    for (int l = 0; l < L; ++l) refill_lane(x, L, l, state, iters);
    return 0;
  }
  const int S = W / 4;
  std::vector<int32_t> red(kSegSlots), col(W);
  std::vector<int32_t> kept(size_t(kSegWarps) * 32);  // [warp][lane]
  std::vector<uint32_t> part(kSegSlots);
  for (int lane = 0; lane < L; ++lane) {
    for (int t = 0; t < kSegThreads; ++t)
      seg_stage(x, W, L, lane, col.data(), t);
    std::fill(red.begin(), red.end(), INT32_MIN);
    std::fill(kept.begin(), kept.end(), INT32_MIN);
    std::fill(part.begin(), part.end(), 0u);
    int mask = 0;
    for (int i = 0; i < iters; ++i) {
      for (int w = 0; w < kSegWarps; ++w) {
        const int s = seg_of(w * 32);
        int32_t m = INT32_MIN;
        for (int r = 0; r < 32; ++r)
          m = max_of(m, seg_step(col.data() + s * S, S, seg_rank(w * 32 + r),
                                 s == mask));
        for (int r = 0; r < 32; ++r)
          kept[w * 32 + r] = seg_keep(kept[w * 32 + r], r, i, m);
      }
      mask = seg_next(mask);
      if (seg_chunk_end(i, iters)) {
        for (int w = 0; w < kSegWarps; ++w)
          for (int r = 0; r < kSegChunk; ++r) {
            seg_post(red.data(), r, seg_of(w * 32), kept[w * 32 + r]);
            kept[w * 32 + r] = INT32_MIN;
          }
        for (int t = 0; t < 4 * (i % kSegChunk + 1); ++t)
          seg_take(red.data(), t, &part[t]);
      }
    }
    for (int t = 0; t < kSegSlots; ++t) red[t] = wrap(part[t]);
    state[lane] = seg_total(red.data());
    state[size_t(L) + lane] = mask;
    for (int t = 0; t < kSegThreads; ++t)
      seg_write(col.data(), W, L, lane, table, t);
  }
  return 0;
}

int lzm_segment_max_rows() { return lzm::kSegMaxRows; }

const char* lzm_error_string(int code) {
  return code == lzm::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_MOSAIC_CUH_
