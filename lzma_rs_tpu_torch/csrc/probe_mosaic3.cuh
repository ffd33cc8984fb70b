// One thread, lane or rank of each mosaic3 probe kernel: the per-lane
// functions of the JAX package's Pallas probes tools/probe_mosaic3.py, in
// scalar code, and the per-rank pieces of a block's shared work (the
// staging of its lanes' table, a warp's reads of a window step).
//
// Compiled for the card by probes_mosaic3.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_mosaic3.cu as host loops, so the logic is checked on
// the CPU against the plain PyTorch versions (ops/probes_mosaic3.py). The
// loops run in the card's order: vote_chain steps each of the warp's 32
// threads' slots one iteration, then ORs a thread's slots and votes over
// the 32 (the card's warp vote); onehot_chain and window_chain stage each
// block's slice by all its ranks (probe_stage.cuh) before any lane runs,
// and a window step takes the max of the warp's 32 ranks (the card's
// __reduce_max_sync) before the lane goes on; byte_chain runs its passes
// of four steps, then the remainder, and its byte permute is the host's C
// form of the card's PRMT (byte_perm).
//
// Integer semantics are the probes': wrapping int32 (every add that can
// wrap is done in uint32_t and converted back), an arithmetic >> of int32,
// and an index is jnp's `%` of a wrapped int32 (lzm::floor_mod of
// lzm::wrap, shared with probe_mosaic.cuh); by a power of two it is an
// and.
#ifndef LZMA_RS_TPU_TORCH_PROBE_MOSAIC3_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_MOSAIC3_CUH_

#include "probe_mosaic.cuh"
#include "probe_stage.cuh"

namespace lzm3 {

using lzm::floor_mod;
using lzm::index_mod;
using lzm::pow2;
using lzm::wrap;
using lzs::block_slice;
using lzs::chunked;
using lzs::copies_landed;
using lzs::copy_word;
using lzs::lanes_per_block;
using lzs::log2_of;
using lzs::Shared;
using lzs::Slice;
using lzs::stage_minor;

constexpr int kBlock = 128;        // byte_chain's threads a block
constexpr int kMaxLanes = 1024;    // vote_chain: all lanes in one warp
constexpr int kVoteBelow = 5;      // P7-P9: run while a lane is below 5
constexpr int kWindowRows = 64;    // P10's rows; P16's scratch rows
constexpr int kChunk = 32;         // P16: rows per chunk
constexpr int kBaseRow = 128;      // P16: row0 = base // 128
constexpr int kBaseShift = 7;      // log2(kBaseRow)
constexpr int kBaseStep = 129;     // P16: base = (base + v + 129) % 16 W
constexpr int ERR_ARGS = -1;       // a bad argument: nothing was launched

// onehot_chain and window_chain: kThreads threads a block, all of which
// stage; window_chain runs a warp a lane (kWindowLanes lanes a block at
// most), onehot_chain a thread a lane of the first warp (kOnehotLanes at
// most). A block's lanes: the most, halved while their slice of the table
// exceeds lzs::kSliceBytes (so onehot_chain's 128 lanes of a 2,048-row
// table are 16 blocks on 16 SMs), at least one. One lane's column must fit the
// block's shared memory: at most kMaxOnehotRows rows, and kMaxRefillRows
// for P16, whose column has a chunk of zeros after it.
constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWindowLanes = kThreads / kWarp;  // 8
constexpr int kOnehotLanes = kWarp;             // 32
constexpr int kMaxOnehotRows = lzm::kMaxShared / 4;             // 58,112
constexpr int kMaxRefillRows = lzm::kMaxShared / 4 - kChunk;    // 58,080
constexpr uint32_t kAll = 0xFFFFFFFFu;  // a warp's threads

enum { VOTE_ANY = 0, VOTE_MAX = 1, VOTE_FLAG = 2 };  // P7, P8, P9
enum { BYTE_SHIFT = 0, BYTE_SELECT = 1 };            // P11a, P11b
enum { REDUCE_SUM = 0, REDUCE_MAX = 1 };             // P12s; P12m-P15
enum { WINDOW_CONCAT = 0, WINDOW_REFILL = 1 };       // P10, P16

// vote_chain holds all L lanes in one warp: thread t keeps K of them in
// registers, lanes t, t + 32, ..., t + 32 (K - 1) (so node0's loads
// coalesce), K = ceil(L / 32) rounded up to a power of two (1 to 32), a
// template parameter: with a run-time count the slots' dynamic indexing
// would put them in local memory. A slot past L holds kVoteBelow, which
// node += i & 1 keeps at or above 5 (fewer than 2^31 iterations add at
// most 2^30), so it never votes.
LZM_FN int vote_slots(int L) {
  int k = 1;
  while (kWarp * k < L) k <<= 1;
  return k;
}

template <int K>
LZM_FN void vote_load(const int32_t* node0, int L, int t, int32_t* node) {
  LZM_UNROLL(unroll)
  for (int k = 0; k < K; ++k) {
    const int l = t + kWarp * k;
    node[k] = l < L ? node0[l] : kVoteBelow;
  }
}

template <int K>
LZM_FN void vote_store(const int32_t* node, int L, int t, int32_t* out) {
  LZM_UNROLL(unroll)
  for (int k = 0; k < K; ++k)
    if (t + kWarp * k < L) out[t + kWarp * k] = node[k];
}

// P7-P9's body on each of a thread's slots: node += add (body j's add is
// j & 1, the probe's node += i & 1).
template <int K>
LZM_FN void vote_body(int32_t* node, uint32_t add) {
  LZM_UNROLL(unroll)
  for (int k = 0; k < K; ++k) node[k] = wrap(uint32_t(node[k]) + add);
}

// The min of N slots from v, a tree of log2 N steps: its halves' mins,
// every index a constant once inlined, so the slots stay in registers (a
// loop form of the tree left a 128-byte stack frame at 32 slots).
template <int N>
struct MinTree {
  static LZM_FN int32_t of(const int32_t* v) {
    const int32_t a = MinTree<N / 2>::of(v), b = MinTree<N / 2>::of(v + N / 2);
    return b < a ? b : a;
  }
};

template <>
struct MinTree<1> {
  static LZM_FN int32_t of(const int32_t* v) { return v[0]; }
};

// Whether one of the thread's slots is below 5 (the warp then votes on
// it): their min below 5, the same test as the OR of each slot's, in a
// shorter chain.
template <int K>
LZM_FN int vote_below(const int32_t* node) {
  return MinTree<K>::of(node) < kVoteBelow;
}

#if defined(__CUDACC__)
#define LZM3_WARP_FN __device__ inline
#else
#define LZM3_WARP_FN inline
#endif

// P7-P9's loop (kMode), at most `iters` iterations, over a warp `w`:
// w.vote() is the warp's vote that one of its slots is below 5 (on the
// card the thread's test and __any_sync, or __reduce_max_sync, a max over
// 0/1 flags being an any; on the host every thread's test, then their
// max), w.step(add) the body on every slot. Every iteration votes, then
// takes its exit test on that vote, then runs the body (P9: the body,
// then the vote), as the probe's while_loop does: no vote runs ahead of
// its iteration. Returns the iterations run, `w` holding node after them;
// `flag` is the last vote.
template <int kMode, int K, class Warp>
LZM3_WARP_FN int vote_loop(Warp& w, int iters, int& flag) {
  int i = 0;
  flag = 1;
  for (;;) {
    if (kMode != VOTE_FLAG) flag = w.vote();
    if (!flag || i >= iters) return i;
    w.step(uint32_t(i) & 1u);
    ++i;
    if (kMode == VOTE_FLAG) flag = w.vote();
  }
}

// The byte permute of the pair (v, 0) by selector s: byte n of the result
// is byte (s >> 4 n) & 7 of the 8 bytes v, 0 (bytes 4-7 zero). On the card
// __byte_perm, one PRMT; on the host the same rule in C (the tests hold it
// against the probe's shift).
LZM_FN uint32_t byte_perm(uint32_t v, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(v, 0u, s);
#else
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    const uint32_t k = (s >> (4 * n)) & 7u;
    r |= (k < 4 ? (v >> (8 * k)) & 0xFFu : 0u) << (8 * n);
  }
  return r;
#endif
}

// P11a's selector is (v & 3) | kBytePick: byte v & 3 of v into byte 0,
// byte 4 (a zero) into bytes 1-3, so the permute is (v >> 8 (v & 3)) &
// 0xFF for every int32 v. The card's kernel takes kBytePick as an argument,
// so ptxas holds it in a register and the selector is one LOP3 ((v & 3) |
// pick); as a constant it took two (an and, then an or).
constexpr uint32_t kBytePick = 0x4440u;

// One step of P11a (a variable per-lane byte pick) or P11b (a select of
// four constant shifts): the byte of v that v & 3 names, plus i. P11a is
// the byte permute: LOP3 (the selector), PRMT, the add. P11b forms the
// four candidate bytes from v, which do not wait on k = v & 3, then picks
// by k's two bits, two selects deep, then adds i.
template <int kMode>
LZM_FN uint32_t byte_step(uint32_t v, uint32_t i, uint32_t pick) {
  uint32_t b;
  if (kMode == BYTE_SHIFT) {
    b = byte_perm(v, (v & 3u) | pick);
  } else {
    const uint32_t b0 = v & 0xFFu, b1 = (v >> 8) & 0xFFu;
    const uint32_t b2 = (v >> 16) & 0xFFu, b3 = v >> 24;
    const uint32_t lo = (v & 1u) ? b1 : b0, hi = (v & 1u) ? b3 : b2;
    b = (v & 2u) ? hi : lo;
  }
  return b + i;
}

// A lane's chain: passes of kByteUnroll steps (the loop's counter, test
// and branch off the chain, a step's i the pass's base plus a constant),
// then the remainder one step at a time; exact for any iters >= 0.
constexpr int kByteUnroll = 4;

template <int kMode>
LZM_FN int32_t byte_chain_lane(int32_t v0, int iters, uint32_t pick) {
  uint32_t v = uint32_t(v0);
  int i = 0;
  LZM_UNROLL(unroll 1)
  for (; i < iters - (kByteUnroll - 1); i += kByteUnroll) {
    LZM_UNROLL(unroll)
    for (int u = 0; u < kByteUnroll; ++u)
      v = byte_step<kMode>(v, uint32_t(i) + uint32_t(u), pick);
  }
  LZM_UNROLL(unroll 1)
  for (; i < iters; ++i) v = byte_step<kMode>(v, uint32_t(i), pick);
  return wrap(v);
}

LZM_FN int onehot_lanes(int R) { return lanes_per_block(R, kOnehotLanes); }
// P16's slice lands twice (lane-minor, then in columns: stage_major_in),
// so its lanes are those of a table of 2 W rows: 4 at 2,048 rows, 32
// blocks on 32 SMs for the tool's 128 lanes.
LZM_FN int window_lanes(int mode, int W) {
  return mode == WINDOW_CONCAT ? kWindowLanes
                               : lanes_per_block(2 * W, kWindowLanes);
}

// A lane's P16 column in shared memory: W rows, then a chunk of zeros.
LZM_FN int refill_column(int W) { return W + kChunk; }

// Dynamic shared memory of a block: onehot_chain's [R, lb] slice; P16's
// lb columns and, for lb a multiple of 4, its [W, lb] slice as it lands
// (stage_major_in); P10 none.
LZM_FN int onehot_bytes(int R) { return R * onehot_lanes(R) * 4; }
LZM_FN int window_bytes(int mode, int W) {
  if (mode == WINDOW_CONCAT) return 0;
  const int lb = window_lanes(mode, W);
  return (refill_column(W) * lb + (lb % 4 == 0 ? W * lb : 0)) * 4;
}

// -- staging: a block's lanes' table into shared memory (probe_stage.cuh)

// P16's column layout: lane f's rows are refill_column(W) words from
// word f refill_column(W), row r at word r ^ swizzle(f, lb) of them (the
// xor stays inside the row's 32-row chunk). A warp's 32 stores of 32 / lb
// rows of lb lanes lie in 32 banks, and a chain warp's 32 loads of one
// chunk are 32 rows of one lane in 32 banks.
LZM_FN int swizzle(int f, int lb) { return (f * (kWarp / lb)) & (kWarp - 1); }

// P16's staging, in two passes where chunked() (a full block of whole
// chunks): pass 1 copies the block's [W, lb] slice lane-minor into the
// words after the columns by 16-byte cp.async (stage_minor), and zeroes
// the chunk after each column; after a barrier, pass 2 moves each word
// into its column, a warp's 32 words being 32 / lb rows of lb lanes, which
// the xor puts in 32 banks. Else pass 1 alone, word by word by 4-byte
// cp.async (neighbouring ranks on neighbouring lanes of a row; lanes past
// nl not copied). Returns whether pass 2 is to follow; the block meets at
// a barrier after each pass. (P16's set-up on the H100, 2,048 rows: 12.9
// us by 4-byte cp.async alone and 9.2 by 16-byte loads into registers and
// transposing stores, 8 lanes a block; 7.6 in two passes, 4 lanes a block,
// which beat 8 there: PERF.md.)
LZM_FN bool stage_major_in(int32_t* sm, const int32_t* x, const Slice& s,
                           int tid, int nt) {
  const int col = refill_column(s.rows);
  for (int i = tid; i < s.lb * kChunk; i += nt)
    sm[(i / kChunk) * col + s.rows + i % kChunk] = 0;
  const int32_t* const from = x + s.lane0;
  if (chunked(from, s)) {
    stage_minor(sm + s.lb * col, x, s, tid, nt);
    return true;
  }
  const int sh = log2_of(s.lb);
  for (int i = tid; i < s.rows * s.lb; i += nt) {
    const int r = i >> sh, f = i & (s.lb - 1);
    if (f < s.nl)
      copy_word(sm + f * col + (r ^ swizzle(f, s.lb)),
                from + size_t(r) * s.L + f);
  }
  copies_landed();
  return false;
}

LZM_FN void stage_major_out(int32_t* sm, const Slice& s, int tid, int nt) {
  const int col = refill_column(s.rows), sh = log2_of(s.lb);
  const int32_t* const minor = sm + s.lb * col;
  for (int i = tid; i < s.rows * s.lb; i += nt) {
    const int r = i >> sh, f = i & (s.lb - 1);
    sm[f * col + (r ^ swizzle(f, s.lb))] = minor[i];
  }
}

// -- the chains ----------------------------------------------------------

// P12s, P12m, P13, P14, P15, one lane, its [R] column in shared memory
// from byte `col`, its rows `sb` bytes apart: from acc = idx = 0, v =
// x[idx] (REDUCE_SUM: the one-hot sum is the element) or max(x[idx], 0)
// (REDUCE_MAX: the one-hot's zeros take part in the max, R >= 2); acc +=
// v; idx = (idx + v + 1) % R. `iters` dependent reads in iters / kUnroll
// loop passes of kUnroll reads each. A step is a shared load, the clamp,
// the adds and the mod (an and where R is a power of two).
template <int kReduce, int kUnroll, bool kPow2>
LZM_FN void onehot_chain_lane(const Shared& sm, uint32_t col, uint32_t sb,
                              int32_t R, int iters, uint32_t& acc_out,
                              int32_t& idx_out) {
  uint32_t acc = 0;
  int32_t idx = 0;
  LZM_UNROLL(unroll 1)
  for (int p = 0; p < iters / kUnroll; ++p) {
    LZM_UNROLL(unroll)
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t w = sm.ld(col + uint32_t(idx) * sb);
      const int32_t v = kReduce == REDUCE_MAX && w < 0 ? 0 : w;
      acc += uint32_t(v);
      idx = index_mod<kPow2>(wrap(uint32_t(idx) + uint32_t(v) + 1u), R);
    }
  }
  acc_out = acc;
  idx_out = idx;
}

// P10, rank t of lane `lane`'s warp: its rows t and t + 32 of x ([W, L]),
// loaded once (the rows do not change between steps).
LZM_FN void concat_rows(const int32_t* x, size_t L, int lane, int t,
                        int32_t& r0, int32_t& r1) {
  r0 = x[t * L + lane];
  r1 = x[(t + kWarp) * L + lane];
}

// P10, rank t of the lane's warp: rows t and t + 32 (r0, r1) plus i, each
// add wrapping before the max; the warp's max over its 32 ranks is the
// step's max over rows 0-63.
LZM_FN int32_t concat_rank(int32_t r0, int32_t r1, int i) {
  const int32_t a = wrap(uint32_t(r0) + uint32_t(i));
  const int32_t b = wrap(uint32_t(r1) + uint32_t(i));
  return a > b ? a : b;
}

// P16: the byte offset of lane f's row t of chunk 0 in the block's
// columns (refill_column(W) words each), its swizzle applied.
LZM_FN uint32_t rank_at(int f, int t, int lb, int col) {
  return uint32_t(f * col + (t ^ swizzle(f, lb))) * 4;
}

// P16, one rank of the lane's warp: row t of chunks row0 and row0 + 1 of
// the lane's column (`at`: the byte offset of its row t of chunk 0, its
// swizzle applied), as v0 and v1, a chunk from the table's end on being
// the zeros after the column (chunk `chunks`: row0 >= 0 always, as base
// is reduced into [0, 16 W)); returns their max. The warp's max over its
// ranks is the step's v.
LZM_FN int32_t refill_rank(const Shared& sm, uint32_t at, int32_t row0,
                           int32_t chunks, int32_t& v0, int32_t& v1) {
  const int32_t c0 = row0 < chunks ? row0 : chunks;
  const int32_t c1 = row0 < chunks ? row0 + 1 : chunks;
  v0 = sm.ld(at + uint32_t(c0) * (kChunk * 4));
  v1 = sm.ld(at + uint32_t(c1) * (kChunk * 4));
  return v0 > v1 ? v0 : v1;
}

// P16's carried state of one lane after its step's max v: acc += v; base
// = (base + v + 129) % 16 W.
template <bool kPow2>
LZM_FN void refill_carry(uint32_t& acc, int32_t& base, int32_t v,
                         int32_t mod) {
  acc += uint32_t(v);
  base = index_mod<kPow2>(
      wrap(uint32_t(base) + uint32_t(v) + uint32_t(kBaseStep)), mod);
}

// Argument checks shared by the card's and the host's C interface.
LZM_FN bool bad_vote(int mode, int L, int iters) {
  return mode < VOTE_ANY || mode > VOTE_FLAG || L < 1 || L > kMaxLanes ||
         iters < 0;
}

LZM_FN bool bad_byte(int mode, int L, int iters) {
  return (mode != BYTE_SHIFT && mode != BYTE_SELECT) || L < 0 || iters < 0;
}

// One lane's column must fit a block's shared memory: R <= 58,112.
LZM_FN bool bad_onehot(int reduce, int unroll, int R, int L, int iters) {
  return (reduce != REDUCE_SUM && reduce != REDUCE_MAX) ||
         (unroll != 1 && unroll != 8) || R < 1 || R > kMaxOnehotRows ||
         (reduce == REDUCE_MAX && R < 2) || L < 0 || iters < 0 ||
         iters % unroll;
}

// P10 reads rows 0-63 of any W >= 64; P16 stages a lane's column and a
// chunk of zeros: W a multiple of 32, at most 58,080.
LZM_FN bool bad_window(int mode, int W, int L, int iters) {
  if ((mode != WINDOW_CONCAT && mode != WINDOW_REFILL) || L < 0 ||
      iters < 0)
    return true;
  if (mode == WINDOW_CONCAT) return W < kWindowRows;
  return W < kChunk || W % kChunk || W > kMaxRefillRows;
}

}  // namespace lzm3

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_mosaic3.cu's C interface as host loops (tests only). The stream
// argument is ignored.
#include <vector>

namespace lzm3 {

// vote_chain's warp on the host: its 32 threads' slots.
template <int K>
struct HostVote {
  int32_t node[kWarp][K];
  int vote() const {
    int v = 0;
    for (int t = 0; t < kWarp; ++t) {
      const int b = vote_below<K>(node[t]);
      v = b > v ? b : v;
    }
    return v;
  }
  void step(uint32_t add) {
    for (int t = 0; t < kWarp; ++t) vote_body<K>(node[t], add);
  }
};

template <int kMode, int K>
void host_vote(const int32_t* node0, int L, int32_t* node, int32_t* state,
               int iters) {
  HostVote<K> w;
  for (int t = 0; t < kWarp; ++t) vote_load<K>(node0, L, t, w.node[t]);
  int flag;
  state[0] = vote_loop<kMode, K>(w, iters, flag);
  state[1] = flag;
  for (int t = 0; t < kWarp; ++t) vote_store<K>(w.node[t], L, t, node);
}

// onehot_chain, block by block: every rank stages the block's slice, then
// each of its lanes runs its chain.
template <int kReduce, int kUnroll, bool kPow2>
void host_onehot(const int32_t* x, int R, int L, int32_t* state,
                 int iters) {
  const int lb = onehot_lanes(R);
  std::vector<int32_t> sm(size_t(R) * lb);
  const Shared m{reinterpret_cast<uintptr_t>(sm.data())};
  for (int b = 0; b * lb < L; ++b) {
    const Slice s = block_slice(R, lb, L, b);
    for (int t = 0; t < kThreads; ++t)
      stage_minor(sm.data(), x, s, t, kThreads);
    for (int f = 0; f < s.nl; ++f) {
      uint32_t acc;
      int32_t idx;
      onehot_chain_lane<kReduce, kUnroll, kPow2>(
          m, uint32_t(f) * 4, uint32_t(lb) * 4, R, iters, acc, idx);
      state[s.lane0 + f] = wrap(acc);
      state[size_t(L) + s.lane0 + f] = idx;
    }
  }
}

// P10, lane by lane: each rank's two rows, then each step's max over the
// warp's ranks.
inline void host_concat(const int32_t* x, int L, int32_t* state,
                        int iters) {
  for (int lane = 0; lane < L; ++lane) {
    int32_t r0[kWarp], r1[kWarp];
    for (int t = 0; t < kWarp; ++t)
      concat_rows(x, size_t(L), lane, t, r0[t], r1[t]);
    uint32_t acc = 0;
    for (int i = 0; i < iters; ++i) {
      int32_t v = INT32_MIN;
      for (int t = 0; t < kWarp; ++t) {
        const int32_t m = concat_rank(r0[t], r1[t], i);
        v = m > v ? m : v;
      }
      acc += uint32_t(v);
    }
    state[lane] = wrap(acc);
  }
}

// P16, block by block: every rank stages the block's columns, then each
// of its lanes runs, a step's max over the warp's ranks; the scratch is
// the ranks' last two words.
template <bool kPow2>
void host_refill(const int32_t* x, int W, int L, int32_t* state,
                 int32_t* scratch, int iters) {
  const int lb = window_lanes(WINDOW_REFILL, W), col = refill_column(W);
  const int32_t chunks = W / kChunk, mod = 16 * W;
  std::vector<int32_t> sm(size_t(window_bytes(WINDOW_REFILL, W)) / 4);
  const Shared m{reinterpret_cast<uintptr_t>(sm.data())};
  for (int b = 0; b * lb < L; ++b) {
    const Slice s = block_slice(W, lb, L, b);
    bool two = false;
    for (int t = 0; t < kThreads; ++t)
      two = stage_major_in(sm.data(), x, s, t, kThreads);
    if (two)
      for (int t = 0; t < kThreads; ++t)
        stage_major_out(sm.data(), s, t, kThreads);
    for (int f = 0; f < s.nl; ++f) {
      const size_t lane = size_t(s.lane0 + f);
      uint32_t acc = 0;
      int32_t base = 0, v0[kWarp] = {}, v1[kWarp] = {};
      for (int i = 0; i < iters; ++i) {
        int32_t v = INT32_MIN;
        for (int t = 0; t < kWarp; ++t) {
          const int32_t mt = refill_rank(m, rank_at(f, t, lb, col),
                                         base >> kBaseShift, chunks, v0[t],
                                         v1[t]);
          v = mt > v ? mt : v;
        }
        refill_carry<kPow2>(acc, base, v, mod);
      }
      state[lane] = wrap(acc);
      state[size_t(L) + lane] = base;
      if (scratch != nullptr)
        for (int t = 0; t < kWarp; ++t) {
          scratch[t * size_t(L) + lane] = v0[t];
          scratch[(kChunk + t) * size_t(L) + lane] = v1[t];
        }
    }
  }
}

}  // namespace lzm3

extern "C" {

// One warp's 32 threads, each with its K slots; a vote takes each
// thread's test of its slots, then their max.
int lzm3_vote_chain(int mode, const int32_t* node0, int L, int32_t* node,
                    int32_t* state, int iters, void* /*stream*/) {
  using namespace lzm3;
  if (bad_vote(mode, L, iters)) return ERR_ARGS;
  using Fn = void (*)(const int32_t*, int, int32_t*, int32_t*, int);
  // [mode][log2 of the slots]
  static const Fn fns[3][6] = {
      {host_vote<VOTE_ANY, 1>, host_vote<VOTE_ANY, 2>,
       host_vote<VOTE_ANY, 4>, host_vote<VOTE_ANY, 8>,
       host_vote<VOTE_ANY, 16>, host_vote<VOTE_ANY, 32>},
      {host_vote<VOTE_MAX, 1>, host_vote<VOTE_MAX, 2>,
       host_vote<VOTE_MAX, 4>, host_vote<VOTE_MAX, 8>,
       host_vote<VOTE_MAX, 16>, host_vote<VOTE_MAX, 32>},
      {host_vote<VOTE_FLAG, 1>, host_vote<VOTE_FLAG, 2>,
       host_vote<VOTE_FLAG, 4>, host_vote<VOTE_FLAG, 8>,
       host_vote<VOTE_FLAG, 16>, host_vote<VOTE_FLAG, 32>}};
  fns[mode][log2_of(vote_slots(L))](node0, L, node, state, iters);
  return 0;
}

int lzm3_vote_slots(int L) {
  return lzm3::bad_vote(lzm3::VOTE_ANY, L, 0) ? lzm3::ERR_ARGS
                                              : lzm3::vote_slots(L);
}

int lzm3_byte_chain(int mode, const int32_t* v0, int L, int32_t* v,
                    int iters, void* /*stream*/) {
  if (lzm3::bad_byte(mode, L, iters)) return lzm3::ERR_ARGS;
  for (int l = 0; l < L; ++l)
    v[l] = mode == lzm3::BYTE_SHIFT
               ? lzm3::byte_chain_lane<lzm3::BYTE_SHIFT>(v0[l], iters,
                                                         lzm3::kBytePick)
               : lzm3::byte_chain_lane<lzm3::BYTE_SELECT>(v0[l], iters,
                                                          lzm3::kBytePick);
  return 0;
}

// The host's byte permute of each v[j] with 0 (tests only): by selector
// s, or by P11a's own ((v[j] & 3) | kBytePick) where s is -1.
void lzm3_byte_perm(const int32_t* v, int n, int s, int32_t* out) {
  for (int j = 0; j < n; ++j) {
    const uint32_t u = uint32_t(v[j]);
    out[j] = lzm3::wrap(lzm3::byte_perm(
        u, s == -1 ? (u & 3u) | lzm3::kBytePick : uint32_t(s)));
  }
}

int lzm3_onehot_chain(int reduce, int unroll, const int32_t* x, int R, int L,
                      int32_t* state, int iters, void* /*stream*/) {
  using namespace lzm3;
  if (bad_onehot(reduce, unroll, R, L, iters)) return ERR_ARGS;
  using Fn = void (*)(const int32_t*, int, int, int32_t*, int);
  // [reduce][unroll == 8][R a power of two]
  static const Fn fns[2][2][2] = {
      {{host_onehot<REDUCE_SUM, 1, false>, host_onehot<REDUCE_SUM, 1, true>},
       {host_onehot<REDUCE_SUM, 8, false>, host_onehot<REDUCE_SUM, 8, true>}},
      {{host_onehot<REDUCE_MAX, 1, false>, host_onehot<REDUCE_MAX, 1, true>},
       {host_onehot<REDUCE_MAX, 8, false>,
        host_onehot<REDUCE_MAX, 8, true>}}};
  fns[reduce][unroll == 8][pow2(R)](x, R, L, state, iters);
  return 0;
}

int lzm3_window_chain(int mode, const int32_t* x, int W, int L,
                      int32_t* state, int32_t* scratch, int iters,
                      void* /*stream*/) {
  using namespace lzm3;
  if (bad_window(mode, W, L, iters)) return ERR_ARGS;
  if (mode == WINDOW_CONCAT)
    host_concat(x, L, state, iters);
  else if (pow2(W))
    host_refill<true>(x, W, L, state, scratch, iters);
  else
    host_refill<false>(x, W, L, state, scratch, iters);
  return 0;
}

const char* lzm3_error_string(int code) {
  return code == lzm3::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_MOSAIC3_CUH_
