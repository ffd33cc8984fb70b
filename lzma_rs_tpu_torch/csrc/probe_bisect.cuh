// One block of the bisect probe kernel: the sixteen bodies of the JAX
// package's Pallas probe tools/probe_lane2d_bisect.py (try_case), in
// scalar code, as the stages of a bit decode they are made of, and the
// per-rank pieces of a block's shared work (the staging of its lanes'
// table, w1's split column sum, the write-back).
//
// Compiled for the card by probes_bisect.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_bisect.cu as host loops over blocks, their ranks and
// their lanes, in an order the card's barriers allow (every rank's
// staging before any lane's chain; each iteration's column parts before
// the lane's combine), so the logic is checked on the CPU against the
// plain PyTorch version (ops/probes_bisect.py).
//
// A body is four stages on the state (idx, acc, rng, cod):
//   index: none, the bit decode's climb (idx += #{k < 10 : acc > k}, in
//          closed form: lzp::climb_clip) or a step (idx += acc & 1), each
//          but none then clipped to [0, 647];
//   read:  the value p a bit is taken from (a table row, a mask, ...);
//   bit:   p & 1, or the range-coder bit of p (rng and cod move);
//   write: none, or the range coder's adapted p back to its row;
// then acc = (acc << 1) | bit, 1 above 0x100. The TPU probe's one-hot
// forms of a read (a select or a multiply-mask and a sum or max over the
// rows, in one or two halves) compute the row's value, so the sixteen
// bodies are eleven functions here (the modes below). Integer semantics
// are wrapping int32 and uint32, as in probe_lane.cuh.
#ifndef LZMA_RS_TPU_TORCH_PROBE_BISECT_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_BISECT_CUH_

#include <string.h>

#include "probe_lane.cuh"

#if defined(__CUDACC__)
#define LZB_FN __host__ __device__ constexpr
#define LZB_UNROLL(n) _Pragma(#n)
#else
#define LZB_FN constexpr
#define LZB_UNROLL(n)
#endif

namespace lzb {

using lzp::BitState;
using lzp::kRows;
using lzp::LaneMinorTable;
using lzp::wrap;

constexpr int kLanes = 32;    // lanes a block: one warp of chains
constexpr int kThreads = 256; // threads a block: all stage, write back
                              // and sum w1's column
constexpr int kWarps = kThreads / kLanes;
constexpr int kPartRows = kRows / kWarps;  // w1: rows a warp sums (81)
constexpr int kChunk = 16;    // bytes of one staging copy
constexpr int kConstRow = 5;  // w2's and w8's row
constexpr int ERR_ARGS = -1;  // a bad argument: nothing was launched
static_assert(kRows % kWarps == 0 && kPartRows % 3 == 0,
              "w1's parts split the column evenly, three sums a part");

// A block's dynamic shared memory: its lanes' [kRows, kLanes] slice of
// the table, then w1's column parts (two buffers of [kWarps, kLanes]).
constexpr int kSliceWords = kRows * kLanes;
constexpr int kPartWords = kWarps * kLanes;
constexpr int kBlockBytes = (kSliceWords + 2 * kPartWords) * 4;  // 84,992

enum Index { IDX_KEEP, IDX_CLIMB, IDX_STEP };
enum Read {
  READ_IDX,        // v1: p = idx
  READ_ROW,        // p = tab[idx]
  READ_MAX0,       // v2max: max(tab[idx], 0), the max over a column that
                   // is 0 off the row
  READ_COLUMN,     // w1: the wrapping sum of the lane's whole column
  READ_CONST_ROW,  // w2: tab[5]
  READ_MASK,       // w3: the mask's sum, #{r : r == idx} (1: idx clipped)
  READ_FIRST_TWO,  // w4: (idx == 0) + (idx == 1)
  READ_MASK7_ROW,  // w8: 7 #{r : r == idx} + tab[5]
};

// The kernel's modes. v2m and v2bt are v2, v5 is v4, w6 and w7 are w5.
enum {
  MODE_V1,
  MODE_V2,
  MODE_V2MAX,
  MODE_V3,
  MODE_V4,
  MODE_W1,
  MODE_W2,
  MODE_W3,
  MODE_W4,
  MODE_W5,
  MODE_W8,
  N_MODES
};

LZB_FN int index_of(int mode) {
  return mode <= MODE_V4 ? IDX_CLIMB
                         : (mode <= MODE_W2 ? IDX_KEEP : IDX_STEP);
}

LZB_FN int read_of(int mode) {
  switch (mode) {
    case MODE_V1: return READ_IDX;
    case MODE_V2MAX: return READ_MAX0;
    case MODE_W1: return READ_COLUMN;
    case MODE_W2: return READ_CONST_ROW;
    case MODE_W3: return READ_MASK;
    case MODE_W4: return READ_FIRST_TWO;
    case MODE_W8: return READ_MASK7_ROW;
    default: return READ_ROW;  // v2, v3, v4, w5
  }
}

// v3 and v4: the range-coder bit (v4 also writes the row back).
LZB_FN bool range_bit(int mode) {
  return mode == MODE_V3 || mode == MODE_V4;
}
LZB_FN bool writes(int mode) { return mode == MODE_V4; }

// Whether a mode stages its block's slice into shared memory: the modes
// that read rows (v2, v2max, v3, v4, w1, w5). v1, w3 and w4 read no row
// and w2 and w8 only row 5, which they read from x itself: staged, they
// took 0-2 cycles an iteration less on the H100 and 0.9-1.0 us more set-up
// a call (PERF.md).
LZB_FN bool stages(int mode) {
  const int r = read_of(mode);
  return r == READ_ROW || r == READ_MAX0 || r == READ_COLUMN;
}

// A lane's column of the staged slice: row r at col[r * kLanes], a 32-bit
// offset (the slice is 82,944 B).
struct SliceColumn {
  int32_t* col;
  LZP_FN int32_t load(int r) const { return col[r * kLanes]; }
  LZP_FN void store(int r, int32_t v) const { col[r * kLanes] = v; }
};

// A table that is read and never written: v3's decode_bit drops its store.
template <class Tab>
struct ReadOnly {
  Tab t;
  LZP_FN int32_t load(int r) const { return t.load(r); }
  LZP_FN void store(int, int32_t) const {}
};

template <int kRead, class Tab>
LZP_FN int32_t read_value(const Tab& tab, int32_t idx) {
  const uint32_t in = uint32_t(idx) < uint32_t(kRows) ? 1u : 0u;
  if (kRead == READ_IDX) return idx;
  if (kRead == READ_ROW) return tab.load(idx);
  if (kRead == READ_MAX0) {
    const int32_t v = tab.load(idx);
    return v > 0 ? v : 0;
  }
  if (kRead == READ_CONST_ROW) return tab.load(kConstRow);
  if (kRead == READ_MASK) return wrap(in);
  if (kRead == READ_FIRST_TWO) return (idx == 0) + (idx == 1);
  return wrap(7u * in + uint32_t(tab.load(kConstRow)));  // READ_MASK7_ROW
}

// One iteration of body kMode on the state: the index stage, the read,
// the bit (v3 and v4: probe_lane.cuh's decode_bit, v3 over a table that
// drops the store), the shift-in. One dependent chain: the next
// iteration's row is not loaded ahead (bitdecode_chain does that; here
// v2 - v1 is the load's cost, which a load issued ahead would hide).
// `column` is w1's read, the column's sum from the block's ranks.
template <int kMode, class Tab>
LZP_FN void bisect_iter(const Tab& tab, BitState& s, int32_t column) {
  if (index_of(kMode) == IDX_CLIMB) {
    s.idx = lzp::climb_clip(s.idx, s.acc);
  } else if (index_of(kMode) == IDX_STEP) {
    const int32_t i = wrap(uint32_t(s.idx) + uint32_t(s.acc & 1));
    s.idx = i < 0 ? 0 : (i > kRows - 1 ? kRows - 1 : i);
  }
  uint32_t bit;
  if (range_bit(kMode)) {
    bit = writes(kMode) ? lzp::decode_bit(tab, s)
                        : lzp::decode_bit(ReadOnly<Tab>{tab}, s);
  } else {
    const int32_t p = read_of(kMode) == READ_COLUMN
                          ? column
                          : read_value<read_of(kMode)>(tab, s.idx);
    bit = uint32_t(p & 1);
  }
  s.acc = lzp::shift_in(s.acc, bit);
}

// The state of lane `lane` of L from start ([4, L]: idx, acc, rng, cod),
// and its end into state ([4, L]) and out[lane] = idx + acc + rng + cod.
LZP_FN BitState load_state(const int32_t* start, size_t L, int lane) {
  return BitState{start[lane], start[L + lane], uint32_t(start[2 * L + lane]),
                  uint32_t(start[3 * L + lane])};
}

LZP_FN void store_state(int32_t* state, int32_t* out, size_t L, int lane,
                        const BitState& s) {
  state[lane] = s.idx;
  state[L + lane] = s.acc;
  state[2 * L + lane] = wrap(s.rng);
  state[3 * L + lane] = wrap(s.cod);
  out[lane] = wrap(uint32_t(s.idx) + uint32_t(s.acc) + s.rng + s.cod);
}

// `iters` iterations of body kMode (not w1) for one lane over `tab`.
template <int kMode, class Tab>
LZP_FN void bisect_lane(const Tab& tab, const int32_t* start, int32_t* state,
                        int32_t* out, size_t L, int lane, int iters) {
  BitState s = load_state(start, L, lane);
  LZB_UNROLL(unroll 1)
  for (int it = 0; it < iters; ++it) bisect_iter<kMode>(tab, s, 0);
  store_state(state, out, L, lane, s);
}

// w1's column sum, split over the block's warps: warp w's part of lane
// t's column (rows [w kPartRows, (w + 1) kPartRows) of the slice), in
// three sums so the adds are not one chain; then the lane's combine of
// the parts in warp order. uint32 adds wrap, so any order gives the plain
// version's sum.
LZP_FN uint32_t column_part(const int32_t* sm, int w, int t) {
  const int32_t* p = sm + w * kPartRows * kLanes + t;
  uint32_t a = 0, b = 0, c = 0;
  LZB_UNROLL(unroll 9)
  for (int r = 0; r < kPartRows; r += 3) {
    a += uint32_t(p[r * kLanes]);
    b += uint32_t(p[(r + 1) * kLanes]);
    c += uint32_t(p[(r + 2) * kLanes]);
  }
  return a + b + c;
}

LZP_FN int32_t column_of(const uint32_t* parts, int t) {
  uint32_t sum = 0;
  LZB_UNROLL(unroll)
  for (int w = 0; w < kWarps; ++w) sum += parts[w * kLanes + t];
  return wrap(sum);
}

// A block's lanes of the [kRows, L] table: nl (<= kLanes) of them from
// lane0, held in shared memory as [kRows, kLanes].
struct Slice {
  int L, lane0, nl;
};

LZP_FN Slice block_slice(int L, int b) {
  const int lane0 = b * kLanes;
  return {L, lane0, L - lane0 < kLanes ? L - lane0 : kLanes};
}

// Whether the slice moves in 16-byte chunks: a whole block, rows 16-byte
// aligned in x (L % 4 == 0 and x + lane0 on 16 bytes).
LZP_FN bool chunked(const int32_t* x, const Slice& s) {
  return s.nl == kLanes && s.L % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x + s.lane0) % kChunk == 0;
}

// Rank `tid` of `nt` copies its share of the block's slice of x into sm:
// in chunks by cp.async (neighbouring ranks on neighbouring chunks of a
// row; the rank waits for its own copies), or word by word for a
// part-filled block or unaligned rows. The block then meets at a barrier.
LZP_FN void stage_in(int32_t* sm, const int32_t* x, const Slice& s, int tid,
                     int nt) {
  if (chunked(x, s)) {
    constexpr int per_row = kLanes * 4 / kChunk;  // 8
    for (int i = tid; i < kRows * per_row; i += nt) {
      const int r = i / per_row, c = i % per_row;
      int32_t* dst = sm + r * kLanes + c * 4;
      const int32_t* src = x + size_t(r) * s.L + s.lane0 + c * 4;
#if defined(__CUDA_ARCH__)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                   "l"(src)
                   : "memory");
#else
      memcpy(dst, src, kChunk);
#endif
    }
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
  } else {
    for (int i = tid; i < kSliceWords; i += nt) {
      const int r = i / kLanes, t = i % kLanes;
      if (t < s.nl) sm[i] = x[size_t(r) * s.L + s.lane0 + t];
    }
  }
}

// Rank `tid` of `nt` writes its share of the slice back into tab ([kRows,
// L]) after the block's barrier: a warp a row, 128 bytes. (A mode that
// stages no slice writes nothing: its final table is x, which the
// launcher copies.)
LZP_FN void stage_out(int32_t* tab, const int32_t* sm, const Slice& s,
                      int tid, int nt) {
  for (int i = tid; i < kSliceWords; i += nt) {
    const int r = i / kLanes, t = i % kLanes;
    if (t < s.nl) tab[size_t(r) * s.L + s.lane0 + t] = sm[i];
  }
}

// A bad argument: mode out of range, no lane, negative iterations.
LZP_FN bool bad_args(int mode, int L, int iters) {
  return mode < 0 || mode >= N_MODES || L < 1 || iters < 0;
}

}  // namespace lzb

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_bisect.cu's C interface as host loops over blocks, ranks and
// lanes (tests only). The stream argument is ignored.
#include <vector>

namespace lzb {

template <int kMode>
void host_block(const int32_t* x, int32_t* tab, const int32_t* start,
                int32_t* state, int32_t* out, const Slice& s, int iters,
                std::vector<int32_t>& sm) {
  const size_t L = size_t(s.L);
  if (stages(kMode))
    for (int r = 0; r < kThreads; ++r) stage_in(sm.data(), x, s, r, kThreads);
  std::vector<uint32_t> parts(kPartWords);
  for (int t = 0; t < s.nl; ++t) {
    const int lane = s.lane0 + t;
    if (kMode == MODE_W1) {  // every iteration: the warps' parts, the combine
      const SliceColumn tab_t{sm.data() + t};
      BitState st = load_state(start, L, lane);
      for (int it = 0; it < iters; ++it) {
        for (int w = 0; w < kWarps; ++w)
          parts[w * kLanes + t] = column_part(sm.data(), w, t);
        bisect_iter<kMode>(tab_t, st, column_of(parts.data(), t));
      }
      store_state(state, out, L, lane, st);
    } else if (stages(kMode)) {
      bisect_lane<kMode>(SliceColumn{sm.data() + t}, start, state, out, L,
                         lane, iters);
    } else {
      bisect_lane<kMode>(
          LaneMinorTable{const_cast<int32_t*>(x) + lane, s.L}, start, state,
          out, L, lane, iters);
    }
  }
  if (stages(kMode) && tab != nullptr)
    for (int r = 0; r < kThreads; ++r)
      stage_out(tab, sm.data(), s, r, kThreads);
}

}  // namespace lzb

extern "C" {

int lzb_bisect(int mode, const int32_t* x, int32_t* tab,
               const int32_t* start, int32_t* state, int32_t* out, int L,
               int iters, void* /*stream*/) {
  using namespace lzb;
  if (bad_args(mode, L, iters)) return ERR_ARGS;
  if (tab != nullptr && !stages(mode))
    memcpy(tab, x, size_t(kRows) * size_t(L) * sizeof(int32_t));
  std::vector<int32_t> sm(kSliceWords);
  for (int b = 0; b <= (L - 1) / kLanes; ++b) {
    const Slice s = block_slice(L, b);
    switch (mode) {
#define LZB_CASE(m)                                                    \
  case m:                                                              \
    host_block<m>(x, tab, start, state, out, s, iters, sm);            \
    break;
      LZB_CASE(MODE_V1)
      LZB_CASE(MODE_V2)
      LZB_CASE(MODE_V2MAX)
      LZB_CASE(MODE_V3)
      LZB_CASE(MODE_V4)
      LZB_CASE(MODE_W1)
      LZB_CASE(MODE_W2)
      LZB_CASE(MODE_W3)
      LZB_CASE(MODE_W4)
      LZB_CASE(MODE_W5)
      LZB_CASE(MODE_W8)
#undef LZB_CASE
    }
  }
  return 0;
}

const char* lzb_error_string(int code) {
  return code == lzb::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_BISECT_CUH_
