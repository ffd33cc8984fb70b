// One thread of the bisect probe kernel: the sixteen bodies of the JAX
// package's Pallas probe tools/probe_lane2d_bisect.py (try_case), in
// scalar code, as the stages of probe_lane.cuh's bit decode they are made
// of.
//
// Compiled for the card by probes_bisect.cu (one thread per lane) and, as
// a test aid, for the host by g++ (-x c++ -DLZP_HOST_ENTRY), which then
// also defines the C interface of probes_bisect.cu as a host loop over
// lanes, so the logic is checked on the CPU against the plain PyTorch
// version (ops/probes_bisect.py).
//
// A body is four stages on the state (idx, acc, rng, cod):
//   index: none, the bit decode's climb (idx += #{k < 10 : acc > k}) or a
//          step (idx += acc & 1), each but none then clipped to [0, 647];
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

#include "probe_lane.cuh"

#if defined(__CUDACC__)
#define LZB_FN __host__ __device__ constexpr
#else
#define LZB_FN constexpr
#endif

namespace lzb {

using lzp::BitState;
using lzp::kRows;
using lzp::LaneMinorTable;
using lzp::wrap;

constexpr int kBlock = 128;   // threads per block
constexpr int kConstRow = 5;  // w2's and w8's row
constexpr int ERR_ARGS = -1;  // a bad argument: nothing was launched

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

// A table that is read and never written: v3's decode_bit drops its store.
struct ReadOnlyTable {
  LaneMinorTable t;
  LZP_FN int32_t load(int r) const { return t.load(r); }
  LZP_FN void store(int, int32_t) const {}
};

template <int kRead>
LZP_FN int32_t read_value(const LaneMinorTable& tab, int32_t idx) {
  const uint32_t in = uint32_t(idx) < uint32_t(kRows) ? 1u : 0u;
  if (kRead == READ_IDX) return idx;
  if (kRead == READ_ROW) return tab.load(idx);
  if (kRead == READ_MAX0) {
    const int32_t v = tab.load(idx);
    return v > 0 ? v : 0;
  }
  if (kRead == READ_COLUMN) {
    uint32_t sum = 0;
    for (int r = 0; r < kRows; ++r) sum += uint32_t(tab.load(r));
    return wrap(sum);
  }
  if (kRead == READ_CONST_ROW) return tab.load(kConstRow);
  if (kRead == READ_MASK) return wrap(in);
  if (kRead == READ_FIRST_TWO) return (idx == 0) + (idx == 1);
  return wrap(7u * in + uint32_t(tab.load(kConstRow)));  // READ_MASK7_ROW
}

// One iteration of body kMode on the state. v3 and v4 are
// probe_lane.cuh's bit-decode step itself (bitdecode_iter: the climb, the
// clip, decode_bit, shift_in), v3 over a table that drops the store.
template <int kMode>
LZP_FN void bisect_iter(const LaneMinorTable& tab, lzp::RegState& st) {
  if (range_bit(kMode)) {
    if (writes(kMode))
      lzp::bitdecode_iter(tab, st);
    else
      lzp::bitdecode_iter(ReadOnlyTable{tab}, st);
    return;
  }
  BitState s = st.load();
  if (index_of(kMode) == IDX_CLIMB) {
#if defined(__CUDACC__)
#pragma unroll
#endif
    for (int k = 0; k < 10; ++k)
      s.idx = wrap(uint32_t(s.idx) + (s.acc > k ? 1u : 0u));
  } else if (index_of(kMode) == IDX_STEP) {
    s.idx = wrap(uint32_t(s.idx) + uint32_t(s.acc & 1));
  }
  if (index_of(kMode) != IDX_KEEP)
    s.idx = s.idx < 0 ? 0 : (s.idx > kRows - 1 ? kRows - 1 : s.idx);
  const int32_t p = read_value<read_of(kMode)>(tab, s.idx);
  s.acc = lzp::shift_in(s.acc, uint32_t(p & 1));
  st.store(s);
}

// One lane of body kMode: x is the [kRows, L] input (lane-minor, the
// probe's [ROWS, S, 128] with lanes flattened), state the [4, L] carry
// (idx, acc, rng, cod; the start in, the end out), out[lane] = idx + acc +
// rng + cod after `iters` iterations. The body that writes (v4) works on
// tab ([kRows, L]), into which the lane copies its column of x first, as
// the probe copies x into its scratch; the others read x itself.
template <int kMode>
LZP_FN void bisect_lane(const int32_t* x, int32_t* tab, int32_t* state,
                        int32_t* out, int L, int lane, int iters) {
  const size_t sL = size_t(L);
  // read-only modes never store through the table: x is not written
  int32_t* col = writes(kMode) ? tab + lane : const_cast<int32_t*>(x) + lane;
  const LaneMinorTable t{col, L};
  if (writes(kMode))
    for (int r = 0; r < kRows; ++r) t.store(r, x[r * sL + lane]);
  lzp::RegState st{BitState{state[lane], state[sL + lane],
                            uint32_t(state[2 * sL + lane]),
                            uint32_t(state[3 * sL + lane])}};
#if defined(__CUDACC__)
#pragma unroll 1
#endif
  for (int it = 0; it < iters; ++it) bisect_iter<kMode>(t, st);
  const BitState& s = st.s;
  state[lane] = s.idx;
  state[sL + lane] = s.acc;
  state[2 * sL + lane] = wrap(s.rng);
  state[3 * sL + lane] = wrap(s.cod);
  out[lane] = wrap(uint32_t(s.idx) + uint32_t(s.acc) + s.rng + s.cod);
}

LZP_FN bool bad_args(int mode, const int32_t* tab, int L, int iters) {
  return mode < 0 || mode >= N_MODES || L < 1 || iters < 0 ||
         (writes(mode) && tab == nullptr);
}

}  // namespace lzb

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_bisect.cu's C interface as a host loop over lanes (tests only).
// The stream argument is ignored.
extern "C" {

int lzb_bisect(int mode, const int32_t* x, int32_t* tab, int32_t* state,
               int32_t* out, int L, int iters, void* /*stream*/) {
  if (lzb::bad_args(mode, tab, L, iters)) return lzb::ERR_ARGS;
  using namespace lzb;
  for (int l = 0; l < L; ++l) {
    switch (mode) {
#define LZB_CASE(m)                                       \
  case m:                                                 \
    bisect_lane<m>(x, tab, state, out, L, l, iters);      \
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
