// One thread of each mosaic3 probe kernel: the per-lane functions of the
// JAX package's Pallas probes tools/probe_mosaic3.py, in scalar code.
//
// Compiled for the card by probes_mosaic3.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_mosaic3.cu as host loops over threads, so the logic
// is checked on the CPU against the plain PyTorch versions
// (ops/probes_mosaic3.py). The block-wide vote of vote_chain is the one
// part that is not per thread: the card's kernel votes with its block, the
// host loop steps every lane one iteration at a time and votes over all.
//
// Integer semantics are the probes': wrapping int32 (every add that can
// wrap is done in uint32_t and converted back), an arithmetic >> of int32,
// and an index is jnp's `%` of a wrapped int32 (lzm::floor_mod of
// lzm::wrap, shared with probe_mosaic.cuh).
#ifndef LZMA_RS_TPU_TORCH_PROBE_MOSAIC3_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_MOSAIC3_CUH_

#include "probe_mosaic.cuh"

namespace lzm3 {

using lzm::floor_mod;
using lzm::wrap;

constexpr int kBlock = 128;        // threads per block (all but vote)
constexpr int kMaxLanes = 1024;    // vote_chain: all lanes in one block
constexpr int kVoteBelow = 5;      // P7-P9: run while a lane is below 5
constexpr int kWindowRows = 64;    // P10's rows; P16's scratch rows
constexpr int kChunk = 32;         // P16: rows per chunk
constexpr int kBaseRow = 128;      // P16: row0 = base // 128
constexpr int kBaseStep = 129;     // P16: base = (base + v + 129) % 16 W
constexpr int ERR_ARGS = -1;       // a bad argument: nothing was launched

enum { VOTE_ANY = 0, VOTE_MAX = 1, VOTE_FLAG = 2 };  // P7, P8, P9
enum { BYTE_SHIFT = 0, BYTE_SELECT = 1 };            // P11a, P11b
enum { REDUCE_SUM = 0, REDUCE_MAX = 1 };             // P12s; P12m-P15
enum { WINDOW_CONCAT = 0, WINDOW_REFILL = 1 };       // P10, P16

// P7-P9's body: node += i & 1.
LZM_FN int32_t vote_step(int32_t node, int i) {
  return wrap(uint32_t(node) + uint32_t(i & 1));
}

// P11a (a variable per-lane shift) and P11b (a 4-way select of constant
// shifts), written as the probe writes them; the same value.
template <int kMode>
LZM_FN int32_t byte_step(int32_t v, int i) {
  int32_t b;
  if (kMode == BYTE_SHIFT) {
    b = (v >> ((v & 3) * 8)) & 0xFF;
  } else {
    const int32_t k = v & 3;
    b = k == 0   ? v & 0xFF
        : k == 1 ? (v >> 8) & 0xFF
        : k == 2 ? (v >> 16) & 0xFF
                 : (v >> 24) & 0xFF;
  }
  return wrap(uint32_t(b) + uint32_t(i));
}

template <int kMode>
LZM_FN int32_t byte_chain_lane(int32_t v, int iters) {
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) v = byte_step<kMode>(v, i);
  return v;
}

// P12s, P12m, P13, P14, P15 on a lane-minor table x ([R, L]), one lane:
// v = x[idx] (REDUCE_SUM: the one-hot sum is the element) or
// max(x[idx], 0) (REDUCE_MAX: the one-hot's zeros take part in the max,
// R >= 2); acc += v; idx = (idx + v + 1) % R. `iters` dependent reads in
// iters / kUnroll loop passes of kUnroll reads each. state: [2, L], acc
// then idx (floor-reduced into [0, R) at the start; the probes start at
// 0), the start in, the end out.
template <int kReduce, int kUnroll>
LZM_FN void onehot_chain_lane(const int32_t* x, int R, int L, int lane,
                              int32_t* state, int iters) {
  uint32_t acc = uint32_t(state[lane]);
  int32_t idx = floor_mod(state[size_t(L) + lane], R);
  LZM_UNROLL(unroll 1)
  for (int p = 0; p < iters / kUnroll; ++p) {
    LZM_UNROLL(unroll)
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t w = x[size_t(idx) * L + lane];
      const int32_t v = kReduce == REDUCE_MAX && w < 0 ? 0 : w;
      acc += uint32_t(v);
      idx = floor_mod(wrap(uint32_t(idx) + uint32_t(v) + 1u), R);
    }
  }
  state[lane] = wrap(acc);
  state[size_t(L) + lane] = idx;
}

// The max over one P16 chunk (32 rows from row 32 c of lane `lane`), or 0
// where the chunk lies outside x's W / 32 chunks (the probe's zeros).
LZM_FN int32_t chunk_max(const int32_t* x, int chunks, int L, int lane,
                         int32_t c, int32_t m) {
  if (c < 0 || c >= chunks) return m > 0 ? m : 0;
  const int32_t* p = x + size_t(c) * kChunk * L + lane;
  LZM_UNROLL(unroll 8)
  for (int r = 0; r < kChunk; ++r) {
    const int32_t v = p[size_t(r) * L];
    m = v > m ? v : m;
  }
  return m;
}

// P10 and P16 on a lane-minor table x ([W, L]), one lane; state: [2, L],
// acc then base (P16; floor-reduced into [0, 16 W) at the start), the
// start in, the end out.
//   WINDOW_CONCAT (P10): acc += max over rows r < 64 of (x[r] + i), the
//                  add wrapping per element before the max.
//   WINDOW_REFILL (P16): row0 = base // 128; v = the max over chunks row0
//                  and row0 + 1 (32 rows each; a chunk >= W / 32 is
//                  zeros); base = (base + v + 129) % 16 W; acc += v.
//                  `scratch` ([64, L]) or null: the last step's two
//                  chunks (zeros when iters is 0).
template <int kMode>
LZM_FN void window_chain_lane(const int32_t* x, int W, int L, int lane,
                              int32_t* state, int32_t* scratch, int iters) {
  const size_t sL = size_t(L);
  uint32_t acc = uint32_t(state[lane]);
  if (kMode == WINDOW_CONCAT) {
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      int32_t m = INT32_MIN;
      LZM_UNROLL(unroll 8)
      for (int r = 0; r < kWindowRows; ++r) {
        const int32_t v = wrap(uint32_t(x[r * sL + lane]) + uint32_t(i));
        m = v > m ? v : m;
      }
      acc += uint32_t(m);
    }
    state[lane] = wrap(acc);
    return;
  }
  const int chunks = W / kChunk;
  const int32_t mod = 16 * W;
  int32_t base = floor_mod(state[sL + lane], mod);
  int32_t row0 = -2;  // no chunk: the scratch is zeros
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    row0 = base / kBaseRow;
    const int32_t v = chunk_max(x, chunks, L, lane, row0 + 1,
                                chunk_max(x, chunks, L, lane, row0,
                                          INT32_MIN));
    acc += uint32_t(v);
    base = floor_mod(wrap(uint32_t(base) + uint32_t(v) + kBaseStep), mod);
  }
  state[lane] = wrap(acc);
  state[sL + lane] = base;
  if (scratch == nullptr) return;
  for (int h = 0; h < 2; ++h) {
    const int32_t c = row0 + h;
    const bool in = c >= 0 && c < chunks;
    for (int r = 0; r < kChunk; ++r)
      scratch[(h * kChunk + r) * sL + lane] =
          in ? x[(size_t(c) * kChunk + r) * sL + lane] : 0;
  }
}

// Argument checks shared by the card's and the host's C interface.
LZM_FN bool bad_vote(int mode, int L, int iters) {
  return mode < VOTE_ANY || mode > VOTE_FLAG || L < 1 || L > kMaxLanes ||
         iters < 0;
}

LZM_FN bool bad_byte(int mode, int L, int iters) {
  return (mode != BYTE_SHIFT && mode != BYTE_SELECT) || L < 0 || iters < 0;
}

LZM_FN bool bad_onehot(int reduce, int unroll, int R, int L, int iters) {
  return (reduce != REDUCE_SUM && reduce != REDUCE_MAX) ||
         (unroll != 1 && unroll != 8) || R < 1 ||
         (reduce == REDUCE_MAX && R < 2) || L < 0 || iters < 0 ||
         iters % unroll;
}

LZM_FN bool bad_window(int mode, int W, int L, int iters) {
  if ((mode != WINDOW_CONCAT && mode != WINDOW_REFILL) || L < 0 ||
      iters < 0)
    return true;
  if (mode == WINDOW_CONCAT) return W < kWindowRows;
  return W < kChunk || W % kChunk || W > (1 << 26);
}

}  // namespace lzm3

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_mosaic3.cu's C interface as host loops over threads (tests
// only). The stream argument is ignored.
extern "C" {

// All lanes step together; the vote is over every lane (lzm3 comment).
int lzm3_vote_chain(int mode, const int32_t* node0, int L, int32_t* node,
                    int32_t* state, int iters, void* /*stream*/) {
  if (lzm3::bad_vote(mode, L, iters)) return lzm3::ERR_ARGS;
  auto below = [&]() {
    int any = 0;
    for (int l = 0; l < L; ++l) any |= node[l] < lzm3::kVoteBelow;
    return any;
  };
  for (int l = 0; l < L; ++l) node[l] = node0[l];
  int i = 0, flag = 1;
  for (;;) {
    if (mode != lzm3::VOTE_FLAG) flag = below();
    if (!flag || i >= iters) break;
    for (int l = 0; l < L; ++l) node[l] = lzm3::vote_step(node[l], i);
    ++i;
    if (mode == lzm3::VOTE_FLAG) flag = below();
  }
  state[0] = i;
  state[1] = flag;
  return 0;
}

int lzm3_byte_chain(int mode, const int32_t* v0, int L, int32_t* v,
                    int iters, void* /*stream*/) {
  if (lzm3::bad_byte(mode, L, iters)) return lzm3::ERR_ARGS;
  for (int l = 0; l < L; ++l)
    v[l] = mode == lzm3::BYTE_SHIFT
               ? lzm3::byte_chain_lane<lzm3::BYTE_SHIFT>(v0[l], iters)
               : lzm3::byte_chain_lane<lzm3::BYTE_SELECT>(v0[l], iters);
  return 0;
}

int lzm3_onehot_chain(int reduce, int unroll, const int32_t* x, int R, int L,
                      int32_t* state, int iters, void* /*stream*/) {
  if (lzm3::bad_onehot(reduce, unroll, R, L, iters)) return lzm3::ERR_ARGS;
  using lzm3::REDUCE_MAX;
  using lzm3::REDUCE_SUM;
  for (int l = 0; l < L; ++l) {
    if (reduce == REDUCE_SUM && unroll == 1)
      lzm3::onehot_chain_lane<REDUCE_SUM, 1>(x, R, L, l, state, iters);
    else if (reduce == REDUCE_SUM)
      lzm3::onehot_chain_lane<REDUCE_SUM, 8>(x, R, L, l, state, iters);
    else if (unroll == 1)
      lzm3::onehot_chain_lane<REDUCE_MAX, 1>(x, R, L, l, state, iters);
    else
      lzm3::onehot_chain_lane<REDUCE_MAX, 8>(x, R, L, l, state, iters);
  }
  return 0;
}

int lzm3_window_chain(int mode, const int32_t* x, int W, int L,
                      int32_t* state, int32_t* scratch, int iters,
                      void* /*stream*/) {
  if (lzm3::bad_window(mode, W, L, iters)) return lzm3::ERR_ARGS;
  for (int l = 0; l < L; ++l) {
    if (mode == lzm3::WINDOW_CONCAT)
      lzm3::window_chain_lane<lzm3::WINDOW_CONCAT>(x, W, L, l, state,
                                                   scratch, iters);
    else
      lzm3::window_chain_lane<lzm3::WINDOW_REFILL>(x, W, L, l, state,
                                                   scratch, iters);
  }
  return 0;
}

const char* lzm3_error_string(int code) {
  return code == lzm3::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_MOSAIC3_CUH_
