// One thread of the mosaic4 probe kernel: the per-lane function of the
// JAX package's Pallas probes tools/probe_mosaic4.py (build and build2), in
// scalar code.
//
// Compiled for the card by probes_mosaic4.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_mosaic4.cu as a host loop over threads, so the logic
// is checked on the CPU against the plain PyTorch version
// (ops/probes_mosaic4.py).
//
// Integer semantics are the probe's: wrapping int32 (every add that can
// wrap is done in uint32_t and converted back), and `%` and `//` are jnp's
// floor mod and floor division of a wrapped int32 (lzm::floor_mod, shared
// with probe_mosaic.cuh).
#ifndef LZMA_RS_TPU_TORCH_PROBE_MOSAIC4_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_MOSAIC4_CUH_

#include "probe_mosaic.cuh"

namespace lzm4 {

using lzm::floor_mod;
using lzm::wrap;

constexpr int kBlock = 128;      // threads per block
constexpr int kW = 512;          // table rows ([512, L], lane-minor)
constexpr int kFill = 7;         // the table's value at the start
constexpr int kReset = 0x400;    // the reset value (LZMA's initial prob)
constexpr int kResetEvery = 17;  // reset where acc % 17 == 0
constexpr int kTile = 64;        // tile rows: two chunks
constexpr int kChunk = 32;       // rows per chunk
constexpr int kChunks = 4;       // chunks 0-3: rows 0-127 (W // 128)
constexpr int kRowOf = 128;      // the refill's row0 = idx // 128
constexpr int kRound = 16;       // steps per outer round
constexpr int kSched = 8;        // build2: rows of k
constexpr int ERR_ARGS = -1;     // a bad argument: nothing was launched

// build's variants: base; when_reset and when_reset_hoisted (one function:
// the block-wide guard of when_reset changes no result); when_reset_refed
// (the flags through the tile's row 0). build2's: max(k[ci], 0), k[ci],
// and the sum of k[r] (ci == r) over the 8 rows.
enum {
  MODE_BASE = 0,
  MODE_RESET = 1,
  MODE_RESET_REFED = 2,
  MODE_SCHED_MAX = 3,
  MODE_SCHED_SUM = 4,
  MODE_SCHED_BLEND = 5,
};

LZM_FN constexpr bool refills(int mode) { return mode < MODE_SCHED_MAX; }

// jnp's a // m for m > 0: the floor division.
LZM_FN int32_t floor_div(int32_t a, int32_t m) {
  return (a - floor_mod(a, m)) / m;
}

// The probe's loop for one lane `lane` of L. tab ([512, L] int32, lane-
// minor) is filled with 7 here; tile ([64, L]) is zeroed here and
// refilled each round (the build variants; null for build2, which has
// none). k: build2's [8, L] input (null for build). state: [2, L], idx
// then acc, the start in and the end out. From it = it0, while it <
// limit: a refill (build), then 16 steps, each
//   v = tab[idx] (0 when idx is outside [0, 512): the one-hot is empty);
//   build: tab[idx] = v + 1 where acc > 0; build2: v += the k term of
//   row ci = clip(acc, 0, 7);
//   idx = (idx + v) % 512; acc += 1;
//   the reset variants: where acc % 17 == 0 the lane's whole column is
//   0x400 (refed: the flag is written to tile[0] and read back);
//   it += 1.
// Returns the final it.
template <int kMode>
LZM_FN int32_t table_chain_lane(const int32_t* k, int L, int lane,
                                int32_t* tab, int32_t* tile,
                                int32_t* state, int32_t it0,
                                int32_t limit) {
  const size_t sL = size_t(L);
  int32_t* col = tab + lane;
  LZM_UNROLL(unroll 8)
  for (int r = 0; r < kW; ++r) col[r * sL] = kFill;
  int32_t* tcol = refills(kMode) ? tile + lane : nullptr;
  if (refills(kMode)) {
    LZM_UNROLL(unroll 8)
    for (int r = 0; r < kTile; ++r) tcol[r * sL] = 0;
  }
  int32_t idx = state[lane];
  uint32_t acc = uint32_t(state[sL + lane]);
  int32_t it = it0;
  LZM_UNROLL(unroll 1)
  while (it < limit) {
    if (refills(kMode)) {
      // tile[32 t + j] = chunk (row0 + t) of rows 0-127, zeros outside
      const int32_t row0 = floor_div(idx, kRowOf);
      for (int t = 0; t < 2; ++t) {
        const int32_t c = row0 + t;  // |row0| < 2^24: no wrap
        const bool in = c >= 0 && c < kChunks;
        LZM_UNROLL(unroll 8)
        for (int j = 0; j < kChunk; ++j)
          tcol[(t * kChunk + j) * sL] =
              in ? col[(size_t(c) * kChunk + j) * sL] : 0;
      }
    }
    LZM_UNROLL(unroll 1)
    for (int j = 0; j < kRound; ++j) {
      const bool in = uint32_t(idx) < uint32_t(kW);
      uint32_t v = in ? uint32_t(col[idx * sL]) : 0u;
      if (refills(kMode)) {
        if (in && int32_t(acc) > 0) col[idx * sL] = wrap(v + 1u);
      } else {
        const int32_t a = int32_t(acc);
        const int32_t ci = a < 0 ? 0 : a > kSched - 1 ? kSched - 1 : a;
        if (kMode == MODE_SCHED_MAX) {
          const int32_t kv = k[ci * sL + lane];
          v += uint32_t(kv > 0 ? kv : 0);
        } else if (kMode == MODE_SCHED_SUM) {
          v += uint32_t(k[ci * sL + lane]);
        } else {  // the probe's blend: every row, where ci == r
          // Written as a select: as a product k[r] * (ci == r) (or an
          // and with a mask of it), ptxas of CUDA 12.9 at its default -O3
          // added wrong rows at some steps on the H100 (right at
          // -Xptxas -O0, and right in this form).
          uint32_t sel = 0;
          LZM_UNROLL(unroll)
          for (int r = 0; r < kSched; ++r)
            sel += ci == r ? uint32_t(k[r * sL + lane]) : 0u;
          v += sel;
        }
      }
      idx = floor_mod(wrap(uint32_t(idx) + v), kW);
      acc += 1u;
      if (kMode == MODE_RESET || kMode == MODE_RESET_REFED) {
        bool flag = floor_mod(int32_t(acc), kResetEvery) == 0;
        if (kMode == MODE_RESET_REFED) {
          tcol[0] = flag;
          flag = tcol[0] == 1;
        }
        if (flag) {
          LZM_UNROLL(unroll 8)
          for (int r = 0; r < kW; ++r) col[r * sL] = kReset;
        }
      }
      it = wrap(uint32_t(it) + 1u);
    }
  }
  state[lane] = idx;
  state[sL + lane] = wrap(acc);
  return it;
}

LZM_FN bool bad_table(int mode, int L, int limit) {
  return mode < MODE_BASE || mode > MODE_SCHED_BLEND || L < 1 || limit < 0;
}

}  // namespace lzm4

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_mosaic4.cu's C interface as a host loop over threads (tests
// only). The stream argument is ignored.
extern "C" {

int lzm4_table_chain(int mode, const int32_t* k, int L, int32_t* tab,
                     int32_t* tile, int32_t* state, const int32_t* it0,
                     int32_t* it_out, int limit, void* /*stream*/) {
  if (lzm4::bad_table(mode, L, limit)) return lzm4::ERR_ARGS;
  using namespace lzm4;
  for (int l = 0; l < L; ++l) {
    int32_t it = 0;
    switch (mode) {
#define LZM4_CASE(m)                                                      \
  case m:                                                                 \
    it = table_chain_lane<m>(k, L, l, tab, tile, state, *it0, limit);     \
    break;
      LZM4_CASE(MODE_BASE)
      LZM4_CASE(MODE_RESET)
      LZM4_CASE(MODE_RESET_REFED)
      LZM4_CASE(MODE_SCHED_MAX)
      LZM4_CASE(MODE_SCHED_SUM)
      LZM4_CASE(MODE_SCHED_BLEND)
#undef LZM4_CASE
    }
    if (l == 0) *it_out = it;
  }
  return 0;
}

const char* lzm4_error_string(int code) {
  return code == lzm4::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_MOSAIC4_CUH_
