// One thread of each mosaic probe kernel: the per-lane functions of the
// JAX package's Pallas probes tools/probe_mosaic.py and
// tools/probe_mosaic2.py, in scalar code.
//
// Compiled for the card by probes_mosaic.cu and, as a test aid, for the
// host by g++ (-x c++ -DLZP_HOST_ENTRY), which then also defines the C
// interface of probes_mosaic.cu as host loops over threads, so the logic is
// checked on the CPU against the plain PyTorch versions
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

#if defined(__CUDACC__)
#define LZM_FN __host__ __device__ inline
#define LZM_UNROLL(n) _Pragma(#n)
#else
#define LZM_FN inline
#define LZM_UNROLL(n)
#endif

namespace lzm {

constexpr int kBlock = 128;        // threads per block
constexpr int kScalarStride = 37;  // row E: j = 37 i % W
constexpr int ERR_ARGS = -1;       // a bad argument: nothing was launched
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

// The i-th index of a walk from `start` by `stride`: wrap to int32, then
// the floor mod by `mod`.
LZM_FN int32_t walk(int32_t start, int32_t stride, int i, int32_t mod) {
  return floor_mod(wrap(uint32_t(start) + uint32_t(stride) * uint32_t(i)),
                   mod);
}

// A, B, C, F: sum over `iters` steps of x at the walk's index along one
// line of x ([rows, cols], row-major): row `line` (minor) or column `line`
// (major). The sum wraps in T (uint8 or int32). The loads are independent
// of each other; only the sum carries.
template <int kAxis, class T>
LZM_FN T gather_sum_elem(const T* x, int cols, int line, int32_t start,
                         int32_t stride, int32_t mod, int iters) {
  uint32_t acc = 0;
  LZM_UNROLL(unroll 4)
  for (int i = 0; i < iters; ++i) {
    const int32_t k = walk(start, stride, i, mod);
    acc += uint32_t(kAxis == AXIS_MINOR ? x[size_t(line) * cols + k]
                                        : x[size_t(k) * cols + line]);
  }
  return static_cast<T>(acc);
}

// D: `iters` read-modify-writes of one row (`cols` words): +1 at the
// walk's index from `start` by 1.
LZM_FN void rw_row(int32_t* row, int cols, int32_t start, int iters) {
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    const int32_t k = walk(start, 1, i, cols);
    row[k] = wrap(uint32_t(row[k]) + 1u);
  }
}

// E: one serial chain through memory: j = 37 i % W; v = x[j];
// x[(j + 1) % W] = v + carry; carry += v. Returns carry.
LZM_FN int32_t rw_scalar(int32_t* x, int cols, int iters) {
  uint32_t carry = 0;
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    const int32_t j = walk(0, kScalarStride, i, cols);
    const uint32_t v = uint32_t(x[j]);
    x[floor_mod(j + 1, cols)] = wrap(v + carry);
    carry += v;
  }
  return wrap(carry);
}

// p1/p2, p3, p6 on a lane-minor table x ([W, L]), one lane: a carried idx
// (floor-reduced into [0, W) at the start; the probes start at 0) and acc.
// state: [2, L], acc then idx, the start in, the end out.
//   ROW_CLAMP:       v = max(x[idx], 0); acc += v; idx = (idx + 1) % W
//   ROW_CLAMP_WRITE: the same, and x[idx] = v + 1 where v is odd
//   ROW_BYTE:        word = x[idx >> 2]; byte = word >> 8 (idx & 3) & 0xFF;
//                    acc += byte; idx = (idx + byte + 1) % W
template <int kMode>
LZM_FN void row_chain_lane(int32_t* x, int W, int L, int lane,
                           int32_t* state, int iters) {
  uint32_t acc = uint32_t(state[lane]);
  int32_t idx = floor_mod(state[size_t(L) + lane], W);
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    if (kMode == ROW_BYTE) {
      const int32_t word = x[size_t(idx >> 2) * L + lane];
      const int32_t byte = (word >> ((idx & 3) * 8)) & 0xFF;
      acc += uint32_t(byte);
      idx = floor_mod(wrap(uint32_t(idx) + uint32_t(byte) + 1u), W);
    } else {
      int32_t* p = x + size_t(idx) * L + lane;
      const int32_t w = *p;
      const int32_t v = w > 0 ? w : 0;
      if (kMode == ROW_CLAMP_WRITE && (v & 1)) *p = wrap(uint32_t(v) + 1u);
      acc += uint32_t(v);
      idx = floor_mod(idx + 1, W);
    }
  }
  state[lane] = wrap(acc);
  state[size_t(L) + lane] = idx;
}

// p4 and p5 on a lane-minor table x ([W, L]), one lane; state: [2, L].
//   SEG_REFILL (p4): every 8th step s = x[0:2] + i; acc += s.
//                    state: acc of rows 0 and 1.
//   SEG_SEGMENTS (p5): four segments of W / 4 rows; the segment `mask`
//                    gets +1 (written back); total += each segment's max;
//                    mask = (mask + 1) % 4. state: total, then mask.
template <int kMode>
LZM_FN void segment_chain_lane(int32_t* x, int W, int L, int lane,
                               int32_t* state, int iters) {
  const size_t sL = size_t(L);
  if (kMode == SEG_REFILL) {
    uint32_t acc0 = uint32_t(state[lane]), acc1 = uint32_t(state[sL + lane]);
    uint32_t s0 = 0, s1 = 0;
    LZM_UNROLL(unroll 1)
    for (int i = 0; i < iters; ++i) {
      if (i % 8 == 0) {
        s0 = uint32_t(x[lane]) + uint32_t(i);
        s1 = uint32_t(x[sL + lane]) + uint32_t(i);
      }
      acc0 += s0;
      acc1 += s1;
    }
    state[lane] = wrap(acc0);
    state[sL + lane] = wrap(acc1);
    return;
  }
  const int S = W / 4;
  uint32_t total = uint32_t(state[lane]);
  int32_t mask = floor_mod(state[sL + lane], 4);
  LZM_UNROLL(unroll 1)
  for (int i = 0; i < iters; ++i) {
    for (int s = 0; s < 4; ++s) {
      int32_t* seg = x + size_t(s) * S * sL + lane;
      int32_t m = INT32_MIN;
      if (s == mask) {
        LZM_UNROLL(unroll 8)
        for (int r = 0; r < S; ++r) {
          const int32_t v = wrap(uint32_t(seg[r * sL]) + 1u);
          seg[r * sL] = v;
          m = v > m ? v : m;
        }
      } else {
        LZM_UNROLL(unroll 8)
        for (int r = 0; r < S; ++r) {
          const int32_t v = seg[r * sL];
          m = v > m ? v : m;
        }
      }
      total += uint32_t(m);
    }
    mask = (mask + 1) % 4;
  }
  state[lane] = wrap(total);
  state[sL + lane] = mask;
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

LZM_FN bool bad_rw(int mode, int rows, int cols, int iters) {
  return (mode != RW_ROWS && mode != RW_SCALAR) || rows < 0 || cols < 1 ||
         iters < 0 || (mode == RW_SCALAR && rows != 1);
}

LZM_FN bool bad_row(int mode, int W, int L, int iters) {
  return mode < ROW_CLAMP || mode > ROW_BYTE || W < 2 || L < 0 || iters < 0;
}

LZM_FN bool bad_segment(int mode, int W, int L, int iters) {
  return (mode != SEG_REFILL && mode != SEG_SEGMENTS) || W < 4 || W % 4 ||
         L < 0 || iters < 0;
}

}  // namespace lzm

#if defined(LZP_HOST_ENTRY) && !defined(__CUDACC__)
// probes_mosaic.cu's C interface as host loops over threads (tests only).
// The stream argument is ignored.
extern "C" {

int lzm_gather_sum(int axis, int elem, const void* x, int x_rows, int x_cols,
                   const int32_t* start, int stride, int mod, void* out,
                   int n_out, int out_cols, int iters, void* /*stream*/) {
  if (lzm::bad_gather(axis, elem, x_rows, x_cols, mod, n_out, out_cols,
                      iters))
    return lzm::ERR_ARGS;
  for (int e = 0; e < n_out; ++e) {
    const int line = axis == lzm::AXIS_MINOR ? e / out_cols : e % out_cols;
    if (elem == lzm::ELEM_U8) {
      const uint8_t* xs = static_cast<const uint8_t*>(x);
      static_cast<uint8_t*>(out)[e] =
          axis == lzm::AXIS_MINOR
              ? lzm::gather_sum_elem<lzm::AXIS_MINOR>(xs, x_cols, line,
                                                      start[e], stride, mod,
                                                      iters)
              : lzm::gather_sum_elem<lzm::AXIS_MAJOR>(xs, x_cols, line,
                                                      start[e], stride, mod,
                                                      iters);
    } else {
      const int32_t* xs = static_cast<const int32_t*>(x);
      static_cast<int32_t*>(out)[e] =
          axis == lzm::AXIS_MINOR
              ? lzm::gather_sum_elem<lzm::AXIS_MINOR>(xs, x_cols, line,
                                                      start[e], stride, mod,
                                                      iters)
              : lzm::gather_sum_elem<lzm::AXIS_MAJOR>(xs, x_cols, line,
                                                      start[e], stride, mod,
                                                      iters);
    }
  }
  return 0;
}

int lzm_rw_chain(int mode, int32_t* x, int rows, int cols,
                 const int32_t* start, int32_t* out, int iters,
                 void* /*stream*/) {
  if (lzm::bad_rw(mode, rows, cols, iters)) return lzm::ERR_ARGS;
  if (mode == lzm::RW_SCALAR) {
    *out = lzm::rw_scalar(x, cols, iters);
    return 0;
  }
  for (int r = 0; r < rows; ++r)
    lzm::rw_row(x + size_t(r) * cols, cols, start[r], iters);
  return 0;
}

int lzm_row_chain(int mode, int32_t* x, int W, int L, int32_t* state,
                  int iters, void* /*stream*/) {
  if (lzm::bad_row(mode, W, L, iters)) return lzm::ERR_ARGS;
  for (int l = 0; l < L; ++l) {
    if (mode == lzm::ROW_CLAMP)
      lzm::row_chain_lane<lzm::ROW_CLAMP>(x, W, L, l, state, iters);
    else if (mode == lzm::ROW_CLAMP_WRITE)
      lzm::row_chain_lane<lzm::ROW_CLAMP_WRITE>(x, W, L, l, state, iters);
    else
      lzm::row_chain_lane<lzm::ROW_BYTE>(x, W, L, l, state, iters);
  }
  return 0;
}

int lzm_segment_chain(int mode, int32_t* x, int W, int L, int32_t* state,
                      int iters, void* /*stream*/) {
  if (lzm::bad_segment(mode, W, L, iters)) return lzm::ERR_ARGS;
  for (int l = 0; l < L; ++l) {
    if (mode == lzm::SEG_REFILL)
      lzm::segment_chain_lane<lzm::SEG_REFILL>(x, W, L, l, state, iters);
    else
      lzm::segment_chain_lane<lzm::SEG_SEGMENTS>(x, W, L, l, state, iters);
  }
  return 0;
}

const char* lzm_error_string(int code) {
  return code == lzm::ERR_ARGS ? "bad argument" : "host build";
}

}  // extern "C"
#endif

#endif  // LZMA_RS_TPU_TORCH_PROBE_MOSAIC_CUH_
