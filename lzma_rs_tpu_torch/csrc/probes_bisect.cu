// Bisect probe kernel for Hopper (sm_90a): the JAX package's Pallas probe
// tools/probe_lane2d_bisect.py, asked again on the card. The per-thread
// code is probe_bisect.cuh (shared with a host test build).
//
// On the TPU the probe bisected which stage of the 2-D bit decode Mosaic
// could not lay out; it only compiled. Its sixteen bodies (one
// pallas_call site, try_case :33) add the bit decode's stages one by one
// on the same state, and vary how the table is read. On the card they are
// one kernel over eleven modes:
//
//   bisect_chain <- try_case(v1, v2, v3, v4, v5, v2m, v2max, v2bt,
//                            w1, ..., w8) (probe_lane2d_bisect.py:33)
//
// The question on the card is what each stage costs a thread's dependent
// chain: v2 - v1 is the table load, v3 - v2 the range coder's arithmetic,
// v4 - v3 the store, w5 - w3 the load without the ten-select climb.
//
// What bounds it, and what the design does about it: one thread per lane
// (the probe's 8 x 128 = 1,024 lanes: 8 blocks of 128 threads, a few
// warps on each of 8 SMs), the lane's column in the probe's lane-minor
// [648, L] layout in device memory (2.65 MB: L2, and L1 for the hot rows).
// Each iteration waits on the one before: latency-bound, a chain of one
// thread, which is what the question needs; nothing hides the latency.
// The writing body (v4) copies its column of the input into a scratch
// table first, as the probe does; the others read the input, which no one
// writes, so nvcc may hoist w1's and w2's loads out of the loop.
// The launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzb::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_bisect.cuh"

namespace {

using lzb::kBlock;

template <int kMode>
__global__ void __launch_bounds__(kBlock)
    bisect_chain_kernel(const int32_t* __restrict__ x,
                        int32_t* __restrict__ tab,
                        int32_t* __restrict__ state,
                        int32_t* __restrict__ out, int L, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzb::bisect_lane<kMode>(x, tab, state, out, L, lane, iters);
}

}  // namespace

extern "C" {

// x: [648, L] int32, not written; tab: [648, L] int32 scratch (the final
// table of v4; may be null for the other modes); state: [4, L] (idx, acc,
// rng, cod), the start in, the end out; out: [L].
int lzb_bisect(int mode, const int32_t* x, int32_t* tab, int32_t* state,
               int32_t* out, int L, int iters, void* stream) {
  if (lzb::bad_args(mode, tab, L, iters)) return lzb::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (L + kBlock - 1) / kBlock;
  switch (mode) {
#define LZB_LAUNCH(m)                                                     \
  case lzb::m:                                                            \
    bisect_chain_kernel<lzb::m><<<blocks, kBlock, 0, s>>>(x, tab, state,  \
                                                          out, L, iters); \
    break;
    LZB_LAUNCH(MODE_V1)
    LZB_LAUNCH(MODE_V2)
    LZB_LAUNCH(MODE_V2MAX)
    LZB_LAUNCH(MODE_V3)
    LZB_LAUNCH(MODE_V4)
    LZB_LAUNCH(MODE_W1)
    LZB_LAUNCH(MODE_W2)
    LZB_LAUNCH(MODE_W3)
    LZB_LAUNCH(MODE_W4)
    LZB_LAUNCH(MODE_W5)
    LZB_LAUNCH(MODE_W8)
#undef LZB_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lzb_error_string(int code) {
  return code == lzb::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
