// Segment decoder for Hopper (sm_90a): decodes L independent LZMA2
// dict-reset segments ("lanes") to completion, one thread per lane.
//
// Replaces the TPU kernel lzma_rs_tpu/ops/vmem2_decoder.py::
// decode_segments_vmem2 (gen-2 Pallas, pallas_call at :2121) and, launched
// at gen-1's bucket (W_IN == W, LZMA_RS_TPU_VMEM_GEN=1), lzma_rs_tpu/ops/
// vmem_decoder.py::decode_segments_vmem (gen-1, pallas_call at :1087): the
// two compute one function and differ only in Mosaic layout. Nothing here
// assumes W_IN < W: a lane reads only [in_start, in_end) of its own W_IN
// bytes, checked against w_in at chunk setup. Same
// contract in a lane-major layout: staged input [L, W_IN] u8, window
// [L, W] u8 (pre-filled with the segment's stored chunks), chunk tables
// [L, K] i32; outputs the window in place and err / outp / steps [L] i32.
// The per-lane decoder is lzma_lane.cuh (shared with a host test build).
//
// What bounds it on this card, and what this first design does about it:
//   - Each lane is a latency-bound serial chain: every range-coder bit
//     waits on the previous one, and on a probability load from global
//     memory (per-lane tables, 2.6-16 KB each, through L1/L2). Nothing yet:
//     tables stay in global memory.
//   - Lanes in one warp take different DFA branches and run different
//     symbol lengths, so the warp serialises over the union of its lanes'
//     paths and runs as long as its slowest lane. Nothing yet: lanes are
//     assigned in the runtime's biggest-first order, nothing more.
//   - Parallelism is the lane count against 132 SMs x 2048 resident
//     threads (270,336): a 16 MB archive of 8 KiB blocks gives ~2,000
//     lanes, of 64 KiB blocks ~250, so most of the card idles. Nothing yet.
// Shared-memory tables, warp-cooperative copies and occupancy tuning are
// left to later work, on purpose: this kernel is the simple, right one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lzma_lane.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) decode_segments_kernel(
    const uint8_t* __restrict__ inbuf, uint8_t* __restrict__ win,
    uint16_t* __restrict__ probs, const int32_t* __restrict__ in_start,
    const int32_t* __restrict__ in_end, const int32_t* __restrict__ out_start,
    const int32_t* __restrict__ out_end,
    const int32_t* __restrict__ chunk_meta, int32_t* __restrict__ err,
    int32_t* __restrict__ outp, int32_t* __restrict__ steps, int L, int w_in,
    int w, int nprobs, int nlit, int k, int max_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const size_t t = size_t(lane) * size_t(k);
  const lzl::LaneResult r = lzl::decode_lane(
      inbuf + size_t(lane) * size_t(w_in), w_in, win + size_t(lane) * size_t(w),
      w, probs + size_t(lane) * size_t(nprobs), nlit, in_start + t, in_end + t,
      out_start + t, out_end + t, chunk_meta + t, k, max_steps);
  err[lane] = r.err;
  outp[lane] = r.outp;
  steps[lane] = r.steps;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int lzl_decode_segments(const void* inbuf, void* win, void* probs,
                        const void* in_start, const void* in_end,
                        const void* out_start, const void* out_end,
                        const void* chunk_meta, void* err, void* outp,
                        void* steps, int L, int w_in, int w, int nprobs,
                        int nlit, int k, int max_steps, void* stream) {
  if (L > 0) {
    decode_segments_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(inbuf), static_cast<uint8_t*>(win),
        static_cast<uint16_t*>(probs), static_cast<const int32_t*>(in_start),
        static_cast<const int32_t*>(in_end),
        static_cast<const int32_t*>(out_start),
        static_cast<const int32_t*>(out_end),
        static_cast<const int32_t*>(chunk_meta), static_cast<int32_t*>(err),
        static_cast<int32_t*>(outp), static_cast<int32_t*>(steps), L, w_in, w,
        nprobs, nlit, k, max_steps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lzl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
