// The decoder's step-cost builds: the segment decoder (a warp a lane,
// table and window in shared memory, decode_segments.cu's instantiation)
// with the option bits of lzma_lane.cuh's kAblated, case by case, so that
// the step-cost tools (lzma_rs_tpu_torch/tools/probe_step_cost.py,
// probe_step_cost2.py) and chip_smoke.py phase 19 can time each part of a
// step by taking it out. The port of the JAX kernel's spin mode and
// LZMA_RS_TPU_ABLATE switches (lzma_rs_tpu/ops/vmem2_decoder.py:2048 and
// the switches it tests), as template instantiations: nothing here reads
// an environment variable, and the decoder's own build sets none of the
// bits. Each case is the kernel template of segment_kernel.cuh over
// lzma_lane.cuh; every case spins (kSpin), so every lane runs exactly
// max_steps steps and reports its restarts.
//
//   0  spin                  the decoder, restarting its segment until the
//                            budget is spent;
//   1  spin,probread         a bit reads the constant 0x400;
//   2  spin,probread,probwrite   ... and stores no probability;
//   3  spin,port             window reads return 0;
//   4  spin,winwrite         no window stores;
//   5  spin,refill           the input byte is the constant 0 (kNoInput);
//   6  all five ablations together.
// Off the main path: nothing but the step-cost tools, chip_smoke.py and
// the on-card tests launch these.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_kernel.cuh"

#define LZL_CASE(C) lzl::Warp, lzl::kDecoder | lzl::kAblated[C], true, true

extern "C" {

// Launch case c (0-6) on `stream`; smem_bytes is
// ops/segment_decoder.py::smem_bytes. Returns a cudaError_t (0 =
// launched).
int lzl_decode_ablated(int c, const void* inbuf, const void* win_init,
                       void* win, const void* in_start, const void* in_end,
                       const void* out_start, const void* out_end,
                       const void* chunk_meta, void* err, void* outp,
                       void* steps, void* restarts, int L, int w_in, int w,
                       int nlit, int k, int max_steps, int smem_bytes,
                       void* stream) {
  const lzl::SpinArgs a{
      {static_cast<const uint8_t*>(inbuf),
       static_cast<const uint8_t*>(win_init),
       static_cast<uint8_t*>(win),
       nullptr,
       static_cast<const int32_t*>(in_start),
       static_cast<const int32_t*>(in_end),
       static_cast<const int32_t*>(out_start),
       static_cast<const int32_t*>(out_end),
       static_cast<const int32_t*>(chunk_meta),
       static_cast<int32_t*>(err),
       static_cast<int32_t*>(outp),
       static_cast<int32_t*>(steps),
       L, w_in, w, 0, nlit, k, max_steps},
      static_cast<int32_t*>(restarts)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 0: return lzl::launch_segments<LZL_CASE(0)>(a, smem_bytes, s);
    case 1: return lzl::launch_segments<LZL_CASE(1)>(a, smem_bytes, s);
    case 2: return lzl::launch_segments<LZL_CASE(2)>(a, smem_bytes, s);
    case 3: return lzl::launch_segments<LZL_CASE(3)>(a, smem_bytes, s);
    case 4: return lzl::launch_segments<LZL_CASE(4)>(a, smem_bytes, s);
    case 5: return lzl::launch_segments<LZL_CASE(5)>(a, smem_bytes, s);
    case 6: return lzl::launch_segments<LZL_CASE(6)>(a, smem_bytes, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// Lanes of case c resident on one SM at smem_bytes.
int lzl_ablated_occupancy(int c, int smem_bytes, int* blocks) {
  switch (c) {
    case 0: return lzl::occupancy_segments<LZL_CASE(0)>(smem_bytes, blocks);
    case 1: return lzl::occupancy_segments<LZL_CASE(1)>(smem_bytes, blocks);
    case 2: return lzl::occupancy_segments<LZL_CASE(2)>(smem_bytes, blocks);
    case 3: return lzl::occupancy_segments<LZL_CASE(3)>(smem_bytes, blocks);
    case 4: return lzl::occupancy_segments<LZL_CASE(4)>(smem_bytes, blocks);
    case 5: return lzl::occupancy_segments<LZL_CASE(5)>(smem_bytes, blocks);
    case 6: return lzl::occupancy_segments<LZL_CASE(6)>(smem_bytes, blocks);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* lzl_ablated_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
