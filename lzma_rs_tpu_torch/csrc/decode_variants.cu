// The segment decoder's variants: the steps from the first design (a
// thread a lane, everything in global memory) to the decoder of
// decode_segments.cu, each one the same kernel template
// (segment_kernel.cuh) over the same per-lane decoder (lzma_lane.cuh), so
// that chip_smoke.py phase 14 can time them against each other on the same
// batch and price each part of the design. Every variant computes the
// decoder's function: the same win, err, outp and steps, which phase 14
// holds equal to the decoder's.
//
//   V0  a thread a lane, 128-thread blocks, table and window in global
//       memory, one byte copied a step (the first design);
//   V1  a warp a lane, table and window in global memory;
//   V2  V1 with the table in shared memory;
//   V3  V2 with the window in shared memory: the decoder itself;
//   V4  V3 with one thread copying a byte a step;
//   V5  V3 with the input read through a look-ahead word;
//   S3  V4 run by one thread, a lane a block: the table and window in
//       shared memory, no warp team (the refill and the window's copies a
//       thread alone, no barriers).
// Off the main path: nothing but chip_smoke.py and the on-card tests
// launch these.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_kernel.cuh"

// Each variant's instantiation: team, options, table shared, window shared.
#define LZL_V0 lzl::Solo, 0, false, false
#define LZL_V1 lzl::Warp, lzl::kDecoder, false, false
#define LZL_V2 lzl::Warp, lzl::kDecoder, true, false
#define LZL_V3 lzl::Warp, lzl::kDecoder, true, true
#define LZL_V4 lzl::Warp, 0, true, true
#define LZL_V5 lzl::Warp, lzl::kDecoder | lzl::kLookahead, true, true
#define LZL_S3 lzl::Solo, 0, true, true

extern "C" {

// Launch variant v (0-6; 6 is S3) on `stream`; smem_bytes is
// ops/segment_variants.py::smem_bytes. Returns a cudaError_t (0 =
// launched).
int lzl_decode_variant(int v, const void* inbuf, const void* win_init,
                       void* win, void* probs, const void* in_start,
                       const void* in_end, const void* out_start,
                       const void* out_end, const void* chunk_meta,
                       void* err, void* outp, void* steps, int L, int w_in,
                       int w, int nprobs, int nlit, int k, int max_steps,
                       int smem_bytes, void* stream) {
  const lzl::SegmentArgs a{
      static_cast<const uint8_t*>(inbuf),
      static_cast<const uint8_t*>(win_init),
      static_cast<uint8_t*>(win),
      static_cast<uint16_t*>(probs),
      static_cast<const int32_t*>(in_start),
      static_cast<const int32_t*>(in_end),
      static_cast<const int32_t*>(out_start),
      static_cast<const int32_t*>(out_end),
      static_cast<const int32_t*>(chunk_meta),
      static_cast<int32_t*>(err),
      static_cast<int32_t*>(outp),
      static_cast<int32_t*>(steps),
      L, w_in, w, nprobs, nlit, k, max_steps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return lzl::launch_segments<LZL_V0>(a, smem_bytes, s);
    case 1: return lzl::launch_segments<LZL_V1>(a, smem_bytes, s);
    case 2: return lzl::launch_segments<LZL_V2>(a, smem_bytes, s);
    case 3: return lzl::launch_segments<LZL_V3>(a, smem_bytes, s);
    case 4: return lzl::launch_segments<LZL_V4>(a, smem_bytes, s);
    case 5: return lzl::launch_segments<LZL_V5>(a, smem_bytes, s);
    case 6: return lzl::launch_segments<LZL_S3>(a, smem_bytes, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// Blocks of variant v resident on one SM at smem_bytes.
int lzl_variant_occupancy(int v, int smem_bytes, int* blocks) {
  switch (v) {
    case 0: return lzl::occupancy_segments<LZL_V0>(smem_bytes, blocks);
    case 1: return lzl::occupancy_segments<LZL_V1>(smem_bytes, blocks);
    case 2: return lzl::occupancy_segments<LZL_V2>(smem_bytes, blocks);
    case 3: return lzl::occupancy_segments<LZL_V3>(smem_bytes, blocks);
    case 4: return lzl::occupancy_segments<LZL_V4>(smem_bytes, blocks);
    case 5: return lzl::occupancy_segments<LZL_V5>(smem_bytes, blocks);
    case 6: return lzl::occupancy_segments<LZL_S3>(smem_bytes, blocks);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* lzl_variant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
