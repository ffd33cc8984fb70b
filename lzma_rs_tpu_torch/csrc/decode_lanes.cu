// The lane engine for Hopper (sm_90a): L independent LZMA2 dict-reset
// segments (or raw LZMA streams) decoded to completion in place in one
// flat output, one warp a lane.
//
// Replaces the JAX package's XLA lane kernel
// lzma_rs_tpu/ops/lane_decoder.py::decode_lanes (:105), the engine
// "tpu-lane": device code outside Pallas, reachable only when a caller
// names it. Its contract, in JAX's order: the flat archive in[in_len] u8;
// the flat output out[out_len] u8 with the stored chunks placed (JAX's
// out_init without its dump slot), decoded in place; chunk tables [L, K]
// i32 (in_start, in_end, out_start, out_end absolute; reset_state, lc, lp,
// pb); nchunks, seg_base, size_known [L] i32; dict_size [L] i64. Outputs
// err, outp (absolute), steps [L] i32. The per-lane code is
// lane_engine.cuh over lzma_lane.cuh (kLaneEngine: ERR_DIST_DICT, lanes of
// unknown size), shared with a host test build.
//
// Design. Where decode_segments.cu bounds a lane by its shared-memory
// window (64 KiB at most), a lane here has no budget: its window is its
// own slice of the output in global memory (out + seg_base, as long as
// its last chunk's out_end), its input the archive itself in global memory
// on the read-only path, so segments of any size and any dictionary decode
// in place, and nothing is staged or copied back lane by lane. The
// probability table, read and written on every bit, stays in shared
// memory: Layout(16) (lc + lp <= 4), 28,272 B a lane. A lane is a block of
// one warp, as in decode_segments.cu: 32 threads run one scalar decoder in
// uniform control flow and split the table's refill and each match copy.
// Window reads that follow a copy see its bytes because every cooperative
// step ends in a warp barrier (__syncwarp orders memory among the warp);
// lanes own disjoint output ranges, so no other lane is involved.
//
// What bounds it on this card. Not bytes or operations (chip_smoke.py
// phase 21 prints the bound, microseconds against a kernel of hundreds of
// milliseconds): each lane is a serial chain, every range-coder bit waiting
// on the one before, so a launch lasts its longest lane's steps times the
// cycles a step, and lane parallelism is the lanes of the batch: 16 lanes
// of 1 MiB blocks fill 16 of the 132 SMs, one 16 MB block one SM. The
// window in global memory adds a load from L1 or L2 to the literals'
// previous byte, the matched literals' byte and the copies, where
// decode_segments.cu reads shared memory. Making it fast is later work:
// the engine is never routed, only named.
//
// The decoder's SASS does not change: this kernel has its own argument
// struct (LaneArgs) and kLaneEngine's code sits behind if constexpr and a
// flag that is constant false in the other builds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_engine.cuh"

namespace {

__global__ void __launch_bounds__(32) lanes_kernel(lzl::LaneArgs a) {
  extern __shared__ uint4 smem[];
  const int lane = int(blockIdx.x);
  if (lane >= a.L) return;
  const lzl::LaneOut r = lzl::run_lane<lzl::Warp>(
      a, lane, reinterpret_cast<uint16_t*>(smem));
  if ((threadIdx.x & 31u) == 0) {
    a.err[lane] = r.err;
    a.outp[lane] = r.outp;
    a.steps[lane] = r.steps;
  }
}

int prepare(int smem) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(lanes_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  }
  return int(e);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one lane: its probability table.
int lzl_lanes_smem_bytes() { return lzl::probs_bytes(lzl::kLaneNlit); }

// Launch on `stream`; smem_bytes must be lzl_lanes_smem_bytes(). Returns
// cudaGetLastError() (0 = launched).
int lzl_decode_lanes(const void* in, void* out, void* scratch,
                     const void* in_start, const void* in_end,
                     const void* out_start, const void* out_end,
                     const void* reset, const void* lc, const void* lp,
                     const void* pb, const void* nchunks,
                     const void* seg_base, const void* size_known,
                     const void* dict_size, void* err, void* outp,
                     void* steps, int L, int K, int in_len, int out_len,
                     int max_steps, int smem_bytes, void* stream) {
  if (smem_bytes != lzl_lanes_smem_bytes()) {
    return int(cudaErrorInvalidValue);
  }
  if (L <= 0) return int(cudaGetLastError());
  const int e = prepare(smem_bytes);
  if (e != int(cudaSuccess)) return e;
  const lzl::LaneArgs a{
      static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out),
      static_cast<int32_t*>(scratch),
      static_cast<const int32_t*>(in_start),
      static_cast<const int32_t*>(in_end),
      static_cast<const int32_t*>(out_start),
      static_cast<const int32_t*>(out_end),
      static_cast<const int32_t*>(reset),
      static_cast<const int32_t*>(lc),
      static_cast<const int32_t*>(lp),
      static_cast<const int32_t*>(pb),
      static_cast<const int32_t*>(nchunks),
      static_cast<const int32_t*>(seg_base),
      static_cast<const int32_t*>(size_known),
      static_cast<const int64_t*>(dict_size),
      static_cast<int32_t*>(err),
      static_cast<int32_t*>(outp),
      static_cast<int32_t*>(steps),
      L, K, in_len, out_len, max_steps};
  lanes_kernel<<<L, 32, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// Lanes resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the attributes).
int lzl_lanes_occupancy(int smem_bytes, int* blocks) {
  const int e = prepare(smem_bytes);
  if (e != int(cudaSuccess)) return e;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lanes_kernel, 32, size_t(smem_bytes)));
}

const char* lzl_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
