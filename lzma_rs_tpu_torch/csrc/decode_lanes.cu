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
// err, outp (absolute) [L] i32 and steps [L] i64. The per-lane code is
// lane_engine.cuh (over lzma_lane.cuh's constants and copy split), shared
// with a host test build.
//
// Design. Where decode_segments.cu bounds a lane by its shared-memory
// window (64 KiB at most), a lane here has no budget: its window is its
// own slice of the output in global memory (out + seg_base, as long as
// its last chunk's out_end), its input the archive itself in global memory
// on the read-only path, so segments of any size and any dictionary decode
// in place, and nothing is staged or copied back lane by lane. The
// probability table, read and written on every bit, stays in shared
// memory in its own layout (LaneTable: every bit tree 8-byte aligned),
// 29,840 B a lane, with the lead's mailbox (144 B). A lane is a block of
// two warps: thread 0, the lead, and the helper warp.
//
// What bounds it on this card. Not bytes or operations (chip_smoke.py
// phase 21 prints the bound, microseconds against a kernel of hundreds of
// milliseconds): each lane is a serial chain, every range-coder bit waiting
// on the one before, so a launch lasts its longest lane's steps times the
// cycles a step, and lane parallelism is the lanes of the batch, which the
// format fixes (a segment is serial: probabilities and state carry across
// its chunks): 16 lanes of 1 MiB blocks fill 16 of the 132 SMs, one 16 MB
// block one SM. So the design's one lever is the latency of a step, and it
// takes everything it can off the chain (lane_engine.cuh): the lead runs
// the chain alone with no barrier a bit; a symbol far from the budget's
// and the chunk's ends runs without a test a bit; every bit tree's
// probabilities come from a shared load issued two levels ahead; the
// input comes a byte ahead; the literal context's previous byte stays in a
// register. The helper warp refills the table and copies matches longer
// than 8 bytes while the lead decodes on; the lead waits for a copy only
// before it reads bytes that the copy writes. The window stays in global
// memory (L1 or L2): its loads sit at copies and chunk starts.
//
// The decoder's SASS does not change: this kernel has its own argument
// struct (LaneArgs), chain (LeadLane) and helpers (Crew); lzma_lane.cuh's
// decode_lane, which the decoder builds, is the decoder's alone
// (chip_smoke.py phase 2 holds it to tools/decoder_sass.json).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_engine.cuh"

namespace {

// A lane is a block of two warps: thread 0, the lead, and the helper warp
// (threads 32-63); the rest of the first warp leaves at once.
constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads) lanes_kernel(lzl::LaneArgs a) {
  extern __shared__ uint4 smem[];
  const int lane = int(blockIdx.x);
  if (lane >= a.L) return;
  uint16_t* const P = reinterpret_cast<uint16_t*>(smem);
  lzl::Mail* const mail = reinterpret_cast<lzl::Mail*>(
      reinterpret_cast<char*>(smem) + lzl::lane_table_bytes());
  if (threadIdx.x == 0) {
    mail->posted = 0;
    mail->done = 0;
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    const int64_t base = a.seg_base[lane];
    lzl::helper_loop(mail, a.out + (base >= 0 && base <= a.out_len ? base : 0),
                     P);
  } else if (threadIdx.x == 0) {
    const lzl::LaneOut r = lzl::run_lane(a, lane, P, mail);
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
int lzl_lanes_smem_bytes() { return lzl::lane_smem_bytes(); }

// Launch on `stream`; smem_bytes must be lzl_lanes_smem_bytes(). Returns
// cudaGetLastError() (0 = launched).
int lzl_decode_lanes(const void* in, void* out, const void* in_start, const void* in_end,
                     const void* out_start, const void* out_end,
                     const void* reset, const void* lc, const void* lp,
                     const void* pb, const void* nchunks,
                     const void* seg_base, const void* size_known,
                     const void* dict_size, void* err, void* outp,
                     void* steps, int L, int K, int in_len, int out_len,
                     long long max_steps, int smem_bytes, void* stream) {
  if (smem_bytes != lzl_lanes_smem_bytes()) {
    return int(cudaErrorInvalidValue);
  }
  if (L <= 0) return int(cudaGetLastError());
  const int e = prepare(smem_bytes);
  if (e != int(cudaSuccess)) return e;
  const lzl::LaneArgs a{
      static_cast<const uint8_t*>(in),
      static_cast<uint8_t*>(out),
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
      static_cast<int64_t*>(steps),
      L, K, in_len, out_len, max_steps};
  lanes_kernel<<<L, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      a);
  return int(cudaGetLastError());
}

// Lanes resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// after the attributes).
int lzl_lanes_occupancy(int smem_bytes, int* blocks) {
  const int e = prepare(smem_bytes);
  if (e != int(cudaSuccess)) return e;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, lanes_kernel, kThreads, size_t(smem_bytes)));
}

const char* lzl_lanes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
