// Segment decoder for Hopper (sm_90a): decodes L independent LZMA2
// dict-reset segments ("lanes") to completion, one warp a lane.
//
// Replaces the TPU kernel lzma_rs_tpu/ops/vmem2_decoder.py::
// decode_segments_vmem2 (gen-2 Pallas, pallas_call at :2121) and, launched
// at gen-1's bucket (W_IN == W, LZMA_RS_TPU_VMEM_GEN=1), lzma_rs_tpu/ops/
// vmem_decoder.py::decode_segments_vmem (gen-1, pallas_call at :1087): the
// two compute one function and differ only in Mosaic layout. Nothing here
// assumes W_IN < W: a lane reads only [in_start, in_end) of its own W_IN
// bytes, checked against w_in at chunk setup. Same contract in a
// lane-major layout: staged input [L, W_IN] u8, initial window [L, W] u8
// (the segment's stored chunks), chunk tables [L, K] i32; outputs the
// decoded window [L, W] u8 and err / outp / steps [L] i32. The per-lane
// decoder is lzma_lane.cuh (shared with a host test build), the kernel
// template segment_kernel.cuh (shared with the variants of
// decode_variants.cu).
//
// What bounds it on this card. Not bytes or operations: chip_smoke.py's
// throughput bound (bytes in and out over 3.35 TB/s, 8 integer operations
// a micro-op over the INT32 rate) is tens of microseconds, the kernel tens
// of milliseconds. Each lane is a serial chain, every range-coder bit
// waiting on the one before, so a launch lasts its longest lane's steps
// times the cycles a step; chip_smoke.py prints both for each archive. The
// first design (a thread a lane, everything in global memory) took ~1,600-
// 1,800 cycles a step against ~170-185 for a bit decode alone (the probes,
// PERF.md). What this design does about the four causes of that gap:
//   1. Tables and window in global memory, every bit a dependent load and
//      store through L1/L2: a lane's probability table (probs_bytes(nlit),
//      5.2-16 KB) and its window (w, 2-64 KiB) live in dynamic shared
//      memory, copied in from win_init and out to win 16 B a thread. The
//      staged input stays in global memory on the read-only path: it is
//      read in order, about once a byte per eight bits.
//   2. The working set overflowing L1 (128 lanes an SM on 16 SMs): a block
//      is one lane, so the grid spreads the lanes over every SM, as many
//      an SM as their shared memory allows (81.5 KB a lane at the largest
//      bucket: 2 an SM; 13.4 KB for 8 KiB windows: 16), with the largest
//      shared-memory carveout. Every lane of a 16 MB archive of 8 or 64
//      KiB blocks is resident in one wave.
//   3. Divergence between a warp's lanes: the warp's 32 threads run one
//      lane's scalar decoder on copies of the same state, so its control
//      flow is uniform; their shared-memory accesses go to one address (a
//      broadcast, no bank conflicts). A warp barrier sits between each
//      probability's load and its store, so correctness does not rest on
//      lockstep execution.
//   4. Serial work the format does not need: the probability refill at a
//      lane's start and at each reset chunk is split over the 32 threads,
//      and a match copy writes up to 32 bytes a pass (byte i from
//      win[outp - dist + i % dist], a byte that existed before the copy,
//      so overlapping copies need no order), with the step count and the
//      stop at the budget or the chunk's end exactly as one byte a step
//      (lzma_lane.cuh: split_copy).
// Why a warp and not one thread a lane, a lane a block, with the same
// placement (variant S3): on one H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 14, two runs) that took 212.8-218.4 cycles a step against this
// design's 194.7-195.9 on 8 KiB blocks, and 156.5-158.6 against
// 137.4-137.7 on 64 KiB blocks, 17-24 cycles more; the warp's copies
// account for at most 7 of them (V4), and its per-bit barrier costs it
// 2-4 (PERF.md has every run).
// decode_variants.cu builds the steps between the first design and this
// one, for chip_smoke.py phase 14 to price each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_kernel.cuh"

// A warp a lane; table and window in shared memory.
#define LZL_DECODER lzl::Warp, lzl::kDecoder, true, true

extern "C" {

// Launch on `stream`; smem_bytes is ops/segment_decoder.py::smem_bytes.
// Returns cudaGetLastError() (0 = launched).
int lzl_decode_segments(const void* inbuf, const void* win_init, void* win,
                        const void* in_start, const void* in_end,
                        const void* out_start, const void* out_end,
                        const void* chunk_meta, void* err, void* outp,
                        void* steps, int L, int w_in, int w, int nlit, int k,
                        int max_steps, int smem_bytes, void* stream) {
  const lzl::SegmentArgs a{
      static_cast<const uint8_t*>(inbuf),
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
      L, w_in, w, 0, nlit, k, max_steps};
  return lzl::launch_segments<LZL_DECODER>(
      a, smem_bytes, static_cast<cudaStream_t>(stream));
}

// Lanes of the decoder resident on one SM at smem_bytes.
int lzl_decoder_occupancy(int smem_bytes, int* blocks) {
  return lzl::occupancy_segments<LZL_DECODER>(smem_bytes, blocks);
}

const char* lzl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
