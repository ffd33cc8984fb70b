// Mosaic4 probe kernel for Hopper (sm_90a): the JAX package's Pallas probes
// of tools/probe_mosaic4.py, asked again on the card. The per-thread code
// is probe_mosaic4.cuh (shared with a host test build).
//
// The TPU probe bisected which construct of the gen-1 decoder's kernel
// Mosaic could not lower (nested while loops, 1-D carried vectors, a
// transposed [W, L] table, a reset under pl.when); it only compiled. Its
// seven Pallas functions (two pallas_call sites: build :108 with four
// variants, build2 :193 with three) are one function here:
//
//   table_chain <- build("base" | "when_reset" | "when_reset_hoisted" |
//                  "when_reset_refed") (probe_mosaic4.py:33),
//                  build2("sched8_max" | "sched8_sum" | "sched8_blend")
//                  (:143)
//
// On the card the same loop prices the decoder's probability update: a
// lane reads a word of its own [512]-word column, writes it back plus one,
// and its next index waits on the value read; the reset variants set the
// lane's whole column to 0x400 (LZMA's initial probability) every 17 steps,
// the state reset at an LZMA2 chunk.
//
// What bounds it on this card, and what the design does about it: one
// thread per lane, the lane's column in a lane-minor [512, L] table in
// device memory (256 KiB at L = 128, more than a block's 227 KiB of shared
// memory, so the table stays where the probe's layout puts it and the
// loads come from L1 or L2). Each step is a dependent load, a store to the
// same word and a few integer operations: latency-bound. The reset is 512
// stores per lane, coalesced over the warp (a row of 32 lanes is one
// 128-byte line): bound by store throughput every 17th step. The block-wide
// max that guards when_reset's pl.when changes no result, so the card has
// no vote; when_reset_refed writes its flag to the tile and reads it back,
// as the probe does. The table's fill (7) and the tile's zeros are part of
// the function, done by each thread for its own column. sched8_blend's
// sum over the 8 rows of k is written as selects: its product form was
// miscompiled by ptxas (probe_mosaic4.cuh).
// The launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzm4::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_mosaic4.cuh"

namespace {

using lzm4::kBlock;

template <int kMode>
__global__ void __launch_bounds__(kBlock)
    table_chain_kernel(const int32_t* __restrict__ k, int L,
                       int32_t* __restrict__ tab, int32_t* __restrict__ tile,
                       int32_t* __restrict__ state,
                       const int32_t* __restrict__ it0,
                       int32_t* __restrict__ it_out, int limit) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const int32_t it = lzm4::table_chain_lane<kMode>(k, L, lane, tab, tile,
                                                   state, *it0, limit);
  if (lane == 0) *it_out = it;
}

}  // namespace

extern "C" {

// k: [8, L] int32 (the sched modes) or null; tab: [512, L] int32 and tile:
// [64, L] int32 (null for the sched modes), both written whole; state:
// [2, L] (idx, acc), the start in, the end out; it0: [1], the loop's start
// count; it_out: [1], its end; limit: the loop runs while it < limit.
int lzm4_table_chain(int mode, const int32_t* k, int L, int32_t* tab,
                     int32_t* tile, int32_t* state, const int32_t* it0,
                     int32_t* it_out, int limit, void* stream) {
  if (lzm4::bad_table(mode, L, limit)) return lzm4::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (L + kBlock - 1) / kBlock;
  switch (mode) {
#define LZM4_LAUNCH(m)                                                    \
  case lzm4::m:                                                           \
    table_chain_kernel<lzm4::m><<<blocks, kBlock, 0, s>>>(                \
        k, L, tab, tile, state, it0, it_out, limit);                      \
    break;
    LZM4_LAUNCH(MODE_BASE)
    LZM4_LAUNCH(MODE_RESET)
    LZM4_LAUNCH(MODE_RESET_REFED)
    LZM4_LAUNCH(MODE_SCHED_MAX)
    LZM4_LAUNCH(MODE_SCHED_SUM)
    LZM4_LAUNCH(MODE_SCHED_BLEND)
#undef LZM4_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lzm4_error_string(int code) {
  return code == lzm4::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
