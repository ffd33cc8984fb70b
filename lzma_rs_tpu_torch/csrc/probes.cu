// Probe kernels for Hopper (sm_90a), one thread per lane: the JAX
// package's Pallas probes of tools/probe_lane2d.py and
// tools/probe_state_in_ref.py, asked again on the card. The per-lane code
// is probe_lane.cuh (shared with a host test build).
//
// The TPU probes measured what Mosaic makes expensive: 1-D replicated
// vectors against 2-D tiles, one-hot table traversals, state in scratch
// refs against the loop carry. A CUDA thread indexes memory directly, so
// 1-D against 2-D is only the lane count L = S * 128 here, and the seven
// Pallas functions compute three per-lane functions:
//
//   tinyops_chain   <- tinyops_only_1d (probe_lane2d.py:177),
//                      tinyops_only_2d (:209)
//   bitdecode_chain <- bitdecode_1d (:97), bitdecode_2d (:145),
//                      y1 (probe_state_in_ref.py:83), y2 (:141)
//   realweight_step <- y4 (probe_state_in_ref.py:211)
//
// What bounds them on this card, and what the design does about it:
//   - Each lane is one serial dependency chain (every op waits on the one
//     before), and L is at most a few thousand threads against 132 SMs x
//     2048: the card is latency-bound, neither bytes nor operations set
//     the time. The time per link is what tinyops_chain and
//     bitdecode_chain measure, to set beside the segment decoder's step,
//     so nothing is done there to hide the latency. What a tiny-op round
//     puts on the chain is shortened instead (probe_lane.cuh: tiny_round,
//     one inline-PTX block): the next round's a - d formed for both
//     outcomes of d's select before the compare, so four dependent
//     instructions a round where the probe's form has five, each lane's
//     registers bit for bit the same. Blocks of 32, 64 or 128 lanes ran alike (one
//     warp a scheduler either way): kBlock stays 64.
//   - realweight_step (y4) is the decoder's step in miniature, and on the
//     TPU its rounds were straight-line code (the probe's Python loop,
//     k & 7 a constant in each round). Here they are unrolled by 8 the
//     same way (probe_lane.cuh: tiny_rounds), and the iteration's memory
//     is pipelined by hand: its table and ring loads are issued, the next
//     iteration's rounds run (nothing in them reads a loaded word or the
//     bit), and only then are the loads consumed, so their latency hides
//     behind ~6,000 cycles of rounds. The chain of tiny ops stays what
//     the probe prices.
//   - bitdecode_chain: an iteration's table row depends only on idx and
//     acc, and acc takes one of two values after the bit; so both
//     candidate rows of the next iteration are climbed, clipped and loaded
//     before the bit resolves, the bit picks one, and where it is the row
//     just stored the new word is forwarded in registers
//     (probe_lane.cuh: bitdecode_lane). The chain an iteration is the
//     range coder on the held word and the bit's selects; the climb (in
//     closed form, the same wrapping int32 result), the clip and the
//     table's load run beside it. Where the table lives is the template
//     parameter: device memory lane-minor [ROWS, L] (the TPU layout; a
//     warp's reads coalesce when its lanes' idx agree), device memory
//     lane-major [L, ROWS] (the decoder's layout: a warp's reads are
//     2,592 B apart), or shared memory (a block's 64 lanes' tables, 648 x
//     64 x 4 = 165,888 B, lane-minor, so any idx pattern is free of bank
//     conflicts; filled at the start, written back at the end). bisect's
//     rows keep the whole step on one chain (probe_bisect.cuh).
//   - State in registers, or (y1, y2) in device memory through volatile
//     pointers, loaded and stored every iteration: that round trip stays
//     on y1's and y2's chain, the candidate loads beside it.
// Each launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzp::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attributes.cuh"
#include "probe_lane.cuh"

namespace {

using lzp::kBlock;
using lzp::kRows;

__global__ void __launch_bounds__(kBlock)
    tinyops_chain_kernel(const int32_t* __restrict__ x,
                         int32_t* __restrict__ state, int L, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzp::tinyops_lane(x[lane], iters, state + lane, state + L + lane,
                    state + 2 * size_t(L) + lane);
}

template <int kPlace, bool kMem>
__global__ void __launch_bounds__(kBlock)
    bitdecode_chain_kernel(int32_t* __restrict__ tab, int32_t* idx,
                           int32_t* acc, int32_t* rng, int32_t* cod, int L,
                           int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (kPlace == lzp::PLACE_SHARED) {
    // each thread fills and writes back its own column only: no barrier
    extern __shared__ int32_t smem[];
    const int t = threadIdx.x;
    if (lane >= L) return;
    for (int r = 0; r < kRows; ++r)
      smem[r * kBlock + t] = tab[size_t(r) * L + lane];
    lzp::bitdecode_run<lzp::LaneMinorTable, kMem>(
        lzp::LaneMinorTable{smem + t, kBlock}, idx, acc, rng, cod, lane,
        iters);
    for (int r = 0; r < kRows; ++r)
      tab[size_t(r) * L + lane] = smem[r * kBlock + t];
  } else if (lane < L) {
    // The lane's first word is held in a register (an empty asm): left to
    // itself nvcc folded it into each row's address and rebuilt that in
    // 64-bit arithmetic, four instructions on the chain to each load. Not
    // for the shared table, whose pointer would turn generic (its loads
    // slower than shared ones).
    int32_t* row0 = kPlace == lzp::PLACE_MINOR ? tab + lane
                                               : tab + size_t(lane) * kRows;
    asm("" : "+l"(row0));
    if (kPlace == lzp::PLACE_MINOR)
      lzp::bitdecode_run<lzp::LaneMinorTable, kMem>(
          lzp::LaneMinorTable{row0, L}, idx, acc, rng, cod, lane, iters);
    else
      lzp::bitdecode_run<lzp::LaneMajorTable, kMem>(
          lzp::LaneMajorTable{row0}, idx, acc, rng, cod, lane, iters);
  }
}

__global__ void __launch_bounds__(kBlock)
    realweight_step_kernel(int32_t* __restrict__ tab,
                           int32_t* __restrict__ ring,
                           int32_t* __restrict__ state, int L, int iters,
                           int rounds) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzp::realweight_lane(tab, ring, state, L, lane, iters, rounds);
}

int blocks(int L) { return (L + kBlock - 1) / kBlock; }

template <int kPlace, bool kMem>
int launch_bitdecode(int32_t* tab, int32_t* idx, int32_t* acc, int32_t* rng,
                     int32_t* cod, int L, int iters, cudaStream_t stream) {
  size_t smem = 0;
  if (kPlace == lzp::PLACE_SHARED) {
    smem = size_t(kRows) * kBlock * sizeof(int32_t);  // above 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        bitdecode_chain_kernel<kPlace, kMem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bitdecode_chain_kernel<kPlace, kMem><<<blocks(L), kBlock, smem, stream>>>(
      tab, idx, acc, rng, cod, L, iters);
  return static_cast<int>(cudaGetLastError());
}

template <int kPlace>
int launch_bitdecode(int mem_state, int32_t* tab, int32_t* idx, int32_t* acc,
                     int32_t* rng, int32_t* cod, int L, int iters,
                     cudaStream_t stream) {
  return mem_state ? launch_bitdecode<kPlace, true>(tab, idx, acc, rng, cod,
                                                    L, iters, stream)
                   : launch_bitdecode<kPlace, false>(tab, idx, acc, rng, cod,
                                                     L, iters, stream);
}

template <int kPlace, bool kMem>
const void* bitdecode_kernel() {
  return reinterpret_cast<const void*>(bitdecode_chain_kernel<kPlace, kMem>);
}

}  // namespace

extern "C" {

// state: [3, L] out (a, b, d).
int lzp_tinyops(const int32_t* x, int32_t* state, int L, int iters,
                void* stream) {
  if (lzp::bad_args(L, iters)) return lzp::ERR_ARGS;
  if (L > 0)
    tinyops_chain_kernel<<<blocks(L), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, state, L,
                                                                iters);
  return static_cast<int>(cudaGetLastError());
}

// tab: [ROWS, L] (minor, shared) or [L, ROWS] (major), updated in place;
// idx, acc, rng, cod: [L] each, the initial state in, the final state out.
int lzp_bitdecode(int place, int mem_state, int32_t* tab, int32_t* idx,
                  int32_t* acc, int32_t* rng, int32_t* cod, int L, int iters,
                  void* stream) {
  if (lzp::bad_bitdecode(place, L, iters)) return lzp::ERR_ARGS;
  if (L == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (place) {
    case lzp::PLACE_MINOR:
      return launch_bitdecode<lzp::PLACE_MINOR>(mem_state, tab, idx, acc,
                                                rng, cod, L, iters, s);
    case lzp::PLACE_MAJOR:
      return launch_bitdecode<lzp::PLACE_MAJOR>(mem_state, tab, idx, acc,
                                                rng, cod, L, iters, s);
    case lzp::PLACE_SHARED:
      return launch_bitdecode<lzp::PLACE_SHARED>(mem_state, tab, idx, acc,
                                                 rng, cod, L, iters, s);
    default:
      return lzp::ERR_ARGS;
  }
}

// The most lanes lzp_bitdecode takes (its table's words fit 32-bit
// offsets).
int lzp_bitdecode_max_lanes() { return lzp::kMaxLanes; }

// tab: [ROWS, L], ring: [RING, L], both updated in place; state: [7, L]
// (idx, acc, rng, cod, a, b, d), the initial state in, the final out.
int lzp_realweight(int32_t* tab, int32_t* ring, int32_t* state, int L,
                   int iters, int rounds, void* stream) {
  if (lzp::bad_args(L, iters) || rounds < 0) return lzp::ERR_ARGS;
  if (L > 0)
    realweight_step_kernel<<<blocks(L), kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        tab, ring, state, L, iters, rounds);
  return static_cast<int>(cudaGetLastError());
}

// bitdecode_chain's kernel for `place` and `mem_state`: out[0..3] the
// registers a thread, local memory a thread (spills), static shared memory
// and the dynamic shared memory it may have (cudaFuncGetAttributes).
// Returns 0, a CUDA error or ERR_ARGS.
int lzp_bitdecode_attributes(int place, int mem_state, int* out) {
  using lzp::PLACE_MAJOR;
  using lzp::PLACE_MINOR;
  using lzp::PLACE_SHARED;
  static const void* const kernels[] = {  // [place][mem_state]
      bitdecode_kernel<PLACE_MINOR, false>(),
      bitdecode_kernel<PLACE_MINOR, true>(),
      bitdecode_kernel<PLACE_MAJOR, false>(),
      bitdecode_kernel<PLACE_MAJOR, true>(),
      bitdecode_kernel<PLACE_SHARED, false>(),
      bitdecode_kernel<PLACE_SHARED, true>(),
  };
  if (place < PLACE_MINOR || place > PLACE_SHARED) return lzp::ERR_ARGS;
  return lzk::kernel_attributes(kernels[place * 2 + (mem_state ? 1 : 0)],
                                out);
}

// realweight_step's kernel: out[0..3] the registers a thread, local
// memory a thread (spills), static shared memory and the dynamic shared
// memory it may have (cudaFuncGetAttributes). Returns 0 or a CUDA error.
int lzp_realweight_attributes(int* out) {
  return lzk::kernel_attributes(
      reinterpret_cast<const void*>(realweight_step_kernel), out);
}

const char* lzp_error_string(int code) {
  return code == lzp::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
