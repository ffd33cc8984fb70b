// Round4 probe kernels for Hopper (sm_90a): the JAX package's Pallas
// probes of tools/probe_round4.py, asked again on the card. The per-thread
// code is probe_round4.cuh (shared with a host test build).
//
// The TPU probe priced the one-hot traversals of the gen-2 decoder's
// probability table ([784, 16, 128] int32 at 2,048 lanes): chained against
// independent selects, a blend write before them, narrow tables, a
// sublane gather. Its twenty rows (three pallas_call sites: _mk :88,
// narrow_1 :271, sel_s :430) compute these functions here, one thread per
// lane, the one-hot selects as direct indexed loads of a lane-minor table:
//
//   select_chain <- _mk over null_case (probe_round4.py:345, null),
//                   sel_n (:109, sel1-sel4), par3 (:134), fused_n without
//                   its blend (:192, fused3), wide4 (:291, the same
//                   function as sel1), gather_taa (:321); narrow_1 (:242,
//                   i16_1, i8_1: the table in int16 or int8); sel_s (:386,
//                   sel_s2, sel_s8, sel_s2f4: a fold of a [2048, S, 128]
//                   table is the same memory, one direct load)
//   blend_chain  <- _mk over blend_par3 (:158), fused_n with its blend
//                   (fusedb3, fusedb3_B16: the block size only set Mosaic's
//                   traversal; fusedb7), blend_mask (:449, blendmask512),
//                   blend_oldw (:482, blendoldw512)
//
// What bounds them on this card, and what the design does about it: each
// iteration's indices wait on slot 0, which waits on the last iteration's
// loads, so every row is latency-bound by its chain: sel_n by n dependent
// loads, par3 and fused_n by one load time with their n loads in flight
// together (the reads are unrolled so that they issue back to back), the
// blends by stores and then loads of the same lane's column. The table
// (6.4 MB at 2,048 lanes) stays in device memory, lane-minor as the probe
// lays it out, so a warp's 32 lanes read one 128-byte line of a row when
// their indices agree; it is served from L2 (50 MB) and L1. The narrow
// rows keep the table in int16 or int8, so the same rows take half or a
// quarter of the bytes. blend_chain writes the wrapper's copy of the
// table (the input is not changed). Start and end state are separate
// buffers: gather_taa's thread (s, m) carries lane (0, m)'s chain from its
// start, which another thread of another block may already have ended.
// Each launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzr4::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_round4.cuh"

namespace {

using lzr4::kBlock;

template <class T, int kMode, int kN>
__global__ void __launch_bounds__(kBlock)
    select_chain_kernel(const T* __restrict__ x, int R, int L, int mask,
                        const int32_t* __restrict__ st0,
                        int32_t* __restrict__ st, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzr4::select_chain_lane<T, kMode, kN>(x, R, L, lane, mask, st0, st, iters);
}

template <int kMode, int kN>
__global__ void __launch_bounds__(kBlock)
    blend_chain_kernel(int32_t* __restrict__ x, int R, int L,
                       const int32_t* __restrict__ st0,
                       int32_t* __restrict__ st, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzr4::blend_chain_lane<kMode, kN>(x, R, L, lane, st0, st, iters);
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" {

// x: [R, L], `elem` bytes an entry (4: int32; 2: int16 and 1: int8, for
// SEL_CHAIN with n = 1 only), not changed; st0: [4, L] int32, the start,
// not changed; st: [4, L] int32, the end; mask: 1023 or 2047 (_idx_mix's
// and).
int lzr4_select_chain(int mode, int n, int elem, const void* x, int R, int L,
                      int mask, const int32_t* st0, int32_t* st, int iters,
                      void* stream) {
  using namespace lzr4;
  if (bad_select(mode, n, elem, mask, R, L, iters)) return ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* x32 = static_cast<const int32_t*>(x);
  const int16_t* x16 = static_cast<const int16_t*>(x);
  const int8_t* x8 = static_cast<const int8_t*>(x);
  const int key = elem == 4 ? mode * 16 + n : (elem == 2 ? 128 : 256) + n;
  switch (key) {
#define LZR4_SEL(k, T, xp, m, nn)                                         \
  case k:                                                                 \
    select_chain_kernel<T, m, nn><<<blocks(L), kBlock, 0, s>>>(           \
        xp, R, L, mask, st0, st, iters);                                  \
    break;
    LZR4_SEL(SEL_NULL * 16 + 1, int32_t, x32, SEL_NULL, 1)
    LZR4_SEL(SEL_CHAIN * 16 + 1, int32_t, x32, SEL_CHAIN, 1)
    LZR4_SEL(SEL_CHAIN * 16 + 2, int32_t, x32, SEL_CHAIN, 2)
    LZR4_SEL(SEL_CHAIN * 16 + 3, int32_t, x32, SEL_CHAIN, 3)
    LZR4_SEL(SEL_CHAIN * 16 + 4, int32_t, x32, SEL_CHAIN, 4)
    LZR4_SEL(SEL_PAR3 * 16 + 3, int32_t, x32, SEL_PAR3, 3)
    LZR4_SEL(SEL_FUSED * 16 + 3, int32_t, x32, SEL_FUSED, 3)
    LZR4_SEL(SEL_GATHER * 16 + 1, int32_t, x32, SEL_GATHER, 1)
    LZR4_SEL(128 + 1, int16_t, x16, SEL_CHAIN, 1)
    LZR4_SEL(256 + 1, int8_t, x8, SEL_CHAIN, 1)
#undef LZR4_SEL
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [R, L] int32, written in place (the wrapper's copy); st0: [4, L]
// int32, the start, not changed; st: [4, L] int32, the end.
int lzr4_blend_chain(int mode, int n, int32_t* x, int R, int L,
                     const int32_t* st0, int32_t* st, int iters,
                     void* stream) {
  using namespace lzr4;
  if (bad_blend(mode, n, R, L, iters)) return ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode * 16 + n) {
#define LZR4_BLEND(m, nn)                                                 \
  case m * 16 + nn:                                                       \
    blend_chain_kernel<m, nn><<<blocks(L), kBlock, 0, s>>>(x, R, L, st0,  \
                                                           st, iters);    \
    break;
    LZR4_BLEND(BLEND_PAR3, 3)
    LZR4_BLEND(BLEND_FUSED, 3)
    LZR4_BLEND(BLEND_FUSED, 7)
    LZR4_BLEND(BLEND_MASK, 1)
    LZR4_BLEND(BLEND_OLDW, 1)
#undef LZR4_BLEND
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lzr4_error_string(int code) {
  return code == lzr4::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
