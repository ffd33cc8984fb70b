// Bisect probe kernel for Hopper (sm_90a): the JAX package's Pallas probe
// tools/probe_lane2d_bisect.py, asked again on the card. The per-lane and
// per-rank code is probe_bisect.cuh (shared with a host test build).
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
// v4 - v3 the store, w5 - w3 the load without the climb.
//
// What bounds it, and what the design does about it. Each iteration waits
// on the one before: latency-bound, a chain of one thread, which is what
// the question needs; so each body stays one chain an iteration (the
// index stage, the read, the bit, the write, the shift-in), and the next
// iteration's row is not loaded ahead as bitdecode_chain loads it: that
// would hide the load, the stage v2 - v1 prices. The TPU probe copies its
// input into a VMEM scratch (tab_ref[:] = x_ref[:]) and every body reads
// that; here a block's shared memory plays VMEM's part. A block runs
// kLanes = 32 lanes (one warp of chains; the tool's 1,024 lanes are 32
// blocks on 32 SMs) with kThreads = 256 threads, which stage the block's
// [648, 32] slice of the lane-minor input (82,944 B) by cp.async in
// 16-byte chunks, so each lane's row lies in its own bank whatever row it
// reads. Only the bodies that read rows stage it (lzb::stages): v1, w3
// and w4 read no row and w2 and w8 only row 5, which they read from x, as
// measured faster (PERF.md). w1 sums its lane's whole column every
// iteration, as the probe reduces the whole table: the eight warps each
// sum an eighth of every lane's column (81 rows, 648 shared loads a block
// an iteration, bound by the SM's 128 bytes of shared memory a cycle),
// post the parts to shared memory (two buffers, so one barrier an
// iteration) and the chain's lane adds them. Where a table is asked for
// (the wrapper's full=True), the block writes its slice back, coalesced
// (unstaged, the final table is x: the launcher copies it); the timed
// call asks for none. The kernel reads the start from `start` and writes
// the end to `state`, so a call is one launch. Threads past L in the last
// block stage, meet every barrier and run no chain.
// The launcher checks its arguments, opts its kernel in to the block's
// dynamic shared memory, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzb::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attributes.cuh"
#include "probe_bisect.cuh"

namespace {

using lzb::kLanes;
using lzb::kThreads;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    bisect_chain_kernel(const int32_t* __restrict__ x,
                        int32_t* __restrict__ tab,
                        const int32_t* __restrict__ start,
                        int32_t* __restrict__ state,
                        int32_t* __restrict__ out, int L, int iters) {
  constexpr bool kStage = lzb::stages(kMode);
  extern __shared__ uint4 smem[];
  int32_t* const sm = reinterpret_cast<int32_t*>(smem);
  const int tid = threadIdx.x, t = tid % kLanes, w = tid / kLanes;
  const lzb::Slice s = lzb::block_slice(L, blockIdx.x);
  const size_t sL = size_t(L);
  const bool chain = w == 0 && t < s.nl;
  if constexpr (kStage) {
    lzb::stage_in(sm, x, s, tid, kThreads);
    __syncthreads();
  }
  if constexpr (kMode == lzb::MODE_W1) {
    // every thread meets the one barrier of each iteration
    uint32_t* const parts = reinterpret_cast<uint32_t*>(sm + lzb::kSliceWords);
    const lzb::SliceColumn col{sm + t};
    lzp::BitState st{};
    if (chain) st = lzb::load_state(start, sL, s.lane0 + t);
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
      uint32_t* const buf = parts + (it & 1) * lzb::kPartWords;
      if (t < s.nl) buf[w * kLanes + t] = lzb::column_part(sm, w, t);
      __syncthreads();
      if (chain)
        lzb::bisect_iter<lzb::MODE_W1>(col, st, lzb::column_of(buf, t));
    }
    if (chain) lzb::store_state(state, out, sL, s.lane0 + t, st);
  } else if (chain) {
    if constexpr (kStage)
      lzb::bisect_lane<kMode>(lzb::SliceColumn{sm + t}, start, state, out,
                              sL, s.lane0 + t, iters);
    else  // no row but row 5 is read, and nothing is stored
      lzb::bisect_lane<kMode>(
          lzp::LaneMinorTable{const_cast<int32_t*>(x) + s.lane0 + t, L},
          start, state, out, sL, s.lane0 + t, iters);
  }
  if (kStage && tab != nullptr) {
    __syncthreads();
    lzb::stage_out(tab, sm, s, tid, kThreads);
  }
}

// Calls f(kernel) with mode's kernel; ERR_ARGS for no such mode.
template <class F>
int with_kernel(int mode, F&& f) {
  switch (mode) {
#define LZB_KERNEL(m) \
  case lzb::m:        \
    return f(reinterpret_cast<const void*>(bisect_chain_kernel<lzb::m>));
    LZB_KERNEL(MODE_V1)
    LZB_KERNEL(MODE_V2)
    LZB_KERNEL(MODE_V2MAX)
    LZB_KERNEL(MODE_V3)
    LZB_KERNEL(MODE_V4)
    LZB_KERNEL(MODE_W1)
    LZB_KERNEL(MODE_W2)
    LZB_KERNEL(MODE_W3)
    LZB_KERNEL(MODE_W4)
    LZB_KERNEL(MODE_W5)
    LZB_KERNEL(MODE_W8)
#undef LZB_KERNEL
  }
  return lzb::ERR_ARGS;
}

// The dynamic shared memory of mode's kernel, and its opt-in (above 48 KB;
// set before every launch, as probes.cu does).
int smem_bytes(int mode) { return lzb::stages(mode) ? lzb::kBlockBytes : 0; }

cudaError_t opt_in(const void* k, int mode) {
  return lzb::stages(mode)
             ? cudaFuncSetAttribute(
                   k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                   smem_bytes(mode))
             : cudaSuccess;
}

}  // namespace

extern "C" {

// x: [648, L] int32, not written; tab: [648, L] int32, the final table,
// written only where not null; start: [4, L] (idx, acc, rng, cod), not
// written; state: [4, L], the end; out: [L].
int lzb_bisect(int mode, const int32_t* x, int32_t* tab,
               const int32_t* start, int32_t* state, int32_t* out, int L,
               int iters, void* stream) {
  if (lzb::bad_args(mode, L, iters)) return lzb::ERR_ARGS;
  const unsigned blocks = unsigned((L - 1) / kLanes + 1);
  void* args[] = {&x, &tab, &start, &state, &out, &L, &iters};
  return with_kernel(mode, [&](const void* k) {
    cudaError_t e = opt_in(k, mode);
    if (e == cudaSuccess && tab != nullptr && !lzb::stages(mode))
      e = cudaMemcpyAsync(tab, x, size_t(lzb::kRows) * size_t(L) * 4,
                          cudaMemcpyDeviceToDevice,
                          static_cast<cudaStream_t>(stream));
    if (e == cudaSuccess)
      e = cudaLaunchKernel(k, dim3(blocks), dim3(kThreads), args,
                           size_t(smem_bytes(mode)),
                           static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

// The kernel of mode: out[0..3] as lzk::kernel_attributes gives them
// (after its opt-in), out[4] its threads a block, out[5] lanes a block,
// out[6] its dynamic shared memory a block. Returns 0, ERR_ARGS or a CUDA
// error.
int lzb_kernel_attributes(int mode, int* out) {
  return with_kernel(mode, [&](const void* k) {
    const cudaError_t e = opt_in(k, mode);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[4] = kThreads;
    out[5] = kLanes;
    out[6] = smem_bytes(mode);
    return lzk::kernel_attributes(k, out);
  });
}

const char* lzb_error_string(int code) {
  return code == lzb::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
