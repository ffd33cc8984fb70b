// Round4 probe kernels for Hopper (sm_90a): the JAX package's Pallas
// probes of tools/probe_round4.py, asked again on the card. The per-block
// and per-thread code is probe_round4.cuh (shared with a host test build).
//
// The TPU probe priced the one-hot traversals of the gen-2 decoder's
// probability table ([784, 16, 128] int32 at 2,048 lanes) held in VMEM
// scratch: chained against independent selects, a blend write before
// them, narrow tables, a sublane gather. Its twenty rows (three
// pallas_call sites: _mk :88, narrow_1 :271, sel_s :430) compute these
// functions here, one thread per lane, the one-hot selects as direct
// indexed loads of the lane's column in shared memory:
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
// blends by stores and then loads of the same lane's column. A block
// holds the whole columns of its lb lanes (lanes_per_block: 32 for a
// 784-row int32 column, 100 KB a block; 16 for sel_s's 2,048 rows) in
// shared memory, [rows, lb] lane-minor, as the decoder keeps its
// probability table (segment_kernel.cuh) and the TPU probe its VMEM
// scratch; so a chain waits on shared-memory latency, not on L2 (a
// 128-lane block's 401 KB slice of device memory outran L1). With 4-byte
// entries and lb dividing 32 every lane of a warp reads its own bank
// whatever rows it picks; int16 and int8 entries share words (at most 2-
// and 4-way conflicts). A block of 128 threads stages its slice with
// cp.async in 16-byte chunks (entry by entry for a part-filled block or
// unaligned rows), gather_taa the 8 rows of the columns of lane % 128,
// and its first lb threads run the lanes, each row's address one
// multiply-add (the row times the slice's stride in bytes, `sb`, an
// argument: computed in the kernel, the compiler factored it into an
// index multiply-add and a shift-add); blend_chain
// writes its slice back into the wrapper's copy of the table (the input
// is not changed). Start and end state are separate buffers in device
// memory: gather_taa's thread (s, m) carries lane (0, m)'s chain from its
// start, which another thread of another block may already have ended.
// A column larger than 227 KB is refused (ERR_ARGS). Each launcher checks
// its arguments, opts its kernel in to 227 KB of dynamic shared memory
// once a device, launches on `stream` and returns cudaGetLastError() (0 =
// launched) or lzr4::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "kernel_attributes.cuh"
#include "probe_round4.cuh"

namespace {

using lzr4::kThreads;

template <class T, int kMode, int kN>
__global__ void __launch_bounds__(kThreads)
    select_chain_kernel(const T* __restrict__ x, int R, int L, int mask,
                        const int32_t* __restrict__ st0,
                        int32_t* __restrict__ st, int iters, int lb,
                        int sb) {
  extern __shared__ uint4 smem[];
  T* const sm = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x, lane = blockIdx.x * lb + t;
  const lzr4::Slice s = lzr4::select_slice(kMode, R, L, blockIdx.x, lb);
  lzr4::stage_in(sm, x, s, t, kThreads);
  __syncthreads();
  if (t < lb && lane < L)
    lzr4::select_chain_lane<T, kMode, kN>(sm + t, sb, R, L, lane, mask, st0,
                                          st, iters);
}

template <int kMode, int kN>
__global__ void __launch_bounds__(kThreads)
    blend_chain_kernel(int32_t* __restrict__ x, int R, int L,
                       const int32_t* __restrict__ st0,
                       int32_t* __restrict__ st, int iters, int lb,
                       int sb) {
  extern __shared__ uint4 smem[];
  int32_t* const sm = reinterpret_cast<int32_t*>(smem);
  const int t = threadIdx.x, lane = blockIdx.x * lb + t;
  const lzr4::Slice s = lzr4::blend_slice(R, L, blockIdx.x, lb);
  lzr4::stage_in(sm, x, s, t, kThreads);
  __syncthreads();
  if (t < lb && lane < L)
    lzr4::blend_chain_lane<kMode, kN>(sm + t, sb, R, L, lane, st0, st,
                                      iters);
  __syncthreads();
  lzr4::stage_out(x, sm, s, t, kThreads);
}

constexpr int kMaxDevices = 64;  // devices whose opt-in is remembered

// Kernel kKernel, opted in to the most dynamic shared memory a block may
// have on the current device: once a device (the attribute is the
// device's), at every call on a device numbered kMaxDevices or more; *err
// is the opt-in's result (or cudaGetDevice's). Two threads may both opt
// in the first time; setting the attribute twice is harmless.
template <auto kKernel>
const void* opted_in(cudaError_t* err) {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  *err = cudaGetDevice(&dev);
  const bool known = dev < kMaxDevices;
  if (*err == cudaSuccess && !(known && done[dev].load())) {
    *err = cudaFuncSetAttribute(kKernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                lzr4::kMaxShared);
    if (*err == cudaSuccess && known) done[dev].store(true);
  }
  return reinterpret_cast<const void*>(kKernel);
}

template <class B>
const void* select_kernel(cudaError_t* err) {
  return opted_in<select_chain_kernel<typename B::Elem, B::mode, B::n>>(err);
}

template <class B>
const void* blend_kernel(cudaError_t* err) {
  return opted_in<blend_chain_kernel<B::mode, B::n>>(err);
}

// Launch kernel `k` over L lanes, lb a block (a block of kThreads: all
// stage, the first lb run lanes), `rows` x lb entries of `elem` bytes of
// shared memory a block; `args` as cudaLaunchKernel takes them.
int launch(const void* k, cudaError_t opt, int L, int lb, int rows, int elem,
           void** args, cudaStream_t s) {
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const cudaError_t e = cudaLaunchKernel(
      k, dim3((L + lb - 1) / lb), dim3(kThreads), args,
      lzr4::block_bytes(rows, lb, elem), s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// out[0..3] (lzk::kernel_attributes) of a kernel whose opt-in gave `opt`.
int attributes(const void* k, cudaError_t opt, int* out) {
  if (opt != cudaSuccess) return static_cast<int>(opt);
  return lzk::kernel_attributes(k, out);
}

}  // namespace

extern "C" {

// Lanes a block for columns of `rows` entries of `elem` bytes (0: a
// column does not fit).
int lzr4_lanes_per_block(int rows, int elem) {
  return lzr4::lanes_per_block(rows, elem);
}

// The table rows a select mode stages (blend_chain stages all R).
int lzr4_staged_rows(int mode, int R) { return lzr4::staged_rows(mode, R); }

// A block's dynamic shared memory for `rows` x `lb` entries of `elem`
// bytes.
long long lzr4_block_bytes(int rows, int lb, int elem) {
  return static_cast<long long>(lzr4::block_bytes(rows, lb, elem));
}

// x: [R, L], `elem` bytes an entry (4: int32; 2: int16 and 1: int8, for
// SEL_CHAIN with n = 1 only), not changed; st0: [4, L] int32, the start,
// not changed; st: [4, L] int32, the end; mask: 1023 or 2047 (_idx_mix's
// and).
int lzr4_select_chain(int mode, int n, int elem, const void* x, int R, int L,
                      int mask, const int32_t* st0, int32_t* st, int iters,
                      void* stream) {
  using namespace lzr4;
  if (bad_select(mode, n, elem, mask, R, L, iters)) return ERR_ARGS;
  const int rows = staged_rows(mode, R);
  int lb = lanes_per_block(rows, elem), sb = lb * elem;
  void* args[] = {&x, &R, &L, &mask, &st0, &st, &iters, &lb, &sb};
  return with_select(mode, n, elem, [&](auto build) {
    cudaError_t opt;
    const void* k = select_kernel<decltype(build)>(&opt);
    return launch(k, opt, L, lb, rows, elem, args,
                  static_cast<cudaStream_t>(stream));
  });
}

// x: [R, L] int32, written in place (the wrapper's copy); st0: [4, L]
// int32, the start, not changed; st: [4, L] int32, the end.
int lzr4_blend_chain(int mode, int n, int32_t* x, int R, int L,
                     const int32_t* st0, int32_t* st, int iters,
                     void* stream) {
  using namespace lzr4;
  if (bad_blend(mode, n, R, L, iters)) return ERR_ARGS;
  int lb = lanes_per_block(R, 4), sb = lb * 4;
  void* args[] = {&x, &R, &L, &st0, &st, &iters, &lb, &sb};
  return with_blend(mode, n, [&](auto build) {
    cudaError_t opt;
    const void* k = blend_kernel<decltype(build)>(&opt);
    return launch(k, opt, L, lb, R, 4, args,
                  static_cast<cudaStream_t>(stream));
  });
}

// The attributes of the select (blend = 0: mode, n, elem) or blend
// (blend = 1: mode, n) build, into out[0..3] (see attributes()). Returns
// 0, ERR_ARGS for a build that does not exist, or a CUDA error.
int lzr4_kernel_attributes(int blend, int mode, int n, int elem, int* out) {
  using namespace lzr4;
  if (blend)
    return with_blend(mode, n, [&](auto build) {
      cudaError_t opt;
      const void* k = blend_kernel<decltype(build)>(&opt);
      return attributes(k, opt, out);
    });
  return with_select(mode, n, elem, [&](auto build) {
    cudaError_t opt;
    const void* k = select_kernel<decltype(build)>(&opt);
    return attributes(k, opt, out);
  });
}

const char* lzr4_error_string(int code) {
  return code == lzr4::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
