// Mosaic4 probe kernel for Hopper (sm_90a): the JAX package's Pallas probes
// of tools/probe_mosaic4.py, asked again on the card. The per-lane and
// per-rank code is probe_mosaic4.cuh (shared with a host test build).
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
// What bounds it on this card, and what the design does about it. The TPU
// probe holds its table and tile in VMEM scratch; here a block's shared
// memory plays VMEM's part: a block of kLanes = 8 lanes (the tool's 128
// lanes are 16 blocks on 16 SMs) and kThreads = 128 threads, which fill
// its [512, 8] table with 7 and zero its [64, 8] tile in shared memory
// (18,432 B), 16 bytes a store. One warp runs the chains, each lane in 4
// threads that load the same words and store the same values, so all 32
// threads take the lanes' state into the warp's shared work. Each step is
// a dependent shared load, a store to the same word and a few integer
// operations (idx = (idx + v) % 512 is one and): latency-bound. The
// chain's shared accesses are ld/st.shared through a base address held in
// a register (probe_mosaic4.cuh: Shared). A run's first step alone tests
// whether idx lies in the table; build2's k term depends on acc alone, so
// its load is issued ahead of the table's. One warp moves shared memory
// at a fraction of the SM's rate (PERF.md), so the bulk work is cut by the
// lanes a warp carries and shared by its 32 threads: a round's refill is
// 16 loads and 16 stores a thread, and the reset is the warp's: the
// lanes' flags (acc % 17 == 0, formed a step ahead) are gathered by
// __ballot_sync; where every lane flags (the tool's input, where all acc
// start at 0) the table is written whole in 16-byte stores; where a few
// flag (the seeded input) the 32 threads write each flagged lane's column
// together, which needs the lane's rows spread over the banks: the reset
// variants' rows are XOR-swizzled (probe_mosaic4.cuh: slot), the others'
// not, each the faster as measured (PERF.md).
//
// Which sync orders each shared access that crosses threads (a lane's
// copies are threads too; __ballot_sync gathers the flags and orders no
// memory): a step's load and store of its word, by __syncwarp between
// them (every copy's load before any copy's store; a copy's next load
// follows its own store, and its siblings' earlier stores precede the
// __syncwarp it has passed); when_reset_refed's tile word, each copy
// reading back after its own store of the same flag, and the next step's
// stores of it after that step's __syncwarp; a round's refill, by
// __syncwarp before it (the steps' stores before the ranks' loads) and
// after it (the ranks' tile stores before the next round); a step's
// resets, by __syncwarp before them (the step's stores before the ranks'
// stores to the same columns) and after them (before the next loads). A
// step with no flag has no resets and no sync there. build2 stores
// nothing while it runs, so its steps need no sync.
//
// The block-wide max that guards when_reset's pl.when changes no result,
// so the card has no vote; when_reset_refed writes its flag to the tile's
// row 0 and reads it back (a volatile shared word), as the probe does.
// Table and tile leave shared memory only where their pointers are given
// (the wrapper's full=True); the timed call gives none. The kernel reads
// the start from `start` and `it0` and writes the end to `state` and
// `it_out`, so a call is one launch. Lanes past L in the last block are
// filled, written back and run by their threads, which meet every barrier
// and ballot (their flags count as 0); they store no state. sched8_blend's
// sum over the 8 rows of k is written as selects: its product form was
// miscompiled by ptxas (probe_mosaic4.cuh).
// The launcher checks its arguments, opts its kernel in to the block's
// dynamic shared memory, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzm4::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attributes.cuh"
#include "probe_mosaic4.cuh"

namespace {

using lzm4::kLanes;
using lzm4::kThreads;

// The chain warp: thread t runs lane f = t % 8 of the block's nl, with
// the lane's other copies (threads past nl run a dummy chain on their own
// lane's column, which nothing reads; its flags are 0, its state not
// stored). Thread t < 8 stands for its lane in the ballot.
template <int kMode>
struct WarpChain {
  lzm4::Shared sm;   // the block's table and tile
  int t, f;
  const int32_t* k;
  size_t L;
  int lane;
  bool primary;      // t < nl: the lane's flag goes to the ballot
  lzm4::Lane s;
  bool flag;         // the next step's reset flag, formed a step ahead
  int32_t it;

  // One step and the warp's resets after it. The flag was formed during
  // the step before (it depends on acc alone), so the ballot waits on
  // nothing of this step's chain.
  template <bool kCheck>
  __device__ __forceinline__ void one_step() {
    using namespace lzm4;
    bool fl = flag;
    if (resets(kMode)) flag = reset_flag(s.acc + 2u);
    step<kMode, kCheck>(sm, f, k, L, lane, s);
    if (resets(kMode)) {
      if (kMode == MODE_RESET_REFED) fl = through_tile(sm, f, fl);
      const uint32_t m = __ballot_sync(kAll, fl && primary);
      if (m != 0u) {
        __syncwarp();
        reset_rank(sm, m, t);
        __syncwarp();
      }
    }
    it = wrap(uint32_t(it) + 1u);
  }

  // A round's refill by the warp's 32 ranks, after the steps' stores and
  // before the next ones.
  __device__ __forceinline__ void refill() {
    if (!lzm4::refills(kMode)) return;
    __syncwarp();
    lzm4::refill_rank(sm, t, lzm4::swizzle_of(kMode), s.idx);
    __syncwarp();
  }

  // From it0 while it < limit: a round's refill, then its 16 steps; the
  // run's first step asks whether idx lies in the table, the others need
  // not (probe_mosaic4.cuh: step).
  __device__ __forceinline__ void run(int32_t limit) {
    using namespace lzm4;
    if (!(it < limit)) return;
    flag = resets(kMode) && reset_flag(s.acc + 1u);
    refill();
    one_step<true>();
#pragma unroll 1
    for (int j = 1; j < kRound; ++j) one_step<false>();
#pragma unroll 1
    while (it < limit) {
      refill();
#pragma unroll 1
      for (int j = 0; j < kRound; ++j) one_step<false>();
    }
  }
};

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    table_chain_kernel(const int32_t* __restrict__ k,
                       const int32_t* __restrict__ start,
                       int32_t* __restrict__ tab, int32_t* __restrict__ tile,
                       int32_t* __restrict__ state,
                       const int32_t* __restrict__ it0,
                       int32_t* __restrict__ it_out, int L, int limit) {
  extern __shared__ uint4 smem[];
  int32_t* const sm = reinterpret_cast<int32_t*>(smem);
  const int tid = threadIdx.x, lane0 = blockIdx.x * kLanes;
  const int nl = L - lane0 < kLanes ? L - lane0 : kLanes;
  lzm4::fill_rank(sm, kMode, tid, kThreads);
  __syncthreads();
  if (tid < lzm4::kWarp) {
    // the shared-space address of the block's memory, held in a register
    uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
    asm("" : "+r"(base));
    const int f = tid % kLanes;
    const bool real = f < nl;
    const int lane = real ? lane0 + f : lane0;  // a dummy reads a real k
    WarpChain<kMode> c{lzm4::Shared{base}, tid, f, k, size_t(L), lane,
                       tid < nl,
                       real ? lzm4::load_lane(start, size_t(L), lane)
                            : lzm4::Lane{0, 0u},
                       false, *it0};
    c.run(limit);
    if (tid < nl) lzm4::store_lane(state, size_t(L), lane, c.s);
    if (blockIdx.x == 0 && tid == 0) *it_out = c.it;
  }
  if (tab != nullptr) {
    __syncthreads();
    lzm4::write_back_rank(tab, tile, sm, lzm4::swizzle_of(kMode), size_t(L),
                          lane0, nl, tid, kThreads);
  }
}

// Calls f(kernel) with mode's kernel; ERR_ARGS for no such mode.
template <class F>
int with_kernel(int mode, F&& f) {
  switch (mode) {
#define LZM4_KERNEL(m) \
  case lzm4::m:        \
    return f(reinterpret_cast<const void*>(table_chain_kernel<lzm4::m>));
    LZM4_KERNEL(MODE_BASE)
    LZM4_KERNEL(MODE_RESET)
    LZM4_KERNEL(MODE_RESET_REFED)
    LZM4_KERNEL(MODE_SCHED_MAX)
    LZM4_KERNEL(MODE_SCHED_SUM)
    LZM4_KERNEL(MODE_SCHED_BLEND)
#undef LZM4_KERNEL
  }
  return lzm4::ERR_ARGS;
}

// A block's dynamic shared memory, and the kernel's opt-in to it (above
// 48 KB; set before every launch, as probes.cu does).
int smem_bytes(int mode) { return lzm4::block_words(mode) * 4; }

cudaError_t opt_in(const void* k, int mode) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(mode));
}

}  // namespace

extern "C" {

// k: [8, L] int32 (the sched modes) or null; start: [2, L] (idx, acc), not
// written; tab: [512, L] and tile: [64, L] int32 (tile for build only),
// the final table and tile, written only where not null; state: [2, L],
// the end; it0: [1], the loop's start count; it_out: [1], its end; limit:
// the loop runs while it < limit.
int lzm4_table_chain(int mode, const int32_t* k, int L, const int32_t* start,
                     int32_t* tab, int32_t* tile, int32_t* state,
                     const int32_t* it0, int32_t* it_out, int limit,
                     void* stream) {
  if (lzm4::bad_table(mode, k, tab, tile, L, limit)) return lzm4::ERR_ARGS;
  const unsigned blocks = unsigned((L - 1) / kLanes + 1);
  void* args[] = {&k, &start, &tab, &tile, &state, &it0, &it_out,
                  &L, &limit};
  return with_kernel(mode, [&](const void* kern) {
    cudaError_t e = opt_in(kern, mode);
    if (e == cudaSuccess)
      e = cudaLaunchKernel(kern, dim3(blocks), dim3(kThreads), args,
                           size_t(smem_bytes(mode)),
                           static_cast<cudaStream_t>(stream));
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  });
}

// The kernel of mode: out[0..3] as lzk::kernel_attributes gives them
// (after its opt-in), out[4] its threads a block, out[5] lanes a block,
// out[6] its dynamic shared memory a block. Returns 0, ERR_ARGS or a CUDA
// error.
int lzm4_kernel_attributes(int mode, int* out) {
  return with_kernel(mode, [&](const void* kern) {
    const cudaError_t e = opt_in(kern, mode);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[4] = kThreads;
    out[5] = kLanes;
    out[6] = smem_bytes(mode);
    return lzk::kernel_attributes(kern, out);
  });
}

const char* lzm4_error_string(int code) {
  return code == lzm4::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
