// Mosaic3 probe kernels for Hopper (sm_90a): the JAX package's Pallas
// probes of tools/probe_mosaic3.py, asked again on the card. The per-thread
// code is probe_mosaic3.cuh (shared with a host test build).
//
// The TPU probe asked which while-loop exits Mosaic could lower (a vector
// reduced to a scalar in the loop's condition) and what a few per-lane
// operations cost there: a variable shift against a select, a one-hot read
// by sum or by max, unrolling, small tables, a chunked refill. Its twelve
// Pallas functions (two pallas_call sites: _wrap :42 and p16 :289) compute
// four functions:
//
//   vote_chain   <- p7 (probe_mosaic3.py:53, P7), p8 (:72, P8),
//                   p9 (:92, P9)
//   byte_chain   <- p11a (:135, P11a), p11b (:155, P11b)
//   onehot_chain <- p12(True) (:181, P12s), p12(False) (P12m), p13 (:210,
//                   P13), p_small(8 | 64) (:236, P14, P15)
//   window_chain <- p10 (:114, P10), p16 (:262, P16)
//
// What bounds them on this card, and what the design does about it:
//   - vote_chain: one warp holds all L lanes (L <= 1024), ceil(L / 32)
//     of them a thread in registers (probe_mosaic3.cuh: vote_slots), and
//     votes on every iteration whether any lane is still below 5: each
//     thread tests its slots (their min below 5) and the warp votes, by
//     __any_sync (P7) or __reduce_max_sync over the 0/1 flags (P8; P9
//     after the update, so its body runs once), one redux.sync: a max
//     over 0/1 flags is an any. A per-thread or per-lane exit would be
//     another function (lanes that reached 5 go on counting while another
//     lane is below 5), so the vote stays in every iteration: bound by
//     the vote and the test after it, which is what the probe asks; no
//     barrier and no shared memory. Each iteration votes, branches on
//     the vote, then runs the body (probe_mosaic3.cuh: vote_loop): no
//     vote runs ahead of its iteration. Its state is written by thread 0.
//   - byte_chain: one thread per lane (blocks of kBlock = 128: the chain
//     is latency-bound, four warps on an SM's four schedulers), one serial
//     chain of a few integer operations a step, each step's byte picked by
//     the one before it. Bound by the chain's dependent instructions, so a
//     step is the fewest this card has for each mode
//     (probe_mosaic3.cuh: byte_step): P11a's pick of byte v & 3 is one
//     byte permute (PRMT, its selector (v & 3) | 0x4440 one LOP3 with the
//     constant held in a register: the kernel takes it as an argument),
//     then the add of i; P11b's select of four constant shifts forms the
//     four bytes before k = v & 3 resolves and picks by k's two bits, two
//     selects deep. Passes of four steps
//     keep the loop's counter and branch off the chain, each step's i a
//     base plus a constant; the remainder runs a step at a time.
//     chip_smoke.py phase 9 reads whether each mode's loop holds a PRMT.
//   - onehot_chain and window_chain: the TPU probes hold the whole table
//     in VMEM, the TPU core's on-chip memory (P16 also its two chunks in a
//     (64, L) VMEM scratch); a Hopper block's shared memory plays VMEM's
//     part. A block of kThreads = 256 threads stages its lanes' slice of
//     the table by cp.async and meets at a barrier; lanes a block are a
//     function of the table's rows (probe_mosaic3.cuh: lanes_per_block: a
//     2,048-row table's 128 lanes are 16 blocks of 8 on 16 SMs for the
//     one-hots, 32 blocks of 4 for P16). Each step's read waits on the
//     value the step before it read: latency-bound, no load goes ahead
//     across steps.
//   - onehot_chain: the slice lane-minor ([R, lb], lb <= 32: the chain
//     threads' loads lie in lb distinct banks whatever their rows), one
//     thread of the first warp a lane; a step is a shared load, the clamp
//     (max), the adds and idx's mod, an and where R is a power of two
//     (every R the tools use), else the floor mod. kUnroll = 8 puts eight
//     dependent reads in one loop pass (P13).
//   - window_chain: a warp a lane, its step's max over 64 rows split over
//     the warp's 32 ranks (two rows a rank) and reduced by
//     __reduce_max_sync. P10 keeps its rows 0-63 in registers (the rows do
//     not change between steps; nothing is staged); P16 holds each lane's
//     whole column lane-major in shared memory with a chunk of zeros after
//     it (every chunk is reachable: row0 < W / 8), staged lane-minor by
//     16-byte cp.async and moved into the columns by the block, its rows
//     XOR-swizzled so the moving stores and a chunk's 32 reads are
//     conflict-free,
//     and a rank reads its row of chunks row0 and row0 + 1 (clamped to
//     the zeros past the table) with two independent loads; base's mod is
//     an and where 16 W is a power of two. Its scratch is the ranks' last
//     two words, written only where asked for (full=True).
// These two and vote_chain start from the probes' zeros and write their
// state, and byte_chain reads v0 and writes v: a call is one launch.
// Threads of lanes past L in the last block stage and meet the barrier,
// then run no chain and store nothing. The staging is probe_stage.cuh's,
// which row_chain's P6 shares.
// Each launcher checks its arguments, opts its kernel in to the block's
// dynamic shared memory (where it has any), launches on `stream` and
// returns cudaGetLastError() (0 = launched) or lzm3::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_attributes.cuh"
#include "probe_mosaic3.cuh"

namespace {

using lzm3::kBlock;
using lzs::shared_of;

// vote_chain's warp on the card: the thread's slots, the warp's vote.
template <int kMode, int K>
struct CardVote {
  int32_t node[K];
  __device__ int vote() const {
    const int b = lzm3::vote_below<K>(node);
    return kMode == lzm3::VOTE_ANY
               ? (__any_sync(lzm3::kAll, b) != 0)
               : int(__reduce_max_sync(lzm3::kAll, unsigned(b)));
  }
  __device__ void step(uint32_t add) { lzm3::vote_body<K>(node, add); }
};

// One block of one warp; thread t's K slots are lanes t, t + 32, ...
template <int kMode, int K>
__global__ void __launch_bounds__(lzm3::kWarp)
    vote_chain_kernel(const int32_t* __restrict__ node0, int L,
                      int32_t* __restrict__ node_out,
                      int32_t* __restrict__ state, int iters) {
  const int t = threadIdx.x;
  CardVote<kMode, K> w;
  lzm3::vote_load<K>(node0, L, t, w.node);
  int flag;
  const int i = lzm3::vote_loop<kMode, K>(w, iters, flag);
  lzm3::vote_store<K>(w.node, L, t, node_out);
  if (t == 0) {
    state[0] = i;
    state[1] = flag;
  }
}

// A thread a lane; `pick` is lzm3::kBytePick (an argument, so that it
// stays in a register: probe_mosaic3.cuh).
template <int kMode>
__global__ void __launch_bounds__(kBlock)
    byte_chain_kernel(const int32_t* __restrict__ v0, int L,
                      int32_t* __restrict__ v, int iters, uint32_t pick) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  v[lane] = lzm3::byte_chain_lane<kMode>(v0[lane], iters, pick);
}

template <int kReduce, int kUnroll, bool kPow2>
__global__ void __launch_bounds__(lzm3::kThreads)
    onehot_chain_kernel(const int32_t* __restrict__ x, int R, int L, int lb,
                        int32_t* __restrict__ state, int iters) {
  extern __shared__ uint4 smem[];
  int32_t* const sm = reinterpret_cast<int32_t*>(smem);
  const int tid = threadIdx.x;
  const lzm3::Slice s = lzm3::block_slice(R, lb, L, blockIdx.x);
  lzm3::stage_minor(sm, x, s, tid, lzm3::kThreads);
  __syncthreads();
  if (tid >= s.nl) return;
  uint32_t acc;
  int32_t idx;
  lzm3::onehot_chain_lane<kReduce, kUnroll, kPow2>(
      shared_of(sm), uint32_t(tid) * 4, uint32_t(lb) * 4, R, iters, acc, idx);
  const int lane = s.lane0 + tid;
  state[lane] = lzm::wrap(acc);
  state[size_t(L) + lane] = idx;
}

// P10: warp f of the block runs lane 8 b + f; no staging, no barrier.
__global__ void __launch_bounds__(lzm3::kThreads)
    concat_kernel(const int32_t* __restrict__ x, int L,
                  int32_t* __restrict__ state, int iters) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * lzm3::kWindowLanes + (threadIdx.x >> 5);
  if (lane >= L) return;  // the whole warp
  int32_t r0, r1;
  lzm3::concat_rows(x, size_t(L), lane, t, r0, r1);
  uint32_t acc = 0;
#pragma unroll 1
  for (int i = 0; i < iters; ++i)
    acc += uint32_t(
        __reduce_max_sync(lzm3::kAll, lzm3::concat_rank(r0, r1, i)));
  if (t == 0) state[lane] = lzm::wrap(acc);
}

// P16: warp f of the block runs lane f of its slice.
template <bool kPow2>
__global__ void __launch_bounds__(lzm3::kThreads)
    refill_kernel(const int32_t* __restrict__ x, int W, int L, int lb,
                  int32_t* __restrict__ state,
                  int32_t* __restrict__ scratch, int iters) {
  extern __shared__ uint4 smem[];
  int32_t* const sm = reinterpret_cast<int32_t*>(smem);
  const int tid = threadIdx.x, f = tid >> 5, t = tid & 31;
  const lzm3::Slice s = lzm3::block_slice(W, lb, L, blockIdx.x);
  if (lzm3::stage_major_in(sm, x, s, tid, lzm3::kThreads)) {
    __syncthreads();
    lzm3::stage_major_out(sm, s, tid, lzm3::kThreads);
  }
  __syncthreads();
  if (f >= s.nl) return;  // the whole warp
  const lzm3::Shared m = shared_of(sm);
  const uint32_t at = lzm3::rank_at(f, t, lb, lzm3::refill_column(W));
  const int32_t chunks = W / lzm3::kChunk, mod = 16 * W;
  uint32_t acc = 0;
  int32_t base = 0, v0 = 0, v1 = 0;  // no step: the scratch is zeros
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const int32_t v = __reduce_max_sync(
        lzm3::kAll, lzm3::refill_rank(m, at, base >> lzm3::kBaseShift, chunks,
                                      v0, v1));
    lzm3::refill_carry<kPow2>(acc, base, v, mod);
  }
  const size_t lane = size_t(s.lane0 + f), sL = size_t(L);
  if (t == 0) {
    state[lane] = lzm::wrap(acc);
    state[sL + lane] = base;
  }
  if (scratch != nullptr) {
    scratch[t * sL + lane] = v0;
    scratch[(lzm3::kChunk + t) * sL + lane] = v1;
  }
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

// vote_chain's kernel for `mode` at L lanes: its slots a thread.
const void* vote_kernel(int mode, int L) {
  using lzm3::VOTE_ANY;
  using lzm3::VOTE_FLAG;
  using lzm3::VOTE_MAX;
  // [mode][log2 of the slots]
  static const void* const fns[3][6] = {
      {(const void*)vote_chain_kernel<VOTE_ANY, 1>,
       (const void*)vote_chain_kernel<VOTE_ANY, 2>,
       (const void*)vote_chain_kernel<VOTE_ANY, 4>,
       (const void*)vote_chain_kernel<VOTE_ANY, 8>,
       (const void*)vote_chain_kernel<VOTE_ANY, 16>,
       (const void*)vote_chain_kernel<VOTE_ANY, 32>},
      {(const void*)vote_chain_kernel<VOTE_MAX, 1>,
       (const void*)vote_chain_kernel<VOTE_MAX, 2>,
       (const void*)vote_chain_kernel<VOTE_MAX, 4>,
       (const void*)vote_chain_kernel<VOTE_MAX, 8>,
       (const void*)vote_chain_kernel<VOTE_MAX, 16>,
       (const void*)vote_chain_kernel<VOTE_MAX, 32>},
      {(const void*)vote_chain_kernel<VOTE_FLAG, 1>,
       (const void*)vote_chain_kernel<VOTE_FLAG, 2>,
       (const void*)vote_chain_kernel<VOTE_FLAG, 4>,
       (const void*)vote_chain_kernel<VOTE_FLAG, 8>,
       (const void*)vote_chain_kernel<VOTE_FLAG, 16>,
       (const void*)vote_chain_kernel<VOTE_FLAG, 32>}};
  return fns[mode][lzm3::log2_of(lzm3::vote_slots(L))];
}

// The kernel of a call, its lanes a block, its dynamic shared memory a
// block and its threads a block (vote_chain: one warp for all L lanes).
struct Kernel {
  const void* fn;
  int lb, smem;
  int threads = lzm3::kThreads;
};

Kernel onehot_kernel(int reduce, int unroll, int R) {
  using lzm3::REDUCE_MAX;
  using lzm3::REDUCE_SUM;
  // [reduce][unroll == 8][R a power of two]
  static const void* const fns[2][2][2] = {
      {{(const void*)onehot_chain_kernel<REDUCE_SUM, 1, false>,
        (const void*)onehot_chain_kernel<REDUCE_SUM, 1, true>},
       {(const void*)onehot_chain_kernel<REDUCE_SUM, 8, false>,
        (const void*)onehot_chain_kernel<REDUCE_SUM, 8, true>}},
      {{(const void*)onehot_chain_kernel<REDUCE_MAX, 1, false>,
        (const void*)onehot_chain_kernel<REDUCE_MAX, 1, true>},
       {(const void*)onehot_chain_kernel<REDUCE_MAX, 8, false>,
        (const void*)onehot_chain_kernel<REDUCE_MAX, 8, true>}}};
  return {fns[reduce][unroll == 8][lzm3::pow2(R)], lzm3::onehot_lanes(R),
          lzm3::onehot_bytes(R)};
}

Kernel window_kernel(int mode, int W) {
  const void* fn =
      mode == lzm3::WINDOW_CONCAT ? (const void*)concat_kernel
      : lzm3::pow2(W)             ? (const void*)refill_kernel<true>
                                  : (const void*)refill_kernel<false>;
  return {fn, lzm3::window_lanes(mode, W), lzm3::window_bytes(mode, W)};
}

// The kernel's opt-in to its block's dynamic shared memory (above 48 KB;
// set before every launch, as probes.cu does).
cudaError_t opt_in(const Kernel& k) {
  return k.smem == 0 ? cudaSuccess
                     : cudaFuncSetAttribute(
                           k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k.smem);
}

int launch(const Kernel& k, int L, void** args, void* stream) {
  if (L == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t e = opt_in(k);
  if (e == cudaSuccess)
    e = cudaLaunchKernel(k.fn, dim3(unsigned((L - 1) / k.lb + 1)),
                         dim3(lzm3::kThreads), args, size_t(k.smem),
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// out[0..3] as lzk::kernel_attributes gives them (after the opt-in),
// out[4] threads a block, out[5] lanes a block, out[6] dynamic shared
// memory a block.
int attributes(const Kernel& k, int* out) {
  const cudaError_t e = opt_in(k);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[4] = k.threads;
  out[5] = k.lb;
  out[6] = k.smem;
  return lzk::kernel_attributes(k.fn, out);
}

}  // namespace

extern "C" {

// node0, node: [L] int32 (L <= 1024, one warp); state: [2] int32, the
// iterations run and the last vote (P9: its flag), written.
int lzm3_vote_chain(int mode, const int32_t* node0, int L, int32_t* node,
                    int32_t* state, int iters, void* stream) {
  if (lzm3::bad_vote(mode, L, iters)) return lzm3::ERR_ARGS;
  void* args[] = {&node0, &L, &node, &state, &iters};
  const cudaError_t e =
      cudaLaunchKernel(vote_kernel(mode, L), dim3(1), dim3(lzm3::kWarp), args,
                       0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The slots a thread of vote_chain's warp holds for L lanes.
int lzm3_vote_slots(int L) {
  return lzm3::bad_vote(lzm3::VOTE_ANY, L, 0) ? lzm3::ERR_ARGS
                                              : lzm3::vote_slots(L);
}

// v0, v: [L] int32.
int lzm3_byte_chain(int mode, const int32_t* v0, int L, int32_t* v,
                    int iters, void* stream) {
  if (lzm3::bad_byte(mode, L, iters)) return lzm3::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > 0) {
    if (mode == lzm3::BYTE_SHIFT)
      byte_chain_kernel<lzm3::BYTE_SHIFT><<<blocks(L), kBlock, 0, s>>>(
          v0, L, v, iters, lzm3::kBytePick);
    else
      byte_chain_kernel<lzm3::BYTE_SELECT><<<blocks(L), kBlock, 0, s>>>(
          v0, L, v, iters, lzm3::kBytePick);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [R, L] int32, not changed; state: [2, L] (acc, idx), written (the
// chain starts from zeros). R <= 58,112 (one lane's column in a block).
int lzm3_onehot_chain(int reduce, int unroll, const int32_t* x, int R, int L,
                      int32_t* state, int iters, void* stream) {
  if (lzm3::bad_onehot(reduce, unroll, R, L, iters)) return lzm3::ERR_ARGS;
  const Kernel k = onehot_kernel(reduce, unroll, R);
  int lb = k.lb;
  void* args[] = {&x, &R, &L, &lb, &state, &iters};
  return launch(k, L, args, stream);
}

// x: [W, L] int32, not changed; state: written, [1, L] (acc: P10) or
// [2, L] (acc, base: P16; the chain starts from zeros); scratch: [64, L]
// int32 or null (P16 only), written. P16: W a multiple of 32, at most
// 58,080 (one lane's column and a chunk of zeros in a block).
int lzm3_window_chain(int mode, const int32_t* x, int W, int L,
                      int32_t* state, int32_t* scratch, int iters,
                      void* stream) {
  if (lzm3::bad_window(mode, W, L, iters)) return lzm3::ERR_ARGS;
  const Kernel k = window_kernel(mode, W);
  int lb = k.lb;
  void* concat_args[] = {&x, &L, &state, &iters};
  void* refill_args[] = {&x, &W, &L, &lb, &state, &scratch, &iters};
  return launch(k, L, mode == lzm3::WINDOW_CONCAT ? concat_args : refill_args,
                stream);
}

// The attributes of the kernel a call with these arguments launches (at
// least one lane, one iteration): see attributes(). Returns 0, ERR_ARGS or
// a CUDA error.
int lzm3_onehot_attributes(int reduce, int unroll, int R, int* out) {
  if (lzm3::bad_onehot(reduce, unroll, R, 1, unroll)) return lzm3::ERR_ARGS;
  return attributes(onehot_kernel(reduce, unroll, R), out);
}

int lzm3_window_attributes(int mode, int W, int* out) {
  if (lzm3::bad_window(mode, W, 1, 1)) return lzm3::ERR_ARGS;
  return attributes(window_kernel(mode, W), out);
}

// byte_chain's kernel for `mode`: a thread a lane, kBlock a block.
int lzm3_byte_attributes(int mode, int* out) {
  if (lzm3::bad_byte(mode, 1, 1)) return lzm3::ERR_ARGS;
  const void* fn = mode == lzm3::BYTE_SHIFT
                       ? (const void*)byte_chain_kernel<lzm3::BYTE_SHIFT>
                       : (const void*)byte_chain_kernel<lzm3::BYTE_SELECT>;
  return attributes({fn, kBlock, 0, kBlock}, out);
}

// vote_chain's kernel at L lanes: out[5] is L (one warp holds them all).
int lzm3_vote_attributes(int mode, int L, int* out) {
  if (lzm3::bad_vote(mode, L, 0)) return lzm3::ERR_ARGS;
  return attributes({vote_kernel(mode, L), L, 0, lzm3::kWarp}, out);
}

const char* lzm3_error_string(int code) {
  return code == lzm3::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
