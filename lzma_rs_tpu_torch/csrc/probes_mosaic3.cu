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
//   - vote_chain: one block holds all L lanes (L <= 1024) and votes on
//     every iteration whether any lane is still below 5: __syncthreads_or
//     (P7), or a warp max (__reduce_max_sync) and the warps' maxima through
//     shared memory (P8; P9 after the update, so its body runs once). A
//     per-warp exit would be another function (lanes that reached 5 go on
//     counting while a lane of another warp is below 5), so the whole
//     block waits at a barrier each iteration: latency-bound by the
//     barrier, which is what the probe asks.
//   - byte_chain: one thread per lane, a dependent chain of a few integer
//     operations; P11a's shift by 8 (v & 3) and P11b's select of four
//     constant shifts are written as the probe writes them, so the SASS
//     shows whether nvcc makes them one code.
//   - onehot_chain: one thread per lane walks a lane-minor [R, L] table by
//     direct load (the one-hot read of the TPU is an indexed load here):
//     each next address waits on the loaded value and a floor mod by R (an
//     integer division). Latency-bound: the table's size picks the level
//     of the cache that serves the load (R = 8 and 64 rows of 512 B: 4 and
//     32 KiB, L1; 2,048 rows: 1 MiB, L2). kUnroll = 8 puts eight dependent
//     reads in one loop pass (P13).
//   - window_chain: one thread per lane takes a max over 64 rows of its
//     column each step: P10 over rows 0-63 plus i (the loads do not depend
//     on the step, so they stay in registers or L1 and the step is 64 adds
//     and maxes), P16 over the two 32-row chunks that base // 128 picks
//     (zeros past the table), each step's chunks waiting on the last max.
// Each launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() (0 = launched) or lzm3::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_mosaic3.cuh"

namespace {

using lzm3::kBlock;

// The block-wide max of `pred` (0 or 1) over all threads. `votes` is one
// of two buffers used in turns, so a warp that runs ahead to the next vote
// does not overwrite what a slower warp still reads.
__device__ int block_max(int pred, int* votes, int warps) {
  const int w = __reduce_max_sync(0xffffffffu, pred);
  if ((threadIdx.x & 31) == 0) votes[threadIdx.x >> 5] = w;
  __syncthreads();
  int m = 0;
  for (int k = 0; k < warps; ++k) m = votes[k] > m ? votes[k] : m;
  return m;
}

template <int kMode>
__global__ void __launch_bounds__(lzm3::kMaxLanes)
    vote_chain_kernel(const int32_t* __restrict__ node0, int L,
                      int32_t* __restrict__ node_out,
                      int32_t* __restrict__ state, int iters) {
  __shared__ int votes[2][lzm3::kMaxLanes / 32];
  const int lane = threadIdx.x;
  const bool live = lane < L;  // threads past L (the last warp's) vote 0
  const int warps = blockDim.x >> 5;
  int32_t node = live ? node0[lane] : 0;
  int i = 0, flag = 1;
  for (;;) {
    const int below = live && node < lzm3::kVoteBelow;
    if (kMode == lzm3::VOTE_ANY)
      flag = __syncthreads_or(below) != 0;
    else if (kMode == lzm3::VOTE_MAX)
      flag = block_max(below, votes[i & 1], warps);
    if (!flag || i >= iters) break;
    node = lzm3::vote_step(node, i);
    ++i;
    if (kMode == lzm3::VOTE_FLAG)
      flag = block_max(live && node < lzm3::kVoteBelow, votes[i & 1], warps);
  }
  if (live) node_out[lane] = node;
  if (lane == 0) {
    state[0] = i;
    state[1] = flag;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kBlock)
    byte_chain_kernel(const int32_t* __restrict__ v0, int L,
                      int32_t* __restrict__ v, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  v[lane] = lzm3::byte_chain_lane<kMode>(v0[lane], iters);
}

template <int kReduce, int kUnroll>
__global__ void __launch_bounds__(kBlock)
    onehot_chain_kernel(const int32_t* __restrict__ x, int R, int L,
                        int32_t* __restrict__ state, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzm3::onehot_chain_lane<kReduce, kUnroll>(x, R, L, lane, state, iters);
}

template <int kMode>
__global__ void __launch_bounds__(kBlock)
    window_chain_kernel(const int32_t* __restrict__ x, int W, int L,
                        int32_t* __restrict__ state,
                        int32_t* __restrict__ scratch, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzm3::window_chain_lane<kMode>(x, W, L, lane, state, scratch, iters);
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

template <int kReduce, int kUnroll>
void launch_onehot(const int32_t* x, int R, int L, int32_t* state, int iters,
                   cudaStream_t s) {
  onehot_chain_kernel<kReduce, kUnroll><<<blocks(L), kBlock, 0, s>>>(
      x, R, L, state, iters);
}

}  // namespace

extern "C" {

// node0, node: [L] int32 (L <= 1024, one block); state: [2] int32, the
// iterations run and the last vote (P9: its flag).
int lzm3_vote_chain(int mode, const int32_t* node0, int L, int32_t* node,
                    int32_t* state, int iters, void* stream) {
  if (lzm3::bad_vote(mode, L, iters)) return lzm3::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = (L + 31) / 32 * 32;
  if (mode == lzm3::VOTE_ANY)
    vote_chain_kernel<lzm3::VOTE_ANY><<<1, threads, 0, s>>>(node0, L, node,
                                                            state, iters);
  else if (mode == lzm3::VOTE_MAX)
    vote_chain_kernel<lzm3::VOTE_MAX><<<1, threads, 0, s>>>(node0, L, node,
                                                            state, iters);
  else
    vote_chain_kernel<lzm3::VOTE_FLAG><<<1, threads, 0, s>>>(node0, L, node,
                                                             state, iters);
  return static_cast<int>(cudaGetLastError());
}

// v0, v: [L] int32.
int lzm3_byte_chain(int mode, const int32_t* v0, int L, int32_t* v,
                    int iters, void* stream) {
  if (lzm3::bad_byte(mode, L, iters)) return lzm3::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > 0) {
    if (mode == lzm3::BYTE_SHIFT)
      byte_chain_kernel<lzm3::BYTE_SHIFT><<<blocks(L), kBlock, 0, s>>>(
          v0, L, v, iters);
    else
      byte_chain_kernel<lzm3::BYTE_SELECT><<<blocks(L), kBlock, 0, s>>>(
          v0, L, v, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [R, L] int32, not changed; state: [2, L] (acc, idx), the start in,
// the end out.
int lzm3_onehot_chain(int reduce, int unroll, const int32_t* x, int R, int L,
                      int32_t* state, int iters, void* stream) {
  if (lzm3::bad_onehot(reduce, unroll, R, L, iters)) return lzm3::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > 0) {
    if (reduce == lzm3::REDUCE_SUM && unroll == 1)
      launch_onehot<lzm3::REDUCE_SUM, 1>(x, R, L, state, iters, s);
    else if (reduce == lzm3::REDUCE_SUM)
      launch_onehot<lzm3::REDUCE_SUM, 8>(x, R, L, state, iters, s);
    else if (unroll == 1)
      launch_onehot<lzm3::REDUCE_MAX, 1>(x, R, L, state, iters, s);
    else
      launch_onehot<lzm3::REDUCE_MAX, 8>(x, R, L, state, iters, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [W, L] int32, not changed; state: [2, L] (acc, base), the start in,
// the end out; scratch: [64, L] int32 or null (WINDOW_REFILL only).
int lzm3_window_chain(int mode, const int32_t* x, int W, int L,
                      int32_t* state, int32_t* scratch, int iters,
                      void* stream) {
  if (lzm3::bad_window(mode, W, L, iters)) return lzm3::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L > 0) {
    if (mode == lzm3::WINDOW_CONCAT)
      window_chain_kernel<lzm3::WINDOW_CONCAT><<<blocks(L), kBlock, 0, s>>>(
          x, W, L, state, scratch, iters);
    else
      window_chain_kernel<lzm3::WINDOW_REFILL><<<blocks(L), kBlock, 0, s>>>(
          x, W, L, state, scratch, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lzm3_error_string(int code) {
  return code == lzm3::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
