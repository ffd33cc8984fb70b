// Mosaic probe kernels for Hopper (sm_90a): the JAX package's Pallas probes
// of tools/probe_mosaic.py and tools/probe_mosaic2.py, asked again on the
// card. The per-thread code is probe_mosaic.cuh (shared with a host test
// build).
//
// The TPU probes asked which per-lane dynamic-indexing patterns Mosaic
// lowers and what each costs: gathers along either axis, one-hot masked
// reads and writes, scalar reads and writes, a carried index, packed
// bytes, refills and segment updates. A CUDA thread indexes memory
// directly, so the one-hot forms are plain indexed loads and stores here
// (the semantics are ported, not the one-hot), and the twelve Pallas
// functions compute four functions:
//
//   gather_sum    <- probe_gather_minor (probe_mosaic.py:109, A),
//                    probe_gather_sublane (:144, B), probe_onehot_read
//                    (:182, C), probe_dynrow (:271, F)
//   rw_chain      <- probe_onehot_write (:211, D), probe_scalar_rw (:242, E)
//   row_chain     <- p1 (probe_mosaic2.py:63), p2 (:95), p3 (:129),
//                    p6 (:233)
//   segment_chain <- p4 (probe_mosaic2.py:162), p5 (:198)
//
// What bounds them on this card, and what the design does about it:
//   - gather_sum: `iters` loads an output element whose addresses do not
//     depend on loaded data, summed (a wrapping add, so in any order). A
//     thread an output would put C's and F's 128 outputs on one SM, 4
//     warps each walking 512 loads; so an output's loads are split over a
//     warp (probe_mosaic.cuh: gather_group), whose 32 loads of a step
//     along a row coalesce, and the partial sums meet in
//     __reduce_add_sync: C and F run a warp a block on 128 SMs. The major
//     axis from 4,096 outputs (B [64, 128], B [512, 128]) keeps a thread an
//     output, in 32-thread blocks. The index's floor mod by the run-time
//     mod, an integer divide, runs at a walk's start and its int32 wraps
//     only; between them the index steps by an add and a conditional
//     subtract. Every table fits the 50 MB L2; the loads' issue and
//     latency, and at A [128, 1024] the 4 M threads' own set-up, set the
//     time.
//   - rw_chain: D's read-modify-writes (+1 at an advancing index of each
//     row) do not depend on each other's data, and a wrapping add commutes.
//     A thread a row put the 128 rows on one SM, each load waiting behind
//     the last store; so a row's steps are split over a warp (gather_sum's
//     launch: the 128 rows on 128 SMs), each step an atomic add whose
//     result is not read (RED), a warp's 32 of a step neighbouring words
//     of the row; the index steps as gather_sum's does. Bound by the adds'
//     issue at L2 and the launch. E is one serial chain of carries: a block
//     stages its [1, W] row into shared memory (W <= kScalarMaxCols, else
//     ERR_ARGS), one thread runs the chain there, the block writes the row
//     back. The loads' addresses do not depend on the data, so each is
//     issued kScalarAhead iterations early; a load that a pending store
//     overwrites takes the stored word from registers (probe_mosaic.cuh:
//     rw_scalar). The chain an iteration is a select and carry's add.
//   - row_chain: p6 (ROW_BYTE) is one serial chain a lane, each load's
//     row waiting on the byte before it; its walk reaches the first
//     quarter of the column only (idx < W, row idx >> 2), so a block of
//     256 threads stages that quarter of its lanes' columns into shared
//     memory by 16-byte cp.async (probe_stage.cuh, the staging onehot_chain
//     uses), meets once at a barrier, and a thread a lane runs the chain
//     there: a step is a dependent shared load, the shift, the and, the
//     adds and the mod (an and where W is a power of two). Latency-bound
//     by the load and the few operations after it; no load goes ahead
//     across steps. Lanes a block follow from the staged bytes
//     (byte_lanes: 16 at W = 2,048, 32 KiB). p1-p3 start at idx 0, so their
//     addresses do not depend on the data: a block of 256 threads takes 8
//     lanes (a row's 8 lanes fill a 32-byte sector; the tool's 128 lanes
//     on 16 SMs), its 32 ranks a lane each owning rows r, r + 32, ... and
//     walking their visits in step order, so p3's writes stay exact; the
//     partial sums meet by shuffles and shared memory (a wrapping add).
//     p3 writes its table into the output in the same launch, copying
//     the unvisited rows by 16-byte loads and stores. Bound by the loads'
//     latency and the launch. Both start from the probes' zeros and write
//     their state: a call is one launch.
//   - segment_chain: p4 is one serial chain of adds a lane (acc += s on
//     two rows, s = x[0:2] + i every 8th step), a thread a lane in blocks
//     of kBlock = 128 (latency-bound: four warps, one a scheduler).
//     Nothing in p4 writes x, so the lane's two source words are read
//     once, coalesced, into registers before the loop (the TPU probe holds
//     x_ref in VMEM), its scratch s is two registers, and no load is left
//     on the chain: rounds of 8 steps with the refill at each round's
//     start, no closed form of a round (probe_mosaic.cuh: refill_lane,
//     refill_add; chip_smoke.py phase 8 reads that the loop loads
//     nothing). Bound by the add chain and the launch. p5 is a vector pass
//     over the whole table each step on the TPU (+1 on one segment, a max
//     over rows on four): a lane's rows are not a serial chain, only the table,
//     mask and total carry from step to step. So a block is a lane (the
//     tool's 128 lanes are 128 blocks on 132 SMs): it stages the lane's
//     column (8 KiB at W = 2,048) into shared memory once, and its 256
//     threads walk it, two warps a segment, each thread its own rows, 8
//     loads in flight before any store (so a step needs no barrier); a
//     warp's max (__reduce_max_sync) is kept by one lane a step, and
//     every 16 steps the lanes post them by a shared atomicMax into a
//     step's slots and the block meets at a barrier pair to fold the
//     slots into total (probe_mosaic.cuh). Every step still reads every
//     row and writes the mask segment's: that walk is what the probe
//     prices. Bound by the step's shared loads and their latency, and the
//     warp reduction's; the table's bytes are read once. A column
//     over kSegMaxRows (58,048 rows: the column and the slots in 227 KB)
//     is refused (ERR_ARGS): there is no device-memory route. Both start
//     from the probes' zeros and write their state, p5 its final column
//     into a new table (x is not written): a call is one launch.
// Each launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() (0 = launched), a CUDA error of the opt-in, or
// lzm::ERR_ARGS.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "kernel_attributes.cuh"
#include "probe_mosaic.cuh"

namespace {

using lzm::kBlock;

// gather_sum: kGroup threads an output (probe_mosaic.cuh: gather_group),
// rank r of the group taking steps r, r + kGroup, ...; a warp's ranks add
// their partial sums with __reduce_add_sync. A group is a whole warp or
// one thread and a block a whole number of warps, so a warp's threads all
// serve outputs below n_out or none does.
template <int kAxis, class T, int kGroup>
__global__ void __launch_bounds__(kBlock)
    gather_sum_kernel(const T* __restrict__ x, int x_cols,
                      const int32_t* __restrict__ start, int32_t stride,
                      int32_t S, uint32_t step, int32_t mod,
                      T* __restrict__ out, int n_out, int out_cols,
                      int iters) {
  const long long t = (long long)(blockIdx.x) * blockDim.x + threadIdx.x;
  const int e = int(t / kGroup), r = int(t % kGroup);
  if (e >= n_out) return;
  const int count = lzm::gather_count(r, kGroup, iters);
  uint32_t acc = 0;
  if (count > 0)
    acc = lzm::gather_part<kAxis, T>(
        x, x_cols, lzm::gather_line<kAxis>(e, out_cols),
        lzm::gather_first(start[e], stride, r), S, step, mod, count);
  if (kGroup > 1) acc = __reduce_add_sync(0xFFFFFFFFu, acc);
  if (r == 0) out[e] = static_cast<T>(acc);
}

// D: a warp a row (probe_mosaic.cuh: rw_rank), gather_sum's launch for
// as many outputs as rows; step = floor_mod(kGatherWarp, cols).
__global__ void __launch_bounds__(kBlock)
    rw_rows_kernel(int32_t* x, int rows, int cols,
                   const int32_t* __restrict__ start, uint32_t step,
                   int iters) {
  const long long t = (long long)(blockIdx.x) * blockDim.x + threadIdx.x;
  const int e = int(t / lzm::kGatherWarp), r = int(t % lzm::kGatherWarp);
  if (e >= rows) return;
  lzm::rw_rank(x + size_t(e) * cols, cols, start[e], step, r, iters);
}

// E: one block stages the row into shared memory, thread 0 runs the chain
// there (probe_mosaic.cuh: rw_scalar), and the block writes the row back.
__global__ void __launch_bounds__(lzm::kScalarThreads)
    rw_scalar_kernel(int32_t* __restrict__ x, int cols,
                     int32_t* __restrict__ out, int iters) {
  extern __shared__ int32_t row[];
  for (int k = threadIdx.x; k < cols; k += lzm::kScalarThreads) row[k] = x[k];
  __syncthreads();
  if (threadIdx.x == 0) *out = lzm::rw_scalar(row, cols, iters);
  __syncthreads();
  for (int k = threadIdx.x; k < cols; k += lzm::kScalarThreads) x[k] = row[k];
}

// p6: block b stages rows [0, byte_rows(W)) of its lb lanes' columns,
// then thread f < nl runs lane lb b + f (probe_mosaic.cuh:
// byte_chain_lane).
template <bool kPow2>
__global__ void __launch_bounds__(lzm::kRowThreads)
    byte_chain_kernel(const int32_t* __restrict__ x, int W, int L, int lb,
                      int32_t* __restrict__ state, int iters) {
  extern __shared__ uint4 slice[];  // 16-byte aligned for cp.async
  int32_t* const sm = reinterpret_cast<int32_t*>(slice);
  const int tid = threadIdx.x;
  const lzs::Slice s =
      lzs::block_slice(lzm::byte_rows(W), lb, L, blockIdx.x);
  lzs::stage_minor(sm, x, s, tid, lzm::kRowThreads);
  __syncthreads();
  if (tid >= s.nl) return;
  uint32_t acc;
  int32_t idx;
  lzm::byte_chain_lane<kPow2>(lzs::shared_of(sm), uint32_t(tid) * 4,
                              uint32_t(lb) * 4, W, iters, acc, idx);
  const int lane = s.lane0 + tid;
  state[lane] = lzm::wrap(acc);
  state[size_t(L) + lane] = idx;
}

// p1-p3: block (b, 0) takes lanes kRowLanes b + f, thread t rank t /
// kRowLanes of lane t % kRowLanes (probe_mosaic.cuh: row_rank); a warp's 4
// ranks a lane meet by shuffles, the warps' sums in shared memory. p3's
// blocks (b, y) also copy range y of the unvisited rows into `table`
// (copy_range, row_copy).
template <int kMode>
__global__ void __launch_bounds__(lzm::kRowThreads)
    row_sum_kernel(const int32_t* __restrict__ x, int W, int L,
                   int32_t* __restrict__ state, int32_t* __restrict__ table,
                   int iters) {
  using namespace lzm;
  __shared__ uint32_t part[kRowWarps][kRowLanes];
  const int t = threadIdx.x, f = t % kRowLanes;
  const int lane0 = blockIdx.x * kRowLanes, lane = lane0 + f;
  const int nl = L - lane0 < kRowLanes ? L - lane0 : kRowLanes;
  if (kMode == ROW_CLAMP_WRITE) {
    int r0, r1;
    copy_range(W, iters, blockIdx.y, gridDim.y, r0, r1);
    row_copy(x, table, L, lane0, nl, r0, r1, t);
  }
  if (blockIdx.y != 0) return;  // the whole block: a copy block
  uint32_t acc = 0;
  if (f < nl)
    acc = row_rank<kMode>(x, table, W, L, lane, t / kRowLanes, iters);
#pragma unroll
  for (int d = kRowLanes; d < 32; d <<= 1)
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, d);
  if ((t & 31) < kRowLanes) part[t >> 5][f] = acc;
  __syncthreads();
  if (t < nl) {
    uint32_t sum = 0;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) sum += part[w][t];
    state[lane] = wrap(sum);
    state[size_t(L) + lane] = iters % W;
  }
}

// p4: a thread a lane, kBlock a block (probe_mosaic.cuh: refill_lane).
__global__ void __launch_bounds__(kBlock)
    refill_kernel(const int32_t* __restrict__ x, int L,
                  int32_t* __restrict__ state, int iters) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  lzm::refill_lane(x, L, lane, state, iters);
}

// p5: block b is lane b (probe_mosaic.cuh: the column in shared memory,
// a warp a segment, a barrier pair every kSegChunk steps); the final
// column goes into `table`, x is not written.
__global__ void __launch_bounds__(lzm::kSegThreads)
    segments_kernel(const int32_t* __restrict__ x, int W, int L,
                    int32_t* __restrict__ state,
                    int32_t* __restrict__ table, int iters) {
  using namespace lzm;
  extern __shared__ int32_t smem[];
  int32_t* const red = smem;
  int32_t* const col = smem + kSegSlots;
  const int t = threadIdx.x, lane = blockIdx.x, S = W / 4;
  // The thread's constants pass through an empty asm, so they stay in
  // registers: left to itself nvcc re-read the thread index and derived
  // them again every step (~28 ns a step on the H100).
  int s = seg_of(t), u = seg_rank(t), r = t & 31;
  asm volatile("" : "+r"(s), "+r"(u), "+r"(r));
  int32_t* const seg = col + s * S;
  seg_stage(x, W, L, lane, col, t);
  if (t < kSegSlots) red[t] = INT32_MIN;
  int mask = 0;
  uint32_t part = 0;
  int32_t kept = INT32_MIN;
  __syncthreads();
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    const int32_t m =
        __reduce_max_sync(0xFFFFFFFFu, seg_step(seg, S, u, s == mask));
    kept = seg_keep(kept, r, i, m);
    mask = seg_next(mask);
    if (seg_chunk_end(i, iters)) {  // the same i in every thread
      if (r < kSegChunk) seg_post(red, r, s, kept);
      kept = INT32_MIN;
      __syncthreads();
      if (t < 4 * (i % kSegChunk + 1)) seg_take(red, t, &part);
      __syncthreads();
    }
  }
  if (t < kSegSlots) red[t] = wrap(part);
  __syncthreads();
  if (t == 0) {
    state[lane] = seg_total(red);
    state[size_t(L) + lane] = mask;
  }
  seg_write(col, W, L, lane, table, t);
}

constexpr int kMaxDevices = 64;  // devices whose opt-in is remembered

// Whether a kernel has opted in on each device numbered below kMaxDevices.
struct OptedIn {
  std::atomic<bool> done[kMaxDevices];
};
OptedIn segments_opted, scalar_opted;

// `kernel` opted in to the most dynamic shared memory a block may have on
// the current device, once a device (at every call on a device numbered
// kMaxDevices or more). Two threads may both opt in the first time;
// setting the attribute twice is harmless.
template <class Kernel>
cudaError_t opt_in(Kernel* kernel, OptedIn& opted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  const bool known = dev < kMaxDevices;
  if (e == cudaSuccess && !(known && opted.done[dev].load())) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             lzm::kMaxShared);
    if (e == cudaSuccess && known) opted.done[dev].store(true);
  }
  return e;
}

// `kernel`'s attributes into out[0..3] (lzk::kernel_attributes), after
// its opt-in where it has one.
template <class Kernel>
int attributes(Kernel* kernel, OptedIn* opted, int* out) {
  const cudaError_t e = opted ? opt_in(kernel, *opted) : cudaSuccess;
  if (e != cudaSuccess) return static_cast<int>(e);
  return lzk::kernel_attributes(reinterpret_cast<const void*>(kernel), out);
}

int blocks(int n) { return (n + kBlock - 1) / kBlock; }

// row_chain's kernel for `mode` at W rows.
const void* row_kernel(int mode, int W) {
  if (mode == lzm::ROW_CLAMP)
    return (const void*)row_sum_kernel<lzm::ROW_CLAMP>;
  if (mode == lzm::ROW_CLAMP_WRITE)
    return (const void*)row_sum_kernel<lzm::ROW_CLAMP_WRITE>;
  return lzm::pow2(W) ? (const void*)byte_chain_kernel<true>
                      : (const void*)byte_chain_kernel<false>;
}

template <int kAxis, class T, int kGroup>
void launch_group(const T* x, int x_cols, const int32_t* start, int stride,
                  int mod, T* out, int n_out, int out_cols, int iters,
                  cudaStream_t s) {
  const int32_t S = lzm::gather_stride(stride, kGroup);
  const uint32_t step = uint32_t(lzm::floor_mod(S, mod));
  gather_sum_kernel<kAxis, T, kGroup>
      <<<lzm::gather_blocks(kGroup, n_out), lzm::gather_block(kGroup, n_out),
         0, s>>>(x, x_cols, start, stride, S, step, mod, out, n_out, out_cols,
                 iters);
}

template <int kAxis, class T>
void launch_gather(const void* x, int x_cols, const int32_t* start,
                   int stride, int mod, void* out, int n_out, int out_cols,
                   int iters, cudaStream_t s) {
  const T* xs = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (lzm::gather_group(kAxis, n_out) == lzm::kGatherWarp)
    launch_group<kAxis, T, lzm::kGatherWarp>(xs, x_cols, start, stride, mod,
                                             o, n_out, out_cols, iters, s);
  else
    launch_group<kAxis, T, 1>(xs, x_cols, start, stride, mod, o, n_out,
                              out_cols, iters, s);
}

template <class T>
void launch_gather(int axis, const void* x, int x_cols, const int32_t* start,
                   int stride, int mod, void* out, int n_out, int out_cols,
                   int iters, cudaStream_t s) {
  if (axis == lzm::AXIS_MINOR)
    launch_gather<lzm::AXIS_MINOR, T>(x, x_cols, start, stride, mod, out,
                                      n_out, out_cols, iters, s);
  else
    launch_gather<lzm::AXIS_MAJOR, T>(x, x_cols, start, stride, mod, out,
                                      n_out, out_cols, iters, s);
}

}  // namespace

extern "C" {

// x: [x_rows, x_cols] (int32 or uint8), not changed; start: [n_out] int32;
// out: [n_out / out_cols, out_cols] of x's type.
int lzm_gather_sum(int axis, int elem, const void* x, int x_rows, int x_cols,
                   const int32_t* start, int stride, int mod, void* out,
                   int n_out, int out_cols, int iters, void* stream) {
  if (lzm::bad_gather(axis, elem, x_rows, x_cols, mod, n_out, out_cols,
                      iters))
    return lzm::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out > 0) {
    if (elem == lzm::ELEM_U8)
      launch_gather<uint8_t>(axis, x, x_cols, start, stride, mod, out, n_out,
                             out_cols, iters, s);
    else
      launch_gather<int32_t>(axis, x, x_cols, start, stride, mod, out, n_out,
                             out_cols, iters, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// gather_sum's launch for `n_out` outputs along `axis`: out[0] the threads
// an output, out[1] the threads a block, out[2] the blocks.
int lzm_gather_launch(int axis, int n_out, int* out) {
  if ((axis != lzm::AXIS_MINOR && axis != lzm::AXIS_MAJOR) || n_out < 0)
    return lzm::ERR_ARGS;
  out[0] = lzm::gather_group(axis, n_out);
  out[1] = lzm::gather_block(out[0], n_out);
  out[2] = lzm::gather_blocks(out[0], n_out);
  return 0;
}

// x: [rows, cols] int32, updated in place. RW_ROWS: start [rows], a warp a
// row; RW_SCALAR: rows == 1 and cols <= kScalarMaxCols, one block, out [1]
// the carry.
int lzm_rw_chain(int mode, int32_t* x, int rows, int cols,
                 const int32_t* start, int32_t* out, int iters,
                 void* stream) {
  if (lzm::bad_rw(mode, rows, cols, iters)) return lzm::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int launch[3];
  lzm::rw_launch(mode, rows, launch);
  if (mode == lzm::RW_SCALAR) {
    const cudaError_t e = opt_in(rw_scalar_kernel, scalar_opted);
    if (e != cudaSuccess) return static_cast<int>(e);
    rw_scalar_kernel<<<launch[2], launch[1], size_t(cols) * sizeof(int32_t),
                       s>>>(x, cols, out, iters);
  } else if (rows > 0) {
    const uint32_t step = uint32_t(lzm::floor_mod(lzm::kGatherWarp, cols));
    rw_rows_kernel<<<launch[2], launch[1], 0, s>>>(x, rows, cols, start,
                                                   step, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// rw_chain's launch for `rows` rows: out[0] the threads a row (1 for E's
// chain), out[1] the threads a block, out[2] the blocks.
int lzm_rw_launch(int mode, int rows, int* out) {
  if ((mode != lzm::RW_ROWS && mode != lzm::RW_SCALAR) || rows < 0)
    return lzm::ERR_ARGS;
  lzm::rw_launch(mode, rows, out);
  return 0;
}

// The most words of E's row.
int lzm_rw_max_cols() { return lzm::kScalarMaxCols; }

// rw_chain's kernels (mode RW_ROWS or RW_SCALAR): see attributes.
int lzm_rw_attributes(int mode, int* out) {
  if (mode == lzm::RW_SCALAR)
    return attributes(rw_scalar_kernel, &scalar_opted, out);
  if (mode == lzm::RW_ROWS) return attributes(rw_rows_kernel, nullptr, out);
  return lzm::ERR_ARGS;
}

// x: [W, L] int32, not changed; table: [W, L] int32, ROW_CLAMP_WRITE's
// final table (written), else null; state: [2, L] (acc, idx), written
// (the chains start from zeros). ROW_BYTE: W <= kByteMaxW.
int lzm_row_chain(int mode, const int32_t* x, int W, int L, int32_t* state,
                  int32_t* table, int iters, void* stream) {
  if (lzm::bad_row(mode, W, L, iters) ||
      (mode == lzm::ROW_CLAMP_WRITE) != (table != nullptr))
    return lzm::ERR_ARGS;
  if (L == 0) return static_cast<int>(cudaGetLastError());
  int launch[3];
  lzm::row_launch(mode, W, launch);
  int lb = launch[0];
  const dim3 grid(unsigned((L - 1) / lb + 1),
                  unsigned(lzm::copy_blocks(mode, W, iters)));
  void* byte_args[] = {&x, &W, &L, &lb, &state, &iters};
  void* rows_args[] = {&x, &W, &L, &state, &table, &iters};
  const void* fn = row_kernel(mode, W);
  cudaError_t e = cudaSuccess;
  if (mode == lzm::ROW_BYTE)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             launch[2]);
  if (e == cudaSuccess)
    e = cudaLaunchKernel(fn, grid, dim3(launch[1]),
                         mode == lzm::ROW_BYTE ? byte_args : rows_args,
                         size_t(launch[2]),
                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// row_chain's launch for `mode` at W rows: out[0] lanes a block, out[1]
// threads a block, out[2] dynamic shared memory a block.
int lzm_row_launch(int mode, int W, int* out) {
  if (lzm::bad_row(mode, W, 1, 0)) return lzm::ERR_ARGS;
  lzm::row_launch(mode, W, out);
  return 0;
}

// The most rows of a p6 table.
int lzm_row_max_w() { return lzm::kByteMaxW; }

// row_chain's blocks a lane group (the grid's y): p3's copy blocks.
int lzm_row_copy_blocks(int mode, int W, int iters) {
  if (lzm::bad_row(mode, W, 1, iters)) return lzm::ERR_ARGS;
  return lzm::copy_blocks(mode, W, iters);
}

// row_chain's kernel for `mode` at W rows: out[0..3] as attributes()
// gives them (after p6's opt-in to its slice), out[4..6] as
// lzm_row_launch's out[0..2].
int lzm_row_attributes(int mode, int W, int* out) {
  if (lzm::bad_row(mode, W, 1, 0)) return lzm::ERR_ARGS;
  lzm::row_launch(mode, W, out + 4);
  const void* fn = row_kernel(mode, W);
  if (mode == lzm::ROW_BYTE) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, out[6]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return lzk::kernel_attributes(fn, out);
}

// x: [W, L] int32, not changed; state: [2, L], written (both chains start
// from zeros); table: [W, L] int32, SEG_SEGMENTS's final table (written),
// else null. SEG_SEGMENTS: W <= kSegMaxRows, one block of kSegThreads a
// lane; SEG_REFILL: a thread a lane.
int lzm_segment_chain(int mode, const int32_t* x, int W, int L,
                      int32_t* state, int32_t* table, int iters,
                      void* stream) {
  if (lzm::bad_segment(mode, W, L, iters) ||
      (mode == lzm::SEG_SEGMENTS) != (table != nullptr))
    return lzm::ERR_ARGS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 0) return static_cast<int>(cudaGetLastError());
  if (mode == lzm::SEG_REFILL) {
    refill_kernel<<<blocks(L), kBlock, 0, s>>>(x, L, state, iters);
  } else {
    const cudaError_t e = opt_in(segments_kernel, segments_opted);
    if (e != cudaSuccess) return static_cast<int>(e);
    segments_kernel<<<L, lzm::kSegThreads, lzm::seg_block_bytes(W), s>>>(
        x, W, L, state, table, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most rows of a p5 column.
int lzm_segment_max_rows() { return lzm::kSegMaxRows; }

// segment_chain's kernel for `mode` at W rows: out[0..3] as attributes()
// gives them (after p5's opt-in), out[4] lanes a block (p4 a thread a
// lane; p5 a block a lane), out[5] threads a block, out[6] dynamic shared
// memory a block (p5's slots and column; p4 none).
int lzm_segment_attributes(int mode, int W, int* out) {
  if (lzm::bad_segment(mode, W, 1, 0)) return lzm::ERR_ARGS;
  const bool refill = mode == lzm::SEG_REFILL;
  out[4] = refill ? kBlock : 1;
  out[5] = refill ? kBlock : lzm::kSegThreads;
  out[6] = refill ? 0 : int(lzm::seg_block_bytes(W));
  return refill ? attributes(refill_kernel, nullptr, out)
                : attributes(segments_kernel, &segments_opted, out);
}

const char* lzm_error_string(int code) {
  return code == lzm::ERR_ARGS
             ? "bad argument"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
