// The segment-decoder kernel as a template over the team that runs a lane
// (lzma_lane.cuh's Solo: a thread a lane; Warp: a warp a lane), the
// decoder's build options, and where a lane's probability table and window
// live (global or shared memory). A lane with anything in shared memory is
// a block of its own. decode_segments.cu instantiates the
// decoder (a warp a lane, both in shared memory); decode_variants.cu the
// placements that chip_smoke.py times against it.
//
// Buffers (lane-major): inbuf [L, w_in] u8; win_init and win [L, w] u8;
// probs [L, nprobs] u16 scratch (global tables only); chunk tables [L, k]
// i32; err, outp, steps [L] i32. With the window in shared memory the
// kernel reads win_init and writes win; in global memory it decodes win in
// place (the caller copies win_init there first). Dynamic shared memory:
// the table (probs_bytes(nlit), when shared), then the window (w, when
// shared).
#ifndef LZMA_RS_TPU_TORCH_SEGMENT_KERNEL_CUH_
#define LZMA_RS_TPU_TORCH_SEGMENT_KERNEL_CUH_

#include <cuda_runtime.h>
#include <stdint.h>

#include "lzma_lane.cuh"

namespace lzl {

struct SegmentArgs {
  const uint8_t* inbuf;
  const uint8_t* win_init;
  uint8_t* win;
  uint16_t* probs;
  const int32_t *in_start, *in_end, *out_start, *out_end, *chunk_meta;
  int32_t *err, *outp, *steps;
  int L, w_in, w, nprobs, nlit, k, max_steps;
};

// Threads a block: one lane's team, or 128 lanes of a thread when a lane
// keeps nothing in shared memory.
template <class Team, bool kShared>
struct Block {
  static constexpr int kThreads =
      Team::kSize == 1 && !kShared ? 128 : Team::kSize;
};

// Dynamic shared memory a launch needs.
template <bool kProbsShared, bool kWinShared>
inline int shared_bytes(int nlit, int w) {
  return (kProbsShared ? probs_bytes(nlit) : 0) + (kWinShared ? w : 0);
}

// n bytes from src to dst, split over a team's ranks: 16 B a rank when
// both are 16-byte aligned and n is a multiple of 16, else a byte a rank.
__device__ inline void team_copy(uint8_t* dst, const uint8_t* src, int n,
                                 int r, int t) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
        uintptr_t(n)) & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int i = r; i < n / 16; i += t) d[i] = s[i];
  } else {
    for (int i = r; i < n; i += t) dst[i] = src[i];
  }
}

template <class Team, int kOpts, bool kProbsShared, bool kWinShared>
__global__ void __launch_bounds__(
    Block<Team, kProbsShared || kWinShared>::kThreads)
    segments_kernel(SegmentArgs a) {
  extern __shared__ uint4 smem[];
  const int lane = Team::kSize == 1
                       ? int(blockIdx.x * blockDim.x + threadIdx.x)
                       : int(blockIdx.x);
  if (lane >= a.L) return;  // uniform over a block that holds one lane
  const int rank = int(threadIdx.x) & (Team::kSize - 1);
  uint8_t* const out = a.win + size_t(lane) * size_t(a.w);
  uint16_t* const P =
      kProbsShared ? reinterpret_cast<uint16_t*>(smem)
                   : a.probs + size_t(lane) * size_t(a.nprobs);
  uint8_t* const W =
      kWinShared ? reinterpret_cast<uint8_t*>(smem) +
                       (kProbsShared ? probs_bytes(a.nlit) : 0)
                 : out;
  if (kWinShared) {
    team_copy(W, a.win_init + size_t(lane) * size_t(a.w), a.w, rank,
              Team::kSize);
    Team{}.sync();
  }
  const size_t t = size_t(lane) * size_t(a.k);
  const LaneResult r = decode_lane<Team, kOpts>(
      Team{}, a.inbuf + size_t(lane) * size_t(a.w_in), a.w_in, W, a.w, P,
      a.nlit, a.in_start + t, a.in_end + t, a.out_start + t, a.out_end + t,
      a.chunk_meta + t, a.k, a.max_steps);
  if (kWinShared) {
    Team{}.sync();
    team_copy(out, W, a.w, rank, Team::kSize);
  }
  if (rank == 0) {
    a.err[lane] = r.err;
    a.outp[lane] = r.outp;
    a.steps[lane] = r.steps;
  }
}

// The kernel's attributes for smem bytes of dynamic shared memory: the
// opt-in above 48 KB and the largest shared-memory carveout, so that as
// many lanes as fit are resident on an SM. Returns a cudaError_t.
template <class Team, int kOpts, bool kProbsShared, bool kWinShared>
int prepare_segments(int smem) {
  auto kern = segments_kernel<Team, kOpts, kProbsShared, kWinShared>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (e == cudaSuccess && smem > 0) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  }
  return int(e);
}

// Launch on stream; smem must be what shared_bytes gives (else
// cudaErrorInvalidValue: the wrapper and the kernel disagree on the
// layout). Returns cudaGetLastError() (0 = launched).
template <class Team, int kOpts, bool kProbsShared, bool kWinShared>
int launch_segments(const SegmentArgs& a, int smem, cudaStream_t stream) {
  if (smem != shared_bytes<kProbsShared, kWinShared>(a.nlit, a.w)) {
    return int(cudaErrorInvalidValue);
  }
  if (a.L <= 0) return int(cudaGetLastError());
  const int e = prepare_segments<Team, kOpts, kProbsShared, kWinShared>(smem);
  if (e != int(cudaSuccess)) return e;
  constexpr int threads =
      Block<Team, kProbsShared || kWinShared>::kThreads;
  const int lanes_a_block = threads / Team::kSize;
  segments_kernel<Team, kOpts, kProbsShared, kWinShared>
      <<<(a.L + lanes_a_block - 1) / lanes_a_block, threads, smem, stream>>>(
          a);
  return int(cudaGetLastError());
}

// Blocks of the kernel resident on one SM at smem bytes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the attributes).
template <class Team, int kOpts, bool kProbsShared, bool kWinShared>
int occupancy_segments(int smem, int* blocks) {
  const int e = prepare_segments<Team, kOpts, kProbsShared, kWinShared>(smem);
  if (e != int(cudaSuccess)) return e;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, segments_kernel<Team, kOpts, kProbsShared, kWinShared>,
      Block<Team, kProbsShared || kWinShared>::kThreads, size_t(smem)));
}

}  // namespace lzl

#endif  // LZMA_RS_TPU_TORCH_SEGMENT_KERNEL_CUH_
