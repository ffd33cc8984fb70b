// The device CRC for Hopper (sm_90a): the raw CRC32 / CRC64-XZ register
// (init 0, no final XOR) of a block's L full 4 KiB chunks, folded to one
// register on the card.
//
// Replaces the JAX package's device CRC
// lzma_rs_tpu/ops/crc_device.py::_jitted_crc_matmul (:226, under
// crc32_device :362 and crc64_device :375): XLA code outside Pallas that
// bit-unpacks the chunks, runs one bf16 matrix product against a
// [32768, width] GF(2) weight matrix and returns an [L, width] parity
// matrix, which the host packs and folds chunk by chunk
// (_tree_combine_host, in power-of-two batches). Here nothing of that is
// kept: no bit-unpacked copy, no product, no parity matrix, and no fold on
// the host. The arithmetic is crc_kernel.cuh's, shared with a host test
// build.
//
// Design. A warp a chunk, a lane 128 contiguous bytes of it: eight 16-byte
// read-only loads a lane, all issued before the first table lookup (a warp
// instruction reads 16 bytes of each of 32 lines, the eight together the
// chunk's 4 KiB once; the L1 keeps the lines between them), so every byte
// is read once and goes straight to registers: no staging in shared memory
// is needed. The lane runs slice-by-8 over its 16 words with the eight
// tables in shared memory (8 KiB for CRC32, 16 KiB for CRC64), advances its
// register past the chunk's later lanes with the nibble tables of
// Z_{2^7} .. Z_{2^11} (shared memory, 2.5 / 10 KiB; a block stages both
// tables with 16-byte loads all in flight at once), and the warp XORs its
// lanes with five shuffles. The chunk's register is advanced past the
// block's later chunks through the nibble tables of Z_{2^12} and up (global
// memory: the warp reads one address at a time), and lane 0 XORs it into
// the output (zeroed by a memset on the stream before the launch) with one
// 64-bit atomicXor. XOR is commutative, so the order
// in which warps arrive changes nothing: the result is exact and
// deterministic, with no second launch, no ticket and no power-of-two
// split of L. Blocks of four warps walk the chunks in a grid-stride loop.
//
// What bounds it on this card: bytes, L x 4096 read once over 3.35 TB/s
// (a 1 MiB block 0.31 us). A slice-by-8 step costs some 30 integer
// instructions for 8 bytes and each advance 2 x W / 4, so the issue rate
// comes next; a launch of one 1 MiB block (256 warps on 64 blocks) is
// short enough that its launch latency is of the same order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "crc_kernel.cuh"

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = kWarps * lzc::kLanes;
constexpr int kMaxBlocks = 1 << 16;

// The tables into shared memory: every 16-byte load of the block's share
// issued before the first store, so the copy waits on one L2 round trip.
template <int A, int B>
__device__ __forceinline__ void stage(uint4* a, const uint4* __restrict__ src_a,
                                      uint4* b,
                                      const uint4* __restrict__ src_b) {
  constexpr int kPer = (A + B + kThreads - 1) / kThreads;
  uint4 v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = int(threadIdx.x) + j * kThreads;
    if (i < A) {
      v[j] = __ldg(src_a + i);
    } else if (i < A + B) {
      v[j] = __ldg(src_b + (i - A));
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = int(threadIdx.x) + j * kThreads;
    if (i < A) {
      a[i] = v[j];
    } else if (i < A + B) {
      b[i - A] = v[j];
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    crc_kernel(const uint4* __restrict__ data, int L,
               const typename lzc::Width<W>::Reg* __restrict__ slice,
               const typename lzc::Width<W>::Reg* __restrict__ maps,
               unsigned long long* out) {
  using Reg = typename lzc::Width<W>::Reg;
  constexpr int kNib = lzc::Width<W>::kNib;
  constexpr int kSlice = 8 * 256 * int(sizeof(Reg)) / 16;  // in uint4s
  constexpr int kLane = lzc::kLaneMaps * kNib * int(sizeof(Reg)) / 16;
  __shared__ __align__(16) Reg t[8 * 256];
  __shared__ __align__(16) Reg lane_maps[lzc::kLaneMaps * kNib];
  stage<kSlice, kLane>(reinterpret_cast<uint4*>(t),
                       reinterpret_cast<const uint4*>(slice),
                       reinterpret_cast<uint4*>(lane_maps),
                       reinterpret_cast<const uint4*>(
                           maps + lzc::kStretchLog * kNib));
  __syncthreads();
  const int lane = int(threadIdx.x) % lzc::kLanes;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long c = (long long)blockIdx.x * kWarps + threadIdx.x / 32; c < L;
       c += step) {
    const uint4* p = data + c * (lzc::kChunk / 16) + lane * (lzc::kStretch / 16);
    uint4 v[lzc::kStretch / 16];
#pragma unroll
    for (int j = 0; j < lzc::kStretch / 16; ++j) v[j] = __ldg(p + j);
    uint64_t words[lzc::kStretchWords];
#pragma unroll
    for (int j = 0; j < lzc::kStretch / 16; ++j) {
      words[2 * j] = uint64_t(v[j].x) | (uint64_t(v[j].y) << 32);
      words[2 * j + 1] = uint64_t(v[j].z) | (uint64_t(v[j].w) << 32);
    }
    Reg r = lzc::lane_to_chunk_end<W>(lane_maps,
                                      lzc::stretch_register(t, words), lane);
#pragma unroll
    for (int off = lzc::kLanes / 2; off > 0; off /= 2) {
      r ^= __shfl_xor_sync(0xffffffffu, r, off);
    }
    r = lzc::chunk_to_end<W>(maps, r, c, L);
    if (lane == 0) atomicXor(out, (unsigned long long)r);
  }
}

}  // namespace

extern "C" {

// The raw register of the L chunks at data (16-byte aligned, L x 4096
// bytes) into *out (8 bytes, zeroed here first) on `stream`.
// slice: 8 x 256 registers; maps: nmaps (= kMaps) nibble tables of
// width / 4 x 16 registers; a register is 4 bytes for width 32, 8 for 64.
// Returns cudaGetLastError() (0 = launched).
int lzc_crc_blocks(int width, const void* data, int L, const void* slice,
                   const void* maps, int nmaps, void* out, void* stream) {
  if (nmaps != lzc::kMaps || L < 1 || (width != 32 && width != 64)) {
    return int(cudaErrorInvalidValue);
  }
  const long long want = ((long long)L + kWarps - 1) / kWarps;
  const int blocks = int(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* d = static_cast<const uint4*>(data);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  const cudaError_t e = cudaMemsetAsync(o, 0, sizeof(*o), s);
  if (e != cudaSuccess) return int(e);
  if (width == 32) {
    crc_kernel<32><<<blocks, kThreads, 0, s>>>(
        d, L, static_cast<const uint32_t*>(slice),
        static_cast<const uint32_t*>(maps), o);
  } else {
    crc_kernel<64><<<blocks, kThreads, 0, s>>>(
        d, L, static_cast<const unsigned long long*>(slice),
        static_cast<const unsigned long long*>(maps), o);
  }
  return int(cudaGetLastError());
}

const char* lzc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
