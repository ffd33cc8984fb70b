// A block's lanes' table into shared memory, and the chains' reads of it:
// the staging that the mosaic probe kernels share (row_chain's P6 in
// probes_mosaic.cu; onehot_chain and window_chain in probes_mosaic3.cu).
//
// A table is lane-minor, [rows, L] int32 (row r of lane l at word r L + l,
// the TPU probes' layout). A block holds a slice of lb lanes' columns,
// lane-minor too ([rows, lb]): a chain thread's word of a row lies in a
// bank of its own among the block's lb. Compiled for the card by nvcc and
// for the host by g++ (the tests' builds), where a copy is a plain copy
// and a shared load a plain load, in the order the card's barriers allow.
#ifndef LZMA_RS_TPU_TORCH_PROBE_STAGE_CUH_
#define LZMA_RS_TPU_TORCH_PROBE_STAGE_CUH_

#include <stddef.h>
#include <stdint.h>

#if !defined(__CUDA_ARCH__)
#include <string.h>
#endif

#if defined(__CUDACC__)
#define LZM_FN __host__ __device__ inline
#define LZM_UNROLL(n) _Pragma(#n)
#else
#define LZM_FN inline
#define LZM_UNROLL(n)
#endif

namespace lzs {

constexpr int kSliceBytes = 65536;  // lanes_per_block: a slice's bytes
constexpr int kCopy = 16;           // bytes a staging copy in whole chunks

// The lanes a block of a table of `rows` rows holds: `most`, halved while
// their slice exceeds kSliceBytes, at least one.
LZM_FN int lanes_per_block(int rows, int most) {
  int lb = most;
  while (lb > 1 && size_t(lb) * size_t(rows) * 4 > size_t(kSliceBytes))
    lb >>= 1;
  return lb;
}

// The block's shared memory as the chains reach it: byte offsets from its
// base. On the card the base is a shared-space address held in a register
// and the loads are ld.shared (as C loads through the extern array,
// ptxas rebuilt the array's address in every step of mosaic4's chain);
// volatile and after the staging's barrier. On the host, a pointer.
struct Shared {
  uintptr_t base;  // the card: a shared-space address; the host: a pointer
#if defined(__CUDA_ARCH__)
  LZM_FN int32_t ld(uint32_t off) const {
    int32_t v;
    asm volatile("ld.shared.b32 %0, [%1];"
                 : "=r"(v)
                 : "r"(uint32_t(base) + off)
                 : "memory");
    return v;
  }
#else
  LZM_FN int32_t ld(uint32_t off) const {
    return *reinterpret_cast<const int32_t*>(base + off);
  }
#endif
};

#if defined(__CUDACC__)
// The block's shared memory as the chains read it: its shared-space
// address, held in a register.
__device__ __forceinline__ Shared shared_of(const int32_t* sm) {
  uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  asm("" : "+r"(at));
  return Shared{at};
}
#endif

// A block's lanes: nl of lb columns from lane0, of a table of L lanes.
struct Slice {
  int rows, lb, L, lane0, nl;
};

LZM_FN Slice block_slice(int rows, int lb, int L, int b) {
  const int lane0 = b * lb;
  return {rows, lb, L, lane0, L - lane0 < lb ? L - lane0 : lb};
}

// One word (4 bytes) or chunk (16) from the table into shared memory:
// cp.async on the card (the rank waits for its own in copies_landed()), a
// copy on the host.
LZM_FN void copy_word(int32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

LZM_FN void copy_chunk(int32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  memcpy(dst, src, kCopy);
#endif
}

LZM_FN void copies_landed() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

LZM_FN int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// Whether the block's rows move in 16-byte chunks: a full block of whole
// chunks (lb a multiple of 4) at 16-byte aligned addresses.
LZM_FN bool chunked(const int32_t* from, const Slice& s) {
  return s.nl == s.lb && s.lb % 4 == 0 && s.L % 4 == 0 &&
         reinterpret_cast<uintptr_t>(from) % kCopy == 0;
}

// Rank `tid` of `nt` copies its share of the block's slice (rows [0,
// s.rows) of its lanes) into sm, lane-minor ([rows, lb]: row r of lane f
// at word r lb + f, so the chain threads' one word each lies in lb
// distinct banks): in 16-byte chunks, neighbouring ranks on neighbouring
// chunks of a row, where chunked(); else word by word. Lanes past nl are
// not copied (nothing reads them). The block then meets at a barrier.
LZM_FN void stage_minor(int32_t* sm, const int32_t* x, const Slice& s,
                        int tid, int nt) {
  const int32_t* const from = x + s.lane0;
  if (chunked(from, s)) {
    const int per_row = s.lb / 4, sh = log2_of(per_row);
    for (int i = tid; i < s.rows * per_row; i += nt) {
      const int r = i >> sh, c = i & (per_row - 1);
      copy_chunk(sm + r * s.lb + c * 4, from + size_t(r) * s.L + c * 4);
    }
  } else {
    const int sh = log2_of(s.lb);
    for (int i = tid; i < s.rows * s.lb; i += nt) {
      const int r = i >> sh, f = i & (s.lb - 1);
      if (f < s.nl) copy_word(sm + i, from + size_t(r) * s.L + f);
    }
  }
  copies_landed();
}

}  // namespace lzs

#endif  // LZMA_RS_TPU_TORCH_PROBE_STAGE_CUH_
