// A kernel's attributes as the probe libraries report them (probes.cu,
// probes_mosaic.cu, probes_round4.cu): card builds only.
#ifndef LZMA_RS_TPU_TORCH_KERNEL_ATTRIBUTES_CUH_
#define LZMA_RS_TPU_TORCH_KERNEL_ATTRIBUTES_CUH_

#include <cuda_runtime.h>

namespace lzk {

// out[0..3]: the registers a thread, local memory a thread (spills),
// static shared memory and the dynamic shared memory the kernel may have
// (cudaFuncGetAttributes: after its opt-in, where it has one). Returns 0
// or a CUDA error.
inline int kernel_attributes(const void* kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxDynamicSharedSizeBytes;
  return 0;
}

}  // namespace lzk

#endif  // LZMA_RS_TPU_TORCH_KERNEL_ATTRIBUTES_CUH_
