// Host-side helper of the kernels' launchers: dynamic shared memory above
// 48 KB has to be asked for before the launch.
#pragma once

#include <cuda_runtime.h>

namespace lexls {

// Opt the kernel in to `bytes` of dynamic shared memory (once per kernel
// and size) and let the SM carve out as much shared memory as it can, so
// that as many blocks as fit are resident.
template <typename K>
cudaError_t configure_shared(K kernel, size_t bytes, size_t& configured) {
  if (bytes <= configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

}  // namespace lexls
