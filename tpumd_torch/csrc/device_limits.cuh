// The current device and the largest shared memory a block may take on
// it, shared by the sources whose kernels size their shared memory to the
// card (eam_cellgrid.cu, cellgrid_pairlist.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// queried once per device (each source keeps its own cache)
cudaError_t device_optin(int* dev, int* optin) {
  static int cached = 0, on_dev = -1;
  cudaError_t err;
  if ((err = cudaGetDevice(dev)) != cudaSuccess) return err;
  if (*dev != on_dev) {
    if ((err = cudaDeviceGetAttribute(
             &cached, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev)) !=
        cudaSuccess) {
      return err;
    }
    on_dev = *dev;
  }
  *optin = cached;
  return cudaSuccess;
}

}  // namespace
