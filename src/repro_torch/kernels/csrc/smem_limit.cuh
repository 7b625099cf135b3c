// Dynamic shared memory above 48 KB, asked for once.
//
// A kernel may use more than 48 KB of dynamic shared memory only after
// cudaFuncSetAttribute has raised its limit. The attribute belongs to the
// kernel on one device and stays set, so a launcher calls this helper with
// a mask of its own (one per kernel instantiation, a function-local
// static) and the attribute is set once per device instead of on every
// launch.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

// Raises `kernel`'s limit on the current device to the most a block may
// have there; a launch still takes only what it asks for. `ready` holds
// one bit per device already raised.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel,
                            std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}
