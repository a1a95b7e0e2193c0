// The dynamic shared memory a kernel may take, set once per kernel and
// device rather than before every launch.
//
// A kernel that takes more than 48 KB of dynamic shared memory needs
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize)
// first. The setting is not a stream operation: a CUDA graph does not
// record it, and the engines capture their programs only after an eager
// warm-up (horizonnet_tpu_torch/program.py). So each kernel sets it at its
// first launch on a device, and a capture or a replay finds it set.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace smem_attr {

// At least `bytes` of dynamic shared memory for `kernel` on the current
// device; calls cudaFuncSetAttribute only when `bytes` exceeds what an
// earlier call set.
inline cudaError_t ensure(const void* kernel, size_t bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> set;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = set[{dev, kernel}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}

}  // namespace smem_attr
