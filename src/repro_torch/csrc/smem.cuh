// Opting a kernel in to more than 48 KB of dynamic shared memory.
//
// The limit is an attribute of the kernel function, one for the whole
// process.  Launchers called from several host threads at once (a sharded
// restore decodes its shards on a thread pool) must not lower it: a thread
// that set a smaller limit after another thread set a larger one would make
// the other's launch fail with cudaErrorInvalidValue.  So the limit is only
// ever raised, under a lock, and a launch that fits the limit already set
// touches nothing.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>

namespace repro_torch {

template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::unordered_map<const void*, long long> limit;
  std::lock_guard<std::mutex> hold(mu);
  long long& set = limit[reinterpret_cast<const void*>(kernel)];
  if (smem <= set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess) set = smem;
  return e;
}

}  // namespace repro_torch
