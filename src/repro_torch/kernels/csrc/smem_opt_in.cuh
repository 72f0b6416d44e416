// The dynamic shared-memory opt-in above 48 KB, shared by every kernel source
// that asks for more (each source includes it by name: the build passes this
// directory to nvcc as -I).
//
// cudaFuncSetAttribute's MaxDynamicSharedMemorySize holds for the current
// device only, so it is kept per device: a flag kept once per process would
// let the first card opt in and leave every other card of the process
// refusing the launch.  A launch that asks for more than 48 KB calls
// `opt_in_smem` with its kernel's own `OptIn` (one a kernel instantiation),
// on the card it launches on.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

constexpr int kOptInDevices = 16;

struct OptIn {  // one kernel instantiation's largest opt-in, per device
  std::mutex lock;
  int bytes[kOptInDevices] = {};
};

// 0, or the CUDA error of reading the current device or of the opt-in
template <typename Kernel>
int opt_in_smem(Kernel* kernel, int smem, OptIn& opted) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kOptInDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(opted.lock);
  if (opted.bytes[dev] >= smem) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) opted.bytes[dev] = smem;
  return (int)err;
}
