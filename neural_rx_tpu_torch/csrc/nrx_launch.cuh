// Host-side launch set-up shared by the port's kernels (sepconv_stack.cu,
// cgnn_iter.cu, ldpc_decode.cu), CUDA C++.
//
// Launch set-up is queried once and reused by every later launch: per
// device its opt-in shared-memory limit and SM count, per (kernel, device)
// the dynamic shared memory the kernel was allowed and its occupancy at the
// last shared-memory size asked for. A kernel template instance is one
// (kernel, dtype). One mutex guards the tables (ctypes calls run without
// Python's lock).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <type_traits>

#include "nrx_tile.cuh"

namespace nrx {

constexpr int kMaxDevices = 64;

// bf16 tiles run their products on the tensor cores, float32 tiles on the
// CUDA cores (TF32 would not keep float32's sums).
template <typename T>
constexpr bool kUseMma = std::is_same<T, __nv_bfloat16>::value;

// What the tensor-core tile takes of a stack: products of at most kMmaMaxK
// input channels (past kMmaRegK, in the kWide instances: stack_wide).
inline bool mma_fits(const StackDesc& d) {
  for (int l = 0; l < d.n_layers; ++l)
    if (d.widths[l] > kMmaMaxK) return false;
  return true;
}

// What the CUDA-core tile takes of a stack outside the folded mode: products
// of at most kRowsMaxN output channels (the weight slabs).
inline bool rows_fit(const StackDesc& d) {
  for (int l = 1; l <= d.n_layers; ++l)
    if (d.widths[l] > kRowsMaxN) return false;
  return true;
}

struct DeviceSetup {
  size_t optin;  // 0: not queried yet
  int n_sm;
};

struct KernelSetup {
  size_t allowed;   // dynamic shared memory granted so far
  size_t occ_smem;  // shared memory of the cached occupancy
  int per_sm;       // resident blocks per SM at occ_smem; 0: not queried
};

inline std::mutex& setup_mutex() {
  static std::mutex mu;
  return mu;
}

// The current device and its set-up; the caller holds setup_mutex().
inline cudaError_t device_setup(int* dev, DeviceSetup* out) {
  static DeviceSetup cache[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceSetup& d = cache[*dev];
  if (d.optin == 0) {
    int optin = 0, n_sm = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    d = DeviceSetup{(size_t)optin, n_sm};
  }
  *out = d;
  return cudaSuccess;
}

// Lets `kernel` take `bytes` of dynamic shared memory unless it already may.
template <typename K>
cudaError_t allow_smem(K* kernel, KernelSetup& k, size_t bytes) {
  if (bytes <= k.allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) k.allowed = bytes;
  return err;
}

}  // namespace nrx
