// Fused separable-3x3-conv stack for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels K1/K2 of the JAX package:
//   neural_rx_tpu/kernels/sepconv_pallas.py
//     fused_conv_stack -> _fused_conv_stack_whole (body _stack_kernel)
//     fused_conv_stack_blocked                    (body _stack_kernel_blocked)
// Both compute the same function; the whole-vs-blocked choice there is a TPU
// VMEM budget, and this one kernel replaces both.
//
// Per layer l of the stack (x: [N, H, W, C] channels-last):
//   1. depthwise 3x3 SAME cross-correlation, f32 accumulator (taps in the
//      reference's order, multiply then add), rounded to the working type;
//   2. pointwise matmul over channels with f32 accumulation, plus bias (f32);
//   3. ReLU on hidden layers, the output layer is linear; round to the
//      working type.
// Columns outside [max(lo,0), min(hi,W)) are zero before every layer and
// after the last (pad-to-bucket semantics of the reference's sc_valid).
// Weights arrive in the working type, as the reference casts them.
//
// Design. A TPU program kept a whole slot (or a 256-column block) in VMEM;
// here a block owns one tile of W_t subcarrier columns of one image and all
// H symbols. It loads columns [w0 - L, w0 + W_t + L) once (L = number of
// layers), runs every layer in shared memory with the live halo shrinking
// by one column per layer, and writes only its W_t core columns, so the
// intermediate activations never touch device memory. Two shared buffers:
// the depthwise step reads A and writes B, the pointwise step reads B and
// writes A. The widest layer (128 channels at nrx_rt) sets W_t through the
// 227 KB shared-memory limit: W_t = 26 in bf16 at 3 layers, 10 in f32.
// The tile code lives in nrx_tile.cuh, shared with cgnn_iter.cu.
//
// What bounds it on this card: at the nrx_rt shapes the work is ~2.5-3.7
// GFLOP against ~7-15 MB of device traffic, so the tensor-core bound is a
// few microseconds for both. This first kernel runs the pointwise products
// on the CUDA cores in f32 (one block per SM, 16 warps, 4x4 register tiles)
// and is bound by its shared-memory loads and the f32 FMA rate instead;
// the halo re-computation costs (W_t + 2L) / W_t extra work on the first
// layer. Tensor cores (wgmma) and TMA loads are later work.

#include "nrx_tile.cuh"

namespace {

using nrx::StackDesc;

template <typename T>
__global__ void __launch_bounds__(nrx::kThreads)
    sepconv_stack_kernel(const T* __restrict__ x, const T* __restrict__ wts,
                         T* __restrict__ out, StackDesc d, int H, int W,
                         int w_tile, int lo, int hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nrx::stack_tile<T>(x, wts, out, d, H, W, w_tile, lo, hi, blockIdx.y,
                     blockIdx.x, smem_raw);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, const StackDesc& d,
                   int n, int h, int wc, int lo, int hi, cudaStream_t stream) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int w_tile = nrx::stack_w_tile(d, h, wc, sizeof(T), optin);
  if (w_tile < 1) return cudaErrorInvalidValue;
  const int n_tiles = (wc + w_tile - 1) / w_tile;
  const size_t smem = nrx::stack_smem(d, h, w_tile, sizeof(T));
  err = cudaFuncSetAttribute(sepconv_stack_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, n);
  sepconv_stack_kernel<T><<<grid, nrx::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d,
      h, wc, w_tile, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [n, h, wc, widths[0]], out: [n, h, wc, widths[n_layers]], both
// contiguous in the working type (dtype 0: float32, 1: bfloat16). w: the
// packed stack, per layer dw [9][c_in], pw [c_in][c_out], b [c_out] in the
// same type. widths: host array of n_layers + 1 ints. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
int nrx_sepconv_stack(const void* x, const void* w, void* out, int dtype, int n,
                      int h, int wc, int n_layers, const void* widths, int lo,
                      int hi, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wc < 1) return (int)cudaErrorInvalidValue;
  StackDesc d;
  if (!nrx::make_stack_desc(n_layers, static_cast<const int*>(widths), &d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, out, d, n, h, wc, lo, hi, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, out, d, n, h, wc, lo, hi, s);
  return (int)cudaErrorInvalidValue;
}

const char* nrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
