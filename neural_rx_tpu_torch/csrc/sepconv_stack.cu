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
//
// What bounds it on this card: at the nrx_rt shapes the work is ~2.5-3.7
// GFLOP against ~7-15 MB of device traffic, so the tensor-core bound is a
// few microseconds for both. This first kernel runs the pointwise products
// on the CUDA cores in f32 (one block per SM, 16 warps, 4x4 register tiles)
// and is bound by its shared-memory loads and the f32 FMA rate instead;
// the halo re-computation costs (W_t + 2L) / W_t extra work on the first
// layer. Tensor cores (wgmma) and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 512;
constexpr int kMaxTile = 64;

struct StackDesc {
  int n_layers;
  int widths[kMaxLayers + 1];
  int dw_off[kMaxLayers];  // [9][c_in], tap-major (ky * 3 + kx)
  int pw_off[kMaxLayers];  // [c_in][c_out]
  int b_off[kMaxLayers];   // [c_out]
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sepconv_stack_kernel(const T* __restrict__ x, const T* __restrict__ wts,
                         T* __restrict__ out, StackDesc d, int H, int W,
                         int w_tile, int lo, int hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = d.n_layers;
  const int E = w_tile + 2 * L;  // buffer columns
  int cmax = 0;
  for (int l = 0; l <= L; ++l) cmax = max(cmax, d.widths[l]);
  T* buf_a = reinterpret_cast<T*>(smem_raw);
  T* buf_b = buf_a + (size_t)H * E * cmax;

  const int n = blockIdx.y;
  const int w0 = blockIdx.x * w_tile;
  const int g0 = w0 - L;  // grid column of buffer column 0
  const int vlo = max(lo, 0);
  const int vhi = min(hi, W);

  // Load the tile plus its halo; columns outside the valid range are zero.
  {
    const int c0 = d.widths[0];
    const T* xn = x + (size_t)n * H * W * c0;
    for (int i = threadIdx.x; i < H * E * c0; i += blockDim.x) {
      const int c = i % c0;
      const int col = (i / c0) % E;
      const int h = i / (c0 * E);
      const int g = g0 + col;
      buf_a[i] = (g >= vlo && g < vhi) ? xn[((size_t)h * W + g) * c0 + c]
                                       : from_f<T>(0.f);
    }
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int cin = d.widths[l];
    const int cout = d.widths[l + 1];
    const int c_lo = l + 1;           // first buffer column this layer writes
    const int wl = E - 2 * (l + 1);   // columns this layer writes
    const int P = H * wl;             // positions this layer writes
    const T* dw = wts + d.dw_off[l];
    const T* pw = wts + d.pw_off[l];
    const T* bias = wts + d.b_off[l];

    // Depthwise: A [h][col][cin] -> B [p][cin], p = h * wl + col - c_lo.
    for (int i = threadIdx.x; i < P * cin; i += blockDim.x) {
      const int c = i % cin;
      const int p = i / cin;
      const int h = p / wl;
      const int col = c_lo + p % wl;
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int hh = h + dy - 1;
        if (hh < 0 || hh >= H) continue;  // SAME zero padding in time
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float xv = to_f(buf_a[((size_t)hh * E + col + dx - 1) * cin + c]);
          const float kv = to_f(dw[(dy * 3 + dx) * cin + c]);
          acc = __fadd_rn(acc, __fmul_rn(xv, kv));
        }
      }
      buf_b[i] = from_f<T>(acc);
    }
    __syncthreads();

    // Pointwise: B [P][cin] x pw [cin][cout] + bias -> A [h][col][cout],
    // each thread a 4-position x 4-channel register tile.
    const int G = (cout + 3) / 4;
    const int Q = (P + 3) / 4;
    const bool relu = l < L - 1;
    for (int item = threadIdx.x; item < G * Q; item += blockDim.x) {
      const int o0 = (item % G) * 4;
      const int p0 = (item / G) * 4;
      const T* a[4];
      int oc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = buf_b + (size_t)min(p0 + k, P - 1) * cin;
        oc[k] = min(o0 + k, cout - 1);
      }
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
      for (int c = 0; c < cin; ++c) {
        const T* row = pw + (size_t)c * cout;
        float av[4], bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) av[k] = to_f(a[k][c]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f(row[oc[j]]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[k][j] = fmaf(av[k], bv[j], acc[k][j]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + k;
        if (p >= P) break;
        const int h = p / wl;
        const int col = c_lo + p % wl;
        const int g = g0 + col;
        const bool valid = g >= vlo && g < vhi;
        T* dst = buf_a + ((size_t)h * E + col) * cout;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + j;
          if (o >= cout) break;
          float y = acc[k][j] + to_f(bias[o]);
          if (relu && y < 0.f) y = 0.f;  // NaN passes, as max(y, 0) does
          dst[o] = valid ? from_f<T>(y) : from_f<T>(0.f);
        }
      }
    }
    __syncthreads();
  }

  // Store the core columns [L, L + w_tile) of the last layer.
  const int cl = d.widths[L];
  T* on = out + (size_t)n * H * W * cl;
  for (int i = threadIdx.x; i < H * w_tile * cl; i += blockDim.x) {
    const int c = i % cl;
    const int cc = (i / cl) % w_tile;
    const int h = i / (cl * w_tile);
    const int g = w0 + cc;
    if (g < W) on[((size_t)h * W + g) * cl + c] = buf_a[((size_t)h * E + L + cc) * cl + c];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, const StackDesc& d,
                   int n, int h, int wc, int lo, int hi, cudaStream_t stream) {
  int cmax = 0;
  for (int l = 0; l <= d.n_layers; ++l) cmax = d.widths[l] > cmax ? d.widths[l] : cmax;
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t per_col = 2 * (size_t)h * cmax * sizeof(T);
  int w_tile = (int)(optin / per_col) - 2 * d.n_layers;
  if (w_tile > kMaxTile) w_tile = kMaxTile;
  if (w_tile > wc) w_tile = wc;
  if (w_tile < 1) return cudaErrorInvalidValue;
  // equal tiles: the same number of blocks with the least halo overhead
  const int n_tiles = (wc + w_tile - 1) / w_tile;
  w_tile = (wc + n_tiles - 1) / n_tiles;
  const size_t smem = per_col * (w_tile + 2 * d.n_layers);
  err = cudaFuncSetAttribute(sepconv_stack_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, n);
  sepconv_stack_kernel<T><<<grid, kThreads, smem, stream>>>(
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
  if (n_layers < 1 || n_layers > kMaxLayers || n < 1 || n > 65535 || h < 1 ||
      wc < 1)
    return (int)cudaErrorInvalidValue;
  StackDesc d = {};
  d.n_layers = n_layers;
  const int* wd = static_cast<const int*>(widths);
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (wd[l] < 1) return (int)cudaErrorInvalidValue;
    d.widths[l] = wd[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    d.dw_off[l] = off;
    off += 9 * d.widths[l];
    d.pw_off[l] = off;
    off += d.widths[l] * d.widths[l + 1];
    d.b_off[l] = off;
    off += d.widths[l + 1];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, out, d, n, h, wc, lo, hi, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, out, d, n, h, wc, lo, hi, s);
  return (int)cudaErrorInvalidValue;
}

const char* nrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
