// Device code shared by the port's CGNN kernels (sm_90a), CUDA C++.
//
// One block works on one tile of subcarrier columns of one image [H, W, C]
// (channels-last): it keeps the tile plus a halo of L columns on each side
// in shared memory (buffer A, [H][E][C], E = w_tile + 2L), runs every layer
// of a separable-conv stack there with the live halo shrinking by one column
// per layer, and leaves the last layer's output in A. Two buffers: the
// depthwise step reads A and writes B, the pointwise step reads B and writes
// A. The tile functions below are the bodies of the stack kernel
// (sepconv_stack.cu), the iteration kernel and the persistent whole-CGNN
// kernel (cgnn_iter.cu).
//
// Rounding points are those of the TPU kernels: weights arrive in the
// working type; the depthwise taps accumulate in f32 in the reference's
// order (multiply, then add) and are rounded; every product sums in f32 along
// its input channels in order, with FMA, the bias is added in f32 and the
// result is rounded to the working type. Columns outside [lo, hi) ∩ [0, W)
// are zero before every layer and after the last.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nrx {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 512;
constexpr int kMaxTile = 64;

// A separable-conv stack in a packed weight buffer: per layer dw [9][c_in]
// (tap-major, ky * 3 + kx), pw [c_in][c_out], b [c_out].
struct StackDesc {
  int n_layers;
  int widths[kMaxLayers + 1];
  int dw_off[kMaxLayers];
  int pw_off[kMaxLayers];
  int b_off[kMaxLayers];
};

// A one-hidden-layer MLP in a packed buffer: w1 [in][hid], b1 [hid],
// w2 [hid][out], b2 [out].
struct MlpDesc {
  int in, hid, out;
};

inline bool make_stack_desc(int n_layers, const int* widths, StackDesc* d) {
  if (n_layers < 1 || n_layers > kMaxLayers) return false;
  *d = StackDesc{};
  d->n_layers = n_layers;
  int off = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1) return false;
    d->widths[l] = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    d->dw_off[l] = off;
    off += 9 * d->widths[l];
    d->pw_off[l] = off;
    off += d->widths[l] * d->widths[l + 1];
    d->b_off[l] = off;
    off += d->widths[l + 1];
  }
  return true;
}

__host__ __device__ inline int stack_cmax(const StackDesc& d) {
  int c = 0;
  for (int l = 0; l <= d.n_layers; ++l) c = d.widths[l] > c ? d.widths[l] : c;
  return c;
}

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

// y[p][o] = sum_c src[p * stride + c] * w[c * cout + o] for p < P, o < cout,
// in f32, c in order with FMA; epi(p, o, y) takes each sum. Each thread
// computes 4-position x 4-channel register tiles. The caller synchronises.
template <typename T, typename Epi>
__device__ __forceinline__ void pointwise(const T* src, int stride, int P,
                                          const T* __restrict__ w, int cin,
                                          int cout, Epi epi) {
  const int G = (cout + 3) / 4;
  const int Q = (P + 3) / 4;
  for (int item = threadIdx.x; item < G * Q; item += blockDim.x) {
    const int o0 = (item % G) * 4;
    const int p0 = (item / G) * 4;
    const T* a[4];
    int oc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = src + (size_t)min(p0 + k, P - 1) * stride;
      oc[k] = min(o0 + k, cout - 1);
    }
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
    for (int c = 0; c < cin; ++c) {
      const T* row = w + (size_t)c * cout;
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
      if (p0 + k >= P) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (o0 + j >= cout) break;
        epi(p0 + k, o0 + j, acc[k][j]);
      }
    }
  }
}

// Every layer of the stack on the tile in A ([H][E][widths[0]], columns
// outside the valid range already zero); the output [H][E][widths[L]] is
// left in A, valid on the core columns [L, E - L). g0: grid column of
// buffer column 0; [vlo, vhi): valid grid columns.
template <typename T>
__device__ void run_stack(T* buf_a, T* buf_b, const T* __restrict__ wts,
                          const StackDesc& d, int H, int E, int g0, int vlo,
                          int vhi) {
  const int L = d.n_layers;
  for (int l = 0; l < L; ++l) {
    const int cin = d.widths[l];
    const int cout = d.widths[l + 1];
    const int c_lo = l + 1;          // first buffer column this layer writes
    const int wl = E - 2 * (l + 1);  // columns this layer writes
    const int P = H * wl;            // positions this layer writes
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

    // Pointwise + bias (+ ReLU on hidden layers): B [P][cin] -> A [h][col][cout].
    const bool relu = l < L - 1;
    pointwise<T>(buf_b, cin, P, pw, cin, cout, [&](int p, int o, float y) {
      const int h = p / wl;
      const int col = c_lo + p % wl;
      const int g = g0 + col;
      y += to_f(bias[o]);
      if (relu && y < 0.f) y = 0.f;  // NaN passes, as max(y, 0) does
      buf_a[((size_t)h * E + col) * cout + o] =
          (g >= vlo && g < vhi) ? from_f<T>(y) : from_f<T>(0.f);
    });
    __syncthreads();
  }
}

// One tile of the stack (the body of the stack kernel): image n of x
// [N, H, W, widths[0]] -> out [N, H, W, widths[L]], core columns
// [tile * w_tile, (tile + 1) * w_tile). Shared memory: A then B, each
// [H][w_tile + 2L][cmax].
template <typename T>
__device__ void stack_tile(const T* x, const T* __restrict__ wts, T* out,
                           const StackDesc& d, int H, int W, int w_tile,
                           int lo, int hi, int n, int tile,
                           unsigned char* smem) {
  const int L = d.n_layers;
  const int E = w_tile + 2 * L;
  T* buf_a = reinterpret_cast<T*>(smem);
  T* buf_b = buf_a + (size_t)H * E * stack_cmax(d);
  const int w0 = tile * w_tile;
  const int g0 = w0 - L;  // grid column of buffer column 0
  const int vlo = max(lo, 0);
  const int vhi = min(hi, W);

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
  __syncthreads();
  run_stack<T>(buf_a, buf_b, wts, d, H, E, g0, vlo, vhi);

  const int cl = d.widths[L];
  T* on = out + (size_t)n * H * W * cl;
  for (int i = threadIdx.x; i < H * w_tile * cl; i += blockDim.x) {
    const int c = i % cl;
    const int cc = (i / cl) % w_tile;
    const int h = i / (cl * w_tile);
    const int g = w0 + cc;
    if (g < W)
      on[((size_t)h * W + g) * cl + c] = buf_a[((size_t)h * E + L + cc) * cl + c];
  }
  __syncthreads();  // A is free for the next tile
}

// Largest tile width (core columns) whose two buffers fit in `smem` bytes,
// then narrowed to equal tiles over W; 0 if none fits.
inline int stack_w_tile(const StackDesc& d, int H, int W, size_t itemsize,
                        size_t smem) {
  const size_t per_col = 2 * (size_t)H * stack_cmax(d) * itemsize;
  int w_tile = (int)(smem / per_col) - 2 * d.n_layers;
  if (w_tile > kMaxTile) w_tile = kMaxTile;
  if (w_tile > W) w_tile = W;
  if (w_tile < 1) return 0;
  const int n_tiles = (W + w_tile - 1) / w_tile;
  return (W + n_tiles - 1) / n_tiles;
}

inline size_t stack_smem(const StackDesc& d, int H, int w_tile,
                         size_t itemsize) {
  return 2 * (size_t)H * (w_tile + 2 * d.n_layers) * stack_cmax(d) * itemsize;
}

}  // namespace nrx
