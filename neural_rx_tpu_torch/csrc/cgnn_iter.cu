// Fused CGNN iteration (K3) and the whole CGNN in one launch (K4) for
// Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of neural_rx_tpu/kernels/cgnn_iter_pallas.py:
//   K3 fused_iteration -> _fused_iteration_impl (body _iter_kernel)
//   K4 fused_cgnn_full -> _fused_cgnn_full_impl (body _full_kernel)
//
// One iteration, state s [b, T, H, W, d_s] (T users), in the working type:
//   1. aggregation MLP per RE and user (1 hidden layer, ReLU), rounded;
//      sps_u = round(y_u) * active[b, u];
//   2. tot = sum_u sps_u (f32 sum, rounded once);
//      a_t = (tot - sps_t) * scale, rounded after each op, with
//      scale = 1 / max(n_active - 1, 1) (1 when n_active <= 1);
//   3. z = [a_t, s_t, pe_t], zero outside the valid columns, through the
//      update stack (separable convs, nrx_tile.cuh);
//   4. s_t + stack output, rounded; in readout mode the LLR and channel
//      readout MLPs (1 hidden layer each) run on that state instead of
//      writing it.
// Rounding points are the TPU kernel's: weights in the working type, f32
// sums, the bias added in f32, one rounding per layer.
//
// K3 design. The TPU program held every user's 128-channel activations for
// a 128-column block in VMEM; Hopper's 227 KB of shared memory hold one
// image's two 128-channel buffers for a 32-column tile. So a block owns
// one (batch item, user t, column tile) and the tile's 3-column halo.
// Prologue: it loads s_t and pe_t into z's slots in buffer A, then for every
// user u runs the aggregation MLP over the tile in chunks of positions
// (the other users' states come from device memory, the hidden layer goes
// to scratch in the free part of A and B), keeping sum_u sps_u in an f32
// array at the end of B and sps_t in z's first slot. Then a_t is formed in
// place, the update stack runs as in the stack kernel, and the epilogue adds
// the residual and writes the state, or runs both readouts on the core
// columns and writes llr and h_hat. The other user's aggregation MLP is
// recomputed in each user's blocks (~15 % of the iteration's FLOPs), which
// keeps the stack kernel's tile width.
//
// K4 design. The whole CGNN (init stack, every iteration, both readouts)
// does not fit a per-tile halo: 9 columns each side with every user's state
// kept across stages leaves ~3 core columns of a 21-column tile. So K4 is
// one persistent cooperative launch with the state in device memory between
// stages (at batch 1 the 5 MB state stays in the 50 MB L2): one block per
// SM loops over (image, tile) work items of a stage, and a grid-wide
// barrier (cooperative_groups this_grid().sync()) separates the stages.
// Ping-pong state buffers come from the caller. Stage tiles are the stack
// and iteration tiles above.
//
// What bounds them on this card: K3 at batch 16 is ~69 GFLOP against
// ~0.2 GB of traffic and K4 at batch 1 ~12.6 GFLOP against ~2 MB, so both
// are bound by operations on the tensor cores (~70 and ~13 us). These first
// kernels run every product on the CUDA cores in f32 (16 warps, 4x4
// register tiles fed from shared memory) and are bound by the shared-memory
// loads and the f32 FMA rate, like the stack kernel.

#include <cooperative_groups.h>

#include <type_traits>

#include "nrx_tile.cuh"

namespace {

using nrx::from_f;
using nrx::MlpDesc;
using nrx::StackDesc;
using nrx::to_f;

constexpr int kMaxIt = 4;
constexpr int kMaxUsers = 8;
constexpr int kMinChunk = 64;

// Static shape of one iteration stage and its shared-memory layout.
struct IterDesc {
  int n_users, d_s, d_pe;
  MlpDesc agg;
  StackDesc upd;  // widths[0] == 2 d_s + d_pe, widths[L] == d_s
  int w_tile;     // core columns of a tile
  int chunk;      // positions per aggregation chunk
  int scr_off;    // scratch: elements from the start of shared memory
  int acc_off;    // f32 user sum: bytes from the start of shared memory
  int readout;    // 0: state out, 1: llr, 2: llr and h_hat
  MlpDesc ro, ch;
  size_t smem;    // bytes
};

// One aggregation MLP over np positions: src [np][stride] -> epi(p, o, y)
// with y the f32 output sum before its bias. Hidden layer in hid_buf.
template <typename T, typename Epi>
__device__ __forceinline__ void mlp(const T* src, int stride, int np,
                                    const T* __restrict__ w, const MlpDesc& m,
                                    T* hid_buf, Epi epi) {
  const T* w1 = w;
  const T* b1 = w1 + m.in * m.hid;
  const T* w2 = b1 + m.hid;
  nrx::pointwise<T>(src, stride, np, w1, m.in, m.hid, [&](int p, int o, float y) {
    y += to_f(b1[o]);
    if (y < 0.f) y = 0.f;  // NaN passes, as max(y, 0) does
    hid_buf[(size_t)p * m.hid + o] = from_f<T>(y);
  });
  __syncthreads();
  nrx::pointwise<T>(hid_buf, m.hid, np, w2, m.hid, m.out, epi);
  __syncthreads();
}

// One readout MLP on the core positions of the tile: state [Pc][d_s] in
// src, hidden layer in hid_buf, output [b, T, H, W, out] rows of image img.
template <typename T>
__device__ void readout(const T* src, int Pc, const T* __restrict__ w,
                        const MlpDesc& m, T* hid_buf, T* out, size_t img,
                        int H, int W, int w0, int w_tile) {
  const T* b2 = w + m.in * m.hid + m.hid + m.hid * m.out;
  T* o_img = out + img * H * W * m.out;
  mlp<T>(src, m.in, Pc, w, m, hid_buf, [&](int p, int o, float y) {
    const int h = p / w_tile;
    const int g = w0 + p % w_tile;
    if (g < W) o_img[((size_t)h * W + g) * m.out + o] = from_f<T>(y + to_f(b2[o]));
  });
}

// One tile of one iteration: user t of batch item bi, core columns
// [tile * w_tile, (tile + 1) * w_tile). s [b, T, H, W, d_s], pe [T, H, W,
// d_pe], act [b, T] f32. State mode writes out [b, T, H, W, d_s]; readout
// mode writes out (llr) and, if q.readout == 2, out2 (h_hat).
template <typename T>
__device__ void iter_tile(const T* s, const T* pe, const float* act, T* out,
                          T* out2, const T* __restrict__ agg_w,
                          const T* __restrict__ upd_w,
                          const T* __restrict__ ro_w,
                          const T* __restrict__ ch_w, const IterDesc& q, int H,
                          int W, int lo, int hi, int bi, int t, int tile,
                          unsigned char* smem) {
  const int L = q.upd.n_layers;
  const int E = q.w_tile + 2 * L;
  const int P = H * E;
  const int d_s = q.d_s;
  const int zc = q.upd.widths[0];
  T* buf_a = reinterpret_cast<T*>(smem);
  T* buf_b = buf_a + (size_t)P * nrx::stack_cmax(q.upd);
  T* scr_s = buf_a + q.scr_off;                // [chunk][d_s]
  T* scr_h = scr_s + (size_t)q.chunk * d_s;    // [chunk][agg.hid]
  float* tot = reinterpret_cast<float*>(smem + q.acc_off);  // [P][d_s]
  const int w0 = tile * q.w_tile;
  const int g0 = w0 - L;
  const int vlo = max(lo, 0);
  const int vhi = min(hi, W);
  const size_t img = (size_t)H * W;
  const T* s_b = s + (size_t)bi * q.n_users * img * d_s;
  const float* act_b = act + (size_t)bi * q.n_users;

  // 1. z[:, d_s:] = [s_t, pe_t] (zero outside the valid columns), sums = 0.
  const int c_sp = d_s + q.d_pe;
  for (int i = threadIdx.x; i < P * c_sp; i += blockDim.x) {
    const int c = i % c_sp;
    const int p = i / c_sp;
    const int h = p / E;
    const int g = g0 + p % E;
    T v = from_f<T>(0.f);
    if (g >= vlo && g < vhi) {
      const size_t rc = (size_t)t * img + (size_t)h * W + g;
      v = c < d_s ? s_b[rc * d_s + c] : pe[rc * q.d_pe + c - d_s];
    }
    buf_a[(size_t)p * zc + d_s + c] = v;
  }
  for (int i = threadIdx.x; i < P * d_s; i += blockDim.x) tot[i] = 0.f;
  float cnt = -1.f;
  for (int u = 0; u < q.n_users; ++u) cnt += act_b[u];
  cnt = fmaxf(cnt, 0.f);
  const float scale = to_f(from_f<T>(cnt == 0.f ? 1.f : 1.f / fmaxf(cnt, 1.f)));
  __syncthreads();

  // 2. Aggregation MLP of every user, chunk by chunk; sps_t goes to z's
  //    first slot, sum_u sps_u to tot.
  const T* b2 = agg_w + q.agg.in * q.agg.hid + q.agg.hid + q.agg.hid * q.agg.out;
  for (int u = 0; u < q.n_users; ++u) {
    const float act_u = act_b[u];
    for (int p0 = 0; p0 < P; p0 += q.chunk) {
      const int np = min(q.chunk, P - p0);
      const T* src = buf_a + (size_t)p0 * zc + d_s;
      int stride = zc;
      if (u != t) {
        for (int i = threadIdx.x; i < np * d_s; i += blockDim.x) {
          const int c = i % d_s;
          const int p = p0 + i / d_s;
          const int h = p / E;
          const int g = g0 + p % E;
          scr_s[i] = (g >= vlo && g < vhi)
                         ? s_b[((size_t)u * img + (size_t)h * W + g) * d_s + c]
                         : from_f<T>(0.f);
        }
        __syncthreads();
        src = scr_s;
        stride = d_s;
      }
      mlp<T>(src, stride, np, agg_w, q.agg, scr_h, [&](int p, int o, float y) {
        const T sps = from_f<T>(to_f(from_f<T>(y + to_f(b2[o]))) * act_u);
        const size_t r = (size_t)(p0 + p);
        tot[r * d_s + o] += to_f(sps);
        if (u == t) buf_a[r * zc + o] = sps;
      });
    }
  }

  // 3. a_t = (tot - sps_t) * scale in z's first slot.
  for (int i = threadIdx.x; i < P * d_s; i += blockDim.x) {
    const int o = i % d_s;
    const int p = i / d_s;
    const int g = g0 + p % E;
    T* zp = buf_a + (size_t)p * zc + o;
    const float diff = to_f(from_f<T>(to_f(from_f<T>(tot[i])) - to_f(*zp)));
    *zp = (g >= vlo && g < vhi) ? from_f<T>(diff * scale) : from_f<T>(0.f);
  }
  __syncthreads();

  // 4. Update stack.
  nrx::run_stack<T>(buf_a, buf_b, upd_w, q.upd, H, E, g0, vlo, vhi);

  // 5. Residual; the state, or both readouts on it.
  const T* s_t = s_b + (size_t)t * img * d_s;
  const size_t img_out = (size_t)bi * q.n_users + t;
  if (q.readout == 0) {
    T* o_t = out + img_out * img * d_s;
    for (int i = threadIdx.x; i < H * q.w_tile * d_s; i += blockDim.x) {
      const int c = i % d_s;
      const int cc = (i / d_s) % q.w_tile;
      const int h = i / (d_s * q.w_tile);
      const int g = w0 + cc;
      if (g < W) {
        const size_t r = ((size_t)h * W + g) * d_s + c;
        o_t[r] = from_f<T>(to_f(buf_a[((size_t)h * E + L + cc) * d_s + c]) +
                           to_f(s_t[r]));
      }
    }
    __syncthreads();
    return;
  }
  const int Pc = H * q.w_tile;
  for (int i = threadIdx.x; i < Pc * d_s; i += blockDim.x) {
    const int c = i % d_s;
    const int p = i / d_s;
    const int h = p / q.w_tile;
    const int cc = p % q.w_tile;
    const int g = w0 + cc;
    buf_b[i] = g < W ? from_f<T>(to_f(buf_a[((size_t)h * E + L + cc) * d_s + c]) +
                                 to_f(s_t[((size_t)h * W + g) * d_s + c]))
                     : from_f<T>(0.f);
  }
  __syncthreads();
  readout<T>(buf_b, Pc, ro_w, q.ro, buf_a, out, img_out, H, W, w0, q.w_tile);
  if (q.readout == 2)
    readout<T>(buf_b, Pc, ch_w, q.ch, buf_a, out2, img_out, H, W, w0, q.w_tile);
}

inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// Shared-memory layout of an iteration tile of E = w_tile + 2L columns:
// buffers A and B ([P][cmax] each, P = H * E), z = [a, s, pe] at the start
// of A, the f32 user sum [P][d_s] at the end, the chunk scratch between.
// Returns false if it does not fit in `limit` bytes.
bool iter_layout(IterDesc* q, int H, int w_tile, size_t itemsize,
                 size_t limit) {
  const int L = q->upd.n_layers;
  const size_t P = (size_t)H * (w_tile + 2 * L);
  const size_t cmax = nrx::stack_cmax(q->upd);
  const size_t zc = q->upd.widths[0];
  const size_t per_chunk = (size_t)(q->d_s + q->agg.hid) * itemsize;
  const size_t scr = align16(P * zc * itemsize);
  const size_t acc = align16(P * q->d_s * sizeof(float));
  const size_t min_chunk = P < (size_t)kMinChunk ? P : (size_t)kMinChunk;
  size_t total = 2 * P * cmax * itemsize;
  if (total < scr + min_chunk * per_chunk + 16 + acc)
    total = scr + min_chunk * per_chunk + 16 + acc;
  total = align16(total);
  if (total > limit) return false;
  // readouts: state [Pc][d_s] in B, hidden [Pc][hid] in A
  const size_t Pc = (size_t)H * w_tile;
  if (q->readout > 0 && Pc * q->ro.hid > P * cmax) return false;
  if (q->readout > 1 && Pc * q->ch.hid > P * cmax) return false;
  q->w_tile = w_tile;
  q->acc_off = (int)((total - acc) & ~(size_t)15);
  q->scr_off = (int)(scr / itemsize);
  size_t chunk = (q->acc_off - scr) / per_chunk;
  q->chunk = (int)(chunk < P ? chunk : P);
  q->smem = total;
  return true;
}

// Widest equal tiles over W whose layout fits `limit` bytes; false if none.
bool iter_tiles(IterDesc* q, int H, int W, size_t itemsize, size_t limit) {
  int w_tile = W < nrx::kMaxTile ? W : nrx::kMaxTile;
  while (w_tile >= 1 && !iter_layout(q, H, w_tile, itemsize, limit)) --w_tile;
  if (w_tile < 1) return false;
  const int n_tiles = (W + w_tile - 1) / w_tile;
  return iter_layout(q, H, (W + n_tiles - 1) / n_tiles, itemsize, limit);
}

bool make_iter_desc(IterDesc* q, int n_users, int d_s, int d_pe,
                    const int* agg_dims, int n_layers, const int* widths,
                    const int* ro_dims, const int* ch_dims) {
  *q = IterDesc{};
  q->n_users = n_users;
  q->d_s = d_s;
  q->d_pe = d_pe;
  q->agg = MlpDesc{agg_dims[0], agg_dims[1], agg_dims[2]};
  if (!nrx::make_stack_desc(n_layers, widths, &q->upd)) return false;
  if (n_users < 1 || n_users > kMaxUsers || d_s < 1 || d_pe < 1) return false;
  if (q->agg.in != d_s || q->agg.out != d_s || q->agg.hid < 1) return false;
  if (q->upd.widths[0] != 2 * d_s + d_pe || q->upd.widths[n_layers] != d_s)
    return false;
  if (ro_dims) {
    q->readout = ch_dims ? 2 : 1;
    q->ro = MlpDesc{ro_dims[0], ro_dims[1], ro_dims[2]};
    if (q->ro.in != d_s || q->ro.hid < 1 || q->ro.out < 1) return false;
    if (ch_dims) {
      q->ch = MlpDesc{ch_dims[0], ch_dims[1], ch_dims[2]};
      if (q->ch.in != d_s || q->ch.hid < 1 || q->ch.out < 1) return false;
    }
  }
  return true;
}

cudaError_t smem_optin(size_t* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *bytes = (size_t)optin;
  return err;
}

// ---------------------------------------------------------------- K3

template <typename T>
struct IterArgs {
  const T* s;
  const T* pe;
  const float* act;
  T* out;
  T* out2;
  const T* agg_w;
  const T* upd_w;
  const T* ro_w;
  const T* ch_w;
  IterDesc q;
  int H, W, lo, hi;
};

template <typename T>
__global__ void __launch_bounds__(nrx::kThreads) cgnn_iter_kernel(IterArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bt = blockIdx.y;
  iter_tile<T>(a.s, a.pe, a.act, a.out, a.out2, a.agg_w, a.upd_w, a.ro_w, a.ch_w,
               a.q, a.H, a.W, a.lo, a.hi, bt / a.q.n_users, bt % a.q.n_users,
               blockIdx.x, smem_raw);
}

template <typename T>
cudaError_t launch_iter(IterArgs<T> a, int b, cudaStream_t stream) {
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  if (!iter_tiles(&a.q, a.H, a.W, sizeof(T), optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(cgnn_iter_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.q.smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.W + a.q.w_tile - 1) / a.q.w_tile, b * a.q.n_users);
  cgnn_iter_kernel<T><<<grid, nrx::kThreads, a.q.smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K4

template <typename T>
struct FullArgs {
  const T* z0;      // [b, T, H, W, init widths[0]]
  const T* pe;      // [T, H, W, d_pe]
  const float* act; // [b, T]
  T* state[2];      // ping-pong [b, T, H, W, d_s]
  T* llr;           // [b, T, H, W, ro.out]
  T* hh;            // [b, T, H, W, ch.out]
  const T* init_w;
  const T* agg_w[kMaxIt];
  const T* upd_w[kMaxIt];
  const T* ro_w;
  const T* ch_w;
  StackDesc init;
  int init_w_tile;
  IterDesc it[kMaxIt];
  int num_it, b, H, W, lo, hi;
};

template <typename T>
__global__ void __launch_bounds__(nrx::kThreads) cgnn_full_kernel(FullArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n_users = a.it[0].n_users;
  const int n_img = a.b * n_users;

  // Stage 0: the init stack, z0 -> state[0].
  const int tiles0 = (a.W + a.init_w_tile - 1) / a.init_w_tile;
  for (int item = blockIdx.x; item < n_img * tiles0; item += gridDim.x)
    nrx::stack_tile<T>(a.z0, a.init_w, a.state[0], a.init, a.H, a.W,
                       a.init_w_tile, a.lo, a.hi, item / tiles0, item % tiles0,
                       smem_raw);

  // Stages 1..num_it: the iterations, the last one with both readouts.
  for (int i = 0; i < a.num_it; ++i) {
    grid.sync();  // the previous stage's state is complete
    const IterDesc& q = a.it[i];
    const T* src = a.state[i % 2];
    T* dst = q.readout ? a.llr : a.state[(i + 1) % 2];
    const int tiles = (a.W + q.w_tile - 1) / q.w_tile;
    for (int item = blockIdx.x; item < n_img * tiles; item += gridDim.x) {
      const int bt = item / tiles;
      iter_tile<T>(src, a.pe, a.act, dst, a.hh, a.agg_w[i], a.upd_w[i], a.ro_w,
                   a.ch_w, q, a.H, a.W, a.lo, a.hi, bt / n_users, bt % n_users,
                   item % tiles, smem_raw);
    }
  }
}

template <typename T>
cudaError_t launch_full(FullArgs<T>& a, cudaStream_t stream) {
  size_t optin = 0;
  cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  a.init_w_tile = nrx::stack_w_tile(a.init, a.H, a.W, sizeof(T), optin);
  if (a.init_w_tile < 1) return cudaErrorInvalidValue;
  size_t smem = nrx::stack_smem(a.init, a.H, a.init_w_tile, sizeof(T));
  const int n_img = a.b * a.it[0].n_users;
  int items = n_img * ((a.W + a.init_w_tile - 1) / a.init_w_tile);
  for (int i = 0; i < a.num_it; ++i) {
    if (!iter_tiles(&a.it[i], a.H, a.W, sizeof(T), optin)) return cudaErrorInvalidValue;
    if (a.it[i].smem > smem) smem = a.it[i].smem;
    const int n = n_img * ((a.W + a.it[i].w_tile - 1) / a.it[i].w_tile);
    if (n > items) items = n;
  }
  err = cudaFuncSetAttribute(cgnn_full_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cgnn_full_kernel<T>,
                                                      nrx::kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // every block resident at once, none without work in the widest stage
  const int blocks = per_sm * n_sm < items ? per_sm * n_sm : items;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)cgnn_full_kernel<T>, dim3(blocks),
                                    dim3(nrx::kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One CGNN iteration (K3). s: [b, t, h, w, d_s]; pe: [t, h, w, d_pe]; both in
// the working type (dtype 0: float32, 1: bfloat16), contiguous. act: [b, t]
// float32 (1 = active). agg_w: packed aggregation MLP, agg_dims {in, hid,
// out}; upd_w: packed update stack, widths: n_layers + 1 ints (host). State
// mode (ro_w null): out [b, t, h, w, d_s]. Readout mode: out = llr [b, t, h,
// w, ro_dims[2]] and, if ch_w is given, out2 = h_hat [b, t, h, w,
// ch_dims[2]]. Dims arrays live on the host. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
int nrx_cgnn_iter(const void* s, const void* pe, const void* act, void* out,
                  void* out2, const void* agg_w, const void* agg_dims,
                  const void* upd_w, int n_layers, const void* widths,
                  const void* ro_w, const void* ro_dims, const void* ch_w,
                  const void* ch_dims, int dtype, int b, int t, int h, int w,
                  int d_s, int d_pe, int lo, int hi, void* stream) {
  if (b < 1 || (size_t)b * t > 65535 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if ((ro_w == nullptr) != (ro_dims == nullptr) || (ch_w == nullptr) != (ch_dims == nullptr) ||
      (ch_w != nullptr && ro_w == nullptr))
    return (int)cudaErrorInvalidValue;
  IterDesc q;
  if (!make_iter_desc(&q, t, d_s, d_pe, static_cast<const int*>(agg_dims), n_layers,
                      static_cast<const int*>(widths), static_cast<const int*>(ro_dims),
                      static_cast<const int*>(ch_dims)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    using T = float;
    IterArgs<T> a{static_cast<const T*>(s), static_cast<const T*>(pe),
                  static_cast<const float*>(act), static_cast<T*>(out),
                  static_cast<T*>(out2), static_cast<const T*>(agg_w),
                  static_cast<const T*>(upd_w), static_cast<const T*>(ro_w),
                  static_cast<const T*>(ch_w), q, h, w, lo, hi};
    return (int)launch_iter<T>(a, b, st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    IterArgs<T> a{static_cast<const T*>(s), static_cast<const T*>(pe),
                  static_cast<const float*>(act), static_cast<T*>(out),
                  static_cast<T*>(out2), static_cast<const T*>(agg_w),
                  static_cast<const T*>(upd_w), static_cast<const T*>(ro_w),
                  static_cast<const T*>(ch_w), q, h, w, lo, hi};
    return (int)launch_iter<T>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The whole CGNN in one cooperative launch (K4). z0: [b, t, h, w,
// init_widths[0]]; pe: [t, h, w, d_pe]; act: [b, t] float32; state_a,
// state_b: scratch [b, t, h, w, d_s] each; llr: [b, t, h, w, ro_dims[2]];
// hh: [b, t, h, w, ch_dims[2]]. init_w: packed init stack (n_init layers,
// init_widths); agg_w, upd_w: host arrays of num_it device pointers to the
// packed aggregation MLPs and update stacks, agg_dims {in, hid, out} per
// iteration, upd_widths n_upd + 1 ints per iteration; ro_w, ch_w: packed
// readout MLPs. Host arrays for every dims argument. Launches on `stream`,
// allocates nothing, does not synchronise; returns the launch's error.
int nrx_cgnn_full(const void* z0, const void* pe, const void* act, void* state_a,
                  void* state_b, void* llr, void* hh, const void* init_w,
                  int n_init, const void* init_widths, const void* agg_w,
                  const void* agg_dims, const void* upd_w, int n_upd,
                  const void* upd_widths, const void* ro_w, const void* ro_dims,
                  const void* ch_w, const void* ch_dims, int num_it, int dtype,
                  int b, int t, int h, int w, int d_s, int d_pe, int lo, int hi,
                  void* stream) {
  if (num_it < 1 || num_it > kMaxIt || b < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  StackDesc init;
  if (!nrx::make_stack_desc(n_init, static_cast<const int*>(init_widths), &init) ||
      init.widths[n_init] != d_s)
    return (int)cudaErrorInvalidValue;
  IterDesc it[kMaxIt];
  const int* ad = static_cast<const int*>(agg_dims);
  const int* uw = static_cast<const int*>(upd_widths);
  for (int i = 0; i < num_it; ++i) {
    const bool last = i == num_it - 1;
    if (!make_iter_desc(&it[i], t, d_s, d_pe, ad + 3 * i, n_upd, uw + (n_upd + 1) * i,
                        last ? static_cast<const int*>(ro_dims) : nullptr,
                        last ? static_cast<const int*>(ch_dims) : nullptr))
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* aw = static_cast<const void* const*>(agg_w);
  const void* const* pw = static_cast<const void* const*>(upd_w);
  auto fill = [&](auto* a) {
    using T = typename std::remove_pointer<decltype(a->z0)>::type;
    using U = typename std::remove_const<T>::type;
    a->z0 = static_cast<const U*>(z0);
    a->pe = static_cast<const U*>(pe);
    a->act = static_cast<const float*>(act);
    a->state[0] = static_cast<U*>(state_a);
    a->state[1] = static_cast<U*>(state_b);
    a->llr = static_cast<U*>(llr);
    a->hh = static_cast<U*>(hh);
    a->init_w = static_cast<const U*>(init_w);
    for (int i = 0; i < num_it; ++i) {
      a->agg_w[i] = static_cast<const U*>(aw[i]);
      a->upd_w[i] = static_cast<const U*>(pw[i]);
      a->it[i] = it[i];
    }
    a->ro_w = static_cast<const U*>(ro_w);
    a->ch_w = static_cast<const U*>(ch_w);
    a->init = init;
    a->num_it = num_it;
    a->b = b;
    a->H = h;
    a->W = w;
    a->lo = lo;
    a->hi = hi;
  };
  if (dtype == 0) {
    FullArgs<float> a{};
    fill(&a);
    return (int)launch_full<float>(a, st);
  }
  if (dtype == 1) {
    FullArgs<__nv_bfloat16> a{};
    fill(&a);
    return (int)launch_full<__nv_bfloat16>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
