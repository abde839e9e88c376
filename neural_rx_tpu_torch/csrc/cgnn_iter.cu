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
// image's two 128-channel buffers for a ~30-column tile. So a block owns
// one (batch item, user t, column tile) and the tile's 3-column halo.
// Prologue: it loads s_t and pe_t into z's slots in buffer A; then, chunk by
// chunk of positions, it runs every user's aggregation MLP in user order
// (the other users' states come from device memory, the hidden layer goes
// to scratch in the free part of A and B), keeping the chunk's sum_u sps_u
// in an f32 array and sps_t in z's first slot, and forms the chunk's a_t in
// place. Then the update stack runs as in the stack kernel, and the
// epilogue adds the residual and writes the state, or runs both readouts on
// the core columns and writes llr and h_hat. The other user's aggregation
// MLP is recomputed in each user's blocks (~15 % of the iteration's FLOPs),
// which keeps the stack kernel's tile width.
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
// are bound by operations on the tensor cores (~70 and ~13 us); 92.5 % of
// an iteration's operations are bf16 products with f32 sums, 6.8 % the
// depthwise taps. In float32 (the eval and Monte-Carlo path) K3 at batch
// 30 is ~130 GFLOP, bound by operations at the CUDA cores' 67 TFLOP/s
// (1.945 ms).
//
// bf16 tiles (tensor cores). Every product (update stack, aggregation MLP,
// readouts, K4's init stack) runs as nrx::pointwise_mma: mma.sync m16n8k16
// bf16 -> f32, A fragments from shared memory by ldmatrix, each warp's B
// fragments (one n8 tile: 8 output channels x all of K, 16 registers)
// loaded once a layer from the fragment-ordered copy of the weights that
// the wrapper appends to the packed buffer (kernels/cgnn_iter.py,
// mma_fragments; one 8-byte load a lane and k-step). The epilogue objects
// (nrx_tile.cuh, here AggEpi and OutEpi) take the rounded values a row at a
// time and store column pairs. A second product on |a| and |w| bounds each
// sum's error; a sum within that bound of a bf16 rounding boundary is
// summed again in order on the CUDA cores (~1 % of them), so the rounded
// outputs stay those of the plain version. Without that, the tensor cores'
// order flipped ~1 % of K3's and ~66 % of K4's bf16 outputs by an ulp or
// more on nrx_rt (max rel err 5e-3 and 3.4e-2 against TOL_BF16 = 2e-2):
// the network carries one flipped rounding through its later layers.
// Padded shapes at nrx_rt (K to 16, N to 16 in the packed copy, with zero
// weights; pad lanes of A zeroed in registers; n8 tiles past N skipped):
//   init stack   K 18 -> 32, N 128 | K 128, N 128 | K 128, N 56 -> 64
//   update stack K 114 -> 128, N 128 | K 128, N 128 | K 128, N 56 -> 64
//   aggregation  K 56 -> 64, N 64 | K 64, N 56 -> 64
//   readouts     K 56 -> 64, N 128 | K 128, N 4 -> 16 (llr), 8 -> 16 (h_hat)
// M (positions, H * columns) is walked in 16-row tiles, the last one
// clamped. Shared memory (nrx::row_ld): rows 16-byte aligned, stride an odd
// number of 16-byte chunks so ldmatrix is free of bank conflicts: A and B
// [P][136] each (128 channels), z [P][120] (114), the state and chunk
// scratch [.][56], the hidden layers [.][72] (64) and [.][136] (128). That
// costs two columns against packed rows: w_tile 24 (E = 30, P = 420) in
// 228,480 B a block for the iteration and for K4's init stack, plus the
// warps' re-sum lists (2,048 B): 230,528 B of the 232,448 (packed bf16
// rows: 26 in 229,376 B). 66 tiles over 1584 columns; aggregation chunks
// of 256 positions. The depthwise taps (nrx::depthwise_pairs) keep a
// channel pair a thread with its taps in registers and compute two adjacent
// columns from shared inputs; state rows move in 16-byte chunks. ptxas: 128
// registers, no spills.
//
// float32 tiles (CUDA cores; the eval and Monte-Carlo path). TF32 would not
// keep float32's sums, so the products stay FMAs on the CUDA cores, each
// sum fmaf over c in order from 0 as the first CUDA-core tile summed: the
// outputs are that tile's bit for bit. nrx::pointwise_f32 runs them in
// register tiles (8 positions x 8 channels for the update stack, which it
// reads channel-major from B, 4 x 8 / 4 x 4 for the MLPs, whose rows it
// reads along c) with the weights (the wrappers' padded rows,
// pack_mlp_rows / pack_stack_rows) staged slab by slab in shared memory by
// cp.async; a product's first slab is sent for before the work ahead of it
// (the depthwise step, the state rows' copy, the MLP's other layer), and
// the state rows come by cp.async too. w_tile 10 (E = 16, P = 224): A, B
// (128 x 204) and three 4 KB slabs in 231,424 B; two aggregation chunks of
// 112 positions. K3 (128 registers, no spill) runs at ~16 % of its bound at
// batch 30, about twice the first tile's speed: shared-memory bandwidth
// holds it (nrx_tile.cuh). K4's float32 instance holds both tiles in one
// kernel and spilled at 512 and 384 threads, so it runs 256 (kFullThreads).
//
// e2e_rt and e2e_large (d_s 64, no LS input) have update stacks of 2 x 64
// + 2 = 130 input channels. Their bf16 tiles run the kWide instances
// (nrx_tile.cuh: the k-steps past nrx::kMmaWideRegK stream their weights
// from L2 per M tile), which cgnn_iter_wide.cu compiles in a translation
// unit of its own; nrx_cgnn_iter and nrx_cgnn_full forward a bf16 launch
// with a product past nrx::kMmaRegK there. Rows of 130 and of 128 channels
// take one stride (136), so those tiles are nrx_rt's; with one user (their
// eval configurations) an iteration's aggregation sums one user's MLP.
//
// stencil_lp (the JAX package's lp_stencil argument of both kernels): the
// bf16 instances with kLp sum every stack's depthwise taps in bf16
// (nrx_tile.cuh, depthwise_pairs<true>): K3's update stack, and K4's init
// stack and update stacks. The float32 instances need none: the mode
// changes nothing there. Neither kernel takes the folded-tap mode.
//
// Launch set-up (shared-memory opt-in, the kernel's shared-memory
// attribute, K4's occupancy) is queried once per device, kernel and size.

#include <cooperative_groups.h>

#include <mutex>
#include <type_traits>

#include "nrx_launch.cuh"
#include "nrx_tile.cuh"

namespace {

using nrx::allow_smem;
using nrx::device_setup;
using nrx::DeviceSetup;
using nrx::from_f;
using nrx::KernelSetup;
using nrx::kMaxDevices;
using nrx::kUseMma;
using nrx::mma_fits;
using nrx::MlpDesc;
using nrx::setup_mutex;
using nrx::StackDesc;
using nrx::to_f;

constexpr int kMaxIt = 8;  // the most of any shipped configuration (nrx_large*)
constexpr int kMaxUsers = 8;
constexpr int kMinChunk = 64;

// Static shape of one iteration stage and its shared-memory layout.
struct IterDesc {
  int n_users, d_s, d_pe;
  MlpDesc agg;
  StackDesc upd;  // widths[0] == 2 d_s + d_pe, widths[L] == d_s
  int w_tile;     // core columns of a tile
  int chunk;      // positions per aggregation chunk
  int scr_off;    // chunk scratch: elements from the start of the buffers
  int acc_off;    // chunk's f32 user sum: bytes from the start of the buffers
  int readout;    // 0: state out, 1: llr, 2: llr and h_hat
  MlpDesc ro, ch;
  size_t smem;    // bytes
};

// One MLP over np positions: src [np][stride] -> epi (an epilogue object,
// nrx_tile.cuh) of the output layer, whose bias it adds. Hidden layer in
// hid_buf [np][mlp_ld(hid)]. kWide: products past nrx::kMmaRegK input
// channels (nrx_tile.cuh). primed (CUDA cores): the hidden layer's first
// weight slab is on its way (nrx::copy_slab); the hidden layer sends for the
// output layer's.
template <typename T, bool kMma, bool kWide = false, typename Epi>
__device__ __forceinline__ void mlp(const T* src, int stride, int np,
                                    const T* __restrict__ w, const MlpDesc& m,
                                    T* hid_buf, nrx::FixList fx, Epi epi,
                                    bool primed = false) {
  const T* w1 = w;
  const T* b1 = w1 + m.in * m.hid;
  const T* w2 = b1 + m.hid;
  const T* b2 = w2 + m.hid * m.out;
  const int ld_h = nrx::mlp_ld(m.hid, kMma);
  nrx::product<T, kMma, kWide>(src, stride, np, w1, w + m.f1, b1, m.in, m.hid, fx,
                               nrx::HiddenEpi<T>{hid_buf, b1, ld_h}, primed, w + m.f2,
                               m.hid, m.out);
  __syncthreads();
  nrx::product<T, kMma, kWide>(hid_buf, ld_h, np, w2, w + m.f2, b2, m.hid, m.out, fx, epi,
                               !kMma);
  __syncthreads();
}

// The readout's output layer: rows of [H, W, n_out] of one image, y + bias
// rounded, core columns w0 + [0, w_tile) inside W only.
template <typename T>
struct OutEpi {
  T* o_img;
  const T* bias;
  int W, w0, w_tile, n_out;
  __device__ void operator()(int p, int o, float y) const {
    const int h = p / w_tile;
    const int g = w0 + p % w_tile;
    if (g < W) o_img[((size_t)h * W + g) * n_out + o] = from_f<T>(y + to_f(bias[o]));
  }
  using Row = T*;  // null past W
  __device__ Row row(int p) const {
    const int g = w0 + p % w_tile;
    return g < W ? o_img + ((size_t)(p / w_tile) * W + g) * n_out : nullptr;
  }
  __device__ void put(Row r, int o, __nv_bfloat16 v) const {
    if (r) r[o] = v;
  }
  __device__ void put2(Row r, int o, __nv_bfloat16 v0, __nv_bfloat16 v1) const {
    if (!r) return;
    if (n_out % 2 == 0) {
      *reinterpret_cast<__nv_bfloat162*>(r + o) = __halves2bfloat162(v0, v1);
    } else {
      r[o] = v0;
      r[o + 1] = v1;
    }
  }
};

// The aggregation MLP's output layer on the rows p of a chunk: sps =
// round(y + bias) * act, rounded; tot (f32, [p][d_s]) += sps; z [p][ld_z] =
// sps when the MLP ran on the block's own user.
template <typename T>
struct AggEpi {
  float* tot;
  T* z;
  const T* bias;
  int d_s, ld_z;
  float act;
  bool own;
  __device__ void operator()(int p, int o, float y) const {
    const T sps = from_f<T>(to_f(from_f<T>(y + to_f(bias[o]))) * act);
    tot[(size_t)p * d_s + o] += to_f(sps);
    if (own) z[(size_t)p * ld_z + o] = sps;
  }
  struct Row {
    float* tot;
    T* z;
  };
  __device__ Row row(int p) const {
    return Row{tot + (size_t)p * d_s, z + (size_t)p * ld_z};
  }
  __device__ void put(const Row& r, int o, __nv_bfloat16 v) const {
    const __nv_bfloat16 sps = __float2bfloat16_rn(__bfloat162float(v) * act);
    r.tot[o] += __bfloat162float(sps);
    if (own) r.z[o] = sps;
  }
  __device__ void put2(const Row& r, int o, __nv_bfloat16 v0, __nv_bfloat16 v1) const {
    const __nv_bfloat162 sps = __floats2bfloat162_rn(__bfloat162float(v0) * act,
                                                     __bfloat162float(v1) * act);
    float2* t = reinterpret_cast<float2*>(r.tot + o);
    float2 cur = *t;
    cur.x += __low2float(sps);
    cur.y += __high2float(sps);
    *t = cur;
    if (own) *reinterpret_cast<__nv_bfloat162*>(r.z + o) = sps;
  }
};

// One readout MLP on the core positions of the tile: state [Pc][row_ld(d_s)]
// in src, hidden layer in hid_buf, output [b, T, H, W, out] rows of image img.
// primed: as mlp's.
template <typename T, bool kMma, bool kWide>
__device__ void readout(const T* src, int Pc, const T* __restrict__ w,
                        const MlpDesc& m, T* hid_buf, T* out, size_t img,
                        int H, int W, int w0, int w_tile, nrx::FixList fx,
                        bool primed = false) {
  const T* b2 = w + m.in * m.hid + m.hid + m.hid * m.out;
  mlp<T, kMma, kWide>(src, nrx::row_ld(m.in, kMma), Pc, w, m, hid_buf, fx,
               OutEpi<T>{out + img * H * W * m.out, b2, W, w0, w_tile, m.out}, primed);
}

// Tensor-core path: state rows move as 16-byte chunks of 8 channels (d_s is
// a multiple of 8 there), so a thread has 8 channels in flight a load.
// dst[r * ld + c] = row(r)[c] for r < n, c < d, zeros where row(r) is null.
template <typename RowFn>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int ld, int n, int d,
                                          RowFn row) {
  const int cpr = d / 8;
  for (int i = threadIdx.x; i < n * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 8;
    const __nv_bfloat16* sp = row(r);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c) =
        sp ? __ldg(reinterpret_cast<const uint4*>(sp + c)) : make_uint4(0, 0, 0, 0);
  }
}

// x + y of 8 bf16 pairs, each sum in f32 and rounded once, as from_f(to_f +
// to_f) does.
__device__ __forceinline__ uint4 add_chunks(uint4 x, uint4 y) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(&x);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(&y);
  uint4 r;
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(nrx::bf16_lo(a[k]) + nrx::bf16_lo(b[k]),
                                                   nrx::bf16_hi(a[k]) + nrx::bf16_hi(b[k]));
    o[k] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return r;
}

// One tile of one iteration: user t of batch item bi, core columns
// [tile * w_tile, (tile + 1) * w_tile). s [b, T, H, W, d_s], pe [T, H, W,
// d_pe], act [b, T] f32. State mode writes out [b, T, H, W, d_s]; readout
// mode writes out (llr) and, if q.readout == 2, out2 (h_hat). kLp: the
// update stack's taps in bf16 (stencil_lp); kWide: products past
// nrx::kMmaRegK input channels (iter_wide).
template <typename T, bool kLp = false, bool kWide = false>
__device__ void iter_tile(const T* s, const T* pe, const float* act, T* out,
                          T* out2, const T* __restrict__ agg_w,
                          const T* __restrict__ upd_w,
                          const T* __restrict__ ro_w,
                          const T* __restrict__ ch_w, const IterDesc& q, int H,
                          int W, int lo, int hi, int bi, int t, int tile,
                          unsigned char* smem) {
  constexpr bool kMma = kUseMma<T>;
  const int L = q.upd.n_layers;
  const int E = q.w_tile + 2 * L;
  const int P = H * E;
  const int d_s = q.d_s;
  const int ld_z = nrx::row_ld(q.upd.widths[0], kMma);  // z = [a, s, pe]
  const int ld_s = nrx::row_ld(d_s, kMma);
  const nrx::FixList fx = nrx::fix_list(smem);
  unsigned char* base = smem + (kMma ? nrx::kFixBytes : 0);  // past the lists
  T* buf_a = reinterpret_cast<T*>(base);
  T* buf_b = buf_a + (kMma ? (size_t)P * nrx::row_ld(nrx::stack_cmax(q.upd), kMma)
                           : nrx::tile_a_elems(H, E, nrx::stack_cmax(q.upd), false));
  T* scr_s = buf_a + q.scr_off;                // [chunk][ld_s]
  T* scr_h = scr_s + (size_t)q.chunk * ld_s;   // [chunk][mlp_ld(agg.hid)]
  float* tot = reinterpret_cast<float*>(base + q.acc_off);  // [chunk][d_s]
  const int w0 = tile * q.w_tile;
  const int g0 = w0 - L;
  const int vlo = max(lo, 0);
  const int vhi = min(hi, W);
  const size_t img = (size_t)H * W;
  const T* s_b = s + (size_t)bi * q.n_users * img * d_s;
  const float* act_b = act + (size_t)bi * q.n_users;

  // 1. z[:, d_s:] = [s_t, pe_t] (zero outside the valid columns).
  if constexpr (kMma) {
    load_rows(buf_a + d_s, ld_z, P, d_s, [&](int p) -> const T* {
      const int g = g0 + p % E;
      return g >= vlo && g < vhi ? s_b + ((size_t)t * img + (size_t)(p / E) * W + g) * d_s
                                 : nullptr;
    });
    for (int i = threadIdx.x; i < P * q.d_pe; i += blockDim.x) {
      const int p = i / q.d_pe;
      const int g = g0 + p % E;
      const size_t rc = (size_t)t * img + (size_t)(p / E) * W + g;
      buf_a[(size_t)p * ld_z + 2 * d_s + i % q.d_pe] =
          g >= vlo && g < vhi ? pe[rc * q.d_pe + i % q.d_pe] : from_f<T>(0.f);
    }
  } else {
    // state rows of 16-byte chunks by cp.async where d_s allows, the rest
    // (pe, or all) element by element
    const bool chunks = d_s % 4 == 0;
    if (chunks)
      nrx::copy_rows_f32(buf_a + d_s, ld_z, P, d_s, s_b, [&](int p) -> const float* {
        const int g = g0 + p % E;
        return g >= vlo && g < vhi ? s_b + ((size_t)t * img + (size_t)(p / E) * W + g) * d_s
                                   : nullptr;
      });
    const int c_lo = chunks ? d_s : 0;
    const int c_sp = d_s + q.d_pe - c_lo;
    for (int i = threadIdx.x; i < P * c_sp; i += blockDim.x) {
      const int c = c_lo + i % c_sp;
      const int p = i / c_sp;
      const int h = p / E;
      const int g = g0 + p % E;
      T v = from_f<T>(0.f);
      if (g >= vlo && g < vhi) {
        const size_t rc = (size_t)t * img + (size_t)h * W + g;
        v = c < d_s ? s_b[rc * d_s + c] : pe[rc * q.d_pe + c - d_s];
      }
      buf_a[(size_t)p * ld_z + d_s + c] = v;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  float cnt = -1.f;
  for (int u = 0; u < q.n_users; ++u) cnt += act_b[u];
  cnt = fmaxf(cnt, 0.f);
  const float scale = to_f(from_f<T>(cnt == 0.f ? 1.f : 1.f / fmaxf(cnt, 1.f)));
  __syncthreads();

  // 2. Chunk by chunk of positions: the aggregation MLP of every user in
  //    order (sps_t to z's first slot, sum_u sps_u to the chunk's f32 sum),
  //    then a_t = (tot - sps_t) * scale in z's first slot. The MLP reads
  //    the user's state from the chunk scratch; on the tensor cores the
  //    block's own user's from z's second slot in place.
  const T* b2 = agg_w + q.agg.in * q.agg.hid + q.agg.hid + q.agg.hid * q.agg.out;
  for (int p0 = 0; p0 < P; p0 += q.chunk) {
    const int np = min(q.chunk, P - p0);
    for (int i = threadIdx.x; i < np * d_s; i += blockDim.x) tot[i] = 0.f;
    for (int u = 0; u < q.n_users; ++u) {
      const T* src = buf_a + (size_t)p0 * ld_z + d_s;
      int stride = ld_z;
      if (!kMma || u != t) {
        if constexpr (kMma) {
          load_rows(scr_s, ld_s, np, d_s, [&](int r) -> const T* {
            const int p = p0 + r;
            const int g = g0 + p % E;
            return g >= vlo && g < vhi
                       ? s_b + ((size_t)u * img + (size_t)(p / E) * W + g) * d_s
                       : nullptr;
          });
        } else {
          // the MLP's first weight slab, then the state rows (16-byte
          // chunks by cp.async where d_s allows)
          nrx::copy_slab(agg_w + q.agg.f1, q.agg.in, q.agg.hid, 0);
          if (d_s % 4 == 0) {
            nrx::copy_rows_f32(scr_s, ld_s, np, d_s, s_b, [&](int r) -> const float* {
              const int p = p0 + r;
              const int g = g0 + p % E;
              return g >= vlo && g < vhi
                         ? s_b + ((size_t)u * img + (size_t)(p / E) * W + g) * d_s
                         : nullptr;
            });
          } else {
            for (int i = threadIdx.x; i < np * d_s; i += blockDim.x) {
              const int c = i % d_s;
              const int p = p0 + i / d_s;
              const int h = p / E;
              const int g = g0 + p % E;
              scr_s[(size_t)(i / d_s) * ld_s + c] =
                  (g >= vlo && g < vhi)
                      ? s_b[((size_t)u * img + (size_t)h * W + g) * d_s + c]
                      : from_f<T>(0.f);
            }
          }
          asm volatile("cp.async.wait_group 0;\n" ::);
        }
        __syncthreads();
        src = scr_s;
        stride = ld_s;
      }
      mlp<T, kMma, kWide>(src, stride, np, agg_w, q.agg, scr_h, fx,
                   AggEpi<T>{tot, buf_a + (size_t)p0 * ld_z, b2, d_s, ld_z, act_b[u], u == t},
                   !kMma);
    }
    for (int i = threadIdx.x; i < np * d_s; i += blockDim.x) {
      const int o = i % d_s;
      const int p = p0 + i / d_s;
      const int g = g0 + p % E;
      T* zp = buf_a + (size_t)p * ld_z + o;
      const float diff = to_f(from_f<T>(to_f(from_f<T>(tot[i])) - to_f(*zp)));
      *zp = (g >= vlo && g < vhi) ? from_f<T>(diff * scale) : from_f<T>(0.f);
    }
    __syncthreads();
  }

  // 4. Update stack.
  nrx::run_stack<T, kMma, kLp ? nrx::kLp : nrx::kNormal, kWide>(buf_a, buf_b, upd_w, q.upd, H,
                                                               E, g0, vlo, vhi, fx);

  // 5. Residual; the state, or both readouts on it.
  const T* s_t = s_b + (size_t)t * img * d_s;
  const size_t img_out = (size_t)bi * q.n_users + t;
  const int cpr = d_s / 8;  // 16-byte chunks a state row (tensor-core path)
  if (q.readout == 0) {
    T* o_t = out + img_out * img * d_s;
    if constexpr (kMma) {
      for (int i = threadIdx.x; i < H * q.w_tile * cpr; i += blockDim.x) {
        const int r = i / cpr;
        const int c = (i - r * cpr) * 8;
        const int cc = r % q.w_tile;
        const int h = r / q.w_tile;
        const int g = w0 + cc;
        if (g < W) {
          const size_t o = ((size_t)h * W + g) * d_s + c;
          *reinterpret_cast<uint4*>(o_t + o) = add_chunks(
              *reinterpret_cast<const uint4*>(buf_a + ((size_t)h * E + L + cc) * ld_s + c),
              __ldg(reinterpret_cast<const uint4*>(s_t + o)));
        }
      }
      __syncthreads();
      return;
    }
    for (int i = threadIdx.x; i < H * q.w_tile * d_s; i += blockDim.x) {
      const int c = i % d_s;
      const int cc = (i / d_s) % q.w_tile;
      const int h = i / (d_s * q.w_tile);
      const int g = w0 + cc;
      if (g < W) {
        const size_t r = ((size_t)h * W + g) * d_s + c;
        o_t[r] = from_f<T>(to_f(buf_a[((size_t)h * E + L + cc) * ld_s + c]) +
                           to_f(s_t[r]));
      }
    }
    __syncthreads();
    return;
  }
  const int Pc = H * q.w_tile;
  if constexpr (kMma) {
    for (int i = threadIdx.x; i < Pc * cpr; i += blockDim.x) {
      const int p = i / cpr;
      const int c = (i - p * cpr) * 8;
      const int h = p / q.w_tile;
      const int cc = p % q.w_tile;
      const int g = w0 + cc;
      *reinterpret_cast<uint4*>(buf_b + (size_t)p * ld_s + c) =
          g < W ? add_chunks(*reinterpret_cast<const uint4*>(
                                 buf_a + ((size_t)h * E + L + cc) * ld_s + c),
                             __ldg(reinterpret_cast<const uint4*>(
                                 s_t + ((size_t)h * W + g) * d_s + c)))
                : make_uint4(0, 0, 0, 0);
    }
  } else {
    nrx::copy_slab(ro_w + q.ro.f1, q.ro.in, q.ro.hid, 0);  // the readout's first slab
    for (int i = threadIdx.x; i < Pc * d_s; i += blockDim.x) {
      const int c = i % d_s;
      const int p = i / d_s;
      const int h = p / q.w_tile;
      const int cc = p % q.w_tile;
      const int g = w0 + cc;
      buf_b[(size_t)p * ld_s + c] =
          g < W ? from_f<T>(to_f(buf_a[((size_t)h * E + L + cc) * ld_s + c]) +
                            to_f(s_t[((size_t)h * W + g) * d_s + c]))
                : from_f<T>(0.f);
    }
  }
  __syncthreads();
  readout<T, kMma, kWide>(buf_b, Pc, ro_w, q.ro, buf_a, out, img_out, H, W, w0, q.w_tile, fx,
                          !kMma);
  if (q.readout == 2)
    readout<T, kMma, kWide>(buf_b, Pc, ch_w, q.ch, buf_a, out2, img_out, H, W, w0, q.w_tile,
                            fx);
}

inline size_t align16(size_t v) { return (v + 15) & ~(size_t)15; }

// Shared-memory layout of an iteration tile of E = w_tile + 2L columns:
// buffers A ([P][ld(cmax)], P = H * E, ld = nrx::row_ld) and B
// (nrx::tile_b_elems), z = [a, s, pe] at the start of A ([P][ld(zc)]), then
// the aggregation's chunk scratch: state [chunk][ld(d_s)], hidden
// [chunk][mlp_ld(agg.hid)] and the f32 user sum [chunk][d_s]. On the
// tensor-core path the re-sum lists (nrx::kFixBytes) come first and the
// offsets count from their end, and a chunk is a multiple of 16 positions;
// on the CUDA cores the weight slabs (nrx::kStageBytes) come last and the
// chunks are equal (the products' tiles fill the block alike). Returns
// false if it does not fit in `limit` bytes.
bool iter_layout(IterDesc* q, int H, int w_tile, size_t itemsize, bool mma,
                 size_t limit) {
  const int L = q->upd.n_layers;
  const int E = w_tile + 2 * L;
  const size_t P = (size_t)H * E;
  const int cmax = nrx::stack_cmax(q->upd);
  const size_t a_elems = nrx::tile_a_elems(H, E, cmax, mma);
  const size_t zc = nrx::row_ld(q->upd.widths[0], mma);
  const size_t per_chunk_t =
      (size_t)(nrx::row_ld(q->d_s, mma) + nrx::mlp_ld(q->agg.hid, mma)) * itemsize;
  const size_t per_chunk = per_chunk_t + q->d_s * sizeof(float);
  const size_t scr = align16(P * zc * itemsize);
  const size_t min_chunk = P < (size_t)kMinChunk ? P : (size_t)kMinChunk;
  const size_t b_elems = nrx::tile_b_elems(q->upd, H, E, mma);
  size_t total = (a_elems + b_elems) * itemsize;
  if (total < scr + min_chunk * per_chunk + 16) total = scr + min_chunk * per_chunk + 16;
  total = align16(total);
  const size_t fix = mma ? nrx::kFixBytes : nrx::kStageBytes;
  if (total + fix > limit || (mma && P > (size_t)nrx::kMmaMaxP)) return false;
  // readouts: state [Pc][ld(d_s)] in B, hidden [Pc][mlp_ld(hid)] in A
  const size_t Pc = (size_t)H * w_tile;
  if (q->readout > 0 && (Pc * nrx::mlp_ld(q->ro.hid, mma) > a_elems ||
                         Pc * nrx::row_ld(q->d_s, mma) > b_elems))
    return false;
  if (q->readout > 1 && Pc * nrx::mlp_ld(q->ch.hid, mma) > a_elems) return false;
  size_t chunk = (total - scr - 16) / per_chunk;
  if (mma && chunk >= 16) chunk &= ~(size_t)15;
  if (chunk > P) chunk = P;
  if (!mma) {
    const size_t n = (P + chunk - 1) / chunk;
    chunk = (P + n - 1) / n;
  }
  q->w_tile = w_tile;
  q->chunk = (int)chunk;
  q->scr_off = (int)(scr / itemsize);
  q->acc_off = (int)align16(scr + chunk * per_chunk_t);
  q->smem = total + fix;
  return true;
}

// Widest equal tiles over W whose layout fits `limit` bytes; false if none.
bool iter_tiles(IterDesc* q, int H, int W, size_t itemsize, bool mma, size_t limit) {
  int w_tile = W < nrx::kMaxTile ? W : nrx::kMaxTile;
  while (w_tile >= 1 && !iter_layout(q, H, w_tile, itemsize, mma, limit)) --w_tile;
  if (w_tile < 1) return false;
  const int n_tiles = (W + w_tile - 1) / w_tile;
  return iter_layout(q, H, (W + n_tiles - 1) / n_tiles, itemsize, mma, limit);
}

// What the tensor-core tile takes: products of at most kMmaMaxK input
// channels (stacks: nrx::mma_fits) and, for the aggregation MLP that reads
// the state's slot of z in place, a 16-byte-aligned slot (d_s a multiple of
// 8). Products past kMmaRegK input channels need the kWide instances.
bool mma_fits(const MlpDesc& m) {
  return m.in <= nrx::kMmaMaxK && m.hid <= nrx::kMmaMaxK;
}

bool mma_fits(const IterDesc& q) {
  return q.d_s % 8 == 0 && mma_fits(q.upd) && mma_fits(q.agg) &&
         (q.readout < 1 || mma_fits(q.ro)) && (q.readout < 2 || mma_fits(q.ch));
}

// What the CUDA-core tile takes: products of at most kRowsMaxN output
// channels (stacks: nrx::rows_fit).
bool rows_fit(const MlpDesc& m) { return m.hid <= nrx::kRowsMaxN && m.out <= nrx::kRowsMaxN; }

bool rows_fit(const IterDesc& q) {
  return nrx::rows_fit(q.upd) && rows_fit(q.agg) && (q.readout < 1 || rows_fit(q.ro)) &&
         (q.readout < 2 || rows_fit(q.ch));
}

bool mlp_wide(const MlpDesc& m) { return m.in > nrx::kMmaRegK || m.hid > nrx::kMmaRegK; }

bool iter_wide(const IterDesc& q) {
  return nrx::stack_wide(q.upd) || mlp_wide(q.agg) || (q.readout >= 1 && mlp_wide(q.ro)) ||
         (q.readout >= 2 && mlp_wide(q.ch));
}

// fragments: where the packed buffers' product weights are B fragments
// (bf16) or float32 rows (nrx_tile.cuh, make_stack_desc).
bool make_iter_desc(IterDesc* q, int n_users, int d_s, int d_pe,
                    const int* agg_dims, int n_layers, const int* widths,
                    const int* ro_dims, const int* ch_dims, bool fragments) {
  *q = IterDesc{};
  q->n_users = n_users;
  q->d_s = d_s;
  q->d_pe = d_pe;
  q->agg = nrx::make_mlp_desc(agg_dims[0], agg_dims[1], agg_dims[2], fragments);
  if (!nrx::make_stack_desc(n_layers, widths, &q->upd, false, fragments)) return false;
  if (n_users < 1 || n_users > kMaxUsers || d_s < 1 || d_pe < 1) return false;
  if (q->agg.in != d_s || q->agg.out != d_s || q->agg.hid < 1) return false;
  if (q->upd.widths[0] != 2 * d_s + d_pe || q->upd.widths[n_layers] != d_s)
    return false;
  if (ro_dims) {
    q->readout = ch_dims ? 2 : 1;
    q->ro = nrx::make_mlp_desc(ro_dims[0], ro_dims[1], ro_dims[2], fragments);
    if (q->ro.in != d_s || q->ro.hid < 1 || q->ro.out < 1) return false;
    if (ch_dims) {
      q->ch = nrx::make_mlp_desc(ch_dims[0], ch_dims[1], ch_dims[2], fragments);
      if (q->ch.in != d_s || q->ch.hid < 1 || q->ch.out < 1) return false;
    }
  }
  return true;
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

template <typename T, bool kLp, bool kWide>
__global__ void __launch_bounds__(nrx::kThreads) cgnn_iter_kernel(IterArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bt = blockIdx.y;
  iter_tile<T, kLp, kWide>(a.s, a.pe, a.act, a.out, a.out2, a.agg_w, a.upd_w, a.ro_w, a.ch_w,
               a.q, a.H, a.W, a.lo, a.hi, bt / a.q.n_users, bt % a.q.n_users,
               blockIdx.x, smem_raw);
}

template <typename T, bool kLp, bool kWide>
cudaError_t launch_iter(IterArgs<T> a, int b, cudaStream_t stream) {
  static KernelSetup setup[kMaxDevices];
  if (kUseMma<T> && !mma_fits(a.q)) return cudaErrorInvalidValue;
  if (!kUseMma<T> && !rows_fit(a.q)) return cudaErrorInvalidValue;
  {
    std::lock_guard<std::mutex> lock(setup_mutex());
    int dev = 0;
    DeviceSetup d;
    cudaError_t err = device_setup(&dev, &d);
    if (err != cudaSuccess) return err;
    if (!iter_tiles(&a.q, a.H, a.W, sizeof(T), kUseMma<T>, d.optin))
      return cudaErrorInvalidValue;
    err = allow_smem(cgnn_iter_kernel<T, kLp, kWide>, setup[dev], a.q.smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((a.W + a.q.w_tile - 1) / a.q.w_tile, b * a.q.n_users);
  cgnn_iter_kernel<T, kLp, kWide><<<grid, nrx::kThreads, a.q.smem, stream>>>(a);
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

// The arguments travel as one kernel parameter: within the 4 KB every
// toolkit accepts.
static_assert(sizeof(FullArgs<float>) <= 4096, "FullArgs exceeds 4 KB");

// Threads of a whole-CGNN block. The float32 instance holds the stack and
// the iteration tile in one kernel: at 512 threads (128 registers) and 384
// (168) it spilled, so it takes 256 (207 registers without a spill); its
// tile code reads blockDim.
template <typename T>
constexpr int kFullThreads = kUseMma<T> ? nrx::kThreads : 256;

template <typename T, bool kLp, bool kWide>
__global__ void __launch_bounds__(kFullThreads<T>) cgnn_full_kernel(FullArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int n_users = a.it[0].n_users;
  const int n_img = a.b * n_users;

  // Stage 0: the init stack, z0 -> state[0].
  const int tiles0 = (a.W + a.init_w_tile - 1) / a.init_w_tile;
  for (int item = blockIdx.x; item < n_img * tiles0; item += gridDim.x)
    nrx::stack_tile<T, kUseMma<T>, kLp ? nrx::kLp : nrx::kNormal, kWide>(
        a.z0, a.init_w, a.state[0], a.init, a.H, a.W, a.init_w_tile, a.lo, a.hi,
        item / tiles0, item % tiles0, smem_raw);

  // Stages 1..num_it: the iterations, the last one with both readouts.
  for (int i = 0; i < a.num_it; ++i) {
    grid.sync();  // the previous stage's state is complete
    const IterDesc& q = a.it[i];
    const T* src = a.state[i % 2];
    T* dst = q.readout ? a.llr : a.state[(i + 1) % 2];
    const int tiles = (a.W + q.w_tile - 1) / q.w_tile;
    for (int item = blockIdx.x; item < n_img * tiles; item += gridDim.x) {
      const int bt = item / tiles;
      iter_tile<T, kLp, kWide>(src, a.pe, a.act, dst, a.hh, a.agg_w[i], a.upd_w[i], a.ro_w,
                   a.ch_w, q, a.H, a.W, a.lo, a.hi, bt / n_users, bt % n_users,
                   item % tiles, smem_raw);
    }
  }
}

template <typename T, bool kLp, bool kWide>
cudaError_t launch_full(FullArgs<T>& a, cudaStream_t stream) {
  static KernelSetup setup[kMaxDevices];
  constexpr bool kMma = kUseMma<T>;
  if (kMma && !mma_fits(a.init)) return cudaErrorInvalidValue;
  if (!kMma && !nrx::rows_fit(a.init)) return cudaErrorInvalidValue;
  for (int i = 0; i < a.num_it; ++i) {
    if (kMma && !mma_fits(a.it[i])) return cudaErrorInvalidValue;
    if (!kMma && !rows_fit(a.it[i])) return cudaErrorInvalidValue;
  }
  int blocks = 0;
  size_t smem = 0;
  {
    std::lock_guard<std::mutex> lock(setup_mutex());
    int dev = 0;
    DeviceSetup d;
    cudaError_t err = device_setup(&dev, &d);
    if (err != cudaSuccess) return err;
    a.init_w_tile = nrx::stack_w_tile(a.init, a.H, a.W, sizeof(T), d.optin, kMma);
    if (a.init_w_tile < 1) return cudaErrorInvalidValue;
    smem = nrx::stack_smem(a.init, a.H, a.init_w_tile, sizeof(T), kMma);
    const int n_img = a.b * a.it[0].n_users;
    int items = n_img * ((a.W + a.init_w_tile - 1) / a.init_w_tile);
    for (int i = 0; i < a.num_it; ++i) {
      if (!iter_tiles(&a.it[i], a.H, a.W, sizeof(T), kMma, d.optin))
        return cudaErrorInvalidValue;
      if (a.it[i].smem > smem) smem = a.it[i].smem;
      const int n = n_img * ((a.W + a.it[i].w_tile - 1) / a.it[i].w_tile);
      if (n > items) items = n;
    }
    KernelSetup& k = setup[dev];
    err = allow_smem(cgnn_full_kernel<T, kLp, kWide>, k, smem);
    if (err != cudaSuccess) return err;
    if (k.per_sm == 0 || k.occ_smem != smem) {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cgnn_full_kernel<T, kLp, kWide>, kFullThreads<T>, smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      k.per_sm = per_sm;
      k.occ_smem = smem;
    }
    // every block resident at once, none without work in the widest stage
    blocks = k.per_sm * d.n_sm < items ? k.per_sm * d.n_sm : items;
  }
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)cgnn_full_kernel<T, kLp, kWide>,
                                                dim3(blocks), dim3(kFullThreads<T>),
                                                args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The entry points' bodies. kWide: this translation unit holds the wide
// instances (cgnn_iter_wide.cu, bf16 only); the other one forwards a
// bf16 launch with a product past nrx::kMmaRegK input channels there.
template <bool kWide>
int cgnn_iter_entry(const void* s, const void* pe, const void* act, void* out, void* out2,
                    const void* agg_w, const void* agg_dims, const void* upd_w, int n_layers,
                    const void* widths, const void* ro_w, const void* ro_dims,
                    const void* ch_w, const void* ch_dims, int dtype, int b, int t, int h,
                    int w, int d_s, int d_pe, int lo, int hi, int lp, void* stream);

template <bool kWide>
int cgnn_full_entry(const void* z0, const void* pe, const void* act, void* state_a,
                    void* state_b, void* llr, void* hh, const void* init_w, int n_init,
                    const void* init_widths, const void* agg_w, const void* agg_dims,
                    const void* upd_w, int n_upd, const void* upd_widths, const void* ro_w,
                    const void* ro_dims, const void* ch_w, const void* ch_dims, int num_it,
                    int dtype, int b, int t, int h, int w, int d_s, int d_pe, int lo, int hi,
                    int lp, void* stream);

}  // namespace

extern "C" {
// The wide instances' entry points (cgnn_iter_wide.cu): the arguments of
// nrx_cgnn_iter and nrx_cgnn_full, bfloat16 only.
int nrx_cgnn_iter_wide(const void* s, const void* pe, const void* act, void* out,
                       void* out2, const void* agg_w, const void* agg_dims,
                       const void* upd_w, int n_layers, const void* widths,
                       const void* ro_w, const void* ro_dims, const void* ch_w,
                       const void* ch_dims, int dtype, int b, int t, int h, int w,
                       int d_s, int d_pe, int lo, int hi, int lp, void* stream);
int nrx_cgnn_full_wide(const void* z0, const void* pe, const void* act, void* state_a,
                       void* state_b, void* llr, void* hh, const void* init_w,
                       int n_init, const void* init_widths, const void* agg_w,
                       const void* agg_dims, const void* upd_w, int n_upd,
                       const void* upd_widths, const void* ro_w, const void* ro_dims,
                       const void* ch_w, const void* ch_dims, int num_it, int dtype,
                       int b, int t, int h, int w, int d_s, int d_pe, int lo, int hi,
                       int lp, void* stream);
}  // extern "C"

namespace {

template <bool kWide>
int cgnn_iter_entry(const void* s, const void* pe, const void* act, void* out, void* out2,
                    const void* agg_w, const void* agg_dims, const void* upd_w, int n_layers,
                    const void* widths, const void* ro_w, const void* ro_dims,
                    const void* ch_w, const void* ch_dims, int dtype, int b, int t, int h,
                    int w, int d_s, int d_pe, int lo, int hi, int lp, void* stream) {
  if (b < 1 || (size_t)b * t > 65535 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if ((ro_w == nullptr) != (ro_dims == nullptr) || (ch_w == nullptr) != (ch_dims == nullptr) ||
      (ch_w != nullptr && ro_w == nullptr))
    return (int)cudaErrorInvalidValue;
  IterDesc q;
  if (!make_iter_desc(&q, t, d_s, d_pe, static_cast<const int*>(agg_dims), n_layers,
                      static_cast<const int*>(widths), static_cast<const int*>(ro_dims),
                      static_cast<const int*>(ch_dims), dtype == 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kWide) {
    if (dtype != 1 || !iter_wide(q)) return (int)cudaErrorInvalidValue;
  } else {
    if (dtype == 1 && iter_wide(q))
      return nrx_cgnn_iter_wide(s, pe, act, out, out2, agg_w, agg_dims, upd_w, n_layers,
                                widths, ro_w, ro_dims, ch_w, ch_dims, dtype, b, t, h, w, d_s,
                                d_pe, lo, hi, lp, stream);
    if (dtype == 0) {
      using T = float;
      IterArgs<T> a{static_cast<const T*>(s), static_cast<const T*>(pe),
                    static_cast<const float*>(act), static_cast<T*>(out),
                    static_cast<T*>(out2), static_cast<const T*>(agg_w),
                    static_cast<const T*>(upd_w), static_cast<const T*>(ro_w),
                    static_cast<const T*>(ch_w), q, h, w, lo, hi};
      return (int)launch_iter<T, false, false>(a, b, st);
    }
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    IterArgs<T> a{static_cast<const T*>(s), static_cast<const T*>(pe),
                  static_cast<const float*>(act), static_cast<T*>(out),
                  static_cast<T*>(out2), static_cast<const T*>(agg_w),
                  static_cast<const T*>(upd_w), static_cast<const T*>(ro_w),
                  static_cast<const T*>(ch_w), q, h, w, lo, hi};
    return lp ? (int)launch_iter<T, true, kWide>(a, b, st)
              : (int)launch_iter<T, false, kWide>(a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kWide>
int cgnn_full_entry(const void* z0, const void* pe, const void* act, void* state_a,
                    void* state_b, void* llr, void* hh, const void* init_w, int n_init,
                    const void* init_widths, const void* agg_w, const void* agg_dims,
                    const void* upd_w, int n_upd, const void* upd_widths, const void* ro_w,
                    const void* ro_dims, const void* ch_w, const void* ch_dims, int num_it,
                    int dtype, int b, int t, int h, int w, int d_s, int d_pe, int lo, int hi,
                    int lp, void* stream) {
  if (num_it < 1 || num_it > kMaxIt || b < 1 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  StackDesc init;
  if (!nrx::make_stack_desc(n_init, static_cast<const int*>(init_widths), &init, false,
                            dtype == 1) ||
      init.widths[n_init] != d_s)
    return (int)cudaErrorInvalidValue;
  IterDesc it[kMaxIt];
  const int* ad = static_cast<const int*>(agg_dims);
  const int* uw = static_cast<const int*>(upd_widths);
  bool wide = nrx::stack_wide(init);
  for (int i = 0; i < num_it; ++i) {
    const bool last = i == num_it - 1;
    if (!make_iter_desc(&it[i], t, d_s, d_pe, ad + 3 * i, n_upd, uw + (n_upd + 1) * i,
                        last ? static_cast<const int*>(ro_dims) : nullptr,
                        last ? static_cast<const int*>(ch_dims) : nullptr, dtype == 1))
      return (int)cudaErrorInvalidValue;
    wide = wide || iter_wide(it[i]);
  }
  if constexpr (kWide) {
    if (dtype != 1 || !wide) return (int)cudaErrorInvalidValue;
  } else {
    if (dtype == 1 && wide)
      return nrx_cgnn_full_wide(z0, pe, act, state_a, state_b, llr, hh, init_w, n_init,
                                init_widths, agg_w, agg_dims, upd_w, n_upd, upd_widths, ro_w,
                                ro_dims, ch_w, ch_dims, num_it, dtype, b, t, h, w, d_s, d_pe,
                                lo, hi, lp, stream);
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
  if constexpr (!kWide) {
    if (dtype == 0) {
      FullArgs<float> a{};
      fill(&a);
      return (int)launch_full<float, false, false>(a, st);
    }
  }
  if (dtype == 1) {
    FullArgs<__nv_bfloat16> a{};
    fill(&a);
    return lp ? (int)launch_full<__nv_bfloat16, true, kWide>(a, st)
              : (int)launch_full<__nv_bfloat16, false, kWide>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#ifdef NRX_CGNN_WIDE

int nrx_cgnn_iter_wide(const void* s, const void* pe, const void* act, void* out,
                       void* out2, const void* agg_w, const void* agg_dims,
                       const void* upd_w, int n_layers, const void* widths,
                       const void* ro_w, const void* ro_dims, const void* ch_w,
                       const void* ch_dims, int dtype, int b, int t, int h, int w,
                       int d_s, int d_pe, int lo, int hi, int lp, void* stream) {
  return cgnn_iter_entry<true>(s, pe, act, out, out2, agg_w, agg_dims, upd_w, n_layers, widths,
                               ro_w, ro_dims, ch_w, ch_dims, dtype, b, t, h, w, d_s, d_pe, lo,
                               hi, lp, stream);
}

int nrx_cgnn_full_wide(const void* z0, const void* pe, const void* act, void* state_a,
                       void* state_b, void* llr, void* hh, const void* init_w,
                       int n_init, const void* init_widths, const void* agg_w,
                       const void* agg_dims, const void* upd_w, int n_upd,
                       const void* upd_widths, const void* ro_w, const void* ro_dims,
                       const void* ch_w, const void* ch_dims, int num_it, int dtype,
                       int b, int t, int h, int w, int d_s, int d_pe, int lo, int hi,
                       int lp, void* stream) {
  return cgnn_full_entry<true>(z0, pe, act, state_a, state_b, llr, hh, init_w, n_init,
                               init_widths, agg_w, agg_dims, upd_w, n_upd, upd_widths, ro_w,
                               ro_dims, ch_w, ch_dims, num_it, dtype, b, t, h, w, d_s, d_pe,
                               lo, hi, lp, stream);
}

#else

// One CGNN iteration (K3). s: [b, t, h, w, d_s]; pe: [t, h, w, d_pe]; both in
// the working type (dtype 0: float32, 1: bfloat16), contiguous. act: [b, t]
// float32 (1 = active). agg_w: packed aggregation MLP, agg_dims {in, hid,
// out}; upd_w: packed update stack, widths: n_layers + 1 ints (host). State
// mode (ro_w null): out [b, t, h, w, d_s]. Readout mode: out = llr [b, t, h,
// w, ro_dims[2]] and, if ch_w is given, out2 = h_hat [b, t, h, w,
// ch_dims[2]]. Dims arrays live on the host. In bfloat16 every packed
// weight buffer is followed by its products' B fragments (the wrapper's
// pack_mlp_mma / pack_stack_mma), and a product takes at most 256 input
// channels (past 128: the wide instances). lp: the stencil_lp mode
// (bfloat16; no effect in float32). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError().
int nrx_cgnn_iter(const void* s, const void* pe, const void* act, void* out,
                  void* out2, const void* agg_w, const void* agg_dims,
                  const void* upd_w, int n_layers, const void* widths,
                  const void* ro_w, const void* ro_dims, const void* ch_w,
                  const void* ch_dims, int dtype, int b, int t, int h, int w,
                  int d_s, int d_pe, int lo, int hi, int lp, void* stream) {
  return cgnn_iter_entry<false>(s, pe, act, out, out2, agg_w, agg_dims, upd_w, n_layers, widths,
                                ro_w, ro_dims, ch_w, ch_dims, dtype, b, t, h, w, d_s, d_pe, lo,
                                hi, lp, stream);
}

// The whole CGNN in one cooperative launch (K4). z0: [b, t, h, w,
// init_widths[0]]; pe: [t, h, w, d_pe]; act: [b, t] float32; state_a,
// state_b: scratch [b, t, h, w, d_s] each; llr: [b, t, h, w, ro_dims[2]];
// hh: [b, t, h, w, ch_dims[2]]. init_w: packed init stack (n_init layers,
// init_widths); agg_w, upd_w: host arrays of num_it device pointers to the
// packed aggregation MLPs and update stacks, agg_dims {in, hid, out} per
// iteration, upd_widths n_upd + 1 ints per iteration; ro_w, ch_w: packed
// readout MLPs, in bfloat16 each followed by its B fragments as for
// nrx_cgnn_iter. Host arrays for every dims argument. lp: the stencil_lp
// mode, as for nrx_cgnn_iter. Launches on `stream`, allocates nothing, does
// not synchronise; returns the launch's error.
int nrx_cgnn_full(const void* z0, const void* pe, const void* act, void* state_a,
                  void* state_b, void* llr, void* hh, const void* init_w,
                  int n_init, const void* init_widths, const void* agg_w,
                  const void* agg_dims, const void* upd_w, int n_upd,
                  const void* upd_widths, const void* ro_w, const void* ro_dims,
                  const void* ch_w, const void* ch_dims, int num_it, int dtype,
                  int b, int t, int h, int w, int d_s, int d_pe, int lo, int hi,
                  int lp, void* stream) {
  return cgnn_full_entry<false>(z0, pe, act, state_a, state_b, llr, hh, init_w, n_init,
                                init_widths, agg_w, agg_dims, upd_w, n_upd, upd_widths, ro_w,
                                ro_dims, ch_w, ch_dims, num_it, dtype, b, t, h, w, d_s, d_pe,
                                lo, hi, lp, stream);
}

#endif  // NRX_CGNN_WIDE

}  // extern "C"
