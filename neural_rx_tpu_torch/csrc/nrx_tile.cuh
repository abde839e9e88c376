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
//
// Two paths, chosen at compile time by the kMma template argument:
//   - CUDA cores (kMma false; every float32 tile): `pointwise_f32`, a
//     register-blocked FMA product (8 positions x 8 output channels a
//     thread, or 4 x 8 / 4 x 4 where tile_cost finds that cheaper) whose
//     weights reach shared memory as slabs copied by cp.async, one slab
//     ahead (from the wrapper's padded `cuda_core_rows`), and
//     `depthwise_f32`, one channel's taps in registers a thread, writing B
//     channel-major ([c][cm_ld]) for the stack's products to read along
//     the positions; the MLPs read their position-major rows along c (all
//     in 8-byte loads, see lds2).
//     Every sum keeps the first CUDA-core tile's order, fmaf over c = 0 ..
//     cin - 1 from 0.f (and the taps' multiply-then-add order), so every
//     float32 output is that tile's, bit for bit.
//     Bound: operations at the CUDA cores' 67 TFLOP/s; what holds them
//     under it is shared-memory bandwidth (a load delivers its bytes to
//     every lane, however few addresses the lanes read: an 8 x 8 tile
//     loads a byte per FMA, as many as the SM's 128 FMAs a cycle can take
//     from its 128 bytes a cycle, and the tile measures about half that).
//   - tensor cores (kMma true; every bf16 tile: the stack kernel's and the
//     CGNN kernels'):
//     `pointwise_mma`, mma.sync m16n8k16 bf16 x bf16 -> f32, and
//     `depthwise_pairs`. The products are exact and sum in f32, 16 input
//     channels per k-step in the tensor core's order, so a sum may differ
//     from the in-order FMA sum in its last f32 bits; the few sums that lie
//     so close to a bf16 rounding boundary that this could change the
//     rounded output are summed again in order (see pointwise_mma). The
//     depthwise taps round exactly as on the CUDA-core path. Rows are
//     `row_ld(c, true)` elements apart (see there). A product of more than
//     kMmaRegK input channels takes the kWide instances, whose k-steps past
//     kMmaWideRegK stream their weights from L2 (see pointwise_mma).
//
// Three layer modes, chosen at compile time by the kMode template argument
// (the JAX package's `mxu` and `lp_stencil` arguments of _run_stack):
//   - kNormal: the depthwise step, then the product, as above;
//   - kLp (bf16 tiles only; a no-op in float32, where the host takes
//     kNormal): the depthwise taps summed in bf16, each product and each
//     partial sum rounded to bf16 (`depthwise_pairs<true>`: packed bf16x2
//     mul.rn / add.rn, never a fused multiply-add);
//   - kFold (the stack kernel only): no depthwise step; the layer is one
//     product over the nine shifted copies of its input with the folded
//     weights W_s = round(dw_s[:, None] * pw), each tap's sum in f32 and
//     added to the sum of the earlier taps in tap order (`folded_mma`,
//     `folded_fma`). Its layers ping-pong between A and B.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace nrx {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 512;
constexpr int kMaxTile = 64;
// Tensor-core path: a warp holds the weights of one n8 tile (8 output
// channels) for all k-steps of a layer in registers (8 k-steps x 2 = 16
// registers; more, with the rest of a CGNN tile, spill under
// __launch_bounds__(512)'s 128), for at most kMmaRegK input channels. A
// product of more (e2e_rt's 130-channel update stacks) runs in a kernel
// instance with kWide set, which holds the first kMmaWideRegK channels'
// k-steps in registers and streams the B fragments of the rest from device
// memory (L2) for each M tile (with the full kMmaRegK in registers, the
// whole-CGNN kernel's wide instance spilled); a product takes at most
// kMmaMaxK.
constexpr int kMmaRegK = 128;
constexpr int kMmaWideRegK = 64;
constexpr int kMmaMaxK = 256;

// Layer modes of a stack (see the header).
constexpr int kNormal = 0;
constexpr int kLp = 1;
constexpr int kFold = 2;

// Channel stride of an activation row in shared memory. CUDA cores: c
// rounded up to 4 (the MLPs read rows 4 channels at a time). Tensor cores: ldmatrix
// needs 16-byte row addresses, so c is rounded up to 8 elements, plus 8 more
// when that is an even number of 16-byte chunks: an odd chunk count puts the
// 8 rows of one ldmatrix phase in 8 different 16-byte bank groups (no
// conflicts). nrx_rt: 18 -> 24, 56 -> 56, 64 -> 72, 114 -> 120, 128 -> 136;
// e2e_rt: 10 -> 24, 130 -> 136.
__host__ __device__ constexpr int row_ld(int c, bool mma) {
  return !mma ? (c + 3) / 4 * 4
              : ((c + 7) / 8 % 2 == 0 ? (c + 7) / 8 * 8 + 8 : (c + 7) / 8 * 8);
}

// Row stride of an MLP's hidden layer in shared memory. On the CUDA cores a
// product reads 4 neighbouring rows at once (at one c): a stride of a
// multiple of 16 words would put them in fewer than four 16-byte bank
// groups, so it takes 4 more (nrx_rt: 64 -> 68, 128 -> 132). Tensor cores:
// row_ld.
__host__ __device__ constexpr int mlp_ld(int c, bool mma) {
  return mma ? row_ld(c, true) : row_ld(c, false) % 16 == 0 ? row_ld(c, false) + 4
                                                             : row_ld(c, false);
}

// The CUDA-core tile's depthwise output B is channel-major, [c][cm_ld(n)]
// for at most n positions: rows of a multiple of 8 floats (a thread's 8
// positions are read together; the rows' last group may read past n),
// plus 4, so a channel's row starts 16 bytes off the bank group of its
// neighbour's.
__host__ __device__ constexpr int cm_ld(int n) { return (n + 7) / 8 * 8 + 4; }

// A float32 product's weights as the CUDA-core tile reads them (the
// wrapper's `cuda_core_rows`): w [cin][cout], each row rows_ld(cout) values
// in two halves of OG = ceil(cout / 8) quads: quad og of half h holds
// channels o = og + (4 h + e) * OG, e < 4, zero past cout. A thread's 8
// channels og + j * OG are quad og of both halves, and 8 lanes on
// neighbouring og read 128 contiguous bytes (one shared-memory pass).
__host__ __device__ constexpr int rows_ld(int cout) { return (cout + 7) / 8 * 8; }

// Values of one product's B fragments in a packed buffer (the wrapper's
// `mma_fragments`): 16-wide slabs of output channels x 16-deep k-steps x 32
// lanes x 8 bf16.
__host__ __device__ inline int frag_size(int cin, int cout) {
  return (cout + 15) / 16 * ((cin + 15) / 16) * 32 * 8;
}

// A separable-conv stack in a packed weight buffer: per layer dw [9][c_in]
// (tap-major, ky * 3 + kx), pw [c_in][c_out], b [c_out]; then from the next
// multiple of 8 values each layer's pw as the products read it (frag_off):
// as B fragments in bf16 (the tensor-core path), as padded rows
// (rows_ld) in float32 (the CUDA-core path). In the folded mode frag_off[l]
// is instead where layer l's nine folded matrices W_s (tap-major) start: as
// B fragments (frag_size values each) in bf16, as rows [c_in][c_out] in
// float32 (the wrapper's pack_stack_folded).
struct StackDesc {
  int n_layers;
  int widths[kMaxLayers + 1];
  int dw_off[kMaxLayers];
  int pw_off[kMaxLayers];
  int b_off[kMaxLayers];
  int frag_off[kMaxLayers];
};

// A one-hidden-layer MLP in a packed buffer: w1 [in][hid], b1 [hid],
// w2 [hid][out], b2 [out]; then, from the next multiple of 8 values, w1 and
// w2 as the products read them (f1, f2): B fragments in bf16, padded rows
// in float32 (fragments false).
struct MlpDesc {
  int in, hid, out;
  int f1, f2;
};

inline MlpDesc make_mlp_desc(int in, int hid, int out, bool fragments = true) {
  const int f1 = (in * hid + hid + hid * out + out + 7) / 8 * 8;
  return MlpDesc{in, hid, out, f1,
                 f1 + (fragments ? frag_size(in, hid) : in * rows_ld(hid))};
}

inline bool make_stack_desc(int n_layers, const int* widths, StackDesc* d,
                            bool folded = false, bool fragments = true) {
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
  off = (off + 7) / 8 * 8;
  for (int l = 0; l < n_layers; ++l) {
    const int cin = d->widths[l], cout = d->widths[l + 1];
    d->frag_off[l] = off;
    off += fragments ? (folded ? 9 : 1) * frag_size(cin, cout)
                     : folded ? 9 * cin * cout : cin * rows_ld(cout);
  }
  return true;
}

// Whether a layer of the stack takes more than kMmaRegK input channels (the
// kWide instances on the tensor cores).
inline bool stack_wide(const StackDesc& d) {
  for (int l = 0; l < d.n_layers; ++l)
    if (d.widths[l] > kMmaRegK) return true;
  return false;
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

// Two floats from shared memory (8-byte aligned p) with one ld.shared.v2:
// on the H100 the float32 tile's products ran 1.5-2 % faster on 8-byte
// than on 16-byte loads of the same bytes, and slower on 4-byte ones
// (volatile keeps the compiler from merging pairs into 16-byte loads).
__device__ __forceinline__ void lds2(float& x, float& y, const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(a));
}

// kN floats from p in shared memory (8-byte aligned; kN even).
template <int kN>
__device__ __forceinline__ void lds_vec(float (&v)[kN], const float* p) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) lds2(v[2 * i], v[2 * i + 1], p + 2 * i);
}

// kN / 4 quads of floats from shared memory, stride floats apart.
template <int kN>
__device__ __forceinline__ void lds_quads(float (&v)[kN], const float* p, int stride) {
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    lds2(v[4 * i], v[4 * i + 1], p + i * stride);
    lds2(v[4 * i + 2], v[4 * i + 3], p + i * stride + 2);
  }
}

// Lanes of a warp along the output slots of a float32 product (see
// fma_tiles): 8, or fewer for a product of fewer slots; the rest of the
// warp's 32 lanes go along position groups.
__device__ __forceinline__ int slot_lanes(int slots) {
  return slots >= 8 ? 8 : slots > 2 ? (slots > 4 ? 8 : 4) : slots;
}

// The float32 products' weight slabs: three stages of kSlabFloats floats
// at the end of the block's dynamic shared memory (the tile sizes leave
// them free: stack_smem, iter_layout). Three, so that the copy of slab g + 1
// (into the stage slab g - 2 used) needs only the barrier before slab g.
constexpr int kSlabFloats = 8 * 128;
constexpr int kStages = 3;
constexpr size_t kStageBytes = kStages * kSlabFloats * sizeof(float);
// The most output channels of a float32 product: a slab holds at least 4
// rows of rows_ld(cout) floats.
constexpr int kRowsMaxN = kSlabFloats / 4;

extern __shared__ __align__(16) unsigned char nrx_dyn_smem[];

__device__ __forceinline__ float* stage_slabs() {
  unsigned n;
  asm("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(n));
  return reinterpret_cast<float*>(nrx_dyn_smem + n - kStageBytes);
}

// 16 bytes from device to shared memory, asynchronously (cp.async, past L1).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Rows of n floats (n a multiple of 4) from device to shared memory with
// cp.async, as one commit group: dst[r * ld + c] = row(r)[c] for r < rows,
// c < n, zeros where row(r) is null (any: a valid device address for
// those). dst, ld and every row 16-byte aligned. The caller waits.
template <typename RowFn>
__device__ __forceinline__ void copy_rows_f32(float* dst, int ld, int rows, int n,
                                              const float* any, RowFn row) {
  const int cpr = n / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int c = (i - r * cpr) * 4;
    const float* sp = row(r);
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + (size_t)r * ld + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(sp ? sp + c : any), "r"(sp ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Rows a weight slab of a product of cout output channels holds: as many
// as fit a stage, a multiple of 4 (at least 4: cout <= kRowsMaxN).
__device__ __forceinline__ int slab_rows(int cout) {
  return max(kSlabFloats / rows_ld(cout) / 4 * 4, 4);
}

// The whole block copies slab g of w (a product of cin x cout; rows
// [c0, c0 + kr) with c0 = (g % n_slabs) * kr, the slab counter running on
// over a product's rounds) into stage g % kStages with cp.async, as one
// commit group.
__device__ __forceinline__ void copy_slab(const float* __restrict__ w, int cin, int cout,
                                          int g) {
  const int kr = slab_rows(cout);
  const int ldw = rows_ld(cout);
  const int c0 = g % ((cin + kr - 1) / kr) * kr;
  const int n4 = min(kr, cin - c0) * ldw / 4;
  const float* src = w + (size_t)c0 * ldw;
  float* dst = stage_slabs() + g % kStages * kSlabFloats;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// One float32 product in register tiles of kQ positions x kO output
// channels a thread (see pointwise_f32). A tile is (position group qg, slot
// s): with kO = 8 slot s is group og = s, channels o = og + j * OG (both
// halves' quad og of the rows, see rows_ld); with kO = 4 it is quad og = s
// % OG of half s / OG. A warp takes a block of tiles, slot_lanes(slots)
// slots x the rest in position groups: a quarter-warp's lanes share their
// position group and read neighbouring quads of weights (no bank
// conflict); its stores of one (k, j) go to neighbouring channels.
// Channel-major (kCm): the tile's positions are qg * kQ + k, read at one c.
// Position-major: qg + k * QG (neighbouring lanes on neighbouring rows), c
// .. c + 3 of each, rows past Q clamped to Q - 1. Lanes past the last group or
// slot compute on clamped ones and store nothing.
//
// The weights reach the block as slabs of slab_rows(cout) rows: the warps
// go round the tiles in rounds (a warp with no tile in the last round
// still copies and waits), each round walking all slabs; while the warps
// multiply one slab from its stage, every thread copies its share of the
// next one (the next round's first, after a round's last) into the next
// stage with cp.async, behind one barrier a slab. primed: slab 0 is
// already on its way (copy_slab(w, cin, cout, 0), before work that hides
// it, after a barrier that freed the stages); next (if not null): the
// weights of the product that follows (next_cin x next_cout), whose slab 0
// is sent for, after a barrier, before the last round's epilogue.
template <int kQ, int kO, bool kCm, typename Epi>
__device__ __forceinline__ void fma_tiles(const float* src, int ld, int Q,
                                          const float* __restrict__ w, int cin, int cout,
                                          bool primed, const Epi& epi, const float* next,
                                          int next_cin, int next_cout) {
  constexpr int kSlots = 8 / kO;  // slots of a group of 8 channels
  const int og_n = (cout + 7) / 8;
  const int slots = og_n * kSlots;
  const int qg_n = (Q + kQ - 1) / kQ;
  const int ldw = rows_ld(cout);
  const int ws = slot_lanes(slots);
  const int wq = 32 / ws;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int ts_n = (slots + ws - 1) / ws;
  const int n_tiles = (qg_n + wq - 1) / wq * ts_n;
  const int kr = slab_rows(cout);
  const int n_slabs = (cin + kr - 1) / kr;
  const int rounds = (n_tiles + n_warps - 1) / n_warps;
  const float* const stage = stage_slabs();
  if (!primed) copy_slab(w, cin, cout, 0);
  for (int r = 0; r < rounds; ++r) {
    const int t = r * n_warps + (threadIdx.x >> 5);
    const bool has = t < n_tiles;  // warp-uniform
    const int tc = min(t, n_tiles - 1);
    const int qg_l = (tc / ts_n) * wq + lane / ws;
    const int s_l = (tc % ts_n) * ws + lane % ws;
    const bool live = has && qg_l < qg_n && s_l < slots;
    const int qg = min(qg_l, qg_n - 1);
    const int s = min(s_l, slots - 1);
    const int og = s % og_n;
    const int j0 = s / og_n * 4;  // kO = 4: the half's first channel
    float acc[kQ][kO];
#pragma unroll
    for (int k = 0; k < kQ; ++k)
#pragma unroll
      for (int j = 0; j < kO; ++j) acc[k][j] = 0.f;
    int off[kCm ? 1 : kQ];  // position-major: the tile's rows
#pragma unroll
    for (int k = 0; k < (kCm ? 1 : kQ); ++k) off[k] = min(qg + k * qg_n, Q - 1) * ld;
    for (int sl = 0; sl < n_slabs; ++sl) {
      const int g = r * n_slabs + sl;  // slab counter: stage g % kStages
      if (g + 1 < rounds * n_slabs) {
        copy_slab(w, cin, cout, g + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      const int c0 = sl * kr;
      const int c1 = min(c0 + kr, cin);
      // row c0, this slot's quad; kO = 8: the second half's 4 * OG on
      const float* wp = stage + g % kStages * kSlabFloats + (j0 / 4 * og_n + og) * 4;
      if (has) {
        if constexpr (kCm) {
          const float* ap = src + qg * kQ;
          // 8 x 8: one channel's loads in flight (a second's would spill)
#pragma unroll(kQ == 8 ? 1 : 2)
          for (int c = c0; c < c1; ++c) {
            float a[kQ], b[kO];
            lds_vec(a, ap + (size_t)c * ld);
            lds_quads(b, wp + (c - c0) * ldw, 4 * og_n);
#pragma unroll
            for (int k = 0; k < kQ; ++k)
#pragma unroll
              for (int j = 0; j < kO; ++j) acc[k][j] = fmaf(a[k], b[j], acc[k][j]);
          }
        } else {
          int c = c0;
          for (; c + 3 < c1; c += 4) {
            float a[kQ][4];
#pragma unroll
            for (int k = 0; k < kQ; ++k) lds_vec(a[k], src + off[k] + c);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              float b[kO];
              lds_quads(b, wp + (c + cc - c0) * ldw, 4 * og_n);
#pragma unroll
              for (int k = 0; k < kQ; ++k)
#pragma unroll
                for (int j = 0; j < kO; ++j) acc[k][j] = fmaf(a[k][cc], b[j], acc[k][j]);
            }
          }
          for (; c < c1; ++c) {
            float b[kO];
            lds_quads(b, wp + (c - c0) * ldw, 4 * og_n);
#pragma unroll
            for (int k = 0; k < kQ; ++k) {
              const float a = src[off[k] + c];
#pragma unroll
              for (int j = 0; j < kO; ++j) acc[k][j] = fmaf(a, b[j], acc[k][j]);
            }
          }
        }
      }
    }
    if (next != nullptr && r == rounds - 1) {
      __syncthreads();  // every stage is free
      copy_slab(next, next_cin, next_cout, 0);
    }
    if (!live) continue;
    // A tile whose positions and channels all exist stores without a test,
    // in one block, so what epi derives from p or o is derived once.
    const bool whole = (kCm ? qg * kQ + kQ <= Q : qg + (kQ - 1) * qg_n < Q) &&
                       og + (j0 + kO - 1) * og_n < cout;
    if (whole) {
#pragma unroll
      for (int k = 0; k < kQ; ++k)
#pragma unroll
        for (int j = 0; j < kO; ++j)
          epi(kCm ? qg * kQ + k : qg + k * qg_n, og + (j0 + j) * og_n, acc[k][j]);
      continue;
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int p = kCm ? qg * kQ + k : qg + k * qg_n;
      if (p >= Q) continue;
#pragma unroll
      for (int j = 0; j < kO; ++j) {
        const int o = og + (j0 + j) * og_n;
        if (o < cout) epi(p, o, acc[k][j]);
      }
    }
  }
}

// What a product in kq x ko tiles costs the block, in cycles of one SM: per
// round of the block's warps and per slab, the larger of the FMAs of its
// busiest sub-partition (four of them) and the shared-memory cycles of all
// its warps (`wavefronts` a warp and channel: 128 bytes delivered take
// one, however few distinct addresses the lanes read), and
// at least the slab copy's latency that they hide (~700 cycles), plus a
// barrier.
__device__ __forceinline__ int tile_cost(int Q, int cin, int cout, int kq, int ko,
                                         int wavefronts) {
  const int slots = (cout + 7) / 8 * (8 / ko);
  const int ws = slot_lanes(slots);
  const int warps = ((Q + kq - 1) / kq + 32 / ws - 1) / (32 / ws) * ((slots + ws - 1) / ws);
  const int kr = slab_rows(cout);
  const int n_slabs = (cin + kr - 1) / kr;
  const int per_round = blockDim.x / 32;
  int cost = 0;
  for (int left = warps; left > 0; left -= per_round) {
    const int n = min(left, per_round);
    const int per_c = max((n + 3) / 4 * kq * ko, n * wavefronts);
    cost += n_slabs * (max(kr * per_c, 700) + 100);
  }
  return cost;
}

// y[p][o] = sum_c a(p, c) * w(c, o) for p < Q, o < cout, in f32, each sum
// fmaf over c = 0 .. cin - 1 in order from 0.f; epi(p, o, y) takes each sum.
// a(p, c) = src[c * ld + p] with kCm (channel-major: the stack's depthwise
// output; ld a multiple of 4 with room for Q rounded up to 8 positions,
// src 16-byte aligned), else src[p * ld + c] (position-major: the MLPs'
// rows; ld a multiple of 4, src 16-byte aligned). w: the product's rows
// (cout <= kRowsMaxN, 16-byte aligned) in device memory, staged
// through the block's slab stages (kStageBytes at the end of its dynamic
// shared memory; every thread must reach the call). primed: the caller has
// issued copy_slab(w, cin, cout, 0); next: see fma_tiles. Each thread holds a
// register tile, whichever tile_cost finds cheapest for Q, cin and cout:
// channel-major, 8 positions x 8 channels (64 bytes loaded for 64 FMAs) or
// 4 x 8; position-major, 4 x 8 or 4 x 4. The caller synchronises.
template <bool kCm, typename Epi>
__device__ __forceinline__ void pointwise_f32(const float* src, int ld, int Q,
                                              const float* __restrict__ w, int cin, int cout,
                                              const Epi& epi, bool primed = false,
                                              const float* next = nullptr, int next_cin = 0,
                                              int next_cout = 0) {
  // wavefronts a warp and channel: (kq + ko) floats x 32 lanes / 128 bytes
  const int c48 = tile_cost(Q, cin, cout, 4, 8, 12);
  if constexpr (kCm) {
    // channel-major inputs (the stacks' products): 8 x 8 or 4 x 8 (4 x 4
    // tiles load more bytes a FMA and never won at nrx_rt's widths)
    if (tile_cost(Q, cin, cout, 8, 8, 16) <= c48) {
      fma_tiles<8, 8, true>(src, ld, Q, w, cin, cout, primed, epi, next, next_cin, next_cout);
    } else {
      fma_tiles<4, 8, true>(src, ld, Q, w, cin, cout, primed, epi, next, next_cin, next_cout);
    }
  } else if (c48 <= tile_cost(Q, cin, cout, 4, 4, 8)) {
    fma_tiles<4, 8, false>(src, ld, Q, w, cin, cout, primed, epi, next, next_cin, next_cout);
  } else {
    fma_tiles<4, 4, false>(src, ld, Q, w, cin, cout, primed, epi, next, next_cin, next_cout);
  }
}

// The four 8x8 bf16 matrices of an m16k16 A fragment, one 16-byte row
// address a lane (shared memory).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* row) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// 8 read-only bytes at p + kOff bytes, the offset an immediate of the load
// (so the compiler keeps one base register, not one address a k-step).
template <int kOff>
__device__ __forceinline__ uint2 ldg_at(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2+%3];\n"
               : "=r"(v.x), "=r"(v.y)
               : "l"(p), "n"(kOff));
  return v;
}

// b[s][hf] of one n8 tile for s < steps (p: this lane's half of its first
// 16-byte fragment word, the next k-step's 512 bytes on), zeros past steps.
template <int kS, int kSteps>
__device__ __forceinline__ void load_fragments(uint32_t (&b)[kSteps][2], const uint2* p,
                                               int steps) {
  if constexpr (kS < kSteps) {
    const uint2 v = kS < steps ? ldg_at<kS * 32 * 16>(p) : make_uint2(0, 0);
    b[kS][0] = v.x;
    b[kS][1] = v.y;
    load_fragments<kS + 1, kSteps>(b, p, steps);
  }
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor-core path's re-sum lists, at the start of a block's dynamic
// shared memory: kFixPerWarp 2-byte entries (p * 16 + column in the
// 16-wide slab of the warp's n8 tile) for each warp; a warp queues at most
// 32 at a time and empties its list to under 32 entries, so it never holds
// more than 63. kMmaEta: the bound on |tensor-core sum - in-order sum| as a
// share of S = sum_c |a_c w_c|. The in-order f32 sum's rounding errors add
// as a random walk, ~2^-24 S; its worst case for 128 terms is 2^-17 S; the
// tensor core's own rounding is not documented. 2^-20 kept every output of
// nrx_rt bit-identical to the plain version on the H100 (PERF.md); a
// product of more than kMmaRegK input channels (more terms, more k-steps)
// takes twice that, kMmaEtaWide.
constexpr int kFixPerWarp = 64;
constexpr int kFixBytes = kThreads / 32 * kFixPerWarp * 2;
constexpr float kMmaEta = 1.0f / 1048576.0f;     // 2^-20
constexpr float kMmaEtaWide = 1.0f / 524288.0f;  // 2^-19
// positions a tile may hold: p * 16 + column fits an entry
constexpr int kMmaMaxP = 4096;

struct FixList {
  uint16_t* base;  // warp w's list at base + w * kFixPerWarp
};

__device__ __forceinline__ FixList fix_list(unsigned char* smem) {
  return FixList{reinterpret_cast<uint16_t*>(smem)};
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Whether y and every sum within d of it give one bf16 value of y + b: the
// ends of [y - d, y + d], rounded outwards, plus b, round to one bf16 (the
// f32 add and the bf16 rounding are monotone, and so is a ReLU after them).
// If so, *v is that value. Branch-free: every test is evaluated.
__device__ __forceinline__ bool certify(float y, float d, float b, __nv_bfloat16* v) {
  const float lo = __fadd_rn(__fsub_rd(y, d), b);
  const float hi = __fadd_rn(__fadd_ru(y, d), b);
  *v = __float2bfloat16_rn(lo);
  const bool same =
      __bfloat16_as_ushort(*v) == __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return same & (fabsf(y) < INFINITY) & (d < INFINITY);
}

// ReLU of a rounded value, as max(y, 0) before the rounding gives it: NaN
// passes, a negative value (also one that rounded to -0) becomes +0.
__device__ __forceinline__ __nv_bfloat16 relu_bf16(__nv_bfloat16 v) {
  const unsigned short b = __bfloat16_as_ushort(v);
  return (b & 0x8000u) && (b & 0x7fffu) <= 0x7f80u ? __ushort_as_bfloat16(0) : v;
}

// Epilogues. A product hands each output to an epilogue object: on the CUDA
// cores as epi(p, o, y), y the f32 sum before the bias; on the tensor cores
// per row, r = epi.row(p), then epi.put(r, o, v) or epi.put2(r, o, v0, v1)
// (o even, o + 1 < cout) with v = y + bias[o] rounded to bf16, the value
// epi(p, o, y) rounds before any ReLU. Both forms store the same.

// A stack layer: A [h][col][ld] = y + bias, ReLU on hidden layers, zero
// outside the valid columns [vlo, vhi) (grid column g0 + col).
template <typename T>
struct StackEpi {
  T* buf_a;
  const T* bias;
  int E, wl, c_lo, g0, vlo, vhi, ld;
  bool relu;
  __device__ void operator()(int p, int o, float y) const {
    const int h = p / wl;
    const int col = c_lo + p % wl;
    const int g = g0 + col;
    y += to_f(bias[o]);
    if (relu && y < 0.f) y = 0.f;  // NaN passes, as max(y, 0) does
    buf_a[((size_t)h * E + col) * ld + o] =
        (g >= vlo && g < vhi) ? from_f<T>(y) : from_f<T>(0.f);
  }
  struct Row {
    T* dst;
    bool valid;
  };
  __device__ Row row(int p) const {
    const int h = p / wl;
    const int col = c_lo + p % wl;
    const int g = g0 + col;
    return Row{buf_a + ((size_t)h * E + col) * ld, g >= vlo && g < vhi};
  }
  __device__ __nv_bfloat16 value(const Row& r, __nv_bfloat16 v) const {
    return !r.valid ? __ushort_as_bfloat16(0) : relu ? relu_bf16(v) : v;
  }
  __device__ void put(const Row& r, int o, __nv_bfloat16 v) const { r.dst[o] = value(r, v); }
  __device__ void put2(const Row& r, int o, __nv_bfloat16 v0, __nv_bfloat16 v1) const {
    *reinterpret_cast<__nv_bfloat162*>(r.dst + o) =
        __halves2bfloat162(value(r, v0), value(r, v1));
  }
};

// The hidden layer of an MLP: hid [p][ld] = max(y + bias, 0).
template <typename T>
struct HiddenEpi {
  T* hid;
  const T* bias;
  int ld;
  __device__ void operator()(int p, int o, float y) const {
    y += to_f(bias[o]);
    if (y < 0.f) y = 0.f;  // NaN passes, as max(y, 0) does
    hid[(size_t)p * ld + o] = from_f<T>(y);
  }
  using Row = T*;
  __device__ Row row(int p) const { return hid + (size_t)p * ld; }
  __device__ void put(Row r, int o, __nv_bfloat16 v) const { r[o] = relu_bf16(v); }
  __device__ void put2(Row r, int o, __nv_bfloat16 v0, __nv_bfloat16 v1) const {
    *reinterpret_cast<__nv_bfloat162*>(r + o) = __halves2bfloat162(relu_bf16(v0), relu_bf16(v1));
  }
};

// One M tile's sums on the tensor cores to epi: this lane's C fragment
// (rows m0 + g and m0 + g + 8, columns o and o + 1) with the error bounds
// eta * mag; each rounded value that the bound certifies goes to the
// epilogue. Returns the uncertified ones: bit r for C register r.
template <typename Epi>
__device__ __forceinline__ uint32_t certify_tile(const float (&acc)[4], const float (&mag)[4],
                                                 float eta, int m0, int P, int o, int cout,
                                                 const __nv_bfloat16* __restrict__ bias,
                                                 const Epi& epi) {
  const int g = (threadIdx.x & 31) >> 2;
  uint32_t need = 0;
  if (o >= cout) return 0;
  const float b0 = to_f(bias[o]);
  const float b1 = o + 1 < cout ? to_f(bias[o + 1]) : 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = m0 + g + 8 * hf;
    if (p >= P) continue;
    const int r = 2 * hf;
    __nv_bfloat16 v0, v1;
    const bool ok0 = certify(acc[r], eta * mag[r], b0, &v0);
    const bool ok1 = certify(acc[r + 1], eta * mag[r + 1], b1, &v1) & (o + 1 < cout);
    const typename Epi::Row rw = epi.row(p);
    if (ok0 && ok1) {
      epi.put2(rw, o, v0, v1);
    } else {
      if (ok0) epi.put(rw, o, v0);
      else need |= 1u << r;
      if (ok1) epi.put(rw, o + 1, v1);
      else if (o + 1 < cout) need |= 1u << (r + 1);
    }
  }
  return need;
}

// Queues the lane's flagged outputs of the M tile at m0 (need: bit r for C
// register r, column o of the 16-wide slab at n_base) in the warp's list,
// one a lane and round, and re-sums whenever 32 are queued; with done (and
// need 0: no tile) the rest. resum(top, n) sums list[top - n, top) again.
// Warp-uniform.
template <typename Resum>
__device__ __forceinline__ void queue_resum(uint32_t need, int m0, int o, int n_base,
                                            bool done, uint16_t* list, int& pending,
                                            Resum& resum) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  for (;;) {
    const unsigned ballot = __ballot_sync(0xffffffffu, need != 0);
    if (ballot == 0 && !(done && pending > 0)) break;
    if (need != 0) {
      const int r = __ffs(need) - 1;
      need &= need - 1;
      const int p = m0 + g + (r >> 1) * 8;
      list[pending + __popc(ballot & ((1u << lane) - 1))] =
          (uint16_t)(p * 16 + o - n_base + (r & 1));
    }
    pending += __popc(ballot);
    if (pending >= 32 || (done && ballot == 0)) {
      const int n = min(pending, 32);
      resum(pending, n);
      pending -= n;
    }
  }
}

// In-order f32 sum from acc of a[k] * w[k][column] over k < cin: a, a row
// in shared memory; col, the column's 8-byte word in the lanes 4g..4g+3 of
// the fragments of k-step 0 (see pointwise_mma's resum).
__device__ __forceinline__ float column_sum(float acc, const __nv_bfloat16* a,
                                           const uint2* __restrict__ col, int cin) {
  const int steps = (cin + 15) / 16;
  for (int s = 0; s < steps; ++s) {
    uint2 v[4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) v[qq] = __ldg(col + 2 * (s * 32 + qq));
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int k = 16 * s + 8 * hf + 2 * qq;
        const uint32_t wv = hf ? v[qq].y : v[qq].x;
        const uint32_t av = *reinterpret_cast<const uint32_t*>(a + k);
        if (k < cin) acc = fmaf(bf16_lo(av), bf16_lo(wv), acc);
        if (k + 1 < cin) acc = fmaf(bf16_hi(av), bf16_hi(wv), acc);
      }
  }
  return acc;
}

// The A fragments of k-step s of one M tile (row: this lane's ldmatrix row
// address), the lanes of the last k-step past cin zeroed in registers
// (pad lanes, or the next row's first channels: nothing in them reaches a
// sum, 0 x NaN), and their magnitudes.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t (&a_abs)[4],
                                       const __nv_bfloat16* row, int s, int steps, int cin) {
  const int q = threadIdx.x & 3;
  ldmatrix_x4(a, row + 16 * s);
  if (s == steps - 1) {
    // k = 16 s + {0, 0, 8, 8}[r] + 2q and k + 1: low and high half
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 16 * s + (r >> 1) * 8 + 2 * q;
      a[r] &= (k < cin ? 0xffffu : 0u) | (k + 1 < cin ? 0xffff0000u : 0u);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) a_abs[r] = a[r] & 0x7fff7fffu;  // clears both signs
}

// The contract of `pointwise_f32` on the tensor cores, with the same rounded
// results: y[p][o] = sum_c src[p * stride + c] * w[c * cout + o] for p < P,
// o < cout, handed to epi per row as bf16(y + bias[o]) (see the
// epilogues). src in shared memory, 16-byte aligned, stride a multiple of 8
// (row_ld); wf: w as B fragments (frag_size values, 16-byte aligned) and
// bias, in device memory; cin <= kMmaRegK, or with kWide cin <= kMmaMaxK;
// P <= kMmaMaxP; fx: the block's re-sum lists (warp w's at fx.base + w *
// kFixPerWarp). The caller synchronises.
//
// Each warp takes an n8 tile of output channels, loads its B fragments into
// registers once (K padded to a multiple of 16 and N to 16 with zeros, in
// the packed layout; one 8-byte load a lane and k-step), then walks 16-row M
// tiles, loading their A fragments with ldmatrix. Rows past P re-read row P
// - 1 and are dropped. The lanes of the last k-step past cin (pad lanes, or
// the next row's first channels) are zeroed in registers, so nothing in
// them reaches a sum (0 x NaN); a row is read at most 8 elements past c =
// cin. Beside each sum a second product on |a| and |w| gives S = sum_c |a_c
// w_c|. The tensor cores add 16 products at a time in their own order, so
// their y may differ from the in-order f32 sum in its last bits; where y +
// bias lies within kMmaEta * S of a bf16 rounding boundary, (p, o) goes to
// the warp's list, and 32 at a time the warp sums them again in order, one
// a lane, reading the weight column from wf. So the rounded outputs are
// those of the in-order sums and of the plain version, not one ulp off.
//
// kWide (the instances for cin up to kMmaMaxK): the first kMmaWideRegK
// channels' k-steps as above, then per M tile each further k-step's B
// fragment from wf (one 8-byte load a lane, from L2), into the same
// accumulators and magnitude sums, so the bound (kMmaEtaWide past kMmaRegK
// channels) and the in-order re-sum cover the whole of K.
template <bool kWide = false, typename Epi>
__device__ __forceinline__ void pointwise_mma(const __nv_bfloat16* src, int stride, int P,
                                              const __nv_bfloat16* __restrict__ wf,
                                              const __nv_bfloat16* __restrict__ bias,
                                              int cin, int cout, FixList fx, Epi epi) {
  constexpr int kSteps = (kWide ? kMmaWideRegK : kMmaRegK) / 16;
  constexpr uint32_t kAbs = 0x7fff7fffu;  // clears both bf16 sign bits
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int q = lane & 3;   // pair of k (A, B) or of columns (C)
  const int steps = (cin + 15) / 16;
  const int n_tiles = (cout + 7) / 8;
  const int groups = n_tiles >= n_warps ? 1 : n_warps / n_tiles;
  const int m_tiles = (P + 15) / 16;
  const float eta = kWide && cin > kMmaRegK ? kMmaEtaWide : kMmaEta;
  uint16_t* list = fx.base + warp * kFixPerWarp;
  for (int unit = warp; unit < n_tiles * groups; unit += n_warps) {
    const int nt = unit % n_tiles;
    const int o0 = 8 * nt;          // first column of the tile
    const int n_base = o0 & ~15;    // first column of its 16-wide slab
    // the slab's fragments: [k-step][lane] of 16 bytes, the tile's half
    // (j = nt & 1) of each
    const uint2* frag = reinterpret_cast<const uint2*>(
        reinterpret_cast<const uint4*>(wf) + (size_t)(nt >> 1) * steps * 32);
    uint32_t b[kSteps][2];
    load_fragments<0, kSteps>(b, frag + 2 * lane + (nt & 1), steps);

    // The in-order sums of the n (<= 32) entries list[top - n, top), one a
    // lane, through epi. Warp-uniform.
    auto resum = [&](int top, int n) {
      __syncwarp();
      if (lane < n) {
        const int e = list[top - n + lane];
        const int p = e >> 4;
        const int o = n_base + (e & 15);
        // column e & 15: bit 3 picks the half of the 16-byte words of the
        // lanes 4g..4g+3 (g = e & 7), whose (x, y) hold k = 16 s + 2 qq
        // (+1) and 16 s + 8 + 2 qq (+1)
        const float acc =
            column_sum(0.f, src + (size_t)p * stride, frag + (e & 7) * 8 + ((e >> 3) & 1), cin);
        epi.put(epi.row(p), o, __float2bfloat16_rn(acc + to_f(bias[o])));
      }
      __syncwarp();
    };

    // One pass per M tile, and one more with no tile that empties the list.
    const int o = o0 + 2 * q;  // this lane's columns o and o + 1
    int pending = 0;           // entries in the warp's list
    for (int mt = unit / n_tiles;; mt += groups) {
      const bool done = mt >= m_tiles;
      const int m0 = 16 * mt;
      uint32_t need = 0;  // bit r: this lane's C register r needs the re-sum
      if (!done) {
        // ldmatrix.x4: lanes 0-15 address rows 0-15 at k 0, lanes 16-31 at k 8
        const __nv_bfloat16* row =
            src + (size_t)min(m0 + (lane & 15), P - 1) * stride + (lane >> 4) * 8;
        float acc[4] = {0.f, 0.f, 0.f, 0.f}, mag[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          if (s >= steps) break;
          uint32_t a[4], a_abs[4];
          load_a(a, a_abs, row, s, steps, cin);
          const uint32_t b_abs[2] = {b[s][0] & kAbs, b[s][1] & kAbs};
          mma_bf16(acc, a, b[s]);
          mma_bf16(mag, a_abs, b_abs);
        }
        if constexpr (kWide) {
          // the k-steps past the registers' (k-step s's words 64 s on)
          const uint2* bs = frag + 2 * lane + (nt & 1);
#pragma unroll 1
          for (int s = kSteps; s < steps; ++s) {
            const uint2 v = __ldg(bs + (size_t)s * 64);
            const uint32_t bw[2] = {v.x, v.y};
            const uint32_t b_abs[2] = {v.x & kAbs, v.y & kAbs};
            uint32_t a[4], a_abs[4];
            load_a(a, a_abs, row, s, steps, cin);
            mma_bf16(acc, a, bw);
            mma_bf16(mag, a_abs, b_abs);
          }
        }
        // C fragment: rows g and g + 8 (hf), columns o and o + 1 (registers
        // 2 hf and 2 hf + 1)
        need = certify_tile(acc, mag, eta, m0, P, o, cout, bias, epi);
      }
      // queue the flagged (p, o); re-sum whenever 32 are queued, and the
      // rest after the last tile
      queue_resum(need, m0, o, n_base, done, list, pending, resum);
      if (done) break;
    }
  }
}

// The folded mode's bound on |tensor-core sum - in-order sum| as a share of
// S = sum_s sum_c |a_c w_c|: each tap's sum within kMmaEta of its own S_s
// (as pointwise_mma's), plus the nine f32 additions of the taps (each
// rounding half an ulp of a partial sum <= S, in both sums): 2^-20 + 9 x
// 2^-24 < 2^-18.
constexpr float kFoldEta = 1.0f / 262144.0f;  // 2^-18

// The folded mode's layer on the tensor cores: y[p][o] = sum over taps s =
// 3 (dy + 1) + (dx + 1) of sum_c a[h + dy][col + dx][c] * W_s[c][o] for
// positions p = h * wl + col - c_lo (wl columns from c_lo, H rows), rows
// h + dy outside [0, H) adding nothing; each tap's sum in f32, added to the
// sum of the earlier taps in tap order; handed to epi per row as bf16(y +
// bias[o]) as pointwise_mma does. a: [H][E][lda] in shared memory (columns
// c_lo - 1 .. c_lo + wl all in [0, E)); wf: the layer's nine fragment sets
// W_0..W_8, frag_size(cin, cout) values each; cin <= kMmaRegK (kWide: <=
// kMmaMaxK, its k-steps past kMmaWideRegK streamed as pointwise_mma's),
// H * wl <= kMmaMaxP. The caller synchronises.
//
// As pointwise_mma, with the A fragments of tap s loaded by ldmatrix from
// the shifted rows (a lane whose row falls outside [0, H) addresses a row
// inside and the owners of that fragment row zero it in registers, so it
// adds nothing). The nine taps' B fragments do not fit in registers: a warp
// streams them a tap at a time from device memory (L2) for kMt M tiles at
// once. Each tap's product runs from a zero accumulator and is added to the
// tile's f32 sum (FADD, in tap order); the magnitude product sums over all
// taps. Outputs within kFoldEta * S of a bf16 rounding boundary are summed
// again in order: per tap, over c in order from zero, then added to the sum
// of the earlier taps (the JAX package's _sepconv_mxu order).
template <bool kWide = false, typename Epi>
__device__ __forceinline__ void folded_mma(const __nv_bfloat16* a, int lda, int H, int E,
                                           int wl, int c_lo,
                                           const __nv_bfloat16* __restrict__ wf,
                                           const __nv_bfloat16* __restrict__ bias,
                                           int cin, int cout, FixList fx, Epi epi) {
  constexpr int kSteps = (kWide ? kMmaWideRegK : kMmaRegK) / 16;
  constexpr int kMt = 2;  // M tiles a pass over the taps' fragments
  constexpr uint32_t kAbs = 0x7fff7fffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int steps = (cin + 15) / 16;
  const int n_tiles = (cout + 7) / 8;
  const int groups = n_tiles >= n_warps ? 1 : n_warps / n_tiles;
  const int P = H * wl;
  const int m_tiles = (P + 15) / 16;
  // 8-byte words of one tap's fragment set
  const int tap_words = frag_size(cin, cout) / 4;
  uint16_t* list = fx.base + warp * kFixPerWarp;
  for (int unit = warp; unit < n_tiles * groups; unit += n_warps) {
    const int nt = unit % n_tiles;
    const int o0 = 8 * nt;
    const int n_base = o0 & ~15;
    const uint2* frag = reinterpret_cast<const uint2*>(
        reinterpret_cast<const uint4*>(wf) + (size_t)(nt >> 1) * steps * 32);

    // In-order sums of list[top - n, top): per tap in order, the sum over c
    // from zero, added to the earlier taps' sum. Warp-uniform.
    auto resum = [&](int top, int n) {
      __syncwarp();
      if (lane < n) {
        const int e = list[top - n + lane];
        const int p = e >> 4;
        const int o = n_base + (e & 15);
        const int h = p / wl;
        const int col = c_lo + p % wl;
        const uint2* colw = frag + (e & 7) * 8 + ((e >> 3) & 1);
        float y = 0.f;
        for (int s = 0; s < 9; ++s) {
          const int hh = h + s / 3 - 1;
          if (hh < 0 || hh >= H) continue;
          const float t = column_sum(0.f, a + ((size_t)hh * E + col + s % 3 - 1) * lda,
                                     colw + (size_t)s * tap_words, cin);
          y = __fadd_rn(y, t);
        }
        epi.put(epi.row(p), o, __float2bfloat16_rn(__fadd_rn(y, to_f(bias[o]))));
      }
      __syncwarp();
    };

    const int o = o0 + 2 * q;
    int pending = 0;
    for (int mt0 = unit / n_tiles;; mt0 += kMt * groups) {
      if (mt0 >= m_tiles) {
        queue_resum(0u, 0, o, n_base, true, list, pending, resum);
        break;
      }
      // per M tile j: this lane's ldmatrix row (buffer row h * E + col of
      // tap (1, 1), and its h), and the h of its fragment rows g and g + 8
      int base[kMt], h_l[kMt], h_g[kMt][2];
      float acc[kMt][4], mag[kMt][4];
#pragma unroll
      for (int j = 0; j < kMt; ++j) {
        const int m0 = 16 * (mt0 + j * groups);
        const int p = min(m0 + (lane & 15), P - 1);
        h_l[j] = p / wl;
        base[j] = h_l[j] * E + c_lo + p % wl;
        h_g[j][0] = min(m0 + g, P - 1) / wl;
        h_g[j][1] = min(m0 + g + 8, P - 1) / wl;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = mag[j][r] = 0.f;
      }
#pragma unroll 1
      for (int s = 0; s < 9; ++s) {
        const int dy = s / 3 - 1;
        const int dx = s % 3 - 1;
        uint32_t b[kSteps][2];
        load_fragments<0, kSteps>(b, frag + (size_t)s * tap_words + 2 * lane + (nt & 1),
                                  steps);
#pragma unroll
        for (int j = 0; j < kMt; ++j) {
          if (mt0 + j * groups >= m_tiles) break;  // warp-uniform
          const int hh = min(max(h_l[j] + dy, 0), H - 1);
          const __nv_bfloat16* row =
              a + (size_t)(base[j] + (hh - h_l[j]) * E + dx) * lda + (lane >> 4) * 8;
          // fragment registers 0, 2: row g; 1, 3: row g + 8
          const uint32_t keep0 = (unsigned)(h_g[j][0] + dy) < (unsigned)H ? ~0u : 0u;
          const uint32_t keep1 = (unsigned)(h_g[j][1] + dy) < (unsigned)H ? ~0u : 0u;
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int st = 0; st < kSteps; ++st) {
            if (st >= steps) break;
            uint32_t af[4], aa[4];
            load_a(af, aa, row, st, steps, cin);
            af[0] &= keep0;
            af[2] &= keep0;
            af[1] &= keep1;
            af[3] &= keep1;
            aa[0] &= keep0;
            aa[2] &= keep0;
            aa[1] &= keep1;
            aa[3] &= keep1;
            const uint32_t b_abs[2] = {b[st][0] & kAbs, b[st][1] & kAbs};
            mma_bf16(t, af, b[st]);
            mma_bf16(mag[j], aa, b_abs);
          }
          if constexpr (kWide) {
            // the tap's k-steps past the registers', from L2 per M tile
            const uint2* bs = frag + (size_t)s * tap_words + 2 * lane + (nt & 1);
#pragma unroll 1
            for (int st = kSteps; st < steps; ++st) {
              const uint2 v = __ldg(bs + (size_t)st * 64);
              const uint32_t bw[2] = {v.x, v.y};
              const uint32_t b_abs[2] = {v.x & kAbs, v.y & kAbs};
              uint32_t af[4], aa[4];
              load_a(af, aa, row, st, steps, cin);
              af[0] &= keep0;
              af[2] &= keep0;
              af[1] &= keep1;
              af[3] &= keep1;
              aa[0] &= keep0;
              aa[2] &= keep0;
              aa[1] &= keep1;
              aa[3] &= keep1;
              mma_bf16(t, af, bw);
              mma_bf16(mag[j], aa, b_abs);
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], t[r]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMt; ++j) {
        if (mt0 + j * groups >= m_tiles) break;
        const int m0 = 16 * (mt0 + j * groups);
        const uint32_t need = certify_tile(acc[j], mag[j], kFoldEta, m0, P, o, cout, bias, epi);
        queue_resum(need, m0, o, n_base, false, list, pending, resum);
      }
    }
  }
}

// The folded mode's layer on the CUDA cores (float32 tiles): the same
// function as folded_mma, each tap's sum over c in order with FMA from
// zero, added to the earlier taps' sum in tap order; epi(p, o, y) takes
// each sum before the bias. w: the layer's nine matrices W_s [cin][cout],
// tap-major. Each thread computes 4-position x 4-channel register tiles.
// The caller synchronises.
template <typename T, typename Epi>
__device__ __forceinline__ void folded_fma(const T* a, int lda, int H, int E, int wl,
                                           int c_lo, const T* __restrict__ w, int cin,
                                           int cout, Epi epi) {
  const int P = H * wl;
  const int G = (cout + 3) / 4;
  const int Q = (P + 3) / 4;
  for (int item = threadIdx.x; item < G * Q; item += blockDim.x) {
    const int o0 = (item % G) * 4;
    const int p0 = (item / G) * 4;
    int hk[4], ck[4], oc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = min(p0 + k, P - 1);
      hk[k] = p / wl;
      ck[k] = c_lo + p % wl;
      oc[k] = min(o0 + k, cout - 1);
    }
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
#pragma unroll 1
    for (int s = 0; s < 9; ++s) {
      const int dy = s / 3 - 1;
      const int dx = s % 3 - 1;
      const T* ar[4];
      bool ok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int hh = hk[k] + dy;
        ok[k] = hh >= 0 && hh < H;
        ar[k] = a + ((size_t)(ok[k] ? hh : hk[k]) * E + ck[k] + dx) * lda;
      }
      const T* ws = w + (size_t)s * cin * cout;
      float t[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) t[k][j] = 0.f;
      for (int c = 0; c < cin; ++c) {
        const T* wrow = ws + (size_t)c * cout;
        float av[4], bv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) av[k] = ok[k] ? to_f(ar[k][c]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f(wrow[oc[j]]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) t[k][j] = fmaf(av[k], bv[j], t[k][j]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = __fadd_rn(acc[k][j], t[k][j]);
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

// A product of position-major rows src [P][stride] on the chosen path: w
// [cin][cout] (the packed matrix, which neither path reads) and wf, the
// weights as the path reads them (B fragments, or float32 rows); the bias
// and fx on the tensor cores (see pointwise_mma; kWide: products past
// kMmaRegK input channels), primed and next on the CUDA cores (see
// pointwise_f32).
template <typename T, bool kMma, bool kWide = false, typename Epi>
__device__ __forceinline__ void product(const T* src, int stride, int P,
                                        const T* __restrict__ w,
                                        const T* __restrict__ wf,
                                        const T* __restrict__ bias, int cin, int cout,
                                        FixList fx, Epi epi, bool primed = false,
                                        const T* next = nullptr, int next_cin = 0,
                                        int next_cout = 0) {
  if constexpr (kMma) {
    static_assert(std::is_same<T, __nv_bfloat16>::value, "tensor cores: bf16 only");
    pointwise_mma<kWide>(src, stride, P, wf, bias, cin, cout, fx, epi);
  } else {
    static_assert(std::is_same<T, float>::value, "CUDA cores: float32 only");
    pointwise_f32<false>(src, stride, P, wf, cin, cout, epi, primed, next, next_cin, next_cout);
  }
}

// bf16x2 multiply and add, each correctly rounded (round to nearest even)
// and never contracted into a fused multiply-add: for bf16 operands the
// bits of "f32 op, then round to bf16", as the plain version computes.
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Depthwise step of the tensor-core path: A [h][col][lda] -> B [p][ldb],
// p = h * wl + col - c_lo, for cin <= 2 * blockDim.x. Each thread keeps one
// channel pair (c, c + 1) and its 9 taps in registers and walks pairs of
// adjacent output columns of one row, blockDim.x / pairs at a time: the two
// outputs share their 3 x 4 input pairs (32-bit loads; bf16 pairs stored as
// 32-bit words). Arithmetic as on the CUDA-core path: per output and channel
// an f32 sum from 0 in tap order, multiply then add, rounded once. kBf16Sum
// (the stencil_lp mode): the sum in bf16 from 0 in the same order, each product
// and each sum rounded, the two channels of a pair in one bf16x2 register.
// For odd cin the last pair's second lane is a pad lane (tap 0, value
// unused).
template <bool kBf16Sum = false>
__device__ __forceinline__ void depthwise_pairs(const __nv_bfloat16* a, __nv_bfloat16* b,
                                                const __nv_bfloat16* __restrict__ dw,
                                                int H, int E, int wl, int c_lo, int cin,
                                                int lda, int ldb) {
  const int pairs = (cin + 1) / 2;
  const int rows = blockDim.x / pairs;
  if ((int)threadIdx.x >= rows * pairs) return;
  const int c = 2 * (threadIdx.x % pairs);
  float k0[9], k1[9];
  uint32_t kp[9];  // kBf16Sum: the taps of (c, c + 1) as a bf16 pair
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const __nv_bfloat16 w0 = dw[t * cin + c];
    const __nv_bfloat16 w1 = c + 1 < cin ? dw[t * cin + c + 1] : __ushort_as_bfloat16(0);
    k0[t] = to_f(w0);
    k1[t] = to_f(w1);
    kp[t] = (uint32_t)__bfloat16_as_ushort(w0) | ((uint32_t)__bfloat16_as_ushort(w1) << 16);
  }
  const int wp = (wl + 1) / 2;  // column pairs a row
  for (int it = threadIdx.x / pairs; it < H * wp; it += rows) {
    const int h = it / wp;
    const int cc = 2 * (it - h * wp);  // first output column - c_lo
    const bool two = cc + 1 < wl;
    // acc[column][channel]; kBf16Sum: lp[column] (both channels)
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    uint32_t lp[2] = {0u, 0u};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      if (hh < 0 || hh >= H) continue;  // SAME zero padding in time
      const __nv_bfloat16* in = a + ((size_t)hh * E + c_lo + cc - 1) * lda + c;
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = 0;
        if (k < 3 || two) v[k] = *reinterpret_cast<const uint32_t*>(in + (size_t)k * lda);
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int t = dy * 3 + dx;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if constexpr (kBf16Sum) {
            lp[m] = bf16x2_add(lp[m], bf16x2_mul(v[dx + m], kp[t]));
          } else {
            acc[m][0] = __fadd_rn(acc[m][0], __fmul_rn(bf16_lo(v[dx + m]), k0[t]));
            acc[m][1] = __fadd_rn(acc[m][1], __fmul_rn(bf16_hi(v[dx + m]), k1[t]));
          }
        }
      }
    }
    uint32_t* out = reinterpret_cast<uint32_t*>(b + (size_t)(h * wl + cc) * ldb + c);
    if constexpr (kBf16Sum) {
      out[0] = lp[0];
      if (two) out[ldb / 2] = lp[1];
    } else {
      const __nv_bfloat162 r0 = __floats2bfloat162_rn(acc[0][0], acc[0][1]);
      const __nv_bfloat162 r1 = __floats2bfloat162_rn(acc[1][0], acc[1][1]);
      out[0] = *reinterpret_cast<const uint32_t*>(&r0);
      if (two) out[ldb / 2] = *reinterpret_cast<const uint32_t*>(&r1);
    }
  }
}

// Depthwise step of the CUDA-core path: A [h][col][lda] -> B [c][ldb]
// (channel-major), position p = h * wl + col - c_lo. Each thread keeps one
// channel's 9 taps in registers and walks runs of 4 positions (p a multiple
// of 4), blockDim.x / cin threads a channel (in blocks of blockDim.x
// channels), storing each run as one float4 (ldb a multiple of 4; the last
// run may write up to 3 positions past H * wl, inside the row's ldb, which
// no product output reads). A run
// inside one row shares its 3 x 6 inputs; one that crosses a row's end
// reads each output's own 3 x 3. Neighbouring lanes take neighbouring
// channels (conflict-free reads of A). Per output and channel an f32 sum
// from 0 in tap order, multiply then add, rows outside [0, H) skipped (SAME
// zero padding in time), as the plain version.
__device__ __forceinline__ void depthwise_f32(const float* a, float* b,
                                              const float* __restrict__ dw, int H, int E,
                                              int wl, int c_lo, int cin, int lda, int ldb) {
  const int P = H * wl;
  const int runs = (P + 3) / 4;
  for (int cb = 0; cb < cin; cb += blockDim.x) {
    const int nc = min(cin - cb, (int)blockDim.x);
    const int per_c = blockDim.x / nc;
    if ((int)threadIdx.x >= per_c * nc) continue;
    const int c = cb + threadIdx.x % nc;
    float k[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) k[t] = dw[t * cin + c];
    float* bc = b + (size_t)c * ldb;
    for (int r = threadIdx.x / nc; r < runs; r += per_c) {
      const int p0 = 4 * r;
      const int h = p0 / wl;
      const int cc = p0 - h * wl;  // first output column - c_lo
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (cc + 4 <= wl) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int hh = h + dy - 1;
          if (hh < 0 || hh >= H) continue;  // SAME zero padding in time
          const float* in = a + ((size_t)hh * E + c_lo + cc - 1) * lda + c;
          float v[6];
#pragma unroll
          for (int m = 0; m < 6; ++m) v[m] = in[(size_t)m * lda];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int m = 0; m < 4; ++m)
              acc[m] = __fadd_rn(acc[m], __fmul_rn(v[dx + m], k[dy * 3 + dx]));
        }
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = min(p0 + m, P - 1);  // past P: a copy of P - 1's
          const int hm = p / wl;
          const float* in = a + ((size_t)hm * E + c_lo + p - hm * wl - 1) * lda + c;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int hh = hm + dy - 1;
            if (hh < 0 || hh >= H) continue;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
              acc[m] = __fadd_rn(acc[m], __fmul_rn(in[((dy - 1) * E + dx) * lda],
                                                   k[dy * 3 + dx]));
          }
        }
      }
      *reinterpret_cast<float4*>(bc + p0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// Every layer of the stack on the tile in A ([H][E][widths[0]], row stride
// row_ld(widths[0], kMma), columns outside the valid range already zero),
// in layer mode kMode (kLp on bf16 tiles only). Returns the buffer that
// holds the output [H][E][widths[L]], valid on the core columns [L, E - L):
// A, or in the folded mode (whose layers read one buffer and write the
// other) A or B by the parity of L. g0: grid column of buffer column 0;
// [vlo, vhi): valid grid columns. kWide: layers of more than kMmaRegK input
// channels (tensor cores).
template <typename T, bool kMma = false, int kMode = kNormal, bool kWide = false>
__device__ T* run_stack(T* buf_a, T* buf_b, const T* __restrict__ wts,
                        const StackDesc& d, int H, int E, int g0, int vlo,
                        int vhi, FixList fx = FixList{}) {
  static_assert(kMode != kLp || kMma, "stencil_lp: bf16 tiles only");
  static_assert(!kWide || kMma, "kWide: tensor-core tiles only");
  const int L = d.n_layers;
  T* in = buf_a;
  T* other = buf_b;
  for (int l = 0; l < L; ++l) {
    const int cin = d.widths[l];
    const int cout = d.widths[l + 1];
    const int ld_in = row_ld(cin, kMma);
    const int ld_out = row_ld(cout, kMma);
    const int c_lo = l + 1;          // first buffer column this layer writes
    const int wl = E - 2 * (l + 1);  // columns this layer writes
    const int P = H * wl;            // positions this layer writes
    const int ldb = cm_ld(P);        // CUDA cores: B's channel stride
    const T* dw = wts + d.dw_off[l];
    const T* pw = wts + d.pw_off[l];
    const T* bias = wts + d.b_off[l];

    if constexpr (kMode == kFold) {
      // A product over the nine shifted inputs: in -> other [h][col][cout].
      const StackEpi<T> epi{other, bias, E, wl, c_lo, g0, vlo, vhi, ld_out, l < L - 1};
      if constexpr (kMma) {
        folded_mma<kWide>(in, ld_in, H, E, wl, c_lo, wts + d.frag_off[l], bias, cin, cout, fx,
                          epi);
      } else {
        folded_fma<T>(in, ld_in, H, E, wl, c_lo, wts + d.frag_off[l], cin, cout, epi);
      }
      __syncthreads();
      T* tmp = in;
      in = other;
      other = tmp;
      continue;
    }

    // Depthwise: A [h][col][cin] -> B, p = h * wl + col - c_lo: [p][cin] on
    // the tensor cores, [cin][ldb] on the CUDA cores (which first send for
    // the product's first weight slab).
    if constexpr (kMma) {
      depthwise_pairs<kMode == kLp>(buf_a, buf_b, dw, H, E, wl, c_lo, cin, ld_in, ld_in);
    } else {
      copy_slab(wts + d.frag_off[l], cin, cout, 0);
      depthwise_f32(buf_a, buf_b, dw, H, E, wl, c_lo, cin, ld_in, ldb);
    }
    __syncthreads();

    // Pointwise + bias (+ ReLU on hidden layers): B -> A [h][col][cout].
    if constexpr (kMma) {
      const T* pwf = kMma ? wts + d.frag_off[l] : nullptr;
      product<T, kMma, kWide>(buf_b, ld_in, P, pw, pwf, bias, cin, cout, fx,
                              StackEpi<T>{buf_a, bias, E, wl, c_lo, g0, vlo, vhi, ld_out, l < L - 1});
    } else {
      pointwise_f32<true>(buf_b, ldb, P, wts + d.frag_off[l], cin, cout,
                          StackEpi<T>{buf_a, bias, E, wl, c_lo, g0, vlo, vhi, ld_out, l < L - 1},
                          true);
    }
    __syncthreads();
  }
  return in;
}

// Elements of buffer A of a tile of E columns, [H][E][row_ld(cmax)]; on
// the CUDA cores rounded up to 4 (B starts 16-byte aligned).
__host__ __device__ inline size_t tile_a_elems(int H, int E, int cmax, bool mma) {
  const size_t n = (size_t)H * E * row_ld(cmax, mma);
  return mma ? n : (n + 3) / 4 * 4;
}

// Elements of buffer B: A's on the tensor cores and in the folded mode
// (whose layers ping-pong between A and B); otherwise on the CUDA cores the
// depthwise output channel-major, the most any layer l takes: widths[l] x
// cm_ld(H * (E - 2 (l + 1))).
__host__ __device__ inline size_t tile_b_elems(const StackDesc& d, int H, int E, bool mma,
                                              bool folded = false) {
  if (mma || folded) return tile_a_elems(H, E, stack_cmax(d), mma);
  size_t b = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const size_t n = (size_t)d.widths[l] * cm_ld(H * (E - 2 * (l + 1)));
    b = n > b ? n : b;
  }
  return b;
}

// One tile of the stack (the body of the stack kernel) in layer mode kMode:
// image n of x [N, H, W, widths[0]] -> out [N, H, W, widths[L]], core
// columns [tile * w_tile, (tile + 1) * w_tile). Shared memory: on the
// tensor-core path the re-sum list (kFixBytes), then A ([H][w_tile +
// 2L][row_ld(cmax, kMma)]) and B (tile_b_elems); on the CUDA cores outside
// the folded mode the weight slabs (kStageBytes) end it. kWide: as
// run_stack's.
template <typename T, bool kMma = false, int kMode = kNormal, bool kWide = false>
__device__ void stack_tile(const T* x, const T* __restrict__ wts, T* out,
                           const StackDesc& d, int H, int W, int w_tile,
                           int lo, int hi, int n, int tile,
                           unsigned char* smem) {
  const int L = d.n_layers;
  const int E = w_tile + 2 * L;
  const FixList fx = fix_list(smem);
  T* buf_a = reinterpret_cast<T*>(smem + (kMma ? kFixBytes : 0));
  T* buf_b = buf_a + (kMma ? (size_t)H * E * row_ld(stack_cmax(d), kMma)
                           : tile_a_elems(H, E, stack_cmax(d), false));
  const int w0 = tile * w_tile;
  const int g0 = w0 - L;  // grid column of buffer column 0
  const int vlo = max(lo, 0);
  const int vhi = min(hi, W);

  const int c0 = d.widths[0];
  const int ld0 = row_ld(c0, kMma);
  const T* xn = x + (size_t)n * H * W * c0;
  if (kMma && c0 % 2 == 0) {
    // bf16 pairs: 4-byte loads (the input rows are 4-byte aligned)
    const int ppr = c0 / 2;
    for (int i = threadIdx.x; i < H * E * ppr; i += blockDim.x) {
      const int r = i / ppr;
      const int c = (i - r * ppr) * 2;
      const int g = g0 + r % E;
      *reinterpret_cast<uint32_t*>(buf_a + (size_t)r * ld0 + c) =
          (g >= vlo && g < vhi)
              ? __ldg(reinterpret_cast<const unsigned int*>(
                    xn + ((size_t)(r / E) * W + g) * c0 + c))
              : 0u;
    }
  } else {
    for (int i = threadIdx.x; i < H * E * c0; i += blockDim.x) {
      const int c = i % c0;
      const int col = (i / c0) % E;
      const int h = i / (c0 * E);
      const int g = g0 + col;
      buf_a[(size_t)(i / c0) * ld0 + c] =
          (g >= vlo && g < vhi) ? xn[((size_t)h * W + g) * c0 + c] : from_f<T>(0.f);
    }
  }
  __syncthreads();
  const T* res = run_stack<T, kMma, kMode, kWide>(buf_a, buf_b, wts, d, H, E, g0, vlo, vhi, fx);

  const int cl = d.widths[L];
  const int ldl = row_ld(cl, kMma);
  T* on = out + (size_t)n * H * W * cl;
  if (kMma && cl % 8 == 0) {
    // 16-byte chunks (rows of 8k bf16 are 16-byte aligned in both)
    const int cpr = cl / 8;
    for (int i = threadIdx.x; i < H * w_tile * cpr; i += blockDim.x) {
      const int r = i / cpr;
      const int c = (i - r * cpr) * 8;
      const int cc = r % w_tile;
      const int h = r / w_tile;
      const int g = w0 + cc;
      if (g < W)
        *reinterpret_cast<uint4*>(on + ((size_t)h * W + g) * cl + c) =
            *reinterpret_cast<const uint4*>(res + ((size_t)h * E + L + cc) * ldl + c);
    }
  } else {
    for (int i = threadIdx.x; i < H * w_tile * cl; i += blockDim.x) {
      const int c = i % cl;
      const int cc = (i / cl) % w_tile;
      const int h = i / (cl * w_tile);
      const int g = w0 + cc;
      if (g < W)
        on[((size_t)h * W + g) * cl + c] = res[((size_t)h * E + L + cc) * ldl + c];
    }
  }
  __syncthreads();  // A and B are free for the next tile
}

inline size_t stack_smem(const StackDesc& d, int H, int w_tile,
                         size_t itemsize, bool mma = false, bool folded = false) {
  const int E = w_tile + 2 * d.n_layers;
  const int cmax = stack_cmax(d);
  return (mma ? kFixBytes : folded ? 0 : kStageBytes) +
         (tile_a_elems(H, E, cmax, mma) + tile_b_elems(d, H, E, mma, folded)) * itemsize;
}

// Largest tile width (core columns) whose buffers fit in `smem` bytes,
// then narrowed to equal tiles over W; 0 if none fits. On the tensor cores
// every layer mode takes the same two buffers (the folded mode ping-pongs
// between them); on the CUDA cores the folded mode takes two equal ones,
// the normal mode a channel-major B and the weight slabs (stack_smem).
inline int stack_w_tile(const StackDesc& d, int H, int W, size_t itemsize,
                        size_t smem, bool mma = false, bool folded = false) {
  const size_t per_col = 2 * (size_t)H * row_ld(stack_cmax(d), mma) * itemsize;
  const size_t fix = mma ? kFixBytes : 0;
  if (smem <= fix) return 0;
  int w_tile = mma ? (int)((smem - fix) / per_col) - 2 * d.n_layers : kMaxTile;
  if (mma && H * (w_tile + 2 * d.n_layers) > kMmaMaxP) w_tile = kMmaMaxP / H - 2 * d.n_layers;
  while (!mma && w_tile >= 1 && stack_smem(d, H, w_tile, itemsize, mma, folded) > smem)
    --w_tile;
  if (w_tile > kMaxTile) w_tile = kMaxTile;
  if (w_tile > W) w_tile = W;
  if (w_tile < 1) return 0;
  const int n_tiles = (W + w_tile - 1) / w_tile;
  return (W + n_tiles - 1) / n_tiles;
}


}  // namespace nrx
