// Layered normalized min-sum QC-LDPC decoder for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K5 of the JAX package:
//   neural_rx_tpu/kernels/ldpc_pallas.py:make_decoder (body `kernel`)
// and computes what its NumPy oracle `reference_layered_decode` computes:
// per iteration, the check rows of the base graph in order; for row r and
// its edges k (column c_k, cyclic shift s_k), in lane j < Z,
//   t_k   = app[c_k][(j + s_k) % Z] - m_k (the edge's previous message)
//   sign  = prod_k (t_k < 0 ? -1 : 1),  min1 = min_k |t_k|,
//   min2  = min over the row without the FIRST edge whose |t_k| <= min1,
//   m_k   = alpha * sign * sgn(t_k) * (k is that edge ? min2 : min1)
//   app[c_k][(j + s_k) % Z] = round(t_k + m_k)
// with alpha = 0.8125, then hard bits app < 0. LLRs are the decoder's
// internal log(p0/p1), [N, n_cols * Z] float32; bits are 0.f / 1.f.
//
// Design. The TPU program held a tile of codewords' APP and check messages
// in VMEM and rotated whole 128-lane rows. Here one block decodes one
// codeword with one thread per lifted lane j (blockDim = Z rounded up to a
// warp; threads j >= Z only help with loads and stores), so a cyclic shift
// is an index, (j + s) mod Z, and Z need not be a multiple of anything.
// The APP [n_cols][Z] lives in shared memory for all iterations (104 KB at
// BG1/Z = 384). Within a row every edge has its own column and
// (j + s) mod Z is a bijection, so no two threads touch one APP entry;
// __syncthreads() separates the rows.
//
// Check-node state. A row's messages are not stored one per edge: they are
// rebuilt from what the min-sum update leaves per (row, lane), three 32-bit
// words: min1 and min2 (unscaled f32) and a word with one sign bit per edge
// (bit k: t_k < 0), the first-minimum edge index (5 bits) and the sign
// parity. The message of edge k is __fmul_rn(+-alpha, k == first ? min2 :
// min1), the same rounded product the update computed, so the decode is the
// one with full messages bit for bit. That is 12 B per row-lane instead of
// 4 B per edge-lane: 212 KB per BG1/Z = 384 codeword against 485 KB, 17 MB
// for the 80 codewords of one user's batch-16 transport blocks, which stay
// in the 50 MB L2. The state of the first rows lives in shared memory
// beside the APP, as many rows as fit (27 of 46 at BG1/Z = 384; all of
// them at Z <= 256); the rest in device memory [N][rows][3][Z]. Each
// thread reads only its own lane's state, so no barrier orders it; row
// r + 1's state is loaded into registers while row r computes (the previous
// iteration wrote it, row r does not touch it), which takes the load's
// latency off the row's chain. The first iteration reads no state (its
// messages are zero, and x - 0 == x), so the buffer needs no clearing.
//
// Where a port goes wrong, and what this code does:
// - Rounding of the update: the new app is t + alpha*sign*sgn*min rounded
//   once, a fused multiply-add, as the JAX kernel computes it on the CPU
//   (XLA contracts the two; the float64 oracle rounds neither). Rounding
//   the product first (13/16 * min is inexact) flips hard bits against the
//   oracle, and so would leaving the choice to nvcc's contraction: both
//   steps are explicit, __fmul_rn for the message and __fmaf_rn for the
//   app. The plain version rounds at the same two points.
// - Sign: t < 0.f, so -0.0 counts as +1 (not signbit); hard bit app < 0.
// - Tie-break: the first edge in row order with |t| <= min1 is the one
//   masked for min2 (the running minimum starts at the first edge and takes
//   a later one only if it is strictly smaller). Ties are common: every
//   filler position enters at +20. LLRs are finite (NaN is outside the
//   contract: the plain version's minimum propagates it, this one does not).
// - Z not a multiple of 32 (Z = 52, 352): guarded by j < Z, all index
//   arithmetic mod Z.
//
// What bounds it on this card: ~10 value operations per edge, lane and
// iteration (subtract, abs, sign test, min1, first-min test, mask, min2,
// other-min select, multiply, fused multiply-add): 316 x 384 x 20 x 10 =
// 24 M per BG1/Z = 384 codeword against 209 KB of LLRs in and bits out, so
// the bound is the f32 rate outside the tensor cores. The kernel is instead
// bound by the latency of its 20 x 46 dependent row steps (a chain of
// shared-memory loads, the row's running minimum, the stores and a
// barrier) with 12 warps an SM: one block per codeword, 80 blocks on 132
// SMs at one user's batch-16 load. The first version of this kernel kept
// one message per edge and lane in device memory; each row step waited on
// those L2 loads one after another (~5,300 of its ~7,200 cycles, PERF.md).
// Here each row's step is compiled for its degree (BG1's and BG2's degrees
// 3-10 and 19): straight-line code whose loads are all issued before the
// first is used; a row's state costs one 12-byte load, made a row ahead.

#include <cuda_runtime.h>

#include <mutex>

#include "nrx_launch.cuh"

namespace {

constexpr int kMaxDeg = 19;   // BG1's densest row; the wrapper checks
constexpr int kMaxZ = 384;    // largest lifting size
constexpr float kAlpha = 0.8125f;
// state word: bits 0..18 edge signs (t_k < 0), 19..23 the first-minimum
// edge, 24 the sign parity
constexpr int kFirstShift = kMaxDeg;
constexpr int kParityShift = kFirstShift + 5;

struct State {
  float min1, min2;
  unsigned word;
};

// x with its sign flipped where bit k of `flips` is set.
__device__ __forceinline__ float flip(unsigned x, unsigned flips, int k) {
  return __uint_as_float(x ^ ((flips << (31 - k)) & 0x80000000u));
}

// One row step of lane j: the row's edges are plan[0, deg) (column * z |
// shift << 16 each); updates the app and returns the row's new state. cur:
// the row's state from the previous iteration, read if `read`. kExact:
// deg == kDeg (no branch between edges), else deg <= kDeg. Each pass is a
// loop of its own, so the row's app loads are all in flight before the
// first is used.
template <int kDeg, bool kExact>
__device__ __forceinline__ State row_step(float* app, const int* plan, int deg, int j,
                                          int z, const State& cur, bool read) {
  int pos[kDeg];
  float t[kDeg];
#pragma unroll
  for (int k = 0; k < kDeg; ++k) {
    if (!kExact && k >= deg) break;
    const int pl = plan[k];
    const int p = j + (pl >> 16);
    pos[k] = (pl & 0xffff) + (p >= z ? p - z : p);
  }
#pragma unroll
  for (int k = 0; k < kDeg; ++k) {
    if (!kExact && k >= deg) break;
    t[k] = app[pos[k]];
  }
  if (read) {
    // the previous messages: alpha * min2 on the first-minimum edge, alpha *
    // min1 elsewhere, rounded once, negative where the edge's sign differs
    // from the row's (-alpha * m rounds to -(alpha * m))
    const unsigned m1 = __float_as_uint(__fmul_rn(kAlpha, cur.min1));
    const unsigned m2 = __float_as_uint(__fmul_rn(kAlpha, cur.min2));
    const int first = (cur.word >> kFirstShift) & 31u;
    const unsigned flips = cur.word ^ (0u - ((cur.word >> kParityShift) & 1u));
#pragma unroll
    for (int k = 0; k < kDeg; ++k) {
      if (!kExact && k >= deg) break;
      t[k] = __fsub_rn(t[k], flip(k == first ? m2 : m1, flips, k));
    }
  }
  // running minimum in row order: an edge becomes the first minimum only if
  // it is strictly below min1, so ties go to the first edge
  unsigned neg = t[0] < 0.f;  // bit k: t_k < 0 (-0.0 counts as +)
  float min1 = fabsf(t[0]), min2 = 1e30f;
  int first = 0;
#pragma unroll
  for (int k = 1; k < kDeg; ++k) {
    if (!kExact && k >= deg) break;
    neg |= static_cast<unsigned>(t[k] < 0.f) << k;
    const float m = fabsf(t[k]);
    const bool lt = m < min1;
    min2 = fminf(min2, lt ? min1 : m);
    first = lt ? k : first;
    min1 = lt ? m : min1;
  }
  const unsigned parity = __popc(neg) & 1u;
  const unsigned flips = neg ^ (0u - parity);  // bit k: message negative
  const unsigned o1 = __float_as_uint(min1), o2 = __float_as_uint(min2);
#pragma unroll
  for (int k = 0; k < kDeg; ++k) {
    if (!kExact && k >= deg) break;
    // t + (+-alpha) * other, rounded once: alpha * (+-other) is the same
    // exact product
    app[pos[k]] = __fmaf_rn(kAlpha, flip(k == first ? o2 : o1, flips, k), t[k]);
  }
  return State{min1, min2, neg | (unsigned)first << kFirstShift | parity << kParityShift};
}

// Decoder of one codeword a block.
__global__ void __launch_bounds__(kMaxZ)
    ldpc_layered_kernel(const float* __restrict__ llr, float* __restrict__ out,
                        float* __restrict__ state, const int* __restrict__ row_ptr,
                        const int* __restrict__ cols, const int* __restrict__ shifts,
                        int z, int n_cols, int n_rows, int n_edges, int num_iter,
                        int smem_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_full = n_cols * z;
  float* app = reinterpret_cast<float*>(smem_raw);       // [n_cols][z]
  float* s_state = app + n_full;                         // [smem_rows][3][z]
  int* s_ptr = reinterpret_cast<int*>(s_state + (size_t)smem_rows * 3 * z);
  int* s_plan = s_ptr + n_rows + 1;  // per edge: column * z | shift << 16

  const size_t cw = blockIdx.x;
  const float* in = llr + cw * n_full;
  float* g_state = state + cw * (size_t)n_rows * 3 * z;
  for (int i = threadIdx.x; i < n_full; i += blockDim.x) app[i] = in[i];
  for (int i = threadIdx.x; i <= n_rows; i += blockDim.x) s_ptr[i] = row_ptr[i];
  for (int i = threadIdx.x; i < n_edges; i += blockDim.x)
    s_plan[i] = cols[i] * z | shifts[i] << 16;
  __syncthreads();

  const int j = threadIdx.x;
  const bool lane = j < z;
  // lane j's words of row r's state: min1, min2, word, z apart
  auto words = [&](int r) -> float* {
    return (r < smem_rows ? s_state : g_state) + (size_t)r * 3 * z + j;
  };

  State nxt{0.f, 0.f, 0u};  // state of the row about to run
  for (int it = 0; it < num_iter; ++it) {
    const bool write = it + 1 < num_iter;
    for (int r = 0; r < n_rows; ++r) {
      const State cur = nxt;
      // the next row's state (after the last row, row 0's of the next
      // iteration), loaded while this row computes; iteration 0 reads none
      const int rn = r + 1 < n_rows ? r + 1 : 0;
      const int itn = r + 1 < n_rows ? it : it + 1;
      if (lane && itn > 0 && itn < num_iter) {
        const float* p = words(rn);
        nxt = rn < smem_rows
                  ? State{p[0], p[z], __float_as_uint(p[2 * z])}
                  : State{__ldcg(p), __ldcg(p + z), __float_as_uint(__ldcg(p + 2 * z))};
      }
      if (lane) {
        const int e0 = s_ptr[r];
        const int deg = s_ptr[r + 1] - e0;
        const int* plan = s_plan + e0;
        // the row step compiled for the row's degree (BG1's and BG2's
        // degrees): straight-line code, all loads issued before any use
        State s;
        switch (deg) {
          case 3: s = row_step<3, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 4: s = row_step<4, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 5: s = row_step<5, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 6: s = row_step<6, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 7: s = row_step<7, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 8: s = row_step<8, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 9: s = row_step<9, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 10: s = row_step<10, true>(app, plan, deg, j, z, cur, it > 0); break;
          case 19: s = row_step<19, true>(app, plan, deg, j, z, cur, it > 0); break;
          default: s = row_step<kMaxDeg, false>(app, plan, deg, j, z, cur, it > 0);
        }
        if (write) {
          float* p = words(r);
          if (r < smem_rows) {
            p[0] = s.min1;
            p[z] = s.min2;
            p[2 * z] = __uint_as_float(s.word);
          } else {
            __stcg(p, s.min1);
            __stcg(p + z, s.min2);
            __stcg(p + 2 * z, __uint_as_float(s.word));
          }
        }
      }
      __syncthreads();
    }
  }
  float* bits = out + cw * n_full;
  for (int i = threadIdx.x; i < n_full; i += blockDim.x)
    bits[i] = app[i] < 0.f ? 1.f : 0.f;
}

cudaError_t launch(const void* llr, void* out, void* state, const void* row_ptr,
                   const void* cols, const void* shifts, int n, int z, int n_cols,
                   int n_rows, int n_edges, int num_iter, cudaStream_t stream) {
  static nrx::KernelSetup setup[nrx::kMaxDevices];
  // app and row plan, then as many rows of state as fit
  const size_t base = sizeof(float) * (size_t)n_cols * z +
                      sizeof(int) * (n_rows + 1 + (size_t)n_edges);
  const size_t per_row = sizeof(float) * 3 * (size_t)z;
  int smem_rows = 0;
  {
    std::lock_guard<std::mutex> lock(nrx::setup_mutex());
    int dev = 0;
    nrx::DeviceSetup d;
    cudaError_t err = nrx::device_setup(&dev, &d);
    if (err != cudaSuccess) return err;
    if (base > d.optin) return cudaErrorInvalidValue;
    smem_rows = (int)((d.optin - base) / per_row);
    if (smem_rows > n_rows) smem_rows = n_rows;
    err = nrx::allow_smem(ldpc_layered_kernel, setup[dev], base + per_row * smem_rows);
    if (err != cudaSuccess) return err;
  }
  const int threads = (z + 31) / 32 * 32;
  ldpc_layered_kernel<<<n, threads, base + per_row * smem_rows, stream>>>(
      static_cast<const float*>(llr), static_cast<float*>(out), static_cast<float*>(state),
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const int*>(shifts), z, n_cols, n_rows, n_edges, num_iter, smem_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// llr, out: [n, n_cols * z] float32, contiguous. state: [n, n_rows, 3, z]
// 32-bit scratch, any contents. row_ptr [n_rows + 1], cols / shifts
// [n_edges]: the row plan (column and shift mod z of each edge in row
// order), int32, on the device; no row may have more than 19 edges.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
int nrx_ldpc_layered_decode(const void* llr, void* out, void* state,
                            const void* row_ptr, const void* cols,
                            const void* shifts, int n, int z, int n_cols,
                            int n_rows, int n_edges, int num_iter, void* stream) {
  if (n < 1 || z < 1 || z > kMaxZ || n_cols < 1 || n_rows < 1 || n_edges < 1 ||
      num_iter < 0 || (size_t)n_cols * z >= 65536)
    return (int)cudaErrorInvalidValue;
  return (int)launch(llr, out, state, row_ptr, cols, shifts, n, z, n_cols, n_rows,
                     n_edges, num_iter, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
