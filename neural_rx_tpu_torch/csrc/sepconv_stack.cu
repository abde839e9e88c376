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
// 227 KB shared-memory limit. The tile code lives in nrx_tile.cuh, shared
// with cgnn_iter.cu, where the iteration kernel and the whole-CGNN kernel's
// init stage run the same tile.
//
// bf16 (the serving dtype) runs the tensor-core tile, as K3/K4 do:
// nrx::pointwise_mma (mma.sync m16n8k16 bf16 -> f32, A fragments from
// shared memory by ldmatrix, each warp's B fragments of one n8 tile in
// registers, from the fragment-ordered copy of the weights that the wrapper
// appends: kernels/sepconv.py, pack_stack_mma) with its re-sum of the sums
// that lie near a bf16 rounding boundary, so the outputs stay those of the
// plain version; nrx::depthwise_pairs for the taps. Rows are row_ld(c, true)
// apart (18 -> 24, 114 -> 120, 128 -> 136, 56 -> 56), and the warps' re-sum
// lists (nrx::kFixBytes) open the dynamic shared memory: W_t = 24 (E = 30)
// in 230,528 B at nrx_rt, 66 tiles over 1584 columns, so one batch-1 slot
// (N = 2) is 132 blocks, one wave at one block per SM. A stack with a layer
// of more than nrx::kMmaRegK = 128 input channels (e2e_rt's and e2e_large's
// update stacks, 130 -> 128 -> 128 -> 64: W_t = 24 too, as rows of 130 and
// 128 channels take the same 136-element stride) runs the kWide instance of
// its mode, whose k-steps past 128 stream their B fragments from L2 per M
// tile; the tile takes at most nrx::kMmaMaxK = 256 input channels a layer,
// and the wrapper refuses a wider bf16 stack.
//
// float32 (the eval and Monte-Carlo path) runs the CUDA-core tile
// (nrx_tile.cuh): nrx::depthwise_f32 writes B channel-major with each
// thread's taps in registers; nrx::pointwise_f32 multiplies it in register
// tiles of 8 positions x 8 channels (4 x 8 where that fills the block
// better), its weights (the wrapper's padded rows, pack_stack_rows) staged
// slab by slab in shared memory by cp.async. Each sum is fmaf over the
// input channels in order from 0, as the first CUDA-core tile summed, so
// the outputs are that tile's bit for bit. W_t = 10 (E = 16): A, B (128
// channels x 204 positions) and three 4 KB weight slabs in 231,424 B.
// Bound by operations at 67 TFLOP/s: 1.131 ms for the init stack at N =
// 60, which the tile runs at ~19 % of, about twice the first tile's speed
// (shared-memory bandwidth holds it: see nrx_tile.cuh). The folded mode
// keeps its loop (nrx::folded_fma) and two position-major buffers.
//
// Layer modes (nrx_tile.cuh; the JAX package's `lp_stencil` and `mxu`
// arguments, one kernel instance each): normal; stencil_lp (bf16: the taps
// summed in packed bf16x2, nrx::depthwise_pairs<true>; float32 takes the
// normal instance, where the mode changes nothing); and the folded-tap form
// (conv_mxu): per layer one product over the nine shifted copies of the
// input with the folded weights W_s = round(dw_s[:, None] * pw) that the
// wrapper packs (kernels/sepconv.py, pack_stack_folded) -- nrx::folded_mma
// on the tensor cores in bf16, the nine taps' B fragments streamed a tap at
// a time from L2 (9 x the pointwise weights: 465,408 B for nrx_rt's init
// stack, 686,592 B for an update stack), with its own re-sum bound;
// nrx::folded_fma on the CUDA cores in float32 (in-order FMA, no TF32).
// Both buffers stay (the folded layers ping-pong between A and B), so
// every mode has the same tile. Its bound is set by operations: 2 x 9 x
// c_in x c_out FLOP per position and layer.
//
// What bounds it on this card: at the nrx_rt shapes a launch at N = 2 does
// 2.5 (init) or 3.7 (update) GFLOP against 6.6 or 15 MB of device traffic,
// so a batch-1 slot's three launches are bound by their bytes (~12 us),
// with ~10 us at the tensor cores' bf16 rate close behind; the halo
// re-computation costs (W_t + 2L) / W_t extra work on the first layer.
//
// Launch set-up (shared-memory opt-in, the kernel's shared-memory
// attribute) is queried once per device, kernel and size (nrx_launch.cuh).

#include "nrx_launch.cuh"
#include "nrx_tile.cuh"

namespace {

using nrx::StackDesc;

template <typename T, int kMode, bool kWide>
__global__ void __launch_bounds__(nrx::kThreads)
    sepconv_stack_kernel(const T* __restrict__ x, const T* __restrict__ wts,
                         T* __restrict__ out, StackDesc d, int H, int W,
                         int w_tile, int lo, int hi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nrx::stack_tile<T, nrx::kUseMma<T>, kMode, kWide>(x, wts, out, d, H, W, w_tile, lo, hi,
                                                    blockIdx.y, blockIdx.x, smem_raw);
}

template <typename T, int kMode, bool kWide = false>
cudaError_t launch(const void* x, const void* w, void* out, const StackDesc& d,
                   int n, int h, int wc, int lo, int hi, cudaStream_t stream) {
  static nrx::KernelSetup setup[nrx::kMaxDevices];
  constexpr bool kMma = nrx::kUseMma<T>;
  if (kMma && !nrx::mma_fits(d)) return cudaErrorInvalidValue;
  if (!kMma && kMode != nrx::kFold && !nrx::rows_fit(d)) return cudaErrorInvalidValue;
  if constexpr (kMma && !kWide) {
    if (nrx::stack_wide(d)) return launch<T, kMode, true>(x, w, out, d, n, h, wc, lo, hi, stream);
  }
  int w_tile = 0;
  size_t smem = 0;
  {
    std::lock_guard<std::mutex> lock(nrx::setup_mutex());
    int dev = 0;
    nrx::DeviceSetup ds;
    cudaError_t err = nrx::device_setup(&dev, &ds);
    if (err != cudaSuccess) return err;
    w_tile = nrx::stack_w_tile(d, h, wc, sizeof(T), ds.optin, kMma, kMode == nrx::kFold);
    if (w_tile < 1) return cudaErrorInvalidValue;
    smem = nrx::stack_smem(d, h, w_tile, sizeof(T), kMma, kMode == nrx::kFold);
    err = nrx::allow_smem(sepconv_stack_kernel<T, kMode, kWide>, setup[dev], smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((wc + w_tile - 1) / w_tile, n);
  sepconv_stack_kernel<T, kMode, kWide><<<grid, nrx::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d,
      h, wc, w_tile, lo, hi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [n, h, wc, widths[0]], out: [n, h, wc, widths[n_layers]], both
// contiguous in the working type (dtype 0: float32, 1: bfloat16). w: the
// packed stack, per layer dw [9][c_in], pw [c_in][c_out], b [c_out] in the
// same type; in bfloat16 followed by every layer's B fragments (the
// wrapper's pack_stack_mma), and no layer wider than 256 input channels.
// mode: 0 normal, 1 stencil_lp, 2 folded taps; the folded mode reads the
// wrapper's pack_stack_folded (the same buffer followed by every layer's
// nine folded matrices: B fragments in bfloat16, rows in float32).
// widths: host array of n_layers + 1 ints. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
int nrx_sepconv_stack(const void* x, const void* w, void* out, int dtype, int n,
                      int h, int wc, int n_layers, const void* widths, int lo,
                      int hi, int mode, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || wc < 1) return (int)cudaErrorInvalidValue;
  if (mode < nrx::kNormal || mode > nrx::kFold) return (int)cudaErrorInvalidValue;
  StackDesc d;
  if (!nrx::make_stack_desc(n_layers, static_cast<const int*>(widths), &d,
                            mode == nrx::kFold, dtype == 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    // stencil_lp changes nothing in float32
    if (mode == nrx::kFold)
      return (int)launch<float, nrx::kFold>(x, w, out, d, n, h, wc, lo, hi, s);
    return (int)launch<float, nrx::kNormal>(x, w, out, d, n, h, wc, lo, hi, s);
  }
  if (dtype == 1) {
    using B = __nv_bfloat16;
    if (mode == nrx::kFold)
      return (int)launch<B, nrx::kFold>(x, w, out, d, n, h, wc, lo, hi, s);
    if (mode == nrx::kLp) return (int)launch<B, nrx::kLp>(x, w, out, d, n, h, wc, lo, hi, s);
    return (int)launch<B, nrx::kNormal>(x, w, out, d, n, h, wc, lo, hi, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* nrx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
