// The wide instances of K3 and K4 (csrc/cgnn_iter.cu) for Hopper (sm_90a),
// CUDA C++: bf16 tiles with a product of more than nrx::kMmaRegK = 128 input
// channels (e2e_rt's and e2e_large's 130-channel update stacks), whose
// k-steps past nrx::kMmaWideRegK stream their weights from L2
// (nrx_tile.cuh, pointwise_mma). A translation unit of its own, so that the
// build compiles these instances beside cgnn_iter.cu's, in parallel;
// nrx_cgnn_iter and nrx_cgnn_full forward such launches to the entry points
// defined here.

#define NRX_CGNN_WIDE
#include "cgnn_iter.cu"
