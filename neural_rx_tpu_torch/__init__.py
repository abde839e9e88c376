"""PyTorch + CUDA port of the nrx_rt neural PUSCH receiver for NVIDIA Hopper.

Mirrors the module layout of the JAX package `neural_rx_tpu` so that each
counterpart is easy to find. This package imports torch and numpy only.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a GPU they raise instead of falling back.

Serving path (`entry.entry`): dense nearest-neighbour LS channel estimate
(`phy/chest.py`) -> CGNN (`rx/cgnn.py`) whose separable-conv stacks run in
the hand-written CUDA kernel `csrc/sepconv_stack.cu`
(`kernels/sepconv.py`) -> (llr, h_hat).
"""
