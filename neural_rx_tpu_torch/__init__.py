"""PyTorch + CUDA port of the nrx_rt neural PUSCH receiver for NVIDIA Hopper.

Mirrors the module layout of the JAX package `neural_rx_tpu` so that each
counterpart is easy to find. This package imports torch and numpy only.
Entry points run on the CUDA device unless the caller passes
`device="cpu"`; without a GPU they raise instead of falling back.

Serving path (`entry.entry`): dense nearest-neighbour LS channel estimate
(`phy/chest.py`) -> CGNN (`rx/cgnn.py`) whose separable-conv stacks and
iterations run in the hand-written CUDA kernels of `csrc/sepconv_stack.cu`
and `csrc/cgnn_iter.cu` (`kernels/sepconv.py`, `kernels/cgnn_iter.py`)
-> (llr, h_hat).

Eval path (`entry.eval_entry`): the transmitter (`phy/nr/transmitter.py`:
TB encode, QAM, RE mapping, DMRS, precoding) -> channel + AWGN
(`channel/apply.py`) -> `NeuralPUSCHReceiver.apply`: the serving path's
LS estimate and CGNN, then a per-user transport-block decode
(`phy/nr/tb.py`) by the flooding decoder (`phy/nr/ldpc.py`) or the
hand-written CUDA layered min-sum decoder `csrc/ldpc_decode.cu`
(`kernels/ldpc.py`).

Monte-Carlo evaluation (`entry.mc_entry`, `sim/simber.py`): the eval path
behind the configuration's channel model (`channel/`), drawn on the device;
with a classical receiver in place of the neural one
(`sim/baseline_e2e.py`, `rx/baselines.py`, `entry.baseline_entry`) for the
baselines the BLER curves compare against, decoded by the same decoders.
"""
