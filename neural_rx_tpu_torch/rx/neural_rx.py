"""NeuralPUSCHReceiver serving path: dense LS estimate + CGNN -> (llr, h_hat).

Counterpart of `neural_rx_tpu/rx/neural_rx.py:NeuralPUSCHReceiver`
(`__init__` and the planar `_prepare_inputs`), plus `serve`, which returns
what the JAX package's `__graft_entry__.entry()` function returns: the
final-iteration LLR grid and the refined channel estimate, by the same
batch-adaptive route.
"""

from __future__ import annotations

import dataclasses

import torch

from ..phy.chest import LSChannelEstimator
from .cgnn import CGNNConfig, cgnn_apply, pilot_positional_encoding


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


class NeuralPUSCHReceiver:
    """Static configuration + functional apply for the neural receiver.

    resource_grid: the PUSCH `ResourceGrid` of the UEs;
    num_bits_per_symbol: one entry per MCS (`sim.config.Parameters`).
    fused_full: serve through the whole-CGNN kernel (the JAX entry's
    `NRX_DEPLOY_MEGA=1` route); kernels=False: every fused route takes its
    kernel's plain version.
    """

    def __init__(self, resource_grid, num_bits_per_symbol,
                 num_rx_ant: int, max_num_tx: int,
                 num_it: int, d_s: int, num_units_init, num_units_agg,
                 num_units_state, num_units_readout,
                 layer_type_conv: str = "sepconv",
                 var_mcs_masking: bool = False,
                 nrx_dtype=torch.float32,
                 fused_full: bool = False,
                 kernels: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.rg = resource_grid
        self.num_rx_ant = num_rx_ant
        self.max_num_tx = max_num_tx
        self.nrx_dtype = nrx_dtype
        self.cgnn_cfg = CGNNConfig(
            num_bits_per_symbol=tuple(num_bits_per_symbol),
            num_rx_ant=num_rx_ant,
            num_it=num_it, d_s=d_s,
            num_units_init=tuple(num_units_init),
            num_units_agg=tuple(tuple(u) for u in num_units_agg),
            num_units_state=tuple(tuple(u) for u in num_units_state),
            num_units_readout=tuple(num_units_readout),
            layer_type_conv=layer_type_conv,
            var_mcs_masking=var_mcs_masking,
            fused_convs=True,
            fused_full=fused_full,
            kernels=kernels)

        # Positional encoding from the configured slot's DMRS positions,
        # [max_num_tx, sym, sc, 2]
        slot = self.rg.configs[0].carrier.slot_number
        pe = pilot_positional_encoding(self.rg.dmrs_grids[slot],
                                       self.rg.pilot_mask)[:max_num_tx]
        self.pe = torch.as_tensor(pe, device=self.device)
        self._ls = LSChannelEstimator(self.rg)

    def _prepare_inputs(self, y_planar: torch.Tensor):
        """y_planar [b, rx_ant, sym, sc, 2] float32 (re/im planes) ->
        (y_in [b, sym, sc, 2*rx_ant], h_in [b, T, sym, sc, 2*rx_ant]),
        channel order [re a0.., im a0..]. bf16 receivers round y before
        the transpose and the LS estimate after its FOCC average, as the
        JAX package does; the LS estimate reads the f32 input."""
        b, ant = y_planar.shape[0], y_planar.shape[1]
        bf16 = self.nrx_dtype == torch.bfloat16
        y_t = y_planar.to(self.nrx_dtype) if bf16 else y_planar
        y_in = y_t.permute(0, 2, 3, 4, 1).reshape(
            b, y_planar.shape[2], y_planar.shape[3], 2 * ant)
        h_in = self._ls.estimate_planar_dense(
            y_planar, out_dtype=self.nrx_dtype if bf16 else None)
        return y_in, h_in[:, :self.max_num_tx]

    def serve(self, params, y_planar: torch.Tensor,
              fused_iteration: bool | None = None):
        """params {"cgnn": tree}; y_planar [b, 4, 14, sc, 2] float32 ->
        (llr [b, T, 14, sc, num_bits], h_hat [b, T, 14, sc, 2*rx_ant]),
        float32, computed in `nrx_dtype` with all users active.

        Route, as the JAX entry picks it per call: every iteration in the
        iteration kernel at batch > 4 (fused_iteration=None), else the
        stack kernel alone; the whole-CGNN kernel if the receiver was built
        with fused_full."""
        b = y_planar.shape[0]
        if fused_iteration is None:
            fused_iteration = b > 4
        cfg = dataclasses.replace(self.cgnn_cfg,
                                  fused_iteration=fused_iteration)
        y_in, h_in = self._prepare_inputs(y_planar)
        ones = torch.ones((b, self.max_num_tx), device=y_planar.device)
        llrs, h_hats = cgnn_apply(params["cgnn"], cfg, y_in,
                                  self.pe, h_in, ones, ones[..., None],
                                  dtype=self.nrx_dtype)
        return llrs[-1][0], h_hats[-1]
