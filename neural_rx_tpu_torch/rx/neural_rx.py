"""NeuralPUSCHReceiver: dense LS estimate + CGNN (+ transport-block decode).

Counterpart of `neural_rx_tpu/rx/neural_rx.py:NeuralPUSCHReceiver`
(`__init__`, the planar `_prepare_inputs` and the eval forward `apply`),
plus `serve`, which returns what the JAX package's
`__graft_entry__.entry()` function returns: the final-iteration LLR grid
and the refined channel estimate, by the same batch-adaptive route. `apply`
takes that route too and decodes each user's transport block;
`preprocess_channel_ground_truth` puts a true channel into the layout of
the channel estimates.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import tables
from ..kernels.ldpc import tb_decode_fast
from ..phy.chest import LSChannelEstimator
from ..phy.nr.tb import tb_decode
from .cgnn import CGNNConfig, cgnn_apply, pilot_positional_encoding


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def receiver_for(p, nrx_dtype=None, fused_full: bool = False,
                 kernels: bool = True, device="cuda"
                 ) -> "NeuralPUSCHReceiver":
    """The neural receiver of a `sim.config.Parameters` (its resource grid,
    MCS list and [neural_receiver] widths), in `nrx_dtype` (default: the
    configuration's)."""
    return NeuralPUSCHReceiver(
        p.resource_grid, [c[0].num_bits_per_symbol for c in p.pusch_configs],
        num_rx_ant=p.num_rx_antennas,
        max_num_tx=p.max_num_tx, num_it=p.num_nrx_iter, d_s=p.d_s,
        num_units_init=p.num_units_init, num_units_agg=p.num_units_agg,
        num_units_state=p.num_units_state,
        num_units_readout=p.num_units_readout,
        layer_type_conv=p.layer_type_conv,
        var_mcs_masking=p.mcs_var_mcs_masking,
        nrx_dtype=p.nrx_dtype if nrx_dtype is None else nrx_dtype,
        fused_full=fused_full, kernels=kernels, device=device)


class NeuralPUSCHReceiver:
    """Static configuration + functional apply for the neural receiver.

    resource_grid: the PUSCH `ResourceGrid` of the UEs (its configs carry
    each UE's transport-block chain for `apply`);
    num_bits_per_symbol: one entry per MCS (`sim.config.Parameters`).
    fused_full: serve through the whole-CGNN kernel (the JAX entry's
    `NRX_DEPLOY_MEGA=1` route); kernels=False: every fused route, and the
    layered LDPC decoder, takes its kernel's plain version.
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
        # precoders [T, ports] of the users
        self.w = np.stack([c.precoding_matrix()[:, 0]
                           for c in self.rg.configs])[:max_num_tx]

    def preprocess_channel_ground_truth(self, h: torch.Tensor
                                        ) -> torch.Tensor:
        """h [b, rx_ant, T, ports, sym, sc] complex -> the effective
        (precoded) channel of each user [b, T, sym, sc, 2*rx_ant] float32,
        channel order [re a0.., im a0..] as the channel estimates."""
        w = tables.on_device(("precoders", self.w.tobytes()), h.device,
                             lambda: self.w)
        h_eff = torch.einsum("batpsc,tp->batsc", h, w)
        return torch.cat([h_eff.real.movedim(1, -1),
                          h_eff.imag.movedim(1, -1)], dim=-1)

    def _prepare_inputs(self, y_planar: torch.Tensor, slot_idx=None):
        """y_planar [b, rx_ant, sym, sc, 2] float32 (re/im planes) ->
        (y_in [b, sym, sc, 2*rx_ant], h_in [b, T, sym, sc, 2*rx_ant]),
        channel order [re a0.., im a0..]. bf16 receivers round y before
        the transpose and the LS estimate after its FOCC average, as the
        JAX package does; the LS estimate reads the f32 input. slot_idx
        selects the DMRS values the transmitter used (default: the
        configured slot)."""
        b, ant = y_planar.shape[0], y_planar.shape[1]
        bf16 = self.nrx_dtype == torch.bfloat16
        y_t = y_planar.to(self.nrx_dtype) if bf16 else y_planar
        y_in = y_t.permute(0, 2, 3, 4, 1).reshape(
            b, y_planar.shape[2], y_planar.shape[3], 2 * ant)
        h_in = self._ls.estimate_planar(
            y_planar, slot_idx=slot_idx,
            out_dtype=self.nrx_dtype if bf16 else None)
        return y_in, h_in[:, :self.max_num_tx]

    def _cgnn(self, params, y_planar: torch.Tensor, active_tx: torch.Tensor,
              fused_iteration: bool | None, slot_idx=None):
        """(llr, h_hat, h_in) of the final iteration, by the route `serve`
        documents, with the users of active_tx [b, T] active."""
        if fused_iteration is None:
            fused_iteration = y_planar.shape[0] > 4
        cfg = dataclasses.replace(self.cgnn_cfg,
                                  fused_iteration=fused_iteration)
        y_in, h_in = self._prepare_inputs(y_planar, slot_idx)
        llrs, h_hats = cgnn_apply(params["cgnn"], cfg, y_in, self.pe, h_in,
                                  active_tx, torch.ones_like(active_tx)[
                                      ..., None], dtype=self.nrx_dtype)
        return llrs[-1][0], h_hats[-1], h_in

    def serve(self, params, y_planar: torch.Tensor,
              fused_iteration: bool | None = None):
        """params {"cgnn": tree}; y_planar [b, 4, 14, sc, 2] float32 ->
        (llr [b, T, 14, sc, num_bits], h_hat [b, T, 14, sc, 2*rx_ant]),
        float32, computed in `nrx_dtype` with all users active.

        Route, as the JAX entry picks it per call: every iteration in the
        iteration kernel at batch > 4 (fused_iteration=None), else the
        stack kernel alone; the whole-CGNN kernel if the receiver was built
        with fused_full."""
        ones = torch.ones((y_planar.shape[0], self.max_num_tx),
                          device=y_planar.device)
        llr, h_hat, _ = self._cgnn(params, y_planar, ones, fused_iteration)
        return llr, h_hat

    def apply(self, params, y: torch.Tensor, active_tx: torch.Tensor,
              mcs_arr_eval=(0,), mcs_ue_mask=None, num_it: int | None = None,
              fast_ldpc: bool = False, slot_idx=None):
        """Eval forward: (b_hat [b, T, tb_size], h_hat [b, T, 14, sc,
        2*rx_ant], h_in (the LS estimate fed to the CGNN), crc [b, T]).

        y: [b, rx_ant, 14, sc] complex64; active_tx: [b, T]. The CGNN takes
        `serve`'s route in `nrx_dtype`; then each user's transport block is
        decoded with its own scrambling: by the flooding boxplus decoder
        (fast_ldpc=False, the reference's), or by the layered min-sum
        kernel (fast_ldpc=True, one launch per user on the card; its plain
        version if the receiver was built with kernels=False). Only the
        single-MCS eval with the configured iteration count is ported."""
        if tuple(mcs_arr_eval) != (0,) or mcs_ue_mask is not None or \
                num_it not in (None, self.cgnn_cfg.num_it):
            raise NotImplementedError(
                "only the single-MCS eval with the configured iterations is "
                "ported")
        b = y.shape[0]
        y_planar = torch.stack([y.real, y.imag], dim=-1)
        llr, h_hat, h_in = self._cgnn(params, y_planar,
                                      active_tx.to(torch.float32), None,
                                      slot_idx)
        llr_flat = self.rg.demap_data(llr).reshape(b, self.max_num_tx, -1)
        decode = functools.partial(
            tb_decode_fast, kernels=self.cgnn_cfg.kernels) if fast_ldpc \
            else tb_decode
        b_hats, crcs = zip(*(decode(self.rg.configs[ue].tb, llr_flat[:, ue])
                             for ue in range(self.max_num_tx)))
        return torch.stack(b_hats, 1), h_hat, h_in, torch.stack(crcs, 1)
