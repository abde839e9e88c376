"""NeuralPUSCHReceiver: dense LS estimate + CGNN (+ transport-block decode).

Counterpart of `neural_rx_tpu/rx/neural_rx.py:NeuralPUSCHReceiver`
(`__init__`, the planar `_prepare_inputs`, the eval forward `apply` and
the training forward `training_loss`), plus `serve`, which returns what the
JAX package's `__graft_entry__.entry()` function returns: the
final-iteration LLR grid and the refined channel estimate, by the same
batch-adaptive route. `apply` takes that route too and decodes each user's
transport block; `training_loss` takes the plain layers under autograd and
returns the BCE data loss and the channel-estimate MSE;
`preprocess_channel_ground_truth` puts a true channel into the layout of
the channel estimates; `init_params` makes seed-made parameters. The
end-to-end configurations feed the CGNN without the LS estimate and with
the pilot REs of y zeroed (`mask_pilots`). On a mesh (`dist/`) the CGNN of
`serve` and `apply` runs on this rank's subcarrier block, and the LLRs and
channel estimates are gathered over the grid group before decoding.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import tables
from ..dist.mesh import constrain, gather_grid
from ..kernels.ldpc import tb_decode_fast
from ..phy.chest import LSChannelEstimator
from ..phy.nr.tb import tb_decode
from .cgnn import (CGNNConfig, cgnn_apply, count_params, init_cgnn_params,
                   pilot_positional_encoding)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def mcs_mask(shape, mcs_idx: int, num_mcs: int, device) -> torch.Tensor:
    """[*shape, num_mcs] float32 one-hot: every user on MCS mcs_idx."""
    mask = torch.zeros(tuple(shape) + (num_mcs,), device=device)
    mask[..., mcs_idx] = 1.0
    return mask


def receiver_for(p, nrx_dtype=None, fused_full: bool = False,
                 kernels: bool = True, device="cuda"
                 ) -> "NeuralPUSCHReceiver":
    """The neural receiver of a `sim.config.Parameters` (its resource grid,
    MCS list and [neural_receiver] widths), in `nrx_dtype` (default: the
    configuration's)."""
    return NeuralPUSCHReceiver(
        p.resource_grid, [c[0].num_bits_per_symbol for c in p.pusch_configs],
        tb_configs=[[c.tb for c in tx.configs] for tx in p.transmitters],
        num_rx_ant=p.num_rx_antennas,
        max_num_tx=p.max_num_tx, num_it=p.num_nrx_iter, d_s=p.d_s,
        num_units_init=p.num_units_init, num_units_agg=p.num_units_agg,
        num_units_state=p.num_units_state,
        num_units_readout=p.num_units_readout,
        layer_type_conv=p.layer_type_conv,
        var_mcs_masking=p.mcs_var_mcs_masking,
        initial_chest=p.initial_chest in ("ls", "nn"),
        mask_pilots=p.mask_pilots,
        nrx_dtype=p.nrx_dtype if nrx_dtype is None else nrx_dtype,
        fused_full=fused_full, kernels=kernels, device=device)


class NeuralPUSCHReceiver:
    """Static configuration + functional apply for the neural receiver.

    resource_grid: the PUSCH `ResourceGrid` of the UEs (the same for every
    MCS); num_bits_per_symbol: one entry per MCS (`sim.config.Parameters`);
    tb_configs: [mcs][ue] transport-block chains for `apply` (default: the
    grid's configs, one MCS); initial_chest: whether the CGNN takes the LS
    estimate; mask_pilots: zero y's pilot REs before the CGNN (the
    end-to-end configurations, whose pilots carry no energy; not with the
    LS estimate).
    fused_full: serve through the whole-CGNN kernel (the JAX entry's
    `NRX_DEPLOY_MEGA=1` route); kernels=False: every fused route, and the
    layered LDPC decoder, takes its kernel's plain version. mesh
    (`dist.mesh.Mesh`, optional): the CGNN runs on this rank's block of the
    subcarrier axis (`cgnn_apply(mesh=)`); the LS estimate before it is
    computed at full width on every rank of a grid group (its nearest
    pilot and FOCC pairs then need no halo), and its outputs are gathered
    over the grid group. The batch block is the caller's.
    """

    def __init__(self, resource_grid, num_bits_per_symbol,
                 num_rx_ant: int, max_num_tx: int,
                 num_it: int, d_s: int, num_units_init, num_units_agg,
                 num_units_state, num_units_readout,
                 layer_type_conv: str = "sepconv",
                 var_mcs_masking: bool = False,
                 initial_chest: bool = True,
                 mask_pilots: bool = False,
                 nrx_dtype=torch.float32,
                 fused_full: bool = False,
                 kernels: bool = True,
                 device="cuda", tb_configs=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rg = resource_grid
        self.tb_configs = tb_configs or [[c.tb for c in resource_grid.configs]]
        if len(self.tb_configs) != len(num_bits_per_symbol):
            raise ValueError(f"{len(self.tb_configs)} MCS of transport-block "
                             f"chains for {len(num_bits_per_symbol)} MCS")
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
            initial_chest=initial_chest,
            fused_convs=True,
            fused_full=fused_full,
            kernels=kernels)

        # Positional encoding from the configured slot's DMRS positions,
        # [max_num_tx, sym, sc, 2]
        slot = self.rg.configs[0].carrier.slot_number
        pe = pilot_positional_encoding(self.rg.dmrs_grids[slot],
                                       self.rg.pilot_mask)[:max_num_tx]
        self.pe = torch.as_tensor(pe, device=self.device)
        if initial_chest and mask_pilots:
            raise ValueError("the LS estimate needs the pilots: no "
                             "initial estimate with masked pilots")
        self.mask_pilots = mask_pilots
        self._ls = LSChannelEstimator(self.rg) if initial_chest else None
        # precoders [T, ports] of the users
        self.w = np.stack([c.precoding_matrix()[:, 0]
                           for c in self.rg.configs])[:max_num_tx]

    @property
    def num_mcs(self) -> int:
        return self.cgnn_cfg.num_mcs

    def num_params(self, params) -> int:
        """Number of parameter values in params (`rx.cgnn.count_params`;
        nrx_rt: 142,922)."""
        return count_params(params)

    def init_params(self, generator: torch.Generator) -> dict:
        """{"cgnn": tree} of seed-made parameters (`init_cgnn_params`) on
        the receiver's device."""
        tree = init_cgnn_params(self.cgnn_cfg, generator)
        return {"cgnn": _to(tree, self.device)}

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
        (y_in [b, sym, sc, 2*rx_ant], h_in [b, T, sym, sc, 2*rx_ant] or None
        without the LS estimate), channel order [re a0.., im a0..]. With
        masked pilots y's pilot REs are zeroed first. bf16 receivers round y
        before the transpose and the LS estimate after its FOCC average, as
        the JAX package does; the LS estimate reads the f32 input. slot_idx
        selects the DMRS values the transmitter used (default: the
        configured slot; an int or a 0-dim tensor on the device)."""
        b, ant = y_planar.shape[0], y_planar.shape[1]
        if self.mask_pilots:
            pilot = tables.on_device(
                ("pilot_mask", self.rg._key), y_planar.device,
                lambda: self.rg.pilot_mask)[None, None, :, :, None]
            y_planar = torch.where(pilot, 0.0, y_planar)
        bf16 = self.nrx_dtype == torch.bfloat16
        y_t = y_planar.to(self.nrx_dtype) if bf16 else y_planar
        y_in = y_t.permute(0, 2, 3, 4, 1).reshape(
            b, y_planar.shape[2], y_planar.shape[3], 2 * ant)
        if self._ls is None:
            return y_in, None
        h_in = self._ls.estimate_planar(
            y_planar, slot_idx=slot_idx,
            out_dtype=self.nrx_dtype if bf16 else None)
        return y_in, h_in[:, :self.max_num_tx]

    def _cgnn(self, params, y_planar: torch.Tensor, active_tx: torch.Tensor,
              fused_iteration: bool | None, slot_idx=None, mcs_ue_mask=None,
              num_it: int | None = None):
        """(llrs [per MCS], h_hat, h_in) after iteration num_it (default:
        all), by the route `serve` documents, with the users of active_tx
        [b, T] active and on the MCS of mcs_ue_mask [b, T, num_mcs]
        (default: the first)."""
        if fused_iteration is None:
            fused_iteration = y_planar.shape[0] > 4
        cfg = dataclasses.replace(self.cgnn_cfg,
                                  fused_iteration=fused_iteration)
        if mcs_ue_mask is None:
            mcs_ue_mask = mcs_mask(active_tx.shape, 0, self.num_mcs,
                                   active_tx.device)
        y_in, h_in = self._prepare_inputs(y_planar, slot_idx)
        mesh = self.mesh if self.mesh is not None and self.mesh.grid > 1 \
            else None
        if mesh is None:
            llrs, h_hats = cgnn_apply(params["cgnn"], cfg, y_in, self.pe,
                                      h_in, active_tx, mcs_ue_mask,
                                      num_it=num_it, dtype=self.nrx_dtype)
            return llrs[-1], h_hats[-1], h_in

        def shard(x, sc_axis):
            return None if x is None else constrain(x, mesh, None, sc_axis)
        llrs, h_hats = cgnn_apply(
            params["cgnn"], cfg, shard(y_in, 2), shard(self.pe, 2),
            shard(h_in, 3), active_tx, mcs_ue_mask, num_it=num_it,
            dtype=self.nrx_dtype, mesh=mesh)
        return ([gather_grid(llr, mesh, 3) for llr in llrs[-1]],
                gather_grid(h_hats[-1], mesh, 3), h_in)

    def serve(self, params, y_planar: torch.Tensor,
              fused_iteration: bool | None = None):
        """params {"cgnn": tree}; y_planar [b, 4, 14, sc, 2] float32 ->
        (llr [b, T, 14, sc, num_bits], h_hat [b, T, 14, sc, 2*rx_ant]),
        float32, computed in `nrx_dtype` with all users active on the first
        MCS.

        Route, as the JAX entry picks it per call: every iteration in the
        iteration kernel at batch > 4 (fused_iteration=None), else the
        stack kernel alone; the whole-CGNN kernel if the receiver was built
        with fused_full (one MCS)."""
        ones = torch.ones((y_planar.shape[0], self.max_num_tx),
                          device=y_planar.device)
        llrs, h_hat, _ = self._cgnn(params, y_planar, ones, fused_iteration)
        return llrs[0], h_hat

    def apply(self, params, y: torch.Tensor, active_tx: torch.Tensor,
              mcs_arr_eval=(0,), mcs_ue_mask=None, num_it: int | None = None,
              fast_ldpc: bool = False, slot_idx=None):
        """Eval forward: (b_hat [b, T, tb_size], h_hat [b, T, 14, sc,
        2*rx_ant], h_in (the LS estimate fed to the CGNN), crc [b, T]).

        y: [b, rx_ant, 14, sc] complex64; active_tx: [b, T]. mcs_ue_mask
        [b, T, num_mcs] puts each user on one MCS (default: every user on
        mcs_arr_eval[0]); num_it cuts the CGNN after that many iterations.
        The CGNN takes `serve`'s route in `nrx_dtype`; then the LLRs of
        MCS mcs_arr_eval[0] are decoded, each user's transport block with
        that MCS's chain and the user's scrambling, as the JAX package does
        (in a mixed slot only the users on that MCS decode meaningfully):
        by the flooding boxplus decoder (fast_ldpc=False, the reference's),
        or by the layered min-sum kernel (fast_ldpc=True, one launch per
        user on the card; its plain version if the receiver was built with
        kernels=False)."""
        b = y.shape[0]
        mcs0 = mcs_arr_eval[0]
        if not 0 <= mcs0 < self.num_mcs:
            raise ValueError(f"MCS index {mcs0} out of range: the receiver "
                             f"has {self.num_mcs} MCS")
        active = active_tx.to(torch.float32)
        if mcs_ue_mask is None:
            mcs_ue_mask = mcs_mask(active.shape, mcs0, self.num_mcs, y.device)
        y_planar = torch.stack([y.real, y.imag], dim=-1)
        llrs, h_hat, h_in = self._cgnn(params, y_planar, active, None,
                                       slot_idx, mcs_ue_mask, num_it)
        llr_flat = self.rg.demap_data(llrs[mcs0]).reshape(
            b, self.max_num_tx, -1)
        decode = functools.partial(
            tb_decode_fast, kernels=self.cgnn_cfg.kernels) if fast_ldpc \
            else tb_decode
        b_hats, crcs = zip(*(decode(self.tb_configs[mcs0][ue],
                                    llr_flat[:, ue])
                             for ue in range(self.max_num_tx)))
        return torch.stack(b_hats, 1), h_hat, h_in, torch.stack(crcs, 1)

    def training_loss(self, params, y: torch.Tensor, active_tx: torch.Tensor,
                      labels, h: torch.Tensor | None,
                      mcs_ue_mask: torch.Tensor, mcs_arr_eval=None,
                      apply_multiloss: bool = False,
                      num_it: int | None = None, slot_idx=None):
        """Training forward: (loss_data, loss_chest), float32 scalars,
        differentiable in params.

        y: [b, rx_ant, 14, sc] complex64; active_tx [b, T]; labels: one
        coded-bit tensor [b, T, G] per MCS of mcs_arr_eval (default: every
        MCS), the transmitted bits; h: the true CFR [b, rx_ant, T, ports,
        14, sc] or None; mcs_ue_mask [b, T, num_mcs]; slot_idx: the slot
        whose DMRS was sent. The CGNN runs its plain layers
        (`cgnn_apply(training=True)`), with the readouts after every
        iteration if apply_multiloss. loss_data sums, over the readout
        points and the MCS, the mean over all entries of BCE with logits
        (softplus(llr) - label * llr, llr = log p1/p0) times the user's MCS
        mask and activity; loss_chest sums over the readout points the mean
        squared error of the channel readout against the precoded true
        channel, times the activity. Neither is renormalised by the share
        of active entries, as in the JAX package."""
        if mcs_arr_eval is None:
            mcs_arr_eval = list(range(self.num_mcs))
        active = active_tx.to(torch.float32)
        y_planar = torch.stack([y.real, y.imag], dim=-1)
        y_in, h_in = self._prepare_inputs(y_planar, slot_idx)
        llrs, h_hats = cgnn_apply(
            params["cgnn"], self.cgnn_cfg, y_in, self.pe, h_in, active,
            mcs_ue_mask, num_it=num_it, dtype=self.nrx_dtype, training=True,
            apply_multiloss=apply_multiloss)
        b = y.shape[0]
        loss_data = torch.zeros((), device=y.device)
        for llrs_it in llrs:
            for li, idx in enumerate(mcs_arr_eval):
                llr = self.rg.demap_data(llrs_it[idx]).reshape(
                    b, self.max_num_tx, -1)
                bce = torch.nn.functional.softplus(llr) - labels[li] * llr
                m = (mcs_ue_mask[:, :, idx] * active)[..., None]
                loss_data = loss_data + (bce * m).mean()
        loss_chest = torch.zeros((), device=y.device)
        if h is not None:
            h_label = self.preprocess_channel_ground_truth(h)
            for hh in h_hats:
                se = (h_label - hh) ** 2
                loss_chest = loss_chest + (
                    se * active[:, :, None, None, None]).mean()
        return loss_data, loss_chest


def _to(tree, device):
    """A parameter tree with every leaf moved to `device`."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
