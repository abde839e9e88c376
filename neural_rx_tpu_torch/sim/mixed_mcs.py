"""Mixed-MCS evaluation: users on different MCS in one slot, one user's
bits read back.

The port's counterpart of `neural_rx_tpu/sim/mixed_mcs.py`. A one-hot
per-user MCS mask schedules the mix: user i on mcs_arr_eval[i % num_mcs]
by default, or a fixed mask [1 or b, T, num_mcs]. The transmitters of every
MCS are superposed through it, the noise variance is that of
mcs_arr_eval[0], and `__call__` returns (bits, b_hat, crc) of user
`ue_return` alone, decoded with the chain of mcs_arr_eval[0] (the MCS user
0 is on in the mixes the reference evaluates).

`MixedMCSE2EModel` receives with the neural receiver, which sees every
user's MCS through the mask; `MixedMCSBaselineModel` with the LS/lin (or
LS/nn) estimate, LMMSE detection and a max-log demap of user `ue_return`
at mcs_arr_eval[0]'s constellation. Draws come from a `torch.Generator` in
`EvalLink.draw`'s order; `forward` takes them as given, so a test can feed
the JAX package's own.
"""

from __future__ import annotations

import torch

from .. import tables
from ..channel.apply import apply_ofdm_channel
from ..kernels.ldpc import tb_decode_fast
from ..phy.chest import LSChannelEstimator
from ..phy.constellation import qam_points
from ..phy.mapping import demap_maxlog
from ..phy.nr.tb import tb_decode
from ..rx.baselines import lmmse_equalize
from .e2e import E2EModel


class MixedMCSE2EModel(E2EModel):
    """The neural receiver's E2E eval model returning one user's bits in a
    mixed-MCS slot. mcs_arr_eval_idx: every MCS of the configuration, in
    evaluation order; mcs_ue_mask: a fixed schedule (default: user i on
    mcs_arr_eval_idx[i % num_mcs])."""

    def __init__(self, sys_parameters, mcs_arr_eval_idx, ue_return: int = 0,
                 mcs_ue_mask: torch.Tensor | None = None,
                 kernels: bool = True, device="cuda"):
        super().__init__(sys_parameters, kernels=kernels, device=device)
        self.mcs_arr_eval = [int(i) for i in mcs_arr_eval_idx]
        if sorted(self.mcs_arr_eval) != list(range(self.num_mcs)):
            raise ValueError(f"a mixed-MCS order holds each of the "
                             f"{self.num_mcs} MCS once, got "
                             f"{self.mcs_arr_eval}")
        if not 0 <= ue_return < self.p.max_num_tx:
            raise ValueError(f"no user {ue_return}")
        self.ue_return = ue_return
        if mcs_ue_mask is None:
            mcs_ue_mask = [[float(i == self.mcs_arr_eval[u % self.num_mcs])
                            for i in range(self.num_mcs)]
                           for u in range(self.p.max_num_tx)]
        # [1 or b, T, num_mcs] on the device, uploaded once
        self._mask = torch.as_tensor(mcs_ue_mask, dtype=torch.float32,
                                     device=self.device).reshape(
            -1, self.p.max_num_tx, self.num_mcs)

    def mask(self, batch_size: int) -> torch.Tensor:
        """The schedule [b, T, num_mcs] float32 on the model's device."""
        return self._mask.expand(batch_size, -1, -1)

    def forward(self, params, bits, h: torch.Tensor, noise: torch.Tensor,
                num_it: int | None = None, fast_ldpc: bool = False):
        """Everything after the draws (bits: one tensor per MCS in
        evaluation order) -> (bits [b, tb_size] of mcs_arr_eval[0], b_hat
        [b, tb_size], crc [b]) of user `ue_return`."""
        b, b_hat, crc = super().forward(
            params, bits, h, noise, fast_ldpc=fast_ldpc, num_it=num_it,
            mcs_arr_eval_idx=self.mcs_arr_eval,
            mcs_ue_mask=self.mask(bits[0].shape[0]))
        ue = self.ue_return
        return b[:, ue], b_hat[:, ue], crc[:, ue]

    def __call__(self, params, generator: torch.Generator, batch_size: int,
                 ebno_db: float, num_it: int | None = None,
                 fast_ldpc: bool = False):
        """One Monte-Carlo batch: `draw` for every MCS, then `forward`."""
        bits, h, noise = self.draw(generator, batch_size, ebno_db,
                                   self.mcs_arr_eval)
        return self.forward(params, bits, h, noise, num_it=num_it,
                            fast_ldpc=fast_ldpc)


class MixedMCSBaselineModel(MixedMCSE2EModel):
    """The classical receiver in a mixed-MCS slot: LS/lin (chest_type
    "lslin", Sionna's slope-extrapolated interpolation) or LS/nn ("lsnn")
    estimate, per-RE LMMSE detection, max-log demap of user `ue_return` at
    mcs_arr_eval[0]'s constellation, flooding or layered decode of its
    transport block. LMMSE detection works per user, so the mix changes
    only the demapper's constellation. Weights: none (params unused)."""

    def __init__(self, sys_parameters, mcs_arr_eval_idx, ue_return: int = 0,
                 mcs_ue_mask: torch.Tensor | None = None,
                 chest_type: str = "lslin", kernels: bool = True,
                 device="cuda"):
        if chest_type not in ("lslin", "lsnn"):
            raise ValueError(f"chest_type lslin or lsnn, not {chest_type!r}")
        super().__init__(sys_parameters, mcs_arr_eval_idx, ue_return,
                         mcs_ue_mask, kernels=kernels, device=device)
        self.kernels = kernels
        self.rg = self.transmitter.resource_grid
        self.ls = LSChannelEstimator(
            self.rg, "lin_extrap" if chest_type == "lslin" else "nn")

    def forward(self, params, bits, h: torch.Tensor, noise: torch.Tensor,
                no: float, fast_ldpc: bool = False):
        """Everything after the draws (bits: one tensor per MCS in
        evaluation order); no: the noise variance of `noise`. Returns
        (bits, b_hat, crc) of user `ue_return`, as the neural model."""
        b = bits[0].shape[0]
        x = self.transmit(bits, self.mcs_arr_eval, self.mask(b))
        y = apply_ofdm_channel(x, h, None, noise=noise)
        h_hat = self.ls(y, no)[0]  # [b, ant, T, 14, sc]
        x_hat, no_eff = lmmse_equalize(y.permute(0, 2, 3, 1),
                                       h_hat.permute(0, 3, 4, 1, 2), no)
        ue, mcs0 = self.ue_return, self.mcs_arr_eval[0]
        tx = self.transmitters[mcs0]
        m = tx.num_bits_per_symbol
        points = tables.on_device(("qam_points", m), y.device,
                                  lambda: qam_points(m))
        llr = demap_maxlog(x_hat[..., ue], points, no_eff[..., ue])
        llr_flat = self.rg.demap_data(llr).reshape(b, -1)
        if fast_ldpc:
            b_hat, crc = tb_decode_fast(tx.configs[ue].tb, llr_flat,
                                        kernels=self.kernels)
        else:
            b_hat, crc = tb_decode(tx.configs[ue].tb, llr_flat)
        return bits[0][:, ue], b_hat, crc

    def __call__(self, params, generator: torch.Generator, batch_size: int,
                 ebno_db: float, num_it: int | None = None,
                 fast_ldpc: bool = False):
        bits, h, noise = self.draw(generator, batch_size, ebno_db,
                                   self.mcs_arr_eval)
        no = self.p.noise_variance(ebno_db, self.mcs_arr_eval[0])
        return self.forward(params, bits, h, noise, no, fast_ldpc=fast_ldpc)
