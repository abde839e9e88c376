"""End-to-end eval model: transmitter -> channel -> neural receiver.

The port's counterpart of `neural_rx_tpu/sim/e2e.py:E2EModel` in eval mode:
every DMRS port active, the configured slot, the transmitters of the
evaluated MCS superposed through a one-hot per-user MCS mask, the
configuration's constant carrier frequency offset if it has one, the
rate-adjusted noise variance of the first evaluated MCS
(`Parameters.noise_variance`), the configuration's channel (TDL-B100,
TDL-C300, DoubleTDL or AWGN), then the receiver's `apply` (LS estimate,
CGNN, per-user transport-block decode of the first evaluated MCS).

Randomness comes from one `torch.Generator` on the model's device, drawn in
a fixed order by `draw`: the bits of each evaluated MCS in order, the
channel (per user for a single-link TDL, the two links of DoubleTDL in
order), the noise. `forward` does everything after the draws, so a test can
feed it the JAX package's own bits, CFRs and noise. Training, trainable
constellations, masked pilots and the UMi/UMa/Dataset channels raise
`NotImplementedError`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..channel.apply import apply_ofdm_channel
from ..phy.misc import binary_source, complex_awgn
from ..rx.neural_rx import mcs_mask, receiver_for, resolve_device


def eval_order(mcs_arr_eval_idx, mcs_ue_mask, num_mcs: int) -> list:
    """The evaluated MCS, in order, as the JAX eval model reads its
    arguments: without a mask one MCS index (an int); with a mask every
    MCS, or the order given as a list."""
    if mcs_ue_mask is None:
        if not isinstance(mcs_arr_eval_idx, (int, np.integer)):
            raise TypeError("without mcs_ue_mask, mcs_arr_eval_idx is one "
                            "MCS index")
        order = [int(mcs_arr_eval_idx)]
    elif isinstance(mcs_arr_eval_idx, (int, np.integer)):
        order = list(range(num_mcs))
    else:
        order = [int(i) for i in mcs_arr_eval_idx]
    if not order or not all(0 <= i < num_mcs for i in order):
        raise ValueError(f"MCS indices {order} out of range: the "
                         f"configuration has {num_mcs} MCS")
    return order


def refuse_unported(p, training: bool = False, mesh=None):
    """NotImplementedError for what the eval models' transmitter and
    channel do not port."""
    why = None
    ct = p.channel_type_name
    if training:
        why = "training is the training slice's (ROADMAP A4)"
    elif mesh is not None:
        why = "a device mesh is the multi-GPU slice's (ROADMAP A6)"
    elif ct in ("UMi", "UMa"):
        why = f"the {ct} channel is the training slice's (ROADMAP A4)"
    elif ct == "Dataset":
        why = "the Dataset channel is the dataset slice's (ROADMAP A5)"
    elif p.custom_constellation or p.mask_pilots:
        why = ("trainable constellations and masked pilots are the "
               "training slice's (ROADMAP A4)")
    if why is not None:
        raise NotImplementedError(why)
    if p.channel_num_tx is not None and p.channel_num_tx > 1 \
            and p.channel_num_tx != p.max_num_tx:
        raise ValueError(f"{ct} is a {p.channel_num_tx}-user channel, the "
                         f"configuration has {p.max_num_tx} users")


class EvalLink:
    """The transmitters (one per MCS; `transmitter` is the first) and
    channel of one `sim.config.Parameters` in eval mode, and the draws of a
    Monte-Carlo batch; the eval models add a receiver."""

    def __init__(self, sys_parameters, device="cuda"):
        self.p = sys_parameters
        self.device = resolve_device(device)
        self.transmitters = self.p.transmitters
        self.transmitter = self.transmitters[0]
        self.num_mcs = len(self.transmitters)

    def _channel(self, generator: torch.Generator, batch_size: int
                 ) -> torch.Tensor:
        """h [b, rx_ant, T, ports, 14, sc] complex64 of one slot."""
        p = self.p
        rg = self.transmitter.resource_grid
        nsym, nsc = rg.num_ofdm_symbols, rg.num_subcarriers
        scs = p.carrier.subcarrier_spacing
        if p.channel_type_name == "AWGN":
            ports = p.num_antenna_ports
            return torch.full(
                (batch_size, p.num_rx_antennas, p.max_num_tx, ports, nsym,
                 nsc), 1.0 / np.sqrt(ports), dtype=torch.complex64,
                device=generator.device)
        if p.channel_num_tx == 1:  # a single link: one draw per user
            return torch.stack([
                p.channel_model(generator, batch_size, nsym, nsc, scs)
                for _ in range(p.max_num_tx)], dim=2)
        return p.channel_model(generator, batch_size, nsym, nsc, scs)

    def draw(self, generator: torch.Generator, batch_size: int,
             ebno_db: float, mcs_arr_eval=(0,)):
        """(bits, h [b, rx_ant, T, ports, 14, sc], noise [b, rx_ant, 14, sc]
        ~ CN(0, N0)) from `generator`, in that order: bits is a list with
        one [b, T, tb_size] tensor per evaluated MCS, in the order of
        mcs_arr_eval, and N0 is that of mcs_arr_eval[0]."""
        p = self.p
        rg = self.transmitter.resource_grid
        bits = [binary_source((batch_size, p.max_num_tx,
                               self.transmitters[idx].tb_size), generator)
                for idx in mcs_arr_eval]
        h = self._channel(generator, batch_size)
        noise = complex_awgn(
            (batch_size, p.num_rx_antennas, rg.num_ofdm_symbols,
             rg.num_subcarriers), p.noise_variance(ebno_db, mcs_arr_eval[0]),
            generator)
        return bits, h, noise

    def transmit(self, bits, order, mcs_ue_mask, active=None):
        """x [b, T, ports, 14, sc]: each evaluated MCS's transmitter on its
        bits (bits[i] for MCS order[i]) times its column of mcs_ue_mask
        [b, T, num_mcs], summed in order; inactive users (active [b, T])
        zeroed; the configuration's frequency offset applied."""
        x = None
        for b_i, idx in zip(bits, order):
            m = mcs_ue_mask[:, :, idx].to(torch.complex64)
            x_i = self.transmitters[idx](b_i) * m[:, :, None, None, None]
            x = x_i if x is None else x + x_i
        if active is not None:
            x = x * active.to(x.dtype)[:, :, None, None, None]
        if self.p.frequency_offset is not None:
            x = self.p.frequency_offset(x)
        return x


class E2EModel(EvalLink):
    """TX -> channel -> neural RX of one `sim.config.Parameters`, eval only.

    kernels=False: the receiver takes its kernels' plain versions on the
    same route (the kernels' oracle on the card)."""

    def __init__(self, sys_parameters, training: bool = False, mesh=None,
                 kernels: bool = True, device="cuda"):
        refuse_unported(sys_parameters, training, mesh)
        if sys_parameters.initial_chest != "ls":
            raise NotImplementedError(
                "the NN initial estimate is the training slice's (ROADMAP A4)")
        super().__init__(sys_parameters, device)
        self.receiver = receiver_for(self.p, kernels=kernels,
                                     device=self.device)

    def forward(self, params, bits, h: torch.Tensor, noise: torch.Tensor,
                active_dmrs: torch.Tensor | None = None,
                fast_ldpc: bool = False, output_nrx_h_hat: bool = False,
                num_it: int | None = None, mcs_arr_eval_idx=0,
                mcs_ue_mask: torch.Tensor | None = None):
        """Everything after the draws: `transmit` the bits (a list as
        `draw` gives it, or one MCS's tensor) in the configured slot with
        the inactive ports (active_dmrs [b, T], default all active) zeroed,
        y = sum h x + noise, receive and decode the first evaluated MCS.
        mcs_arr_eval_idx and mcs_ue_mask [b, T, num_mcs] as in the JAX
        package (`eval_order`): without a mask every user is on MCS
        mcs_arr_eval_idx; num_it cuts the CGNN.

        Returns (b, b_hat, crc) as the JAX package's eval model does: the
        first evaluated MCS's bits [b, T, tb_size] and b_hat zeroed for
        inactive ports, and the error-counting CRC status [b, T] with
        inactive ports forced to pass; with output_nrx_h_hat also (h_true
        [b, T, 14, sc, 2*rx_ant], h_hat refined, h_hat of the LS
        estimate)."""
        bits = [bits] if isinstance(bits, torch.Tensor) else list(bits)
        order = eval_order(mcs_arr_eval_idx, mcs_ue_mask, self.num_mcs)
        if len(bits) != len(order):
            raise ValueError(f"{len(bits)} bit tensors for the evaluated "
                             f"MCS {order}")
        if active_dmrs is None:
            active_dmrs = torch.ones(bits[0].shape[:2], device=h.device)
        active = active_dmrs.to(torch.float32)
        if mcs_ue_mask is None:
            mcs_ue_mask = mcs_mask(active.shape, order[0], self.num_mcs,
                                   active.device)
        x = self.transmit(bits, order, mcs_ue_mask, active)
        y = apply_ofdm_channel(x, h, None, noise=noise)
        b_hat, h_ref, h_init, crc = self.receiver.apply(
            params, y, active, mcs_arr_eval=tuple(order),
            mcs_ue_mask=mcs_ue_mask, num_it=num_it, fast_ldpc=fast_ldpc)
        am = active[..., None]
        b = bits[0] * am
        b_hat = b_hat * am
        crc = torch.where(active > 0, crc, torch.ones_like(crc))
        if output_nrx_h_hat:
            h_true = self.receiver.preprocess_channel_ground_truth(h)
            return b, b_hat, crc, h_true, h_ref, h_init
        return b, b_hat, crc

    def __call__(self, params, generator: torch.Generator, batch_size: int,
                 ebno_db: float, fast_ldpc: bool = False,
                 output_nrx_h_hat: bool = False, num_it: int | None = None,
                 mcs_arr_eval_idx=0, mcs_ue_mask: torch.Tensor | None = None):
        """One Monte-Carlo batch: `draw` from `generator` (on the model's
        device) for the evaluated MCS, then `forward`."""
        order = eval_order(mcs_arr_eval_idx, mcs_ue_mask, self.num_mcs)
        bits, h, noise = self.draw(generator, batch_size, ebno_db, order)
        return self.forward(params, bits, h, noise, fast_ldpc=fast_ldpc,
                            output_nrx_h_hat=output_nrx_h_hat, num_it=num_it,
                            mcs_arr_eval_idx=mcs_arr_eval_idx,
                            mcs_ue_mask=mcs_ue_mask)
