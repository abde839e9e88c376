"""End-to-end eval model: transmitter -> channel -> neural receiver.

The port's counterpart of `neural_rx_tpu/sim/e2e.py:E2EModel` in eval mode:
every DMRS port active, the configured slot, one MCS, the rate-adjusted
noise variance (`Parameters.noise_variance`), the configuration's channel
(TDL-B100, TDL-C300, DoubleTDL or AWGN), then the receiver's `apply`
(LS estimate, CGNN, per-user transport-block decode).

Randomness comes from one `torch.Generator` on the model's device, drawn in
a fixed order by `draw`: the bits, the channel (per user for a single-link
TDL, the two links of DoubleTDL in order), the noise. `forward` does
everything after the draws, so a test can feed it the JAX package's own
bits, CFRs and noise. Training, trainable constellations, masked pilots,
several MCS, a carrier frequency offset and the UMi/UMa/Dataset channels
raise `NotImplementedError`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..channel.apply import apply_ofdm_channel
from ..phy.misc import binary_source, complex_awgn
from ..rx.neural_rx import receiver_for, resolve_device


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
    elif p.frequency_offset is not None:
        why = "a carrier frequency offset is the training slice's (A4)"
    elif p.custom_constellation or p.mask_pilots:
        why = ("trainable constellations and masked pilots are the "
               "training slice's (ROADMAP A4)")
    elif len(p.mcs_index) != 1:
        why = "several MCS are the training slice's (ROADMAP A4)"
    if why is not None:
        raise NotImplementedError(why)
    if p.channel_num_tx is not None and p.channel_num_tx > 1 \
            and p.channel_num_tx != p.max_num_tx:
        raise ValueError(f"{ct} is a {p.channel_num_tx}-user channel, the "
                         f"configuration has {p.max_num_tx} users")


class EvalLink:
    """The transmitter (first MCS) and channel of one
    `sim.config.Parameters` in eval mode, and the draws of a Monte-Carlo
    batch; the eval models add a receiver."""

    def __init__(self, sys_parameters, device="cuda"):
        self.p = sys_parameters
        self.device = resolve_device(device)
        self.transmitter = self.p.transmitters[0]

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
             ebno_db: float):
        """(bits [b, T, tb_size], h [b, rx_ant, T, ports, 14, sc], noise
        [b, rx_ant, 14, sc] ~ CN(0, N0)) from `generator`, in that order."""
        p = self.p
        rg = self.transmitter.resource_grid
        bits = binary_source((batch_size, p.max_num_tx,
                              self.transmitter.tb_size), generator)
        h = self._channel(generator, batch_size)
        noise = complex_awgn(
            (batch_size, p.num_rx_antennas, rg.num_ofdm_symbols,
             rg.num_subcarriers), p.noise_variance(ebno_db), generator)
        return bits, h, noise


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

    def forward(self, params, bits: torch.Tensor, h: torch.Tensor,
                noise: torch.Tensor, active_dmrs: torch.Tensor | None = None,
                fast_ldpc: bool = False, output_nrx_h_hat: bool = False,
                num_it: int | None = None):
        """Everything after the draws: transmit `bits` in the configured
        slot, zero the inactive ports (active_dmrs [b, T], default all
        active), y = sum h x + noise, receive and decode.

        Returns (b, b_hat, crc) as the JAX package's eval model does: bits
        [b, T, tb_size] and b_hat zeroed for inactive ports, and the
        error-counting CRC status [b, T] with inactive ports forced to pass;
        with output_nrx_h_hat also (h_true [b, T, 14, sc, 2*rx_ant],
        h_hat refined, h_hat of the LS estimate)."""
        if active_dmrs is None:
            active_dmrs = torch.ones(bits.shape[:2], device=bits.device)
        active = active_dmrs.to(torch.float32)
        x = self.transmitter(bits)
        x = x * active.to(x.dtype)[:, :, None, None, None]
        y = apply_ofdm_channel(x, h, None, noise=noise)
        b_hat, h_ref, h_init, crc = self.receiver.apply(
            params, y, active, num_it=num_it, fast_ldpc=fast_ldpc)
        am = active[..., None]
        b = bits * am
        b_hat = b_hat * am
        crc = torch.where(active > 0, crc, torch.ones_like(crc))
        if output_nrx_h_hat:
            h_true = self.receiver.preprocess_channel_ground_truth(h)
            return b, b_hat, crc, h_true, h_ref, h_init
        return b, b_hat, crc

    def __call__(self, params, generator: torch.Generator, batch_size: int,
                 ebno_db: float, fast_ldpc: bool = False,
                 output_nrx_h_hat: bool = False, num_it: int | None = None):
        """One Monte-Carlo batch: `draw` from `generator` (on the model's
        device), then `forward`."""
        bits, h, noise = self.draw(generator, batch_size, ebno_db)
        return self.forward(params, bits, h, noise, fast_ldpc=fast_ldpc,
                            output_nrx_h_hat=output_nrx_h_hat, num_it=num_it)
