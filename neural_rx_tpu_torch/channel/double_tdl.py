"""DoubleTDL evaluation channel: TDL-B 100 ns / 400 Hz (user 0) and TDL-C
300 ns / 100 Hz (user 1).

The port's copy of `neural_rx_tpu/channel/double_tdl.py`: two independent
TDL links with antenna correlation low/medium/high (alpha/beta = 0/0,
0.9/0.3, 0.9/0.9), stacked along the user axis. The speeds come from the
Doppler frequencies, not from the configuration's UT velocities.
"""

from __future__ import annotations

import torch

from .tdl import SPEED_OF_LIGHT, TDLChannel, exp_correlation_matrix

_CORR = {"low": (0.0, 0.0), "medium": (0.9, 0.3), "high": (0.9, 0.9)}


class DoubleTDLChannel:
    """Two-UE benchmark channel (exactly 2 users)."""

    def __init__(self, carrier_frequency: float, num_rx_ant: int = 4,
                 num_tx_ant: int = 2, norm_channel: bool = False,
                 correlation: str = "low"):
        alpha, beta = _CORR[correlation]
        rx_corr = exp_correlation_matrix(num_rx_ant, alpha)
        tx_corr = exp_correlation_matrix(num_tx_ant, beta)
        links = (("B", 100e-9, 400.0), ("C", 300e-9, 100.0))
        self.links = [
            TDLChannel(model, spread, carrier_frequency,
                       max_speed=doppler * SPEED_OF_LIGHT / carrier_frequency,
                       num_rx_ant=num_rx_ant, num_tx_ant=num_tx_ant,
                       rx_corr=rx_corr, tx_corr=tx_corr,
                       normalize=norm_channel)
            for model, spread, doppler in links]

    def draw(self, generator: torch.Generator, batch_size: int):
        """The draws of the two links, user 0's first."""
        return [link.draw(generator, batch_size) for link in self.links]

    def cfr(self, draws, num_symbols: int, num_sc: int,
            subcarrier_spacing: float) -> torch.Tensor:
        """h [batch, num_rx_ant, 2, num_tx_ant, sym, sc] complex64."""
        return torch.stack([
            link.cfr(d, num_symbols, num_sc, subcarrier_spacing)
            for link, d in zip(self.links, draws)], dim=2)

    def __call__(self, generator: torch.Generator, batch_size: int,
                 num_symbols: int, num_sc: int, subcarrier_spacing: float
                 ) -> torch.Tensor:
        return self.cfr(self.draw(generator, batch_size), num_symbols, num_sc,
                        subcarrier_spacing)
