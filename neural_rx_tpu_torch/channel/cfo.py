"""Carrier frequency offset impairment.

The port's counterpart of `neural_rx_tpu/channel/cfo.py`: a per-user
offset, relative to the sampling rate, applied in the time domain (OFDM
modulate the frequency-domain grid, multiply by exp(j 2 pi fo t),
demodulate). At eval the offset is constant, its maximum; otherwise each
user's offset is drawn uniformly from [-max, max] by a `torch.Generator`.
"""

from __future__ import annotations

import math

import torch

from ..phy.ofdm import ofdm_demodulate, ofdm_modulate


class FrequencyOffset:
    def __init__(self, max_rel_offset: float, cp_length: int = 0,
                 constant_offset: bool = False):
        self.max_rel_offset = float(max_rel_offset)
        self.min_rel_offset = (self.max_rel_offset if constant_offset
                               else -self.max_rel_offset)
        self.cp_length = cp_length

    def draw(self, generator: torch.Generator | None, batch: int,
             num_tx: int) -> torch.Tensor:
        """Relative offsets fo [batch, num_tx, 1, 1] float32 on the
        generator's device: the constant offset without a draw, or
        U(min, max) from `generator`."""
        if self.min_rel_offset == self.max_rel_offset:
            device = None if generator is None else generator.device
            return torch.full((batch, num_tx, 1, 1), self.max_rel_offset,
                              dtype=torch.float32, device=device)
        u = torch.rand((batch, num_tx, 1, 1), generator=generator,
                       device=generator.device)
        return self.min_rel_offset + u * (self.max_rel_offset
                                          - self.min_rel_offset)

    def apply(self, x: torch.Tensor, fo: torch.Tensor) -> torch.Tensor:
        """x [batch, num_tx, num_ports, num_sym, fft] frequency-domain
        grids shifted by the offsets fo [batch, num_tx, 1, 1]."""
        xt = ofdm_modulate(x, self.cp_length)
        t = torch.arange(xt.shape[-1], dtype=torch.float32, device=x.device)
        phase = 2.0 * math.pi * fo.to(x.device) * t
        xt = xt * torch.exp(1j * phase.to(torch.complex64))
        return ofdm_demodulate(xt, x.shape[-1], self.cp_length)

    def __call__(self, x: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        if self.max_rel_offset == 0.0 and self.min_rel_offset == 0.0:
            return x
        return self.apply(x, self.draw(generator, x.shape[0], x.shape[1]))
