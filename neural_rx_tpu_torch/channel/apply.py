"""Frequency-domain OFDM channel application + AWGN.

The port's copy of `neural_rx_tpu/channel/apply.py`: one einsum over
(tx, port) plus complex AWGN.
"""

from __future__ import annotations

import torch

from ..phy.misc import complex_awgn


def apply_ofdm_channel(x: torch.Tensor, h: torch.Tensor, no: float,
                       generator: torch.Generator | None = None,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """y = sum_{tx, port} h * x + n.

    x: [batch, num_tx, num_ports, 14, sc] transmitted grids.
    h: [batch, num_rx_ant, num_tx, num_ports, 14, sc] CFRs.
    no: noise variance N0. The noise n is CN(0, no) drawn from
    `generator` (on its own device, then moved to y's, so a CPU generator
    gives every device the same draw), or `noise` [batch, num_rx_ant, 14,
    sc] as given (already scaled), so that a test can feed both packages
    the same draw. Returns y: [batch, num_rx_ant, 14, sc] complex64.
    """
    y = torch.einsum("batpsc,btpsc->basc", h, x)
    if noise is None:
        if generator is None:
            raise ValueError("pass a generator or the noise itself")
        noise = complex_awgn(y.shape, no, generator)
    return y + noise.to(y.device)
