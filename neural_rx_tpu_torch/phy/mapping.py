"""Bit -> symbol mapping.

The port's copy of `neural_rx_tpu/phy/mapping.py:map_bits`: one gather
from the point table. The demappers wait for the baselines slice.
"""

from __future__ import annotations

import torch


def map_bits(bits: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Map bits to constellation symbols.

    bits: [..., n*m] in {0,1}; points: [2^m] complex.
    Returns [..., n] complex symbols.
    """
    m = int(points.shape[0]).bit_length() - 1
    b = bits.reshape(bits.shape[:-1] + (-1, m)).to(torch.int64)
    weights = 2 ** torch.arange(m - 1, -1, -1, device=bits.device)
    return points[(b * weights).sum(dim=-1)]
