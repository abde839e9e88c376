"""Random symbol sources.

The port's copy of `neural_rx_tpu/phy/sources.py`, drawing from a
`torch.Generator` on its device where the JAX package takes a PRNG key.
"""

from __future__ import annotations

import torch

from .constellation import qam_points
from .mapping import map_bits
from .misc import binary_source


def symbol_source(generator: torch.Generator, shape, points
                  ) -> torch.Tensor:
    """I.i.d. uniform symbols of `shape` from the point set `points`."""
    points = torch.as_tensor(points, device=generator.device)
    idx = torch.randint(0, points.shape[0], tuple(shape),
                        generator=generator, device=generator.device)
    return points[idx]


def qam_source(generator: torch.Generator, shape,
               num_bits_per_symbol: int) -> torch.Tensor:
    """I.i.d. uniform QAM symbols (unit average energy), complex64."""
    return symbol_source(generator, shape, qam_points(num_bits_per_symbol))


def qam_source_with_bits(generator: torch.Generator, shape,
                         num_bits_per_symbol: int):
    """(symbols of `shape`, bits [*shape, m]): random bits mapped to QAM,
    for callers that need the generating bits."""
    bits = binary_source(tuple(shape) + (num_bits_per_symbol,), generator)
    flat = bits.reshape(bits.shape[:-2] + (-1,))
    points = torch.as_tensor(qam_points(num_bits_per_symbol),
                             device=generator.device)
    return map_bits(flat, points), bits
