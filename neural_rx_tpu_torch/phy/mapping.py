"""Bit <-> symbol mapping and LLR demapping (max-log and exact APP).

The port's copy of `neural_rx_tpu/phy/mapping.py`: the mapper is one
gather from the point table; the demappers reduce over the constellation
points with a max (max-log) or a log-sum-exp (APP).

LLR sign convention as Sionna's: llr = log(Pr(b=1) / Pr(b=0)), so a
positive LLR means bit 1.
"""

from __future__ import annotations

import torch

from .. import tables
from .constellation import bit_labels

_NEG_INF = -1e30


def map_bits(bits: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Map bits to constellation symbols.

    bits: [..., n*m] in {0,1}; points: [2^m] complex.
    Returns [..., n] complex symbols.
    """
    m = int(points.shape[0]).bit_length() - 1
    b = bits.reshape(bits.shape[:-1] + (-1, m)).to(torch.int64)
    weights = 2 ** torch.arange(m - 1, -1, -1, device=bits.device)
    return points[(b * weights).sum(dim=-1)]


def _bit_masks(num_bits_per_symbol: int, device) -> torch.Tensor:
    """[m, 2^m] bool, True where the point's bit j is 1 (its complement
    marks bit 0)."""
    return tables.on_device(
        ("bit_masks", num_bits_per_symbol), device,
        lambda: bit_labels(num_bits_per_symbol).T > 0.5)


def _exponents(y: torch.Tensor, points: torch.Tensor, no) -> torch.Tensor:
    """-|y - c|^2 / no for every constellation point: [..., 2^m]. no: a
    number or a tensor broadcastable to y."""
    d2 = (y[..., None] - points).abs() ** 2
    if isinstance(no, torch.Tensor):
        no = no.broadcast_to(y.shape)[..., None]
    return -d2 / no


def _masked_exponents(y, points, no):
    """(exponents where bit j is 1, where it is 0), each [..., m, 2^m] with
    -1e30 elsewhere."""
    m = int(points.shape[0]).bit_length() - 1
    mask1 = _bit_masks(m, y.device)
    e = _exponents(y, points, no)[..., None, :]
    return torch.where(mask1, e, _NEG_INF), torch.where(mask1, _NEG_INF, e)


def demap_maxlog(y: torch.Tensor, points: torch.Tensor, no) -> torch.Tensor:
    """Max-log LLRs. y: [...] complex, no: broadcastable to y. Out:
    [..., m]."""
    exp1, exp0 = _masked_exponents(y, points, no)
    return exp1.amax(dim=-1) - exp0.amax(dim=-1)


def demap_app(y: torch.Tensor, points: torch.Tensor, no) -> torch.Tensor:
    """Exact a-posteriori LLRs by log-sum-exp."""
    exp1, exp0 = _masked_exponents(y, points, no)
    return torch.logsumexp(exp1, dim=-1) - torch.logsumexp(exp0, dim=-1)
