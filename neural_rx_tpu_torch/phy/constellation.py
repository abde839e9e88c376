"""Gray-coded QAM constellations (unit energy).

The port's copy of what the transmitter reads from
`neural_rx_tpu/phy/constellation.py`: the point table, the bit labels and
`Constellation` (points normalised as the JAX transmitter normalises
them), and the trainable point set of the end-to-end configurations:
`Constellation.init_params` gives the real [2, 2^m] leaf, `points` centres
it and normalises it to unit energy on every forward pass.

Bit convention (38.211 §5.1 QAM, Sionna): for 2^m-QAM the m bits of a
symbol split alternately between I and Q; each axis is a Gray-coded PAM
with the first bit selecting the half-plane sign.
"""

from __future__ import annotations

import numpy as np
import torch


def pam_gray_bits(b: np.ndarray) -> float:
    """Map a bit vector to a (unnormalized, odd-integer) Gray PAM level:
    level = (1-2*b0) * (2^(n-1) - gray(rest)) over the remaining bits."""
    if len(b) == 0:
        return 0.0
    return (1 - 2 * b[0]) * (2 ** (len(b) - 1) - pam_gray_bits(b[1:]))


def qam_points(num_bits_per_symbol: int, normalize: bool = True
               ) -> np.ndarray:
    """The 2^m Gray-coded QAM points indexed by their bit label (index i's
    binary expansion, MSB first; even-position bits drive the real axis,
    odd-position bits the imaginary axis). complex64."""
    m = num_bits_per_symbol
    if m % 2 or m < 2:
        raise ValueError("QAM requires an even number of bits/symbol")
    n = 2**m
    points = np.zeros(n, dtype=np.complex128)
    for i in range(n):
        bits = np.array([(i >> (m - 1 - j)) & 1 for j in range(m)])
        points[i] = pam_gray_bits(bits[0::2]) + 1j * pam_gray_bits(bits[1::2])
    if normalize:
        points /= np.sqrt(np.mean(np.abs(points) ** 2))
    return points.astype(np.complex64)


def bit_labels(num_bits_per_symbol: int) -> np.ndarray:
    """[2^m, m] matrix of the bit label of each constellation index."""
    m = num_bits_per_symbol
    idx = np.arange(2**m)
    return ((idx[:, None] >> (m - 1 - np.arange(m)[None, :])) & 1).astype(
        np.float32)


class Constellation:
    """A QAM constellation; `_init_points` is the real [2, 2^m] (re, im)
    array the JAX package keeps as its parameter leaf, trainable in the
    end-to-end configurations."""

    def __init__(self, num_bits_per_symbol: int):
        self.num_bits_per_symbol = num_bits_per_symbol
        pts = qam_points(num_bits_per_symbol)
        self._init_points = np.stack([pts.real, pts.imag]).astype(np.float32)

    def init_params(self, device="cpu") -> torch.Tensor:
        """The initial (re, im) point array [2, 2^m] float32 on `device`:
        a parameter leaf of a trainable constellation."""
        return torch.tensor(self._init_points, device=device)

    @staticmethod
    def points(params: torch.Tensor, center: bool = False) -> torch.Tensor:
        """The complex point set of the (re, im) array `params` [2, 2^m],
        centred first if `center`, normalised to unit energy, in complex64
        arithmetic as the JAX package computes it. Differentiable in
        `params`."""
        c = torch.complex(params[0], params[1])
        if center:
            c = c - c.mean()
        return c / torch.sqrt((c.abs() ** 2).mean())
