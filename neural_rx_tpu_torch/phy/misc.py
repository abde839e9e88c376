"""Small PHY utilities: SNR conversion, AWGN, bit sources, the
zero-forcing precoder.

The port's copy of `neural_rx_tpu/phy/misc.py`. The random functions take
an explicit `torch.Generator` and draw on its device where the JAX
package takes a PRNG key; the two give different numbers from the same
seed, so tests feed both packages the same numpy draws instead.

ebnodb2no reproduces the reference's rate-adjusted SNR semantics:
N0 = 1 / (Eb/N0 * Qm * R), scaled by the resource-grid overhead factor
num_resource_elements / num_data_symbols (pilot + CP overhead).
"""

from __future__ import annotations

import math

import torch


def ebnodb2no(ebno_db, num_bits_per_symbol: int, coderate: float,
              num_resource_elements: float | None = None,
              num_data_symbols: int | None = None):
    """Eb/N0 [dB] -> complex noise variance N0 (unit signal energy): a
    float for a number, a float32 tensor for a tensor of Eb/N0s."""
    ebno = 10.0 ** (ebno_db / 10.0)
    no = 1.0 / (ebno * num_bits_per_symbol * coderate)
    if num_resource_elements is not None and num_data_symbols is not None:
        no = no * (num_resource_elements / num_data_symbols)
    return no


def complex_awgn(shape, no, generator: torch.Generator) -> torch.Tensor:
    """CN(0, no) noise, complex64, on the generator's device: real and
    imaginary parts N(0, no/2). no: a number, or a tensor [batch] of one
    variance per batch item (the first axis of `shape`)."""
    re = torch.randn(shape, generator=generator, device=generator.device)
    im = torch.randn(shape, generator=generator, device=generator.device)
    if isinstance(no, torch.Tensor):
        std = torch.sqrt(no.to(re.device, torch.float32) / 2.0).reshape(
            (-1,) + (1,) * (len(shape) - 1))
    else:
        std = math.sqrt(no / 2.0)
    return torch.complex(re * std, im * std)


def binary_source(shape, generator: torch.Generator) -> torch.Tensor:
    """I.i.d. uniform bits in {0., 1.}, float32, on the generator's
    device."""
    return torch.randint(0, 2, shape, generator=generator,
                         device=generator.device).to(torch.float32)


def zf_precoder(h: torch.Tensor) -> torch.Tensor:
    """Zero-forcing precoding matrices with per-column normalization
    (reference ZFPrecoder): h [..., rx, tx] complex -> W = h^H (h h^H)^-1
    [..., tx, rx], each column scaled to unit norm (norms clamped at
    1e-12)."""
    hh = h @ h.conj().transpose(-1, -2)  # H H^H
    w = h.conj().transpose(-1, -2) @ torch.linalg.inv(hh)
    norm = torch.sqrt((w.abs() ** 2).sum(dim=-2, keepdim=True))
    return w / torch.clamp(norm, min=1e-12)
