"""OFDM modulation and demodulation (IFFT/FFT and cyclic prefix).

The port's copy of `neural_rx_tpu/phy/ofdm.py`, with its grid convention:
subcarriers run from the most negative to the most positive frequency, so
modulation ifftshifts before the IFFT and demodulation fftshifts after the
FFT. Used by the frequency-offset impairment (`channel/cfo.py`); the
channel itself is applied in the frequency domain.
"""

from __future__ import annotations

import torch


def ofdm_modulate(x: torch.Tensor, cp_length: int) -> torch.Tensor:
    """Frequency-domain grid [..., num_ofdm_symbols, fft_size] complex ->
    time samples [..., num_ofdm_symbols * (fft_size + cp_length)], each
    symbol preceded by its cyclic prefix."""
    xt = torch.fft.ifft(torch.fft.ifftshift(x, dim=-1), dim=-1, norm="ortho")
    if cp_length > 0:
        xt = torch.cat([xt[..., -cp_length:], xt], dim=-1)
    return xt.reshape(x.shape[:-2] + (-1,))


def ofdm_demodulate(y: torch.Tensor, fft_size: int, cp_length: int
                    ) -> torch.Tensor:
    """Time samples [..., num_symbols * (fft_size + cp_length)] -> the
    frequency-domain grid [..., num_symbols, fft_size], cyclic prefixes
    dropped."""
    sym_len = fft_size + cp_length
    num_sym = y.shape[-1] // sym_len
    yt = y[..., :num_sym * sym_len].reshape(y.shape[:-1]
                                            + (num_sym, sym_len))
    yf = torch.fft.fft(yt[..., cp_length:], dim=-1, norm="ortho")
    return torch.fft.fftshift(yf, dim=-1)
