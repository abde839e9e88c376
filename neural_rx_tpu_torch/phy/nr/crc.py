"""CRC attachment and check, 38.212 §5.1, as a GF(2) matrix product.

The port's copy of `neural_rx_tpu/phy/nr/crc.py`. CRC over GF(2) is
linear, so for a fixed payload length A the parity is
``(bits @ G) mod 2`` with a precomputed [A, L] generator matrix (NumPy,
built once per (A, type)). The product runs in float32: every partial sum
is an integer below 2^24 (A <= 41,000 ones), so it is exact in any
summation order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import tables

# Generator polynomials, MSB-first coefficient lists excluding the leading 1.
CRC_POLYS = {
    "CRC24A": (24, 0x864CFB),
    "CRC24B": (24, 0x800063),
    "CRC24C": (24, 0xB2B117),
    "CRC16": (16, 0x11021 & 0xFFFF),
    "CRC11": (11, 0x621 & 0x7FF),
    "CRC6": (6, 0x61 & 0x3F),
}


@functools.lru_cache(maxsize=64)
def crc_generator_matrix(num_bits: int, crc_type: str) -> np.ndarray:
    """[num_bits, L] float32 GF(2) matrix: crc = bits @ G mod 2.

    Row i is the CRC of the unit vector e_i, the remainder of
    x^(L + num_bits - 1 - i) mod the polynomial, filled from the last row
    up by repeated multiplication by x."""
    length, poly = CRC_POLYS[crc_type]
    top, mask = 1 << (length - 1), (1 << length) - 1
    rems = [poly]  # remainder of x^L, then times x, as integers
    for _ in range(1, num_bits):
        rem = rems[-1]
        rems.append(((rem << 1) & mask) ^ (poly if rem & top else 0))
    rems = np.asarray(rems[::-1], np.int64)[:, None]
    g = (rems >> np.arange(length - 1, -1, -1)) & 1  # MSB first
    return g.astype(np.float32)


def _parity(bits: torch.Tensor, crc_type: str) -> torch.Tensor:
    key = (bits.shape[-1], crc_type)
    g = tables.on_device(("crc",) + key, bits.device,
                         lambda: crc_generator_matrix(*key))
    return torch.remainder(torch.round(bits.float() @ g), 2.0)


def crc_attach(bits: torch.Tensor, crc_type: str) -> torch.Tensor:
    """Append CRC parity bits along the last axis. bits: [..., A] float."""
    return torch.cat([bits, _parity(bits, crc_type).to(bits.dtype)], dim=-1)


def crc_check(bits_with_crc: torch.Tensor, crc_type: str) -> torch.Tensor:
    """Boolean [...] CRC-pass flags for payload+CRC arrays."""
    length, _ = CRC_POLYS[crc_type]
    payload = bits_with_crc[..., :-length]
    expected = bits_with_crc[..., -length:]
    return (_parity(payload, crc_type) == expected).all(dim=-1)
