"""Pseudo-random (Gold) sequence generation, 38.211 §5.2.1.

Used for the DMRS pilot values and PUSCH scrambling. Pure NumPy, evaluated
once at configuration time.
"""

from __future__ import annotations

import numpy as np

_NC = 1600


def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """Length-`length` Gold sequence c(n) as an int8 {0,1} array."""
    n_total = length + _NC + 31
    x1 = np.zeros(n_total, np.int8)
    x2 = np.zeros(n_total, np.int8)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for n in range(n_total - 31):
        x1[n + 31] = (x1[n + 3] + x1[n]) % 2
        x2[n + 31] = (x2[n + 3] + x2[n + 2] + x2[n + 1] + x2[n]) % 2
    return ((x1[_NC:_NC + length] + x2[_NC:_NC + length]) % 2).astype(np.int8)


def qpsk_from_gold(c: np.ndarray) -> np.ndarray:
    """Map a Gold bit sequence to QPSK symbols r(n) (38.211 §5.2.2):
    r(n) = (1/sqrt(2)) [(1 - 2 c(2n)) + j (1 - 2 c(2n+1))]."""
    c = c.astype(np.float64)
    re = 1.0 - 2.0 * c[0::2]
    im = 1.0 - 2.0 * c[1::2]
    return ((re + 1j * im) / np.sqrt(2.0)).astype(np.complex64)


def pusch_scrambling_sequence(n_rnti: int, n_id: int, length: int
                              ) -> np.ndarray:
    """PUSCH scrambling sequence (38.211 §6.3.1.1):
    c_init = n_rnti * 2^15 + n_id."""
    return gold_sequence((n_rnti << 15) + n_id, length)


def dmrs_c_init(slot_number: int, symbol_index: int, n_id: int,
                n_scid: int) -> int:
    """DMRS sequence init (38.211 §6.4.1.1.1):
    c_init = (2^17 (14 n_slot + l + 1)(2 N_id + 1) + 2 N_id + n_scid) mod 2^31
    """
    return ((2**17 * (14 * slot_number + symbol_index + 1) * (2 * n_id + 1)
             + 2 * n_id + n_scid) % 2**31)
