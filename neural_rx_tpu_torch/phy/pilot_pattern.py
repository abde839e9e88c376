"""Generic OFDM pilot patterns (reference siona_tf.py:1524-1907:
PilotPattern / EmptyPilotPattern / KroneckerPilotPattern).

The 5G PUSCH DMRS patterns live in phy/nr/dmrs.py; these generic
builders support non-NR OFDM experiments (mask [num_tx, sym, sc] +
per-TX pilot values over the masked REs, row-major order like the
ResourceGrid convention).
"""

from __future__ import annotations

import numpy as np


class PilotPattern:
    """mask: [num_tx, num_sym, num_sc] bool; pilots: [num_tx, n_pilots]
    complex values in row-major masked order."""

    def __init__(self, mask: np.ndarray, pilots: np.ndarray,
                 normalize: bool = False):
        mask = np.asarray(mask, bool)
        pilots = np.asarray(pilots, np.complex64)
        assert mask.ndim == 3
        n = int(mask[0].sum())
        assert all(int(m.sum()) == n for m in mask), \
            "equal pilot count per tx"
        assert pilots.shape == (mask.shape[0], n)
        if normalize:
            energy = np.mean(np.abs(pilots) ** 2, axis=-1, keepdims=True)
            pilots = pilots / np.sqrt(np.maximum(energy, 1e-12))
        self.mask = mask
        self.pilots = pilots

    @property
    def num_pilot_symbols(self) -> int:
        return self.pilots.shape[-1]


def empty_pilot_pattern(num_tx: int, num_sym: int, num_sc: int
                        ) -> PilotPattern:
    """No pilots (pilotless experiments)."""
    return PilotPattern(np.zeros((num_tx, num_sym, num_sc), bool),
                        np.zeros((num_tx, 0), np.complex64))


def kronecker_pilot_pattern(num_tx: int, num_sym: int, num_sc: int,
                            pilot_symbol_indices, seed: int = 0
                            ) -> PilotPattern:
    """Orthogonal pilots: every TX gets every num_tx-th subcarrier of
    the pilot-carrying OFDM symbols (QPSK values, zero on other TXs'
    subcarriers — the Kronecker structure of siona_tf.py:1784)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((num_tx, num_sym, num_sc), bool)
    for s in pilot_symbol_indices:
        mask[:, s, :] = True
    n = int(mask[0].sum())
    pilots = np.zeros((num_tx, n), np.complex64)
    n_per_sym = num_sc
    for tx in range(num_tx):
        vals = (rng.choice([1, -1], size=n) +
                1j * rng.choice([1, -1], size=n)) / np.sqrt(2)
        own = np.zeros(n, bool)
        for si in range(len(pilot_symbol_indices)):
            base = si * n_per_sym
            own[base + tx::num_tx] = True
        pilots[tx] = np.where(own, vals * np.sqrt(num_tx), 0.0)
    return PilotPattern(mask, pilots)
