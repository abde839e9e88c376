"""OFDM resource grid for PUSCH: the static (NumPy) description.

The port's counterpart of `neural_rx_tpu/phy/grid.py:ResourceGrid`, holding
what the receiver reads: the per-UE configs, the pilot mask and the per-slot
DMRS grid bank. Built once at configuration time.

The PUSCH grid has no guard carriers or DC null: all 12*n_prb subcarriers
are effective.
"""

from __future__ import annotations

import numpy as np


class ResourceGrid:
    """Static resource grid shared by all UEs of one PUSCH configuration.

    pusch_configs: list of PUSCHConfig, one per UE (same carrier/DMRS
    structure, different ports/scrambling).
    """

    def __init__(self, pusch_configs):
        self.configs = list(pusch_configs)
        c0 = self.configs[0]
        self.num_tx = len(self.configs)
        self.num_ofdm_symbols = c0.num_symbols_total
        self.num_subcarriers = c0.num_subcarriers
        self.num_slots_per_frame = c0.num_slots_per_frame

        # Pilot mask: identical for every UE (union of CDM groups w/o data)
        self.pilot_mask = c0.pilot_mask()  # [14, sc] bool

        # Per-slot DMRS grid bank: [num_slots, num_tx, 14, sc] complex64
        self.dmrs_grids = np.stack([
            np.stack([cfg.dmrs_grid(slot) for cfg in self.configs])
            for slot in range(self.num_slots_per_frame)
        ]).astype(np.complex64)

        # Per-TX pilot values over the pilot mask (incl. zeros on the other
        # CDM group): [num_slots, num_tx, num_pilot_symbols]
        pm = self.pilot_mask.reshape(-1)
        self.pilots = self.dmrs_grids.reshape(
            self.num_slots_per_frame, self.num_tx, -1)[..., pm]
