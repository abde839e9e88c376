"""OFDM resource grid for PUSCH: static description + mapping ops.

The port's counterpart of `neural_rx_tpu/phy/grid.py:ResourceGrid`: the
per-UE configs, the pilot and data masks, the data-RE indices and the
per-slot DMRS grid bank (NumPy, built once at configuration time), and the
torch ops of the TX and RX paths: one scatter (`map_data`) or gather
(`demap_data`) with static indices.

The PUSCH grid has no guard carriers or DC null: all 12*n_prb subcarriers
are effective.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import tables


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
        # The CP is never materialized (frequency-domain simulation), but
        # its energy overhead enters the Eb/N0 definition: normal CP is
        # 144/2048 of the symbol for every numerology.
        self.cp_overhead = 144.0 / 2048.0

        # Pilot mask: identical for every UE (union of CDM groups w/o data)
        self.pilot_mask = c0.pilot_mask()  # [14, sc] bool
        alloc_mask = np.zeros((self.num_ofdm_symbols,
                               self.num_subcarriers), bool)
        s0, ns = c0.symbol_allocation
        alloc_mask[s0:s0 + ns] = True
        self.data_mask = alloc_mask & ~self.pilot_mask

        # Flat row-major (symbol-major) data indices
        self.data_ind = np.flatnonzero(
            self.data_mask.reshape(-1)).astype(np.int32)
        self.num_data_symbols = int(self.data_ind.size)  # per layer
        self.num_pilot_symbols = int(self.pilot_mask.sum())
        self.num_resource_elements = int(alloc_mask.sum())

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
        # content key of the tables above, for `tables.on_device`
        self._key = hashlib.sha1(self.data_ind.tobytes()
                                 + self.dmrs_grids.tobytes()).hexdigest()

    def _data_index(self, device) -> torch.Tensor:
        return tables.on_device(("data_ind", self._key), device,
                                lambda: self.data_ind, torch.int64)

    def map_data(self, symbols: torch.Tensor) -> torch.Tensor:
        """Scatter data symbols into an empty grid:
        [..., num_data_symbols] -> [..., 14, num_subcarriers]."""
        n_re = self.num_ofdm_symbols * self.num_subcarriers
        flat = torch.zeros(symbols.shape[:-1] + (n_re,), dtype=symbols.dtype,
                           device=symbols.device)
        flat[..., self._data_index(symbols.device)] = symbols
        return flat.reshape(symbols.shape[:-1] + (self.num_ofdm_symbols,
                                                  self.num_subcarriers))

    def demap_data(self, grid: torch.Tensor) -> torch.Tensor:
        """Gather data REs: [..., 14, sc] -> [..., n_data], or with a
        trailing per-RE channel axis [..., 14, sc, ch] -> [..., n_data, ch]
        (LLR grids)."""
        idx = self._data_index(grid.device)
        shape = (self.num_ofdm_symbols, self.num_subcarriers)
        if tuple(grid.shape[-2:]) == shape:
            return grid.reshape(grid.shape[:-2] + (-1,))[..., idx]
        if tuple(grid.shape[-3:-1]) != shape:
            raise ValueError(f"grid {tuple(grid.shape)} is not [..., "
                             f"{shape[0]}, {shape[1]}(, ch)]")
        flat = grid.reshape(grid.shape[:-3] + (-1, grid.shape[-1]))
        return flat[..., idx, :]

    @property
    def effective_subcarrier_ind(self) -> np.ndarray:
        """Indices of the effective (non-nulled) subcarriers. A PUSCH
        bandwidth-part grid has no guard or DC nulls, so every subcarrier
        is effective: the identity, kept for parity with the reference's
        RemoveNulledSubcarriers."""
        return np.arange(self.num_subcarriers)

    def remove_nulled_subcarriers(self, grid: torch.Tensor) -> torch.Tensor:
        """grid [..., sc] restricted to the effective subcarriers (the
        identity for PUSCH grids)."""
        return grid[..., self.effective_subcarrier_ind]

    def dmrs_grid_slot(self, slot_idx, device=None) -> torch.Tensor:
        """DMRS grid of one slot: [num_tx, 14, sc] complex64. slot_idx: an
        int, or a 0-dim integer tensor on `device` (a slot drawn on the
        device indexes the bank there)."""
        if isinstance(slot_idx, torch.Tensor):
            return tables.on_device(("dmrs_grids", self._key), device,
                                    lambda: self.dmrs_grids)[slot_idx]
        return tables.on_device(("dmrs_grid", self._key, slot_idx), device,
                                lambda: self.dmrs_grids[slot_idx])
