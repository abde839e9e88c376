"""PUSCH transmitter: TB encode -> QAM map -> RG map -> DMRS -> precode.

The port's copy of `neural_rx_tpu/phy/nr/transmitter.py:PUSCHTransmitter`
(frequency domain, one transmitter per MCS for all its UEs: per-UE
scrambling via n_rnti/n_id, per-UE DMRS ports, per-UE codebook
precoding), with the trainable point set of the end-to-end
configurations (`constellation_points`). `encode` and `modulate` split the
call, so the training model reads its labels (the coded bits) from the
same encode.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import tables
from ..constellation import Constellation
from ..grid import ResourceGrid
from ..mapping import map_bits
from .tb import tb_encode


class PUSCHTransmitter:
    """Frequency-domain PUSCH transmitter for one MCS, all UEs.

    Call: bits [batch, num_tx, tb_size] -> x [batch, num_tx,
    num_antenna_ports, 14, num_subcarriers] complex64.
    """

    def __init__(self, pusch_configs):
        self.configs = list(pusch_configs)
        c0 = self.configs[0]
        self.resource_grid = ResourceGrid(self.configs)
        self.num_bits_per_symbol = c0.num_bits_per_symbol
        self.target_coderate = c0.target_coderate
        self.tb_size = c0.tb_size
        self.num_coded_bits = c0.num_coded_bits
        self.constellation = Constellation(self.num_bits_per_symbol)
        # [num_tx, num_ports, 1]
        self.w = np.stack([c.precoding_matrix() for c in self.configs])
        self.num_antenna_ports = c0.num_antenna_ports

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """bits [batch, num_tx, tb_size] float {0,1} -> coded bits [batch,
        num_tx, num_coded_bits]: each UE's transport block encoded with
        its own scrambling."""
        return torch.stack([tb_encode(cfg.tb, bits[:, i])
                            for i, cfg in enumerate(self.configs)], dim=1)

    def modulate(self, coded: torch.Tensor, slot_idx=None,
                 constellation_points: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """coded bits [batch, num_tx, num_coded_bits] -> x [batch, num_tx,
        ports, 14, sc] complex64: QAM mapping (the fixed points, or
        `constellation_points` [2^m] complex, through which gradients flow),
        resource-grid mapping, the DMRS of slot slot_idx (an int or a 0-dim
        integer tensor on the device; default: the configured slot) and
        codebook precoding."""
        rg = self.resource_grid
        dev = coded.device
        if slot_idx is None:
            slot_idx = self.configs[0].carrier.slot_number
        points = constellation_points
        if points is None:
            points = Constellation.points(tables.on_device(
                ("constellation", self.num_bits_per_symbol), dev,
                lambda: self.constellation._init_points))
        x = rg.map_data(map_bits(coded, points))  # [batch, num_tx, 14, sc]

        # Add DMRS (pre-precoding, single layer per UE)
        x = x + rg.dmrs_grid_slot(slot_idx, dev)[None]

        # Codebook precoding: port p carries w[tx, p] * layer signal
        w = tables.on_device(("precoders", self.w.tobytes()), dev,
                             lambda: self.w[..., 0])  # [num_tx, ports]
        return x[:, :, None] * w[None, :, :, None, None]

    def __call__(self, bits: torch.Tensor, slot_idx=None,
                 constellation_points: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """bits [batch, num_tx, tb_size] float {0,1} on the output's
        device -> x [batch, num_tx, ports, 14, sc] complex64: `encode`,
        then `modulate`."""
        return self.modulate(self.encode(bits), slot_idx,
                             constellation_points)
