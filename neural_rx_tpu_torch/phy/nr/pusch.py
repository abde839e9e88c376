"""PUSCH configuration: carrier + DMRS + MCS + precoding (38.211/38.214).

The port's copy of `neural_rx_tpu/phy/nr/pusch.py`: the DMRS grids, the
pilot mask, the modulation order, the codebook precoding matrix (38.211
Table 6.3.1.5-1), the coded-bit budget G, the TBS and the transport-block
chain config `tb`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .dmrs import DMRSConfig, dmrs_grid_for_port, pilot_mask, \
    dmrs_symbol_indices
from .mcs import calculate_tbs, mcs_to_qm_rate
from .tb import TBConfig

# 38.211 Table 6.3.1.5-1: single-layer, 2 antenna ports, W[tpmi]
_CODEBOOK_1L_2P = [
    np.array([[1], [0]]) / np.sqrt(2),
    np.array([[0], [1]]) / np.sqrt(2),
    np.array([[1], [1]]) / 2,
    np.array([[1], [-1]]) / 2,
    np.array([[1], [1j]]) / 2,
    np.array([[1], [-1j]]) / 2,
]

# 38.211 Table 6.3.1.5-3: single-layer, 4 antenna ports (first 12 entries;
# TPMI 12-27 are the 2-bit-phase combinations)
def _codebook_1l_4p(tpmi: int) -> np.ndarray:
    if tpmi < 4:
        w = np.zeros((4, 1), complex)
        w[tpmi, 0] = 1.0
        return w / 2
    if tpmi < 12:
        # pairs (0,2) with phases 1, j, -1, -j then (1,3) likewise
        base = tpmi - 4
        first, phase = (0, base) if base < 4 else (1, base - 4)
        w = np.zeros((4, 1), complex)
        w[first, 0] = 1.0
        w[first + 2, 0] = 1j ** phase
        return w / 2
    base = tpmi - 12
    a, b = divmod(base, 4)
    w = np.array([[1.0], [1j ** a], [1j ** b], [1j ** ((a + b) % 4)]],
                 dtype=complex)
    return w / 2


@dataclasses.dataclass
class CarrierConfig:
    """Mirror of the reference CarrierConfig (parameters.py:139-148)."""
    n_cell_id: int = 1
    cyclic_prefix: str = "normal"
    subcarrier_spacing: float = 30e3  # Hz
    n_size_grid: int = 4
    n_start_grid: int = 0
    slot_number: int = 0
    frame_number: int = 0
    carrier_frequency: float = 2.14e9

    @property
    def mu(self) -> int:
        return int(np.log2(self.subcarrier_spacing / 15e3))

    @property
    def num_slots_per_frame(self) -> int:
        return 10 * (2 ** self.mu)


class PUSCHConfig:
    """Static per-UE PUSCH configuration.

    Derives Qm/coderate from the MCS tables, the data-RE count, the coded
    bits G and the TBS; builds the DMRS grids, the pilot mask and (at first
    use of `tb`) the transport-block chain.
    """

    def __init__(self, carrier: CarrierConfig, dmrs: DMRSConfig,
                 mcs_index: int = 14, mcs_table: int = 1,
                 num_antenna_ports: int = 2, precoding: str = "codebook",
                 tpmi: int = 2, symbol_allocation=(0, 14),
                 n_rnti: int = 1, n_id: int = 1,
                 num_bp_iter: int = 20, cn_type: str = "boxplus"):
        self.carrier = carrier
        self.dmrs = dmrs
        self.mcs_index = mcs_index
        self.mcs_table = mcs_table
        self.num_antenna_ports = num_antenna_ports
        self.precoding = precoding
        self.tpmi = tpmi
        self.symbol_allocation = tuple(symbol_allocation)
        self.n_rnti = n_rnti
        self.n_id = n_id
        self.num_bp_iter = num_bp_iter
        self.cn_type = cn_type
        self.num_layers = len(dmrs.dmrs_port_set)
        if self.num_layers != 1:
            raise ValueError("one layer per UE (reference setup)")

        self.num_symbols_total = 14
        self.num_subcarriers = 12 * carrier.n_size_grid
        self.num_slots_per_frame = carrier.num_slots_per_frame

        self.num_bits_per_symbol, self.target_coderate = mcs_to_qm_rate(
            mcs_index, mcs_table)

        # Data-RE count per layer (symbols in allocation minus reserved
        # pilot REs) -> coded bits G
        pm = self.pilot_mask()
        s0, ns = self.symbol_allocation
        alloc = np.zeros_like(pm)
        alloc[s0:s0 + ns] = True
        self.num_data_res = int((alloc & ~pm).sum())
        self.num_coded_bits = (self.num_data_res * self.num_bits_per_symbol
                               * self.num_layers)

        # TBS per 38.214 §6.1.4.2 (DMRS overhead counts all CDM groups
        # without data over the allocated symbols)
        re_per_group = 6 if dmrs.config_type == 1 else 4
        n_dmrs_per_prb = (len(self.dmrs_symbol_indices()) * re_per_group
                          * dmrs.num_cdm_groups_without_data)
        self.tb_size = calculate_tbs(
            carrier.n_size_grid, ns, n_dmrs_per_prb,
            self.num_bits_per_symbol, self.target_coderate, self.num_layers)

    @functools.cached_property
    def tb(self) -> TBConfig:
        """The transport-block chain config. Built at first use: a BG1
        code's generated shift table takes seconds, and serving never
        needs it."""
        return TBConfig(self.tb_size, self.num_coded_bits,
                        self.num_bits_per_symbol, self.target_coderate,
                        n_rnti=self.n_rnti, n_id=self.n_id,
                        num_layers=self.num_layers,
                        num_bp_iter=self.num_bp_iter, cn_type=self.cn_type)

    # -- grid building -------------------------------------------------
    def dmrs_symbol_indices(self):
        return dmrs_symbol_indices(self.dmrs.mapping_type,
                                   self.dmrs.type_a_position,
                                   self.dmrs.additional_position,
                                   self.dmrs.length, self.symbol_allocation)

    def pilot_mask(self) -> np.ndarray:
        return pilot_mask(self.dmrs, self.num_subcarriers,
                          self.symbol_allocation, self.num_symbols_total)

    def dmrs_grid(self, slot_number: int) -> np.ndarray:
        """Pre-precoding DMRS grid of this UE's (single) port:
        [14, num_subcarriers]."""
        port = self.dmrs.dmrs_port_set[0]
        return dmrs_grid_for_port(self.dmrs, port, self.num_subcarriers,
                                  self.symbol_allocation, slot_number,
                                  self.num_symbols_total)

    # -- precoding ------------------------------------------------------
    def precoding_matrix(self) -> np.ndarray:
        """W: [num_antenna_ports, num_layers] complex64, unit column norm.

        The 38.211 Table 6.3.1.5 entries carry a 1/2 (4-port: 1/2) power
        scaling; simulation-side the column is renormalized to unit norm
        so the received per-layer symbol energy is Es = 1 — the
        calibration the reference's committed BLER curves follow
        (verified empirically: with the spec-literal 1/2-norm precoder,
        every receiver — including genie-CSI — lands ~3 dB right of the
        reference's curves; with unit-norm columns they align).
        """
        if self.precoding != "codebook":
            w = np.ones((self.num_antenna_ports, self.num_layers), complex)
        elif self.num_antenna_ports == 1:
            w = np.ones((1, 1), complex)
        elif self.num_antenna_ports == 2:
            w = _CODEBOOK_1L_2P[self.tpmi]
        elif self.num_antenna_ports == 4:
            w = _codebook_1l_4p(self.tpmi)
        else:
            raise ValueError("unsupported num_antenna_ports")
        w = w / np.linalg.norm(w, axis=0, keepdims=True)
        return w.astype(np.complex64)

    def clone(self, **overrides) -> "PUSCHConfig":
        kw = dict(carrier=self.carrier, dmrs=self.dmrs,
                  mcs_index=self.mcs_index, mcs_table=self.mcs_table,
                  num_antenna_ports=self.num_antenna_ports,
                  precoding=self.precoding, tpmi=self.tpmi,
                  symbol_allocation=self.symbol_allocation,
                  n_rnti=self.n_rnti, n_id=self.n_id,
                  num_bp_iter=self.num_bp_iter, cn_type=self.cn_type)
        kw.update(overrides)
        return PUSCHConfig(**kw)
