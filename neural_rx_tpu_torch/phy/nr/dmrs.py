"""PUSCH DMRS generation, 38.211 §6.4.1.1.

Static NumPy evaluated at configuration time: one pilot grid per slot
number (the precomputed pilot bank). The port's copy of
`neural_rx_tpu/phy/nr/dmrs.py`.

Conventions:
- Config type 1: comb-2, CDM groups {0,1} at subcarrier offsets Δ={0,1},
  ports 0/1 (group 0) and 2/3 (group 1), k = 4n + 2k' + Δ.
- Config type 2: 2-SC clusters, CDM groups {0,1,2} at Δ={0,2,4},
  ports (0,1)/(2,3)/(4,5), k = 6n + k' + Δ.
- Amplitude β = sqrt(num_cdm_groups_without_data) (38.214 Table 6.2.2-1
  EPRE ratio; Sionna applies the same scaling).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .sequences import gold_sequence, qpsk_from_gold, dmrs_c_init

# Port -> (cdm_group, delta, w_f, w_t) per 38.211 Tables 6.4.1.1.3-1/2.
_PORT_MAP_TYPE1 = {
    0: (0, 0, (+1, +1), (+1, +1)),
    1: (0, 0, (+1, -1), (+1, +1)),
    2: (1, 1, (+1, +1), (+1, +1)),
    3: (1, 1, (+1, -1), (+1, +1)),
    4: (0, 0, (+1, +1), (+1, -1)),
    5: (0, 0, (+1, -1), (+1, -1)),
    6: (1, 1, (+1, +1), (+1, -1)),
    7: (1, 1, (+1, -1), (+1, -1)),
}
_PORT_MAP_TYPE2 = {
    0: (0, 0, (+1, +1), (+1, +1)),
    1: (0, 0, (+1, -1), (+1, +1)),
    2: (1, 2, (+1, +1), (+1, +1)),
    3: (1, 2, (+1, -1), (+1, +1)),
    4: (2, 4, (+1, +1), (+1, +1)),
    5: (2, 4, (+1, -1), (+1, +1)),
}


def dmrs_symbol_indices(mapping_type: str, type_a_position: int,
                        additional_position: int, length: int,
                        symbol_allocation: tuple[int, int]) -> list[int]:
    """First symbols l̄ of each DMRS group (38.211 Table 6.4.1.1.3-3/4).

    Single-symbol (length=1) and double-symbol (length=2) DMRS, PUSCH
    without frequency hopping. Returns the full list of DMRS symbol
    indices (each l̄ expanded by `length`).
    """
    start, num = symbol_allocation
    if mapping_type == "A":
        assert start == 0, "mapping type A requires allocation starting at 0"
        ld = num  # duration in symbols counted from slot start
        l0 = type_a_position
        assert l0 in (2, 3)
        if length == 1:
            # Table 6.4.1.1.3-3, PUSCH mapping type A, single-symbol DMRS
            table = {
                0: {ld_: [l0] for ld_ in range(4, 15)},
                1: {**{ld_: [l0] for ld_ in range(4, 8)},
                    **{ld_: [l0, 7] for ld_ in (8, 9)},
                    **{ld_: [l0, 9] for ld_ in (10, 11)},
                    **{ld_: [l0, 11] for ld_ in (12, 13, 14)}},
                2: {**{ld_: [l0] for ld_ in range(4, 8)},
                    **{ld_: [l0, 7] for ld_ in (8, 9)},
                    **{ld_: [l0, 6, 9] for ld_ in (10, 11)},
                    **{ld_: [l0, 7, 11] for ld_ in (12,)},
                    **{ld_: [l0, 7, 11] for ld_ in (13, 14)}},
                3: {**{ld_: [l0] for ld_ in range(4, 8)},
                    **{ld_: [l0, 7] for ld_ in (8, 9)},
                    **{ld_: [l0, 6, 9] for ld_ in (10, 11)},
                    **{ld_: [l0, 5, 8, 11] for ld_ in (12, 13, 14)}},
            }[additional_position]
            bars = table[ld]
        else:  # double-symbol
            table = {
                0: {ld_: [l0] for ld_ in range(4, 15)},
                1: {**{ld_: [l0] for ld_ in range(4, 10)},
                    **{ld_: [l0, 8] for ld_ in (10, 11)},
                    **{ld_: [l0, 10] for ld_ in (12, 13, 14)}},
            }[additional_position]
            bars = table[ld]
    elif mapping_type == "B":
        ld = num
        l0 = 0  # relative to allocation start
        if length == 1:
            table = {
                0: {ld_: [l0] for ld_ in range(1, 15)},
                1: {**{ld_: [l0] for ld_ in range(1, 5)},
                    **{ld_: [l0, 4] for ld_ in (5, 6, 7)},
                    **{ld_: [l0, 6] for ld_ in (8, 9)},
                    **{ld_: [l0, 8] for ld_ in (10, 11)},
                    **{ld_: [l0, 10] for ld_ in (12, 13, 14)}},
            }[additional_position]
            bars = [b + start for b in table[ld]]
        else:  # double-symbol, mapping type B (Table 6.4.1.1.3-4)
            assert ld >= 2, "double-symbol DMRS needs >=2 symbols"
            if additional_position != 0:
                # The additional-position column of the type-B
                # double-symbol table cannot be transcribed here with
                # verifiable fidelity (no spec copy in this environment)
                # and no config in the matrix uses it; refusing beats
                # shipping invented pilot positions.
                raise ValueError(
                    "double-symbol type-B DMRS with additional_position"
                    " > 0 is not supported (unverified table column)")
            bars = [l0 + start]
    else:
        raise ValueError(f"unknown mapping type {mapping_type}")
    out = []
    for b in bars:
        out.extend(b + i for i in range(length))
    return out


@dataclasses.dataclass
class DMRSConfig:
    """Static DMRS configuration (mirror of reference PUSCHDMRSConfig)."""
    config_type: int = 1
    type_a_position: int = 2
    additional_position: int = 1
    length: int = 1
    dmrs_port_set: tuple[int, ...] = (0,)
    n_scid: int = 0
    num_cdm_groups_without_data: int = 2
    n_id: tuple[int, int] = (1, 1)
    mapping_type: str = "A"

    @property
    def port_map(self):
        return _PORT_MAP_TYPE1 if self.config_type == 1 else _PORT_MAP_TYPE2

    @property
    def beta(self) -> float:
        return float(np.sqrt(self.num_cdm_groups_without_data))

    def cdm_group_subcarriers(self, group: int, num_sc: int) -> np.ndarray:
        """Subcarrier indices of one CDM group within a num_sc-wide grid."""
        if self.config_type == 1:
            n = np.arange(num_sc // 4)
            k = (4 * n[:, None] + 2 * np.arange(2)[None, :] + group).ravel()
        else:
            n = np.arange(num_sc // 6)
            k = (6 * n[:, None] + np.arange(2)[None, :] + 2 * group).ravel()
        return np.sort(k)


def dmrs_grid_for_port(cfg: DMRSConfig, port: int, num_sc: int,
                       symbol_allocation: tuple[int, int],
                       slot_number: int,
                       num_symbols_total: int = 14) -> np.ndarray:
    """Complex DMRS grid [num_symbols_total, num_sc] for one antenna port.

    Nonzero only at the port's own CDM-group REs in the DMRS symbols; the
    amplitude includes β. The reference point for the sequence is CRB 0
    (n_start_grid = 0 assumed, as in all reference configs).
    """
    group, delta, w_f, w_t = cfg.port_map[port]
    dmrs_syms = dmrs_symbol_indices(cfg.mapping_type, cfg.type_a_position,
                                    cfg.additional_position, cfg.length,
                                    symbol_allocation)
    grid = np.zeros((num_symbols_total, num_sc), np.complex64)
    n_id = cfg.n_id[cfg.n_scid] if isinstance(cfg.n_id, (list, tuple)) \
        else cfg.n_id
    # group DMRS symbols into l' pairs for double-symbol OCC
    for gi in range(0, len(dmrs_syms), cfg.length):
        for lp in range(cfg.length):
            l_sym = dmrs_syms[gi + lp]
            c_init = dmrs_c_init(slot_number, l_sym, n_id, cfg.n_scid)
            if cfg.config_type == 1:
                n_max = num_sc // 4
                c = gold_sequence(c_init, 2 * (2 * n_max))
                r = qpsk_from_gold(c)  # r(0..2*n_max-1)
                for n in range(n_max):
                    for kp in range(2):
                        k = 4 * n + 2 * kp + delta
                        grid[l_sym, k] = (cfg.beta * w_f[kp] * w_t[lp]
                                          * r[2 * n + kp])
            else:
                n_max = num_sc // 6
                c = gold_sequence(c_init, 2 * (2 * n_max))
                r = qpsk_from_gold(c)
                for n in range(n_max):
                    for kp in range(2):
                        k = 6 * n + kp + delta
                        grid[l_sym, k] = (cfg.beta * w_f[kp] * w_t[lp]
                                          * r[2 * n + kp])
    return grid


def pilot_mask(cfg: DMRSConfig, num_sc: int,
               symbol_allocation: tuple[int, int],
               num_symbols_total: int = 14) -> np.ndarray:
    """Boolean [num_symbols_total, num_sc]: REs reserved for DMRS.

    Covers the first `num_cdm_groups_without_data` CDM groups in every
    DMRS symbol — these REs carry no data for ANY user (matches Sionna's
    type-grid semantics: the union is marked as pilots for every TX).
    """
    dmrs_syms = dmrs_symbol_indices(cfg.mapping_type, cfg.type_a_position,
                                    cfg.additional_position, cfg.length,
                                    symbol_allocation)
    mask = np.zeros((num_symbols_total, num_sc), bool)
    for g in range(cfg.num_cdm_groups_without_data):
        scs = cfg.cdm_group_subcarriers(g, num_sc)
        for l_sym in dmrs_syms:
            mask[l_sym, scs] = True
    return mask
