"""MCS and transport-block-size tables, 38.214 §5.1.3.

`mcs_to_qm_rate` gives the (modulation order, target code rate) of an MCS
index; `calculate_tbs` implements the 38.214 §5.1.3.2 TBS determination.
"""

from __future__ import annotations

import math

# Table 5.1.3.1-1 (MCS index table 1 for PDSCH/PUSCH): idx -> (Qm, R*1024)
MCS_TABLE_1 = {
    0: (2, 120), 1: (2, 157), 2: (2, 193), 3: (2, 251), 4: (2, 308),
    5: (2, 379), 6: (2, 449), 7: (2, 526), 8: (2, 602), 9: (2, 679),
    10: (4, 340), 11: (4, 378), 12: (4, 434), 13: (4, 490), 14: (4, 553),
    15: (4, 616), 16: (4, 658), 17: (6, 438), 18: (6, 466), 19: (6, 517),
    20: (6, 567), 21: (6, 616), 22: (6, 666), 23: (6, 719), 24: (6, 772),
    25: (6, 822), 26: (6, 873), 27: (6, 910), 28: (6, 948),
}

# Table 5.1.3.1-2 (MCS index table 2, up to 256QAM)
MCS_TABLE_2 = {
    0: (2, 120), 1: (2, 193), 2: (2, 308), 3: (2, 449), 4: (2, 602),
    5: (4, 378), 6: (4, 434), 7: (4, 490), 8: (4, 553), 9: (4, 616),
    10: (4, 658), 11: (6, 466), 12: (6, 517), 13: (6, 567), 14: (6, 616),
    15: (6, 666), 16: (6, 719), 17: (6, 772), 18: (6, 822), 19: (6, 873),
    20: (8, 682.5), 21: (8, 711), 22: (8, 754), 23: (8, 797), 24: (8, 841),
    25: (8, 885), 26: (8, 916.5), 27: (8, 948),
}


def mcs_to_qm_rate(mcs_index: int, mcs_table: int = 1):
    """-> (num_bits_per_symbol Qm, target code rate R)."""
    table = {1: MCS_TABLE_1, 2: MCS_TABLE_2}[mcs_table]
    qm, r1024 = table[mcs_index]
    return qm, r1024 / 1024.0


# Table 5.1.3.2-1: TBS values for Ninfo <= 3824
TBS_TABLE = [
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
]


def calculate_tbs(num_prbs: int, num_symbols: int, num_dmrs_re_per_prb: int,
                  qm: int, coderate: float, num_layers: int = 1,
                  num_oh_re: int = 0) -> int:
    """Transport block size per 38.214 §5.1.3.2.

    num_dmrs_re_per_prb: DMRS REs per PRB over the allocation (all CDM
    groups without data count as DMRS overhead).
    """
    n_re_prime = 12 * num_symbols - num_dmrs_re_per_prb - num_oh_re
    n_re = min(156, n_re_prime) * num_prbs
    n_info = n_re * coderate * qm * num_layers
    if n_info <= 3824:
        n = max(3, int(math.floor(math.log2(n_info))) - 6)
        n_info_p = max(24, (1 << n) * int(n_info // (1 << n)))
        for tbs in TBS_TABLE:
            if tbs >= n_info_p:
                return tbs
        return TBS_TABLE[-1]
    n = int(math.floor(math.log2(n_info - 24))) - 5
    n_info_p = max(3840, (1 << n) * int(round((n_info - 24) / (1 << n))))
    if coderate <= 0.25:
        c = math.ceil((n_info_p + 24) / 3816)
        return 8 * c * math.ceil((n_info_p + 24) / (8 * c)) - 24
    if n_info_p > 8424:
        c = math.ceil((n_info_p + 24) / 8424)
        return 8 * c * math.ceil((n_info_p + 24) / (8 * c)) - 24
    return 8 * math.ceil((n_info_p + 24) / 8) - 24
