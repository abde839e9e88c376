"""MCS tables, 38.214 §5.1.3.1.

`mcs_to_qm_rate` gives the (modulation order, target code rate) of an MCS
index. Transport-block sizing is not needed by the serving path.
"""

from __future__ import annotations

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
