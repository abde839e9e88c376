"""Goodput and result export.

The port's copy of `neural_rx_tpu/sim/metrics.py`'s `calculate_goodput`,
`load_results` and `export_csv` (NumPy; the results pickles of both
packages have one format). Plotting waits for the tooling slice.
"""

from __future__ import annotations

import csv
import pickle

import numpy as np


def calculate_goodput(bler, tb_size: int, num_res: int,
                      num_pilots: int = 0, include_pilots: bool = True):
    """Goodput in information bits per resource element:
    (1 - BLER) * TBS / REs. include_pilots=False drops the DMRS overhead
    from the RE count (pilotless comparison)."""
    bler = np.asarray(bler, np.float64)
    res = num_res if include_pilots else num_res - num_pilots
    return (1.0 - bler) * tb_size / res


def load_results(path: str):
    """Load a results pickle: (ebno_dbs, ber_dict, bler_dict)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def export_csv(results_path: str, out_path: str):
    """Flatten a results pickle to CSV rows (system, num_tx, mcs_idx,
    ebno_db, ber, bler)."""
    ebno, bers, blers = load_results(results_path)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["system", "num_tx", "mcs_idx", "ebno_db", "ber",
                    "bler"])
        for key in blers:
            sys_name, num_tx, mcs = key
            for e, br, bl in zip(np.asarray(ebno).ravel(),
                                 np.asarray(bers[key]).ravel(),
                                 np.asarray(blers[key]).ravel()):
                w.writerow([sys_name, num_tx, mcs, float(e), float(br),
                            float(bl)])
