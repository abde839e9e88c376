"""Goodput, result export and plotting.

The port's copy of `neural_rx_tpu/sim/metrics.py` (NumPy; the results
pickles of both packages have one format): `calculate_goodput`,
`load_results`, `export_csv`, `export_constellation` (a trainable
constellation as CSV), and the plots `plot_results` (BLER or BER curves)
and `plot_goodput`, which import matplotlib when called and write PNGs.
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


def _figure():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    return plt, fig, ax


def _finish(plt, fig, ax, out_path: str, title: str | None):
    ax.legend(fontsize=8)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_results(results_path: str, out_path: str, metric: str = "bler",
                 title: str | None = None):
    """The BLER (or BER, metric="ber") curves of a results pickle -> PNG,
    one curve per (system, num_tx, mcs_idx) on a log scale."""
    plt, fig, ax = _figure()
    ebno, bers, blers = load_results(results_path)
    data = blers if metric == "bler" else bers
    for key, vals in sorted(data.items()):
        sys_name, num_tx, mcs = key
        vals = np.asarray(vals, np.float64).ravel()
        e = np.asarray(ebno).ravel()[: len(vals)]
        ax.semilogy(e, np.maximum(vals, 1e-7), marker="o",
                    label=f"{sys_name} {num_tx}UE mcs{mcs}")
    ax.set_xlabel("Eb/No [dB]")
    ax.set_ylabel(metric.upper())
    ax.grid(True, which="both", alpha=0.4)
    _finish(plt, fig, ax, out_path, title)


def plot_goodput(results_path: str, out_path: str, tb_size: int,
                 num_res: int, num_pilots: int = 0,
                 pilotless_systems=(), title: str | None = None):
    """Goodput against Eb/N0 of a results pickle -> PNG; the systems in
    pilotless_systems get the pilot overhead removed from their RE count."""
    plt, fig, ax = _figure()
    ebno, _, blers = load_results(results_path)
    for key, vals in sorted(blers.items()):
        sys_name, num_tx, mcs = key
        gp = calculate_goodput(np.asarray(vals).ravel(), tb_size, num_res,
                               num_pilots,
                               include_pilots=sys_name not in
                               pilotless_systems)
        e = np.asarray(ebno).ravel()[: len(gp)]
        ax.plot(e, gp, marker="o", label=f"{sys_name} {num_tx}UE mcs{mcs}")
    ax.set_xlabel("Eb/No [dB]")
    ax.set_ylabel("Goodput [bit/RE]")
    ax.grid(True, alpha=0.4)
    _finish(plt, fig, ax, out_path, title)


def export_constellation(points, out_path: str):
    """A constellation -> CSV rows (index, re, im): points complex [n], or
    the (re, im) [2, n] array of a trainable constellation (a tensor or an
    array)."""
    if hasattr(points, "detach"):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points)
    if pts.ndim == 2 and pts.shape[0] == 2:
        pts = pts[0] + 1j * pts[1]
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "re", "im"])
        for i, c in enumerate(pts):
            w.writerow([i, float(np.real(c)), float(np.imag(c))])
