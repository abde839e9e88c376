"""Trajectory sampling and the synthetic site-specific CIR datasets.

The port's copy of the NumPy code of `neural_rx_tpu/sim/trajectory.py`:
`sample_along_trajectory` (equally spaced positions and velocities along a
polyline of waypoints) and `generate_synthetic_cir_dataset` (a static
scatterer field around the trajectory gives each position a CIR (a, tau),
written as `.cirbin`), with the canonical site's constants. Both write the
JAX package's files byte for byte from the same arguments.

`ensure_site_datasets` keeps the JAX package's defaults (200 points for
each file). `write_committed_site_datasets` writes what the repository's
`data/` holds: the eval trajectory at 200 points (seed 1) and the train
trajectory at 2000 (seed 0). Run as a script it writes those into a
directory:

    python -m neural_rx_tpu_torch.sim.trajectory --out DIR
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..channel.io_native import write_cirbin

SPEED_OF_LIGHT = 299792458.0

# canonical synthetic site: train/eval trajectories through one scatterer
# field
SITE_BS_POSITION = [40.0, 30.0, 25.0]
SITE_TRAIN_WAYPOINTS = [[0, 0, 1.5], [80, 0, 1.5], [80, 60, 1.5],
                        [0, 60, 1.5]]
SITE_EVAL_WAYPOINTS = [[-80.0, 40.0, 1.5], [20.0, -30.0, 1.5],
                       [90.0, 60.0, 1.5]]
TRAIN_FILE = "nrx_site_specific_train.cirbin"
EVAL_FILE = "nrx_site_specific_eval.cirbin"
# (points, seed) of the files the repository's data/ holds
COMMITTED = {TRAIN_FILE: (2000, 0), EVAL_FILE: (200, 1)}


def sample_along_trajectory(waypoints, num_points: int,
                            speed_mps: float = 1.0):
    """Waypoints [W, 3] -> (positions [N, 3], velocities [N, 3]): points
    equally spaced along the polyline, each with its segment's direction
    times speed_mps."""
    wp = np.asarray(waypoints, np.float64)
    seg = np.diff(wp, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    s = np.linspace(0.0, cum[-1], num_points, endpoint=False)
    pos = np.empty((num_points, wp.shape[1]))
    vel = np.empty_like(pos)
    for i, si in enumerate(s):
        j = min(np.searchsorted(cum, si, "right") - 1, len(seg) - 1)
        frac = (si - cum[j]) / max(seg_len[j], 1e-12)
        pos[i] = wp[j] + frac * seg[j]
        vel[i] = seg[j] / max(seg_len[j], 1e-12) * speed_mps
    return pos, vel


def generate_synthetic_cir_dataset(
        path: str, waypoints, num_points: int, bs_position,
        carrier_frequency: float = 2.14e9, num_rx_ant: int = 4,
        num_tx_ant: int = 2, num_paths: int = 12, seed: int = 0):
    """Write a synthetic site dataset to `path`: a direct path and
    num_paths - 1 paths via scatterers drawn around the trajectory's
    centre, per position a CIR with geometric delays and phases and ULA
    responses from the geometry's angles. Returns the positions."""
    rng = np.random.default_rng(seed)
    pos, _ = sample_along_trajectory(waypoints, num_points)
    bs = np.asarray(bs_position, np.float64)
    center = pos.mean(0)
    scat = center + rng.normal(scale=60.0, size=(num_paths - 1, 3))
    scat[:, 2] = np.abs(scat[:, 2]) + 5.0
    lam = SPEED_OF_LIGHT / carrier_frequency

    a = np.zeros((num_points, num_rx_ant, num_tx_ant, num_paths),
                 np.complex64)
    tau = np.zeros((num_points, num_paths), np.float32)
    for i, p in enumerate(pos):
        d_los = np.linalg.norm(bs - p)
        dists = np.asarray([d_los] + [np.linalg.norm(p - s)
                                      + np.linalg.norm(bs - s)
                                      for s in scat])
        tau[i] = (dists / SPEED_OF_LIGHT).astype(np.float32)
        gains = np.concatenate(
            [[1.0], 0.3 * rng.rayleigh(scale=1.0, size=num_paths - 1)])
        gains = gains / np.linalg.norm(gains)
        phases = np.exp(-2j * np.pi * dists / lam)
        # the direct path departs toward the BS and arrives from the UE;
        # a scattered path departs and arrives via its scatterer
        dep_targets = np.vstack([bs[None], scat])
        arr_targets = np.vstack([p[None], scat])
        aod = np.arctan2(dep_targets[:, 1] - p[1],
                         dep_targets[:, 0] - p[0] + 1e-9)
        aoa = np.arctan2(arr_targets[:, 1] - bs[1],
                         arr_targets[:, 0] - bs[0] + 1e-9)
        for pi in range(num_paths):
            ar = np.exp(1j * np.pi * np.arange(num_rx_ant)
                        * np.sin(aoa[pi]))
            at = np.exp(1j * np.pi * np.arange(num_tx_ant)
                        * np.sin(aod[pi]))
            a[i, :, :, pi] = (gains[pi] * phases[pi]
                              * np.outer(ar, at)).astype(np.complex64)
    write_cirbin(path, a, tau)
    return pos


def _write(data_dir: str, name: str, num_points: int, seed: int) -> str:
    path = os.path.join(data_dir, name)
    waypoints = SITE_TRAIN_WAYPOINTS if name == TRAIN_FILE \
        else SITE_EVAL_WAYPOINTS
    generate_synthetic_cir_dataset(path, waypoints, num_points,
                                   bs_position=SITE_BS_POSITION, seed=seed)
    return path


def ensure_site_datasets(data_dir: str = "data", num_points: int = 200):
    """(train path, eval path) in data_dir, each generated with num_points
    points if absent (train seed 0, eval seed 1), as the JAX package's."""
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for name, seed in ((TRAIN_FILE, 0), (EVAL_FILE, 1)):
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            _write(data_dir, name, num_points, seed)
        paths.append(path)
    return tuple(paths)


def write_committed_site_datasets(data_dir: str):
    """(train path, eval path): the two files of the repository's data/
    (`COMMITTED`), written anew into data_dir."""
    os.makedirs(data_dir, exist_ok=True)
    return tuple(_write(data_dir, name, n, seed)
                 for name, (n, seed) in COMMITTED.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    for path in write_committed_site_datasets(ap.parse_args(argv).out):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
