"""Monte-Carlo BER/BLER simulation with early stopping.

The port's counterpart of `neural_rx_tpu/sim/simber.py`: a per-step
evaluation that returns the four integer error counters (bit errors, bits,
block errors, blocks), a host loop that accumulates steps per Eb/N0 point
until `num_target_block_errors` block errors or `max_mc_iter` steps, a
sweep that stops once a point's BLER falls below `target_bler`, the
Wilson interval of a BLER and the results pickle keyed
(system, num_tx, mcs_idx) in the JAX package's format.

One `torch.Generator` on the model's device, seeded with `seed`, feeds
every step of a sweep in turn. A device mesh and several processes are the
multi-GPU slice's and raise.
"""

from __future__ import annotations

import os
import pickle
import time
import warnings

import numpy as np
import torch


def make_eval_step(model, fast_ldpc: bool = False, num_it: int | None = None,
                   mcs_arr_eval_idx: int | None = None):
    """step(params, generator, batch_size, ebno_db) -> int64 [4] array
    (bit errors, bits, block errors, blocks) of one batch of `model` (an
    `E2EModel`, a `BaselineE2EModel` with params {} and num_it None, or a
    `sim.mixed_mcs` model, whose b is one user's [b, tb_size]) on MCS
    mcs_arr_eval_idx (default: the model's default, MCS 0); the two error
    counts come to the host in one copy."""
    kwargs = {"fast_ldpc": fast_ldpc}
    if num_it is not None:
        kwargs["num_it"] = num_it
    if mcs_arr_eval_idx is not None:
        kwargs["mcs_arr_eval_idx"] = mcs_arr_eval_idx

    def step(params, generator, batch_size, ebno_db):
        b, b_hat, _ = model(params, generator, batch_size, ebno_db, **kwargs)
        # one transport block per leading element
        errs = (b != b_hat).sum(dim=-1)
        bit_errs, blk_errs = torch.stack([errs.sum(),
                                          (errs > 0).sum()]).tolist()
        return np.asarray([bit_errs, b.numel(), blk_errs, errs.numel()],
                          np.int64)

    return step


def sim_ber(model, params, ebno_dbs, batch_size: int,
            max_mc_iter: int = 100, num_target_block_errors: int = 200,
            target_bler: float | None = None, num_it: int | None = None,
            seed: int = 0, verbose: bool = True, mesh=None,
            mcs_arr_eval_idx: int | None = None,
            fast_ldpc: bool = False, return_counts: bool = False,
            point_callback=None):
    """Monte-Carlo sweep of `model` on MCS mcs_arr_eval_idx (see
    `make_eval_step`). Returns (ber, bler) arrays over ebno_dbs; with
    return_counts=True also the (block_errors, num_blocks) integer arrays
    (see `bler_confidence_interval`).

    A point stops once `num_target_block_errors` block errors are counted
    or after `max_mc_iter` steps; the sweep stops after the first point
    whose BLER is below `target_bler`. point_callback(ebno_db, ber, bler)
    fires after every finished point, so a caller can save partial sweeps.
    """
    if mesh is not None or (torch.distributed.is_available()
                            and torch.distributed.is_initialized()
                            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "a mesh or several processes are the multi-GPU slice's "
            "(ROADMAP A6)")
    step = make_eval_step(model, fast_ldpc=fast_ldpc, num_it=num_it,
                          mcs_arr_eval_idx=mcs_arr_eval_idx)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    ebno_dbs = np.asarray(ebno_dbs, np.float32)
    bers = np.full(len(ebno_dbs), np.nan)
    blers = np.full(len(ebno_dbs), np.nan)
    blk_errs = np.zeros(len(ebno_dbs), np.int64)
    blk_tot = np.zeros(len(ebno_dbs), np.int64)
    for i, ebno in enumerate(ebno_dbs):
        total = np.zeros(4, np.int64)
        t0 = time.time()
        for _ in range(max_mc_iter):
            total += step(params, generator, batch_size, float(ebno))
            if total[2] >= num_target_block_errors:
                break
        be, nb, ble, nbl = (int(v) for v in total)
        bers[i] = be / max(nb, 1)
        blers[i] = ble / max(nbl, 1)
        blk_errs[i], blk_tot[i] = ble, nbl
        if verbose:
            print(f"Eb/No {ebno:5.1f} dB | BER {bers[i]:.4e} | "
                  f"BLER {blers[i]:.4e} | blocks {nbl} | "
                  f"{time.time()-t0:.1f}s", flush=True)
        if point_callback is not None:
            point_callback(float(ebno), float(bers[i]), float(blers[i]))
        if target_bler is not None and blers[i] < target_bler:
            break
    if return_counts:
        return bers, blers, blk_errs, blk_tot
    return bers, blers


def bler_confidence_interval(block_errors: int, num_blocks: int,
                             z: float = 1.96):
    """Wilson score interval for a BLER estimate (95% by default)."""
    if num_blocks <= 0:
        return (float("nan"), float("nan"))
    p = block_errors / num_blocks
    denom = 1 + z ** 2 / num_blocks
    center = (p + z ** 2 / (2 * num_blocks)) / denom
    half = (z / denom) * np.sqrt(p * (1 - p) / num_blocks
                                 + z ** 2 / (4 * num_blocks ** 2))
    return (max(center - half, 0.0), min(center + half, 1.0))


def save_results(path: str, label: str, system_name: str, num_tx: int,
                 mcs_idx: int, ebno_dbs, bers, blers):
    """Append-update a results pickle (union SNR grid, {key: BER curve},
    {key: BLER curve}) keyed (system, num_tx, mcs_idx). Sweeps run on
    different grids are merged onto the union grid (rounded to 1e-6 dB),
    each curve NaN-padded where it was not measured; new measurements win
    where measured and stored points survive elsewhere."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new_e = np.round(np.asarray(ebno_dbs, np.float64), 6)
    if os.path.exists(path):
        with open(path, "rb") as f:
            ebno_arr, ber_d, bler_d = pickle.load(f)
        ebno_arr = np.round(np.asarray(ebno_arr, np.float64), 6)
    else:
        ebno_arr, ber_d, bler_d = new_e, {}, {}

    union = np.union1d(ebno_arr, new_e)

    def remap(curve, grid):
        curve = np.asarray(curve, np.float64)
        if len(curve) != len(grid):
            warnings.warn(
                f"save_results({path}): curve length {len(curve)} != "
                f"grid length {len(grid)}; extra entries dropped")
        n = min(len(curve), len(grid))
        out = np.full(len(union), np.nan)
        for i in range(n):
            j = int(np.argmin(np.abs(union - grid[i])))
            out[j] = curve[i]
        return out

    if not np.array_equal(union, ebno_arr):
        ber_d = {k: remap(v, ebno_arr) for k, v in ber_d.items()}
        bler_d = {k: remap(v, ebno_arr) for k, v in bler_d.items()}
    keyname = (system_name, num_tx, mcs_idx)

    def merge(d, curve):
        new = remap(curve, new_e)
        old = d.get(keyname)
        if old is not None:
            old = np.asarray(old, np.float64)
            d[keyname] = np.where(np.isnan(new), old, new)
        else:
            d[keyname] = new

    merge(ber_d, bers)
    merge(bler_d, blers)
    with open(path, "wb") as f:
        pickle.dump((union, ber_d, bler_d), f)
