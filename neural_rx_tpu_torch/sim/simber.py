"""Monte-Carlo BER/BLER simulation with early stopping.

The port's counterpart of `neural_rx_tpu/sim/simber.py`: a per-step
evaluation that returns the four integer error counters (bit errors, bits,
block errors, blocks), a host loop that accumulates steps per Eb/N0 point
until `num_target_block_errors` block errors or `max_mc_iter` steps, a
sweep that stops once a point's BLER falls below `target_bler`, the
Wilson interval of a BLER and the results pickle keyed
(system, num_tx, mcs_idx) in the JAX package's format.

One `torch.Generator` on the model's device, seeded with `seed`, feeds
every step of a sweep in turn.

Several processes (`dist/`), two modes as in the JAX package, never
combined:
(a) a mesh that spans the ranks (`mesh=`, an `E2EModel`): every rank seeds
    its generator with `seed` and draws the global batch, computes its data
    block (`E2EModel(mesh=)`), and the counters are summed over the data
    group; the result is the single-device run's;
(b) no mesh and a world of several processes: each rank draws its own
    stream (`dist.multihost.host_generator(seed)`) and evaluates
    batch_size items a step; the four counters are summed over every rank
    each step, so every rank stops on the global counts.
Only rank 0 prints.
"""

from __future__ import annotations

import os
import pickle
import time
import warnings

import numpy as np
import torch

from ..dist import multihost
from ..dist.mesh import all_reduce, sum_over_data


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

    mesh: a `dist.mesh.Mesh` over every rank, for an `E2EModel` (mode (a)
    of the module's docstring; batch_size is the global batch); without
    one, several processes run mode (b).
    """
    rank, n_proc = multihost.world()
    if mesh is not None:
        if not hasattr(model, "mesh"):
            raise NotImplementedError(
                f"{type(model).__name__} takes no mesh: run it one process "
                "per rank, without a mesh")
        kept = model.mesh
        try:
            model.mesh = mesh  # checks its type
            if mesh.data * mesh.grid != n_proc:
                raise ValueError(f"the mesh spans {mesh.data * mesh.grid} "
                                 f"ranks of {n_proc}")
            return sim_ber(model, params, ebno_dbs, batch_size, max_mc_iter,
                           num_target_block_errors, target_bler, num_it,
                           seed, verbose, None,
                           mcs_arr_eval_idx, fast_ldpc, return_counts,
                           point_callback)
        finally:
            model.mesh = kept
    on_mesh = getattr(model, "mesh", None)
    verbose = verbose and rank == 0
    step = make_eval_step(model, fast_ldpc=fast_ldpc, num_it=num_it,
                          mcs_arr_eval_idx=mcs_arr_eval_idx)
    if on_mesh is not None:  # mode (a): the data blocks' counters
        def reduce(r):
            return sum_over_data(torch.as_tensor(r, device=_comm_device(
                on_mesh.backend, model.device)), on_mesh).cpu().numpy()
        generator = torch.Generator(device=model.device).manual_seed(seed)
    elif n_proc > 1:  # mode (b): per-rank streams, global counters
        backend = torch.distributed.get_backend()

        def reduce(r):
            return all_reduce(torch.as_tensor(r, device=_comm_device(
                backend, model.device)), None, backend).cpu().numpy()
        generator = multihost.host_generator(seed, model.device)
    else:
        def reduce(r):
            return r
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
            total += reduce(step(params, generator, batch_size,
                                 float(ebno)))
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


def _comm_device(backend: str | None, device) -> torch.device:
    """Where a backend's collective takes the counters: the model's card
    under NCCL, else the host."""
    return torch.device(device) if backend == "nccl" else torch.device("cpu")


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
