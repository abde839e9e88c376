"""Training loop: phased schedule, randomised users / MCS / SNR, Adam.

The port's counterpart of `neural_rx_tpu/sim/training.py`, with its
sampling: a triangular user count biased to the maximum, a per-user MCS
(uniform, or the configuration's `mcs_training_probs` row of the user
count), an Eb/N0 uniform in the phase's range of the user count plus the
configuration's per-MCS offsets over the active users, a random active
port set and, inside the E2E model, a random pilot slot. One step draws
all of that from a `torch.Generator` on the model's device, runs the
training forward (the receiver's plain layers under autograd), the
backward pass and one `torch.optim.Adam` update (optax's defaults: beta
0.9 / 0.999, eps 1e-8), and keeps its losses on the device. A phase
re-initialises Adam, as the JAX package does; a "chunk" of steps is the
logging unit: the losses reach the host once a chunk.

On a mesh (`make_step(mesh=)`, `dist/`) every rank draws the step's global
batch from the same generator, as one device would, trains on its data
block, and averages the gradients over the data group before Adam, so
every rank holds the same parameters after every step.

Checkpoints hold the parameters, Adam's state and the step in the port's
own format (`torch.save`, read back with `weights_only=True`); the JAX
package's pickles hold a JAX `PyTreeDef` and cannot be read without JAX.
Weights are written as `.npz` of named leaves (`weights.save`), the format
`cli/evaluate.py` loads.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .. import weights
from ..dist.mesh import sum_over_data
from .e2e import data_block, sample_active_dmrs, training_block

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8


def triangular_sample(generator: torch.Generator, minimum: int,
                      maximum: int) -> torch.Tensor:
    """A user count in [minimum, maximum] biased to the maximum, as a 0-dim
    int64 tensor on the generator's device: floor(a + sqrt(u) (b - a)) with
    b = maximum + 1."""
    u = torch.rand((), generator=generator, device=generator.device)
    x = minimum + torch.sqrt(u) * (maximum + 1 - minimum)
    return torch.clamp(torch.floor(x).long(), max=maximum)


def sample_mcs_assignment(generator: torch.Generator, batch_size: int,
                          max_num_tx: int, mcs_arr_training_idx,
                          num_mcs: int, num_tx=None, min_num_tx: int = 1,
                          mcs_training_probs=None):
    """(mcs_idx [b, T] int64, one-hot mask [b, T, num_mcs] float32): each
    user's MCS, uniform over mcs_arr_training_idx, or drawn by the row
    num_tx - min_num_tx of mcs_training_probs."""
    dev = generator.device
    idx_arr = torch.as_tensor(mcs_arr_training_idx, dtype=torch.int64,
                              device=dev)
    if mcs_training_probs is None:
        r = torch.randint(0, len(mcs_arr_training_idx),
                          (batch_size, max_num_tx), generator=generator,
                          device=dev)
        mcs_idx = idx_arr[r]
    else:
        probs = torch.as_tensor(mcs_training_probs, dtype=torch.float32,
                                device=dev)
        p = probs[num_tx - min_num_tx]
        cdf = torch.cumsum(torch.cat([torch.zeros(1, device=dev),
                                      p / p.sum()]), 0)
        u = torch.rand((batch_size, max_num_tx, 1), generator=generator,
                       device=dev)
        cond = (u >= cdf[:-1]) & (u < cdf[1:])
        mcs_idx = (idx_arr * cond.long()).sum(-1)
    return mcs_idx, torch.nn.functional.one_hot(mcs_idx, num_mcs).float()


def trainable(params) -> dict:
    """A copy of params whose leaves are float32 tensors requiring grad."""
    return weights.unflatten({
        k: v.detach().float().clone().requires_grad_(True)
        for k, v in weights.flatten(params).items()})


def make_adam(params, lr: float) -> torch.optim.Adam:
    """Adam over every leaf of params with optax.adam's defaults."""
    return torch.optim.Adam(list(weights.flatten(params).values()), lr=lr,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def make_step(model, sys_parameters, optimizer, mcs_arr_training_idx,
              batch_size: int, double_readout: bool, weighting: float,
              apply_multiloss: bool, train_tx: bool, mesh=None):
    """step(params, generator) -> (loss_data, loss_chest, loss), 0-dim
    device tensors: one SGD iteration of `model` (an E2EModel with
    training=True) updating params (trainable leaves, `trainable`) in
    place through `optimizer`. The per-user-count Eb/N0 range is
    `step.set_snr_range(lo, hi)` (one entry per user count from
    min_num_tx; default [0, 1) dB).

    mesh (a `dist.mesh.Mesh` with a grid axis of 1): batch_size is the
    global batch, split over the data axis; the gradients (and the returned
    losses) are averaged over the data group in one all-reduce before
    Adam."""
    if mesh is not None and mesh.grid != 1:
        raise ValueError("training shards the batch alone: the mesh's grid "
                         f"axis must be 1, not {mesh.grid}")
    p = sys_parameters
    num_mcs = len(p.mcs_index)
    dev = model.device
    offsets = None
    if p.mcs_training_snr_db_offset is not None:
        offsets = torch.as_tensor(p.mcs_training_snr_db_offset,
                                  dtype=torch.float32, device=dev)
    n_counts = p.max_num_tx - p.min_num_tx + 1
    snr = {"lo": torch.zeros(n_counts, device=dev),
           "hi": torch.ones(n_counts, device=dev)}

    def sample(generator):
        """The per-step sampling: (Eb/N0 [b], active [b, T], MCS mask)."""
        num_tx = triangular_sample(generator, p.min_num_tx, p.max_num_tx)
        mcs_idx, mcs_ue_mask = sample_mcs_assignment(
            generator, batch_size, p.max_num_tx, mcs_arr_training_idx,
            num_mcs, num_tx=num_tx, min_num_tx=p.min_num_tx,
            mcs_training_probs=p.mcs_training_probs)
        lo = snr["lo"][num_tx - p.min_num_tx]
        hi = snr["hi"][num_tx - p.min_num_tx]
        u = torch.rand((batch_size,), generator=generator, device=dev)
        snr_db = lo + (hi - lo) * u
        active = sample_active_dmrs(generator, batch_size, num_tx,
                                    p.max_num_tx)
        if offsets is not None:
            off = offsets[num_tx - 1][mcs_idx]  # [b, T]
            snr_db = snr_db + (off * active).sum(dim=1)
        return snr_db, active, mcs_ue_mask

    def step(params, generator):
        snr_db, active, mcs_ue_mask = sample(generator)
        d = model.draw_training(generator, batch_size, snr_db,
                                list(range(num_mcs)))
        if mesh is not None:
            active, mcs_ue_mask = data_block(mesh, active, mcs_ue_mask)
            d = training_block(d, mesh)
        optimizer.zero_grad(set_to_none=True)
        loss_data, loss_chest = model.forward(
            params, d["bits"], d["h"], d["noise"], active_dmrs=active,
            mcs_ue_mask=mcs_ue_mask, slot_idx=d["slot_idx"], fo=d["fo"],
            apply_multiloss=apply_multiloss)
        loss = loss_data + weighting * loss_chest if double_readout \
            else loss_data
        loss.backward()
        if "constellation" in params and not train_tx:
            for c in params["constellation"]:
                c.grad = torch.zeros_like(c)
        losses = (loss_data.detach(), loss_chest.detach(), loss.detach())
        if mesh is not None:
            losses = average_over_data(params, losses, mesh)
        optimizer.step()
        return losses

    def set_snr_range(lo, hi):
        snr["lo"] = torch.as_tensor(lo, dtype=torch.float32, device=dev)
        snr["hi"] = torch.as_tensor(hi, dtype=torch.float32, device=dev)

    step.set_snr_range = set_snr_range
    step.sample = sample
    return step


def average_over_data(params, losses, mesh):
    """Every leaf's gradient and the losses averaged over the data group in
    one all-reduce (a leaf without a gradient counts as zeros); returns the
    averaged losses."""
    leaves = list(weights.flatten(params).values())
    grads = [torch.zeros_like(v) if v.grad is None else v.grad
             for v in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack(losses)])
    flat = sum_over_data(flat, mesh) / mesh.data
    at = 0
    for v in leaves:
        v.grad = flat[at:at + v.numel()].view_as(v).clone()
        at += v.numel()
    return tuple(flat[at:])


def make_eval_loss_fn(model, sys_parameters, batch_size: int = 32):
    """eval_losses(params, generator) -> {"eval_loss_mcs{i}": loss_data}:
    the data loss of every user active on MCS i at the configuration's
    eval_ebno_db_arr[i], without gradients (the monitor the JAX package
    logs)."""
    p = sys_parameters
    ebnos = [float(e) for e in p.eval_ebno_db_arr]
    dev = model.device

    def eval_losses(params, generator):
        out = {}
        active = torch.ones((batch_size, p.max_num_tx), device=dev)
        with torch.no_grad():
            for idx, ebno in enumerate(ebnos):
                mm = torch.zeros((batch_size, p.max_num_tx,
                                  len(p.mcs_index)), device=dev)
                mm[..., idx] = 1.0
                ld, _ = model(params, generator, batch_size,
                              torch.full((batch_size,), ebno, device=dev),
                              active_dmrs=active, mcs_ue_mask=mm)
                out[f"eval_loss_mcs{idx}"] = float(ld)
        return out
    return eval_losses


def save_checkpoint(path: str, params, optimizer, step: int) -> None:
    """params (named leaves), Adam's state and the step, `torch.save`d."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"params": {k: v.detach().cpu() for k, v in
                           weights.flatten(params).items()},
                "opt_state": optimizer.state_dict(), "step": int(step)},
               path)


def load_checkpoint(path: str, device="cpu"):
    """(params tree, Adam state dict, step) of `save_checkpoint`'s file."""
    d = torch.load(path, map_location=device, weights_only=True)
    return weights.unflatten(d["params"]), d["opt_state"], d["step"]


def save_weights(path: str, params) -> list:
    """Weights only, as `.npz` of named leaves (`weights.save`: in parts
    where one file would reach `weights.PART_LIMIT`). Returns the paths
    written."""
    return weights.save(path, params)


def load_weights(path: str, device="cpu") -> dict:
    """{"cgnn": tree[, "constellation": [...]]} of a weights `.npz`."""
    return weights.load_tree(path, device=device)


def merge_matching_leaves(dst, src):
    """Copy every leaf of `src` into `dst` whose name (`weights.flatten`)
    and shape both match; keep `dst`'s leaf otherwise (a warm start across
    configurations: nrx_rt -> nrx_rt_qpsk re-initialises only the LLR
    head). Returns (merged, copied, kept)."""
    flat_src = weights.flatten(src)
    merged, copied, kept = {}, 0, 0
    for name, v in weights.flatten(dst).items():
        s = flat_src.get(name)
        if s is not None and tuple(s.shape) == tuple(v.shape):
            merged[name] = s.to(v.device, v.dtype)
            copied += 1
        else:
            merged[name] = v
            kept += 1
    return weights.unflatten(merged), copied, kept


def training_loop(model, sys_parameters, params, label: str,
                  mcs_arr_training_idx=None, seed: int = 42,
                  results_dir: str = "weights", log_dir: str = "logs",
                  chunk: int = 100, max_iters: int | None = None,
                  eval_fn=None, verbose: bool = True,
                  weight_saving_schedule=None):
    """Phased training by the configuration's training_schedule; returns
    the trained params (trainable leaves).

    Each phase sets its learning rate, batch size, train_tx, double
    readout and its weight, multiloss and Eb/N0 range, with a fresh Adam.
    After every chunk of steps one line goes to log_dir/{label}.jsonl
    (phase, iteration, the chunk's last losses, its mean data and total
    losses, steps/s);
    every 1000 iterations and at the end a checkpoint goes to
    results_dir/{label}_ckpt.pt and eval_fn(params, iteration) runs; at
    the iterations of weight_saving_schedule a snapshot goes to
    {label}_weights_iter_{n}.npz; at the end the weights go to
    results_dir/{label}_weights.npz. max_iters caps the iterations of all
    phases together."""
    p = sys_parameters
    sched = p.training_schedule
    if mcs_arr_training_idx is None:
        mcs_arr_training_idx = list(range(len(p.mcs_index)))
    params = trainable(params)
    generator = torch.Generator(device=model.device).manual_seed(seed)
    os.makedirs(log_dir, exist_ok=True)
    total_done = 0
    with open(os.path.join(log_dir, f"{label}.jsonl"), "a") as log_f:
        for phase in range(len(sched["num_iter"])):
            if max_iters is not None and total_done >= max_iters:
                break
            optimizer = make_adam(params, float(
                sched["learning_rate"][phase]))
            step = make_step(
                model, p, optimizer, mcs_arr_training_idx,
                int(sched["batch_size"][phase]),
                bool(sched["double_readout"][phase]),
                float(sched["weighting_double_readout"][phase]),
                bool(sched["apply_multiloss"][phase]),
                bool(sched["train_tx"][phase]))
            step.set_snr_range(sched["min_training_snr_db"][phase],
                               sched["max_training_snr_db"][phase])
            it, num_iter = 0, int(sched["num_iter"][phase])
            while it < num_iter:
                if max_iters is not None and total_done >= max_iters:
                    break
                t0 = time.time()
                losses = torch.stack([torch.stack(step(params, generator))
                                      for _ in range(chunk)]).cpu().numpy()
                it += chunk
                total_done += chunk
                ld, lc, loss = (float(x) for x in losses[-1])
                rec = {"phase": phase, "iter": total_done, "loss_data": ld,
                       "loss_chest": lc, "loss": loss,
                       "loss_data_mean": float(losses[:, 0].mean()),
                       "loss_mean": float(losses[:, 2].mean()),
                       "iters_per_s": chunk / (time.time() - t0)}
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                if verbose:
                    print(f"[{label}] phase {phase} iter {total_done} "
                          f"loss {loss:.4f} ({rec['iters_per_s']:.1f} it/s)",
                          flush=True)
                if total_done % 1000 == 0 or (max_iters is not None
                                              and total_done >= max_iters):
                    save_checkpoint(os.path.join(
                        results_dir, f"{label}_ckpt.pt"), params, optimizer,
                        total_done)
                    if eval_fn is not None:
                        eval_fn(params, total_done)
                for snap in weight_saving_schedule or ():
                    if total_done - chunk < snap <= total_done:
                        save_weights(os.path.join(
                            results_dir, f"{label}_weights_iter_{snap}.npz"),
                            params)
    save_weights(os.path.join(results_dir, f"{label}_weights.npz"), params)
    return params


def loss_history(losses) -> np.ndarray:
    """[n, 3] float64 host array of a list of `step` results, copied from
    the device once."""
    return torch.stack([torch.stack(x) for x in losses]).double().cpu(
    ).numpy()
