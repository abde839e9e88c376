"""Jobs that each rank of a group runs: sharded computations whose results
are held against a single-process run.

`run_jobs(payload)` is the target of `launch.run_ranks` that
`chip_smoke.py` (phase `dist_path`) and `tests/test_torch_dist.py` start:
payload = {"device": "cpu" | "cuda", "jobs": [(kind, args), ...]}, and it
returns one dict per job with the job's outputs (CPU tensors and arrays),
the kernel launches the rank made in it and its seconds. Meshes are created once per
(data, grid) shape, in job order, which is the same on every rank. The
jobs (`JOBS`):

- "stack": the stack kernel on this rank's subcarrier shard of x (grid =
  world): its output block;
- "iteration": the iteration kernel on the shards of s and pe, with the
  readouts where given;
- "cgnn": `cgnn_apply` on a data x grid mesh: the llrs and h_hat of this
  rank's (batch, subcarrier) block;
- "sim_ber": `sim_ber` of an `E2EModel` on a data x grid mesh (mode "a")
  or without a mesh, one stream per rank (mode "b");
- "train": one training step (`train_once`) on a data x 1 mesh: the
  parameters after it;
- "mesh": the default mesh's shape.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import weights
from ..kernels import cgnn_iter, ldpc, sepconv
from ..rx.cgnn import cgnn_apply
from .fused_sharded import (fused_conv_stack_sharded,
                            fused_iteration_sharded)
from .mesh import constrain, make_mesh
from .multihost import world

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def launch_counts() -> dict:
    """The kernel wrappers' launch counters."""
    return {"sepconv_stack": sepconv.launches,
            "cgnn_iter": cgnn_iter.iter_launches,
            "cgnn_full": cgnn_iter.full_launches,
            "ldpc_decode": ldpc.launches}


def reset_counts():
    sepconv.launches = 0
    cgnn_iter.iter_launches = 0
    cgnn_iter.full_launches = 0
    ldpc.launches = 0


def to_device(tree, device):
    """A parameter tree on device, without the kernels' packed buffers
    (derived from the leaves, rebuilt there at first use)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()
                if k != "packed"}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def _stack(args, device, mesh_of):
    mesh = mesh_of(1, world()[1])
    dtype = DTYPES[args["dtype"]]
    p = to_device(args["p"], device)
    x = constrain(args["x"], mesh, None, 2).to(device, dtype).contiguous()
    return {"out": fused_conv_stack_sharded(p, x, mesh).cpu()}


def _iteration(args, device, mesh_of):
    mesh = mesh_of(1, world()[1])
    dtype = DTYPES[args["dtype"]]
    it_p = to_device(args["it_p"], device)
    s = constrain(args["s"], mesh, None, 3).to(device, dtype).contiguous()
    pe = constrain(args["pe"], mesh, None, 2).to(device, dtype).contiguous()
    readouts = to_device(args.get("readouts") or [], device)
    out = fused_iteration_sharded(it_p, s, pe, args["active"].to(device),
                                  mesh, *readouts)
    out = out if isinstance(out, tuple) else (out,)
    return {"out": [o.cpu() for o in out]}


def _cgnn(args, device, mesh_of):
    mesh = mesh_of(args["data"], args["grid"])

    def block(x, batch_axis, sc_axis):
        return constrain(x, mesh, batch_axis, sc_axis).to(device)
    llrs, h_hats = cgnn_apply(
        to_device(args["params"], device), args["cfg"],
        block(args["y"], 0, 2), block(args["pe"], None, 2),
        block(args["h"], 0, 3), block(args["active"], 0, None),
        block(args["mm"], 0, None), dtype=DTYPES[args["dtype"]],
        mesh=mesh)
    return {"llr": llrs[-1][0].cpu(), "h_hat": h_hats[-1].cpu(),
            "index": (mesh.data_index, mesh.grid_index)}


def eval_model(args, device):
    """(E2EModel, params) of args: "config", "config_dir" (optional),
    "weights" (an `.npz`)."""
    from ..entry import load_params
    from ..sim.config import Parameters
    from ..sim.e2e import E2EModel
    p = Parameters(args["config"], training=False,
                   config_dir=args.get("config_dir"))
    model = E2EModel(p, device=device)
    return model, load_params(dtype=p.nrx_dtype, device=device,
                              path=args["weights"])


def _sim_ber(args, device, mesh_of):
    from ..sim.simber import sim_ber
    model, params = eval_model(args, device)
    mesh = mesh_of(args["data"], args["grid"]) if args["mode"] == "a" \
        else None
    ber, bler, errs, blocks = sim_ber(model, params, mesh=mesh,
                                      return_counts=True, verbose=False,
                                      **args["kwargs"])
    return {"ber": ber, "bler": bler, "block_errors": errs,
            "blocks": blocks}


def train_once(args, device, mesh=None):
    """(params after one training step, losses): a training `E2EModel` of
    args["config"] (with "config_dir", "overrides"), the parameters
    args["leaves"] (`weights.flatten` names, float32), Adam at args["lr"],
    phase 0 of the configuration's schedule at the global batch
    args["batch"], a generator seeded with args["seed"]; on `mesh`, the
    batch split over its data axis."""
    from ..sim import training
    from ..sim.config import Parameters
    from ..sim.e2e import E2EModel
    p = Parameters(args["config"], training=True,
                   config_dir=args.get("config_dir"),
                   overrides=args.get("overrides"))
    model = E2EModel(p, training=True, device=device)
    params = training.trainable(to_device(weights.unflatten(
        dict(args["leaves"])), device))
    opt = training.make_adam(params, args["lr"])
    s = p.training_schedule
    step = training.make_step(
        model, p, opt, list(range(len(p.mcs_index))), args["batch"],
        bool(s["double_readout"][0]), float(s["weighting_double_readout"][0]),
        bool(s["apply_multiloss"][0]), bool(s["train_tx"][0]), mesh=mesh)
    step.set_snr_range(s["min_training_snr_db"][0],
                       s["max_training_snr_db"][0])
    gen = torch.Generator(device=device).manual_seed(args["seed"])
    losses = step(params, gen)
    return ({k: v.detach().cpu() for k, v in
             weights.flatten(params).items()},
            torch.stack(losses).cpu())


def _train(args, device, mesh_of):
    leaves, losses = train_once(args, device, mesh_of(world()[1], 1))
    return {"leaves": leaves, "losses": losses}


def _mesh(args, device, mesh_of):
    return {"shape": make_mesh().shape}


JOBS = {"stack": _stack, "iteration": _iteration, "cgnn": _cgnn,
        "sim_ber": _sim_ber, "train": _train, "mesh": _mesh}


def run_jobs(payload) -> list:
    """Each job of payload["jobs"] on payload["device"] in this rank, with
    its launch counts; see the module docstring."""
    device = torch.device(payload["device"])
    meshes: dict = {}

    def mesh_of(data: int, grid: int):
        if (data, grid) not in meshes:
            meshes[data, grid] = make_mesh(data=data, grid=grid)
        return meshes[data, grid]

    out = []
    for kind, args in payload["jobs"]:
        reset_counts()
        t0 = time.perf_counter()
        rec = JOBS[kind](args, device, mesh_of)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["launches"] = launch_counts()
        rec["seconds"] = time.perf_counter() - t0
        out.append(rec)
    return out


def assemble(blocks: list, key: str) -> torch.Tensor:
    """The global [b, T, sym, sc, ...] tensor of the "cgnn" job's blocks
    (one record per rank): batch blocks stacked along axis 0, subcarrier
    blocks along axis 3; ranks holding the same block count once."""
    seen = {}
    for rec in blocks:
        seen.setdefault(rec["index"], rec[key])
    rows = sorted({d for d, _ in seen})
    cols = sorted({g for _, g in seen})
    return torch.cat([torch.cat([seen[d, g] for g in cols], dim=3)
                      for d in rows], dim=0)


def flat_leaves(params) -> dict:
    """{name: float32 CPU tensor} of a parameter tree."""
    return {k: v.detach().float().cpu() for k, v in
            weights.flatten(params).items()}


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64)), initial=0.0))
