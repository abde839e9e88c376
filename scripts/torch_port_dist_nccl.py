"""The multi-GPU layer across cards, one rank a card over NCCL.

Starts one rank per card (`dist.launch.run_ranks`, NCCL, rank r on card r)
and runs `dist.checks.run_jobs` on `chip_smoke.py`'s sharded jobs at
nrx_rt's widths (`dist_inputs`: 132 PRB, committed weights, inputs from
numpy), then holds each result against the same computation on card 0
alone, as `chip_smoke.py` `dist_path` does on one card: the stack and
iteration kernels on subcarrier shards, their halos exchanged between
cards, in bf16 and float32 (`check_kernel_jobs`); the eval CGNN on meshes
1 x W and 2 x W/2 (`check_cgnn_jobs`); `sim_ber` on a 2 x W/2 mesh
(counters equal); a training step on a W x 1 mesh (parameters equal on
every rank, the largest difference from one card's step). Prints one JSON
line with the cards' name and power limit and exits non-zero if a check
fails. A CPU rehearsal with gloo ranks at a small size: --device cpu
--backend gloo --world 4 --config test_small --config-dir tests/data
--batch 4 --train-batch 8.

    python3 scripts/torch_port_dist_nccl.py
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--config", default="nrx_rt")
    ap.add_argument("--config-dir", default=None)
    ap.add_argument("--batch", type=int, default=30)
    ap.add_argument("--train-batch", type=int, default=None)
    args = ap.parse_args()
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from neural_rx_tpu_torch.dist import checks
    from neural_rx_tpu_torch.dist.launch import run_ranks
    from neural_rx_tpu_torch.kernels import _build
    from neural_rx_tpu_torch.sim.simber import sim_ber

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.build()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    world = args.world or torch.cuda.device_count()
    t0 = time.perf_counter()
    d = smoke.dist_inputs(args.config, args.config_dir, args.batch,
                          args.train_batch)
    meshes = [(1, world), (2, world // 2)]
    n_k = len(d["kernel_jobs"])
    jobs = d["kernel_jobs"] + smoke.cgnn_jobs(d, meshes) + [
        ("sim_ber", dict(d["eval_args"], mode="a", data=2,
                         grid=world // 2)),
        ("train", d["train_args"])]
    ranks = run_ranks("neural_rx_tpu_torch.dist.checks:run_jobs", world,
                      args.backend, {"device": args.device, "jobs": jobs},
                      900)
    groups = [list(r) for r in zip(*ranks)]
    ranks_s = time.perf_counter() - t0

    out = {"card": card, "world": world, "backend": args.backend,
           "kernels": smoke.check_kernel_jobs(dev, d["kernel_jobs"],
                                              groups[:n_k], world),
           "cgnn": smoke.check_cgnn_jobs(dev, d, groups[n_k:n_k + 2],
                                         meshes)}
    model, params = checks.eval_model(d["eval_args"], dev)
    ref = sim_ber(model, params, verbose=False, return_counts=True,
                  **d["eval_args"]["kwargs"])
    out["sim_ber"] = {
        "counters": [int(ref[2][0]), int(ref[3][0]), float(ref[0][0])],
        "equal": all(np.array_equal(r["block_errors"], ref[2])
                     and np.array_equal(r["blocks"], ref[3])
                     and np.array_equal(r["ber"], ref[0])
                     for r in groups[n_k + 2])}
    single, _ = checks.train_once(d["train_args"], dev)
    train = groups[-1]
    out["train"] = {
        "ranks_equal": all(torch.equal(v, train[0]["leaves"][k])
                           for r in train for k, v in r["leaves"].items()),
        "vs_single_max_abs": max(checks.max_abs_diff(v, single[k])
                                 for k, v in train[0]["leaves"].items())}
    out["launches_rank0"] = [r[0]["launches"] for r in groups]
    out["job_seconds"] = [max(r["seconds"] for r in recs) for recs in groups]
    out["ranks_seconds"] = ranks_s
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    ok = (all(k["ok"] for k in out["kernels"])
          and all(c["rel_err"] <= 1e-5 for c in out["cgnn"])
          and out["sim_ber"]["equal"] and out["train"]["ranks_equal"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
