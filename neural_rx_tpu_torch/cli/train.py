"""Training of the neural receiver by the configuration's phased schedule.

    python -m neural_rx_tpu_torch.cli.train --config nrx_rt [--smoke] \
        [--iters N] [--warm-start [PATH]] [--device cuda|cpu] \
        [--weights-dir DIR] [--log-dir DIR] [--seed S]

Trains from seed-made parameters (`E2EModel.init_params`, seed --seed) on
the configuration's training channel and width with `sim.training.
training_loop`, and writes DIR/{label}_weights.npz (the format
`cli/evaluate.py --weights` loads), the checkpoint DIR/{label}_ckpt.pt and
the log LOGDIR/{label}.jsonl. --warm-start starts from PATH (an `.npz` of
weights or a `_ckpt.pt` checkpoint), by default from DIR/{label}_weights.npz
if it exists, else from the committed weights of the configuration; leaves
whose name or shape differ keep their seed-made values.

--smoke runs a short training under the label {label}_smoke, so it never
writes over trained weights or their log, and checks that the mean loss of
the last chunk lies below the first chunk's (or far below the ln 2 of
guessing): 500 iterations in chunks of 100, or on the CPU 30 iterations at
batch 4 in chunks of 10 over an AWGN channel. --iters caps the iterations.
The device defaults to cuda, which needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True,
                    help="configuration label, e.g. nrx_rt")
    ap.add_argument("--smoke", action="store_true",
                    help="a short run; assert that the loss decreases")
    ap.add_argument("--iters", type=int, default=None,
                    help="cap the SGD iterations of all phases together")
    ap.add_argument("--warm-start", nargs="?", const="", default=None,
                    metavar="PATH", help="start from existing weights")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--weights-dir", default="weights")
    ap.add_argument("--log-dir", default="logs")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import torch

    from .. import weights
    from ..rx.neural_rx import resolve_device
    from ..sim.config import Parameters
    from ..sim.e2e import E2EModel
    from ..sim.training import (load_checkpoint, load_weights,
                                merge_matching_leaves, training_loop)

    device = resolve_device(args.device)
    cpu_smoke = args.smoke and device.type == "cpu"
    # the CPU smoke keeps the work tiny: AWGN in place of the training
    # channel still runs the whole TX -> RX -> loss -> gradient path
    overrides = {"channel_type": "AWGN"} if cpu_smoke else None
    p = Parameters(args.config, training=True, overrides=overrides)
    model = E2EModel(p, training=True, device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(args.seed))

    if args.warm_start is not None:
        path = args.warm_start or os.path.join(
            args.weights_dir, f"{p.label}_weights.npz")
        if not args.warm_start and not weights.exists(path):
            path = weights.committed_weights(p.label)
        src = (load_checkpoint(path, device)[0] if path.endswith(".pt")
               else load_weights(path, device))
        params, copied, kept = merge_matching_leaves(params, src)
        print(f"warm start from {path}: {copied} leaves copied, {kept} "
              "kept", flush=True)

    max_iters, chunk = args.iters, 100
    if args.smoke:
        max_iters = max_iters or 500
        if cpu_smoke:
            p.training_schedule["batch_size"] = [
                4 for _ in p.training_schedule["batch_size"]]
            chunk, max_iters = 10, args.iters or 30
        chunk = min(chunk, max_iters)
    label = f"{p.label}_smoke" if args.smoke else p.label
    log_path = os.path.join(args.log_dir, f"{label}.jsonl")
    if args.smoke and os.path.exists(log_path):
        os.remove(log_path)

    training_loop(model, p, params, label=label,
                  results_dir=args.weights_dir, log_dir=args.log_dir,
                  seed=args.seed, chunk=chunk, max_iters=max_iters)

    if args.smoke:
        with open(log_path) as f:
            recs = [json.loads(line) for line in f]
        first, last = recs[0]["loss_mean"], recs[-1]["loss_mean"]
        print(f"smoke: loss {first:.4f} -> {last:.4f}")
        if not (last < first or last < 0.6):
            raise SystemExit("smoke failed: the loss did not decrease")
        print("SMOKE PASSED")


if __name__ == "__main__":
    main()
