"""BLER of one system as the JAX package computes it today, on the CPU: the
reference the PyTorch port's `chip_smoke.py` holds a system to where the
committed curve under `results/` disagrees with the JAX package's own code
or was made with weights that are not in the repository.

Runs `neural_rx_tpu.sim.simber.sim_ber` (eval mode, the configuration's
eval channel and width, the flooding decoder unless --fast-ldpc) on the
JAX package's `BaselineE2EModel` (--system baseline_*, covariances from
--cov-dir), on its `E2EModel` (--system nrx with --weights, the evaluated
MCS --mcs-idx), or with --mixed-order on its `sim.mixed_mcs` models
(--system nrx or lslin; UE 0's BLER, users on the MCS of --mixed-mask's
one-hot rows), and prints one JSON line per Eb/N0 point (BLER, block
errors, blocks, Wilson 95 % interval, seconds) and a last line with the
whole curve, which --out also writes to a file. The curve `chip_smoke.py`
reads,
`neural_rx_tpu_torch/curves/jax_e2e_baseline_baseline_lmmse_kbest.json`,
was written by

    JAX_PLATFORMS=cpu python scripts/torch_port_jax_baseline_curve.py \
        --config e2e_baseline --system baseline_lmmse_kbest \
        --num-tx-eval 1 --snr 0 1 2 3 4 --batch-size 30 --max-iter 30 \
        --target-block-errors 100000 \
        --out neural_rx_tpu_torch/curves/jax_e2e_baseline_baseline_lmmse_kbest.json

(900 blocks a point; options: [--seed 0] [--cov-dir weights]
[--fast-ldpc]). Which var-MCS weights made which committed curve
(ROADMAP.md C4) was read from

    JAX_PLATFORMS=cpu python scripts/torch_port_jax_baseline_curve.py \
        --config nrx_rt_var_mcs --system nrx --mcs-idx 1 --snr 2 \
        --weights weights/nrx_rt_var_mcs_ema.pkl --batch-size 10 \
        --max-iter 15 --target-block-errors 100000

(and the same with weights/nrx_rt_var_mcs_weights.pkl, and both at
--mcs-idx 0 --snr 1), and the mixed-MCS curves the smoke reads,
`neural_rx_tpu_torch/curves/jax_mixed_mcs_{nrx,lslin}_{ue0_qpsk,
ue0_16qam}.json`, with

    JAX_PLATFORMS=cpu python scripts/torch_port_jax_baseline_curve.py \
        --config nrx_rt_var_mcs --system nrx \
        --weights weights/nrx_rt_var_mcs_weights.pkl \
        --mixed-order 0 1 --mixed-mask 1 0 0 1 --snr 0 1 2 \
        --batch-size 10 --max-iter 15 --target-block-errors 100000 \
        --out neural_rx_tpu_torch/curves/jax_mixed_mcs_nrx_ue0_qpsk.json

(150 blocks a point; user 0 on QPSK, user 1 on 16-QAM), --system lslin
without --weights, and --mixed-order 1 0 --mixed-mask 0 1 1 0 --snr 1 2 3
for user 0 on 16-QAM (`..._ue0_16qam.json`). nrx_large's curve with the
committed weights, `neural_rx_tpu_torch/curves/jax_nrx_large.json` (the
committed curve under `results/` was made with other weights, ROADMAP.md
R10), comes from three runs started together,

    JAX_PLATFORMS=cpu python scripts/torch_port_jax_baseline_curve.py \
        --config nrx_large --system nrx \
        --weights weights/nrx_large_weights.pkl --snr 0 1 \
        --batch-size 10 --max-iter 20 --target-block-errors 100000 \
        --out /tmp/jax_nrx_large_0_1.json

with --snr 2 3 and --snr 4 (400 blocks a point: 2 users), merged in Eb/N0
order by

    python scripts/torch_port_jax_baseline_curve.py --merge \
        /tmp/jax_nrx_large_0_1.json /tmp/jax_nrx_large_2_3.json \
        /tmp/jax_nrx_large_4.json \
        --out neural_rx_tpu_torch/curves/jax_nrx_large.json
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def merge(paths, out) -> int:
    """One record of the records in `paths` (runs of the same system and
    settings at other Eb/N0s): their points in Eb/N0 order."""
    recs = []
    for path in paths:
        with open(path) as f:
            recs.append(json.load(f))
    same = {k: v for k, v in recs[0].items() if k != "curve"}
    for rec in recs[1:]:
        other = {k: v for k, v in rec.items() if k != "curve"}
        if other != same:
            raise ValueError(f"runs differ: {same} vs {other}")
    record = {**same, "curve": sorted(
        (pt for rec in recs for pt in rec["curve"]),
        key=lambda pt: pt["ebno_db"])}
    print(json.dumps(record), flush=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return 0


def main() -> int:
    if "--merge" in sys.argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--merge", nargs="+", required=True)
        ap.add_argument("--out", required=True)
        args = ap.parse_args()
        return merge(args.merge, args.out)
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--system", required=True)
    ap.add_argument("--num-tx-eval", type=int, default=None)
    ap.add_argument("--snr", type=float, nargs="+", required=True)
    ap.add_argument("--batch-size", type=int, default=30)
    ap.add_argument("--max-iter", type=int, default=10)
    ap.add_argument("--target-block-errors", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast-ldpc", action="store_true")
    ap.add_argument("--cov-dir", default=os.path.join(ROOT, "weights"))
    ap.add_argument("--weights", default=None,
                    help="the JAX weights pickle of --system nrx")
    ap.add_argument("--mcs-idx", type=int, default=0)
    ap.add_argument("--mixed-order", type=int, nargs="+", default=None,
                    help="the MCS evaluation order of a mixed-MCS slot")
    ap.add_argument("--mixed-mask", type=int, nargs="+", default=None,
                    help="its one-hot MCS rows, user after user")
    ap.add_argument("--out", default=None,
                    help="also write the whole curve's JSON here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    from neural_rx_tpu.sim.baseline_e2e import BaselineE2EModel
    from neural_rx_tpu.sim.config import Parameters
    from neural_rx_tpu.sim.e2e import E2EModel
    from neural_rx_tpu.sim.mixed_mcs import (MixedMCSBaselineModel,
                                             MixedMCSE2EModel)
    from neural_rx_tpu.sim.simber import bler_confidence_interval, sim_ber
    from neural_rx_tpu.sim.training import load_weights

    system = "nrx" if args.system in ("nrx", "lslin") else args.system
    p = Parameters(args.config, system=system, training=False,
                   num_tx_eval=args.num_tx_eval)
    params, num_it = {}, None
    if args.system in ("nrx", "lslin"):
        if args.system == "nrx":
            params = load_weights(args.weights)
            num_it = p.num_nrx_iter_eval
        if args.mixed_order is None:
            model = E2EModel(p)
        else:
            mask = jnp.asarray(args.mixed_mask, jnp.float32).reshape(
                1, p.max_num_tx, len(args.mixed_order))
            mixed = (MixedMCSE2EModel if args.system == "nrx"
                     else MixedMCSBaselineModel)
            model = mixed(p, args.mixed_order, ue_return=0,
                          mcs_ue_mask=mask)
    else:
        model = BaselineE2EModel(p, system=args.system, cov_dir=args.cov_dir)
    curve = []
    for ebno in args.snr:
        t0 = time.perf_counter()
        _, bler, errs, blocks = sim_ber(
            model, params, [ebno], args.batch_size,
            max_mc_iter=args.max_iter,
            num_target_block_errors=args.target_block_errors,
            mcs_arr_eval_idx=args.mcs_idx, num_it=num_it, seed=args.seed,
            verbose=False, fast_ldpc=args.fast_ldpc, return_counts=True)
        point = {"ebno_db": ebno, "bler": float(bler[0]),
                 "block_errors": int(errs[0]), "blocks": int(blocks[0]),
                 "wilson95": [float(v) for v in bler_confidence_interval(
                     int(errs[0]), int(blocks[0]))],
                 "seconds": time.perf_counter() - t0}
        print(json.dumps(point), flush=True)
        curve.append(point)
    record = {"config": args.config, "system": args.system,
              "weights": args.weights and os.path.basename(args.weights),
              "mcs_idx": args.mcs_idx, "mixed_order": args.mixed_order,
              "mixed_mask": args.mixed_mask, "users": p.max_num_tx, "batch": args.batch_size,
              "max_iter": args.max_iter, "fast_ldpc": args.fast_ldpc,
              "seed": args.seed,
              "jax_devices": [str(d) for d in jax.devices()],
              "curve": curve}
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
