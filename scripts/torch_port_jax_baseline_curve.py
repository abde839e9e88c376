"""BLER of one classical baseline as the JAX package computes it today, on
the CPU: the reference the PyTorch port's `chip_smoke.py` holds a baseline
to where the committed curve under `results/` disagrees with the JAX
package's own code.

Runs `neural_rx_tpu.sim.simber.sim_ber` on the JAX package's
`BaselineE2EModel` (eval mode, the configuration's eval channel and width,
the flooding decoder unless --fast-ldpc, covariances from --cov-dir) and
prints one JSON line per Eb/N0 point (BLER, block errors, blocks, Wilson
95 % interval, seconds) and a last line with the whole curve, which --out
also writes to a file. The curve `chip_smoke.py` reads,
`neural_rx_tpu_torch/curves/jax_e2e_baseline_baseline_lmmse_kbest.json`,
was written by

    JAX_PLATFORMS=cpu python scripts/torch_port_jax_baseline_curve.py \
        --config e2e_baseline --system baseline_lmmse_kbest \
        --num-tx-eval 1 --snr 0 1 2 3 4 --batch-size 30 --max-iter 30 \
        --target-block-errors 100000 \
        --out neural_rx_tpu_torch/curves/jax_e2e_baseline_baseline_lmmse_kbest.json

(900 blocks a point; options: [--seed 0] [--cov-dir weights]
[--fast-ldpc]).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
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
    ap.add_argument("--out", default=None,
                    help="also write the whole curve's JSON here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax
    from neural_rx_tpu.sim.baseline_e2e import BaselineE2EModel
    from neural_rx_tpu.sim.config import Parameters
    from neural_rx_tpu.sim.simber import bler_confidence_interval, sim_ber

    p = Parameters(args.config, system=args.system, training=False,
                   num_tx_eval=args.num_tx_eval)
    model = BaselineE2EModel(p, system=args.system, cov_dir=args.cov_dir)
    curve = []
    for ebno in args.snr:
        t0 = time.perf_counter()
        _, bler, errs, blocks = sim_ber(
            model, {}, [ebno], args.batch_size, max_mc_iter=args.max_iter,
            num_target_block_errors=args.target_block_errors,
            seed=args.seed, verbose=False, fast_ldpc=args.fast_ldpc,
            return_counts=True)
        point = {"ebno_db": ebno, "bler": float(bler[0]),
                 "block_errors": int(errs[0]), "blocks": int(blocks[0]),
                 "wilson95": [float(v) for v in bler_confidence_interval(
                     int(errs[0]), int(blocks[0]))],
                 "seconds": time.perf_counter() - t0}
        print(json.dumps(point), flush=True)
        curve.append(point)
    record = {"config": args.config, "system": args.system,
              "users": p.max_num_tx, "batch": args.batch_size,
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
