"""Normalised MSE of the baselines' channel estimates in the PyTorch port.

For each configuration (in eval mode, 132 PRB) and Eb/N0, draws one
Monte-Carlo batch (`BaselineE2EModel.draw`, seeded generator), transmits it
and prints sum |h_hat - h|^2 / sum |h|^2 of the LS/lin, LS/nn and LMMSE
estimates against the true effective channel, one JSON line per point.
The LMMSE estimate's covariances are computed into a temporary directory.

    python scripts/torch_port_chest_nmse.py [--device cpu|cuda] \
        [--batch 2] [--snr 1 5 10] [--seed 1]
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("e2e_baseline", 1), ("nrx_rt", None))
ESTIMATES = {"lslin": "baseline_lslin_lmmse", "lsnn": "baseline_lsnn_lmmse",
             "lmmse": "baseline_lmmse_lmmse"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--snr", type=float, nargs="+", default=[1.0, 5.0,
                                                             10.0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.sim.baseline_e2e import BaselineE2EModel
    from neural_rx_tpu_torch.sim.config import Parameters

    with tempfile.TemporaryDirectory() as cov_dir:
        for label, users in CASES:
            p = Parameters(label, training=False, num_tx_eval=users)
            truth = BaselineE2EModel(p, "baseline_perf_csi_lmmse",
                                     device=args.device)
            models = {name: BaselineE2EModel(p, system, cov_dir=cov_dir,
                                             device=args.device)
                      for name, system in ESTIMATES.items()}
            for ebno in args.snr:
                gen = torch.Generator(device=args.device).manual_seed(
                    args.seed)
                (bits,), h, noise = truth.draw(gen, args.batch, ebno)
                no = p.noise_variance(ebno)
                y = apply_ofdm_channel(truth.transmitter(bits), h, None,
                                       noise=noise)
                h_true = truth.estimate(y, h, no)
                power = float((h_true.abs() ** 2).sum())
                print(json.dumps({
                    "config": label, "users": p.max_num_tx,
                    "ebno_db": ebno, "no": no, "batch": args.batch,
                    "device": str(args.device),
                    "nmse": {name: float((m.estimate(y, h, no) - h_true)
                                         .abs().pow(2).sum()) / power
                             for name, m in models.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
