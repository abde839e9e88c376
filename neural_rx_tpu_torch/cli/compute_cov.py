"""Channel covariances for the LMMSE baseline, measured on the training
channel at the evaluation width (the JAX package's `cli/compute_cov.py`).

    python -m neural_rx_tpu_torch.cli.compute_cov --config nrx_rt \
        [--batches 8] [--batch-size 16] [--out-dir weights] \
        [--device cuda|cpu]

Draws `batches` batches of CFRs of the configuration's training channel
(UMi for most) on the eval grid from a generator seeded with
`sim.covariance.COV_SEED` and writes OUT/{label}_{freq,time,space}_cov_mat.npy
(complex64). The device defaults to cuda, which needs a GPU.
"""

from __future__ import annotations

import argparse
import os


def compute(config: str, device, num_batches: int = 8,
            batch_size: int = 16):
    """(cov_freq, cov_time, cov_space) complex64 numpy of `config`'s
    training channel on its eval grid, drawn on `device`."""
    import torch

    from ..sim import covariance
    from ..sim.config import Parameters

    p = Parameters(config, training=False)
    p_train = Parameters(config, training=True)
    p.channel_model = p_train.channel_model
    p.channel_type_name = p_train.channel_type_name
    gen = torch.Generator(device=device).manual_seed(covariance.COV_SEED)
    return p.label, covariance.compute_cov_matrices(
        p, gen, num_batches=num_batches, batch_size=batch_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--out-dir", default="weights")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np

    from ..rx.neural_rx import resolve_device

    label, covs = compute(args.config, resolve_device(args.device),
                          args.batches, args.batch_size)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, c in zip(("freq", "time", "space"), covs):
        path = os.path.join(args.out_dir, f"{label}_{name}_cov_mat.npy")
        np.save(path, c)
        print(f"saved {path} {c.shape}")


if __name__ == "__main__":
    main()
