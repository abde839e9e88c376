"""BLER evaluation of the neural receiver or a classical baseline (Monte
Carlo).

    python -m neural_rx_tpu_torch.cli.evaluate --config nrx_rt \
        [--system nrx|baseline_lslin_lmmse|baseline_lsnn_lmmse|
                  baseline_lmmse_lmmse|baseline_lmmse_kbest|
                  baseline_perf_csi_lmmse|baseline_perf_csi_kbest] \
        [--snr 2 3 4] [--max-iter N] [--batch-size B] [--num-tx-eval T] \
        [--mcs-idx 0] [--fast-ldpc] [--target-block-errors K] \
        [--target-bler X] [--weights PATH | --weights-dir DIR | --untrained] \
        [--results-dir DIR] [--data-dir DIR] [--device cuda|cpu]

Sweeps Eb/N0 over the configuration's [evaluation] grid unless --snr is
given, with `sim.simber.sim_ber` on `sim.e2e.E2EModel` (system nrx) or
`sim.baseline_e2e.BaselineE2EModel` over the configuration's eval channel,
and merges (Eb/N0, BER, BLER) into DIR/{label}_results.pkl keyed
(name, num_tx, mcs_idx), the JAX package's format: name is "Neural
Receiver" for nrx and the system name for a baseline. --mcs-idx picks
the evaluated MCS of a configuration with several (every user on it); an
index out of range raises ValueError. The neural receiver runs the
configuration's num_nrx_iter_eval iterations; its weights default to the
committed weights (`weights.committed_weights`, looked up in --weights-dir,
default the repository's weights/); a missing file is an error; a
--weights file not ending in `.npz` is read as a reference weight file
(`compat/reference_weights.py`). --untrained evaluates the seed-0 init
(`E2EModel.init_params` from a generator seeded 0 on the device, as the
JAX package's PRNGKey(0): a plumbing check) and reads no weights.
A baseline with the LMMSE channel estimate reads the covariances
weights/{label}_{freq,time,space}_cov_mat.npy, and computes and writes them
there if they are missing. The site-specific configurations read their
CIR dataset from --data-dir (default: the repository's data/; `python -m
neural_rx_tpu_torch.sim.trajectory --out DIR` writes it). The device
defaults to cuda, which needs a GPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from ..sim.baseline_e2e import SYSTEMS

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--system", default="nrx")
    ap.add_argument("--snr", type=float, nargs="*", default=None)
    ap.add_argument("--max-iter", type=int, default=100,
                    help="max Monte-Carlo steps per SNR point")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--num-tx-eval", type=int, default=None)
    ap.add_argument("--mcs-idx", type=int, default=0)
    ap.add_argument("--target-block-errors", type=int, default=200)
    ap.add_argument("--target-bler", type=float, default=None)
    ap.add_argument("--fast-ldpc", action="store_true",
                    help="layered min-sum decoder (the LDPC kernel)")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--weights-dir", default=None,
                    help="where the committed weights are looked up")
    ap.add_argument("--untrained", action="store_true",
                    help="evaluate the seed-0 init (plumbing checks)")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.system != "nrx" and args.system not in SYSTEMS:
        raise ValueError(f"unknown system {args.system!r}: nrx or one of "
                         f"{', '.join(SYSTEMS)}")

    import torch

    from .. import weights
    from ..entry import load_params, pack_params
    from ..rx.neural_rx import resolve_device
    from ..sim.baseline_e2e import BaselineE2EModel
    from ..sim.config import Parameters
    from ..sim.e2e import E2EModel
    from ..sim.simber import save_results, sim_ber

    device = resolve_device(args.device)
    p = Parameters(args.config, system=args.system, training=False,
                   num_tx_eval=args.num_tx_eval, data_dir=args.data_dir)
    if not 0 <= args.mcs_idx < len(p.mcs_index):
        raise ValueError(f"MCS index {args.mcs_idx} out of range: "
                         f"{args.config} has {len(p.mcs_index)} MCS")
    if args.snr:
        ebno_dbs = np.asarray(args.snr, np.float32)
    else:
        ebno_dbs = np.arange(p.snr_db_eval_min, p.snr_db_eval_max,
                             p.snr_db_eval_stepsize, dtype=np.float32)
    if args.system == "nrx":
        model = E2EModel(p, device=device)
        seed_made = model.init_params(
            torch.Generator(device=device).manual_seed(0))
        if args.untrained:
            params = pack_params(seed_made, p.nrx_dtype)
        else:
            wpath = args.weights or weights.committed_weights(
                p.label, args.weights_dir or weights.WEIGHTS_DIR)
            if not weights.exists(wpath):
                raise FileNotFoundError(
                    f"no weights at {wpath}: convert them with "
                    "scripts/torch_port_export_weights.py, or pass "
                    "--untrained")
            params = load_params(
                dtype=p.nrx_dtype, device=device, path=wpath,
                template=None if wpath.endswith(".npz") else seed_made)
        name, num_it = "Neural Receiver", p.num_nrx_iter_eval
    else:
        model = BaselineE2EModel(p, args.system, device=device)
        params, name, num_it = {}, args.system, None
    ber, bler = sim_ber(
        model, params, ebno_dbs, batch_size=args.batch_size
        or p.batch_size_eval, max_mc_iter=args.max_iter,
        num_target_block_errors=args.target_block_errors,
        target_bler=args.target_bler, num_it=num_it,
        fast_ldpc=args.fast_ldpc, mcs_arr_eval_idx=args.mcs_idx)
    path = os.path.join(args.results_dir, f"{p.label}_results.pkl")
    save_results(path, p.label, name, p.max_num_tx, args.mcs_idx,
                 ebno_dbs, ber, bler)
    print(f"saved {path}")


if __name__ == "__main__":
    main()
