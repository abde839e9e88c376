"""Convert a pickled JAX weight tree into the `.npz` the PyTorch port reads
(`neural_rx_tpu_torch/weights.py`).

The pickles under `weights/` hold a JAX `PyTreeDef`, so this runs where the
JAX package is importable. Each leaf of the CGNN tree is written as a
float32 array named by its tree path, e.g. `s_init.0.hidden.1.pw`, and a
trainable constellation's (re, im) point arrays as `constellation.0`, ...
A tree whose `.npz` would reach 1,000,000 B is written as parts,
`{stem}.part0.npz`, ... (`weights.write_npz`).

    python scripts/torch_port_export_weights.py \
        [weights/nrx_rt_ema_weights.pkl] [weights/nrx_rt_ema_weights.npz]

The committed files and their sources:
    nrx_rt{,_qpsk,_64qam}_ema_weights.npz   <- the same name, .pkl
    nrx_rt_var_mcs_weights.npz             <- nrx_rt_var_mcs_weights.pkl
    nrx_site_specific_100k_weights.npz     <- the same name, .pkl
    nrx_large_weights.part*.npz            <- nrx_large_weights.pkl
    e2e_rt_ema_weights.part*.npz           <- e2e_rt_ema.pkl
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from neural_rx_tpu.sim.training import load_weights  # noqa: E402
from neural_rx_tpu_torch.weights import flatten, write_npz  # noqa: E402


def main(src="weights/nrx_rt_ema_weights.pkl",
         dst="weights/nrx_rt_ema_weights.npz"):
    tree = load_weights(src)
    leaves = flatten(tree["cgnn"])
    if "constellation" in tree:
        leaves.update(flatten({"constellation": tree["constellation"]}))
    leaves = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    n = sum(v.size for v in leaves.values())
    for path in write_npz(dst, leaves):
        print(f"{path}: {os.path.getsize(path)} B")
    print(f"{dst}: {len(leaves)} leaves, {n} values")


if __name__ == "__main__":
    main(*sys.argv[1:])
