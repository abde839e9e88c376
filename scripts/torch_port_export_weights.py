"""Convert a pickled JAX CGNN weight tree into the `.npz` the PyTorch port
reads (`neural_rx_tpu_torch/weights.py`).

The pickles under `weights/` hold a JAX `PyTreeDef`, so this runs where the
JAX package is importable. Each leaf of the CGNN tree is written as a
float32 array named by its tree path, e.g. `s_init.0.hidden.1.pw`.

    python scripts/torch_port_export_weights.py \
        [weights/nrx_rt_ema_weights.pkl] [weights/nrx_rt_ema_weights.npz]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from neural_rx_tpu.sim.training import load_weights  # noqa: E402
from neural_rx_tpu_torch.weights import flatten  # noqa: E402


def main(src="weights/nrx_rt_ema_weights.pkl",
         dst="weights/nrx_rt_ema_weights.npz"):
    cgnn = load_weights(src)["cgnn"]
    leaves = {k: np.asarray(v, np.float32) for k, v in flatten(cgnn).items()}
    np.savez(dst, **leaves)
    n = sum(v.size for v in leaves.values())
    print(f"{dst}: {len(leaves)} leaves, {n} values")


if __name__ == "__main__":
    main(*sys.argv[1:])
