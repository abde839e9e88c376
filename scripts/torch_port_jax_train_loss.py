"""The JAX package's training data loss of a configuration, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_port_jax_train_loss.py \
        [--config nrx_rt] [--phase 1] [--batch 128] [--batches 16] \
        [--weights weights/nrx_rt_ema_weights.pkl] [--seed 0]

Draws `batches` training batches as `neural_rx_tpu/sim/training.py`'s step
samples them (triangular user count, MCS, Eb/N0 in the phase's range of the
user count, active ports) and prints one JSON line with the mean loss_data
of the forward (no update; with the phase's `apply_multiloss`, as the step
computes it: the sum over every iteration's readout) and its standard
error, for the given weights (a JAX pickle) and for the JAX package's
seed-made init (PRNGKey(seed)). `chip_smoke.py` holds the port's warm
starts on the card to the first (`JAX_WARM_LOSS`: nrx_rt; and
`JAX_LARGE_WARM_LOSS`: `--config nrx_large --weights
weights/nrx_large_weights.pkl`).
"""

import argparse
import json
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="nrx_rt")
    ap.add_argument("--phase", type=int, default=1)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--weights", default="weights/nrx_rt_ema_weights.pkl")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

    import jax
    import jax.numpy as jnp
    from neural_rx_tpu.sim.config import Parameters
    from neural_rx_tpu.sim.e2e import E2EModel, sample_active_dmrs
    from neural_rx_tpu.sim.training import (load_weights,
                                            sample_mcs_assignment,
                                            triangular_sample)

    p = Parameters(args.config, system="nrx", training=True)
    model = E2EModel(p, training=True)
    sched = p.training_schedule
    lo = jnp.asarray(sched["min_training_snr_db"][args.phase], jnp.float32)
    hi = jnp.asarray(sched["max_training_snr_db"][args.phase], jnp.float32)
    multiloss = bool(sched["apply_multiloss"][args.phase])
    num_mcs = len(p.mcs_index)
    b = args.batch

    @jax.jit
    def loss_data(params, key):
        keys = jax.random.split(key, 5)
        num_tx = triangular_sample(keys[0], p.min_num_tx, p.max_num_tx)
        _, mm = sample_mcs_assignment(
            keys[1], b, p.max_num_tx, list(range(num_mcs)), num_mcs,
            num_tx=num_tx, min_num_tx=p.min_num_tx,
            mcs_training_probs=getattr(p, "mcs_training_probs", None))
        snr = jax.random.uniform(keys[2], (b,),
                                 minval=lo[num_tx - p.min_num_tx],
                                 maxval=hi[num_tx - p.min_num_tx])
        act = sample_active_dmrs(keys[3], b, num_tx, p.max_num_tx)
        return model(params, keys[4], b, snr, num_tx=num_tx,
                     active_dmrs=act, mcs_ue_mask=mm,
                     apply_multiloss=multiloss)[0]

    out = {"config": args.config, "phase": args.phase, "batch": b,
           "apply_multiloss": multiloss,
           "batches": args.batches, "device": str(jax.devices()[0])}
    for name, params in (
            ("weights", load_weights(args.weights)),
            ("init", model.init_params(jax.random.PRNGKey(args.seed)))):
        vals = np.asarray([float(loss_data(params, jax.random.PRNGKey(i)))
                           for i in range(args.batches)])
        out[name] = {"loss_data_mean": float(vals.mean()),
                     "loss_data_se": float(vals.std(ddof=1)
                                           / np.sqrt(len(vals)))}
    out["weights_file"] = args.weights
    print(json.dumps(out))


if __name__ == "__main__":
    main()
