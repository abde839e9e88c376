"""Copy committed BLER curves of the JAX package into the JSON files the
PyTorch port's `chip_smoke.py` reads (`results/` is not part of the copy of
the repository that runs on the GPU machine).

    python scripts/torch_port_export_curves.py [CURVES_DIR]

writes CURVES_DIR/nrx_rt_var_mcs.json, nrx_site_specific_100k.json,
nrx_large.json and e2e_rt.json (default: neural_rx_tpu_torch/curves/).
Reads, with numpy and pickle alone:
- results/nrx_rt_var_mcs_results.pkl: the own-trained weights' curves
  ("own"; reproduced by weights/nrx_rt_var_mcs_weights.pkl, ROADMAP.md C4),
  key ('Neural Receiver', 2, mcs);
- results/nrx_rt_var_mcs_ref_results.pkl: the imported reference weights'
  curves ("ref"; those weights are not in the repository);
- results/mixed_mcs_results.pkl: the mixed-MCS curves of user 0 ("mixed":
  [ebno, same-MCS dict, mixed-MCS dict], keys (system name, MCS of user
  0)), made with the imported weights;
- results/nrx_site_specific_100k_results.pkl: the site-specific fine-tuned
  receiver's curve on the eval trajectory ("curve"; reproduced by
  weights/nrx_site_specific_100k_weights.pkl, ROADMAP.md C7), key
  ('Neural Receiver', 2, 0);
- results/nrx_large_results.pkl: nrx_large's curve ("curve"), key
  ('Neural Receiver', 2, 0), made with imported reference weights that are
  not in the repository (ROADMAP.md R10: `chip_smoke.py` records it beside
  the points of weights/nrx_large_weights.pkl and holds those to the JAX
  CPU sweep curves/jax_nrx_large.json);
- results/e2e_rt_results.pkl: e2e_rt's curve ("curve"), key ('Neural
  Receiver', 1, 0), re-measured with its EMA weights (results/README.md),
  weights/e2e_rt_ema.pkl.
Each curve is written as {"ebno_db": [...], "bler": [...]} with the points
the run did not reach (NaN) dropped.
"""

import json
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEMS = {"Neural Receiver": "nrx", "Baseline - LS/lin+LMMSE": "lslin"}


def _curve(ebno, bler) -> dict:
    ebno, bler = np.asarray(ebno, float), np.asarray(bler, float)
    keep = np.isfinite(bler)
    return {"ebno_db": ebno[keep].tolist(), "bler": bler[keep].tolist()}


def _per_mcs(name: str, users: int = 2) -> dict:
    with open(os.path.join(ROOT, "results", name), "rb") as f:
        ebno, _, bler = pickle.load(f)
    return {str(key[2]): _curve(ebno, v) for key, v in sorted(bler.items())
            if key[0] == "Neural Receiver" and key[1] == users}


def _write(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(path)


def main(curves_dir=os.path.join(ROOT, "neural_rx_tpu_torch",
                                 "curves")) -> int:
    with open(os.path.join(ROOT, "results", "mixed_mcs_results.pkl"),
              "rb") as f:
        ebno, _, mixed = pickle.load(f)
    _write(os.path.join(curves_dir, "nrx_rt_var_mcs.json"), {
        "config": "nrx_rt_var_mcs", "users": 2,
        "own": _per_mcs("nrx_rt_var_mcs_results.pkl"),
        "ref": _per_mcs("nrx_rt_var_mcs_ref_results.pkl"),
        "mixed": {SYSTEMS[name] + "_ue0_mcs" + str(mcs): _curve(ebno, v)
                  for (name, mcs), v in sorted(mixed.items())}})
    _write(os.path.join(curves_dir, "nrx_site_specific_100k.json"), {
        "config": "nrx_site_specific_100k", "users": 2,
        "weights": "nrx_site_specific_100k_weights.pkl",
        "curve": _per_mcs("nrx_site_specific_100k_results.pkl")["0"]})
    for label, users, made_with in (
            ("nrx_large", 2, "imported reference weights, not in the "
             "repository (results/README.md)"),
            ("e2e_rt", 1, "e2e_rt_ema.pkl")):
        _write(os.path.join(curves_dir, f"{label}.json"), {
            "config": label, "users": users, "weights": made_with,
            "curve": _per_mcs(f"{label}_results.pkl", users)["0"]})
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
