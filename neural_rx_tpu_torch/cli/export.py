"""Deployment export: the Aerial-ABI engine per PRB bucket, its latency and
its engine file (the reference's `scripts/export_onnx.py`, the JAX
package's `cli/export.py`).

    python -m neural_rx_tpu_torch.cli.export --config nrx_rt \
        [--buckets 4 132] [--batch 1] [--out deploy_out] \
        [--weights-dir weights] [--device cuda|cpu]

Builds `entry.deploy_entry`'s receiver (bfloat16; the stack kernel on the
init stack and the iteration kernel on every iteration, unless the JAX
package's overrides NRX_FUSED_CONVS / NRX_FUSED_ITER say otherwise) with
the committed weights of --weights-dir (`weights.committed_weights`), or
seed-made ones where there are none. On the card each bucket is served
from its CUDA graph; on the CPU (--device cpu) eagerly, through the
kernels' plain versions. Per bucket it measures `deploy.aot.
measure_latency` on seeded inputs and writes the engine file
{label}_{n}prb.nrxengine (`deploy.aot.save_engine`); then
{config}_manifest.json with every bucket's numbers into --out.
"""

from __future__ import annotations

import argparse
import json
import os


def _flag(name: str) -> bool:
    """The JAX export's route override: unset or "1" means on."""
    return os.environ[name] == "1" if name in os.environ else True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--buckets", type=int, nargs="*", default=[4, 132])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", default="deploy_out")
    ap.add_argument("--weights-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from .. import weights
    from ..deploy.aot import measure_latency, save_engine
    from ..entry import deploy_entry
    from ..rx.neural_rx import resolve_device
    from ..sim.config import Parameters

    device = resolve_device(args.device)
    graphs = device.type == "cuda"
    rx, examples = deploy_entry(
        args.config, buckets=args.buckets, batch=args.batch,
        dtype=torch.bfloat16, graphs=graphs, device=device,
        fused_convs=_flag("NRX_FUSED_CONVS"),
        fused_iteration=_flag("NRX_FUSED_ITER"),
        weights_dir=args.weights_dir or weights.WEIGHTS_DIR)
    label = Parameters(args.config, system="dummy").label
    os.makedirs(args.out, exist_ok=True)
    manifest = {"config": args.config, "batch": args.batch,
                "device": (torch.cuda.get_device_name(device)
                           if graphs else "cpu"),
                "mode": "graph" if graphs else "eager", "buckets": {}}
    for n in rx.buckets:
        stats = measure_latency(lambda *a, n=n: rx.run(n, *a), examples[n],
                                iters=100 if graphs else 3,
                                batch=args.batch)
        path = os.path.join(args.out, f"{label}_{n}prb.nrxengine")
        stats["engine_file"] = os.path.basename(path)
        stats["engine_bytes"] = save_engine(path, rx.engines[n], rx.params)
        stats["capture_s"] = rx.capture_seconds.get((n, 12 * n))
        manifest["buckets"][n] = stats
        print(f"bucket {n} PRB: {json.dumps(stats)}", flush=True)
    with open(os.path.join(args.out, f"{args.config}_manifest.json"),
              "w") as f:
        json.dump(manifest, f, indent=2)
    print("manifest written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
