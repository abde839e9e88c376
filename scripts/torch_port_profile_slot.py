"""Where the time of one nrx_rt slot goes in the PyTorch port, on the GPU.

Runs `neural_rx_tpu_torch.entry.entry()` (132 PRB, bf16, committed
weights; the batch-adaptive route, or with --mega the whole-CGNN kernel),
or with --eval the eval path `entry.eval_entry()` (132 PRB, float32, its
example slot at 10 dB; the layered LDPC kernel, or with --flooding the
flooding decoder), or with --mc one Monte-Carlo step `entry.mc_entry()`
(132 PRB, float32, DoubleTDLlow, 3 dB; --flooding as for --eval), or with
--baseline SYSTEM one Monte-Carlo step of a classical baseline
`entry.baseline_entry()` (--config, default nrx_rt, with --num-tx-eval
users at --ebno dB, default 4; its covariances computed on the card into a
temporary directory; --flooding as for --eval), under
`torch.profiler` for a few calls after a warm-up and prints one JSON line:
device time per kernel name (summed over the window, per call), the
device-busy share of the window, the host time per call and the memory
copies per call by kind (pageable host-to-device among them). With
--trace, the Chrome trace is written to that path. --conv-mxu and
--stencil-lp set the layer-mode knobs NRX_CONV_MXU=1 and NRX_STENCIL_LP=1
for the run, which the kernels' wrappers read at each call and route as
the JAX package does (with conv_mxu the batch > 4 route's iterations take
the stack kernel, not the iteration kernel).

    python3 scripts/torch_port_profile_slot.py [--batch 1] [--slots 10] \
        [--mega | --eval [--flooding] | --mc [--flooding] \
         | --baseline SYSTEM [--config nrx_rt] [--num-tx-eval T] \
           [--ebno 4] [--flooding]] [--conv-mxu] [--stencil-lp] \
        [--trace slot_trace.json]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--slots", type=int, default=10)
    ap.add_argument("--mega", action="store_true")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--mc", action="store_true")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--config", default="nrx_rt")
    ap.add_argument("--num-tx-eval", type=int, default=None)
    ap.add_argument("--ebno", type=float, default=4.0)
    ap.add_argument("--flooding", action="store_true")
    ap.add_argument("--trace", default=None)
    ap.add_argument("--conv-mxu", action="store_true")
    ap.add_argument("--stencil-lp", action="store_true")
    args = ap.parse_args()
    for flag, knob in ((args.conv_mxu, "NRX_CONV_MXU"),
                       (args.stencil_lp, "NRX_STENCIL_LP")):
        os.environ[knob] = "1" if flag else "0"
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from neural_rx_tpu_torch import entry as entries

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.baseline:
        with tempfile.TemporaryDirectory() as cov_dir:
            fn, fn_args = entries.baseline_entry(
                args.baseline, config=args.config, device="cuda",
                batch=args.batch, ebno_db=args.ebno,
                num_tx_eval=args.num_tx_eval, fast_ldpc=not args.flooding,
                cov_dir=cov_dir)
    elif args.mc:
        fn, fn_args = entries.mc_entry(device="cuda", batch=args.batch,
                                       fast_ldpc=not args.flooding)
    elif args.eval:
        fn, fn_args = entries.eval_entry(device="cuda", batch=args.batch,
                                         fast_ldpc=not args.flooding)
    else:
        fn, fn_args = entries.entry(device="cuda", batch=args.batch,
                                    mega=args.mega)
    for _ in range(5):
        fn(*fn_args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.slots):
            fn(*fn_args)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(ev.name, [0.0, 0])
            kernels[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            kernels[ev.name][1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    copies = {k: v[1] / args.slots for k, v in kernels.items()
              if "Memcpy" in k}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": card, "batch": args.batch, "mega": args.mega,
        "eval": args.eval, "mc": args.mc, "baseline": args.baseline,
        "config": args.config if args.baseline else "nrx_rt",
        "flooding": args.flooding,
        "conv_mxu": args.conv_mxu, "stencil_lp": args.stencil_lp,
        "slots": args.slots,
        "window_ms_per_slot": window_ms / args.slots,
        "device_busy_ms_per_slot": busy_ms / args.slots,
        "device_busy_share": busy_ms / window_ms,
        "kernels_per_slot": sum(v[1] for v in kernels.values()) / args.slots,
        "copies_per_slot": copies,
        "top": [{"name": k[:90], "ms_per_slot": v[0] / args.slots,
                 "calls_per_slot": v[1] / args.slots} for k, v in top[:25]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
