#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (`neural_rx_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. card: the `nvidia-smi` name and power limit;
  2. build: the CUDA kernels with plain nvcc (`kernels/_build.py`);
  3. kernel_check: the sepconv-stack kernel against its plain PyTorch
     version at the three nrx_rt stacks (N=2, 14x1584), float32 and
     bfloat16, with and without sc_valid;
  4. main_path: `entry()` at 132 PRB, batch 1, committed weights: shapes,
     finite values, exactly 3 kernel launches per slot, and the result
     against the plain-version path on the same card (bfloat16 as served,
     and the same receiver in float32);
  5. times: CUDA-event device time per stack launch (kernel and plain) and
     per slot at batch 1 and 16.
Then the `kernels` line, and last `{"ok": true, "device": {...}}`. Any
failure raises and the script exits non-zero. Without a CUDA device it exits
non-zero before printing anything.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Tolerances: max |kernel - plain| / max |plain|. float32: the pointwise
# sums run in another order (sequential FMA vs cuBLAS). bfloat16: those
# order differences flip the last bit of a rounded activation now and then.
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
SC_VALID_CASES = (None, (5, 1500))
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets): bytes/s,
    bf16 tensor FLOP/s and float32 (non-tensor) FLOP/s."""
    if "H100" in name and "PCIe" in name:
        return {"part": "H100 PCIe", "bytes_per_s": 2.0e12,
                "bf16_flops": 756e12, "f32_flops": 51e12}
    if "H100" in name and "NVL" in name:
        return {"part": "H100 NVL", "bytes_per_s": 3.9e12,
                "bf16_flops": 835e12, "f32_flops": 60e12}
    return {"part": "H100 SXM", "bytes_per_s": 3.35e12,
            "bf16_flops": 989e12, "f32_flops": 67e12}


def stack_work(widths, n, h, w, itemsize):
    """(bytes, flops) the stack must move and do: input read once, output
    written once, weights read once; per position and layer 9 depthwise
    MACs per input channel, c_in*c_out pointwise MACs and the bias."""
    flops = sum(2 * 9 * ci + 2 * ci * co + co
                for ci, co in zip(widths[:-1], widths[1:])) * n * h * w
    n_w = sum(9 * ci + ci * co + co for ci, co in zip(widths[:-1], widths[1:]))
    nbytes = (n * h * w * (widths[0] + widths[-1]) + n_w) * itemsize
    return nbytes, flops


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps, warmup=3):
    """Device time per call from CUDA events over `reps` back-to-back calls
    on the current stream, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from neural_rx_tpu_torch.entry import entry, load_params, make_receiver
    from neural_rx_tpu_torch.kernels import _build, sepconv
    from neural_rx_tpu_torch.rx.cgnn import count_params

    # the plain version is the oracle: full float32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks": peaks,
          "seconds": time.perf_counter() - t0})

    # 2. build
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_seconds": info.seconds, "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})

    # 3. kernel against plain version at the nrx_rt stack shapes
    t0 = time.perf_counter()
    params = load_params(device=dev)
    cgnn = params["cgnn"]
    assert count_params(cgnn) == 142922, count_params(cgnn)
    stacks = {"init": cgnn["s_init"][0],
              "update0": cgnn["iterations"][0]["update"],
              "update1": cgnn["iterations"][1]["update"]}
    n, h, w = 2, 14, 1584
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = []
    for sname, p in stacks.items():
        c_in = p["hidden"][0]["pw"].shape[0]
        x32 = torch.randn((n, h, w, c_in), generator=gen, device=dev)
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dtype)
            for scv in SC_VALID_CASES:
                got = sepconv.fused_conv_stack(p, x, sc_valid=scv)
                ref = sepconv.sepconv_stack_reference(p, x, sc_valid=scv)
                torch.cuda.synchronize()
                err = rel_err(got, ref)
                max_abs = float((got.float() - ref.float()).abs().max())
                ok = (got.shape == ref.shape and got.dtype == dtype
                      and bool(torch.isfinite(got).all()) and err <= tol)
                if scv is not None:
                    lo, hi = scv
                    ok = ok and not got[:, :, :lo].any() \
                        and not got[:, :, hi:].any()
                checks.append({"stack": sname, "dtype": str(dtype),
                               "sc_valid": scv, "max_abs_err": max_abs,
                               "rel_err": err, "tol": tol, "ok": ok})
                assert ok, checks[-1]
    emit({"phase": "kernel_check", "checks": checks,
          "seconds": time.perf_counter() - t0})

    # 4. main path: entry() at 132 PRB, batch 1
    t0 = time.perf_counter()
    fn, (params, y) = entry(device="cuda")
    sepconv.launches = 0
    llr, h_hat = fn(params, y)
    torch.cuda.synchronize()
    launches = sepconv.launches
    assert launches == 3, launches
    assert llr.shape == (1, 2, 14, 1584, 4), llr.shape
    assert h_hat.shape == (1, 2, 14, 1584, 8), h_hat.shape
    assert bool(torch.isfinite(llr).all() and torch.isfinite(h_hat).all())
    rx_plain = make_receiver(fused_convs=False, device=dev)
    llr_p, h_p = rx_plain.serve(params, y)
    e2e = {"bf16": {"llr": rel_err(llr, llr_p), "h_hat": rel_err(h_hat, h_p)}}
    params32 = load_params(dtype=torch.float32, device=dev)
    rx32 = make_receiver(nrx_dtype=torch.float32, device=dev)
    rx32_plain = make_receiver(nrx_dtype=torch.float32, fused_convs=False,
                               device=dev)
    l32, h32 = rx32.serve(params32, y)
    l32p, h32p = rx32_plain.serve(params32, y)
    torch.cuda.synchronize()
    e2e["f32"] = {"llr": rel_err(l32, l32p), "h_hat": rel_err(h32, h32p)}
    emit({"phase": "main_path", "launches_per_slot": launches,
          "llr_shape": list(llr.shape), "h_hat_shape": list(h_hat.shape),
          "rel_err_vs_plain": e2e, "tol": {"bf16": TOL_BF16, "f32": TOL_F32},
          "seconds": time.perf_counter() - t0})
    assert e2e["f32"]["llr"] <= TOL_F32 and e2e["f32"]["h_hat"] <= TOL_F32
    assert e2e["bf16"]["llr"] <= TOL_BF16 and e2e["bf16"]["h_hat"] <= TOL_BF16

    # 5. times (bf16, as served)
    t0 = time.perf_counter()
    per_stack = []
    for sname, p in stacks.items():
        c_in = p["hidden"][0]["pw"].shape[0]
        x = torch.randn((n, h, w, c_in), generator=gen,
                        device=dev).to(torch.bfloat16)
        widths = [c_in] + [lp["pw"].shape[1] for lp in p["hidden"]] \
            + [p["out"]["pw"].shape[1]]
        nbytes, flops = stack_work(widths, n, h, w, 2)
        t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
        t_ops = flops / peaks["bf16_flops"] * 1e3
        kernel_ms = cuda_ms(lambda: sepconv.fused_conv_stack(p, x), reps=50)
        plain_ms = cuda_ms(
            lambda: sepconv.sepconv_stack_reference(p, x), reps=10)
        per_stack.append({"stack": sname, "widths": widths, "shape":
                          [n, h, w], "kernel_ms": kernel_ms,
                          "plain_ms": plain_ms, "bytes": nbytes,
                          "flops": flops, "bytes_ms": t_bytes,
                          "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
                          "bound_by": "bytes" if t_bytes >= t_ops
                          else "operations"})
    slot_ms = cuda_ms(lambda: fn(params, y), reps=20)
    host_ms = []
    for _ in range(20):
        t1 = time.perf_counter()
        fn(params, y)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t1) * 1e3)
    y16 = torch.as_tensor(np.random.default_rng(1).normal(
        size=(16,) + tuple(y.shape[1:])), dtype=torch.float32, device=dev)
    b16_ms = cuda_ms(lambda: fn(params, y16), reps=5)
    emit({"phase": "times", "card": card, "per_stack": per_stack,
          "slot_ms": slot_ms, "slot_host_ms_median": float(np.median(host_ms)),
          "batch16_call_ms": b16_ms, "slots_per_s": 16 / (b16_ms / 1e3),
          "seconds": time.perf_counter() - t0})

    kernel_ms = sum(s["kernel_ms"] for s in per_stack)
    plain_ms = sum(s["plain_ms"] for s in per_stack)
    bound_ms = sum(s["bound_ms"] for s in per_stack)
    bf16_checks = [c for c in checks if c["dtype"] == str(torch.bfloat16)]
    emit({"kernels": [{
        "name": "sepconv_stack", "route": "cuda",
        "source": "neural_rx_tpu_torch/csrc/sepconv_stack.cu",
        "replaces": "neural_rx_tpu/kernels/sepconv_pallas.py:362",
        "replaces_k": "K1/K2 (fused_conv_stack :243, "
                      "fused_conv_stack_blocked :362)",
        "launches": launches, "launches_per_slot": launches,
        "max_abs_err": max(c["max_abs_err"] for c in bf16_checks),
        "tol": TOL_BF16, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if sum(s["bytes_ms"] for s in per_stack)
        >= sum(s["ops_ms"] for s in per_stack) else "operations",
        "library_ms": None,
        "note": "ms/plain_ms/bound_ms: sum over the 3 launches of one "
                "slot (init, update0, update1), bf16, N=2, 14x1584"}]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
