"""How far bfloat16 results of the CGNN kernels move when only the order of
their float32 sums changes, on the GPU.

Holds the fused iteration (state and readout mode) and the whole-CGNN
kernel, in bfloat16 at nrx_rt's widths (b = 1, T = 2, 14x1584, committed
weights, inputs from numpy's default_rng(seed)), against their plain
PyTorch versions on the GPU (cuBLAS sums) and on the CPU (the CPU BLAS's
order), and the two plain versions against each other. Each pair gets the
error `chip_smoke.py` holds to TOL_BF16 (max |a - b| / max |b|), the share
of elements that differ and where in the column tile the largest
differences sit. Then the plain whole CGNN against itself with one bf16 ulp
added to 0.1 % of its inputs. Prints one JSON line per case, then the card.

    python3 scripts/torch_port_bf16_spread.py [--seed 0]
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TX, N_SYM, N_SC = 2, 14, 1584


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from neural_rx_tpu_torch.entry import load_params, make_receiver
    from neural_rx_tpu_torch.kernels import cgnn_iter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf = torch.bfloat16
    dev = torch.device("cuda")
    cg = {"cuda": load_params(device=dev)["cgnn"],
          "cpu": load_params(device="cpu")["cgnn"]}
    pe32 = make_receiver(device="cpu").pe
    rng = np.random.default_rng(args.seed)
    s32 = torch.as_tensor(4.0 * rng.standard_normal(
        (1, N_TX, N_SYM, N_SC, 56)), dtype=torch.float32)
    z32 = torch.as_tensor(rng.standard_normal((1, N_TX, N_SYM, N_SC, 18)),
                          dtype=torch.float32)

    def cases(where):
        c = cg[where]
        s, z, pe = s32.to(where, bf), z32.to(where, bf), pe32.to(where, bf)
        ro = (c["readout_llrs"][0], c["readout_chest"])
        return {
            "iter_state": lambda f, act: f["it"](c["iterations"][0], s, pe,
                                                 act),
            "iter_readout": lambda f, act: f["it"](c["iterations"][1], s, pe,
                                                   act, None, *ro),
            "full": lambda f, act: f["full"](c, z, pe, act)}

    kernel = {"it": cgnn_iter.fused_iteration,
              "full": cgnn_iter.fused_cgnn_full}
    plain = {"it": cgnn_iter.fused_iteration_reference,
             "full": cgnn_iter.fused_cgnn_full_reference}

    def tup(x):
        return tuple(t.cpu() for t in (x if isinstance(x, tuple) else (x,)))

    def pair(a, b):
        share, ulps = chip_smoke.differences(a, b)
        d = torch.cat([(x.float() - y.float()).abs().flatten()
                       for x, y in zip(a, b)])
        shape = a[0].shape
        top = []
        if d.numel() and float(d.max()) > 0:
            # largest differences of the first output: column mod 24 (the
            # tensor-core tile width) and channel
            d0 = (a[0].float() - b[0].float()).abs()
            idx = torch.topk(d0.flatten(), 5).indices
            for i in idx.tolist():
                coords = np.unravel_index(i, tuple(shape))
                top.append({"h": int(coords[2]), "w": int(coords[3]),
                            "w_mod_24": int(coords[3]) % 24,
                            "c": int(coords[4]), "diff": float(d0.flatten()[i])})
        return {"rel_err": max(chip_smoke.rel_err(x, y) for x, y in zip(a, b)),
                "differing_share": share, "max_ulps": ulps, "top": top}

    gpu, cpu = cases("cuda"), cases("cpu")
    for name in gpu:
        for active in ((1.0, 1.0), (1.0, 0.0)):
            act_g = torch.tensor([active], device=dev)
            act_c = torch.tensor([active])
            k = tup(gpu[name](kernel, act_g))
            pg = tup(gpu[name](plain, act_g))
            pc = tup(cpu[name](plain, act_c))
            torch.cuda.synchronize()
            print(json.dumps({
                "case": name, "active": active,
                "kernel_vs_plain_gpu": pair(k, pg),
                "plain_gpu_vs_plain_cpu": pair(pg, pc),
                "kernel_vs_plain_cpu": pair(k, pc)}), flush=True)
    # the plain whole CGNN with one bf16 ulp added to 0.1 % of its inputs:
    # how far the network itself carries a flipped rounding
    c = cg["cuda"]
    z = z32.to(dev, bf)
    hit = torch.as_tensor(rng.random(z.shape) < 1e-3, device=dev)
    bits = z.view(torch.int16)
    z_ulp = torch.where(hit, bits + 1, bits).view(bf)
    for active in ((1.0, 1.0), (1.0, 0.0)):
        act_g = torch.tensor([active], device=dev)
        pe = pe32.to(dev, bf)
        base = tup(plain["full"](c, z, pe, act_g))
        moved = tup(plain["full"](c, z_ulp, pe, act_g))
        print(json.dumps({
            "case": "full_plain_one_ulp_on_0.1%_of_inputs", "active": active,
            "inputs_moved": int(hit.sum()), "plain_vs_plain": pair(moved, base)}),
            flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
