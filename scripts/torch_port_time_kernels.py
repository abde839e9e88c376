"""Device time of the port's kernels alone, on the GPU.

Builds the kernels from `neural_rx_tpu_torch/csrc` (printing what ptxas
reports of registers and spills when it compiles them), then times with
CUDA events at nrx_rt's widths (132 PRB, committed weights, inputs from
numpy's default_rng(0)), each beside its bound as `chip_smoke.py` computes
it: in bfloat16 the separable-conv stack kernel over the three stacks of
one batch-1 slot (N = 2) and on the batch-16 route's init stack (N = 32),
the fused iteration at batch 16 in state mode and the whole-CGNN kernel at
batch 1 and 16; in float32 the layered LDPC decoder on one user's batch-16
load (80 BG1/Z = 384 codewords at 10 dB, 20 iterations) and the CGNN
kernels at the eval and Monte-Carlo path's shapes (`float32`): the stack
kernel on the init stack at N = 60 (batch 30), the fused iteration at
batch 30 in state mode and in readout mode (both readouts) and the
whole-CGNN kernel at batch 1, each beside its float32 bound and with a
SHA-256 of its output bytes (inputs from their own default_rng(0)), so two
checkouts timed in one call show whether their float32 outputs are the
same bits. Beside the times: the elements of the stack slot and the hard
bits of the decode that differ from the plain versions, and each float32
kernel's largest difference from its plain version relative to the plain
output's largest magnitude. Prints one JSON line. It passes the wrappers
their layer modes, so an older checkout, whose wrappers take none, is timed
with that checkout's own copy of this script (the float32 part passes
none).

With --conv-mxu the stacks run in the folded-tap mode (`mxu=True`; the
iteration and whole-CGNN kernels do not take it), with --stencil-lp the
stacks, the iteration and the whole CGNN sum their depthwise taps in
bfloat16 (`lp_stencil=True`); the output names the mode. Run it once per
mode in one call to compare the modes on one card.

    python3 scripts/torch_port_time_kernels.py [--reps 10] \
        [--conv-mxu] [--stencil-lp]
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TX, N_SYM, N_SC = 2, 14, 1584


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--conv-mxu", action="store_true")
    ap.add_argument("--stencil-lp", action="store_true")
    args = ap.parse_args()
    stack_kw = {"mxu": args.conv_mxu, "lp_stencil": args.stencil_lp}
    cgnn_kw = {"lp_stencil": args.stencil_lp}
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from neural_rx_tpu_torch.entry import load_params, make_receiver
    from neural_rx_tpu_torch.kernels import _build, cgnn_iter, sepconv
    from neural_rx_tpu_torch.kernels import ldpc as k5
    from neural_rx_tpu_torch.phy.nr import ldpc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    info = _build.build()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    peaks = cs.card_peaks(torch.cuda.get_device_name(0))
    bf, dev = torch.bfloat16, torch.device("cuda")
    cgnn = load_params(device=dev)["cgnn"]
    pe = make_receiver(device=dev).pe.to(bf)
    rng = np.random.default_rng(0)

    def rand(shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev).to(bf)

    def rates(rec):  # achieved TFLOP/s and share of the bound
        return {**rec, "tflops": rec["flops"] / rec["kernel_ms"] / 1e9,
                "pct_of_bound": 100.0 * rec["bound_ms"] / rec["kernel_ms"]}

    out = {"card": card, "nvcc_seconds": info.seconds, "ptxas": ptxas,
           "modes": {"conv_mxu": args.conv_mxu,
                     "stencil_lp": args.stencil_lp}}
    stacks = [cgnn["s_init"][0]] + [it["update"] for it in cgnn["iterations"]]
    xs = [rand((N_TX, N_SYM, N_SC, cs.widths_of(p)[0])) for p in stacks]
    out["sepconv_slot_ms"] = sum(
        cs.cuda_ms(lambda p=p, x=x: sepconv.fused_conv_stack(p, x, **stack_kw),
                   args.reps)
        for p, x in zip(stacks, xs))
    # elements that differ from the plain version, over the slot's stacks
    out["sepconv_slot_differing"] = sum(
        int((sepconv.fused_conv_stack(p, x, **stack_kw)
             != sepconv.sepconv_stack_reference(p, x, **stack_kw)).sum())
        for p, x in zip(stacks, xs))
    x32 = rand((32, N_SYM, N_SC, 18))
    work = cs.stack_work(cs.widths_of(stacks[0]), 32, N_SYM, N_SC, 2)
    if args.conv_mxu:  # the folded form's products: 2 x 9 x c_in x c_out
        work = (work[0], cs.fold_flops(cs.widths_of(stacks[0]))
                * 32 * N_SYM * N_SC)
    rec = {"kernel_ms": cs.cuda_ms(
        lambda: sepconv.fused_conv_stack(stacks[0], x32, **stack_kw),
        args.reps), **cs.bound(*work, peaks)}
    out["sepconv_init_n32"] = rates(rec)
    del x32
    it0 = cgnn["iterations"][0]
    s16 = rand((16, N_TX, N_SYM, N_SC, 56), 4.0)
    act16 = torch.ones((16, N_TX), device=dev)
    rec = {"kernel_ms": cs.cuda_ms(
        lambda: cgnn_iter.fused_iteration(it0, s16, pe, act16, **cgnn_kw),
        args.reps),
        **cs.bound(*cs.iteration_work(it0, 16, pe.shape[-1], 2), peaks)}
    out["cgnn_iter_b16"] = rates(rec)
    del s16
    for b in (1, 16):
        z = rand((b, N_TX, N_SYM, N_SC, 18))
        act = torch.ones((b, N_TX), device=dev)
        rec = {"kernel_ms": cs.cuda_ms(
            lambda: cgnn_iter.fused_cgnn_full(cgnn, z, pe, act, **cgnn_kw),
            args.reps),
            **cs.bound(*cs.full_work(cgnn, b, pe.shape[-1], 2), peaks)}
        out[f"cgnn_full_b{b}"] = rates(rec)
    # one user's batch-16 transport blocks: 16 x 5 codewords, BPSK at 10 dB
    code = ldpc.get_code(1, 384)
    sent = torch.as_tensor(rng.integers(0, 2, (80, code.k)),
                           dtype=torch.float32, device=dev)
    cw = ldpc.encode(code, sent)
    snr = 10.0 ** (10.0 / 10.0)
    y = (1.0 - 2.0 * cw) + torch.as_tensor(
        rng.standard_normal(tuple(cw.shape)) / snr ** 0.5,
        dtype=torch.float32, device=dev)
    llr = (2.0 * snr * y).contiguous()  # internal log(p0/p1)
    llr[:, :2 * code.z] = 0.0
    bits = k5.layered_decode(code, llr, cs.LDPC_ITER)
    rec = {"kernel_ms": cs.cuda_ms(
        lambda: k5.layered_decode(code, llr, cs.LDPC_ITER), args.reps),
        "bit_errors": int((bits != cw).sum()),
        "differing_bits": int((bits != k5.layered_decode_reference(
            code, llr, cs.LDPC_ITER)).sum()),
        **cs.bound(*cs.ldpc_work(code, 80), peaks, rate="f32_flops")}
    out["ldpc_decode_80"] = rates(rec)
    out["float32"] = float32_kernels(cs, peaks, args.reps, dev)
    print(json.dumps(out))
    return 0


def float32_kernels(cs, peaks, reps, dev) -> dict:
    """The float32 CGNN kernels at the eval path's shapes: time, bound,
    SHA-256 of the output bytes, and the largest difference from the plain
    version (relative to its largest magnitude)."""
    import torch
    from neural_rx_tpu_torch.entry import load_params, make_receiver
    from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
    f32 = torch.float32
    cgnn = load_params(dtype=f32, device=dev)["cgnn"]
    pe = make_receiver(nrx_dtype=f32, device=dev).pe.to(f32)
    rng = np.random.default_rng(0)

    def rand(shape, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=f32, device=dev)

    def digest(outs):
        h = hashlib.sha256()
        for o in outs:
            h.update(o.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    def record(fn, plain, work, n):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        rec = {"kernel_ms": cs.cuda_ms(fn, n),
               **cs.bound(*work, peaks, rate="f32_flops"),
               "sha256": digest(got),
               "rel_err": max(cs.rel_err(g, r) for g, r in zip(got, ref))}
        return {**rec, "tflops": rec["flops"] / rec["kernel_ms"] / 1e9,
                "pct_of_bound": 100.0 * rec["bound_ms"] / rec["kernel_ms"]}

    out = {}
    init = cgnn["s_init"][0]
    x60 = rand((60, N_SYM, N_SC, cs.widths_of(init)[0]))
    out["sepconv_init_n60"] = record(
        lambda: sepconv.fused_conv_stack(init, x60),
        lambda: sepconv.sepconv_stack_reference(init, x60),
        cs.stack_work(cs.widths_of(init), 60, N_SYM, N_SC, 4), reps)
    del x60
    it0, it1 = cgnn["iterations"]
    d_s = cs.mlp_dims(it0["agg"])[0]
    s30 = rand((30, N_TX, N_SYM, N_SC, d_s), 4.0)
    act30 = torch.ones((30, N_TX), device=dev)
    out["cgnn_iter_b30"] = record(
        lambda: cgnn_iter.fused_iteration(it0, s30, pe, act30),
        lambda: cgnn_iter.fused_iteration_reference(it0, s30, pe, act30),
        cs.iteration_work(it0, 30, pe.shape[-1], 4), max(reps // 2, 1))
    readouts = (cgnn["readout_llrs"][0], cgnn["readout_chest"])
    out["cgnn_iter_b30_readout"] = record(
        lambda: cgnn_iter.fused_iteration(it1, s30, pe, act30, None,
                                          *readouts),
        lambda: cgnn_iter.fused_iteration_reference(it1, s30, pe, act30,
                                                    None, *readouts),
        cs.iteration_work(it1, 30, pe.shape[-1], 4, readouts),
        max(reps // 2, 1))
    del s30
    z1 = rand((1, N_TX, N_SYM, N_SC, cs.widths_of(init)[0]))
    act1 = torch.ones((1, N_TX), device=dev)
    out["cgnn_full_b1"] = record(
        lambda: cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1),
        lambda: cgnn_iter.fused_cgnn_full_reference(cgnn, z1, pe, act1),
        cs.full_work(cgnn, 1, pe.shape[-1], 4), reps)
    return out


if __name__ == "__main__":
    sys.exit(main())
