"""Where the first layered LDPC kernel spends a row step, from clock64 probes.

Takes the source of the first version of `csrc/ldpc_decode.cu` (the kernel
that stores one check message per edge and lane in device memory; give the
file of a checkout of that version with --src), inserts clock64 reads into
a copy at three points of every row step of block 0's thread 0 (row start;
after the min1 pass, which loads the app and the row's messages; after the
update, which stores them; after the row's barrier), builds the copy alone
with nvcc and runs it on one user's batch-16 load of nrx_rt's eval code
(80 BG1/Z = 384 codewords at 10 dB, 20 iterations). Prints one JSON line:
the mean cycles a row step spends in each phase, the kernel's time from
CUDA events with and without the probes, and the card's name, power limit
and SM clock. Run on a machine with a GPU and nvcc, from the repository
root:

    python3 scripts/torch_port_ldpc_probe.py \
        --src OLD/neural_rx_tpu_torch/csrc/ldpc_decode.cu
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (anchor in the first kernel's source, text put after it)
PROBES = [
    ("  const int j = threadIdx.x;\n",
     "  const bool pr_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  long long pr_sum[3] = {0, 0, 0};\n"),
    ("    for (int r = 0; r < n_rows; ++r) {\n",
     "      const long long pr_a = clock64();\n"
     "      long long pr_b = pr_a, pr_c = pr_a;\n"),
    ("        // second minimum: mask only the first edge reaching min1\n",
     "        asm volatile(\"\" ::\"f\"(min1));\n"
     "        pr_b = clock64();\n"),
]
# the update loop ends the `if (j < z)` block; then the row's barrier
END_OF_ROW = ("      }\n      __syncthreads();\n    }\n  }\n",
              "        asm volatile(\"\" ::: \"memory\");\n"
              "        pr_c = clock64();\n"
              "      }\n      __syncthreads();\n"
              "      if (pr_on) {\n"
              "        const long long pr_d = clock64();\n"
              "        pr_sum[0] += pr_b - pr_a;\n"
              "        pr_sum[1] += pr_c - pr_b;\n"
              "        pr_sum[2] += pr_d - pr_c;\n"
              "      }\n    }\n  }\n"
              "  if (pr_on)\n"
              "    for (int q = 0; q < 3; ++q) g_probe[q] += pr_sum[q];\n")
HEADER = ("__device__ long long g_probe[3];\n"
          "extern \"C\" int nrx_probe_read(long long* host) {\n"
          "  return (int)cudaMemcpyFromSymbol(host, g_probe,\n"
          "                                   sizeof(g_probe));\n"
          "}\n"
          "extern \"C\" int nrx_probe_reset() {\n"
          "  const long long zero[3] = {0, 0, 0};\n"
          "  return (int)cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));\n"
          "}\n")


def instrument(src: str) -> str:
    for anchor, text in PROBES:
        if anchor not in src:
            raise SystemExit(f"anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + text, 1)
    if END_OF_ROW[0] not in src:
        raise SystemExit("end-of-row anchor not found")
    src = src.replace(END_OF_ROW[0], END_OF_ROW[1], 1)
    anchor = "namespace {\n"
    return src.replace(anchor, HEADER + anchor, 1)


def build(src_path: str, out_dir: str, probes: bool) -> ctypes.CDLL:
    from neural_rx_tpu_torch.kernels import _build
    with open(src_path) as f:
        src = f.read()
    if probes:
        src = instrument(src)
    name = "probe" if probes else "plain"
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run([_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.nrx_ldpc_layered_decode.restype = I
    lib.nrx_ldpc_layered_decode.argtypes = [P] * 7 + [I] * 6 + [P]
    if probes:
        lib.nrx_probe_read.argtypes = [P]
        lib.nrx_probe_reset.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from neural_rx_tpu_torch.phy.nr import ldpc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    code = ldpc.get_code(1, 384)
    n = 80
    info = torch.as_tensor(rng.integers(0, 2, (n, code.k)),
                           dtype=torch.float32, device=dev)
    cw = ldpc.encode(code, info)
    snr = 10.0
    y = (1.0 - 2.0 * cw) + torch.as_tensor(
        rng.standard_normal(tuple(cw.shape)) / snr ** 0.5,
        dtype=torch.float32, device=dev)
    llr = (2.0 * snr * y).contiguous()
    llr[:, :2 * code.z] = 0.0
    # the first kernel's row plan: column, shift and message index per edge
    flat = [(c, int(code.shifts[(r, c)]), int(code.row_ptr[r]) + i)
            for r, cols in enumerate(code.rows) for i, c in enumerate(cols)]
    cols, shifts, edges = (torch.tensor(v, dtype=torch.int32, device=dev)
                           for v in zip(*flat))
    row_ptr = torch.tensor(code.row_ptr.tolist(), dtype=torch.int32,
                           device=dev)
    out = torch.empty_like(llr)
    c2v = torch.empty((n, code.num_edges, code.z), device=dev)
    res = {"card": card, "codewords": n, "bg": 1, "z": code.z,
           "num_iter": cs.LDPC_ITER}
    with tempfile.TemporaryDirectory() as tmp:
        for probes in (False, True):
            lib = build(args.src, tmp, probes)

            def run():
                rc = lib.nrx_ldpc_layered_decode(
                    llr.data_ptr(), out.data_ptr(), c2v.data_ptr(),
                    row_ptr.data_ptr(), cols.data_ptr(), shifts.data_ptr(),
                    edges.data_ptr(), n, code.z, code.num_cols,
                    code.num_rows, code.num_edges, cs.LDPC_ITER,
                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            key = "probed" if probes else "plain"
            res[f"kernel_ms_{key}"] = cs.cuda_ms(run, args.reps)
            res[f"bit_errors_{key}"] = int((out != cw).sum())
            if probes:
                assert lib.nrx_probe_reset() == 0
                run()
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * 3)()
                ptr = ctypes.cast(buf, ctypes.c_void_p)
                assert lib.nrx_probe_read(ptr) == 0
                steps = cs.LDPC_ITER * code.num_rows
                res["row_steps"] = steps
                res["cycles_per_row_step"] = {
                    "loads_and_min1": buf[0] / steps,
                    "min2_and_update": buf[1] / steps,
                    "barrier": buf[2] / steps}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
