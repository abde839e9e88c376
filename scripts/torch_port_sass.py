"""What the port's kernels compile to: SASS opcode counts per kernel.

Builds the kernels from `neural_rx_tpu_torch/csrc` of the checkout this
script lives in (`kernels/_build.py`), disassembles the library with
`cuobjdump -sass`, and for every kernel whose mangled name contains one of
the given names prints its count of each opcode (the mnemonic before the
first dot: HMMA, FFMA, LDS, LDG, STG, BAR, ...) as one JSON line, and
writes its full SASS to --out (one file a kernel; by default `sass/` in
the package's gitignored build directory). Needs the CUDA toolkit:

    python3 scripts/torch_port_sass.py [--out DIR] \
        sepconv_stack_kernel ldpc_layered_kernel
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from neural_rx_tpu_torch.kernels import _build

    out_dir = args.out or os.path.join(_build.BUILD_DIR, "sass")

    lib = _build.build().path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not any(n in name for n in args.names):
            continue
        ops = collections.Counter(OPCODE.findall(part))
        counts[name] = dict(ops.most_common())
        with open(os.path.join(out_dir, name[:120] + ".sass"), "w") as f:
            f.write(part)
    print(json.dumps({"library": os.path.basename(lib), "kernels": counts}))
    return 0 if counts else 1


if __name__ == "__main__":
    sys.exit(main())
