"""`python3 helfem_tpu_torch/tools/probe_timing.py [--root DIR]`: the matmul
probes K8 (matmul_f32) and K9 (matmul_dd) of a checkout, timed on the card.

Imports chip_smoke.py and helfem_tpu_torch from the checkout at DIR (by
default the one holding this file) and runs its phase-3 comparison of the
probes against their plain versions at n = 2048 and 4096, both precisions,
so that two commits can be timed in one card session: one process per
checkout, since a process keeps the first kernel library it loads. Prints
the card and one JSON line per probe, precision and size.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose kernels are timed")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("probe_timing: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    for n in (2048, 4096):
        for (name, prec), r in cs.compare_probes(n, dev).items():
            print(json.dumps({"root": root, "n": n, "name": name, "precision": prec,
                              "ms": r["ms"], "plain_ms": r["plain_ms"],
                              "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"],
                              "scale": r["scale"], "tflop_s": r["flops"] / r["ms"] / 1e9}),
                  flush=True)


if __name__ == "__main__":
    main()
