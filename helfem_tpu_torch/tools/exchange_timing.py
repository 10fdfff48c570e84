"""`python3 helfem_tpu_torch/tools/exchange_timing.py [--root DIR]`: the
diatomic exchange kernels K6 (radial_exchange_dia_occ) and K7
(radial_exchange_dia) of a checkout, timed on the card.

Imports chip_smoke.py and helfem_tpu_torch from the checkout at DIR (by
default the one holding this file) and runs its phase-3 comparison of the
two kernels against their plain versions at the N2 (6,6), CO, LiH and
lmax=12 shapes, so that two commits can be timed in one card session: one
process per checkout, since a process keeps the first kernel library it
loads. Prints the card and one JSON line per kernel and shape.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

# the LiH shape of tests/test_torch_kernels.py: nprim 5, blocks that are not
# a whole number of warps
LIH = dict(Z1=3, Z2=1, Rbond=3.015, lmax=(3, 2, 1), rmax=20.0, nelem=3, nnodes=5)


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
        raise SystemExit("exchange_timing: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    runs = [(shape, cs.dia_exchange_inputs(cfg, dev))
            for shape, cfg in {**cs.DIA_SHAPES, "lih": LIH}.items()]
    runs.append(("lmax12", cs.lmax12_exchange_inputs(dev)))
    for shape, inputs in runs:
        big = shape == "lmax12"
        for name, (kargs, moved, flops) in inputs.items():
            r = cs.compare(name, kargs, moved, flops, *((1, 3) if big else (5, 50)))
            print(json.dumps({"root": root, "shape": shape, "name": name, "ms": r["ms"],
                              "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                              "max_abs_err": r["max_abs_err"],
                              "tflop_s": flops / r["ms"] / 1e9}), flush=True)
        del inputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
