"""`python3 helfem_tpu_torch/tools/radial_timing.py [--root DIR]`: the atomic
radial kernels K1 (radial_exchange) and K2 (radial_coulomb) of a checkout,
timed on the card.

Imports chip_smoke.py and helfem_tpu_torch from the checkout at DIR (by
default the one holding this file) and runs its phase-3 comparison of the
two kernels against their plain versions at the Ar and Xe bench shapes, so
that two commits can be timed in one run on the card: one process per
checkout, since a process keeps the first kernel library it loads. Beside
the call time (CUDA events over back-to-back calls, host dispatch included)
it prints the device time per call from torch.profiler and the host's
enqueue time per call (wall clock of 200 calls without a synchronise),
both measured by this file's own checkout's code. Prints the card and one
JSON line per kernel and shape.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def _device_ms():
    """device_ms from this file's checkout, whatever checkout is timed."""
    path = Path(__file__).resolve().parents[1] / "utils" / "profiling.py"
    spec = importlib.util.spec_from_file_location("_radial_timing_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.device_ms


def host_enqueue_us(fn, calls: int = 200) -> float:
    """Microseconds per call of fn() on the host, without a synchronise
    between calls: the wrapper's Python and the launch API."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose kernels are timed")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    device_ms = _device_ms()
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("radial_timing: needs an NVIDIA GPU")
    kernels = importlib.import_module("helfem_tpu_torch.kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    for shape in ("ar", "xe"):
        inputs = cs.kernel_inputs(cs.SHAPES[shape], dev)
        for name in ("radial_exchange", "radial_coulomb"):
            kargs, moved, flops = inputs[name]
            r = cs.compare(name, kargs, moved, flops)
            kern = getattr(kernels, name)
            print(json.dumps({"root": root, "shape": shape, "name": name, "ms": r["ms"],
                              "device_ms": device_ms(lambda: kern(*kargs), 50),
                              "host_enqueue_us": host_enqueue_us(lambda: kern(*kargs)),
                              "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                              "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"],
                              "scale": r["scale"]}), flush=True)
        del inputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
