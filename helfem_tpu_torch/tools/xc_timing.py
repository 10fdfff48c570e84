"""`python3 helfem_tpu_torch/tools/xc_timing.py [--root DIR]`: the diatomic
XC kernels K4 (dia_xc_fields) and K5 (dia_xc_fock) of a checkout, timed on
the card.

Imports chip_smoke.py and helfem_tpu_torch from the checkout at DIR (by
default the one holding this file) and runs its phase-3 comparison of the
two kernels against their plain versions at the N2 (6,6), CO and N2
lmax=12 shapes, so that two commits can be timed in one run on the card: one
process per checkout, since a process keeps the first kernel library it
loads. A checkout whose kernels take both spins in one call is timed at one
and two spins, an older one at its one spin per call; one with a tau mode
(meta-GGAs) also in that mode. Beside the call time (CUDA events over
back-to-back calls, host dispatch included) it prints the device time per
call from torch.profiler and from CUDA events around calls queued behind
a sleeping kernel, measured by this file's own checkout's
utils/profiling.py. Prints the card and one JSON line per kernel, shape,
spin count and mode.
"""

import argparse
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path


def _timers():
    """device_ms and queued_ms from this file's checkout, whatever checkout
    is timed."""
    path = Path(__file__).resolve().parents[1] / "utils" / "profiling.py"
    spec = importlib.util.spec_from_file_location("_xc_timing_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.device_ms, module.queued_ms


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose kernels are timed")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    device_ms, queued_ms = _timers()
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("xc_timing: needs an NVIDIA GPU")
    kernels = importlib.import_module("helfem_tpu_torch.kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    batched = "ns" in inspect.signature(cs.dia_kernel_inputs).parameters
    modes = (False, True) if "tau" in inspect.signature(cs.xc_kernel_inputs).parameters else \
        (False,)
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    shapes = {**cs.DIA_SHAPES, "lmax12": cs.N2_L12_SHAPE}
    for shape, cfg in shapes.items():
        big = shape == "lmax12"
        for ns in (1, 2) if batched else (1,):
            for tau in modes:
                if tau:
                    inputs = cs.xc_kernel_inputs(DiatomicBasis(**cfg), dev, ns, tau=True)
                else:
                    inputs = cs.dia_kernel_inputs(cfg, dev, ns=ns) if batched else \
                        cs.dia_kernel_inputs(cfg, dev)
                for name in ("dia_xc_fields", "dia_xc_fock"):
                    kargs, moved, flops = inputs[name]
                    r = cs.compare(name, kargs, moved, flops, *((2, 10) if big else (5, 50)))
                    kern = getattr(kernels, name)
                    reps = 10 if big else 20
                    print(json.dumps({
                        "root": root, "shape": shape, "spins": ns, "tau": tau, "name": name,
                        "ms": r["ms"], "device_ms": device_ms(lambda: kern(*kargs), reps),
                        "queued_ms": queued_ms(lambda: kern(*kargs), reps),
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"],
                        "scale": r["scale"]}), flush=True)
                del inputs
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
