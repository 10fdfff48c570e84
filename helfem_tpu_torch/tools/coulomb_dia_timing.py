"""`python3 helfem_tpu_torch/tools/coulomb_dia_timing.py [--root DIR]`: the
diatomic Coulomb kernel K3 (radial_coulomb_dia) of a checkout, timed on the
card at the N2 (6,6) bench basis and the N2 lmax=12 basis.

Imports chip_smoke.py and helfem_tpu_torch from the checkout at DIR (by
default the one holding this file), builds that checkout's operators and
K3's inputs for a random symmetric symmetry-block-diagonal density (numpy
seed) at the SCF's njbd channels, and runs its chip_smoke.compare of K3
against the plain version, so that two commits can be timed in one run on
the card: one process per checkout, since a process keeps the first kernel
library it loads. Beside the call time (CUDA events over back-to-back calls,
host dispatch included) it prints the device time per call from
torch.profiler and the host's enqueue time per call, both measured by this
file's own checkout's code (radial_timing.py), and the bound (bytes: each
table row, window entry and output once). Prints the card and one JSON line
per shape.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {  # DiatomicBasis arguments: chip_smoke.py's N2 bench and N2_L12_SHAPE
    "n2": dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8),
    "lmax12": dict(Z1=7, Z2=7, Rbond=2.068, lmax=(12, 12, 12), rmax=40.0, nelem=5, nnodes=15),
}


def _timing():
    """radial_timing.py of this file's checkout, whatever checkout is timed."""
    path = Path(__file__).resolve().parent / "radial_timing.py"
    spec = importlib.util.spec_from_file_location("_coulomb_dia_timing_radial", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k3_inputs(cfg: dict, dev, seed: int = 11):
    """(K3's arguments, bytes it must move, operations) at a basis of the
    imported checkout, as chip_smoke.coulomb_dia_inputs counts them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from helfem_tpu_torch.models.diatomic import DiatomicBasis, _to4

    basis = DiatomicBasis(**cfg)
    ops = basis.build_operators(dev)
    rng = np.random.default_rng(seed)
    P = np.zeros((basis.nbf, basis.nbf))
    for idx in basis.sym_blocks():
        X = rng.standard_normal((len(idx), len(idx)))
        P[np.ix_(idx, idx)] = X + X.T
    P4 = _to4(torch.tensor(P, device=dev), basis.nang, basis.nrad)
    nj = basis.njbd
    Paux0 = torch.einsum("sab,abIJ->sIJ", ops.GmLM[:nj], P4).contiguous()
    Paux2 = torch.einsum("sab,abIJ->sIJ", ops.GpLM[:nj], P4).contiguous()
    ilm = ops.LM_ilm[:nj]
    nelem, npr = ops.gidx.shape
    np2, rows = npr * npr, len(set(ilm.tolist()))
    moved = (8 * 2 * nj * cs.window_entries(ops.gidx, basis.nrad) + cs.nbytes(Paux0, Paux2)
             + cs.nbytes(ilm, ops.gidx) + 8 * rows * (3 * nelem * np2 * np2 + 4 * nelem * np2 + 1))
    args = (Paux0, Paux2, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.LMfac, ilm,
            ops.gidx)
    return args, moved, nj * nelem * (8 * np2 * np2 + 16 * np2)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose kernel is timed")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    timing = _timing()
    device_ms = timing._device_ms()
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("coulomb_dia_timing: needs an NVIDIA GPU")
    kernels = importlib.import_module("helfem_tpu_torch.kernels")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    name = "radial_coulomb_dia"
    kern = getattr(kernels, name)
    for shape, cfg in SHAPES.items():
        kargs, moved, flops = k3_inputs(cfg, dev)
        reps = (2, 10) if shape == "lmax12" else (5, 50)
        r = cs.compare(name, kargs, moved, flops, *reps)
        print(json.dumps({"root": root, "shape": shape, "name": name, "ms": r["ms"],
                          "device_ms": device_ms(lambda: kern(*kargs), 50),
                          "host_enqueue_us": timing.host_enqueue_us(lambda: kern(*kargs)),
                          "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"],
                          "scale": r["scale"]}), flush=True)
        del kargs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
