"""`python3 helfem_tpu_torch/tools/eig_timing.py [--root DIR]`: warm SCF walls
of a checkout on the card, with the device time split into the eigensolve
(K11's sweeps, `aten::_linalg_eigh`) and the rest.

Imports helfem_tpu_torch from the checkout at DIR (by default the one
holding this file), so that two commits can be compared in one run on the
card: one process per checkout, since a process keeps the first kernel
library it loads. Per cell (Ar HF and N2 PBE at the bench bases, N2 HF at
the lmax=12 basis; chip_smoke.py's settings) it runs one cold SCF, then
`--walls` warm ones (the wall clock of each, to a synchronise) and one more
under torch.profiler, measured by this file's own checkout's code: the
device time of all kernels, of K11 (`refine_eig_kernel`, absent before the
warm start) and of `aten::_linalg_eigh` (its self device time: the cuSOLVER
kernels it launches), and the warm start's accepted and cold groups where
the checkout counts them. Prints the card and one JSON line per cell.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

CELLS = {  # label -> (kind, basis arguments, SCF arguments)
    "Ar HF": ("atomic", dict(Z=18, lmax=1, mmax=1, rmax=40.0, nelem=10, nnodes=15),
              dict(nela=9, nelb=9, convthr=1e-9, guess="TF")),
    "N2 PBE": ("diatomic", dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5,
                                nnodes=8),
               dict(nela=7, nelb=7, method="PBE", convthr=1e-7, maxit=50)),
    "N2 HF lmax=12": ("diatomic", dict(Z1=7, Z2=7, Rbond=2.068, lmax=(12, 12, 12), rmax=40.0,
                                       nelem=5, nnodes=15),
                      dict(nela=7, nelb=7, method="HF", convthr=1e-7, maxit=50)),
}


def _profiling():
    """utils/profiling.py of this file's checkout, whatever checkout is
    timed (the parent's may not split the eigensolve)."""
    path = Path(__file__).resolve().parents[1] / "utils" / "profiling.py"
    spec = importlib.util.spec_from_file_location("_eig_timing_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_split(run, profiling) -> dict:
    """Device ms of one run() under torch.profiler: all kernels, K11, eigh."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    split = profiling.eig_split(events)
    (k11_ms, k11_n), (eigh_ms, eigh_n) = split[profiling.K11], split[profiling.EIGH]
    return {"busy_ms": sum(e.self_device_time_total for e in profiling._kernels(events)) * 1e-3,
            "k11_ms": k11_ms, "k11_launches": k11_n, "eigh_ms": eigh_ms, "eigh_calls": eigh_n}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose SCFs are timed")
    p.add_argument("--walls", type=int, default=3, help="warm SCFs timed per cell")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    profiling = _profiling()
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("eig_timing: needs an NVIDIA GPU")
    linalg = importlib.import_module("helfem_tpu_torch.utils.linalg")
    atomic = importlib.import_module("helfem_tpu_torch.models.atomic")
    diatomic = importlib.import_module("helfem_tpu_torch.models.diatomic")
    atomic_scf = importlib.import_module("helfem_tpu_torch.scf.atomic_scf")
    diatomic_scf = importlib.import_module("helfem_tpu_torch.scf.diatomic_scf")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    counts = getattr(linalg, "warm_counts", None)  # absent before the warm start
    for label, (kind, bargs, sargs) in CELLS.items():
        basis = (atomic.AtomicBasis if kind == "atomic" else diatomic.DiatomicBasis)(**bargs)
        ops = basis.build_operators(dev)
        scf = atomic_scf.scf_atom if kind == "atomic" else diatomic_scf.scf_diatomic
        kw = dict(sargs)
        nela, nelb = kw.pop("nela"), kw.pop("nelb")

        def run():
            return scf(basis, nela, nelb, ops=ops, **kw)

        res = run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.walls):
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if counts is not None:
            for key in counts:
                counts[key] = 0
        split = device_split(run, profiling)
        print(json.dumps({"root": root, "cell": label, "E": res.E, "niter": res.niter,
                          "converged": res.converged, "walls_s": walls, **split,
                          "warm_counts": None if counts is None else dict(counts)}),
              flush=True)
        del ops
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
