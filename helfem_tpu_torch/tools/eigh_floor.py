"""`python -m helfem_tpu_torch.tools.eigh_floor`: the DIIS-error floor of Xe HF
at the bench basis on the card, against the eigensolver of the SCF.

Runs the port's restricted SCF of Xe (lmax = mmax = 3, nelem 8, nnodes 12,
Rmax 40, zexp 2.5, TF guess) with convthr 1e-12 for 30 iterations three
times: with the blocked eigensolve as it ships (torch.linalg.eigh on the card
plus helfem_tpu's four refinement passes, utils/linalg.py:eigh_refined),
with no refinement pass (the card's eigh alone), and with the eigh taken on
the host's LAPACK and no refinement pass. The fused chunks' warm start
(K11, utils/linalg.py:eigh_warm) runs first at every fused step, but its
certificate gate at convthr 1e-12 is 1e-13, below its floor at Xe, so each
step takes the cold eigensolve under test. Prints the card, then one JSON line
per run: the energy, the iterations, and the last three DIIS errors. The
error stops falling where the eigensolve's residual holds it, and the SCF
converges at a convthr only above that floor.
"""

import contextlib
import json
import subprocess

import torch

from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.utils import linalg

XE = dict(Z=54, lmax=3, mmax=3, rmax=40.0, nelem=8, nnodes=12, zexp=2.5)
_EIGH = torch.linalg.eigh


def _host_eigh(A):
    w, V = _EIGH(A.cpu())
    return w.to(A.device), V.to(A.device)


class _DiisLog:
    """stdout sink keeping the DIIS error of each verbose SCF line."""

    def __init__(self):
        self.errs = []

    def write(self, text):
        if "diis =" in text:
            self.errs.append(float(text.split("diis =")[1].split()[0]))

    def flush(self):
        pass


def run(label: str, npass: int, host: bool, dev, cfg=XE, nel=27) -> dict:
    """One SCF with the eigensolve's refinement passes set to npass (on the
    host's LAPACK eigh when host); both restored afterwards."""
    defaults = linalg.eigh_refined.__defaults__
    linalg.eigh_refined.__defaults__ = (npass, defaults[1])
    log = _DiisLog()
    try:
        if host:
            torch.linalg.eigh = _host_eigh
        basis = AtomicBasis(**cfg)
        ops = basis.build_operators(dev)
        with contextlib.redirect_stdout(log):
            res = scf_atom(basis, nel, nel, convthr=1e-12, maxit=30, guess="TF", ops=ops,
                           verbose=True)
    finally:
        linalg.eigh_refined.__defaults__ = defaults
        torch.linalg.eigh = _EIGH
    return {"eigensolve": label, "E": res.E, "iterations": res.niter,
            "last_diis_errors": log.errs[-3:]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("eigh_floor: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    for label, npass, host in (("card eigh + 4 refinement passes (as shipped)", 4, False),
                               ("card eigh alone", 0, False),
                               ("host LAPACK eigh alone", 0, True)):
        print(json.dumps(run(label, npass, host, dev)), flush=True)


if __name__ == "__main__":
    main()
