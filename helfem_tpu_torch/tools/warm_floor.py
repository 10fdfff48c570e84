"""`python3 -m helfem_tpu_torch.tools.warm_floor [--out DIR]`: the residual
certificate of the warm eigensolve at every fused SCF step on the card, by
K11 and by its plain version, against the step's gate.

Runs one SCF per cell (tools/eig_timing.py's Ar HF, N2 PBE and N2 HF at the
lmax=12 basis, and Xe HF at the bench basis; chip_smoke.py's settings) with
every K11 call's inputs recorded (utils/profiling.py:capture_warm), then
holds each call's residuals per group (one per spin) from K11 against
refine_eig_plain's on the same inputs and against the SCF's gate,
min(0.1 convthr, 1e-9). Each call's scale is the largest |eigenvalue| of
its blocks' unpadded slots, whose f64 rounding (about eps n max|E|) sets
the floor the residual cannot go below. Prints the card and one JSON line
per cell. With --out, the inputs of each cell's last warm attempt (seeded
by the previous step, never by the identity) go to DIR/<cell>.npz (A, V0,
npass, tau, groups, gate), for a reference run of helfem_tpu's eigh_warm
on the same blocks on the CPU (tests/warm_floor_reference.py).
"""

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from helfem_tpu_torch.kernels import refine_eig_plain
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.common import warm_gate
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
from helfem_tpu_torch.tools.eig_timing import CELLS as TIMED
from helfem_tpu_torch.utils.linalg import _BIG
from helfem_tpu_torch.utils.profiling import capture_warm

CELLS = {**TIMED, "Xe HF": ("atomic", dict(Z=54, lmax=3, mmax=3, rmax=40.0, nelem=8, nnodes=12,
                                           zexp=2.5),
                            dict(nela=27, nelb=27, convthr=1e-9, guess="TF"))}


def unpadded_scale(E: torch.Tensor) -> float:
    """The largest |eigenvalue| outside the padded slots (eigenvalue _BIG)."""
    return float(E.abs().masked_fill(E.abs() > 0.5 * _BIG, 0.0).max())


def cell_floor(label: str, dev, out: Path | None) -> dict:
    """One SCF of the cell with its K11 calls recorded: per call the
    residuals by K11 and by the plain version, and the scale."""
    kind, bargs, sargs = CELLS[label]
    basis = (AtomicBasis if kind == "atomic" else DiatomicBasis)(**bargs)
    ops = basis.build_operators(dev)
    scf = scf_atom if kind == "atomic" else scf_diatomic
    kw = dict(sargs)
    nela, nelb = kw.pop("nela"), kw.pop("nelb")
    gate = warm_gate(kw["convthr"])
    with capture_warm(keep_inputs=True) as calls:
        res = scf(basis, nela, nelb, ops=ops, **kw)
    steps = []
    for call in calls:
        E, _, off = refine_eig_plain(*call["args"])
        steps.append({"k11": call["off"].tolist(), "plain": off.tolist(),
                      "scale": unpadded_scale(E)})
    if out is not None and len(calls) > 1:
        A, V0, npass, tau, groups = calls[-1]["args"]
        np.savez(out / f"{label.replace(' ', '_').replace('=', '')}.npz", A=A.cpu().numpy(),
                 V0=V0.cpu().numpy(), npass=npass, tau=tau, groups=groups, gate=gate)
    shape = list(calls[0]["args"][0].shape) if calls else None
    return {"cell": label, "E": res.E, "niter": res.niter, "converged": res.converged,
            "gate": gate, "blocks": shape, "steps": steps,
            "accepted_k11": sum(x < gate for s in steps for x in s["k11"]),
            "accepted_plain": sum(x < gate for s in steps for x in s["plain"]),
            "floor_over_scale": [min(s["plain"]) / s["scale"] for s in steps[1:]]}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--out", default="", help="directory for each cell's last K11 inputs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("warm_floor: needs an NVIDIA GPU")
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    for label in CELLS:
        print(json.dumps(cell_floor(label, dev, out)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
