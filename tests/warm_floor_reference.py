"""helfem_tpu's warm eigensolve on the blocks of a fused SCF step recorded on
the card, beside the port's plain version on the same blocks, on the CPU.

Reads the .npz files that `python3 -m helfem_tpu_torch.tools.warm_floor
--out DIR` writes (one cell's last warm attempt: A, V0, npass, tau, groups,
gate) and prints per file and group of blocks (spin) the residual
certificate of helfem_tpu's _refine_passes (utils/linalg.py:21, npass + 1
sweeps as eigh_warm_with runs them, one call per group as helfem_tpu's
drivers make them), its eigh_warm decision against the gate, the port's
refine_eig_plain residual on the same blocks, and the scale max|E| of the
unpadded slots. A residual above the gate in helfem_tpu too puts the
floor in the algorithm and the data, not in the port.

Run from the repo root:
    JAX_PLATFORMS=cpu python3 tests/warm_floor_reference.py DIR
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from helfem_tpu.utils import linalg as jl  # noqa: E402
from helfem_tpu_torch.kernels import refine_eig_plain  # noqa: E402

jax.config.update("jax_enable_x64", True)
_BIG = 1e6  # the padded slots' eigenvalue (helfem_tpu_torch/utils/linalg.py)


def reference(path: Path) -> list[dict]:
    d = np.load(path)
    A, V0 = d["A"], d["V0"]
    npass, tau, groups, gate = int(d["npass"]), float(d["tau"]), int(d["groups"]), float(d["gate"])
    _, _, port = refine_eig_plain(torch.tensor(A), torch.tensor(V0), npass, tau, groups)
    rows = []
    for g, (Ag, Vg) in enumerate(zip(np.split(A, groups), np.split(V0, groups))):
        Aj, Vj = jnp.asarray(Ag), jnp.asarray(Vg)
        E0 = jnp.diagonal(jnp.swapaxes(Vj, -1, -2) @ Aj @ Vj, axis1=-2, axis2=-1)
        E, _, off = jl._refine_passes(Aj, E0, Vj, npass + 1, tau)
        good = bool(jl.eigh_warm(Aj, Vj, npass, tau, gate)[2])
        E = np.abs(np.asarray(E))
        rows.append({"file": path.name, "group": g, "blocks": list(Ag.shape), "gate": gate,
                     "helfem_tpu_off": float(off), "helfem_tpu_accepts": good,
                     "port_plain_off": float(port[g]), "scale": float(E[E < 0.5 * _BIG].max())})
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    for path in sorted(Path(argv[0]).glob("*.npz")):
        for row in reference(path):
            print(row, flush=True)


if __name__ == "__main__":
    main()
