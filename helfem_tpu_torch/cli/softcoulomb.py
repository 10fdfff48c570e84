"""`python -m helfem_tpu_torch.cli.softcoulomb`: 1D soft-Coulomb eigenproblem
on FEM in the PyTorch/CUDA port (helfem_tpu.cli.softcoulomb; reference
model: src/harmonic/softcoulomb.cpp). helfem_tpu's flags, plus --device:
the whitening and the eigensolve run there.
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import open_device
from helfem_tpu_torch.cli.harmonic import fem_spectrum


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.softcoulomb", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--xmax", type=float, default=40.0)
    p.add_argument("--nelem", type=int, default=20)
    p.add_argument("--nnodes", type=int, default=12)
    p.add_argument("--nquad", type=int, default=0)
    p.add_argument("--neig", type=int, default=8)
    p.add_argument("--asoft", type=float, default=1.0, help="V = -1/sqrt(x^2+a^2)")
    p.add_argument("--device", default="cuda", help="torch device of the eigensolve")
    args = p.parse_args(argv)

    device = open_device(args.device)
    E = fem_spectrum(args.xmax, args.nelem, args.nnodes, args.nquad,
                     lambda x: -1.0 / np.sqrt(x**2 + args.asoft**2), device)
    print(" n  E")
    for n in range(args.neig):
        print(f"{n:2d}  {E[n]: .15e}")
    return E[: args.neig]


if __name__ == "__main__":
    main()
