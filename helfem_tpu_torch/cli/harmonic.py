"""`python -m helfem_tpu_torch.cli.harmonic`: 1D harmonic oscillator on FEM
in the PyTorch/CUDA port, a smoke test of the basis layers
(helfem_tpu.cli.harmonic; reference model: src/harmonic/main.cpp:17-137).
helfem_tpu's flags, plus --device: the whitening and the eigensolve run
there; the FEM matrices are built on the host.
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import open_device


def fem_spectrum(xmax: float, nelem: int, nnodes: int, nquad: int, potential, device):
    """Eigenvalues of T + V on the 1D LIP FEM basis of [-xmax, xmax] (nelem
    equal elements), V(x) a callable: S^-1/2 (T + V) S^-1/2 on `device`
    (helfem_tpu cli/harmonic.py:26-36)."""
    import torch

    from helfem_tpu_torch.ops.fem import FEMBasis
    from helfem_tpu_torch.ops.polynomials import get_basis
    from helfem_tpu_torch.ops.quadrature import chebyshev

    fem = FEMBasis(get_basis(4, nnodes), np.linspace(-xmax, xmax, nelem + 1))
    xq, wq = chebyshev(nquad or 5 * nnodes)
    S = fem.matrix_element(0, 0, xq, wq)
    T = 0.5 * fem.matrix_element(1, 1, xq, wq)
    V = fem.matrix_element(0, 0, xq, wq, f=potential(fem.coords(xq)))

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    w, U = torch.linalg.eigh(dev(S))
    Sinvh = U @ torch.diag(w**-0.5) @ U.T
    return torch.linalg.eigvalsh(Sinvh @ dev(T + V) @ Sinvh).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.harmonic", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--xmax", type=float, default=10.0)
    p.add_argument("--nelem", type=int, default=12)
    p.add_argument("--nnodes", type=int, default=12)
    p.add_argument("--nquad", type=int, default=0)
    p.add_argument("--neig", type=int, default=10)
    p.add_argument("--omega", type=float, default=1.0)
    p.add_argument("--device", default="cuda", help="torch device of the eigensolve")
    args = p.parse_args(argv)

    device = open_device(args.device)
    E = fem_spectrum(args.xmax, args.nelem, args.nnodes, args.nquad,
                     lambda x: 0.5 * args.omega**2 * x**2, device)
    print(" n  E_FEM                 E_exact              error")
    for n in range(args.neig):
        exact = args.omega * (n + 0.5)
        print(f"{n:2d}  {E[n]: .15e} {exact: .15e} {E[n]-exact: .3e}")
    return E[: args.neig]


if __name__ == "__main__":
    main()
