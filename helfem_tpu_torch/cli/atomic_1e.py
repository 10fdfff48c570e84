"""`python -m helfem_tpu_torch.cli.atomic_1e`: one-electron atom of the
PyTorch/CUDA port -- exact per-l spectra and radial orbitals on the FEM
basis (helfem_tpu.cli.atomic_1e; reference: src/sadatom/1e.cpp, the
`1e_atom` binary). Diagonalizes H_l = T + Z V + l(l+1) T_l for each l <=
lmax and exports the eigenvalues, the orbital values on the radial
quadrature grid and the grid itself (radii and weights) to a checkpoint:
npz, or with a .chk/.h5/.hdf5 name the reference's HDF5 storage (needs
h5py).

The finite-nucleus option shapes the element grid only (an nelem0 sub-grid
resolving the nuclear size), as in the reference program, which keeps the
point-charge potential matrix (ref: src/sadatom/1e.cpp:97). helfem_tpu's
flags, plus --device: the whitening, the eigensolves and the orbitals'
contraction run there; the radial tables are built on the host.
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import is_hdf5, open_device
from helfem_tpu_torch.cli.atomic import NUCLEAR_MODELS


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.atomic_1e", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--Z", required=True, help="nuclear charge")
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--grid", type=int, default=4,
                   help="1 linear, 2 quadratic, 3 polynomial, 4 exponential")
    p.add_argument("--grid0", type=int, default=4, help="finite-nucleus sub-grid type")
    p.add_argument("--zexp", type=float, default=2.0)
    p.add_argument("--zexp0", type=float, default=2.0)
    p.add_argument("--nelem", type=int, required=True)
    p.add_argument("--nelem0", type=int, default=0)
    p.add_argument("--lmax", type=int, default=3)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--nquad", type=int, default=0)
    p.add_argument("--primbas", type=int, default=4)
    p.add_argument("--finitenuc", type=int, default=0,
                   help="0 point, 2 gaussian, 3 spherical, 4 hollow, 5 regularized")
    p.add_argument("--Rrms", type=float, default=0.0)
    p.add_argument("--neig", type=int, default=8,
                   help="eigenvalues printed per l (all are saved)")
    p.add_argument("--save", default="1e.chk",
                   help="checkpoint (.chk/.h5/.hdf5 -> HDF5, else npz) holding orbs_<l>, "
                        "E_<l>, r, wr")
    p.add_argument("--device", default="cuda",
                   help="torch device of the eigensolves (cuda or cpu)")
    args = p.parse_args(argv)

    import torch

    from helfem_tpu_torch.ops.fem import FEMBasis
    from helfem_tpu_torch.ops.grids import form_grid
    from helfem_tpu_torch.ops.polynomials import get_basis
    from helfem_tpu_torch.ops.radial import RadialBasis
    from helfem_tpu_torch.utils import checkpoint_h5
    from helfem_tpu_torch.utils.elements import get_Z

    device = open_device(args.device)
    if is_hdf5(args.save):
        checkpoint_h5.require_h5py()
    Z = get_Z(args.Z)
    nucmodel = NUCLEAR_MODELS[args.finitenuc]
    nquad = args.nquad if args.nquad else 5 * args.nnodes
    poly = get_basis(args.primbas, args.nnodes)
    bval = form_grid(nucmodel, args.Rrms, args.nelem, args.Rmax, args.grid, args.zexp,
                     args.nelem0, args.grid0, args.zexp0, Z)
    fem = FEMBasis(poly, bval, drop_first=True, drop_last=True)
    rb = RadialBasis(fem, nquad)

    def dev(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    w, U = torch.linalg.eigh(dev(rb.overlap()))
    Sinvh = U @ torch.diag(w**-0.5) @ U.T
    T, Tl, V = dev(rb.kinetic()), dev(rb.kinetic_l()), dev(rb.nuclear())
    # the basis functions at the quadrature points of each element, with a
    # zero column for the dropped end functions
    gidx = torch.as_tensor(np.asarray(fem.gidx), device=device).long()
    B = dev(rb.b)  # [nelem, nq, nprim]

    # grid radii and weights, element-stacked like the reference export
    out = {"r": rb.r.ravel(), "wr": rb.wr.ravel()}
    for l in range(args.lmax + 1):
        H = Sinvh.T @ (T + Z * V + l * (l + 1) * Tl) @ Sinvh
        E, Cw = torch.linalg.eigh(0.5 * (H + H.T))
        C = Sinvh @ Cw
        # orbital values u_nl(r)/r on the quadrature grid (get_bf = B/r)
        Cpad = torch.cat([C, torch.zeros((1, C.shape[1]), dtype=C.dtype, device=device)])
        orbs = torch.einsum("eqi,eik->eqk", B, Cpad[gidx]).reshape(-1, C.shape[1])
        E = E.cpu().numpy()
        out[f"E_{l}"] = E
        out[f"orbs_{l}"] = orbs.cpu().numpy()
        print(f"l={l} eigenvalues")
        for n in range(min(args.neig, len(E))):
            exact = -0.5 * Z * Z / (n + l + 1) ** 2
            print(f"  {E[n]: .12e}   (hydrogenic point-nucleus {exact: .6e})")

    if is_hdf5(args.save):
        with checkpoint_h5.require_h5py().File(args.save, "w") as f:
            checkpoint_h5._w_vec(f, "r", out["r"])
            checkpoint_h5._w_vec(f, "wr", out["wr"])
            for l in range(args.lmax + 1):
                checkpoint_h5._w_vec(f, f"E_{l}", out[f"E_{l}"])
                checkpoint_h5._w_mat(f, f"orbs_{l}", out[f"orbs_{l}"])
    else:
        np.savez(args.save, **out)
    print(f"saved {args.save}")
    return out


if __name__ == "__main__":
    main()
