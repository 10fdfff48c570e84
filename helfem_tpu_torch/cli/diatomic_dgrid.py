"""`python -m helfem_tpu_torch.cli.diatomic_dgrid`: electron density on a
(z, rho) half-plane grid from a diatomic checkpoint, in the PyTorch/CUDA
port (helfem_tpu.cli.diatomic_dgrid; reference: diatomic_dgrid,
src/diatomic/density_grid.cpp). helfem_tpu's flags, plus --device: the
density's contraction at the points runs there.
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import open_device
from helfem_tpu_torch.cli.diatomic_dline import checkpoint_density


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.diatomic_dgrid",
                                description=__doc__, allow_abbrev=False)
    p.add_argument("--load", required=True,
                   help="diatomic checkpoint: npz from the port or helfem_tpu, or a "
                        "reference-schema HDF5 file (.chk/.h5/.hdf5), incl. ones written "
                        "by upstream HelFEM")
    p.add_argument("--output", default="density_grid.dat")
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--nrho", type=int, default=50)
    p.add_argument("--zmax", type=float, default=0.0, help="0 = 3 Rhalf")
    p.add_argument("--rhomax", type=float, default=0.0, help="0 = 2 Rhalf")
    p.add_argument("--device", default="cuda", help="torch device of the contraction")
    args = p.parse_args(argv)

    from helfem_tpu_torch.models.diatomic_tools import density_grid

    device = open_device(args.device)
    basis, P = checkpoint_density(args.load)
    z, rho, n = density_grid(basis, P, nz=args.nz, nrho=args.nrho,
                             zmax=args.zmax if args.zmax > 0 else None,
                             rhomax=args.rhomax if args.rhomax > 0 else None, device=device)
    # rows: z rho n (the reference's whitespace .dat layout)
    Z, R = np.meshgrid(z, rho, indexing="ij")
    np.savetxt(args.output, np.column_stack([Z.ravel(), R.ravel(), n.ravel()]))
    print(f"density grid ({args.nz} x {args.nrho}) written to {args.output}")
    return z, rho, n


if __name__ == "__main__":
    main()
