"""`python -m helfem_tpu_torch.cli.diatomic_dline`: electron density along the
internuclear axis from a diatomic checkpoint, in the PyTorch/CUDA port
(helfem_tpu.cli.diatomic_dline; reference: diatomic_dline,
src/diatomic/density_line.cpp). helfem_tpu's flags, plus --device: the
density's contraction at the points runs there; the checkpoint is read and
the basis values at the points are made on the host.
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import is_hdf5, open_device


def checkpoint_density(path: str):
    """(basis, total density P [nbf, nbf]) of a diatomic checkpoint: npz
    from the port or helfem_tpu (its block orbitals and occupations, twice
    alpha's when restricted), or a reference-schema HDF5 file, upstream
    HelFEM's too (its P, lifted to the padded layout; needs h5py)."""
    from helfem_tpu_torch.utils import checkpoint, checkpoint_h5

    if is_hdf5(path):
        return checkpoint_h5.load_diatomic_chk_density(path)
    basis, d = checkpoint.load_diatomic(path)
    P = checkpoint.density_from_blocks_dia(basis, d["orbs_a"], d["occ_a"])
    if d["orbs_b"].size:
        P = P + checkpoint.density_from_blocks_dia(basis, d["orbs_b"], d["occ_b"])
    else:
        P = 2.0 * P
    return basis, P


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.diatomic_dline",
                                description=__doc__, allow_abbrev=False)
    p.add_argument("--load", required=True,
                   help="diatomic checkpoint: npz from the port or helfem_tpu, or a "
                        "reference-schema HDF5 file (.chk/.h5/.hdf5), incl. ones written "
                        "by upstream HelFEM")
    p.add_argument("--output", default="density_line.dat")
    p.add_argument("--npts", type=int, default=200)
    p.add_argument("--zmax", type=float, default=0.0, help="0 = 3 Rhalf")
    p.add_argument("--device", default="cuda", help="torch device of the contraction")
    args = p.parse_args(argv)

    from helfem_tpu_torch.models.diatomic_tools import density_line

    device = open_device(args.device)
    basis, P = checkpoint_density(args.load)
    z, n = density_line(basis, P, npts=args.npts, zmax=args.zmax if args.zmax > 0 else None,
                        device=device)
    np.savetxt(args.output, np.column_stack([z, n]))
    print(f"density line ({args.npts} points) written to {args.output}")
    return z, n


if __name__ == "__main__":
    main()
