"""`python -m helfem_tpu_torch.cli.diatomic_1e`: one-electron diatomic
(H2+-like) exact diagonalization of the PyTorch/CUDA port
(helfem_tpu.cli.diatomic_1e; reference: src/diatomic/1e.cpp): the blocked
whitened eigensolve of T + V over the m and g/u symmetry blocks. helfem_tpu's
flags, plus --device: the eigensolve runs there; the one-electron operators
and the blocks' whitening are built on the host.
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import open_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.diatomic_1e", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--Z1", required=True)
    p.add_argument("--Z2", required=True)
    p.add_argument("--Rbond", type=float, required=True)
    p.add_argument("--lmax", default="12")
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--nelem", type=int, default=6)
    p.add_argument("--nnodes", type=int, default=12)
    p.add_argument("--primbas", type=int, default=4)
    p.add_argument("--neig", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device of the eigensolve")
    args = p.parse_args(argv)

    import torch

    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.utils.elements import get_Z
    from helfem_tpu_torch.utils.linalg import build_blocks, eig_blocks

    device = open_device(args.device)
    lmax = tuple(int(x) for x in str(args.lmax).split(","))
    b = DiatomicBasis(Z1=get_Z(args.Z1), Z2=get_Z(args.Z2), Rbond=args.Rbond, lmax=lmax,
                      rmax=args.Rmax, nelem=args.nelem, nnodes=args.nnodes,
                      primbas=args.primbas)
    # the operators' H0 and blocks as DiatomicBasis.host_operators makes them
    blk_idx, blk_sinvh = build_blocks(b.overlap(), b.sym_blocks(True))
    mv = b.shell_mask().reshape(-1)
    H0 = (b.kinetic() + b.nuclear()) * mv[:, None] * mv[None, :]

    def dev(x):
        return torch.as_tensor(x, device=device)

    E, _ = eig_blocks(dev(H0), dev(blk_idx), dev(blk_sinvh))
    E = np.sort(E.cpu().numpy().ravel())
    Enucrep = b.Z1 * b.Z2 / b.Rbond
    print(" n  E_el                  E_el + Z1 Z2 / R")
    for n in range(args.neig):
        print(f"{n:2d}  {E[n]: .15e} {E[n]+Enucrep: .15e}")
    return E[: args.neig]


if __name__ == "__main__":
    main()
