"""`python -m helfem_tpu_torch.cli.diatomic_cbasis`: the per-m angular basis
needed to converge the occupied core (one-electron) orbitals of a diatomic
to a series of thresholds, in the PyTorch/CUDA port
(helfem_tpu.cli.diatomic_cbasis; flags mirror src/diatomic/corebasis.cpp:
118-137). helfem_tpu's flags, plus --device: the core Hamiltonian's
eigensolves run there; the one-electron operators are built on the host.
"""

import argparse

from helfem_tpu_torch.cli._common import open_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.diatomic_cbasis",
                                description=__doc__, allow_abbrev=False)
    p.add_argument("--Z1", required=True)
    p.add_argument("--Z2", required=True)
    p.add_argument("--Rbond", type=float, required=True)
    p.add_argument("--angstrom", action="store_true")
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--zexp", type=float, default=1.0)
    p.add_argument("--nelem", type=int, default=1)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--thresh", type=int, default=10, help="scan 1e-1 .. 1e-thresh")
    p.add_argument("--nadd", type=int, default=2, help="functions added per step")
    p.add_argument("--device", default="cuda", help="torch device of the eigensolves")
    args = p.parse_args(argv)

    from helfem_tpu_torch.models.diatomic_tools import core_basis_scan, num_orbs
    from helfem_tpu_torch.utils.elements import ANGSTROM_IN_BOHR, SYMBOLS, get_Z

    device = open_device(args.device)
    Z1, Z2 = get_Z(args.Z1), get_Z(args.Z2)
    R = args.Rbond * (ANGSTROM_IN_BOHR if args.angstrom else 1.0)
    if args.nadd % 2:
        print("WARNING: odd nadd unbalances gerade/ungerade convergence.")
    names = "sigma pi delta phi".split()
    occ = " ".join(f"{n} {names[m]}" for m, n in enumerate(num_orbs(Z1, Z2)))
    print(f"Core basis for {SYMBOLS[Z1]}-{SYMBOLS[Z2]} at R = {R:g}: {occ} orbitals")
    results = core_basis_scan(Z1, Z2, R, thresh=args.thresh, nadd=args.nadd, rmax=args.Rmax,
                              nelem=args.nelem, nnodes=args.nnodes, igrid=args.grid,
                              zexp=args.zexp, verbose=True, device=device)
    print("\nthreshold   lmax per m-type")
    for thr, lm in results:
        print(f"  {thr:.0e}    {list(lm)}")
    return results


if __name__ == "__main__":
    main()
