"""`python -m helfem_tpu_torch.cli.diatomic`: diatomic HF/DFT SCF program of
the PyTorch/CUDA port.

A subset of helfem_tpu.cli.diatomic (flag names mirror the reference
`diatomic` program, src/diatomic/main.cpp:89-143), plus --device. The port
runs HF, LDA, GGA, meta-GGA and laplacian-level (BR89) functionals and
their global hybrids,
restricted, unrestricted (--restricted 0, the default for nela != nelb) or
ROHF (--restricted 1 with nela != nelb), from the core, SAP, GSZ or TF
guess, in axial electric (--Ez), quadrupole (--Qzz) and magnetic (--Bz)
fields and with finite nuclei (--finitenuc, --Rrms1, --Rrms2); flags of the
JAX CLI that it does not cover are rejected with
NotImplementedError. The per-iteration and final-energy lines match the JAX
CLI's.
"""

import argparse
import time

from helfem_tpu_torch.cli._common import (
    add_xc_flags,
    apply_pars_files,
    open_device,
    parse_nela_nelb,
    reject_unported,
)

# helfem_tpu.cli.diatomic flags outside this slice
_UNPORTED_FLAGS = (
    "lpad", "diag", "maverage", "save", "load", "symmetry", "readocc", "trace", "ndev",
)


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.diatomic", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--Z1", required=True, help="nuclear charge (number or symbol)")
    p.add_argument("--Z2", required=True)
    p.add_argument("--Rbond", type=float, required=True)
    p.add_argument("--angstrom", action="store_true")
    p.add_argument("--nela", type=int, default=0)
    p.add_argument("--nelb", type=int, default=0)
    p.add_argument("--Q", type=int, default=0, help="molecular charge")
    p.add_argument("--M", type=int, default=0, help="spin multiplicity 2S+1 (0 = lowest)")
    p.add_argument("--lmax", required=True, help="lmax, or comma list per |m|")
    p.add_argument("--mmax", type=int, default=-1,
                   help="maximum m; if >= 0, --lmax must be a single value applied "
                        "to every |m| <= mmax")
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--zexp", type=float, default=2.0)
    p.add_argument("--nelem", type=int, required=True)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--primbas", type=int, default=4,
                   help="primitive polynomial basis id (3 Legendre, 4 LIP, 5 HIP, "
                        "6-11 general HIP, 100/101 Chebyshev nodes)")
    p.add_argument("--nquad", type=int, default=0)
    p.add_argument("--maxit", type=int, default=50)
    p.add_argument("--convthr", type=float, default=1e-7)
    p.add_argument("--method", default="HF",
                   help="HF, LDA, SVWN, PBE, revPBE, PBEsol, RPBE, BLYP, TPSS, SCAN, rSCAN, "
                        "the hybrids PBE0/PBEh, TPSSh and B3LYP5, the laplacian-level BR89 "
                        "exchange mgga_x_br89, or an 'x,c' pair (e.g. "
                        "'mgga_x_br89,gga_c_lyp'); range separation exists on atoms only")
    p.add_argument("--guess", default="core", help="core, SAP, TF or GSZ")
    p.add_argument("--iguess", type=int, default=None,
                   help="guess by reference id: 0 core, 1 GSZ, 2 SAP, 3 TF; "
                        "overrides --guess")
    p.add_argument("--dftthr", type=float, default=1e-12)
    p.add_argument("--ldft", type=int, default=0,
                   help="eta rule order for the dft grid (0 = auto)")
    add_xc_flags(p)
    p.add_argument("--restricted", type=int, default=-1,
                   help="-1 auto, 0 unrestricted, 1 restricted (ROHF if open shell)")
    p.add_argument("--perturb", type=float, default=0.0,
                   help="random orthogonal rotation amplitude for the guess orbitals")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diisorder", type=int, default=10, help="DIIS history length")
    p.add_argument("--diiseps", type=float, default=0.1,
                   help="DIIS error below which extrapolation starts mixing in")
    p.add_argument("--diisthr", type=float, default=None,
                   help="DIIS error below which extrapolation is pure C2-DIIS; "
                        "between diisthr and diiseps the DIIS/ADIIS weights are "
                        "blended on the reference's sliding scale "
                        "(src/general/diis.cpp:241); unset = hard switch at diiseps")
    p.add_argument("--Ez", type=float, default=0.0, help="electric field along the bond")
    p.add_argument("--Qzz", type=float, default=0.0, help="quadrupole field strength")
    p.add_argument("--Bz", type=float, default=0.0, help="magnetic field along the bond")
    p.add_argument("--finitenuc", default="point",
                   help="nuclear model: point|gaussian|spherical|hollow|regularized")
    p.add_argument("--Rrms1", type=float, default=0.0, help="nucleus 1 rms radius")
    p.add_argument("--Rrms2", type=float, default=0.0, help="nucleus 2 rms radius")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their "
                        "plain PyTorch versions")
    args, extra = p.parse_known_args(argv)
    reject_unported(extra, _UNPORTED_FLAGS, p.prog)

    import torch

    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.utils.elements import ANGSTROM_IN_BOHR, HARTREE_IN_EV, get_Z
    from helfem_tpu_torch.utils.timer import Timer

    device = open_device(args.device)
    Z1, Z2 = get_Z(args.Z1), get_Z(args.Z2)
    R = args.Rbond * (ANGSTROM_IN_BOHR if args.angstrom else 1.0)
    if args.mmax >= 0:
        if "," in str(args.lmax):
            raise SystemExit("--mmax requires a single --lmax value")
        lmax = (int(args.lmax),) * (args.mmax + 1)
    else:
        lmax = tuple(int(x) for x in str(args.lmax).split(","))
    if args.iguess is not None:
        args.guess = {0: "core", 1: "GSZ", 2: "SAP", 3: "TF"}[args.iguess]
    nela, nelb = parse_nela_nelb(Z1 + Z2, args.Q, args.M, args.nela, args.nelb)
    args.method = apply_pars_files(args.method, args.x_pars, args.c_pars)

    timer = Timer()
    basis = DiatomicBasis(
        Z1=Z1, Z2=Z2, Rbond=R, lmax=lmax, rmax=args.Rmax, nelem=args.nelem,
        nnodes=args.nnodes, primbas=args.primbas, nquad=args.nquad, igrid=args.grid,
        zexp=args.zexp,
    )
    walls = {"basis": timer.lap("basis set formation")}
    print(f"Running {args.method} on Z1={Z1} Z2={Z2} R={R} with {nela}+{nelb} electrons")
    print(f"{basis.nang} angular shells x {basis.nrad} radial functions; "
          f"{len(basis.lm_map)} (L,|M|) channels")
    # an axial electric field couples even and odd l: no g/u blocks
    ops = basis.build_operators(device, parity=args.Ez == 0.0)
    walls["operators"] = timer.lap("operator build")
    t0 = time.perf_counter()
    res = scf_diatomic(
        basis, nela, nelb, method=args.method, maxit=args.maxit, convthr=args.convthr,
        verbose=True, ops=ops, guess=args.guess, restricted=args.restricted,
        perturb=args.perturb, seed=args.seed, diisorder=args.diisorder,
        diiseps=args.diiseps, dftthr=args.dftthr, ldft=args.ldft, diisthr=args.diisthr,
        Ez=args.Ez, Qzz=args.Qzz, Bz=args.Bz, finitenuc=args.finitenuc, Rrms1=args.Rrms1,
        Rrms2=args.Rrms2,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls["scf"] = time.perf_counter() - t0
    timer.lap("SCF")
    res.walls = walls
    print()
    for name, val in [
        ("Kinetic", res.Ekin), ("Nuclear attraction", res.Enucattr),
        ("Nuclear repulsion", res.Enucrep), ("Coulomb", res.Ecoul),
        ("Exact exchange", res.Exx), ("Exchange-correlation", res.Exc),
        ("Total", res.E),
    ]:
        print(f"{name:<21s} energy: % .16f" % val)
    print(f"{'Virial ratio':<21s}       : % .16f" % (-res.E / res.Ekin))
    print(f"{'Electrons on grid':<21s}       : % .16f" % res.Nelgrid)
    spins = [("", nela, res.orbE_a, res.orbsym_a)]
    if res.orbE_b is not None:
        spins = [("alpha ", nela, res.orbE_a, res.orbsym_a),
                 ("beta ", nelb, res.orbE_b, res.orbsym_b)]
    for spin, nel, orbE, orbsym in spins:
        nshow = min(nel + 2, len(orbE))
        print(f"\n{spin}occupied + lowest virtual orbital energies:")
        for i in range(nshow):
            tag = "occ" if i < nel else "vir"
            print(f"  {i + 1:3d} {orbsym[i]:>8s}  % .9f  {tag}" % orbE[i])
        if 0 < nel < len(orbE):
            gap = (orbE[nel] - orbE[nel - 1]) * HARTREE_IN_EV
            print(f"{spin}HOMO-LUMO gap: {gap:.3f} eV")
    if not res.converged:
        print("WARNING: SCF did not converge!")
    return res


if __name__ == "__main__":
    main()
