"""`python -m helfem_tpu_torch.cli.atomic`: atomic HF SCF driver of the
PyTorch/CUDA port.

A subset of helfem_tpu.cli.atomic (flag names mirror the reference `atomic`
program, src/atomic/main.cpp:63-119), plus --device. Flags of the JAX CLI
that this slice does not cover are rejected with NotImplementedError. The
per-iteration and final-energy lines match the JAX CLI's.
"""

import argparse
import time

from helfem_tpu_torch.cli._common import open_device, parse_nela_nelb, reject_unported

# helfem_tpu.cli.atomic flags outside this slice
_UNPORTED_FLAGS = (
    "Zl", "Zr", "Rmid", "nela", "nelb", "Q", "M", "nquad", "nelem0", "grid0",
    "zexp0", "add_conf", "load", "readocc", "Ez", "Qzz", "Bz", "finitenuc",
    "Rrms", "iconf", "conf_N", "conf_R", "conf_barrier", "shift_conf", "save",
    "dftthr", "restricted", "symmetry", "maverage", "perturb", "seed",
    "dampfock", "dampthr", "diag", "eigiter", "diisthr", "ldft", "mdft",
    "angstrom", "x_pars", "c_pars", "zeroder", "trace", "ndev", "taylor_order",
)


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.atomic", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--Z", required=True, help="nuclear charge (number or symbol)")
    p.add_argument("--lmax", type=int, required=True)
    p.add_argument("--mmax", type=int, required=True)
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--zexp", type=float, default=2.0)
    p.add_argument("--nelem", type=int, required=True)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--primbas", type=int, default=4,
                   help="primitive polynomial basis id (3 Legendre, 4 LIP, "
                        "5 HIP, 6-11 general HIP, 100/101 Chebyshev nodes)")
    p.add_argument("--maxit", type=int, default=50)
    p.add_argument("--convthr", type=float, default=1e-7)
    p.add_argument("--method", default="HF")
    p.add_argument("--iguess", type=int, default=2,
                   help="0 core, 1 GSZ, 2 SAP, 3 TF")
    p.add_argument("--diisorder", type=int, default=10, help="DIIS history length")
    p.add_argument("--diiseps", type=float, default=0.1,
                   help="DIIS error below which extrapolation starts mixing in")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their "
                        "plain PyTorch versions")
    args, extra = p.parse_known_args(argv)
    reject_unported(extra, _UNPORTED_FLAGS, p.prog)

    import torch

    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.scf.atomic_scf import hf_kfrac, scf_atom
    from helfem_tpu_torch.utils.elements import HARTREE_IN_EV, get_Z
    from helfem_tpu_torch.utils.timer import Timer

    device = open_device(args.device)
    hf_kfrac(args.method)  # raises for methods that are not ported
    Z = get_Z(args.Z)
    nela, nelb = parse_nela_nelb(Z, 0, 0, 0, 0)
    guess = {0: "core", 1: "GSZ", 2: "SAP", 3: "TF"}[args.iguess]

    timer = Timer()
    basis = AtomicBasis(
        Z=Z, lmax=args.lmax, mmax=args.mmax, rmax=args.Rmax, nelem=args.nelem,
        nnodes=args.nnodes, igrid=args.grid, zexp=args.zexp, primbas=args.primbas,
    )
    walls = {"basis": timer.lap("basis set formation")}
    print(f"Running {args.method} on Z={Z} with {nela}+{nelb} electrons, "
          f"{basis.nbf} basis functions ({basis.nang} angular x {basis.nrad} radial)")
    ops = basis.build_operators(device)
    walls["operators"] = timer.lap("operator build")
    t0 = time.perf_counter()
    res = scf_atom(
        basis, nela, nelb, method=args.method, maxit=args.maxit,
        convthr=args.convthr, guess=guess, verbose=True, ops=ops,
        diisorder=args.diisorder, diiseps=args.diiseps,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls["scf"] = time.perf_counter() - t0
    timer.lap("SCF")
    res.walls = walls
    print()
    for name, val in [
        ("Kinetic", res.Ekin), ("Nuclear attraction", res.Enuc),
        ("Coulomb", res.Ecoul), ("Exact exchange", res.Exx),
        ("Exchange-correlation", res.Exc), ("Field/confinement", res.Efield),
        ("Total", res.E),
    ]:
        print(f"{name:<21s} energy: % .16f" % val)
    print(f"{'Virial ratio':<21s}       : % .16f" % (-res.E / res.Ekin))
    if len(res.orbE_a) > nela and nela > 0:
        gap = (res.orbE_a[nela] - res.orbE_a[nela - 1]) * HARTREE_IN_EV
        print(f"HOMO-LUMO gap: {gap:.3f} eV")
    if res.orbsym_a is not None and nela > 0:
        nshow = min(nela + 2, len(res.orbE_a))
        print("occupied + lowest virtual orbital energies:")
        for i in range(nshow):
            tag = "occ" if i < nela else "vir"
            print(f"  {i + 1:3d} {res.orbsym_a[i]:>8s}  % .9f  {tag}" % res.orbE_a[i])
    if not res.converged:
        print("WARNING: SCF did not converge!")
    return res


if __name__ == "__main__":
    main()
