"""`python -m helfem_tpu_torch.cli.gensap`: spherically averaged atoms and
SAP potential generation, the restricted program of the PyTorch/CUDA port.

A subset of helfem_tpu.cli.gensap (flag names mirror the reference gensap,
src/sadatom/main.cpp:101-143), plus --device. It runs the restricted solver
with its occupation search and writes the SAP table result_<El>.dat;
--savepot, --saveorb and --saveing write the xc potential, the orbitals and
the xc ingredients. Flags of the JAX CLI that it does not cover (the
unrestricted program, charges, finite nuclei, confinement, ...) are rejected
with NotImplementedError.
"""

import argparse
import time

import numpy as np

from helfem_tpu_torch.cli._common import open_device, reject_unported

# helfem_tpu.cli.gensap flags outside this slice
_UNPORTED_FLAGS = (
    "unrestricted", "restricted", "M", "scan", "Q", "finitenuc", "Rrms", "nelem0", "grid0",
    "zexp0", "iconf", "conf_N", "conf_R", "conf_barrier", "shift_conf", "add_conf", "zeroder",
    "completeness", "x_pars", "c_pars", "diisthr", "taylor_order",
)
BOHR_A = 0.529177210903
SHELLS = "spdfgh"


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.gensap", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--Z", required=True, help="nuclear charge (number or symbol)")
    p.add_argument("--lmax", type=int, default=3)
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--zexp", type=float, default=2.0)
    p.add_argument("--nelem", type=int, default=10)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--primbas", type=int, default=4,
                   help="primitive polynomial basis id (3 Legendre, 4 LIP, 5 HIP, "
                        "6-11 general HIP, 100/101 Chebyshev nodes)")
    p.add_argument("--nquad", type=int, default=0,
                   help="quadrature points per element (0 = 5*nnodes)")
    p.add_argument("--maxit", type=int, default=128)
    p.add_argument("--convthr", type=float, default=1e-7)
    p.add_argument("--shift", type=float, default=1.0,
                   help="level shift for the initial SCF iterations, dropped once the "
                        "DIIS error is below 1e-3")
    p.add_argument("--method", default="lda_x", help="xc method for the SAP potential")
    p.add_argument("--iguess", type=int, default=3,
                   help="guess potential: 0 core, 1 GSZ, 2 SAP, 3 TF (SAP solves the "
                        "atom's own SAP table first)")
    p.add_argument("--dftthr", type=float, default=1e-12,
                   help="density threshold for the xc evaluation")
    p.add_argument("--diisorder", type=int, default=10, help="DIIS history length")
    p.add_argument("--diiseps", type=float, default=0.1,
                   help="DIIS error below which extrapolation starts mixing in")
    p.add_argument("--nosearch", action="store_true", help="skip occupation search")
    p.add_argument("--occs", default="auto",
                   help="'auto' (search), 'hf' (Saito 2009 table), or per-l electron "
                        "counts like '7,12,5,0'")
    p.add_argument("--output", default="", help="result_<El>.dat path (default auto)")
    p.add_argument("--saveing", action="store_true",
                   help="write the xc-ingredient table xcing_<El>.dat")
    p.add_argument("--saveorb", action="store_true",
                   help="write radial orbital coefficients per l channel")
    p.add_argument("--savepot", action="store_true",
                   help="write the multiplicative xc potential to xcpot.dat")
    p.add_argument("--pot", default="none",
                   help="compute the exported result_<El>.dat potential with THIS "
                        "functional instead of the SCF one")
    p.add_argument("--vdwthr", type=float, default=1e-3,
                   help="density threshold for the van der Waals radius")
    p.add_argument("--eps_el", type=float, default=0.073416683704840394115,
                   help="electron count outside the electron-count radius (default: "
                        "H-atom value matching the 1e-3 vdW threshold, Rahm 2016)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their plain "
                        "PyTorch versions")
    args, extra = p.parse_known_args(argv)
    reject_unported(extra, _UNPORTED_FLAGS, p.prog)

    import torch

    from helfem_tpu_torch.models.sadatom import (
        SadAtomBasis,
        coulomb_screening,
        electron_count_radius,
        kinetic_energy_density,
        occupied_orbital_table,
        radial_density,
        solve_sadatom,
        vdw_radius,
        xc_ingredients,
        xc_potential_table,
        xc_screening,
    )
    from helfem_tpu_torch.models.sadconf import get_configuration
    from helfem_tpu_torch.ops.xc import parse_method
    from helfem_tpu_torch.utils.elements import HARTREE_IN_EV, SYMBOLS, get_Z
    from helfem_tpu_torch.utils.timer import Timer

    device = open_device(args.device)
    Z = get_Z(args.Z)
    guess = {0: "core", 1: "GSZ", 2: "SAP", 3: "TF"}[args.iguess]
    # --pot computes the exported screening with another functional than
    # the SCF's (reference: main.cpp:672-678)
    funcs, _ = parse_method(args.method)
    pot_funcs = funcs if args.pot == "none" else parse_method(args.pot)[0]
    occs = None
    if args.occs == "hf":
        # Saito 2009 table occupations (reference: main.cpp:561-576 occs=hf)
        conf = get_configuration(Z)
        if conf[args.lmax + 1:].any():
            raise SystemExit(f"--occs hf for Z={Z} needs lmax >= 3")
        occs = conf[: args.lmax + 1]
        print(f"Saito 2009 occupations for {SYMBOLS[Z]}: {list(occs)}")
    elif args.occs != "auto":
        occs = np.array([int(x) for x in args.occs.replace(",", " ").split()])
        if len(occs) != args.lmax + 1:
            raise SystemExit(f"--occs needs {args.lmax + 1} entries")
    if args.pot != "none":
        print(f"exported potential computed with {args.pot}")

    timer = Timer()
    basis = SadAtomBasis(Z=Z, lmax=args.lmax, rmax=args.Rmax, nelem=args.nelem,
                         nnodes=args.nnodes, primbas=args.primbas, nquad=args.nquad,
                         igrid=args.grid, zexp=args.zexp)
    walls = {"basis": timer.lap("basis set formation")}
    ops = basis.build_ops(device)
    walls["operators"] = timer.lap("operator build")
    t0 = time.perf_counter()
    res = solve_sadatom(
        basis, nel=Z, method=args.method, occs=occs, maxit=args.maxit, convthr=args.convthr,
        guess=guess, verbose=True, ops=ops, search=not args.nosearch, shift=args.shift,
        dftthr=args.dftthr, diisorder=args.diisorder, diiseps=args.diiseps,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls["solve"] = time.perf_counter() - t0
    timer.lap("SCF")
    res.walls = walls
    if res.conf_list and len(res.conf_list) > 1:
        # energy-ordered configuration list (reference: main.cpp:350-365)
        print(f"\nMinimal energy configurations for {SYMBOLS[Z]}")
        E0 = res.conf_list[0][1]
        for i, (key, E, conv) in enumerate(res.conf_list):
            line = f" {' '.join(f'{n:2d}' for n in key)}  {E:+.10f}"
            if i > 0:
                line += f" {(E - E0) * HARTREE_IN_EV:11.6f}"
            if not conv:
                line += "  convergence failure"
            print(line)
    occstr = " ".join(f"{SHELLS[l]}^{n}" for l, n in enumerate(res.occs) if n)
    print(f"\nConfiguration: {occstr}")
    # per-orbital <r^i> moments and density-maximum radius (reference:
    # OrbitalChannel::Print, src/sadatom/solver.cpp:152-186)
    hdr = f"{'nl':>3s} {'nocc':>4s} {'E':>16s}"
    for i in (-2, -1, 1, 2, 3):
        hdr += f" {'<r>(' + str(i) + ')':>12s}"
    print(hdr + f" {'r(max)':>12s}")
    for row in occupied_orbital_table(basis, res.occs, res.orbE, res.orbs):
        line = f"{row['n']:2d}{SHELLS[row['l']]} {row['nocc']:4d} " + "% 16.9f" % row["E"]
        for i in (-2, -1, 1, 2, 3):
            line += " %e" % row["moments"][i]
        print(line + " %e" % row["rmax"])
    print("Etot  = % 18.9f" % res.E)
    print("Ekin  = % 18.9f" % res.Ekin)
    print("Ecoul = % 18.9f" % res.Ecoul)
    print("Eenuc = % 18.9f" % (res.E - res.Ekin - res.Ecoul - res.Exx - res.Exc))
    print("Exc   = % 18.9f" % (res.Exx + res.Exc))

    Prad = res.Pl.sum(axis=0)
    # vdW and electron-count radii (reference: main.cpp:632-639)
    rvdw = vdw_radius(basis, Prad, args.vdwthr)
    print(f"\nEstimated vdW radius with density threshold {args.vdwthr:e} "
          f"is {rvdw:.6f} bohr = {rvdw * BOHR_A:.6f} A")
    print("Note that this criterion is sensitive to numerical noise.")
    rincl = electron_count_radius(basis, Prad, Z - args.eps_el)
    print(f"Estimated vdW radius with electron count threshold "
          f"{args.eps_el:e} is {rincl:.6f} bohr = {rincl * BOHR_A:.6f} A")

    # SAP potential table (reference: RestrictedPotential's 9 columns)
    r, n, dn, ln, wt = radial_density(basis, Prad)
    tau = kinetic_energy_density(basis, res.Pl)
    vcoul = coulomb_screening(basis, Prad)
    vxc = xc_screening(basis, Prad, pot_funcs)
    zeff = Z - (vcoul + vxc)
    order = np.argsort(r)
    path = args.output or f"result_{SYMBOLS[Z]}.dat"
    np.savetxt(path, np.column_stack([r, n, dn, ln, tau, vcoul, vxc, wt, zeff])[order])
    print(f"SAP potential written to {path}")
    if args.savepot:
        # restricted spin densities are Pl/2 (reference: main.cpp:666-668)
        rp, va, vb = xc_potential_table(basis, res.Pl / 2.0, res.Pl / 2.0, funcs)
        np.savetxt("xcpot.dat", np.column_stack([rp, va, vb]))
        print("xc potential written to xcpot.dat")
    if args.saveing:
        ing = xc_ingredients(basis, res.Pl)
        np.savetxt(f"xcing_{SYMBOLS[Z]}.dat", ing[np.argsort(ing[:, 0])])
        print(f"xc ingredients written to xcing_{SYMBOLS[Z]}.dat")
    if args.saveorb:
        for l in range(args.lmax + 1):
            np.savetxt(f"orbs_{SYMBOLS[Z]}_l{l}.dat", res.orbs[l])
        print("radial orbital coefficients written")
    if not res.converged:
        print("WARNING: SCF did not converge!")
    return res


if __name__ == "__main__":
    main()
