"""`python -m helfem_tpu_torch.cli.gensap`: spherically averaged atoms and
SAP potential generation, the restricted program of the PyTorch/CUDA port.

A subset of helfem_tpu.cli.gensap (flag names mirror the reference gensap,
src/sadatom/main.cpp:101-143), plus --device. It runs the restricted solver
with its occupation search and writes the SAP table result_<El>.dat;
--savepot, --saveorb and --saveing write the xc potential, the orbitals and
the xc ingredients. --unrestricted (or --restricted -1/0) then runs the
spin-polarised solver, at a fixed multiplicity --M, with the Hund-rule
aufbau search or with the multiplicity scan (--scan), and writes the five
potential variants resultU/M/W/S/s_<El>.dat. Finite nuclei with their
sub-grid (--finitenuc, --Rrms, --nelem0, --grid0, --zexp0), the
confinement (--iconf family; Econf printed apart) and --zeroder run as in
helfem_tpu; --completeness writes the GTO and STO completeness and
importance profiles of every l channel (ops/lcao.py, their solves on the
device).
"""

import argparse

import numpy as np

from helfem_tpu_torch.cli._common import add_xc_flags, apply_pars_files, open_device

# the unrestricted potential variants: file tag -> potential_table mode
# (reference: src/sadatom/main.cpp:738-767)
VARIANTS = {"U": "mean", "M": "average", "W": "weighted", "S": "highspin", "s": "lowspin"}
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
    p.add_argument("--method", default="lda_x",
                   help="xc method of the SCF; a meta-GGA needs --pot with an LDA or GGA "
                        "for the exported potential, as in helfem_tpu")
    add_xc_flags(p, mdft=False)
    p.add_argument("--iguess", type=int, default=3,
                   help="guess potential: 0 core, 1 GSZ, 2 SAP, 3 TF (SAP solves the "
                        "atom's own SAP table first)")
    p.add_argument("--dftthr", type=float, default=1e-12,
                   help="density threshold for the xc evaluation")
    p.add_argument("--diisorder", type=int, default=10, help="DIIS history length")
    p.add_argument("--diiseps", type=float, default=0.1,
                   help="DIIS error below which extrapolation starts mixing in")
    p.add_argument("--diisthr", type=float, default=None,
                   help="DIIS error below which extrapolation is pure C2-DIIS "
                        "(unset = hard switch at diiseps)")
    p.add_argument("--nosearch", action="store_true", help="skip occupation search")
    p.add_argument("--occs", default="auto",
                   help="'auto' (search), 'hf' (Saito 2009 table), or per-l electron "
                        "counts like '7,12,5,0' (with --unrestricted: 2(lmax+1) spin-"
                        "resolved counts, or lmax+1 split by Hund's rules)")
    p.add_argument("--restricted", type=int, default=None,
                   help="1 restricted search, -1 unrestricted aufbau search, 0 unrestricted "
                        "multiplicity scan (the --unrestricted/--scan pair)")
    p.add_argument("--unrestricted", action="store_true",
                   help="spin-polarised solve; writes resultU/M/W/S/s_<El>.dat variants")
    p.add_argument("--M", type=int, default=0, help="spin multiplicity 2S+1 (0 = search)")
    p.add_argument("--scan", action="store_true",
                   help="with --unrestricted: full multiplicity scan")
    p.add_argument("--Q", type=int, default=0, help="total charge")
    p.add_argument("--output", default="", help="result_<El>.dat path (default auto)")
    p.add_argument("--completeness", action="store_true",
                   help="write GTO/STO completeness + importance profiles")
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
    p.add_argument("--zeroder", action="store_true",
                   help="drop the derivative DOF at Rmax too (Hermite bases)")
    p.add_argument("--taylor_order", type=int, default=-1,
                   help="accepted for reference parity; B(r)/r near the origin is "
                        "evaluated by exact polynomial division, so it has no effect")
    # finite nucleus and its sub-grid (reference: main.cpp:104-110)
    p.add_argument("--finitenuc", default="point",
                   help="point|gaussian|spherical|hollow|regularized")
    p.add_argument("--Rrms", type=float, default=0.0, help="nuclear rms radius")
    p.add_argument("--nelem0", type=int, default=0, help="nuclear sub-grid elements")
    p.add_argument("--grid0", type=int, default=2)
    p.add_argument("--zexp0", type=float, default=2.0)
    # confinement (reference: main.cpp:138-143)
    p.add_argument("--iconf", type=int, default=0,
                   help="1 polynomial, 2 exponential, 3 barrier, 4 Junquera")
    p.add_argument("--conf_N", type=int, default=0)
    p.add_argument("--conf_R", type=float, default=0.0)
    p.add_argument("--conf_barrier", type=float, default=0.0)
    p.add_argument("--shift_conf", type=float, default=0.0)
    p.add_argument("--add_conf", action="store_true",
                   help="insert an element boundary at the confinement onset")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their plain "
                        "PyTorch versions")
    args = p.parse_args(argv)

    from helfem_tpu_torch.models.sadatom import SadAtomBasis, sad_method
    from helfem_tpu_torch.models.sadconf import get_configuration, hund_rule
    from helfem_tpu_torch.ops.xc import parse_method
    from helfem_tpu_torch.utils.elements import SYMBOLS, get_Z
    from helfem_tpu_torch.utils.timer import Timer

    device = open_device(args.device)
    Z = get_Z(args.Z)
    nel = Z - args.Q
    if args.restricted is not None:
        args.unrestricted = args.restricted != 1
        args.scan = args.restricted == 0
    args.method = apply_pars_files(args.method, args.x_pars, args.c_pars)
    guess = {0: "core", 1: "GSZ", 2: "SAP", 3: "TF"}[args.iguess]
    # --pot computes the exported screening with another functional than
    # the SCF's (reference: main.cpp:672-678)
    funcs, _ = sad_method(args.method)  # a laplacian-level functional raises
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
    # spin-resolved occupations (reference: main.cpp:578-590, and Hund's
    # rules for lmax+1 entries, translate_occs at main.cpp:87-95)
    occs_u = None
    if occs is not None and args.unrestricted:
        if len(occs) == 2 * (args.lmax + 1):
            occs_u = (occs[: args.lmax + 1], occs[args.lmax + 1:])
        elif len(occs) == args.lmax + 1:
            occs_u = hund_rule(occs)
            print("Used Hund's rules to translate occupations into "
                  f"{list(occs_u[0])} + {list(occs_u[1])}")
        else:
            raise SystemExit(f"--occs needs {args.lmax + 1} or {2 * (args.lmax + 1)} entries")
        occs = None
    elif occs is not None and len(occs) != args.lmax + 1:
        raise SystemExit(f"--occs needs {args.lmax + 1} entries")
    if args.pot != "none":
        print(f"exported potential computed with {args.pot}")

    timer = Timer()
    basis = SadAtomBasis(
        Z=Z, lmax=args.lmax, rmax=args.Rmax, nelem=args.nelem, nnodes=args.nnodes,
        primbas=args.primbas, nquad=args.nquad, igrid=args.grid, zexp=args.zexp,
        finitenuc=args.finitenuc, Rrms=args.Rrms, nelem0=args.nelem0, igrid0=args.grid0,
        zexp0=args.zexp0, iconf=args.iconf, conf_N=args.conf_N, conf_R=args.conf_R,
        conf_barrier=args.conf_barrier, shift_conf=args.shift_conf,
        conf_boundary=args.shift_conf if (args.add_conf and args.iconf) else 0.0,
        zeroder=args.zeroder)
    walls = {"basis": timer.lap("basis set formation")}
    ops = basis.build_ops(device)
    walls["operators"] = timer.lap("operator build")
    solver_kw = dict(maxit=args.maxit, convthr=args.convthr, guess=guess, shift=args.shift,
                     dftthr=args.dftthr, diisorder=args.diisorder, diiseps=args.diiseps,
                     diisthr=args.diisthr, ops=ops)
    res = None
    if occs_u is None:
        res = restricted_leg(args, basis, Z, nel, occs, funcs, pot_funcs, solver_kw, walls)
    if args.unrestricted:
        r_u = unrestricted_leg(args, basis, Z, nel, occs_u, funcs, pot_funcs, solver_kw,
                               walls)
        if res is None:
            r_u.walls = walls
            return r_u
        res.spin_polarised = r_u
    return res


def _sync(device) -> None:
    """Wait for the card, so that a wall covers the device work."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def print_orbitals(basis, occs, orbE, orbs, restricted: bool = True) -> None:
    """Per-orbital <r^i> moments and density-maximum radius (reference:
    OrbitalChannel::Print, src/sadatom/solver.cpp:152-186)."""
    from helfem_tpu_torch.models.sadatom import occupied_orbital_table

    hdr = f"{'nl':>3s} {'nocc':>4s} {'E':>16s}"
    for i in (-2, -1, 1, 2, 3):
        hdr += f" {'<r>(' + str(i) + ')':>12s}"
    print(hdr + f" {'r(max)':>12s}")
    for row in occupied_orbital_table(basis, occs, orbE, orbs, restricted):
        line = f"{row['n']:2d}{SHELLS[row['l']]} {row['nocc']:4d} " + "% 16.9f" % row["E"]
        for i in (-2, -1, 1, 2, 3):
            line += " %e" % row["moments"][i]
        print(line + " %e" % row["rmax"])


def print_radii(args, basis, Prad, nel) -> None:
    """vdW and electron-count radii (reference: main.cpp:632-639)."""
    from helfem_tpu_torch.models.sadatom import electron_count_radius, vdw_radius

    rvdw = vdw_radius(basis, Prad, args.vdwthr)
    print(f"\nEstimated vdW radius with density threshold {args.vdwthr:e} "
          f"is {rvdw:.6f} bohr = {rvdw * BOHR_A:.6f} A")
    print("Note that this criterion is sensitive to numerical noise.")
    rincl = electron_count_radius(basis, Prad, nel - args.eps_el)
    print(f"Estimated vdW radius with electron count threshold "
          f"{args.eps_el:e} is {rincl:.6f} bohr = {rincl * BOHR_A:.6f} A")


def restricted_leg(args, basis, Z, nel, occs, funcs, pot_funcs, solver_kw, walls):
    """The restricted solve or search, its printout and the SAP table."""
    from helfem_tpu_torch.models.sadatom import (
        coulomb_screening,
        kinetic_energy_density,
        radial_density,
        solve_sadatom,
        xc_ingredients,
        xc_potential_table,
        xc_screening,
    )
    from helfem_tpu_torch.utils.elements import HARTREE_IN_EV, SYMBOLS
    from helfem_tpu_torch.utils.timer import Timer

    timer = Timer()
    res = solve_sadatom(basis, nel=nel, method=args.method, occs=occs, verbose=True,
                        search=not args.nosearch, **solver_kw)
    _sync(solver_kw["ops"].device)
    walls["solve"] = timer.lap("SCF")
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
    print_orbitals(basis, res.occs, res.orbE, res.orbs)
    # the confinement sits in the nuclear slot: Econf = <P, Vconf> apart
    Econf = 0.0 if basis.Vconf is None else float(np.sum(res.Pl.sum(axis=0) * basis.Vconf))
    res.Econf = Econf
    print("Etot  = % 18.9f" % res.E)
    print("Ekin  = % 18.9f" % res.Ekin)
    print("Ecoul = % 18.9f" % res.Ecoul)
    print("Eenuc = % 18.9f" % (res.E - res.Ekin - res.Ecoul - res.Exx - res.Exc - Econf))
    if basis.Vconf is not None:
        print("Econf = % 18.9f" % Econf)
    print("Exc   = % 18.9f" % (res.Exx + res.Exc))

    Prad = res.Pl.sum(axis=0)
    print_radii(args, basis, Prad, nel)

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
    if args.completeness:
        completeness_files(args, basis, Z, res, solver_kw["ops"].device)
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


def completeness_files(args, basis, Z: int, res, device) -> None:
    """GTO/STO completeness and importance profiles per l channel on 501
    exponents in [1e-5, 1e10] (helfem_tpu/cli/gensap.py:275-294; reference:
    gto/sto_{completeness,importance}_profile, src/sadatom/solver.cpp):
    completeness_<kind>_<El>.dat and importance_<kind>_<El>.dat, log10 of
    the exponent then one column per l."""
    from helfem_tpu_torch.ops.lcao import completeness_profile, importance_profile
    from helfem_tpu_torch.utils.elements import SYMBOLS

    expn = np.logspace(-5, 10, 501)
    for kind in ("GTO", "STO"):
        comp, imp = [np.log10(expn)], [np.log10(expn)]
        for l in range(args.lmax + 1):
            comp.append(completeness_profile(basis.rb, l, expn, kind, device))
            # (partially) occupied radial orbitals: 2(2l+1) electrons each
            occn = int(np.ceil(res.occs[l] / (2.0 * (2 * l + 1))))
            imp.append(importance_profile(basis.rb, np.asarray(res.orbs[l])[:, :occn], l,
                                          expn, kind, device))
        np.savetxt(f"completeness_{kind}_{SYMBOLS[Z]}.dat", np.column_stack(comp))
        np.savetxt(f"importance_{kind}_{SYMBOLS[Z]}.dat", np.column_stack(imp))
        print(f"{kind} completeness + importance profiles written")


def unrestricted_leg(args, basis, Z, nel, occs_u, funcs, pot_funcs, solver_kw, walls):
    """The spin-polarised solve: a fixed spin-resolved configuration, a
    fixed multiplicity with aufbau occupations, or the configuration search
    (reference: main.cpp:578-767); its printout, radii and the five
    potential-variant tables (beside --output when it names a path)."""
    import os

    from helfem_tpu_torch.models.sadatom import (
        potential_table,
        search_sadatom_unrestricted,
        solve_sadatom_unrestricted,
        xc_potential_table,
    )
    from helfem_tpu_torch.utils.elements import HARTREE_IN_EV, SYMBOLS
    from helfem_tpu_torch.utils.timer import Timer

    timer = Timer()
    if occs_u is not None:
        oa, ob = (np.asarray(o, dtype=int) for o in occs_u)
        r_u = solve_sadatom_unrestricted(basis, int(oa.sum()), int(ob.sum()),
                                         method=args.method, occs_a=oa, occs_b=ob,
                                         verbose=True, **solver_kw)
        M = int(oa.sum() - ob.sum() + 1)
        if not r_u.converged:
            print("WARNING: unrestricted solve did not converge")
    elif args.M > 0:
        nela = (nel + args.M - 1) // 2
        r_u = solve_sadatom_unrestricted(basis, nela, nel - nela, method=args.method,
                                         **solver_kw)
        M = args.M
        if not r_u.converged:
            raise SystemExit("unrestricted solve did not converge")
    else:
        r_u = search_sadatom_unrestricted(basis, nel=nel, method=args.method,
                                          mode="scan" if args.scan else "aufbau", **solver_kw)
        print(f"\nMinimal energy spin states for {SYMBOLS[Z]}")
        E0 = r_u.conf_list[0][1]
        for i, ((oa, ob), E, conv) in enumerate(r_u.conf_list):
            occfmt = " ".join(f"{n:2d}" for n in (*oa, *ob))
            line = f"{sum(oa) - sum(ob) + 1:2d}:  {occfmt}  {E:+.10f}"
            if i > 0:
                line += f" {(E - E0) * HARTREE_IN_EV:11.6f}"
            if not conv:
                line += "  convergence failure"
            print(line)
        M = int(sum(r_u.occs) - sum(r_u.occs_b) + 1)
    _sync(solver_kw["ops"].device)
    walls["unrestricted"] = timer.lap("unrestricted SCF")
    print(f"selected multiplicity {M}, E = {r_u.E:.9f}")
    for tag, occ, E, C in (("alpha", r_u.occs, r_u.orbE, r_u.orbs),
                           ("beta", r_u.occs_b, r_u.orbE_b, r_u.orbs_b)):
        if np.asarray(occ).any():
            print(f"{tag} orbitals:")
            print_orbitals(basis, occ, E, C, restricted=False)
    print_radii(args, basis, (r_u.Pl + r_u.Plb).sum(axis=0), nel)
    if args.savepot:
        rp, va, vb = xc_potential_table(basis, r_u.Pl, r_u.Plb, funcs)
        np.savetxt("xcpot.dat", np.column_stack([rp, va, vb]))
        print("xc potential written to xcpot.dat")
    for tag, mode in VARIANTS.items():
        path = os.path.join(os.path.dirname(args.output), f"result{tag}_{SYMBOLS[Z]}.dat")
        np.savetxt(path, potential_table(basis, r_u.Pl, r_u.Plb, pot_funcs, mode=mode))
        print(f"{mode} potential written to {path}")
    return r_u



if __name__ == "__main__":
    main()
