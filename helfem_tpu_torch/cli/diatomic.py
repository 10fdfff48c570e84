"""`python -m helfem_tpu_torch.cli.diatomic`: diatomic HF/DFT SCF program of
the PyTorch/CUDA port.

A subset of helfem_tpu.cli.diatomic (flag names mirror the reference
`diatomic` program, src/diatomic/main.cpp:89-143), plus --device. The port
runs HF, LDA, GGA, meta-GGA and laplacian-level (BR89) functionals and
their global hybrids,
restricted, unrestricted (--restricted 0, the default for nela != nelb) or
ROHF (--restricted 1 with nela != nelb), from the core, SAP, GSZ or TF
guess, in axial electric (--Ez), quadrupole (--Qzz) and magnetic (--Bz)
fields and with finite nuclei (--finitenuc, --Rrms1, --Rrms2), with the
SCF controls (--diag, --maverage, --symmetry, --readocc), followed by the
post-SCF analysis (multipoles, nuclear densities, occupied orbitals);
--trace writes a torch.profiler Chrome trace of the SCF. --save writes the
checkpoint after every host iteration and fused chunk and once at the end
(a .chk/.h5/.hdf5 path: the reference HDF5 schema at the end, npz
crash-recovery files beside it as <save>.crash.npz; HDF5 needs h5py);
--load warm-starts from a checkpoint, projected onto this basis when the
discretization differs (the same bond length). --ndev N runs the SCF over
N ranks (parallel/launch.py: gloo ranks on the CPU, NCCL with one card per
rank on CUDA), rank 0 printing and writing. The per-iteration,
final-energy and analysis lines match the JAX CLI's.
"""

import argparse
import time

from helfem_tpu_torch.cli._common import (
    add_xc_flags,
    apply_pars_files,
    crash_hook,
    is_hdf5,
    open_device,
    parse_nela_nelb,
    rank0_only,
    scf_on_ranks,
)


def main(argv=None):
    return rank0_only(_main, argv)


def _main(argv, writes: bool):
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
    p.add_argument("--lpad", type=int, default=10,
                   help="accepted for reference parity (Qlm recursion padding); the Q_lm "
                        "builder pads its downward recursion per point, so it has no effect")
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
    p.add_argument("--diag", type=int, default=1,
                   help="1: symmetric inverse square root whitening; 0: inverse Cholesky "
                        "whitening (reference --diag, src/diatomic/main.cpp:111)")
    p.add_argument("--maverage", action="store_true",
                   help="average the Fock matrix over +-m symmetry pairs every iteration")
    p.add_argument("--symmetry", type=int, default=-1,
                   help="0/1 m blocks only, 2 add gerade/ungerade; -1 auto (g/u for "
                        "homonuclear without an axial electric field)")
    p.add_argument("--readocc", type=int, default=0,
                   help="read per-symmetry-block occupations from occs.dat (lines 'na nb') "
                        "in the working directory, used until this iteration (<0: always)")
    p.add_argument("--trace", default="",
                   help="write a torch.profiler Chrome/Perfetto trace of the SCF to this "
                        "JSON file")
    p.add_argument("--save", default="",
                   help="write a checkpoint (after every host iteration and fused chunk and "
                        "at the end); a .chk/.h5/.hdf5 extension writes the reference HDF5 "
                        "schema at the end (needs h5py), anything else npz")
    p.add_argument("--load", default="",
                   help="warm start from a checkpoint (npz or reference-schema HDF5 by "
                        "extension)")
    p.add_argument("--ndev", type=int, default=0,
                   help="run the SCF over an N-device mesh: the Coulomb (L,M) channel scan, "
                        "the exchange (L,|M|) step scan, and the XC mu-element axis shard "
                        "over the mesh; the blocked eigensolve shards the symmetry-block axis "
                        "(the multi-chip replacement for the reference's OpenMP, "
                        "src/diatomic/basis.cpp:1560)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their "
                        "plain PyTorch versions")
    args, extra = p.parse_known_args(argv)
    if extra:
        raise SystemExit(f"{p.prog}: unrecognized arguments: {' '.join(extra)}")
    if not writes:
        args.save = ""

    import numpy as np
    import torch

    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.utils import checkpoint, checkpoint_h5
    from helfem_tpu_torch.utils.elements import ANGSTROM_IN_BOHR, HARTREE_IN_EV, get_Z
    from helfem_tpu_torch.utils.profiling import trace_scf
    from helfem_tpu_torch.utils.timer import Timer

    device = open_device(args.device)
    if is_hdf5(args.save) or is_hdf5(args.load):
        checkpoint_h5.require_h5py()  # before the SCF, not after it
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
    occs = None
    if args.readocc:
        occs = np.loadtxt("occs.dat", ndmin=2)
        if occs.shape[1] < 2:
            raise SystemExit("occs.dat needs at least two columns (na nb)")

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
    # the symmetry blocks (reference: src/diatomic/main.cpp:313-319): g/u
    # for homonuclear without an axial electric field, which couples even
    # and odd l; --symmetry 0/1 drop them, 2 keeps them unless Ez
    parity = args.Ez == 0.0
    if args.symmetry in (0, 1):
        parity = False
    elif args.symmetry == 2:
        if args.Ez != 0.0:
            print("Warning - asked for full orbital symmetry in presence of "
                  "electric field. Relaxing restriction.")
        else:
            parity = True
    ops = basis.build_operators(device, parity=parity, chol=not args.diag)
    walls["operators"] = timer.lap("operator build")
    P0a = P0b = None
    if is_hdf5(args.load):
        bold, d = checkpoint_h5.load_diatomic_chk(args.load)
        P0a, P0b = checkpoint_h5.warm_start_density_dia_h5(basis, bold, d)
        print(f"warm start from HDF5 checkpoint {args.load}")
    elif args.load:
        bold, d = checkpoint.load_diatomic(args.load)
        if bold.nbf == basis.nbf and bold.lmax == basis.lmax:
            # the file's own blocks (helfem_tpu takes this run's, and fails
            # when --Ez or --symmetry changed them)
            P0a = checkpoint.density_from_blocks_dia(bold, d["orbs_a"], d["occ_a"])
            if d["orbs_b"].size:
                P0b = checkpoint.density_from_blocks_dia(bold, d["orbs_b"], d["occ_b"])
            print(f"warm start from {args.load} (E = {float(d['E']):.9f})")
        else:
            # another discretization: the cross-basis restart projection
            P0a, P0b = checkpoint.warm_start_density_dia(basis, bold, d)
            print(f"cross-basis warm start from {args.load} (E = {float(d['E']):.9f})")
    if args.load:
        walls["load"] = timer.lap("checkpoint load and projection")
    kwargs = dict(
        method=args.method, maxit=args.maxit, convthr=args.convthr, verbose=True, ops=ops,
        guess=args.guess, restricted=args.restricted, perturb=args.perturb, seed=args.seed,
        diisorder=args.diisorder, diiseps=args.diiseps, dftthr=args.dftthr, ldft=args.ldft,
        diisthr=args.diisthr, Ez=args.Ez, Qzz=args.Qzz, Bz=args.Bz, finitenuc=args.finitenuc,
        Rrms1=args.Rrms1, Rrms2=args.Rrms2, occs=occs, readocc_until=args.readocc,
        diag=bool(args.diag), maverage=args.maverage, P0a=P0a, P0b=P0b,
    )
    t0 = time.perf_counter()
    with trace_scf(args.trace, device):
        if args.ndev:
            res, writes = scf_on_ranks(scf_diatomic, args.ndev, basis, nela, nelb, kwargs,
                                       args.save, checkpoint.save_diatomic, device)
        else:
            save_cb, writes = crash_hook(args.save, basis, checkpoint.save_diatomic)
            res = scf_diatomic(basis, nela, nelb, **kwargs,
                               save_cb=save_cb if args.save else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls["scf"] = time.perf_counter() - t0
    if args.trace:
        print(f"profiler trace written to {args.trace}")
    timer.lap("SCF")
    res.walls = walls
    res.checkpoint_writes = writes
    if args.save:
        t0 = time.perf_counter()
        if is_hdf5(args.save):
            checkpoint_h5.save_diatomic_chk(args.save, basis, res, nela, nelb)
        else:
            checkpoint.save_diatomic(args.save, basis, res)
        walls["save"] = time.perf_counter() - t0
        print(f"checkpoint saved to {args.save}")
    print()
    for name, val in [
        ("Kinetic", res.Ekin), ("Nuclear attraction", res.Enucattr),
        ("Nuclear repulsion", res.Enucrep), ("Coulomb", res.Ecoul),
        ("Exact exchange", res.Exx), ("Exchange-correlation", res.Exc),
        ("Total", res.E),
    ]:
        print(f"{name:<21s} energy: % .16f" % val)
    print(f"{'Virial ratio':<21s}       : % .16f" % (-res.E / res.Ekin))
    print(f"{'Hellmann-Feynman':<21s}  force: %e"
          % ((2 * res.Ekin + res.Enucattr + res.Enucrep + res.Ecoul + res.Exx + res.Exc) / R))
    print(f"{'Electrons on grid':<21s}       : % .16f" % res.Nelgrid)
    res.analysis = analysis(basis, ops, res, nela)
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


def analysis(basis, ops, res, nela: int) -> dict:
    """The post-SCF analysis of helfem_tpu's diatomic CLI, printed line for
    line (helfem_tpu/cli/diatomic.py:256-291; reference:
    src/diatomic/main.cpp:1000-1086): the electronic, nuclear and total
    dipole and quadrupole moments, the electron density at the nuclei and
    the alpha occupied orbitals' energies and radial moments. Host numpy;
    returns the values printed."""
    import numpy as np

    from helfem_tpu_torch.models.diatomic_tools import (
        nuclear_densities_dia,
        occupied_orbital_vectors_dia,
        orbital_moments_dia,
    )
    from helfem_tpu_torch.scf.diatomic_scf import density_dia

    Pa = density_dia(ops, res.orbs_a, res.occ_a)
    P = Pa + (Pa if res.orbs_b is None else density_dia(ops, res.orbs_b, res.occ_b))
    mv = basis.shell_mask().reshape(-1)
    mm = mv[:, None] * mv[None, :]
    out = {"eldip": -float(np.vdot(P, basis.dipole_z() * mm)),
           "elquad": -float(np.vdot(P, basis.quadrupole_zz() * mm)),
           "nucdip": (basis.Z2 - basis.Z1) * basis.Rhalf,
           "nucquad": (basis.Z1 + basis.Z2) * basis.Rhalf**2}
    print()
    print("Electronic dipole     moment % .10e" % out["eldip"])
    print("Nuclear    dipole     moment % .10e" % out["nucdip"])
    print("Total      dipole     moment % .10e" % (out["eldip"] + out["nucdip"]))
    print("Electronic quadrupole moment % .10e" % out["elquad"])
    print("Nuclear    quadrupole moment % .10e" % out["nucquad"])
    print("Total      quadrupole moment % .10e" % (out["elquad"] + out["nucquad"]))
    print("\nNuclear electron densities")
    out["nucdens"] = nuclear_densities_dia(basis, P)
    if basis.Z1:
        print("left : % .10e" % out["nucdens"][0])
    if basis.Z2:
        print("right: % .10e" % out["nucdens"][1])
    rows = []
    if nela > 0:
        print("\nOccupied orbital analysis (alpha):")
        print(f"{'io':>2s} {'energy':>13s} {'1/<rl^-1>':>12s} {'<rl>':>12s} "
              f"{'sqrt(<rc^2>)':>12s} {'<rr>':>12s}")
        for io, (E_o, _, c) in enumerate(occupied_orbital_vectors_dia(
                basis, res.orbs_a, res.occ_a, res.orbE_blocks_a)):
            m = orbital_moments_dia(basis, c)
            rows.append((E_o, 1.0 / m["left"][-1], m["left"][1], np.sqrt(m["center"][2]),
                         m["right"][1]))
            print(f"{io + 1:2d} % e %e %e %e %e" % rows[-1])
    out["orbitals"] = rows
    return out


if __name__ == "__main__":
    main()
