"""`python -m helfem_tpu_torch.cli.atomic`: atomic HF/DFT SCF driver of the
PyTorch/CUDA port (restricted, unrestricted or ROHF; global and
range-separated hybrids; the laplacian-level BR89; Fock damping, the
sliding DIIS/ADIIS blend, m-averaging, fixed occupations, a perturbed
guess, Cholesky whitening and the iterative eigensolve; electric and
magnetic fields, confinement, finite nuclei, off-centre nuclei and the
symmetry blocks 0/1/2), followed by the post-SCF analysis.

helfem_tpu.cli.atomic's flags (they mirror the reference `atomic` program,
src/atomic/main.cpp:63-119), plus --device; --trace writes a torch.profiler
Chrome trace of the SCF. --save (default helfem.npz, as helfem_tpu's)
writes the checkpoint after every host iteration and fused chunk and once
at the end (a .chk/.h5/.hdf5 path: the reference HDF5 schema at the end,
npz crash-recovery files beside it as <save>.crash.npz; HDF5 needs h5py);
--load warm-starts from a checkpoint, projected onto this basis when the
discretization differs (an npz file needs (l,m) symmetry blocks). --ndev N
runs the SCF over N ranks (parallel/launch.py: gloo ranks on the CPU, NCCL
with one card per rank on CUDA), rank 0 printing and writing. The
per-iteration, final-energy and analysis lines match the JAX CLI's.
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

# --finitenuc: the reference's nuclear model numbers
NUCLEAR_MODELS = {0: "point", 1: "point", 2: "gaussian", 3: "spherical", 4: "hollow",
                  5: "regularized"}


def main(argv=None):
    return rank0_only(_main, argv)


def _main(argv, writes: bool):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.atomic", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--Z", required=True, help="nuclear charge (number or symbol)")
    p.add_argument("--Zl", default="", help="left off-centre charge (at -Rmid z)")
    p.add_argument("--Zr", default="", help="right off-centre charge (at +Rmid z)")
    p.add_argument("--Rmid", type=float, default=0.0, help="off-centre distance")
    p.add_argument("--angstrom", action="store_true", help="Rmid given in angstrom")
    p.add_argument("--nela", type=int, default=0)
    p.add_argument("--nelb", type=int, default=0)
    p.add_argument("--Q", type=int, default=0, help="charge state")
    p.add_argument("--M", type=int, default=0, help="spin multiplicity")
    p.add_argument("--lmax", type=int, required=True)
    p.add_argument("--mmax", type=int, required=True)
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--grid", type=int, default=4)
    p.add_argument("--zexp", type=float, default=2.0)
    p.add_argument("--nelem", type=int, required=True)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--nquad", type=int, default=0,
                   help="quadrature points per element (0 = 5*nnodes)")
    p.add_argument("--primbas", type=int, default=4,
                   help="primitive polynomial basis id (3 Legendre, 4 LIP, "
                        "5 HIP, 6-11 general HIP, 100/101 Chebyshev nodes)")
    p.add_argument("--nelem0", type=int, default=0,
                   help="elements in the finite-nucleus sub-grid / per off-centre grid "
                        "section (0 = plain grid)")
    p.add_argument("--grid0", type=int, default=2, help="finite-nucleus sub-grid type")
    p.add_argument("--zexp0", type=float, default=2.0)
    p.add_argument("--Ez", type=float, default=0.0, help="electric field along z")
    p.add_argument("--Qzz", type=float, default=0.0, help="quadrupole field strength")
    p.add_argument("--Bz", type=float, default=0.0, help="magnetic field along z")
    p.add_argument("--finitenuc", type=int, default=0,
                   help="0 point, 2 gaussian, 3 spherical, 4 hollow, 5 regularized "
                        "(Gygi; Rrms = a)")
    p.add_argument("--Rrms", type=float, default=0.0, help="nuclear rms charge radius")
    p.add_argument("--iconf", type=int, default=0,
                   help="confinement: 0 none, 1 polynomial, 2 exponential, 3 barrier, "
                        "4 Junquera")
    p.add_argument("--conf_N", type=int, default=0)
    p.add_argument("--conf_R", type=float, default=0.0)
    p.add_argument("--conf_barrier", type=float, default=0.0)
    p.add_argument("--shift_conf", type=float, default=0.0)
    p.add_argument("--add_conf", type=int, default=1,
                   help="insert an element boundary at the confinement onset radius")
    p.add_argument("--symmetry", type=int, default=-1,
                   help="symmetry blocks: 0 none, 1 m, 2 (l,m); -1 auto (1 under Ez, Qzz "
                        "or off-centre nuclei, else 2)")
    p.add_argument("--maxit", type=int, default=50)
    p.add_argument("--convthr", type=float, default=1e-7)
    p.add_argument("--method", default="HF",
                   help="HF, LDA, SVWN, PBE, revPBE, PBEsol, RPBE, BLYP, TPSS, SCAN, rSCAN, "
                        "the hybrids PBE0/PBEh, TPSSh and B3LYP5, the range-separated "
                        "LC-LDA/LDAERF, LCY-LDA and SR-PBE0 (e.g. 'LC-LDA[omega=0.4]', "
                        "overrides omega, kshort, kfull), the laplacian-level BR89 "
                        "exchange mgga_x_br89, or an 'x,c' pair of the ported "
                        "functionals (e.g. 'mgga_x_br89,gga_c_lyp')")
    p.add_argument("--iguess", type=int, default=2,
                   help="0 core, 1 GSZ, 2 SAP, 3 TF")
    p.add_argument("--dftthr", type=float, default=1e-12, help="XC density threshold")
    p.add_argument("--restricted", type=int, default=-1,
                   help="-1 restricted iff nela == nelb, 0 unrestricted, 1 restricted "
                        "(ROHF for open shells)")
    p.add_argument("--ldft", type=int, default=0,
                   help="theta points of the XC grid (0: 2*lmax + 12)")
    add_xc_flags(p)
    p.add_argument("--diisorder", type=int, default=10, help="DIIS history length")
    p.add_argument("--diiseps", type=float, default=0.1,
                   help="DIIS error below which extrapolation starts mixing in")
    p.add_argument("--diisthr", type=float, default=None,
                   help="DIIS error below which extrapolation is pure C2-DIIS; "
                        "between diisthr and diiseps the DIIS/ADIIS weights are "
                        "blended on the reference's sliding scale "
                        "(src/general/diis.cpp:241); unset = hard switch at diiseps")
    p.add_argument("--dampfock", type=float, default=1.0,
                   help="damping factor for occupied-virtual MO Fock blocks")
    p.add_argument("--dampthr", type=float, default=0.5,
                   help="apply damping while the DIIS error is above this")
    p.add_argument("--readocc", default="",
                   help="occupation file: lines 'l m na nb' (fixed per-(l,m) occupations)")
    p.add_argument("--maverage", action="store_true",
                   help="average the Fock matrix over m within each l")
    p.add_argument("--perturb", type=float, default=0.0,
                   help="random orthogonal rotation amplitude for the guess orbitals")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diag", type=int, default=1,
                   help="1: symmetric inverse square root whitening; 0: inverse Cholesky "
                        "whitening (reference --diag, src/atomic/main.cpp:88)")
    p.add_argument("--eigiter", type=int, default=0,
                   help="when > 0, solve each symmetry block for its lowest N eigenpairs "
                        "by shift-invert ARPACK on the host (reference: scf::eig_iter)")
    p.add_argument("--zeroder", action="store_true",
                   help="drop the derivative DOF at Rmax too (Hermite bases)")
    p.add_argument("--taylor_order", type=int, default=-1,
                   help="accepted for reference parity; B(r)/r near the origin is "
                        "evaluated by exact polynomial division, so it has no effect")
    p.add_argument("--trace", default="",
                   help="write a torch.profiler Chrome/Perfetto trace of the SCF to this "
                        "JSON file")
    p.add_argument("--save", default="helfem.npz",
                   help="checkpoint file, written after every host iteration and fused "
                        "chunk and at the end; a .chk/.h5/.hdf5 extension writes the "
                        "reference HDF5 schema at the end (needs h5py); '' writes none")
    p.add_argument("--load", default="",
                   help="warm start from a checkpoint (cross-basis orbital projection); "
                        ".chk/.h5/.hdf5 reads the reference HDF5 schema, anything else npz")
    p.add_argument("--ndev", type=int, default=0,
                   help="run the SCF over an N-device mesh: the Fock build shards the TEI L "
                        "axis and the DFT-grid element axis, the blocked eigensolve shards "
                        "the symmetry-block axis (the multi-chip replacement for the "
                        "reference's OpenMP, src/atomic/TwoDBasis.cpp:987)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their "
                        "plain PyTorch versions")
    args, extra = p.parse_known_args(argv)
    if extra:
        raise SystemExit(f"{p.prog}: unrecognized arguments: {' '.join(extra)}")
    if not writes:
        args.save = ""

    import torch

    from helfem_tpu_torch.models.atomic import AtomicBasis
    import numpy as np

    from helfem_tpu_torch.models.atomic_dft import (
        build_atomic_grid, eval_kinetic_grid, eval_overlap_grid, needs_lapl,
    )
    from helfem_tpu_torch.ops.xc import parse_method_rs
    from helfem_tpu_torch.scf.atomic_scf import atomic_analysis, rs_operators, scf_atom
    from helfem_tpu_torch.utils import checkpoint, checkpoint_h5
    from helfem_tpu_torch.utils.elements import ANGSTROM_IN_BOHR, HARTREE_IN_EV, get_Z
    from helfem_tpu_torch.utils.profiling import trace_scf
    from helfem_tpu_torch.utils.timer import Timer

    device = open_device(args.device)
    if is_hdf5(args.save) or is_hdf5(args.load):
        checkpoint_h5.require_h5py()  # before the SCF, not after it
    args.method = apply_pars_files(args.method, args.x_pars, args.c_pars)
    spec = parse_method_rs(args.method)  # raises for methods that are not ported
    funcs = spec.funcs
    Z = get_Z(args.Z)
    Zl = get_Z(args.Zl) if args.Zl else 0
    Zr = get_Z(args.Zr) if args.Zr else 0
    if args.angstrom:
        args.Rmid *= ANGSTROM_IN_BOHR
    nela, nelb = parse_nela_nelb(Z + Zl + Zr, args.Q, args.M, args.nela, args.nelb)
    guess = {0: "core", 1: "GSZ", 2: "SAP", 3: "TF"}[args.iguess]
    nucmodel = NUCLEAR_MODELS[args.finitenuc]

    timer = Timer()
    basis = AtomicBasis(
        Z=Z, lmax=args.lmax, mmax=args.mmax, rmax=args.Rmax, nelem=args.nelem,
        nnodes=args.nnodes, nquad=args.nquad, igrid=args.grid, zexp=args.zexp,
        primbas=args.primbas, finitenuc=nucmodel, Rrms=args.Rrms, nelem0=args.nelem0,
        igrid0=args.grid0, zexp0=args.zexp0, Zl=Zl, Zr=Zr, Rmid=args.Rmid,
        conf_boundary=args.shift_conf if (args.add_conf and args.iconf) else 0.0,
        zeroder=args.zeroder,
    )
    walls = {"basis": timer.lap("basis set formation")}
    print(f"Running {args.method} on Z={Z} with {nela}+{nelb} electrons, "
          f"{basis.nbf} basis functions ({basis.nang} angular x {basis.nrad} radial)")
    if spec.omega != 0.0:
        # reference printout, src/atomic/main.cpp:363-371
        print(f"Using range-separated exchange with omega = {spec.omega:.3f} "
              f"({spec.kernel} kernel)")
        print(f"Using {100 * (spec.kfull + spec.kshort):.3f} % short-range and "
              f"{100 * spec.kfull:.3f} % long-range exchange.")
    ops = basis.build_operators(device)
    walls["operators"] = timer.lap("operator build")
    _, _, rs = rs_operators(basis, spec, device)
    if rs is not None:
        walls["rs tables"] = timer.lap(f"{spec.kernel} exchange tables")
    grid = None
    if funcs:
        # grid-accuracy self-check, as the reference prints it
        # (src/atomic/main.cpp:411-441)
        grid = build_atomic_grid(basis, device, ntheta=args.ldft, lapl=needs_lapl(funcs))
        S = basis.overlap()
        dS = np.abs(eval_overlap_grid(grid, basis.nrad).cpu().numpy() - S)
        nrm = np.sqrt(np.outer(np.diag(S), np.diag(S)))
        print(f"Error in overlap matrix evaluated through xc grid is {np.linalg.norm(dS / nrm):e}")
        T = basis.kinetic()
        dT = np.abs(eval_kinetic_grid(grid, basis.nrad).cpu().numpy() - T) / (1 + np.abs(T))
        print(f"Relative error in kinetic matrix evaluated through xc grid is "
              f"{np.linalg.norm(dT):e}")
        walls["grid check"] = timer.lap("XC grid self-check")
    # warm start from a checkpoint (cross-basis orbital projection)
    P0a = P0b = None
    if args.load:
        if is_hdf5(args.load):
            oldb, d = checkpoint_h5.load_atomic_chk(args.load)
            P0a, P0b = checkpoint_h5.warm_start_density_atomic_h5(basis, oldb, d)
            print(f"Warm start from HDF5 checkpoint {args.load}")
        else:
            oldb, d = checkpoint.load_atomic(args.load)
            P0a, P0b = checkpoint.warm_start_density(basis, oldb, d)
            print(f"Warm start from {args.load} (E = {float(d['E']):.9f})")
        walls["load"] = timer.lap("checkpoint load and projection")
    occs = None
    if args.readocc:  # lines 'l m na nb'
        occs = {}
        with open(args.readocc) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if line:
                    l_, m_, na_, nb_ = line.split()
                    occs[(int(l_), int(m_))] = (float(na_), float(nb_))
    kwargs = dict(
        method=args.method, maxit=args.maxit, convthr=args.convthr, guess=guess, verbose=True,
        ops=ops, dftthr=args.dftthr, restricted=args.restricted, diisorder=args.diisorder,
        diiseps=args.diiseps, ldft=args.ldft, grid=grid, rs=rs, dampfock=args.dampfock,
        dampthr=args.dampthr, diisthr=args.diisthr, Ez=args.Ez, Qzz=args.Qzz, Bz=args.Bz,
        iconf=args.iconf, conf_N=args.conf_N, conf_R=args.conf_R,
        conf_barrier=args.conf_barrier, shift_conf=args.shift_conf, finitenuc=nucmodel,
        Rrms=args.Rrms, Zl=Zl, Zr=Zr, Rmid=args.Rmid, symmetry=args.symmetry, occs=occs,
        perturb=args.perturb, seed=args.seed, maverage=args.maverage, diag=bool(args.diag),
        eigiter=args.eigiter, P0a=P0a, P0b=P0b,
    )
    t0 = time.perf_counter()
    with trace_scf(args.trace, device):
        if args.ndev:
            res, writes = scf_on_ranks(scf_atom, args.ndev, basis, nela, nelb, kwargs,
                                       args.save, checkpoint.save_atomic, device)
        else:
            save_cb, writes = crash_hook(args.save, basis, checkpoint.save_atomic)
            res = scf_atom(basis, nela, nelb, **kwargs, save_cb=save_cb if args.save else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    walls["scf"] = time.perf_counter() - t0
    if args.trace:
        print(f"profiler trace written to {args.trace}")
    timer.lap("SCF")
    res.walls = walls
    res.checkpoint_writes = writes
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
    # post-SCF analysis (reference: src/atomic/main.cpp:1000-1059)
    ana = atomic_analysis(basis, res, symm=res.symm_used)
    res.analysis = ana
    print()
    print(f"Virial ratio -E/T     : {ana['virial_ratio']:.10f}")
    for n in (-1, 1, 2, 3):
        print(f"<r^{n:+d}>                : {ana[f'<r^{n}>']:.10f}")
    print(f"Density at nucleus    : {ana['density_at_nucleus']:.10f}")
    print(f"Density gradient      : {ana['density_gradient_at_nucleus']:.10f}")
    print(f"Cusp -n'(0)/(2 Z n(0)): {ana['cusp']:.10f}")
    print(f"Dipole <z>            : {ana['dipole_z']:.10e}")
    print(f"Quadrupole <zz>       : {ana['quadrupole_zz']:.10e}")
    if args.save:
        t0 = time.perf_counter()
        if is_hdf5(args.save):
            checkpoint_h5.save_atomic_chk(args.save, basis, res, nela, nelb)
        else:
            checkpoint.save_atomic(args.save, basis, res)
        walls["save"] = time.perf_counter() - t0
        print(f"checkpoint saved to {args.save}")
    return res


if __name__ == "__main__":
    main()
