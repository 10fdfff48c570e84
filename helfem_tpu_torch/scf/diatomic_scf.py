"""Diatomic SCF driver (L7), ported from helfem_tpu/scf/diatomic_scf.py.

The port runs HF, LDA, GGA, meta-GGA and laplacian-level (BR89)
functionals and their global hybrids, restricted (RHF/RKS), unrestricted
(UHF/UKS) or ROHF, under the diatomic symmetry blocks (m, plus g/u for
homonuclear), the paths of the N2 HF and N2 PBE bench configs and of open
shells such as triplet O2 or H2+:

  guess (core, or SAP/GSZ/TF of the two atoms) -> two host iterations (Fock
  on the device, host DIIS with ADIIS far from convergence) -> fused device
  chunks of 4, 8, then 16 iterations: densities and occupied orbitals ->
  Coulomb of the total density (M = 0 channels), occupied-orbital exchange
  per spin and the XC Fock of both spins (CUDA kernels on the card) ->
  block-coordinate C2-DIIS -> one batched blocked eigensolve for both
  spins, with the convergence test on the device after every iteration.

An axial electric field Ez, a quadrupole field Qzz, a magnetic field Bz
(orbital and diamagnetic terms, and the spin Zeeman -+ Bz/2 per spin) and
finite nuclei add one-electron terms folded into H0 (their energy is
Efield); under Ez the g/u split of the blocks is dropped.

ROHF, the level shift (shift: the previous virtual orbitals pushed up
while the DIIS error is above 1e-3, for rough-potential functionals such
as BR89) and the +-m Fock average (maverage) stay on the host loop, as in
helfem_tpu; diisthr blends the host DIIS's C2-DIIS and ADIIS weights
between diisthr and diiseps. diag=False whitens the blocks with the
inverse Cholesky factor; P0a/P0b start from the Fock of a density; occs
fixes the electron count of each symmetry block until iteration
readocc_until (for good when negative), on the host loop while it holds.
helfem_tpu's lax.while_loop chunk becomes a
Python loop over tensors that stay on the device; one boolean per iteration
comes back to stop the chunk. The host iterations' eigensolve is
torch.linalg.eigh per block with helfem_tpu's four refinement passes
(utils/linalg.py:eigh_refined); the fused chunks' is helfem_tpu's warm
start (eig_blocks_dia_b_warm: K11's sweeps from the previous whitened
eigenvectors, a certificate per spin, eigh_refined where it fails).
helfem_tpu's host eigensolve of large bases (eig_blocks_dia_host,
_dia_host_warm) and its workspace-chunked device eigh (_eigh_chunked) are
workarounds for the TPU's device eigh that the card does not need. The crash-recovery hook
save_cb gets the state of every host iteration and of the reported
iteration of every fused chunk, as helfem_tpu's does. ndev >= 1 runs the
SCF over ndev ranks (parallel/mesh.py, parallel/launch.py): the Coulomb
channels, the exchange steps and the XC elements split over the ranks and
the eigensolve over the symmetry blocks, every iteration on the host loop.
A range-separated method raises ValueError, as helfem_tpu's does (range
separation exists on atoms only).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from helfem_tpu_torch.models.diatomic import (
    DiatomicBasis,
    DiatomicOperators,
    coulomb_dia,
    exchange_dia,
    exchange_dia_occ,
)
from helfem_tpu_torch.models.atomic_dft import needs_lapl
from helfem_tpu_torch.models.diatomic_dft import DiaGridOps, build_dia_grid, eval_fxc_dia
from helfem_tpu_torch.models.diatomic_tools import finite_nucleus_Vnuc, guess_hamiltonian_dia
from helfem_tpu_torch.ops.xc import parse_method
from helfem_tpu_torch.parallel import launch
from helfem_tpu_torch.parallel.mesh import make_mesh, sharded_dia_eig, sharded_dia_scf_fock
from helfem_tpu_torch.scf.common import (
    aufbau_blocks,
    diis_error_blocks,
    full_sinvh,
    hook_state,
    occ_fixed_blocks,
    symmetric_sinvh,
    vdot,
    warm_gate,
)
from helfem_tpu_torch.scf.diis import DIIS, device_diis_step
from helfem_tpu_torch.utils.linalg import (
    _BIG,
    density_blocks,
    eig_blocks,
    eig_blocks_b,
    eig_blocks_b_warm,
    form_sh,
    gather_blocks,
    perturbation_matrix,
    rohf_update,
    scatter_blocks,
)

__all__ = ["scf_diatomic", "DiaSCFResult", "density_dia", "eig_blocks_dia_b_warm",
           "eig_blocks_dia_shifted", "fock_m_average_dia", "make_dia_fock", "occ_select", "occupied_dia"]


def fock_m_average_dia(F: np.ndarray, basis: DiatomicBasis) -> np.ndarray:
    """F (host numpy) with its submatrices over the +m and -m shells
    averaged, so that pi+/pi-, delta+/delta-, ... stay degenerate
    (helfem_tpu diatomic_scf.py:173-197; reference --maverage:
    scf::fock_symmetry_average, src/diatomic/main.cpp:325-332,892-895). The
    shells pair in ascending l; +-m shells share their l set and radial
    mask."""
    F = np.array(F)
    nrad = basis.nrad
    for m in sorted(set(basis.mval)):
        if m <= 0:
            continue
        sp = sorted((a for a in range(basis.nang) if basis.mval[a] == m),
                    key=lambda a: basis.lval[a])
        sm = sorted((a for a in range(basis.nang) if basis.mval[a] == -m),
                    key=lambda a: basis.lval[a])
        if len(sp) != len(sm):
            continue
        idxp = np.concatenate([np.arange(a * nrad, (a + 1) * nrad) for a in sp])
        idxm = np.concatenate([np.arange(a * nrad, (a + 1) * nrad) for a in sm])
        mean = 0.5 * (F[np.ix_(idxp, idxp)] + F[np.ix_(idxm, idxm)])
        F[np.ix_(idxp, idxp)] = mean
        F[np.ix_(idxm, idxm)] = mean
    return F


def density_dia(ops: DiatomicOperators, C, occ) -> np.ndarray:
    """The host density [nbf, nbf] of block orbitals C [nblk, blen, blen]
    and occupations occ [nblk, blen] (numpy or tensors)."""
    C = torch.as_tensor(np.asarray(C), dtype=torch.float64)
    occ = torch.as_tensor(np.asarray(occ), dtype=torch.float64)
    blk_idx = ops.blk_idx.cpu()
    return density_blocks(C, occ, blk_idx, ops.S.cpu()).numpy()


def eig_blocks_dia_shifted(ops: DiatomicOperators, Fb: torch.Tensor, C_prev: torch.Tensor,
                           occ: torch.Tensor, shift: float) -> torch.Tensor:
    """The block-coordinate Fock blocks Fb [nblk, blen, blen] with the span of
    the previous iteration's virtual orbitals (C_prev [nblk, blen, blen],
    occupations occ [nblk, blen] <= 0) pushed up by `shift` through S Cv
    Cv^T S per block, ready for the blocked eigensolve (helfem_tpu
    diatomic_scf.py:200-225; the SAD atom's and the reference's
    UpdateOrbitalsShifted stabiliser, for rough-potential functionals such
    as BR89)."""
    Sb = gather_blocks(ops.S, ops.blk_idx)
    Cv = C_prev * (occ <= 0.0).to(Fb.dtype)[:, None, :]
    SC = torch.einsum("bpq,bqk->bpk", Sb, Cv)
    return Fb + shift * torch.einsum("bpk,brk->bpr", SC, SC)


def eig_blocks_dia_b_warm(ops: DiatomicOperators, Fb: torch.Tensor, V0: torch.Tensor,
                          wgate: float, groups: int = 1):
    """The warm-started blocked eigensolve of block-coordinate Fock matrices
    Fb [groups nblk, blen, blen], `groups` spins stacked (helfem_tpu's
    eig_blocks_dia_b_warm, diatomic_scf.py:91-110, one call per spin there):
    V0 the previous whitened block eigenvectors of the same stacking, a
    certificate per spin against wgate, and the unchunked eigh_refined as
    the cold solve; the spins share ops' block maps by broadcasting. Returns
    (E, C, V, good) as eig_blocks_b_warm's."""
    shape = Fb.shape
    E, C, V, good = eig_blocks_b_warm(Fb.reshape(groups, -1, *shape[-2:]), ops.blk_idx,
                                      ops.blk_sinvh, ops.S.shape[0],
                                      V0.reshape(groups, -1, *shape[-2:]), wgate, groups)
    return E.reshape(shape[:-1]), C.reshape(shape), V.reshape(shape), good


def occ_select(occ: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Selector of the occupied orbitals for the factorised exchange:
    (block, column, sqrt(f)) of every orbital with occupation > 0.

    Eager PyTorch has no static shapes, so the width is the exact count of
    occupied columns: helfem_tpu's two padded widths (+2, +8) and its
    overflow to the dense K(P) guard a jit specialisation that does not
    exist here. exchange_dia stays for callers that have only P."""
    b, k = np.nonzero(occ > 0)
    return (torch.as_tensor(b, dtype=torch.long, device=device),
            torch.as_tensor(k, dtype=torch.long, device=device),
            torch.as_tensor(np.sqrt(occ[b, k]), dtype=torch.float64, device=device))


def occupied_dia(ops: DiatomicOperators, C: torch.Tensor, sel) -> torch.Tensor:
    """sqrt(f)-weighted occupied orbital columns [nbf, no] from block
    orbitals C [nblk, blen, blen] and an occ_select selector."""
    ob, ok, sqf = sel
    nbf = ops.S.shape[0]
    no = sqf.shape[0]
    rows = ops.blk_idx[ob].long()  # [no, blen]; padded slots point at row nbf
    Csel = C[ob, :, ok] * sqf[:, None]  # [no, blen]
    Co = torch.zeros((nbf + 1, no), dtype=C.dtype, device=C.device)
    cols = torch.arange(no, device=C.device)[:, None].expand_as(rows)
    Co.index_put_((rows, cols), Csel, accumulate=True)
    return Co[:nbf]


@dataclass
class DiaSCFResult:
    converged: bool
    niter: int
    E: float
    Ekin: float
    Enucattr: float
    Enucrep: float
    Ecoul: float
    Exx: float
    Exc: float
    orbE_a: np.ndarray
    orbs_a: np.ndarray | None = None  # [nblk, blen, blen] block orbitals
    occ_a: np.ndarray | None = None  # [nblk, blen]
    orbE_b: np.ndarray | None = None  # beta: None when restricted
    orbs_b: np.ndarray | None = None
    occ_b: np.ndarray | None = None
    orbsym_a: list[str] | None = None  # spectroscopic label per orbE_a entry
    orbsym_b: list[str] | None = None
    orbE_blocks_a: np.ndarray | None = None  # [nblk, blen] block eigenvalues
    orbE_blocks_b: np.ndarray | None = None
    Nelgrid: float = 0.0  # electrons counted on the DFT grid
    Efield: float = 0.0  # <P, Vextra>: fields and the finite nuclei
    walls: dict = field(default_factory=dict)  # phase -> seconds (CLI)
    analysis: dict = field(default_factory=dict)  # the CLI's post-SCF analysis


def make_dia_fock(funcs: tuple, kfrac: float = 0.0, dftthr: float = 1e-12,
                  njbd: int | None = None):
    """Fock build of both spins for symmetry-block-diagonal densities
    (helfem_tpu's make_dia_fock): fock(ops, g, Pa, Pb, Coa=None, Cob=None)
    -> (Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel), the energies device
    scalars. The Coulomb build runs once, on Pa + Pb (njbd: on the M = 0
    channels only, exact here, coulomb_dia). With kfrac != 0 each spin's
    exchange is built from its sqrt(f)-weighted occupied columns when given
    (the SCF always has them), from its density otherwise; restricted
    (Pb is Pa) builds it once, Kb = Ka, and Exx = (<Pa, Ka> + <Pb, Kb>)/2.
    funcs may be empty (pure HF: g is not read); the XC build takes both
    spins in one launch of each kernel, one spin when Pb is Pa."""

    def exchange(ops, P, Co):
        return kfrac * (exchange_dia_occ(ops, Co) if Co is not None else exchange_dia(ops, P))

    def fock(ops: DiatomicOperators, g: DiaGridOps | None, Pa: torch.Tensor,
             Pb: torch.Tensor, Coa: torch.Tensor | None = None,
             Cob: torch.Tensor | None = None):
        restricted = Pb is Pa
        P = Pa + Pb
        J = coulomb_dia(ops, P, njbd)
        Fa = Fb = ops.H0 + J
        zero = torch.zeros((), dtype=Pa.dtype, device=Pa.device)
        Exx = Exc = Nel = zero
        if kfrac != 0.0:
            Ka = exchange(ops, Pa, Coa)
            Kb = Ka if restricted else exchange(ops, Pb, Cob)
            Fa, Fb = Fa + Ka, Fb if restricted else Fb + Kb
            Exx = 0.5 * (vdot(Pa, Ka) + vdot(Pb, Kb))
        if funcs:
            XCa, XCb, Exc, Nel = eval_fxc_dia(funcs, g, ops, Pa, Pb, dftthr)
            Fa, Fb = Fa + XCa, Fb if restricted else Fb + XCb
        Ekin = vdot(P, ops.T)
        Enuc = vdot(P, ops.Vnuc)
        Ecoul = 0.5 * vdot(P, J)
        return Fa, Fa if restricted else Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    return fock


def make_dia_fused_chunk(funcs: tuple, kfrac: float, dftthr: float, njbd: int | None,
                         Bz: float = 0.0):
    """Up to `nrun` SCF iterations on the device (helfem_tpu's
    make_dia_fused_chunk): densities and occupied columns ->
    Fock -> block C2-DIIS (circular history, updated in place) -> blocked
    eigensolve, with the convergence test (err < convthr and |dE| <
    convthr) on the device after each. occ, sel and C are tuples with one
    entry per spin (one when restricted); unrestricted, the DIIS error is
    both spins' errors concatenated, the history holds the spin-stacked
    block Focks [nhist, 2, nblk, blen, blen], and both spins' blocks go
    through one batched eigensolve. Occupations (and with them the
    selectors of the occupied columns, None without exchange) are frozen
    within a chunk. The eigensolve is the warm-started one
    (eig_blocks_dia_b_warm, a certificate per spin) from Vw [ns nblk, blen,
    blen], the previous whitened eigenvectors. Returns per iteration the
    orbitals and eigenvalues of each spin, energies, errors, grid electron
    counts and energy components, then the new DIIS count, the number of
    iterations run and the last step's Vw.
    Energies leave out the nuclear repulsion and the spin Zeeman energy, as
    helfem_tpu's do; they hold Efield = <P, Vextra> of the extras Vextra
    (None: none) that ops.H0 carries, and Bz adds the spin Zeeman term -+
    Bz/2 S to each spin's Fock."""
    fock = make_dia_fock(funcs, kfrac, dftthr, njbd)

    def chunk(ops, g, Vextra, occ, sel, C, Vw, histF, histE, count, convthr, Eprev, nrun):
        nbf = ops.S.shape[0]
        ns, nblk = len(C), ops.blk_idx.shape[0]
        Sb = gather_blocks(ops.S, ops.blk_idx)
        wgate = warm_gate(convthr)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=C[0].device)
        out = []
        for _ in range(nrun):
            Pbk = [(c * o[:, None, :]) @ c.mT for c, o in zip(C, occ)]
            P = [scatter_blocks(p, ops.blk_idx, nbf) for p in Pbk]
            Co = [None if s is None else occupied_dia(ops, c, s) for c, s in zip(C, sel)]
            Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, P[0], P[-1], Co[0], Co[-1])
            Efield = torch.zeros_like(Ekin) if Vextra is None else vdot(P[0] + P[-1], Vextra)
            Etot = Ekin + Enuc + Ecoul + Exx + Exc + Efield
            if Bz != 0.0:
                Fa, Fb = Fa - 0.5 * Bz * ops.S, Fb + 0.5 * Bz * ops.S
            Fbk = [gather_blocks(F, ops.blk_idx) for F in (Fa, Fb)[:ns]]
            err = torch.cat([diis_error_blocks(F, p, Sb, ops.blk_sinvh)
                             for F, p in zip(Fbk, Pbk)])
            errmax = torch.max(torch.abs(err))
            Fuse, count = device_diis_step(histF, histE, count,
                                           Fbk[0] if ns == 1 else torch.stack(Fbk), err)
            E, Cn, Vw, _ = eig_blocks_dia_b_warm(ops, Fuse.reshape(ns * nblk, *Fuse.shape[-2:]),
                                                 Vw, wgate, ns)
            C, E = Cn.split(nblk), E.split(nblk)
            out.append((C, E, Etot, errmax, Nel, torch.stack([Ekin, Enuc, Ecoul, Exx, Exc,
                                                              Efield])))
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        Cs, Es, Etots, errs, Nels, comps = zip(*out)
        return (Cs, Es, count, torch.stack(Etots), torch.stack(errs), torch.stack(Nels),
                torch.stack(comps), len(out), Vw)

    return chunk


# device memory one spin's per-iteration orbitals may take in a fused chunk
# (helfem_tpu caps its chunk length the same way; two spins hold twice it)
_CHUNK_C_BYTES = 256e6


def scf_diatomic(
    basis: DiatomicBasis,
    nela: int,
    nelb: int,
    method: str = "HF",
    maxit: int = 100,
    convthr: float = 1e-7,
    verbose: bool = False,
    ops: DiatomicOperators | None = None,
    guess: str = "core",
    Ez: float = 0.0,
    Qzz: float = 0.0,
    Bz: float = 0.0,
    finitenuc: str = "point",
    Rrms1: float = 0.0,
    Rrms2: float = 0.0,
    restricted: int = -1,
    perturb: float = 0.0,
    seed: int = 0,
    diisorder: int = 10,
    diiseps: float = 0.1,
    dftthr: float = 1e-12,
    ldft: int = 0,
    device=None,
    shift: float = 0.0,
    diisthr: float | None = None,
    P0a: np.ndarray | None = None,
    P0b: np.ndarray | None = None,
    occs: np.ndarray | None = None,
    readocc_until: int = 0,
    diag: bool = True,
    maverage: bool = False,
    save_cb=None,
    ndev: int = 0,
) -> DiaSCFResult:
    """Restricted, unrestricted or ROHF SCF (helfem_tpu's scf_diatomic) for
    HF, LDA, GGA and meta-GGA functionals and their global hybrids (PBE0,
    B3LYP5, TPSSh), from the core guess or the SAP, GSZ or
    TF guess of the two atoms (a SAP atom is solved on the operators'
    device). restricted = -1 restricts exactly when nela == nelb, 0 runs
    UHF/UKS, and 1 with nela != nelb runs ROHF through rohf_update on the
    host loop alone, as helfem_tpu does; Bz != 0 never runs restricted.
    Ez, Qzz (its quadrupole operator over 3) and Bz add the field
    operators, finitenuc ('gaussian', 'spherical', 'hollow' or
    'regularized', nuclei rms radii Rrms1, Rrms2) replaces the point nuclei
    on the 2D quadrature grid: all folded into H0 (their energy is Efield),
    Bz also the spin Zeeman -+ Bz/2 S and Emag = -Bz/2 (nela - nelb)
    (helfem_tpu diatomic_scf.py:566-606). Operators built here drop the g/u
    blocks under Ez; prebuilt `ops` are taken as they are. perturb rotates the guess orbitals
    of each spin by its own random rotation (seed, seed + 1). The operators
    and the grid (none for pure HF) are built on `device` unless `ops` is
    given, in which case the SCF runs on ops' device. shift != 0 pushes the
    previous virtual orbitals up by `shift` in the eigensolve while the
    DIIS error is above 1e-3 and keeps every iteration on the host loop
    (helfem_tpu diatomic_scf.py:742-745, :896-905; a keyword without a CLI
    flag, as there); diisthr (not None) blends the host DIIS's C2-DIIS and
    ADIIS weights between diisthr and diiseps (scf/diis.py).

    P0a/P0b (host [nbf, nbf]; P0b None: the same for beta) start from the
    blocked eigensolve of the Fock of that density (its exchange from the
    density, exchange_dia) instead of the guess Hamiltonian (helfem_tpu
    diatomic_scf.py:688-708). occs [nblk, 2] fixes each symmetry block's
    alpha and beta electron counts (aufbau within the block) up to
    iteration readocc_until, for good when it is negative; a finite
    boundary keeps the SCF on the host loop until it has passed, so that
    the release lands on its iteration (:754-769). maverage averages the
    Fock over the +-m shells every iteration, on the host loop. diag=False
    builds the operators with the inverse Cholesky whitening (prebuilt ops
    are taken as they are). save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb),
    when given, is the crash-recovery hook (helfem_tpu diatomic_scf.py:835,
    :887): called after every host iteration and once per fused chunk, on
    the state of the chunk's reported iteration, with host numpy arrays
    (the beta ones None when restricted).

    ndev >= 1 runs the SCF over ndev ranks (helfem_tpu diatomic_scf.py:665-688,
    :744-745): K3 on each rank's range of the M = 0 Coulomb channels, K6 (or
    K7) on its range of the exchange steps and K4/K5 on its range of the mu
    elements, all-reduced, and the blocked eigensolve (guess included) on
    its symmetry blocks, gathered (parallel/mesh.py), with every iteration
    on the host loop; the level-shifted eigensolve stays whole on each rank,
    as helfem_tpu's. Inside an initialized process group of ndev ranks the
    call runs this rank's share (another size raises); outside any, ndev 1
    runs over a one-rank group made for the call, and ndev > 1 over ndev
    spawned ranks on copies of the arguments (launch.call; save_cb must
    then pickle), returning rank 0's result. Only rank 0 prints and calls
    save_cb; rank 0 broadcasts the occupations and the convergence test's
    numbers."""
    call_args = dict(locals())
    # a range-separated method raises ValueError, as helfem_tpu's does: range
    # separation exists on atoms only
    funcs, kfrac = parse_method(method)
    funcs = tuple(funcs)
    if ndev and not launch.in_group():
        if ops is None and device is None:
            raise ValueError("scf_diatomic needs a device (or prebuilt ops)")
        return launch.call(scf_diatomic, ndev, (), call_args,
                           ops.device if ops is not None else device)
    if ops is None:
        if device is None:
            raise ValueError("scf_diatomic needs a device (or prebuilt ops)")
        # an axial electric field couples even and odd l: no g/u blocks
        ops = basis.build_operators(device, parity=Ez == 0.0, chol=not diag)
    device = ops.device
    mesh = make_mesh(ndev, device=device) if ndev else None
    if mesh is not None and mesh.rank != 0:
        verbose, save_cb = False, None
    nbf = basis.nbf
    g = build_dia_grid(basis, device, neta=ldft, lapl=needs_lapl(funcs)) if funcs else None
    Enucrep = basis.Z1 * basis.Z2 / basis.Rbond
    njbd = basis.njbd
    rohf = restricted == 1 and nela != nelb
    restricted = ((nela == nelb and Bz == 0.0) if restricted == -1
                  else (restricted == 1 and not rohf and Bz == 0.0))
    ns = 1 if restricted else 2
    fock = make_dia_fock(funcs, kfrac, dftthr, njbd)

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    # the one-electron extras, folded into H0 (diatomic_scf.py:587-604)
    Vextra = np.zeros((nbf, nbf))
    mv = basis.shell_mask().reshape(-1)
    if finitenuc != "point":
        Vextra += finite_nucleus_Vnuc(basis, finitenuc, Rrms1, Rrms2) - ops.Vnuc.cpu().numpy()
    if Ez != 0.0:
        Vextra += Ez * basis.dipole_z() * mv[:, None] * mv[None, :]
    if Qzz != 0.0:
        Vextra += (Qzz / 3.0) * basis.quadrupole_zz() * mv[:, None] * mv[None, :]
    if Bz != 0.0:
        Vextra += basis.Bz_field(Bz)
    Vextra = as_dev(Vextra) if np.abs(Vextra).max() > 0.0 else None
    if Vextra is not None:
        ops = ops._replace(H0=ops.H0 + Vextra)
    Emag = -0.5 * Bz * (nela - nelb)
    seig = None
    if mesh is not None:
        # the Fock build and the eigensolve over the mesh (helfem_tpu
        # diatomic_scf.py:665-688), of the operators with their extras
        sfock = sharded_dia_scf_fock(mesh, ops, funcs, g, kfrac, dftthr, restricted, njbd)[0]
        gfock = fock  # the guess of a two-spin warm start stays single-rank
        fock = lambda ops_, g_, Pa, Pb, Coa=None, Cob=None: sfock(Pa, Pb, Coa, Cob)  # noqa: E731
        seig = sharded_dia_eig(mesh, ops)

    blk_idx_np = ops.blk_idx.cpu().numpy()
    blk_sinvh_np = ops.blk_sinvh.cpu().numpy()
    nblk, blen = blk_idx_np.shape
    idx_s, sinvh_s = ops.blk_idx.repeat(ns, 1), ops.blk_sinvh.repeat(ns, 1, 1)

    def eig_spins(Fs, shifted=None):
        """One batched blocked eigensolve of each spin's dense Fock:
        (host eigenvalues, device orbitals) per spin; shifted = ((C, occ)
        per spin) applies the level shift to each spin's blocks first."""
        if seig is not None and shifted is None:
            E, C = seig(torch.stack([torch.as_tensor(F, dtype=torch.float64, device=device)
                                     for F in Fs]))
            E = E.cpu().numpy()
            return [(E[s], C[s]) for s in range(len(Fs))]
        Fb = [gather_blocks(as_dev(F), ops.blk_idx) for F in Fs]
        if shifted is not None:
            Fb = [eig_blocks_dia_shifted(ops, F, C, as_dev(o), shift)
                  for F, (C, o) in zip(Fb, shifted)]
        E, C = eig_blocks_b(torch.cat(Fb), idx_s, sinvh_s, nbf)
        E = E.cpu().numpy()
        return [(E[s * nblk:(s + 1) * nblk], C[s * nblk:(s + 1) * nblk]) for s in range(ns)]

    if P0a is not None:
        # the Fock of a density (a loaded checkpoint's, say) as the guess;
        # its exchange from the density, as helfem_tpu's without orbitals
        Pg_a = as_dev(P0a)
        fg = fock if mesh is None or P0b is None else gfock
        Fg_a, Fg_b, *_ = fg(ops, g, Pg_a, Pg_a if P0b is None else as_dev(P0b))
        spins = eig_spins([Fg_a.cpu().numpy()] if restricted else
                          [Fg_a.cpu().numpy(), Fg_b.cpu().numpy()])
        (Ea, Ca), (Eb, Cb) = spins[0], spins[-1]
    else:
        if guess == "core":
            Hguess = ops.H0
        else:
            Hguess = as_dev(guess_hamiltonian_dia(basis, guess, device))
        if seig is None:
            Ea, Ca = eig_blocks(Hguess, ops.blk_idx, ops.blk_sinvh)
            Ea = Ea.cpu().numpy()
        else:
            (Ea, Ca), = eig_spins([Hguess])
    if P0a is None or restricted:
        Eb, Cb = Ea.copy(), Ca
    if perturb:
        # an independent rotation per spin (the reference draws a fresh one
        # for beta), so a symmetric guess can break spin symmetry
        Ca = torch.einsum("bpk,kq->bpq", Ca, as_dev(perturbation_matrix(blen, perturb, seed)))
        if not restricted:
            Cb = torch.einsum("bpk,kq->bpq", Cb,
                              as_dev(perturbation_matrix(blen, perturb, seed + 1)))
    Sinvh_np = full_sinvh(blk_idx_np, blk_sinvh_np, nbf)
    diis = DIIS(ops.S.cpu().numpy(), Sinvh_np, max_hist=diisorder, diis_eps=diiseps,
                diis_thr=diisthr, blocks=(blk_idx_np, blk_sinvh_np))
    Sh_np = form_sh(ops.S.cpu().numpy()) if rohf else None
    # rohf_update's natural orbitals need the symmetric inverse square root
    # under --diag 0 too
    Sinvh_rohf = symmetric_sinvh(ops.S.cpu().numpy(), blk_idx_np) if rohf else None

    Eold, Etot, converged = 0.0, 0.0, False
    Ekin = Enuc = Ecoul = Exx = Exc = Nel = Efield = 0.0
    # fused device chunks engage after TWO host iterations: the host DIIS's
    # ADIIS weights carry the far-from-converged guess, which the chunks'
    # pure C2-DIIS cannot (helfem_tpu diatomic_scf.py:736-745). ROHF's Fock
    # update, the level shift and the m-average are host work every
    # iteration, so they stay on the host.
    warmup = maxit if rohf or shift != 0.0 or maverage or mesh is not None else 2
    chunk_len = 4  # chunk schedule 4, 8, 16, capped by the orbitals' memory
    CH = 16
    while CH > 4 and CH * nblk * blen * blen * 8 > _CHUNK_C_BYTES:
        CH //= 2
    fused = None
    occa = occb = None

    def select(occ):
        return occ_select(occ, device) if kfrac != 0.0 else None

    it = 0
    while it < maxit:
        it += 1
        if occs is not None and (readocc_until < 0 or it <= readocc_until):
            # fixed per-block electron counts (reference --readocc occs.dat,
            # until the readocc_until-th Fock build)
            occa = occ_fixed_blocks(Ea, np.asarray(occs)[:, 0])
            occb = occa if restricted else occ_fixed_blocks(Eb, np.asarray(occs)[:, 1])
        else:
            occa = aufbau_blocks(Ea, nela)
            occb = occa if restricted else aufbau_blocks(Eb, nelb)
        if mesh is not None:  # every rank takes rank 0's decisions
            occa, occb_ = mesh.bcast(occa, occb)
            occb = occa if restricted else occb_
        # a finite boundary must land on its iteration: the fused chunks
        # freeze the occupations for several iterations
        readocc_hold = occs is not None and 0 < readocc_until and it <= readocc_until
        if it > warmup and not readocc_hold:
            if fused is None:
                nhist = 10
                fused = make_dia_fused_chunk(funcs, kfrac, dftthr, njbd, Bz)
                histF = torch.zeros((nhist, *(() if restricted else (2,)), nblk, blen, blen),
                                    dtype=torch.float64, device=device)
                histE = torch.zeros((nhist, ns * nblk * blen * blen), dtype=torch.float64,
                                    device=device)
                count = 0
                # the warm eigensolve's seed: the identity fails the first
                # fused step's certificate, which then solves cold; the
                # whitened eigenvectors persist across chunks, per spin
                Vw = torch.eye(blen, dtype=torch.float64, device=device).repeat(ns * nblk, 1, 1)
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            spin_occs = (occa, occb)[:ns]
            # the chunk's energies leave out the constant Enucrep + Emag
            Cs, Es, count, Etots, errs, Nels, comps, kmax, Vw = fused(
                ops, g, Vextra, tuple(as_dev(o) for o in spin_occs),
                tuple(select(o) for o in spin_occs),
                (Ca, Cb)[:ns], Vw, histF, histE, count, float(convthr), Eold - Enucrep - Emag, nrun,
            )
            Etots = Etots.cpu().numpy()
            errs = errs.cpu().numpy()
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k]) + Enucrep + Emag
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"iter {it + k:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  "
                          f"diis = {err:.3e} (fused)")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            # the chunk ran k+1 counted iterations, one already counted above
            it += k
            Ca, Cb = Cs[k][0], Cs[k][-1]
            Ea, Eb = Es[k][0].cpu().numpy(), Es[k][-1].cpu().numpy()
            Nel = float(Nels[k])
            Ekin, Enuc, Ecoul, Exx, Exc, Efield = comps[k].cpu().numpy()
            if save_cb is not None:
                hook_state(save_cb, it, Etot, restricted, Ea, Ca, occa, Eb, Cb, occb)
            if converged or it >= maxit:
                break
            continue

        Pa = density_blocks(Ca, as_dev(occa), ops.blk_idx, ops.S)
        Pb = Pa if restricted else density_blocks(Cb, as_dev(occb), ops.blk_idx, ops.S)
        sela = select(occa)
        Coa = None if sela is None else occupied_dia(ops, Ca, sela)
        Cob = None if restricted or sela is None else occupied_dia(ops, Cb, select(occb))
        Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Pb, Coa, Cob)
        Efield = 0.0 if Vextra is None else float(vdot(Pa + Pb, Vextra))
        if Bz != 0.0:
            Fa, Fb = Fa - 0.5 * Bz * ops.S, Fb + 0.5 * Bz * ops.S
        Ekin, Enuc, Ecoul, Exx, Exc, Nel = (float(x) for x in
                                            (Ekin, Enuc, Ecoul, Exx, Exc, Nel))
        Etot = float(Ekin + Enuc + Ecoul + Exx + Exc) + Enucrep + Efield + Emag
        dE = Etot - Eold
        Eold = Etot
        if maverage:
            Fa = as_dev(fock_m_average_dia(Fa.cpu().numpy(), basis))
            Fb = Fa if restricted else as_dev(fock_m_average_dia(Fb.cpu().numpy(), basis))
        if restricted:
            err = diis.update([Fa.cpu().numpy()], [Pa.cpu().numpy()])
        else:
            Fa, Fb, Pa, Pb = (x.cpu().numpy() for x in (Fa, Fb, Pa, Pb))
            if rohf:
                Fa, Fb = rohf_update(Fa, Fb, Pa + Pb, Sh_np, Sinvh_rohf, nela, nelb)
            err = diis.update([Fa, Fb], [Pa, Pb])
        Fs = diis.solve()
        if mesh is not None:
            err, Etot, dE = (float(x) for x in mesh.bcast(err, Etot, dE))
            Eold = Etot
        if verbose:
            print(f"iter {it:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e}")
        if save_cb is not None:
            hook_state(save_cb, it, Etot, restricted, Ea, Ca, occa, Eb, Cb, occb)
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
            break
        shifted = None
        if err > 1e-3 and shift != 0.0:
            shifted = ((Ca, occa), (Cb, occb))[:ns]
        spins = eig_spins(Fs, shifted)
        (Ea, Ca), (Eb, Cb) = spins[0], spins[-1]

    labels = basis.sym_labels(True)
    if len(labels) != nblk:
        labels = basis.sym_labels(False)

    def _sorted(E):
        """(eigenvalues ascending, their block labels), padded slots dropped."""
        flat = E.ravel()
        order = np.argsort(flat)
        order = order[flat[order] < _BIG / 2]
        return flat[order], [labels[i // E.shape[1]] for i in order]

    (oea, syma), (oeb, symb) = _sorted(Ea), _sorted(Eb)
    return DiaSCFResult(
        converged=converged,
        niter=it,
        E=Etot,
        Ekin=float(Ekin),
        Enucattr=float(Enuc),
        Enucrep=Enucrep,
        Ecoul=float(Ecoul),
        Exx=float(Exx),
        Exc=float(Exc),
        orbE_a=oea,
        orbs_a=Ca.cpu().numpy(),
        occ_a=occa,
        orbE_b=None if restricted else oeb,
        orbs_b=None if restricted else Cb.cpu().numpy(),
        occ_b=None if restricted else occb,
        orbsym_a=syma,
        orbsym_b=None if restricted else symb,
        orbE_blocks_a=Ea,
        orbE_blocks_b=None if restricted else Eb,
        Nelgrid=float(Nel),
        Efield=float(Efield),
    )
