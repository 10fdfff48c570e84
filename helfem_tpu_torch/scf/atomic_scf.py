"""Atomic SCF driver (L7), ported from helfem_tpu/scf/atomic_scf.py.

The port runs HF, the ported LDA, GGA and meta-GGA functionals (BR89, the
laplacian-level one, among them), their
global hybrids (PBE0, B3LYP5, TPSSh) and the range-separated hybrids
(LC-LDA, LDAERF, LCY-LDA, SR-PBE0: kfull K + kshort K_sr(omega), the erfc
or Yukawa kernel), restricted (RHF/RKS), unrestricted (UHF/UKS) or ROHF,
with the one-electron extras of helfem_tpu (axial electric field Ez and
quadrupole Qzz, magnetic field Bz with its spin Zeeman term, confinement,
finite nuclei and off-centre nuclei):

  two host iterations (Fock on the device, host DIIS) ->
  fused device chunks of 4, 8, then 16 iterations: density -> Coulomb,
  exchange and the XC grid (CUDA kernels on the card) ->
  block-coordinate C2-DIIS -> batched whitened eigensolve, with the
  convergence test on the device after every iteration.

The symmetry blocks are (l,m) (symmetry 2) unless Ez, Qzz or off-centre
nuclei couple l channels, then m blocks (symmetry 1); `symmetry` 0/1/2
overrides. Under (l,m) blocks every density is channel-block-diagonal and
the exchange runs on the channel diagonals (exchange_bd); under 0/1 it runs
on the channel-pair windows (exchange_general: all nang^2 pairs, or the
same-m ones). The DIIS side works in block coordinates in both: the Fock
matrices of symmetry 0 and 1 are block-diagonal over their blocks, as
those of symmetry 2 are.

ROHF, Fock damping (dampfock/dampthr, the occupied-virtual MO blocks
scaled while the DIIS error is at least dampthr), the Fock m-average
(maverage) and the iterative eigensolve (eigiter: host ARPACK per block)
stay on the host loop (their Fock updates or eigensolves are host work
every iteration), as in helfem_tpu; diisthr blends the host DIIS's C2-DIIS
and ADIIS weights between diisthr and diiseps. diag=False whitens the
blocks with the inverse Cholesky factor. The guess can be a warm-start
density (P0a/P0b: one Fock of it, on the channel-pair windows when it has
cross-channel blocks, then the blocked eigensolve), perturbed by a random
rotation (perturb/seed), and the occupations can be fixed per (l,m) block
(occs). helfem_tpu's lax.while_loop chunk becomes a Python loop over
tensors that stay on the device; one boolean per iteration comes back to
stop the chunk. The crash-recovery hook save_cb gets the state of every
host iteration and of the reported iteration of every fused chunk, as
helfem_tpu's does. ndev >= 1 runs the SCF over ndev ranks
(parallel/mesh.py, parallel/launch.py): the Fock build on each rank's L
range and grid elements, the blocked eigensolve on its symmetry blocks,
every iteration on the host loop. atomic_analysis is the
post-SCF analysis (<r^n>, the density at the nucleus and the cusp, the
multipoles).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from helfem_tpu_torch.models.atomic import (
    AtomicBasis,
    AtomicOperators,
    ErfcOperators,
    RSOperators,
    channel_diag,
    channel_pairs,
    coulomb,
    erfc_exchange,
    erfc_exchange_bd,
    exchange,
    exchange_bd,
    rs_exchange,
    rs_exchange_bd,
)
from helfem_tpu_torch.models.atomic_dft import (
    AtomGridOps,
    build_atomic_grid,
    eval_fxc,
    needs_lapl,
)
from helfem_tpu_torch.ops.xc import MethodSpec, parse_method_rs
from helfem_tpu_torch.parallel import launch
from helfem_tpu_torch.parallel.mesh import make_mesh, sharded_atomic_fock, sharded_eig_blocks
from helfem_tpu_torch.scf.common import (
    aufbau_blocks,
    diis_error_blocks,
    full_sinvh,
    hook_state,
    symmetric_sinvh,
    vdot,
    warm_gate,
)
from helfem_tpu_torch.scf.diis import DIIS, device_diis_step
from helfem_tpu_torch.scf.guess import potential
from helfem_tpu_torch.utils.linalg import (
    _BIG,
    build_blocks,
    density_blocks,
    eig_blocks,
    eig_blocks_b_warm,
    eig_blocks_iter,
    form_sh,
    gather_blocks,
    perturbation_matrix,
    rohf_update,
    scatter_blocks,
)

__all__ = ["scf_atom", "SCFResult", "atomic_analysis", "aufbau_blocks", "extra_operators",
           "make_fock", "rs_operators"]


@dataclass
class SCFResult:
    converged: bool
    niter: int
    E: float
    Ekin: float
    Enuc: float
    Ecoul: float
    Exx: float
    Exc: float
    Nelgrid: float
    Efield: float
    orbE_a: np.ndarray
    orbs_a: np.ndarray  # [nblk, blen, blen] block eigenvectors
    occ_a: np.ndarray  # [nblk, blen]
    orbE_b: np.ndarray | None = None
    orbs_b: np.ndarray | None = None
    occ_b: np.ndarray | None = None
    orbsym_a: list[str] | None = None  # symmetry label per orbE_a entry
    orbsym_b: list[str] | None = None
    orbE_blocks_a: np.ndarray | None = None  # unsorted [nblk, blen]
    orbE_blocks_b: np.ndarray | None = None
    symm_used: int | None = None
    walls: dict = field(default_factory=dict)  # phase -> seconds (CLI)
    analysis: dict = field(default_factory=dict)  # the CLI's atomic_analysis


def _diis_error(F, P, S, Sinvh):
    FPS = F @ P @ S
    e = Sinvh.T @ (FPS - FPS.T) @ Sinvh
    return e.reshape(-1)


def _fock_m_average(F: np.ndarray, basis: AtomicBasis) -> np.ndarray:
    """F (host numpy) with its diagonal (l,m) radial blocks averaged over m
    for each l (helfem_tpu atomic_scf.py:413-428; reference:
    scf::fock_symmetry_average, src/general/scf_helpers.cpp:264, the
    --maverage option)."""
    F = np.array(F)
    nrad = basis.nrad
    for l in np.unique(basis.lval):
        shells = np.nonzero(basis.lval == l)[0]
        if len(shells) < 2:
            continue
        mean = sum(F[a * nrad:(a + 1) * nrad, a * nrad:(a + 1) * nrad]
                   for a in shells) / len(shells)
        for a in shells:
            F[a * nrad:(a + 1) * nrad, a * nrad:(a + 1) * nrad] = mean
    return F


def _channel_bd(P: np.ndarray, nang: int, nrad: int) -> bool:
    """Is P block-diagonal over the angular channels (helfem_tpu
    atomic_scf.py:577-582)?"""
    P4 = np.asarray(P).reshape(nang, nrad, nang, nrad)
    off = P4.copy()
    off[np.arange(nang), :, np.arange(nang), :] = 0.0
    return float(np.abs(off).max()) <= 1e-12 * max(float(np.abs(P4).max()), 1.0)


def fixed_occupations(basis: AtomicBasis, occs: dict, nblk: int, blen: int) -> np.ndarray:
    """[2, nblk, blen] alpha and beta occupations of the (l,m) blocks from
    {(l, m): (na, nb)}: the lowest na (nb) orbitals of each named block
    filled (helfem_tpu atomic_scf.py:628-640; the reference's readocc)."""
    occ = np.zeros((2, nblk, blen))
    for a in range(basis.nang):
        key = (int(basis.lval[a]), int(basis.mval[a]))
        if key in occs:
            for spin, nocc in enumerate(occs[key]):
                occ[spin, a, :int(nocc)] = 1.0
    return occ


def _damp_fock_mo(F, C_blocks, occ, blk_idx, S, factor: float) -> np.ndarray:
    """F (host numpy) with the occupied-virtual MO blocks of each symmetry
    block scaled by `factor` in the previous orbitals C_blocks [nblk, blen,
    blen] (helfem_tpu atomic_scf.py:431-455; reference: the --dampfock
    off-diagonal damping, src/atomic/main.cpp:919-935)."""
    F = np.array(F)
    S = np.asarray(S)
    nbf = F.shape[0]
    for b in range(blk_idx.shape[0]):
        idx = blk_idx[b]
        idx = idx[idx < nbf]
        ni = len(idx)
        C = np.asarray(C_blocks[b])[:ni, :ni]
        occm = np.asarray(occ[b])[:ni] > 0
        if not occm.any() or occm.all():
            continue
        Fb = F[np.ix_(idx, idx)]
        Sb = S[np.ix_(idx, idx)]
        M = C.T @ Fb @ C
        M[np.ix_(occm, ~occm)] *= factor
        M[np.ix_(~occm, occm)] *= factor
        F[np.ix_(idx, idx)] = Sb @ C @ M @ C.T @ Sb
    return F


def make_fock(funcs, kfrac: float, nrad: int, dftthr: float = 1e-12,
              restricted: bool = False, kshort: float = 0.0, kernel: str = "erfc",
              rs: ErfcOperators | RSOperators | None = None, Bz: float = 0.0, pairs=None):
    """Fock builder (helfem_tpu's make_fock, atomic_scf.py:149-211):
    fock(ops, g, Vextra, Pa, Pb) -> (Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc,
    Nel, Efield), the energies device scalars; Vextra (the one-electron
    extras, or None) is added to H0 and Efield = <P, Vextra>. Coulomb is
    one radial_coulomb launch; the exchange kfrac K + kshort K_sr(omega),
    with the short-range tables rs of `kernel`, is one radial_exchange
    launch for kfrac K, and one launch for kshort K_sr, radial_erfc_exchange
    on the erfc tables or radial_exchange on the Yukawa tables; each launch
    takes Pa alone when restricted (Pb is Pa) and both spins together
    otherwise. pairs None runs the exchange on the channel diagonals of a
    channel-block-diagonal density (exchange_bd: symmetry 2); else on the
    windows of those channel pairs (exchange_general: symmetry 0 and 1,
    models/atomic.py:channel_pairs). The XC of funcs on the grid g is one
    launch each of dia_xc_fields and dia_xc_fock
    (models/atomic_dft.py:eval_fxc). Bz != 0 adds the spin Zeeman term -+
    Bz/2 S to Fa and Fb after the energies."""
    if kshort != 0.0 and rs is None:
        raise ValueError("make_fock: kshort != 0 needs the short-range tables rs")
    erfc = kernel == "erfc"
    if pairs is None:  # on the channel diagonals
        full, short, extra = exchange_bd, erfc_exchange_bd if erfc else rs_exchange_bd, ()
    else:  # on the channel-pair windows
        full, short, extra = exchange, erfc_exchange if erfc else rs_exchange, (pairs,)

    def K_of(ops, Ps):
        """kfrac K + kshort K_sr of the stacked (or single) spin densities."""
        if pairs is None:
            nang = ops.G.shape[-1]
            Ps = channel_diag(Ps, nang, nrad) if Ps.dim() == 2 else torch.stack(
                [channel_diag(P, nang, nrad) for P in Ps])
        K = 0.0
        if kfrac != 0.0:
            K = kfrac * full(ops, Ps, *extra)
        if kshort != 0.0:
            K = K + kshort * short(ops, rs, Ps, *extra)
        return K

    def fock(ops: AtomicOperators, g, Vextra, Pa: torch.Tensor, Pb: torch.Tensor):
        P = Pa + Pb
        J = coulomb(ops, P)
        H = ops.H0 if Vextra is None else ops.H0 + Vextra
        Fa = Fb = H + J
        Exx = Exc = Nel = Efield = torch.zeros((), dtype=P.dtype, device=P.device)
        if kfrac != 0.0 or kshort != 0.0:
            K = K_of(ops, Pa if restricted else torch.stack((Pa, Pb)))
            Ka, Kb = (K, K) if restricted else K
            Fa, Fb = Fa + Ka, Fb + Kb
            Exx = 0.5 * (vdot(Pa, Ka) + vdot(Pb, Kb))
        if funcs:
            XCa, XCb, Exc, Nel = eval_fxc(funcs, g, Pa, Pa if restricted else Pb, dftthr)
            Fa, Fb = Fa + XCa, Fb + XCb
        if Bz != 0.0:
            Fa, Fb = Fa - 0.5 * Bz * ops.S, Fb + 0.5 * Bz * ops.S
        Ekin = vdot(P, ops.T)
        Enuc = vdot(P, ops.Vnuc)
        Ecoul = 0.5 * vdot(P, J)
        if Vextra is not None:
            Efield = vdot(P, Vextra)
        return Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield

    return fock


def make_fused_step(fock):
    """One restricted SCF iteration on the device: density -> Fock ->
    block-coordinate C2-DIIS (circular history, updated in place) ->
    warm-started blocked eigensolve (eig_blocks_b_warm: the previous step's
    whitened eigenvectors Vw seed K11's sweeps; a failed certificate, as
    after the identity seed or a large DIIS jump, solves cold). Only
    (energy, DIIS error) and the certificate need to reach the host."""

    def step(ops, g, Vextra, blk_idx, blk_sinvh, Sb, occ, C, Vw, histF, histE, count, wgate):
        nbf = ops.S.shape[0]
        Pab = (C * occ[:, None, :]) @ C.mT
        Pa = scatter_blocks(Pab, blk_idx, nbf)
        Fa, _, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield = fock(ops, g, Vextra, Pa, Pa)
        Etot = Ekin + Enuc + Ecoul + Exx + Exc + Efield
        Fab = gather_blocks(Fa, blk_idx)
        err = diis_error_blocks(Fab, Pab, Sb, blk_sinvh)
        errmax = torch.max(torch.abs(err))
        Fuse, count = device_diis_step(histF, histE, count, Fab, err)
        E, Cn, Vw, _ = eig_blocks_b_warm(Fuse, blk_idx, blk_sinvh, nbf, Vw, wgate)
        return Cn, Vw, E, count, Etot, errmax, Nel, torch.stack([Ekin, Enuc, Ecoul, Exx, Exc,
                                                                 Efield])

    return step


def make_fused_chunk(fock):
    """Up to `nrun` fused iterations of the restricted Fock builder `fock`
    (make_fock) with the convergence test (err < convthr and |dE| <
    convthr, the host loop's own) on the device after each; occupations are
    frozen within a chunk. Vw are the whitened eigenvectors of the previous
    eigensolve (the identity before the first chunk). Returns the
    per-iteration orbitals, eigenvalues, energies, errors, grid electron
    counts and energy components, the new DIIS count, the number of
    iterations run and the last step's whitened eigenvectors."""
    step = make_fused_step(fock)

    def chunk(ops, g, Vextra, blk_idx, blk_sinvh, occ, C, Vw, histF, histE, count, convthr,
              Eprev, nrun):
        Sb = gather_blocks(ops.S, blk_idx)
        wgate = warm_gate(convthr)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=C.device)
        Cs, Es, Etots, errs, Nels, comps = [], [], [], [], [], []
        for _ in range(nrun):
            C, Vw, E, count, Etot, errmax, Nel, comp = step(ops, g, Vextra, blk_idx, blk_sinvh,
                                                            Sb, occ, C, Vw, histF, histE, count,
                                                            wgate)
            Cs.append(C)
            Es.append(E)
            Etots.append(Etot)
            errs.append(errmax)
            Nels.append(Nel)
            comps.append(comp)
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        return (Cs, Es, count, torch.stack(Etots), torch.stack(errs), torch.stack(Nels),
                torch.stack(comps), len(Cs), Vw)

    return chunk


def make_fused_chunk_u(fock):
    """Unrestricted analogue of make_fused_chunk (atomic_scf.py:317-413) for
    the two-spin Fock builder `fock`: the DIIS history stores spin-stacked
    block-coordinate Fock pairs with the combined alpha+beta error vector
    (the reference's uDIIS combined-error mode); both spins' blocks go
    through one warm-started eigensolve with a certificate per spin (K11 on
    the spin-stacked blocks, groups=2; Vw [2 nblk, blen, blen] their
    whitened eigenvectors). Returns per iteration the orbitals and
    eigenvalues of both spins, energies (without the constant spin Zeeman
    energy), errors, grid electron counts and energy components, then the
    new DIIS count, the number of iterations run and the last step's Vw."""

    def chunk(ops, g, Vextra, blk_idx, blk_sinvh, occa, occb, Ca, Cb, Vw, histF, histE, count,
              convthr, Eprev, nrun):
        wgate = warm_gate(convthr)
        nbf = ops.S.shape[0]
        nblk = blk_idx.shape[0]
        Sb = gather_blocks(ops.S, blk_idx)
        idx2, sinvh2 = blk_idx.repeat(2, 1), blk_sinvh.repeat(2, 1, 1)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=Ca.device)
        out = []
        for _ in range(nrun):
            Pab = (Ca * occa[:, None, :]) @ Ca.mT
            Pbb = (Cb * occb[:, None, :]) @ Cb.mT
            Pa = scatter_blocks(Pab, blk_idx, nbf)
            Pb = scatter_blocks(Pbb, blk_idx, nbf)
            Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield = fock(ops, g, Vextra, Pa, Pb)
            Etot = Ekin + Enuc + Ecoul + Exx + Exc + Efield
            Fab = gather_blocks(Fa, blk_idx)
            Fbb = gather_blocks(Fb, blk_idx)
            err = torch.cat((diis_error_blocks(Fab, Pab, Sb, blk_sinvh),
                             diis_error_blocks(Fbb, Pbb, Sb, blk_sinvh)))
            errmax = torch.max(torch.abs(err))
            Fuse, count = device_diis_step(histF, histE, count, torch.stack((Fab, Fbb)), err)
            E, C, Vw, _ = eig_blocks_b_warm(Fuse.reshape(2 * nblk, *Fuse.shape[2:]), idx2,
                                            sinvh2, nbf, Vw, wgate, groups=2)
            Ea, Eb, Ca, Cb = E[:nblk], E[nblk:], C[:nblk], C[nblk:]
            out.append((Ca, Cb, Ea, Eb, Etot, errmax, Nel,
                        torch.stack([Ekin, Enuc, Ecoul, Exx, Exc, Efield])))
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        Cas, Cbs, Eas, Ebs, Etots, errs, Nels, comps = zip(*out)
        return (Cas, Cbs, Eas, Ebs, count, torch.stack(Etots), torch.stack(errs),
                torch.stack(Nels), torch.stack(comps), len(out), Vw)

    return chunk


def rs_operators(basis: AtomicBasis, spec: MethodSpec, device):
    """(kfrac, kshort, rs) of a method: its exact-exchange fractions and its
    short-range tables, built on `device` (None without range separation).
    omega = 0 folds kshort into kfrac and builds no tables: the short-range
    kernel is then the full one (helfem_tpu atomic_scf.py:533-540)."""
    kfrac, kshort = spec.kfull, spec.kshort
    if kshort == 0.0:
        return kfrac, 0.0, None
    if spec.omega == 0.0:
        return kfrac + kshort, 0.0, None
    build = basis.build_erfc if spec.kernel == "erfc" else basis.build_yukawa
    return kfrac, kshort, build(spec.omega, device)


def extra_operators(basis: AtomicBasis, Ez: float = 0.0, Qzz: float = 0.0, Bz: float = 0.0,
                    iconf: int = 0, conf_N: int = 0, conf_R: float = 0.0,
                    conf_barrier: float = 0.0, shift_conf: float = 0.0,
                    finitenuc: str = "point", Rrms: float = 0.0, Zl: int = 0, Zr: int = 0,
                    Rmid: float = 0.0):
    """The one-electron extras Vextra [nbf, nbf] (host numpy) of scf_atom,
    or None when there are none (helfem_tpu atomic_scf.py:543-558): the
    finite nucleus less the point nucleus, Ez z, Qzz/3 times the quadrupole,
    the orbital Zeeman and diamagnetic Bz terms, the confinement (iconf 3
    takes conf_barrier as its height) and the off-centre nuclei."""
    terms = []
    if finitenuc != "point":
        terms.append(basis.nuclear_model(finitenuc, Rrms) - basis.nuclear())
    if Ez != 0.0:
        terms.append(Ez * basis.dipole_z())
    if Qzz != 0.0:
        terms.append(Qzz * basis.quadrupole_zz() / 3.0)
    if Bz != 0.0:
        terms.append(basis.Bz_field(Bz))
    if iconf:
        N = conf_N if iconf != 3 else conf_barrier
        terms.append(basis.confinement(N, conf_R, iconf, shift_conf))
    if (Zl or Zr) and Rmid > 0.0:
        terms.append(basis.nuclear_offcenter(Zl, Zr, Rmid))
    if not terms:
        return None
    Vextra = np.zeros((basis.nbf, basis.nbf))
    for t in terms:
        Vextra += t
    return Vextra


def scf_atom(
    basis: AtomicBasis,
    nela: int,
    nelb: int,
    method: str = "HF",
    maxit: int = 100,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    ops: AtomicOperators | None = None,
    dftthr: float = 1e-12,
    restricted: int = -1,
    Ez: float = 0.0,
    Qzz: float = 0.0,
    Bz: float = 0.0,
    iconf: int = 0,
    conf_N: int = 0,
    conf_R: float = 0.0,
    conf_barrier: float = 0.0,
    shift_conf: float = 0.0,
    finitenuc: str = "point",
    Rrms: float = 0.0,
    Zl: int = 0,
    Zr: int = 0,
    Rmid: float = 0.0,
    symmetry: int = -1,
    diisorder: int = 10,
    diiseps: float = 0.1,
    ldft: int = 0,
    device=None,
    grid: AtomGridOps | None = None,
    rs: ErfcOperators | RSOperators | None = None,
    dampfock: float = 1.0,
    dampthr: float = 0.5,
    diisthr: float | None = None,
    occs: dict | None = None,
    perturb: float = 0.0,
    seed: int = 0,
    P0a: np.ndarray | None = None,
    P0b: np.ndarray | None = None,
    maverage: bool = False,
    diag: bool = True,
    eigiter: int = 0,
    save_cb=None,
    ndev: int = 0,
) -> SCFResult:
    """Restricted, unrestricted or ROHF SCF of HF, the ported LDA, GGA and
    meta-GGA functionals, their global hybrids and the range-separated
    hybrids (helfem_tpu's scf_atom). restricted = -1 restricts exactly when
    nela == nelb and Bz == 0, 0 runs UHF/UKS, and 1 with nela != nelb runs
    ROHF through rohf_update on the host loop alone, as helfem_tpu does;
    Bz != 0 never runs restricted. Ez, Qzz, Bz, the confinement (iconf 1-4
    with conf_N, conf_R, conf_barrier, shift_conf), the finite nucleus
    (finitenuc 'gaussian', 'spherical', 'hollow' or 'regularized' with
    Rrms) and the off-centre charges Zl at -Rmid z and Zr at +Rmid z add
    one-electron terms (extra_operators; their energy is Efield), Bz also
    the spin Zeeman -+ Bz/2 S and Emag = -Bz/2 (nela - nelb). symmetry -1
    picks m blocks (1) under Ez, Qzz or off-centre nuclei, else (l,m)
    blocks (2); 0, 1 or 2 forces them. The operators (and the grid of a
    functional, ldft theta points, 0 for 2 lmax + 12, and a range-separated
    method's short-range tables, see rs_operators) are built on `device`
    unless `ops` (and `grid`, `rs`) are given, in which case the SCF runs on
    ops' device; a laplacian-level functional needs its grid built with
    lapl=True. dampfock != 1 scales the occupied-virtual MO blocks of the
    extrapolated Fock by dampfock while the DIIS error is at least dampthr,
    and keeps every iteration on the host loop (helfem_tpu
    atomic_scf.py:692, :871-878); diisthr (not None) blends the host DIIS's
    C2-DIIS and ADIIS weights between diisthr and diiseps (scf/diis.py).

    P0a/P0b (host [nbf, nbf]; P0b None: the same for beta) start from the
    blocked eigensolve of the Fock of that density instead of the model
    potential; a density with cross-channel blocks takes the exchange on
    all channel-pair windows for that one Fock under (l,m) blocks.
    perturb rotates the alpha guess orbitals by perturbation_matrix(seed),
    and an unrestricted run's beta ones (of the unperturbed guess) by its
    own rotation (seed + 1). occs {(l, m): (na, nb)} fixes the occupations
    of the (l,m) blocks (symmetry 2 only, else ValueError). maverage
    averages the Fock's (l,m) blocks over m every iteration; eigiter > 0
    solves each block for its lowest eigiter pairs by shift-invert ARPACK
    (sigma = -0.6 Z^2 - 10) on the host; both keep every iteration on the
    host loop (helfem_tpu atomic_scf.py:692). diag=False whitens with the
    inverse Cholesky factor (reference --diag 0).

    save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb), when given, is the
    crash-recovery hook (helfem_tpu atomic_scf.py:770-779, :826-836,
    :882-886): called after every host iteration and once per fused chunk,
    on the state of the chunk's reported iteration, with host numpy block
    eigenvalues, orbitals and occupations (Eb, Cb, occb None when
    restricted); one card-to-host copy of the orbitals per call.

    ndev >= 1 runs the SCF over ndev ranks (helfem_tpu atomic_scf.py:649-666,
    :692-693): the Fock build on each rank's L range (K1, K2) and grid
    elements (K4, K5), all-reduced, and the blocked eigensolve on its
    symmetry blocks, gathered (parallel/mesh.py), with every iteration on
    the host loop; range-separated exchange raises, as helfem_tpu's does.
    Inside an initialized process group of ndev ranks the call runs this
    rank's share (another size raises); outside any, ndev 1 runs over a
    one-rank group made for the call, and ndev > 1 over ndev spawned ranks
    on copies of the arguments (launch.call; save_cb must then pickle),
    returning rank 0's result. Only rank 0 prints and calls save_cb; rank 0
    broadcasts the occupations and the convergence test's numbers."""
    call_args = dict(locals())
    spec = parse_method_rs(method)  # raises for the functionals the port lacks
    funcs = spec.funcs
    if ndev:
        if spec.kshort != 0.0 and spec.omega != 0.0:
            raise NotImplementedError("--ndev does not support range-separated exchange yet "
                                      "(erfc/yukawa tables)")
        if not launch.in_group():
            if ops is None and device is None:
                raise ValueError("scf_atom needs a device (or prebuilt ops)")
            return launch.call(scf_atom, ndev, (), call_args,
                               ops.device if ops is not None else device)
    if symmetry not in (-1, 0, 1, 2):
        raise ValueError(f"symmetry={symmetry}: 0 (none), 1 (m), 2 (l,m) or -1 (auto)")
    offcentre = bool(Zl or Zr) and Rmid > 0.0
    symm = 1 if (Ez != 0.0 or Qzz != 0.0 or offcentre) else 2
    if symmetry >= 0:
        symm = symmetry
    if ops is None:
        if device is None:
            raise ValueError("scf_atom needs a device (or prebuilt ops)")
        ops = basis.build_operators(device)
    device = ops.device
    mesh = make_mesh(ndev, device=device) if ndev else None
    if mesh is not None and mesh.rank != 0:
        verbose, save_cb = False, None
    nrad = basis.nrad
    kfrac, kshort, rs = (rs_operators(basis, spec, device) if rs is None
                         else (spec.kfull, spec.kshort, rs))
    kernel = spec.kernel
    g = grid
    if funcs and g is None:
        g = build_atomic_grid(basis, device, ntheta=ldft, lapl=needs_lapl(funcs))

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    Vextra_np = extra_operators(basis, Ez, Qzz, Bz, iconf, conf_N, conf_R, conf_barrier,
                                shift_conf, finitenuc, Rrms, Zl, Zr, Rmid)
    Vextra = None if Vextra_np is None else as_dev(Vextra_np)
    rohf = restricted == 1 and nela != nelb
    restricted = ((nela == nelb and Bz == 0.0) if restricted == -1
                  else (restricted == 1 and not rohf and Bz == 0.0))
    S_np = ops.S.cpu().numpy()
    blk_idx_np, blk_sinvh_np = build_blocks(S_np, basis.sym_blocks(symm), chol=not diag)
    blk_idx = torch.as_tensor(blk_idx_np, device=device)
    blk_sinvh = torch.as_tensor(blk_sinvh_np, device=device)
    # (l,m) blocks keep every density channel-block-diagonal: the exchange
    # runs on the channel diagonals; else on the windows of the channel
    # pairs the blocks let through
    pairs = None if symm == 2 else channel_pairs(basis.mval, symm)
    fock = make_fock(funcs, kfrac, nrad, dftthr, restricted=restricted, kshort=kshort,
                     kernel=kernel, rs=rs, Bz=Bz, pairs=pairs)

    def eig(Fs):
        """(host eigenvalues, device orbitals) of each spin's Fock in Fs."""
        out = [eig_blocks(F, blk_idx, blk_sinvh) for F in Fs]
        return [(E.cpu().numpy(), C) for E, C in out]

    if mesh is not None:
        # the loop's Fock build and eigensolve over the mesh; the guess's
        # stay single-rank, as helfem_tpu's (atomic_scf.py:649-666)
        sfock = sharded_atomic_fock(mesh, ops, funcs, g, kfrac, bd=pairs is None, Bz=Bz,
                                    dftthr=dftthr, restricted=restricted, pairs=pairs)[0]
        fock = lambda ops_, g_, Vextra_, Pa, Pb: sfock(Vextra_, Pa, Pb)  # noqa: E731
        seig = sharded_eig_blocks(mesh, blk_idx, blk_sinvh, basis.nbf)

        def eig(Fs):  # noqa: F811 -- both spins in one solve and one gather
            E, C = seig(torch.stack(Fs))
            E = E.cpu().numpy()
            return [(E[s], C[s]) for s in range(len(Fs))]

    # guess: the Fock of a warm-start density, or the model-potential
    # Hamiltonian with the extras (the same orbitals for both spins)
    Cb_w = None
    if P0a is not None:
        P0b_ = P0a if P0b is None else P0b
        gpairs = pairs
        if pairs is None and not (_channel_bd(P0a, basis.nang, nrad)
                                  and _channel_bd(P0b_, basis.nang, nrad)):
            # a lower-symmetry density: its cross-channel blocks would be
            # dropped by the channel-diagonal exchange
            gpairs = channel_pairs(basis.mval, 0)
        fg = make_fock(funcs, kfrac, nrad, dftthr, restricted=P0b is None, kshort=kshort,
                       kernel=kernel, rs=rs, Bz=Bz, pairs=gpairs)
        Pg_a = as_dev(P0a)
        Fg_a, Fg_b, *_ = fg(ops, g, Vextra, Pg_a, Pg_a if P0b is None else as_dev(P0b))
        Ea, Ca = eig_blocks(Fg_a, blk_idx, blk_sinvh)
        if P0b is not None:
            Eb_w, Cb_w = eig_blocks(Fg_b, blk_idx, blk_sinvh)
    else:
        Hg = basis.kinetic() + basis.model_potential(potential(guess, basis.Z, device=device))
        if Vextra_np is not None:
            Hg = Hg + Vextra_np
        Ea, Ca = eig_blocks(as_dev(Hg), blk_idx, blk_sinvh)
    Ea = Ea.cpu().numpy()
    Ca_unpert = Ca
    if perturb:
        Ca = torch.einsum("bpk,kq->bpq", Ca,
                          as_dev(perturbation_matrix(Ca.shape[-1], perturb, seed)))
    if Cb_w is not None:
        Eb, Cb = Eb_w.cpu().numpy(), Cb_w
    else:
        Eb, Cb = Ea.copy(), Ca
        if perturb and not restricted:
            # an independent beta rotation of the unperturbed guess, so that
            # a symmetric guess can break spin symmetry
            Cb = torch.einsum("bpk,kq->bpq", Ca_unpert,
                              as_dev(perturbation_matrix(Ca.shape[-1], perturb, seed + 1)))
    occ_fix = None
    if occs is not None:
        if symm != 2:
            raise ValueError("fixed occupations need (l,m) symmetry blocks")
        occ_fix = fixed_occupations(basis, occs, *blk_idx_np.shape)

    Sinvh_np = full_sinvh(blk_idx_np, blk_sinvh_np, basis.nbf)
    Sinvh_dev = as_dev(Sinvh_np)
    diis = DIIS(S_np, Sinvh_np, max_hist=diisorder, diis_eps=diiseps, diis_thr=diisthr,
                blocks=(blk_idx_np, blk_sinvh_np))
    Sh_np = form_sh(S_np) if rohf else None
    # the natural orbitals of rohf_update take the symmetric inverse square
    # root under --diag 0 too (helfem_tpu passes its Cholesky factor there,
    # and its ROHF then settles 2.7e-5 Eh higher for O at lmax 1)
    Sinvh_rohf = symmetric_sinvh(S_np, blk_idx_np) if rohf else None
    Emag = -0.5 * Bz * (nela - nelb)

    Eold = 0.0
    Etot = 0.0
    Nel = 0.0
    converged = False
    occa = occb = None
    # fused device chunks engage after TWO host iterations; they are
    # load-bearing (helfem_tpu atomic_scf.py:684-697): the host DIIS handles
    # the large-error regime that the chunks' pure C2-DIIS cannot. ROHF's
    # Fock update, the m-average, the MO-basis damping and the iterative
    # eigensolve are host work every iteration, so they stay on the host.
    warmup = (maxit if rohf or maverage or dampfock != 1.0 or eigiter > 0 or mesh is not None
              else 2)
    chunk_len = 4  # chunk schedule 4, 8, 16
    CH = 16
    nhist = 10
    fused = None
    it = 0
    while it < maxit:
        it += 1
        if occ_fix is not None:
            occa = occ_fix[0]
            occb = occa if restricted else occ_fix[1]
        else:
            occa = aufbau_blocks(Ea, nela)
            occb = occa if restricted else aufbau_blocks(Eb, nelb)
        if mesh is not None:  # every rank takes rank 0's decisions
            occa, occb_ = mesh.bcast(occa, occb)
            occb = occa if restricted else occb_

        if it > warmup:
            nblk, blen = blk_idx_np.shape
            if fused is None:
                ns = 1 if restricted else 2
                fused = (make_fused_chunk if restricted else make_fused_chunk_u)(fock)
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
            if restricted:
                Cs, Es, count, Etots, errs, Nels, comps, kmax, Vw = fused(
                    ops, g, Vextra, blk_idx, blk_sinvh, as_dev(occa), Ca, Vw, histF, histE, count,
                    float(convthr), Eold, nrun,
                )
            else:
                # the chunk's energies leave out the constant Emag
                Cs, Cbs, Es, Ebs, count, Etots, errs, Nels, comps, kmax, Vw = fused(
                    ops, g, Vextra, blk_idx, blk_sinvh, as_dev(occa), as_dev(occb), Ca, Cb, Vw,
                    histF, histE, count, float(convthr), Eold - Emag, nrun,
                )
            Etots = Etots.cpu().numpy()
            errs = errs.cpu().numpy()
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k]) + Emag
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"iter {it + k:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e} (fused)")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            # the chunk ran k+1 counted iterations, one already counted above
            it += k
            Ca = Cs[k]
            Ea = Es[k].cpu().numpy()
            if restricted:
                Eb, Cb = Ea, Ca
            else:
                Cb = Cbs[k]
                Eb = Ebs[k].cpu().numpy()
            Nel = float(Nels[k])
            Ekin, Enuc, Ecoul, Exx, Exc, Efield = comps[k].cpu().numpy()
            if save_cb is not None:
                hook_state(save_cb, it, Etot, restricted, Ea, Ca, occa, Eb, Cb, occb)
            if converged or it >= maxit:
                break
            continue

        Pa = density_blocks(Ca, as_dev(occa), blk_idx, ops.S)
        Pb = Pa if restricted else density_blocks(Cb, as_dev(occb), blk_idx, ops.S)
        Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield = fock(ops, g, Vextra, Pa, Pb)
        Etot = float(Ekin + Enuc + Ecoul + Exx + Exc + Efield) + Emag
        Nel = float(Nel)
        dE = Etot - Eold
        Eold = Etot
        if maverage:
            Fa = as_dev(_fock_m_average(Fa.cpu().numpy(), basis))
            Fb = Fa if restricted else as_dev(_fock_m_average(Fb.cpu().numpy(), basis))
        if restricted:
            ev = _diis_error(Fa, Pa, ops.S, Sinvh_dev)
            err = diis.update_with_error([Fa.cpu().numpy()], ev.cpu().numpy())
            (Fa_,) = diis.solve()
            Fb_ = Fa_
        else:
            Fa, Fb, Pa, Pb = (x.cpu().numpy() for x in (Fa, Fb, Pa, Pb))
            if rohf:
                Fa, Fb = rohf_update(Fa, Fb, Pa + Pb, Sh_np, Sinvh_rohf, nela, nelb)
            err = diis.update([Fa, Fb], [Pa, Pb])
            Fa_, Fb_ = diis.solve()
        if mesh is not None:
            err, Etot, dE = (float(x) for x in mesh.bcast(err, Etot, dE))
            Eold = Etot
        if dampfock != 1.0 and err >= dampthr:
            if verbose:
                print(f"damping off-diagonal Fock elements by {dampfock:.3f}")
            Fa_ = _damp_fock_mo(Fa_, Ca.cpu().numpy(), occa, blk_idx_np, S_np, dampfock)
            Fb_ = Fa_ if restricted else _damp_fock_mo(Fb_, Cb.cpu().numpy(), occb, blk_idx_np,
                                                       S_np, dampfock)
        if verbose:
            print(f"iter {it:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e}")
        if save_cb is not None:
            hook_state(save_cb, it, Etot, restricted, Ea, Ca, occa, Eb, Cb, occb)
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
            break
        if eigiter > 0:
            # the lowest eigiter pairs of each block by shift-invert ARPACK
            # (reference: scf::eig_iter); orbital energies lie above -Z^2/2
            sigma = -0.6 * basis.Z**2 - 10.0
            Ea, Ca = eig_blocks_iter(Fa_, blk_idx_np, blk_sinvh_np, eigiter, sigma)
            if mesh is not None:  # ARPACK's start vector is random: rank 0's pairs
                Ea, Ca = mesh.bcast(Ea, Ca)
            Ca = as_dev(Ca)
            if restricted:
                Eb, Cb = Ea, Ca
            else:
                Eb, Cb = eig_blocks_iter(Fb_, blk_idx_np, blk_sinvh_np, eigiter, sigma)
                if mesh is not None:
                    Eb, Cb = mesh.bcast(Eb, Cb)
                Cb = as_dev(Cb)
            continue
        spins = eig([as_dev(Fa_)] if restricted else [as_dev(Fa_), as_dev(Fb_)])
        (Ea, Ca), (Eb, Cb) = spins[0], spins[-1]

    labels = basis.sym_labels(symm)

    def _sorted_syms(E):
        """Block label per sorted eigenvalue (padded _BIG slots dropped)."""
        flat = E.ravel()
        order = np.argsort(flat)
        order = order[flat[order] < _BIG / 2]
        return [labels[i // E.shape[1]] for i in order]

    def _sorted(E):
        e = np.sort(E.ravel())
        return e[e < _BIG / 2]

    return SCFResult(
        converged=converged,
        niter=it,
        E=Etot,
        Ekin=float(Ekin),
        Enuc=float(Enuc),
        Ecoul=float(Ecoul),
        Exx=float(Exx),
        Exc=float(Exc),
        Nelgrid=float(Nel),
        Efield=float(Efield),
        orbE_a=_sorted(Ea),
        orbs_a=Ca.cpu().numpy(),
        occ_a=occa,
        orbE_b=None if restricted else _sorted(Eb),
        orbs_b=None if restricted else Cb.cpu().numpy(),
        occ_b=None if restricted else occb,
        orbsym_a=_sorted_syms(Ea),
        orbsym_b=None if restricted else _sorted_syms(Eb),
        orbE_blocks_a=Ea,
        orbE_blocks_b=None if restricted else Eb,
        symm_used=symm,
    )


def atomic_analysis(basis: AtomicBasis, res: SCFResult, symm: int = 2) -> dict:
    """Post-SCF analysis (helfem_tpu atomic_scf.py:952-990; reference:
    src/atomic/main.cpp:1000-1059), host numpy on the result's block
    orbitals over the blocks of symmetry `symm` (the run's, res.symm_used):
    <r^n> for n = -1, 1, 2, 3; the density n(0) and its gradient n'(0) at
    the nucleus (s shells alone reach it) and the cusp -n'(0)/(2 Z n(0));
    the dipole -<z> and the quadrupole -<(3 z^2 - r^2)/2>; the virial
    ratio -E/T."""
    blk_idx = build_blocks(basis.overlap(), basis.sym_blocks(symm))[0]
    nbf = basis.nbf

    def full_P(C, occ):
        P = np.zeros((nbf + 1, nbf + 1))
        Pb = np.einsum("bpk,bk,bqk->bpq", np.asarray(C), occ, np.asarray(C))
        for b in range(blk_idx.shape[0]):
            P[np.ix_(blk_idx[b], blk_idx[b])] += Pb[b]
        return P[:nbf, :nbf]

    Pa = full_P(res.orbs_a, res.occ_a)
    P = Pa + (full_P(res.orbs_b, res.occ_b) if res.orbs_b is not None else Pa)
    out = {}
    for n in (-1, 1, 2, 3):
        out[f"<r^{n}>"] = float(np.vdot(P, np.kron(np.eye(basis.nang),
                                                   basis.rb.radial_integral(n))))
    B0, dB0 = np.zeros(nbf), np.zeros(nbf)
    nrad = basis.nrad
    for a in np.nonzero((basis.lval == 0) & (basis.mval == 0))[0]:
        B0[a * nrad:(a + 1) * nrad] = basis.rb.bf_at_origin()
        dB0[a * nrad:(a + 1) * nrad] = basis.rb.dbf_at_origin()
    y00sq = 1.0 / (4.0 * np.pi)
    n0 = float(B0 @ P @ B0) * y00sq
    dn0 = 2.0 * float(dB0 @ P @ B0) * y00sq
    out["density_at_nucleus"] = n0
    out["density_gradient_at_nucleus"] = dn0
    out["cusp"] = -dn0 / (2.0 * basis.Z * n0) if n0 > 0 and basis.Z else 0.0
    out["dipole_z"] = -float(np.vdot(P, basis.dipole_z()))
    out["quadrupole_zz"] = -float(np.vdot(P, basis.quadrupole_zz()))
    out["virial_ratio"] = -res.E / res.Ekin if res.Ekin else 0.0
    return out
