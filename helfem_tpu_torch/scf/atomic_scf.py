"""Atomic SCF driver (L7), ported from helfem_tpu/scf/atomic_scf.py.

The port runs HF, the ported LDA, GGA and meta-GGA functionals (BR89, the
laplacian-level one, among them), their
global hybrids (PBE0, B3LYP5, TPSSh) and the range-separated hybrids
(LC-LDA, LDAERF, LCY-LDA, SR-PBE0: kfull K + kshort K_sr(omega), the erfc
or Yukawa kernel), restricted (RHF/RKS), unrestricted (UHF/UKS) or ROHF,
under (l,m) symmetry blocks (symmetry=2):

  two host iterations (Fock on the device, host DIIS) ->
  fused device chunks of 4, 8, then 16 iterations: density -> Coulomb,
  block-diagonal exchange and the XC grid (CUDA kernels on the card) ->
  block-coordinate C2-DIIS -> batched whitened eigensolve, with the
  convergence test on the device after every iteration.

ROHF and Fock damping (dampfock/dampthr, the occupied-virtual MO blocks
scaled while the DIIS error is at least dampthr) stay on the host loop
(their Fock updates are host numpy every iteration), as in helfem_tpu;
diisthr blends the host DIIS's C2-DIIS and ADIIS weights between diisthr
and diiseps. helfem_tpu's lax.while_loop chunk becomes a
Python loop over tensors that stay on the device; one boolean per iteration
comes back to stop the chunk. Every other scf_atom option (fields,
confinement, finite nuclei, --ndev, --eigiter, m-averaging, ...)
raises NotImplementedError: nothing falls back silently.
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
    coulomb,
    erfc_exchange_bd,
    exchange_bd,
    rs_exchange_bd,
)
from helfem_tpu_torch.models.atomic_dft import (
    AtomGridOps,
    build_atomic_grid,
    eval_fxc,
    needs_lapl,
)
from helfem_tpu_torch.ops.xc import MethodSpec, parse_method_rs
from helfem_tpu_torch.scf.common import (
    aufbau_blocks,
    diis_error_blocks,
    full_sinvh,
    reject_unported,
    vdot,
)
from helfem_tpu_torch.scf.diis import DIIS, device_diis_step
from helfem_tpu_torch.scf.guess import potential
from helfem_tpu_torch.utils.linalg import (
    _BIG,
    build_blocks,
    density_blocks,
    eig_blocks,
    eig_blocks_b,
    form_sh,
    gather_blocks,
    rohf_update,
    scatter_blocks,
)

__all__ = ["scf_atom", "SCFResult", "aufbau_blocks", "make_fock", "rs_operators"]


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


def _diis_error(F, P, S, Sinvh):
    FPS = F @ P @ S
    e = Sinvh.T @ (FPS - FPS.T) @ Sinvh
    return e.reshape(-1)


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
              rs: ErfcOperators | RSOperators | None = None):
    """Fock builder for channel-block-diagonal densities (helfem_tpu's
    make_fock with bd=True, atomic_scf.py:149-211; no fields): fock(ops, g,
    Pa, Pb) -> (Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel), the energies
    device scalars. Coulomb is one radial_coulomb launch; the exchange
    kfrac K + kshort K_sr(omega), with the short-range tables rs of
    `kernel`, is one radial_exchange launch for kfrac K, and one launch for
    kshort K_sr, radial_erfc_exchange on the erfc tables or radial_exchange
    on the Yukawa tables; each launch takes Pa alone when restricted (Pb is
    Pa) and both spins together otherwise. The XC of funcs on the grid g is
    one launch each of dia_xc_fields and dia_xc_fock
    (models/atomic_dft.py:eval_fxc)."""
    if kshort != 0.0 and rs is None:
        raise ValueError("make_fock: kshort != 0 needs the short-range tables rs")
    sr_exchange = erfc_exchange_bd if kernel == "erfc" else rs_exchange_bd

    def fock(ops: AtomicOperators, g, Pa: torch.Tensor, Pb: torch.Tensor):
        P = Pa + Pb
        J = coulomb(ops, P)
        Fa = Fb = ops.H0 + J
        Exx = Exc = Nel = torch.zeros((), dtype=P.dtype, device=P.device)
        if kfrac != 0.0 or kshort != 0.0:
            nang = ops.G.shape[-1]
            Pd = (channel_diag(Pa, nang, nrad) if restricted else
                  torch.stack((channel_diag(Pa, nang, nrad), channel_diag(Pb, nang, nrad))))
            K = 0.0
            if kfrac != 0.0:
                K = kfrac * exchange_bd(ops, Pd)
            if kshort != 0.0:
                K = K + kshort * sr_exchange(ops, rs, Pd)
            Ka, Kb = (K, K) if restricted else K
            Fa, Fb = Fa + Ka, Fb + Kb
            Exx = 0.5 * (vdot(Pa, Ka) + vdot(Pb, Kb))
        if funcs:
            XCa, XCb, Exc, Nel = eval_fxc(funcs, g, Pa, Pa if restricted else Pb, dftthr)
            Fa, Fb = Fa + XCa, Fb + XCb
        Ekin = vdot(P, ops.T)
        Enuc = vdot(P, ops.Vnuc)
        Ecoul = 0.5 * vdot(P, J)
        return Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    return fock


def _components(Ekin, Enuc, Ecoul, Exx, Exc):
    """[Ekin, Enuc, Ecoul, Exx, Exc, Efield] (no field terms here)."""
    return torch.stack([Ekin, Enuc, Ecoul, Exx, Exc, torch.zeros_like(Ekin)])


def make_fused_step(funcs, kfrac: float, nrad: int, dftthr: float = 1e-12,
                    kshort: float = 0.0, kernel: str = "erfc", rs=None):
    """One restricted SCF iteration on the device: density -> Fock ->
    block-coordinate C2-DIIS (circular history, updated in place) ->
    blocked eigensolve. Only (energy, DIIS error) need to reach the host."""
    fock = make_fock(funcs, kfrac, nrad, dftthr, restricted=True, kshort=kshort,
                     kernel=kernel, rs=rs)

    def step(ops, g, blk_idx, blk_sinvh, Sb, occ, C, histF, histE, count):
        nbf = ops.S.shape[0]
        Pab = torch.einsum("bpk,bk,bqk->bpq", C, occ, C)
        Pa = scatter_blocks(Pab, blk_idx, nbf)
        Fa, _, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Pa)
        Etot = Ekin + Enuc + Ecoul + Exx + Exc
        Fab = gather_blocks(Fa, blk_idx)
        err = diis_error_blocks(Fab, Pab, Sb, blk_sinvh)
        errmax = torch.max(torch.abs(err))
        Fuse, count = device_diis_step(histF, histE, count, Fab, err)
        E, Cn = eig_blocks_b(Fuse, blk_idx, blk_sinvh, nbf)
        return Cn, E, count, Etot, errmax, Nel, _components(Ekin, Enuc, Ecoul, Exx, Exc)

    return step


def make_fused_chunk(funcs, kfrac: float, nrad: int, dftthr: float = 1e-12,
                     kshort: float = 0.0, kernel: str = "erfc", rs=None):
    """Up to `nrun` fused iterations with the convergence test (err <
    convthr and |dE| < convthr, the host loop's own) on the device after
    each; occupations are frozen within a chunk. Returns the per-iteration
    orbitals, eigenvalues, energies, errors, grid electron counts and
    energy components, the new DIIS count and the number of iterations
    run."""
    step = make_fused_step(funcs, kfrac, nrad, dftthr, kshort, kernel, rs)

    def chunk(ops, g, blk_idx, blk_sinvh, occ, C, histF, histE, count, convthr,
              Eprev, nrun):
        Sb = gather_blocks(ops.S, blk_idx)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=C.device)
        Cs, Es, Etots, errs, Nels, comps = [], [], [], [], [], []
        for _ in range(nrun):
            C, E, count, Etot, errmax, Nel, comp = step(ops, g, blk_idx, blk_sinvh, Sb,
                                                        occ, C, histF, histE, count)
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
                torch.stack(comps), len(Cs))

    return chunk


def make_fused_chunk_u(funcs, kfrac: float, nrad: int, dftthr: float = 1e-12,
                       kshort: float = 0.0, kernel: str = "erfc", rs=None):
    """Unrestricted analogue of make_fused_chunk (atomic_scf.py:317-413):
    the DIIS history stores spin-stacked block-coordinate Fock pairs with
    the combined alpha+beta error vector (the reference's uDIIS
    combined-error mode); both spins' blocks go through one batched
    eigensolve. Returns per iteration the orbitals and eigenvalues of both
    spins, energies, errors, grid electron counts and energy components,
    then the new DIIS count and the number of iterations run."""
    fock = make_fock(funcs, kfrac, nrad, dftthr, restricted=False, kshort=kshort,
                     kernel=kernel, rs=rs)

    def chunk(ops, g, blk_idx, blk_sinvh, occa, occb, Ca, Cb, histF, histE, count,
              convthr, Eprev, nrun):
        nbf = ops.S.shape[0]
        nblk = blk_idx.shape[0]
        Sb = gather_blocks(ops.S, blk_idx)
        idx2, sinvh2 = blk_idx.repeat(2, 1), blk_sinvh.repeat(2, 1, 1)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=Ca.device)
        out = []
        for _ in range(nrun):
            Pab = torch.einsum("bpk,bk,bqk->bpq", Ca, occa, Ca)
            Pbb = torch.einsum("bpk,bk,bqk->bpq", Cb, occb, Cb)
            Pa = scatter_blocks(Pab, blk_idx, nbf)
            Pb = scatter_blocks(Pbb, blk_idx, nbf)
            Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Pb)
            Etot = Ekin + Enuc + Ecoul + Exx + Exc
            Fab = gather_blocks(Fa, blk_idx)
            Fbb = gather_blocks(Fb, blk_idx)
            err = torch.cat((diis_error_blocks(Fab, Pab, Sb, blk_sinvh),
                             diis_error_blocks(Fbb, Pbb, Sb, blk_sinvh)))
            errmax = torch.max(torch.abs(err))
            Fuse, count = device_diis_step(histF, histE, count, torch.stack((Fab, Fbb)), err)
            E, C = eig_blocks_b(Fuse.reshape(2 * nblk, *Fuse.shape[2:]), idx2, sinvh2, nbf)
            Ea, Eb, Ca, Cb = E[:nblk], E[nblk:], C[:nblk], C[nblk:]
            out.append((Ca, Cb, Ea, Eb, Etot, errmax, Nel,
                        _components(Ekin, Enuc, Ecoul, Exx, Exc)))
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        Cas, Cbs, Eas, Ebs, Etots, errs, Nels, comps = zip(*out)
        return (Cas, Cbs, Eas, Ebs, count, torch.stack(Etots), torch.stack(errs),
                torch.stack(Nels), torch.stack(comps), len(out))

    return chunk


# scf_atom options of helfem_tpu that the port does not cover, with the
# default values under which they are inert
_UNPORTED = {
    "Ez": 0.0, "Qzz": 0.0, "Bz": 0.0, "iconf": 0,
    "conf_N": 0, "conf_R": 0.0, "conf_barrier": 0.0, "shift_conf": 0.0,
    "finitenuc": "point", "Rrms": 0.0, "Zl": 0, "Zr": 0, "Rmid": 0.0,
    "occs": None, "perturb": 0.0, "seed": 0, "P0a": None, "P0b": None,
    "save_cb": None, "maverage": False, "diag": True, "eigiter": 0, "ndev": 0,
}


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
    **unported,
) -> SCFResult:
    """Restricted, unrestricted or ROHF SCF of HF, the ported LDA, GGA and
    meta-GGA functionals, their global hybrids and the range-separated
    hybrids under (l,m) symmetry blocks
    (helfem_tpu's scf_atom at symmetry 2). restricted = -1 restricts
    exactly when nela == nelb, 0 runs UHF/UKS, and 1 with nela != nelb runs
    ROHF through rohf_update on the host loop alone, as helfem_tpu does.
    The operators (and the grid of a functional, ldft theta points, 0 for
    2 lmax + 12, and a range-separated method's short-range tables, see
    rs_operators) are built on `device` unless `ops` (and `grid`, `rs`)
    are given, in which case the SCF runs on ops' device; a
    laplacian-level functional needs its grid built with lapl=True.
    dampfock != 1 scales the occupied-virtual MO blocks of the extrapolated
    Fock by dampfock while the DIIS error is at least dampthr, and keeps
    every iteration on the host loop (helfem_tpu atomic_scf.py:692, :871-
    878); diisthr (not None) blends the host DIIS's C2-DIIS and ADIIS
    weights between diisthr and diiseps (scf/diis.py)."""
    reject_unported(unported, _UNPORTED, "scf_atom")
    spec = parse_method_rs(method)  # raises for the functionals the port lacks
    funcs = spec.funcs
    if symmetry not in (-1, 2):
        raise NotImplementedError(f"symmetry={symmetry}: only (l,m) blocks "
                                  "(symmetry 2) are ported")
    symm = 2
    if ops is None:
        if device is None:
            raise ValueError("scf_atom needs a device (or prebuilt ops)")
        ops = basis.build_operators(device)
    device = ops.device
    nrad = basis.nrad
    kfrac, kshort, rs = (rs_operators(basis, spec, device) if rs is None
                         else (spec.kfull, spec.kshort, rs))
    kernel = spec.kernel
    g = grid
    if funcs and g is None:
        g = build_atomic_grid(basis, device, ntheta=ldft, lapl=needs_lapl(funcs))
    rohf = restricted == 1 and nela != nelb
    restricted = nela == nelb if restricted == -1 else (restricted == 1 and not rohf)
    S_np = ops.S.cpu().numpy()
    blk_idx_np, blk_sinvh_np = build_blocks(S_np, basis.sym_blocks(symm))
    blk_idx = torch.as_tensor(blk_idx_np, device=device)
    blk_sinvh = torch.as_tensor(blk_sinvh_np, device=device)
    fock = make_fock(funcs, kfrac, nrad, dftthr, restricted=restricted, kshort=kshort,
                     kernel=kernel, rs=rs)

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    # guess: model-potential Hamiltonian, the same orbitals for both spins
    Hg = as_dev(basis.kinetic()
                + basis.model_potential(potential(guess, basis.Z, device=device)))
    Ea, Ca = eig_blocks(Hg, blk_idx, blk_sinvh)
    Ea = Ea.cpu().numpy()
    Eb, Cb = Ea.copy(), Ca

    Sinvh_np = full_sinvh(blk_idx_np, blk_sinvh_np, basis.nbf)
    Sinvh_dev = as_dev(Sinvh_np)
    diis = DIIS(S_np, Sinvh_np, max_hist=diisorder, diis_eps=diiseps, diis_thr=diisthr,
                blocks=(blk_idx_np, blk_sinvh_np))
    Sh_np = form_sh(S_np) if rohf else None

    Eold = 0.0
    Etot = 0.0
    Nel = 0.0
    converged = False
    occa = occb = None
    # fused device chunks engage after TWO host iterations; they are
    # load-bearing (helfem_tpu atomic_scf.py:684-697): the host DIIS handles
    # the large-error regime that the chunks' pure C2-DIIS cannot. ROHF's
    # Fock update and the MO-basis damping are host work every iteration,
    # so they stay on the host.
    warmup = maxit if rohf or dampfock != 1.0 else 2
    chunk_len = 4  # chunk schedule 4, 8, 16
    CH = 16
    nhist = 10
    fused = None
    it = 0
    while it < maxit:
        it += 1
        occa = aufbau_blocks(Ea, nela)
        occb = occa if restricted else aufbau_blocks(Eb, nelb)

        if it > warmup:
            nblk, blen = blk_idx_np.shape
            if fused is None:
                ns = 1 if restricted else 2
                fused = (make_fused_chunk if restricted else make_fused_chunk_u)(
                    funcs, kfrac, nrad, dftthr, kshort, kernel, rs)
                histF = torch.zeros((nhist, *(() if restricted else (2,)), nblk, blen, blen),
                                    dtype=torch.float64, device=device)
                histE = torch.zeros((nhist, ns * nblk * blen * blen), dtype=torch.float64,
                                    device=device)
                count = 0
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            if restricted:
                Cs, Es, count, Etots, errs, Nels, comps, kmax = fused(
                    ops, g, blk_idx, blk_sinvh, as_dev(occa), Ca, histF, histE, count,
                    float(convthr), Eold, nrun,
                )
            else:
                Cs, Cbs, Es, Ebs, count, Etots, errs, Nels, comps, kmax = fused(
                    ops, g, blk_idx, blk_sinvh, as_dev(occa), as_dev(occb), Ca, Cb, histF,
                    histE, count, float(convthr), Eold, nrun,
                )
            Etots = Etots.cpu().numpy()
            errs = errs.cpu().numpy()
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k])
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
            if converged or it >= maxit:
                break
            continue

        Pa = density_blocks(Ca, as_dev(occa), blk_idx, ops.S)
        Pb = Pa if restricted else density_blocks(Cb, as_dev(occb), blk_idx, ops.S)
        Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Pb)
        Efield = 0.0
        Etot = float(Ekin + Enuc + Ecoul + Exx + Exc)
        Nel = float(Nel)
        dE = Etot - Eold
        Eold = Etot
        if restricted:
            ev = _diis_error(Fa, Pa, ops.S, Sinvh_dev)
            err = diis.update_with_error([Fa.cpu().numpy()], ev.cpu().numpy())
            (Fa_,) = diis.solve()
            Fb_ = Fa_
        else:
            Fa, Fb, Pa, Pb = (x.cpu().numpy() for x in (Fa, Fb, Pa, Pb))
            if rohf:
                Fa, Fb = rohf_update(Fa, Fb, Pa + Pb, Sh_np, Sinvh_np, nela, nelb)
            err = diis.update([Fa, Fb], [Pa, Pb])
            Fa_, Fb_ = diis.solve()
        if dampfock != 1.0 and err >= dampthr:
            if verbose:
                print(f"damping off-diagonal Fock elements by {dampfock:.3f}")
            Fa_ = _damp_fock_mo(Fa_, Ca.cpu().numpy(), occa, blk_idx_np, S_np, dampfock)
            Fb_ = Fa_ if restricted else _damp_fock_mo(Fb_, Cb.cpu().numpy(), occb, blk_idx_np,
                                                       S_np, dampfock)
        if verbose:
            print(f"iter {it:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e}")
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
            break
        Ea, Ca = eig_blocks(as_dev(Fa_), blk_idx, blk_sinvh)
        Ea = Ea.cpu().numpy()
        if restricted:
            Eb, Cb = Ea, Ca
        else:
            Eb, Cb = eig_blocks(as_dev(Fb_), blk_idx, blk_sinvh)
            Eb = Eb.cpu().numpy()

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
