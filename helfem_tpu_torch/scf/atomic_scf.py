"""Atomic SCF driver (L7), ported from helfem_tpu/scf/atomic_scf.py.

This slice runs closed-shell restricted Hartree-Fock under (l,m) symmetry
blocks (symmetry=2), the path of the Ar HF bench config:

  two host iterations (Fock on the device, host DIIS) ->
  fused device chunks of 4, 8, then 16 iterations: density -> Coulomb and
  block-diagonal exchange (CUDA kernels on the card) -> block-coordinate
  C2-DIIS -> batched whitened eigensolve, with the convergence test on the
  device after every iteration.

helfem_tpu's lax.while_loop chunk becomes a Python loop over tensors that
stay on the device; one boolean per iteration comes back to stop the chunk.
Every other scf_atom option (UHF/ROHF, DFT, range separation, fields,
confinement, finite nuclei, --ndev, --eigiter, m-averaging, damping, ...)
raises NotImplementedError: nothing falls back silently.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from helfem_tpu_torch.models.atomic import (
    AtomicBasis,
    AtomicOperators,
    channel_diag,
    coulomb,
    exchange_bd,
)
from helfem_tpu_torch.ops.xc import parse_method_rs
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
    gather_blocks,
    scatter_blocks,
)

__all__ = ["scf_atom", "SCFResult", "aufbau_blocks", "hf_kfrac"]


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


def make_fock(kfrac: float, nrad: int):
    """Fock builder of restricted HF for channel-block-diagonal densities
    (helfem_tpu's make_fock with restricted=True and bd=True; no XC, fields
    or range separation): fock(ops, Pa) -> (Fa, Ekin, Enuc, Ecoul, Exx)."""

    def fock(ops: AtomicOperators, Pa: torch.Tensor):
        P = Pa + Pa
        J = coulomb(ops, P)
        nang = ops.G.shape[-1]
        Ka = kfrac * exchange_bd(ops, channel_diag(Pa, nang, nrad))
        Fa = ops.H0 + J + Ka
        Exx = 0.5 * (vdot(Pa, Ka) + vdot(Pa, Ka))
        Ekin = vdot(P, ops.T)
        Enuc = vdot(P, ops.Vnuc)
        Ecoul = 0.5 * vdot(P, J)
        return Fa, Ekin, Enuc, Ecoul, Exx

    return fock


def make_fused_step(kfrac: float, nrad: int):
    """One restricted SCF iteration on the device: density -> Fock ->
    block-coordinate C2-DIIS (circular history, updated in place) ->
    blocked eigensolve. Only (energy, DIIS error) need to reach the host."""
    fock = make_fock(kfrac, nrad)

    def step(ops, blk_idx, blk_sinvh, Sb, occ, C, histF, histE, count):
        nbf = ops.S.shape[0]
        Pab = torch.einsum("bpk,bk,bqk->bpq", C, occ, C)
        Pa = scatter_blocks(Pab, blk_idx, nbf)
        Fa, Ekin, Enuc, Ecoul, Exx = fock(ops, Pa)
        Etot = Ekin + Enuc + Ecoul + Exx
        Fab = gather_blocks(Fa, blk_idx)
        err = diis_error_blocks(Fab, Pab, Sb, blk_sinvh)
        errmax = torch.max(torch.abs(err))
        Fuse, count = device_diis_step(histF, histE, count, Fab, err)
        E, Cn = eig_blocks_b(Fuse, blk_idx, blk_sinvh, nbf)
        zero = torch.zeros_like(Ekin)
        comps = torch.stack([Ekin, Enuc, Ecoul, Exx, zero, zero])
        return Cn, E, count, Etot, errmax, comps

    return step


def make_fused_chunk(kfrac: float, nrad: int):
    """Up to `nrun` fused iterations with the convergence test (err <
    convthr and |dE| < convthr, the host loop's own) on the device after
    each; occupations are frozen within a chunk. Returns the per-iteration
    orbitals, eigenvalues, energies, errors and energy components, the new
    DIIS count and the number of iterations run."""
    step = make_fused_step(kfrac, nrad)

    def chunk(ops, blk_idx, blk_sinvh, occ, C, histF, histE, count, convthr,
              Eprev, nrun):
        Sb = gather_blocks(ops.S, blk_idx)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=C.device)
        Cs, Es, Etots, errs, comps = [], [], [], [], []
        for _ in range(nrun):
            C, E, count, Etot, errmax, comp = step(ops, blk_idx, blk_sinvh, Sb,
                                                   occ, C, histF, histE, count)
            Cs.append(C)
            Es.append(E)
            Etots.append(Etot)
            errs.append(errmax)
            comps.append(comp)
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        return (Cs, Es, count, torch.stack(Etots), torch.stack(errs),
                torch.stack(comps), len(Cs))

    return chunk


# scf_atom options of helfem_tpu that this slice does not cover, with the
# default values under which they are inert
_UNPORTED = {
    "dftthr": 1e-12, "Ez": 0.0, "Qzz": 0.0, "Bz": 0.0, "iconf": 0,
    "conf_N": 0, "conf_R": 0.0, "conf_barrier": 0.0, "shift_conf": 0.0,
    "finitenuc": "point", "Rrms": 0.0, "Zl": 0, "Zr": 0, "Rmid": 0.0,
    "occs": None, "perturb": 0.0, "seed": 0, "P0a": None, "P0b": None,
    "save_cb": None, "maverage": False, "dampfock": 1.0, "dampthr": 0.5,
    "ldft": 0, "diag": True, "eigiter": 0, "ndev": 0, "diisthr": None,
}


def hf_kfrac(method: str) -> float:
    """Exact-exchange fraction of a method this slice runs on atoms: HF
    only; every functional raises (atomic DFT is not ported yet)."""
    spec = parse_method_rs(method)
    if spec.funcs or spec.kshort:
        raise NotImplementedError(
            f"method '{method}': atomic DFT is not ported to helfem_tpu_torch "
            "yet; only HF runs on atoms (see ROADMAP.md)"
        )
    return spec.kfull


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
    restricted: int = -1,
    symmetry: int = -1,
    diisorder: int = 10,
    diiseps: float = 0.1,
    device=None,
    **unported,
) -> SCFResult:
    """Closed-shell restricted HF (helfem_tpu's scf_atom for nela == nelb,
    method 'HF', symmetry 2). The operators are built on `device` unless
    `ops` is given, in which case the SCF runs on ops' device."""
    reject_unported(unported, _UNPORTED, "scf_atom")
    kfrac = hf_kfrac(method)
    if nela != nelb or restricted == 0:
        raise NotImplementedError("unrestricted and ROHF SCF are not ported to "
                                  "helfem_tpu_torch yet; only closed-shell RHF")
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
    S_np = ops.S.cpu().numpy()
    blk_idx_np, blk_sinvh_np = build_blocks(S_np, basis.sym_blocks(symm))
    blk_idx = torch.as_tensor(blk_idx_np, device=device)
    blk_sinvh = torch.as_tensor(blk_sinvh_np, device=device)
    fock = make_fock(kfrac, nrad)

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    # guess: model-potential Hamiltonian
    Hg = as_dev(basis.kinetic()
                + basis.model_potential(potential(guess, basis.Z, device=device)))
    Ea, Ca = eig_blocks(Hg, blk_idx, blk_sinvh)
    Ea = Ea.cpu().numpy()

    Sinvh_np = full_sinvh(blk_idx_np, blk_sinvh_np, basis.nbf)
    Sinvh_dev = as_dev(Sinvh_np)
    diis = DIIS(S_np, Sinvh_np, max_hist=diisorder, diis_eps=diiseps,
                blocks=(blk_idx_np, blk_sinvh_np))

    Eold = 0.0
    Etot = 0.0
    converged = False
    occa = None
    # fused device chunks engage after TWO host iterations; they are
    # load-bearing (helfem_tpu atomic_scf.py:684-697): the host DIIS handles
    # the large-error regime that the chunks' pure C2-DIIS cannot
    warmup = 2
    chunk_len = 4  # chunk schedule 4, 8, 16
    fused = None
    it = 0
    while it < maxit:
        it += 1
        occa = aufbau_blocks(Ea, nela)

        if it > warmup:
            if fused is None:
                nhist = 10
                CH = 16
                fused = make_fused_chunk(kfrac, nrad)
                nblk, blen = blk_idx_np.shape
                histF = torch.zeros((nhist, nblk, blen, blen), dtype=torch.float64, device=device)
                histE = torch.zeros((nhist, nblk * blen * blen), dtype=torch.float64, device=device)
                count = 0
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            Cs, Es, count, Etots, errs, comps, kmax = fused(
                ops, blk_idx, blk_sinvh, as_dev(occa), Ca, histF, histE, count,
                float(convthr), Eold, nrun,
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
            Ekin, Enuc, Ecoul, Exx, Exc, Efield = comps[k].cpu().numpy()
            if converged or it >= maxit:
                break
            continue

        Pa = density_blocks(Ca, as_dev(occa), blk_idx, ops.S)
        Fa, Ekin, Enuc, Ecoul, Exx = fock(ops, Pa)
        Exc = Efield = 0.0
        Etot = float(Ekin + Enuc + Ecoul + Exx)
        dE = Etot - Eold
        Eold = Etot
        ev = _diis_error(Fa, Pa, ops.S, Sinvh_dev)
        err = diis.update_with_error([Fa.cpu().numpy()], ev.cpu().numpy())
        (Fa_,) = diis.solve()
        if verbose:
            print(f"iter {it:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e}")
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
            break
        Ea, Ca = eig_blocks(as_dev(Fa_), blk_idx, blk_sinvh)
        Ea = Ea.cpu().numpy()

    labels = basis.sym_labels(symm)

    def _sorted_syms(E):
        """Block label per sorted eigenvalue (padded _BIG slots dropped)."""
        flat = E.ravel()
        order = np.argsort(flat)
        order = order[flat[order] < _BIG / 2]
        return [labels[i // E.shape[1]] for i in order]

    oe = np.sort(Ea.ravel())
    return SCFResult(
        converged=converged,
        niter=it,
        E=Etot,
        Ekin=float(Ekin),
        Enuc=float(Enuc),
        Ecoul=float(Ecoul),
        Exx=float(Exx),
        Exc=float(Exc),
        Nelgrid=0.0,
        Efield=float(Efield),
        orbE_a=oe[oe < _BIG / 2],
        orbs_a=Ca.cpu().numpy(),
        occ_a=occa,
        orbsym_a=_sorted_syms(Ea),
        orbE_blocks_a=Ea,
        symm_used=symm,
    )

