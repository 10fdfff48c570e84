"""Diatomic SCF driver (L7), ported from helfem_tpu/scf/diatomic_scf.py.

The port runs closed-shell restricted Hartree-Fock, LDA and GGA
functionals and the PBE0 hybrid under the diatomic symmetry blocks (m, plus
g/u for homonuclear), the paths of the N2 HF and N2 PBE bench configs:

  guess (core, or SAP/GSZ/TF of the two atoms) -> two host iterations (Fock
  on the device, host DIIS with ADIIS far from convergence) -> fused device
  chunks of 4, 8, then 16 iterations: density and occupied orbitals ->
  Coulomb (M = 0 channels), occupied-orbital exchange and XC Fock (CUDA
  kernels on the card) ->
  block-coordinate C2-DIIS -> blocked eigensolve, with the convergence test
  on the device after every iteration.

helfem_tpu's lax.while_loop chunk becomes a Python loop over tensors that
stay on the device; one boolean per iteration comes back to stop the chunk.
The eigensolve is torch.linalg.eigh per block with helfem_tpu's four
refinement passes (utils/linalg.py:eigh_refined); its warm start is not
carried over. Every other
scf_diatomic option (open shells, range-separated and meta-GGA hybrids,
fields, finite nuclei, level shifts, --ndev, ...) raises
NotImplementedError: nothing falls back silently.
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
from helfem_tpu_torch.models.diatomic_dft import DiaGridOps, build_dia_grid, eval_fxc_dia
from helfem_tpu_torch.models.diatomic_tools import guess_hamiltonian_dia
from helfem_tpu_torch.ops.xc import parse_method_rs
from helfem_tpu_torch.scf.common import (
    aufbau_blocks,
    diis_error_blocks,
    full_sinvh,
    reject_unported,
    vdot,
)
from helfem_tpu_torch.scf.diis import DIIS, device_diis_step
from helfem_tpu_torch.utils.linalg import (
    _BIG,
    density_blocks,
    eig_blocks,
    eig_blocks_b,
    gather_blocks,
    scatter_blocks,
)

__all__ = ["scf_diatomic", "DiaSCFResult", "make_dia_fock", "occ_select", "occupied_dia"]


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
    orbsym_a: list[str] | None = None  # spectroscopic label per orbE_a entry
    orbE_blocks_a: np.ndarray | None = None  # [nblk, blen] block eigenvalues
    Nelgrid: float = 0.0  # electrons counted on the DFT grid
    walls: dict = field(default_factory=dict)  # phase -> seconds (CLI)


def make_dia_fock(funcs: tuple, kfrac: float = 0.0, dftthr: float = 1e-12,
                  njbd: int | None = None):
    """Restricted Fock build for symmetry-block-diagonal densities
    (helfem_tpu's make_dia_fock with restricted=True, so Kb = Ka and Exx =
    <Pa, Ka>): fock(ops, g, Pa, Co=None) -> (Fa, Ekin, Enuc, Ecoul, Exx,
    Exc, Nel). With kfrac != 0 the exchange is built from the sqrt(f)-
    weighted occupied columns Co when given (the SCF always has them), from
    the density otherwise. funcs may be empty (pure HF: g is not read).
    njbd runs the Coulomb build on the M = 0 channels only (exact here,
    coulomb_dia)."""

    def fock(ops: DiatomicOperators, g: DiaGridOps | None, Pa: torch.Tensor,
             Co: torch.Tensor | None = None):
        P = Pa + Pa
        J = coulomb_dia(ops, P, njbd)
        Fa = ops.H0 + J
        zero = torch.zeros((), dtype=Pa.dtype, device=Pa.device)
        Exx = Exc = Nel = zero
        if kfrac != 0.0:
            Ka = kfrac * (exchange_dia_occ(ops, Co) if Co is not None
                          else exchange_dia(ops, Pa))
            Fa = Fa + Ka
            Exx = vdot(Pa, Ka)
        if funcs:
            XCa, _, Exc, Nel = eval_fxc_dia(funcs, g, ops, Pa, Pa, dftthr)
            Fa = Fa + XCa
        Ekin = vdot(P, ops.T)
        Enuc = vdot(P, ops.Vnuc)
        Ecoul = 0.5 * vdot(P, J)
        return Fa, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    return fock


def make_dia_fused_chunk(funcs: tuple, kfrac: float, dftthr: float, njbd: int | None):
    """Up to `nrun` restricted SCF iterations on the device (helfem_tpu's
    make_dia_fused_chunk, restricted, no fields): density and occupied
    columns -> Fock -> block C2-DIIS (circular history, updated in place) ->
    blocked eigensolve, with the convergence test (err < convthr and |dE| <
    convthr) on the device after each. Occupations (and with them the
    selector `sel` of the occupied columns, None without exchange) are
    frozen within a chunk. Energies leave out the nuclear repulsion, as
    helfem_tpu's do."""
    fock = make_dia_fock(funcs, kfrac, dftthr, njbd)

    def chunk(ops, g, occ, sel, C, histF, histE, count, convthr, Eprev, nrun):
        nbf = ops.S.shape[0]
        Sb = gather_blocks(ops.S, ops.blk_idx)
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=C.device)
        Cs, Es, Etots, errs, Nels, comps = [], [], [], [], [], []
        for _ in range(nrun):
            Pab = torch.einsum("bpk,bk,bqk->bpq", C, occ, C)
            Pa = scatter_blocks(Pab, ops.blk_idx, nbf)
            Co = None if sel is None else occupied_dia(ops, C, sel)
            Fa, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Co)
            Etot = Ekin + Enuc + Ecoul + Exx + Exc
            Fab = gather_blocks(Fa, ops.blk_idx)
            err = diis_error_blocks(Fab, Pab, Sb, ops.blk_sinvh)
            errmax = torch.max(torch.abs(err))
            Fuse, count = device_diis_step(histF, histE, count, Fab, err)
            E, C = eig_blocks_b(Fuse, ops.blk_idx, ops.blk_sinvh, nbf)
            Cs.append(C)
            Es.append(E)
            Etots.append(Etot)
            errs.append(errmax)
            Nels.append(Nel)
            comps.append(torch.stack([Ekin, Enuc, Ecoul, Exx, Exc]))
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        return (Cs, Es, count, torch.stack(Etots), torch.stack(errs), torch.stack(Nels),
                torch.stack(comps), len(Cs))

    return chunk


# scf_diatomic options of helfem_tpu that this slice does not cover, with the
# default values under which they are inert
_UNPORTED = {
    "P0a": None, "P0b": None, "Ez": 0.0, "Qzz": 0.0, "Bz": 0.0, "finitenuc": "point",
    "Rrms1": 0.0, "Rrms2": 0.0, "shift": 0.0, "restricted": -1, "perturb": 0.0,
    "seed": 0, "occs": None, "readocc_until": 0, "diisthr": None, "save_cb": None,
    "diag": True, "maverage": False, "ndev": 0,
}


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
    diisorder: int = 10,
    diiseps: float = 0.1,
    dftthr: float = 1e-12,
    ldft: int = 0,
    device=None,
    **unported,
) -> DiaSCFResult:
    """Closed-shell restricted SCF (helfem_tpu's scf_diatomic for nela ==
    nelb) for HF, LDA/GGA functionals and PBE0, from the core guess or the
    SAP, GSZ or TF guess of the two atoms (a SAP atom is solved on the
    operators' device). The operators and the grid (none for pure HF) are
    built on `device` unless `ops` is given, in which case the SCF runs on
    ops' device."""
    reject_unported(unported, _UNPORTED, "scf_diatomic")
    if nela != nelb:
        raise NotImplementedError("open-shell diatomic SCF is not ported to "
                                  "helfem_tpu_torch yet; only closed shells")
    spec = parse_method_rs(method)
    funcs, kfrac = spec.funcs, spec.kfull
    if spec.kshort:
        raise NotImplementedError(f"method '{method}' needs the range-separated exchange, "
                                  "which is not ported to helfem_tpu_torch yet")
    if ops is None:
        if device is None:
            raise ValueError("scf_diatomic needs a device (or prebuilt ops)")
        ops = basis.build_operators(device)
    device = ops.device
    nbf = basis.nbf
    g = build_dia_grid(basis, device, neta=ldft) if funcs else None
    Enucrep = basis.Z1 * basis.Z2 / basis.Rbond
    njbd = basis.njbd
    fock = make_dia_fock(funcs, kfrac, dftthr, njbd)

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    if guess == "core":
        Hguess = ops.H0
    else:
        Hguess = as_dev(guess_hamiltonian_dia(basis, guess, device))
    Ea, Ca = eig_blocks(Hguess, ops.blk_idx, ops.blk_sinvh)
    Ea = Ea.cpu().numpy()
    blk_idx_np = ops.blk_idx.cpu().numpy()
    blk_sinvh_np = ops.blk_sinvh.cpu().numpy()
    diis = DIIS(ops.S.cpu().numpy(), full_sinvh(blk_idx_np, blk_sinvh_np, nbf),
                max_hist=diisorder, diis_eps=diiseps, blocks=(blk_idx_np, blk_sinvh_np))

    Eold, Etot, converged = 0.0, 0.0, False
    Ekin = Enuc = Ecoul = Exx = Exc = Nel = 0.0
    # fused device chunks engage after TWO host iterations: the host DIIS's
    # ADIIS weights carry the far-from-converged core guess, which the
    # chunks' pure C2-DIIS cannot (helfem_tpu diatomic_scf.py:736-745)
    warmup = 2
    chunk_len = 4  # chunk schedule 4, 8, 16
    CH = 16
    fused = None
    occa = None
    it = 0
    while it < maxit:
        it += 1
        occa = aufbau_blocks(Ea, nela)
        if it > warmup:
            if fused is None:
                nhist = 10
                fused = make_dia_fused_chunk(funcs, kfrac, dftthr, njbd)
                nblk, blen = blk_idx_np.shape
                histF = torch.zeros((nhist, nblk, blen, blen), dtype=torch.float64,
                                    device=device)
                histE = torch.zeros((nhist, nblk * blen * blen), dtype=torch.float64,
                                    device=device)
                count = 0
            nrun = min(chunk_len, CH, maxit - it + 1)
            chunk_len = min(2 * chunk_len, CH)
            sel = occ_select(occa, device) if kfrac != 0.0 else None
            Cs, Es, count, Etots, errs, Nels, comps, kmax = fused(
                ops, g, as_dev(occa), sel, Ca, histF, histE, count, float(convthr),
                Eold - Enucrep, nrun,
            )
            Etots = Etots.cpu().numpy()
            errs = errs.cpu().numpy()
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k]) + Enucrep
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
            Ca = Cs[k]
            Ea = Es[k].cpu().numpy()
            Nel = float(Nels[k])
            Ekin, Enuc, Ecoul, Exx, Exc = comps[k].cpu().numpy()
            if converged or it >= maxit:
                break
            continue

        Pa = density_blocks(Ca, as_dev(occa), ops.blk_idx, ops.S)
        Co = occupied_dia(ops, Ca, occ_select(occa, device)) if kfrac != 0.0 else None
        Fa, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, g, Pa, Co)
        Ekin, Enuc, Ecoul, Exx, Exc, Nel = (float(x) for x in
                                            (Ekin, Enuc, Ecoul, Exx, Exc, Nel))
        Etot = Ekin + Enuc + Ecoul + Exx + Exc + Enucrep
        dE = Etot - Eold
        Eold = Etot
        err = diis.update([Fa.cpu().numpy()], [Pa.cpu().numpy()])
        (Fa_,) = diis.solve()
        if verbose:
            print(f"iter {it:3d}  E = {Etot:+.12f}  dE = {dE:+.3e}  diis = {err:.3e}")
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
            break
        Ea, Ca = eig_blocks(as_dev(Fa_), ops.blk_idx, ops.blk_sinvh)
        Ea = Ea.cpu().numpy()

    nblk = Ea.shape[0]
    labels = basis.sym_labels(True)
    if len(labels) != nblk:
        labels = basis.sym_labels(False)
    flat = Ea.ravel()
    order = np.argsort(flat)
    order = order[flat[order] < _BIG / 2]
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
        orbE_a=flat[order],
        orbs_a=Ca.cpu().numpy(),
        occ_a=occa,
        orbsym_a=[labels[i // Ea.shape[1]] for i in order],
        orbE_blocks_a=Ea,
        Nelgrid=float(Nel),
    )
