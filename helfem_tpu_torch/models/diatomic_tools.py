"""Model potentials on the diatomic (mu, eta) quadrature grid, the
finite-nucleus attraction, the SAP/GSZ/TF guess Hamiltonian of two atoms
and the post-SCF analysis (the density at points and at the nuclei, the
orbitals' radial moments), ported from helfem_tpu/models/diatomic_tools.py
(host numpy on the basis and on the grid tables of build_dia_grid).
"""

import numpy as np
import torch

from helfem_tpu_torch.models.atomic import nuclear_model_V
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.diatomic_dft import DiaGridOps, build_dia_grid
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.ops.spherical import legendre_Pbar
from helfem_tpu_torch.scf.guess import potential

__all__ = ["potential_matrix_dia", "finite_nucleus_Vnuc", "guess_hamiltonian_dia",
           "eval_density_points", "nuclear_densities_dia", "occupied_orbital_vectors_dia",
           "orbital_moments_dia"]


def potential_matrix_dia(basis: DiatomicBasis, g: DiaGridOps, V) -> np.ndarray:
    """<chi_A | V | chi_B> for a phi-independent potential V(r1, r2) of the
    two focus distances (reference: TwoDGridWorker::model_potential,
    twodquadrature.cpp)."""
    neta = g.TT.shape[-1]
    etav, _ = gauss_legendre(neta)
    Rh = basis.Rhalf
    xi = np.cosh(basis.mu)
    r1 = Rh * (xi[:, :, None] + etav[None, None, :])
    r2 = Rh * (xi[:, :, None] - etav[None, None, :])
    Vg = V(r1, r2)
    w = g.w.cpu().numpy()
    A1 = np.einsum("eqt,abt->abeq", w * Vg, g.TT.cpu().numpy(), optimize=True)
    Vel = np.einsum("abeq,eqi,eqj->abeij", A1, basis.B, basis.B, optimize=True)
    nang, nrad = basis.nang, basis.nrad
    gi = basis.fem.gidx
    out = np.zeros((nang, nang, nrad + 1, nrad + 1))
    for e in range(basis.fem.nelem):
        out[:, :, gi[e][:, None], gi[e][None, :]] += Vel[:, :, e]
    out = out[:, :, :nrad, :nrad].transpose(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)
    m2 = basis.shell_mask().reshape(-1)
    return out * m2[:, None] * m2[None, :]


def finite_nucleus_Vnuc(basis: DiatomicBasis, model: str, Rrms1: float, Rrms2: float,
                        g: DiaGridOps | None = None) -> np.ndarray:
    """Nuclear attraction of finite-nucleus charge models on the 2D (mu,
    eta) quadrature grid (diatomic_tools.py:53-71; reference:
    src/diatomic/main.cpp:492-514, qgrid.model_potential(pot1, pot2)): model
    'gaussian', 'spherical', 'hollow' or 'regularized', Rrms1/Rrms2 the
    nuclei's rms radii. The grid tables are made on the host unless g is
    given."""
    if g is None:
        g = build_dia_grid(basis, torch.device("cpu"))
    V1 = nuclear_model_V(model, basis.Z1, Rrms1) if basis.Z1 > 0 else (lambda r: 0.0 * r)
    V2 = nuclear_model_V(model, basis.Z2, Rrms2) if basis.Z2 > 0 else (lambda r: 0.0 * r)
    return potential_matrix_dia(basis, g, lambda r1, r2: V1(r1) + V2(r2))


def guess_hamiltonian_dia(basis: DiatomicBasis, kind: str, device) -> np.ndarray:
    """T + the sum of the two atoms' screened-nucleus potentials on the 2D
    grid (reference: src/diatomic/main.cpp:654-701). The grid tables are
    made on the host; a SAP atom is solved on `device`."""
    g = build_dia_grid(basis, torch.device("cpu"))
    V1 = potential(kind, basis.Z1, device=device) if basis.Z1 > 0 else (lambda r: 0.0 * r)
    V2 = potential(kind, basis.Z2, device=device) if basis.Z2 > 0 else (lambda r: 0.0 * r)
    Vmat = potential_matrix_dia(basis, g, lambda r1, r2: V1(r1) + V2(r2))
    m = basis.shell_mask().reshape(-1)
    return basis.kinetic() * np.outer(m, m) + Vmat


def _shell_Pbar(basis: DiatomicBasis, eta: np.ndarray) -> np.ndarray:
    """[nang, len(eta)] normalised Legendre Pbar_l^|m|(eta) of each shell."""
    Pb = legendre_Pbar(int(basis.lval.max()), eta)
    return np.stack([Pb[basis.lval[a], abs(basis.mval[a])] for a in range(basis.nang)])


def _point_to_prolate(basis: DiatomicBasis, z, rho):
    """(mu, eta) of the cylindrical points (z, rho)."""
    Rh = basis.Rhalf
    r1 = np.sqrt(rho**2 + (z + Rh) ** 2)
    r2 = np.sqrt(rho**2 + (z - Rh) ** 2)
    xi = np.clip((r1 + r2) / (2 * Rh), 1.0, None)
    eta = np.clip((r1 - r2) / (2 * Rh), -1.0, 1.0)
    return np.arccosh(xi), eta


def eval_density_points(basis: DiatomicBasis, P: np.ndarray, z, rho) -> np.ndarray:
    """Electron density at the cylindrical points (z, rho) of the m-block-
    diagonal density P (helfem_tpu diatomic_tools.py:97-130)."""
    z = np.atleast_1d(np.asarray(z, dtype=float))
    rho = np.broadcast_to(np.atleast_1d(np.asarray(rho, dtype=float)), z.shape)
    mu, eta = _point_to_prolate(basis, z, rho)
    nang, nrad = basis.nang, basis.nrad
    fem = basis.fem
    Bv = np.zeros((len(z), nrad + 1))
    eidx = np.clip(np.searchsorted(fem.bval, mu, side="right") - 1, 0, fem.nelem - 1)
    for k, e in enumerate(eidx):
        x = (mu[k] - fem.mids[e]) / (0.5 * fem.lengths[e])
        Bv[k][fem.gidx[e]] += fem.eval_element(e, np.array([x]), 0)[0][0]
    Bv = Bv[:, :nrad]
    Th = _shell_Pbar(basis, eta)
    mask = basis.shell_mask()
    P4 = P.reshape(nang, nrad, nang, nrad)
    dens = np.zeros(len(z))
    for a in range(nang):
        for b in range(nang):
            if basis.mval[a] != basis.mval[b]:
                continue
            va, vb = Bv * mask[a][None, :], Bv * mask[b][None, :]
            dens += Th[a] * Th[b] * np.einsum("kI,IJ,kJ->k", va, P4[a, :, b, :], vb)
    return dens


def orbital_moments_dia(basis: DiatomicBasis, c: np.ndarray) -> dict:
    """Radial moments of one orbital |phi|^2 about the left and right
    nuclei and the centre (helfem_tpu diatomic_tools.py:256-300; reference:
    TwoDBasis::radial_moments, src/diatomic/main.cpp:1033-1086). c is a
    full-basis vector [nbf] of one m channel. Returns {'left': {n: <r_l^n>},
    'right': ..., 'center': {2: <r_c^2>}} for n in (-1, 1, 2, 3); in prolate
    coordinates r_{l,r} = Rh (cosh mu +- eta), so the moments are quadrature
    sums."""
    nang, nrad = basis.nang, basis.nrad
    eta, weta = gauss_legendre(2 * int(basis.lval.max()) + 16)
    Th = _shell_Pbar(basis, eta)
    cpad = np.zeros((nang, nrad + 1))
    cpad[:, :nrad] = c.reshape(nang, nrad) * basis.shell_mask()
    phi_mu = np.einsum("eqi,aei->aeq", basis.B, cpad[:, basis.fem.gidx])
    F = np.einsum("aeq,at->eqt", phi_mu, Th)
    ch = np.cosh(basis.mu)
    w3 = (ch[:, :, None] ** 2 - eta[None, None, :] ** 2) * (
        np.sinh(basis.mu) * basis.wmu)[:, :, None] * weta[None, None, :]
    dens = F * F * w3
    norm = dens.sum()
    Rh = basis.Rhalf
    r_l = Rh * (ch[:, :, None] + eta[None, None, :])
    r_r = Rh * (ch[:, :, None] - eta[None, None, :])
    rc2 = Rh**2 * (ch[:, :, None] ** 2 + eta[None, None, :] ** 2 - 1.0)
    out = {"left": {}, "right": {}, "center": {}}
    for n in (-1, 1, 2, 3):
        out["left"][n] = float((dens * r_l**n).sum() / norm)
        out["right"][n] = float((dens * r_r**n).sum() / norm)
    out["center"][2] = float((dens * rc2).sum() / norm)
    return out


def nuclear_densities_dia(basis: DiatomicBasis, P: np.ndarray) -> tuple[float, float]:
    """Electron density at the two nuclei (helfem_tpu diatomic_tools.py:
    303-309; reference: TwoDBasis::nuclear_density, src/diatomic/main.cpp:
    1024-1031), a relative 1e-7 of Rh off the axis point."""
    eps = 1e-7
    z = np.array([-basis.Rhalf * (1.0 - eps), basis.Rhalf * (1.0 - eps)])
    n = eval_density_points(basis, P, z, np.full(2, basis.Rhalf * eps))
    return float(n[0]), float(n[1])


def occupied_orbital_vectors_dia(basis: DiatomicBasis, orbs, occ, E_blocks):
    """The occupied block orbitals as full-basis vectors, sorted by
    eigenvalue: [(E, occ, c [nbf]), ...] (helfem_tpu diatomic_tools.py:
    312-333). The blocks are the g/u-split ones or the merged ones, by
    their count."""
    orbs = np.asarray(orbs)
    blocks = next((b for b in (basis.sym_blocks(True), basis.sym_blocks(False))
                   if len(b) == orbs.shape[0]), None)
    if blocks is None:
        raise ValueError("orbital block count matches no symmetry setup")
    out = []
    for b, idx in enumerate(blocks):
        for k in range(np.asarray(occ).shape[1]):
            if occ[b][k] <= 0:
                continue
            c = np.zeros(basis.nbf)
            c[idx] = orbs[b][:len(idx), k]
            out.append((float(E_blocks[b][k]), float(occ[b][k]), c))
    out.sort(key=lambda t: t[0])
    return out
