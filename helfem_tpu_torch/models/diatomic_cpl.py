"""Diatomic completeness / importance profiles with off-center probes,
ported from helfem_tpu/models/diatomic_cpl.py.

Redesign of the reference's diatomic completeness tool
(src/diatomic/completeness.cpp and twodquadrature.cpp gto/sto_projection):
a probe function g(r_c; alpha) Y_lm(theta_c) centered on the left nucleus,
the bond midpoint, or the right nucleus is integrated against every FEM
basis function on the 2D prolate-spheroidal grid, giving

    completeness  Y(alpha)  = p S^+ p^T            (diag; pseudo-inverse)
    importance    I(alpha)  = sum_occ |<probe|psi_i>|^2

Geometry (foci at z = -+ Rhalf; Z1 at eta=-1, Z2 at eta=+1, matching the
nuclear-attraction operator in models/diatomic.py):
    r_left  = Rh (xi + eta)     cos t_left  = (xi eta + 1)/(xi + eta)
    r_right = Rh (xi - eta)     cos t_right = (xi eta - 1)/(xi - eta)
    r_mid   = Rh sqrt(xi^2 + eta^2 - 1)     cos t_mid = Rh xi eta / r_mid

The probe overlaps are a host numpy table; the pseudo-inverse of the
overlap (its eigensolve) and the profiles' contractions run in torch on the
caller's device.
"""

import numpy as np
import torch

from helfem_tpu_torch.ops.lcao import radial_GTO, radial_STO
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.ops.spherical import legendre_Pbar

__all__ = ["probe_projection", "completeness_dia", "importance_dia", "full_orbitals"]


def probe_projection(basis, l: int, m: int, expn, center: str = "left",
                     kind: str = "GTO", neta: int = 0) -> np.ndarray:
    """Overlaps <g_alpha Y_lm(center) | chi_j> for all FEM basis functions;
    returns [nexp, nbf] (reference: TwoDGrid::gto_projection/sto_projection,
    src/diatomic/twodquadrature.cpp)."""
    if abs(m) > l:
        return np.zeros((len(np.atleast_1d(expn)), basis.nbf))
    lmax_b = int(basis.lval.max())
    if neta == 0:
        neta = 2 * max(lmax_b, l) + 14
    eta, weta = gauss_legendre(neta)
    Rh = basis.Rhalf
    xi = np.cosh(basis.mu)[:, :, None]  # [ne, nq, 1]
    et = eta[None, None, :]
    if center == "left":
        r = Rh * (xi + et)
        ct = (xi * et + 1.0) / (xi + et)
    elif center == "right":
        r = Rh * (xi - et)
        ct = (xi * et - 1.0) / (xi - et)
    elif center in ("mid", "middle"):
        r = Rh * np.sqrt(np.maximum(xi**2 + et**2 - 1.0, 1e-300))
        ct = np.clip(Rh * xi * et / r, -1.0, 1.0)
    else:
        raise ValueError(f"unknown center {center}")
    ct = np.clip(ct, -1.0, 1.0)

    f = radial_GTO if kind.upper() == "GTO" else radial_STO
    expn = np.atleast_1d(np.asarray(expn, dtype=float))
    g = f(r.ravel(), l, expn).reshape(*r.shape, len(expn))  # [ne,nq,nt,na]
    Pb = legendre_Pbar(l, ct.ravel())[l, abs(m)].reshape(r.shape)
    vol = xi**2 - et**2
    w = 2.0 * np.pi * Rh**3 * basis.wmu[:, :, None] * np.sinh(basis.mu)[:, :, None] * vol * weta[None, None, :]
    G = w * Pb  # [ne, nq, nt]

    # theta table of the basis shells (same-m only couple)
    P = legendre_Pbar(lmax_b, eta)
    nang, nrad = basis.nang, basis.nrad
    ov_ang = np.zeros((len(expn), nang, nrad + 1))
    for a in range(nang):
        if basis.mval[a] != m:
            continue
        Th = P[basis.lval[a], abs(m)]
        flat = np.einsum("eqta,eqt,t,eqi->eia", g, G, Th, basis.B, optimize=True)
        acc = np.zeros((nrad + 1, len(expn)))
        for e in range(basis.fem.nelem):
            acc[basis.fem.gidx[e]] += flat[e]
        ov_ang[:, a, :] = acc.T[:, : nrad + 1]
    ov = ov_ang[:, :, :nrad].reshape(len(expn), nang * nrad)
    return ov * basis.shell_mask().reshape(-1)[None, :]


def _sinv(S: torch.Tensor, cutoff: float = 1e-13) -> torch.Tensor:
    """Pseudo-inverse dropping only numerically-null directions (the masked
    shell rows). The prolate overlap is genuinely ill-conditioned
    (eigenvalue span ~1e12) but those small directions carry real
    completeness, so the cutoff is relative machine-noise level, not the
    reference's absolute 1e-6 (src/diatomic/completeness.cpp:129-137).
    The eigensolve runs on S's device."""
    w, U = torch.linalg.eigh(S)
    keep = w >= cutoff * w.max()
    return (U[:, keep] / w[keep]) @ U[:, keep].T


def completeness_dia(basis, S, l: int, m: int, expn, center: str = "left",
                     kind: str = "GTO", device=None) -> np.ndarray:
    """Y(alpha) = diag(p S^+ p^T): 1 where the FEM basis spans the probe.
    S is host numpy or a tensor; the pseudo-inverse and the contraction run
    on `device` (None: S's device, or the CPU)."""
    S = torch.as_tensor(S, dtype=torch.float64, device=device)
    p = torch.as_tensor(probe_projection(basis, l, m, expn, center, kind), device=S.device)
    return torch.einsum("ai,ij,aj->a", p, _sinv(S), p).cpu().numpy()


def full_orbitals(ops, C, occ) -> np.ndarray:
    """Occupied orbitals in full-basis coordinates [nbf, nocc] from the
    padded block eigenvectors (host numpy)."""
    bi = ops.blk_idx.cpu().numpy()
    C = np.asarray(C)
    occ = np.asarray(occ)
    nbf = ops.S.shape[0]
    cols = []
    for b in range(bi.shape[0]):
        for k in range(C.shape[2]):
            if occ[b, k] > 0:
                v = np.zeros(nbf + 1)
                v[bi[b]] += C[b, :, k]
                cols.append(v[:nbf])
    return np.stack(cols, axis=1) if cols else np.zeros((nbf, 0))


def importance_dia(basis, Cocc: np.ndarray, l: int, m: int, expn,
                   center: str = "left", kind: str = "GTO", device=None) -> np.ndarray:
    """I(alpha) = sum_i |<probe|psi_i>|^2 over occupied orbitals, the
    contraction on `device` (None: the CPU)."""
    p = torch.as_tensor(probe_projection(basis, l, m, expn, center, kind), device=device)
    proj = p @ torch.as_tensor(np.asarray(Cocc, dtype=float), device=device)
    return (proj**2).sum(dim=1).cpu().numpy()
