"""Radial GTO/STO evaluation and completeness/importance profiles, ported
from helfem_tpu/ops/lcao.py.

(reference: src/general/lcao.{cpp,h}; profiles used by diatomic_cpl,
src/diatomic/completeness.cpp, and the sadatom gto/sto_completeness_profile,
src/sadatom/solver.cpp.)

Normalizations (radially normalized: int |f|^2 r^2 dr = 1):
  GTO: f(r) = 2^{l+2} alpha^{(2l+3)/4} r^l e^{-alpha r^2}
             / ((2 pi)^{1/4} sqrt((2l+1)!!))
  STO: f(r) = (2 zeta)^{l+3/2} / sqrt((2l+2)!) r^l e^{-zeta r}

The probe overlaps <g_alpha | b_n> are assembled on the host (a table, as
the port's other tables are); the profiles' solve against the overlap and
their contractions run in torch on the caller's device.
"""

import math

import numpy as np
import torch

__all__ = ["radial_GTO", "radial_STO", "completeness_profile", "importance_profile"]


def _dfact(n: int) -> float:
    return float(math.prod(range(n, 0, -2))) if n > 0 else 1.0


def radial_GTO(r: np.ndarray, l: int, alpha) -> np.ndarray:
    """Normalized radial GTOs; shape [npts, nexp] for vector alpha."""
    r = np.asarray(r, dtype=float)
    alpha = np.atleast_1d(np.asarray(alpha, dtype=float))
    pref = 2.0 ** (l + 2) * alpha ** ((2 * l + 3) / 4.0) / (
        (2.0 * np.pi) ** 0.25 * math.sqrt(_dfact(2 * l + 1))
    )
    return pref[None, :] * r[:, None] ** l * np.exp(-alpha[None, :] * r[:, None] ** 2)


def radial_STO(r: np.ndarray, l: int, zeta) -> np.ndarray:
    """Normalized radial STOs; shape [npts, nexp]."""
    r = np.asarray(r, dtype=float)
    zeta = np.atleast_1d(np.asarray(zeta, dtype=float))
    pref = (2.0 * zeta) ** (l + 1.5) / math.sqrt(math.factorial(2 * l + 2))
    return pref[None, :] * r[:, None] ** l * np.exp(-zeta[None, :] * r[:, None])


def _test_overlaps(rb, l: int, expn: np.ndarray, kind: str) -> np.ndarray:
    """<g_alpha | b_n> [nexp, nbf] over the radial basis rb (volume r^2 dr)."""
    f = radial_GTO if kind.upper() == "GTO" else radial_STO
    gv = np.stack([f(rb.r[e], l, expn) for e in range(rb.fem.nelem)])  # [nelem, nq, nexp]
    w = rb.wr * rb.r**2
    ov_el = np.einsum("eqa,eq,eqi->eai", gv, w, rb.b, optimize=True)
    nbf = rb.fem.nbf
    ov = np.zeros((len(expn), nbf + 1))
    for e in range(rb.fem.nelem):
        ov[:, rb.fem.gidx[e]] += ov_el[e]
    return ov[:, :nbf]


def importance_profile(rb, c_occ: np.ndarray, l: int, expn: np.ndarray, kind: str = "GTO",
                       device=None) -> np.ndarray:
    """I(alpha) = sum_i |<g_alpha | psi_i>|^2 over occupied radial orbitals
    c_occ [nbf, nocc] of channel l (reference: sadatom gto/sto importance
    profiles, src/sadatom/solver.cpp); the contraction on `device` (None:
    the CPU)."""
    ov = torch.as_tensor(_test_overlaps(rb, l, expn, kind), device=device)
    proj = ov @ torch.as_tensor(np.asarray(c_occ, dtype=float), device=device)
    return (proj**2).sum(dim=1).cpu().numpy()


def completeness_profile(rb, l: int, expn: np.ndarray, kind: str = "GTO",
                         device=None) -> np.ndarray:
    """Y(alpha) = sum_{mn} <g_a|b_m> (S^-1)_{mn} <b_n|g_a> for the radial FEM
    basis rb (atomic RadialBasis): 1 means the test function is exactly
    representable (reference: diatomic_cpl / sadatom completeness
    profiles). The solve and the contraction run on `device` (None: the
    CPU)."""
    ov = torch.as_tensor(_test_overlaps(rb, l, expn, kind), device=device)
    S = torch.as_tensor(rb.overlap(), device=device)
    x = torch.linalg.solve(S, ov.T)
    return torch.einsum("an,na->a", ov, x).cpu().numpy()
