"""Regularized (Gygi) nucleus, ported from helfem_tpu/ops/gygi.py.

Gygi's all-electron regularized Coulomb potential [F. Gygi, JCTC 19, 1300
(2023)]: pick the node-free, cusp-free reference orbital

    phi(r) = exp(h(r)) / sqrt(pi),   h(r) = -r erf(a r) - b exp(-a^2 r^2)

with b(a) fixed by <phi|phi> = 1, and define the potential so that phi is
the exact ground state at E = -1/2:

    V(r) = -1/2 + (r phi)'' / (2 r phi)
         = -1/2 + h'/r + (h'' + h'^2)/2.

Charge scaling V_Z(r) = Z^2 V_1(Z r) gives E_0 = -Z^2/2 exactly. The
derivatives of h are evaluated directly (the reference uses machine-generated
Maple output, libhelfem/src/RegularizedNucleus.cpp:142-188), with a series
branch for erf(ar)/r at small r. Host numpy, at setup.
"""

import math

import numpy as np
from scipy.special import erf

from helfem_tpu_torch.ops.quadrature import radial_chebyshev

__all__ = ["gygi_b", "gygi_phi", "gygi_V"]

_SQPI = math.sqrt(math.pi)


def _h(a, b, r):
    return -r * erf(a * r) - b * np.exp(-((a * r) ** 2))


def gygi_phi(a: float, b: float, r: np.ndarray) -> np.ndarray:
    """Reference orbital phi(r) (not charge-scaled)."""
    return np.exp(_h(a, b, np.asarray(r, dtype=float))) / _SQPI


def gygi_b(a: float, nquad: int = 200) -> float:
    """Normalization parameter b(a): bisection on <phi|phi> = 1 (reference
    behavior: RegularizedNucleus::find_b)."""
    r, wr = radial_chebyshev(nquad)

    def norm(b):
        return 4.0 * math.pi * float(np.sum(wr * (r * gygi_phi(a, b, r)) ** 2))

    lo, hi = 1e-4, 10.0
    if not (norm(lo) > 1.0 > norm(hi)):
        raise ValueError(f"cannot bracket b for a={a}")
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if norm(mid) > 1.0:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 4.0 * np.finfo(float).eps * mid:
            break
    return 0.5 * (lo + hi)


def _erf_over_r(a: float, r: np.ndarray) -> np.ndarray:
    """erf(a r)/r, stable at r -> 0 through its Maclaurin series."""
    x = a * r
    small = np.abs(x) < 1e-4
    rs = np.where(small, 1.0, r)
    series = a * (2.0 / _SQPI) * (1.0 - x**2 / 3.0 + x**4 / 10.0)
    return np.where(small, series, erf(x) / rs)


def gygi_V(Z: int, a: float, r: np.ndarray, b: float | None = None) -> np.ndarray:
    """Regularized nuclear potential V_Z(r) = Z^2 V_1(a, b; Z r)."""
    if b is None:
        b = gygi_b(a)
    r = np.asarray(r, dtype=float)
    x = Z * r  # at unit charge, then scaled
    e = np.exp(-((a * x) ** 2))
    erf_over = _erf_over_r(a, x)
    # h'(x) = -erf(ax) - (2a/sqrt(pi)) x e + 2 a^2 b x e
    hp = -erf_over * x + (2.0 * a * a * b - 2.0 * a / _SQPI) * x * e
    # h'/x with the erf(ax)/x form kept explicit for x -> 0
    hp_over_x = -erf_over + (2.0 * a * a * b - 2.0 * a / _SQPI) * e
    # h''(x) = e [ -4a/sqrt(pi) + 4 a^3 x^2/sqrt(pi) + 2 a^2 b (1 - 2 a^2 x^2) ]
    hpp = e * (
        -4.0 * a / _SQPI
        + 4.0 * a**3 * x**2 / _SQPI
        + 2.0 * a * a * b * (1.0 - 2.0 * a * a * x**2)
    )
    V1 = -0.5 + hp_over_x + 0.5 * (hpp + hp * hp)
    return Z * Z * V1
