"""Spherical-harmonic expansion of the complementary-error-function kernel
(host setup), the port's copy of helfem_tpu/ops/erfc_expn.py:

    erfc(mu r12)/r12 = sum_{LM} [4 pi mu / (2L+1)] Phi_L(mu r<, mu r>) Y Y*

with the Phi_n(Xi, xi) functions of Angyan, Gerber & Marsman, J. Phys. A 39,
8613 (2006) (reference implementation: libhelfem/src/erfc_expn.cpp).

Two branches as in the paper: the general expansion (eqs. 21-24) and the
short-range power series (eqs. 28-30) for small arguments, switched per the
criterion on p. 8624. Vectorized numpy; erfc through math.erfc, as
helfem_tpu evaluates it, so the tables are helfem_tpu's bit for bit.
"""

import math

import numpy as np

__all__ = ["Phi", "phi_table"]


def _Fn(n: int, Xi, xi):
    """Eq. (22) (lower limit p=0 per the reference's correction)."""
    explus = np.exp(-((Xi + xi) ** 2))
    exminus = np.exp(-((Xi - xi) ** 2))
    prefac = -1.0 / (4.0 * Xi * xi)
    F = np.zeros_like(Xi)
    for p in range(n + 1):
        F += (
            prefac ** (p + 1)
            * (math.factorial(n + p) / (math.factorial(p) * math.factorial(n - p)))
            * ((-1.0) ** (n - p) * explus - exminus)
        )
    return 2.0 / math.sqrt(math.pi) * F


def _erfc(x):
    return np.vectorize(math.erfc)(x)


def _Phi_general(n: int, Xi, xi):
    """Eq. (21); requires Xi >= xi elementwise."""
    Fnarr = [_Fn(i, Xi, xi) for i in range(n + 1)]
    s = np.zeros_like(Xi)
    for m in range(1, n + 1):
        Xim = Xi**m
        xim = xi**m
        s += Fnarr[n - m] * ((Xim * Xim + xim * xim) / (Xim * xim))
    Xi2np1 = Xi ** (2 * n + 1)
    xi2np1 = xi ** (2 * n + 1)
    Hn = (
        (Xi2np1 + xi2np1) * _erfc(Xi + xi) - (Xi2np1 - xi2np1) * _erfc(Xi - xi)
    ) / (2.0 * (xi * Xi) ** (n + 1))
    return Fnarr[n] + s + Hn


def _choose(n: int, m: int) -> float:
    """Binomial incl. negative upper index (case ladder as in the
    reference, erfc_expn.cpp:45-68)."""
    if n == -1:
        return (-1.0) ** m
    if n == 0:
        return 1.0 if m == 0 else 0.0
    if m == 0:
        return 1.0
    if m == 1:
        return float(n)
    if n > 0 and m > n:
        return 0.0
    if n < 0:
        return _choose(n + m - 1, m) * (-1.0) ** m
    return float(math.comb(n, m))


def _dfact(n: int) -> float:
    return float(math.prod(range(n, 0, -2))) if n > 0 else 1.0


def _Dnk(n: int, k: int, Xi):
    """Eqs. (28)-(29)."""
    prefac = np.exp(-(Xi**2)) / math.sqrt(math.pi) * 2.0 ** (n + 1) * Xi ** (2 * n + 1)
    if k == 0:
        s = np.zeros_like(Xi)
        for m in range(1, n + 1):
            s += 1.0 / (_dfact(2 * (n - m) + 1) * (2.0 * Xi * Xi) ** m)
        return _erfc(Xi) + prefac * s
    s = np.zeros_like(Xi)
    for m in range(1, k + 1):
        s += _choose(m - k - 1, m - 1) * (2.0 * Xi * Xi) ** (k - m) / _dfact(2 * (n + k - m) + 1)
    return prefac * (2.0 * n + 1.0) / (math.factorial(k) * (2.0 * (n + k) + 1.0)) * s


def _Phi_short(n: int, Xi, xi):
    """Eq. (30), power series in xi; requires Xi >= xi. The series stops
    when every point's last term is below 1e-16 of its sum."""
    Phi = np.zeros_like(Xi)
    for k in range(0, 32, 2):
        dPhi = _Dnk(n, k, Xi) * xi ** (n + 2 * k) + _Dnk(n, k + 1, Xi) * xi ** (
            n + 2 * (k + 1)
        )
        Phi = Phi + dPhi
        if np.all(np.abs(dPhi) < 1e-16 * np.maximum(np.abs(Phi), 1e-300)):
            break
    out = Phi / Xi ** (n + 1)
    if n == 0:
        out = np.where((Xi == 0.0) & (xi == 0.0), 1.0, out)
    return out


def Phi(n: int, Xi, xi):
    """Phi_n(Xi, xi), branch-switched per point (argument order-insensitive)."""
    Xi = np.asarray(Xi, dtype=np.float64)
    xi = np.asarray(xi, dtype=np.float64)
    big = np.maximum(Xi, xi)
    small = np.minimum(Xi, xi)
    use_short = (small < 0.4) | ((big < 0.5) & (small < 2.0 * big))
    out = np.empty_like(big)
    if np.any(use_short):
        out[use_short] = _Phi_short(n, big[use_short], np.maximum(small[use_short], 0.0))
    if np.any(~use_short):
        out[~use_short] = _Phi_general(n, big[~use_short], small[~use_short])
    return out


def phi_table(Lmax: int, Xi, xi):
    """Phi[L, ...] for L = 0..Lmax on broadcasted point arrays."""
    return np.stack([Phi(L, Xi, xi) for L in range(Lmax + 1)])
