"""Normalized associated Legendre functions and their theta derivatives
(L4), carried over from helfem_tpu/ops/spherical.py (host numpy). The
diatomic DFT grid builds its angular tables from them.

Normalization: Y_lm(theta, phi) = Pbar_l^m(cos theta) e^{i m phi} with
int |Y_lm|^2 dOmega = 1, i.e. Pbar includes sqrt((2l+1)/4pi (l-m)!/(l+m)!)
(the reference wraps GSL, src/general/spherical_harmonics.cpp:25-41).
"""

import numpy as np

__all__ = ["legendre_Pbar", "ylm_dtheta"]


def legendre_Pbar(lmax: int, x: np.ndarray) -> np.ndarray:
    """Normalized associated Legendre Pbar[l, m, npts] for 0 <= m <= l <= lmax.

    Pbar_l^m(x) = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!) P_l^m(x), with the
    Condon-Shortley phase included in P_l^m.
    """
    x = np.asarray(x, dtype=np.float64)
    sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))
    P = np.zeros((lmax + 1, lmax + 1, len(x)))
    P[0, 0] = np.sqrt(1.0 / (4.0 * np.pi))
    for m in range(1, lmax + 1):
        # diagonal: Pbar_m^m = -sqrt((2m+1)/(2m)) * sx * Pbar_{m-1}^{m-1}
        P[m, m] = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sx * P[m - 1, m - 1]
    for m in range(0, lmax):
        P[m + 1, m] = np.sqrt(2.0 * m + 3.0) * x * P[m, m]
        for l in range(m + 2, lmax + 1):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[l, m] = a * (x * P[l - 1, m] - b * P[l - 2, m])
    return P


def ylm_dtheta(lmax: int, cth: np.ndarray) -> np.ndarray:
    """d(Pbar_l^m)/d(theta) [l, m, npts], via the derivative identity
    dP_l^m/dtheta = (1/sin) (l x P_l^m - (l+m) P_{l-1}^m) with matching
    normalization; used for GGA gradients on the angular grid."""
    x = np.asarray(cth, dtype=np.float64)
    sx = np.sqrt(np.maximum(1e-300, 1.0 - x * x))
    P = legendre_Pbar(lmax, x)
    D = np.zeros_like(P)
    for m in range(0, lmax + 1):
        for l in range(m, lmax + 1):
            if l == 0:
                continue
            if l - 1 >= m:
                # norm ratio between Pbar_{l-1}^m and P_{l-1}^m relative to l
                c = np.sqrt(
                    (2.0 * l + 1.0) / (2.0 * l - 1.0) * (l - m) * (l + m)
                )
                D[l, m] = (l * x * P[l, m] - c * P[l - 1, m]) / sx
            else:
                D[l, m] = l * x * P[l, m] / sx
    return D
