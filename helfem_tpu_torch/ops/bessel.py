"""Modified spherical Bessel functions i_L, k_L (host setup), the port's copy
of helfem_tpu/ops/bessel.py.

Conventions matching the reference (libhelfem/src/utils.cpp:42-80, which
rescales GSL): i_L(x) = sqrt(pi/2x) I_{L+1/2}(x), k_L(x) = sqrt(2/pi x)
K_{L+1/2}(x), so that the Yukawa kernel expands as

  e^{-lam r12}/r12 = 4 pi lam sum_{LM} i_L(lam r<) k_L(lam r>) Y_LM(1) Y_LM*(2).

Algorithms (longdouble): k_L upward recursion (growing: stable), i_L downward
Miller recursion normalized by i_0 = sinh(x)/x.
"""

import numpy as np

__all__ = ["bessel_il", "bessel_kl"]

LD = np.longdouble


def bessel_kl(x: np.ndarray, Lmax: int) -> np.ndarray:
    """k_L(x) for L=0..Lmax, shape [Lmax+1, npts]."""
    x = np.asarray(x, dtype=LD)
    k = np.empty((Lmax + 1, len(x)), dtype=LD)
    ex = np.exp(-x)
    k[0] = ex / x
    if Lmax >= 1:
        k[1] = ex * (1.0 / x + 1.0 / (x * x))
    for L in range(1, Lmax):
        k[L + 1] = k[L - 1] + (2 * L + 1) / x * k[L]
    return k.astype(np.float64)


def bessel_il(x: np.ndarray, Lmax: int) -> np.ndarray:
    """i_L(x) for L=0..Lmax via downward Miller recursion, [Lmax+1, npts]."""
    x = np.asarray(x, dtype=LD)
    npts = len(x)
    pad = Lmax + 30 + int(np.ceil(np.max(np.abs(x.astype(np.float64))))) // 2
    N = Lmax + pad
    # downward ratio r_L = i_L / i_{L-1}: from i_{L-1} = i_{L+1} + (2L+1)/x i_L
    #   r_L = 1 / ((2L+1)/x + r_{L+1})
    rs = np.empty((Lmax + 1, npts), dtype=LD)
    r = np.zeros(npts, dtype=LD)
    for L in range(N, 0, -1):
        r = 1.0 / ((2 * L + 1) / x + r)
        if L <= Lmax:
            rs[L] = r
    out = np.empty((Lmax + 1, npts), dtype=LD)
    # i_0 = sinh(x)/x, stable for all x >= 0 (x>0 assumed)
    out[0] = np.sinh(x) / x
    for L in range(1, Lmax + 1):
        out[L] = out[L - 1] * rs[L]
    return out.astype(np.float64)
