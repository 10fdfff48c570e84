"""Associated Legendre functions P_l^m(x), Q_l^m(x) for x > 1 (L4),
carried over from helfem_tpu/ops/legendreq.py (host numpy, longdouble).

Replaces the reference's Fortran library (src/legendre/*.f90, Schneider et
al. CPC 2010/2018 + wrapper src/legendre/Legendre_Wrapper.h) used for the
prolate-spheroidal (diatomic) two-electron integrals.

Conventions (Hobson, x > 1, no Condon-Shortley phase):
    f_l^m(x) = (x^2-1)^{m/2} d^m f_l / dx^m   for f in {P, Q}
matching the Neumann expansion prefactor used by the reference
(LMfac = 4 pi Rh^5 (-1)^M (L-|M|)!/(L+|M|)!, src/diatomic/basis.cpp:1419).

Algorithms (numpy longdouble on host; helfem_tpu's optional C++ copy of the
same algorithm, csrc/legendre_pq.cpp, is not carried over):
  P_l^0: upward l recursion (P grows with l: stable).
  Q_l^0: two branches, switched per point on theta = arccosh(x):
    * theta*Lmax small (x near 1): the exact identity
        Q_l = P_l Q_0 - W_{l-1},  W_{l-1} = sum_{k=1..l} P_{k-1} P_{l-k} / k
      (cancellation ~ e^{2 l theta}, mild near x=1; longdouble absorbs it),
    * otherwise: downward continued-fraction/Miller recursion for the
      minimal solution, normalized by the exact Q_0.
  m > 0 columns for both P and Q: the order-raising relation
      sqrt(x^2-1) f_l^{m+1} = (l-m) x f_l^m - (l+m) f_{l-1}^m
  applied column by column on the l >= m triangle (growing in m: stable).
"""

import numpy as np

__all__ = ["legendre_PQ"]

LD = np.longdouble


def _P0_upward(Lmax: int, x: np.ndarray) -> np.ndarray:
    P = np.empty((Lmax + 1, len(x)), dtype=LD)
    P[0] = 1.0
    if Lmax >= 1:
        P[1] = x
    for l in range(1, Lmax):
        P[l + 1] = ((2 * l + 1) * x * P[l] - l * P[l - 1]) / (l + 1)
    return P


def _Q0_identity(Lmax: int, x: np.ndarray, P: np.ndarray, Q0: np.ndarray) -> np.ndarray:
    """Q_l = P_l Q_0 - W_{l-1} with W_{l-1} = sum_{k=1}^{l} P_{k-1} P_{l-k}/k."""
    Q = np.empty((Lmax + 1, len(x)), dtype=LD)
    Q[0] = Q0
    for l in range(1, Lmax + 1):
        W = np.zeros_like(x)
        for k in range(1, l + 1):
            W += P[k - 1] * P[l - k] / LD(k)
        Q[l] = P[l] * Q0 - W
    return Q


def _Q0_downward(Lmax: int, x: np.ndarray, npad: np.ndarray, Q0v: np.ndarray) -> np.ndarray:
    """Miller's algorithm: downward recursion of the minimal solution from
    ratio r_N = 0 at N = Lmax + pad, normalized by the exact Q_0."""
    pad = int(np.max(npad))
    N = Lmax + pad
    # downward ratio recursion for the minimal solution, r_l = Q_l / Q_{l-1}:
    #   from (l+1) Q_{l+1} = (2l+1) x Q_l - l Q_{l-1}:
    #   r_l = l / ((2l+1) x - (l+1) r_{l+1}),   seeded with r_N = 0
    rs = np.empty((Lmax + 1, len(x)), dtype=LD)
    r = np.zeros_like(x)
    for l in range(N, 0, -1):
        r = LD(l) / ((2 * l + 1) * x - (l + 1) * r)
        if l <= Lmax:
            rs[l] = r
    Q = np.empty((Lmax + 1, len(x)), dtype=LD)
    Q[0] = Q0v
    for l in range(1, Lmax + 1):
        Q[l] = Q[l - 1] * rs[l]
    return Q


def _raise_m(F: np.ndarray, Lmax: int, Mmax: int, x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Fill the m > 0 columns of a [Lmax+1, Mmax+1, npts] table whose m=0
    column is given, via sqrt(x^2-1) f_l^{m+1} = (l-m) x f_l^m - (l+m) f_{l-1}^m
    on the l >= m+1 triangle (entries with l < m stay zero for P / unused
    for Q)."""
    for m in range(Mmax):
        for l in range(m + 1, Lmax + 1):
            F[l, m + 1] = ((l - m) * x * F[l, m] - (l + m) * F[l - 1, m]) / s
    return F


def legendre_PQ(
    Lmax: int, Mmax: int, xi: np.ndarray | None = None, mu: np.ndarray | None = None,
    theta_switch: float = 3.0,
):
    """P[l, m, n], Q[l, m, n] for xi[n] > 1, float64 output.

    Either xi (> 1) or mu (= arccosh xi, > 0) may be given; passing mu keeps
    full accuracy for xi extremely close to 1 (xi - 1 = 2 sinh^2(mu/2) is
    computed in longdouble, where cosh(mu) itself would round to 1.0).

    theta_switch: points with arccosh(xi) * max(Lmax,1) < theta_switch use
    the exact product identity for Q_l^0, others the downward recursion."""
    if mu is not None:
        mu = np.asarray(mu, dtype=LD)
        if np.any(mu <= 0.0):
            raise ValueError("legendre_PQ requires mu > 0")
        xi = np.cosh(mu)
        xim1 = 2.0 * np.sinh(mu / 2.0) ** 2
        theta = mu.astype(np.float64)
    else:
        xi = np.asarray(xi, dtype=LD)
        if np.any(xi <= 1.0):
            raise ValueError("legendre_PQ requires xi > 1")
        xim1 = xi - 1.0
        theta = np.arccosh(xi.astype(np.float64))
    npts = len(xi)

    P0 = _P0_upward(Lmax, xi)

    Q0v = 0.5 * np.log((xi + 1.0) / xim1)
    Q0 = np.empty((Lmax + 1, npts), dtype=LD)
    near = theta * max(Lmax, 1) < theta_switch
    if np.any(near):
        Q0[:, near] = _Q0_identity(Lmax, xi[near], P0[:, near], Q0v[near])
    if np.any(~near):
        xf = xi[~near]
        # pad for Miller: error ~ e^{-2 pad theta}; aim for 1e-20
        padn = np.ceil(24.0 / np.maximum(theta[~near], 1e-3)).astype(int) + 10
        Q0[:, ~near] = _Q0_downward(Lmax, xf, padn, Q0v[~near])

    P = np.zeros((Lmax + 1, Mmax + 1, npts), dtype=LD)
    Q = np.zeros((Lmax + 1, Mmax + 1, npts), dtype=LD)
    P[:, 0] = P0
    Q[:, 0] = Q0
    if Mmax > 0:
        # column c is filled for all l >= c (the raising loop for target
        # column m+1 starts at l = m+1, and its sources in column m sit at
        # l >= m, already available) -- exactly the l >= m triangle used by
        # the Neumann expansion.
        s = np.sqrt(xim1 * (xi + 1.0))
        P = _raise_m(P, Lmax, Mmax, xi, s)
        Q = _raise_m(Q, Lmax, Mmax, xi, s)
    return P.astype(np.float64), Q.astype(np.float64)
