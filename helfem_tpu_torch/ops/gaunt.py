"""Gaunt coefficients (L4), carried over from helfem_tpu/ops/gaunt.py: the
exact 3j symbols, the dense table of the atomic Coulomb/exchange builds, and
the cos^k, sin^2 and cos^2 sin^2 couplings of the field operators and the
modified (cos^2) couplings of the diatomic operators.

The reference computes Wigner-3j symbols with GSL and caches dense cubes
(src/general/gaunt.{cpp,h}). Here 3j symbols are evaluated EXACTLY in integer
arithmetic (Racah's single-sum formula over Fractions) on host at setup --
no GSL -- then moved to the device as small dense f64 tensors.

Table layout used by the Coulomb/exchange einsum paths:
    G[L, M+Moff, a, b] = <Y_{l_a m_a} | Y_{L M} | Y_{l_b m_b}>
nonzero only when m_a = M + m_b (reference: gaunt_coefficient convention,
src/general/gaunt.cpp:35-53).
"""

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np

__all__ = ["wigner3j", "gaunt_coefficient", "gaunt_table", "modified_gaunt_coefficient",
           "cosk_coupling", "sine2_coupling", "cos2sin2_coupling"]


@lru_cache(maxsize=None)
def _w3j_exact(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int):
    """(sign, S, P2): 3j = sign * S * sqrt(P2) with S, P2 exact Fractions."""
    if m1 + m2 + m3 != 0:
        return 1, Fraction(0), Fraction(0)
    if j3 < abs(j1 - j2) or j3 > j1 + j2:
        return 1, Fraction(0), Fraction(0)
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 1, Fraction(0), Fraction(0)
    f = math.factorial
    # triangle coefficient
    P2 = Fraction(
        f(j1 + j2 - j3) * f(j1 - j2 + j3) * f(-j1 + j2 + j3), f(j1 + j2 + j3 + 1)
    )
    P2 *= f(j1 + m1) * f(j1 - m1) * f(j2 + m2) * f(j2 - m2) * f(j3 + m3) * f(j3 - m3)
    kmin = max(0, j2 - j3 - m1, j1 - j3 + m2)
    kmax = min(j1 + j2 - j3, j1 - m1, j2 + m2)
    S = Fraction(0)
    for k in range(kmin, kmax + 1):
        den = (
            f(k)
            * f(j1 + j2 - j3 - k)
            * f(j1 - m1 - k)
            * f(j2 + m2 - k)
            * f(j3 - j2 + m1 + k)
            * f(j3 - j1 - m2 + k)
        )
        S += Fraction((-1) ** k, den)
    sign = (-1) ** (j1 - j2 - m3)
    return sign, S, P2


def wigner3j(j1: int, j2: int, j3: int, m1: int, m2: int, m3: int) -> float:
    """Exact-arithmetic Wigner 3j symbol (integer j only)."""
    sign, S, P2 = _w3j_exact(j1, j2, j3, m1, m2, m3)
    if S == 0:
        return 0.0
    return sign * float(S) * math.sqrt(float(P2))


@lru_cache(maxsize=None)
def gaunt_coefficient(L: int, M: int, l: int, m: int, lp: int, mp: int) -> float:
    """<Y_LM | Y_lm | Y_lp,mp> = integral Y_LM^* Y_lm Y_lp,mp dOmega."""
    if M != m + mp:
        return 0.0
    if L < abs(l - lp) or L > l + lp:
        return 0.0
    res = math.sqrt((2 * L + 1) * (2 * l + 1) * (2 * lp + 1) / (4.0 * math.pi))
    res *= wigner3j(L, l, lp, 0, 0, 0)
    res *= wigner3j(L, l, lp, -M, m, mp)
    return res * (-1.0) ** M


@lru_cache(maxsize=None)
def modified_gaunt_coefficient(la: int, ma: int, L: int, M: int, lb: int, mb: int) -> float:
    """Coupling of Y_LM through cos^2(theta):
    <Y_la,ma | cos^2 Y_LM | Y_lb,mb>, via cos^2 = (2/3)sqrt(pi) Y00 +
    (4/15)sqrt(5 pi) Y20 (reference: modified_gaunt_coefficient,
    src/general/gaunt.cpp:55-68)."""
    c0 = 2.0 / 3.0 * math.sqrt(math.pi)
    c2 = 4.0 / 15.0 * math.sqrt(5.0 * math.pi)
    cpl0 = gaunt_coefficient(L, M, 0, 0, L, M) * gaunt_coefficient(la, ma, lb, mb, L, M)
    cpl2 = 0.0
    for Lp in range(max(L - 2, abs(M), 0), L + 3):
        cpl2 += gaunt_coefficient(Lp, M, 2, 0, L, M) * gaunt_coefficient(la, ma, lb, mb, Lp, M)
    return c0 * cpl0 + c2 * cpl2


@lru_cache(maxsize=None)
def _cosk_legendre_coeffs(k: int):
    """Exact expansion x^k = sum_n c_n P_n(x): c_n = (2n+1)/2 int x^k P_n dx."""
    # Legendre coefficients as exact Fractions via the recurrence
    polys = [[Fraction(1)], [Fraction(0), Fraction(1)]]  # coefficient lists
    for n in range(1, k + 1):
        a = [Fraction(0)] + [Fraction(2 * n + 1, n + 1) * c for c in polys[n]]
        b = [Fraction(n, n + 1) * c for c in polys[n - 1]] + [Fraction(0)] * 2
        polys.append([x - y for x, y in zip(a, b + [Fraction(0)] * (len(a) - len(b)))])
    out = {}
    for n in range(k + 1):
        # c_n = (2n+1)/2 * sum_j p_j * int x^{k+j}
        tot = Fraction(0)
        for j, pj in enumerate(polys[n]):
            if (k + j) % 2 == 0:
                tot += pj * Fraction(2, k + j + 1)
        c = Fraction(2 * n + 1, 2) * tot
        if c != 0:
            out[n] = float(c)
    return out


@lru_cache(maxsize=None)
def cosk_coupling(k: int, la: int, ma: int, lb: int, mb: int) -> float:
    """<Y_la,ma | cos^k(theta) | Y_lb,mb> (reference: gaunt.h cosine/cosine2/
    .../cosine5_coupling helpers)."""
    if ma != mb:
        return 0.0
    val = 0.0
    for n, c in _cosk_legendre_coeffs(k).items():
        val += c * math.sqrt(4.0 * math.pi / (2 * n + 1)) * gaunt_coefficient(
            la, ma, n, 0, lb, mb
        )
    return val


def sine2_coupling(la, ma, lb, mb) -> float:
    """<Y_la,ma | sin^2(theta) | Y_lb,mb> = delta - <cos^2>."""
    d = 1.0 if (la == lb and ma == mb) else 0.0
    return d - cosk_coupling(2, la, ma, lb, mb)


def cos2sin2_coupling(la, ma, lb, mb) -> float:
    """<Y_la,ma | cos^2(theta) sin^2(theta) | Y_lb,mb> = <cos^2> - <cos^4>."""
    return cosk_coupling(2, la, ma, lb, mb) - cosk_coupling(4, la, ma, lb, mb)


def gaunt_table(lval: np.ndarray, mval: np.ndarray, Lmax: int) -> np.ndarray:
    """Dense coupling tensor G[L, M+Moff, a, b] for angular shells (l_a, m_a).

    M ranges over [-Moff, Moff] with Moff = max m spread; entry is
    <Y_{l_a m_a}|Y_LM|Y_{l_b m_b}>, zero unless M = m_a - m_b.
    """
    lval = np.asarray(lval)
    mval = np.asarray(mval)
    nang = len(lval)
    Moff = int(mval.max() - mval.min()) if nang else 0
    G = np.zeros((Lmax + 1, 2 * Moff + 1, nang, nang))
    for a in range(nang):
        for b in range(nang):
            M = int(mval[a] - mval[b])
            if abs(M) > Moff:
                continue
            for L in range(abs(int(lval[a] - lval[b])), min(Lmax, int(lval[a] + lval[b])) + 1):
                if abs(M) > L:
                    continue
                G[L, M + Moff, a, b] = gaunt_coefficient(
                    int(lval[a]), int(mval[a]), L, M, int(lval[b]), int(mval[b])
                )
    return G
