"""Exchange-correlation functionals (L6), ported from helfem_tpu/ops/xc.py.

Each functional is a pointwise energy density f(rho_a, rho_b, sigma_aa,
sigma_ab, sigma_bb) -> e (energy per unit volume) written in plain torch
ops; every potential (vrho, vsigma) comes from one reverse-mode
torch.autograd.grad pass in f64, where helfem_tpu takes jax.vjp, so the
potentials match the energy by construction.

Meta-GGAs (family 'mgga') also take the kinetic energy densities ta, tb
and give vtau; the laplacian-level BR89 (family 'mggal') takes ta, tb and
the density laplacians la, lb too and gives vtau and vlapl.

Ported: Slater exchange, VWN5 and PW92 correlation (LDA); PBE, RPBE and
B88 exchange, PBE and LYP correlation (GGA), with the revPBE and PBEsol
parameter variants; TPSS, SCAN and rSCAN exchange and correlation
(meta-GGA); BR89 exchange (laplacian-level meta-GGA). Methods: HF, lda,
svwn/svwn5, pbe, revpbe, pbesol, rpbe, blyp,
tpss, scan, rscan, the hybrids pbe0/pbeh, tpssh and b3lyp5, the
range-separated hybrids lc-lda/ldaerf, lcy-lda and sr-pbe0 (with their
[omega=..,kshort=..,kfull=..] overrides; the short-range LDA exchange
lda_x_erf), and 'x,c' (or 'x-c') pairs of the catalog's functionals, BR89
('mgga_x_br89') among them. Formulas from the original publications
(Vosko-Wilk-Nusair 1980; Perdew-Wang 1992; Perdew-Burke-Ernzerhof 1996;
Becke 1988; Lee-Yang-Parr 1988; Becke-Roussel 1989; Tao et al. 2003;
Sun-Ruzsinszky-Perdew 2015; Bartok-Yates 2019; Gill-Adamson-Pople 1996).

Density threshold: points with rho < thr are masked out of energies and
potentials (libxc's dens_threshold convention, dftgrid.cpp:428).
"""

import inspect
import math
from functools import lru_cache
from typing import Callable, NamedTuple

import torch

__all__ = ["Functional", "MethodSpec", "get_functional", "with_params",
           "scale_functional", "parse_method", "parse_method_rs", "xc_eval"]

_TINY = 1e-30
_PI = math.pi


def _max(x, c):
    """max(x, c) with jnp.maximum's derivative: half to each side at a tie
    (torch.clamp passes all of it), so that potentials at a floor agree
    with helfem_tpu's."""
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))


def _min(x, c):
    return torch.minimum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), with its derivative at ties."""
    return _min(_max(x, lo), hi)


def _clip_zeta(zeta):
    # keep |zeta| strictly below 1: phi = (1 -+ zeta)^{2/3} has an infinite
    # rho-derivative at zeta = +-1 (reached exactly when one spin density
    # rounds away), which would poison the autodiff potentials with NaNs
    return _clip(zeta, -1.0 + 1e-15, 1.0 - 1e-15)


class Functional(NamedTuple):
    name: str
    family: str  # 'lda', 'gga', 'mgga' or 'mggal'
    f: Callable  # (ra, rb, saa, sab, sbb[, ta, tb[, la, lb]], **params) -> energy per volume
    params: tuple = ()  # sorted ((key, value), ...) overrides, hashable


# ----------------------------------------------------------------------------
# LDA exchange (Slater/Dirac)
# ----------------------------------------------------------------------------


def _ex_slater(ra, rb, saa, sab, sbb):
    cx = -0.75 * (6.0 / _PI) ** (1.0 / 3.0)
    return cx * (ra ** (4.0 / 3.0) + rb ** (4.0 / 3.0))


def _sr_lda_factor(a):
    """Short-range attenuation of the LDA exchange hole for the erf-split
    interaction (Gill-Adamson-Pople 1996 / Toulouse-Savin): the kept part is
    erfc(omega r12)/r12. a = omega / (2 kF). Evaluated directly for small a
    and by its large-a series (f -> 1/(36 a^2)) where the closed form loses
    all significance to cancellation. Each branch sees its argument clamped
    to its own side of a = 8 (asafe, abig), so the branch that torch.where
    discards has a finite gradient and leaks no NaN into the potential."""
    a = _max(a, 1e-10)
    asafe = _min(a, 8.0)
    t = 1.0 / (2.0 * asafe)
    direct = 1.0 - (8.0 * asafe / 3.0) * (
        math.sqrt(_PI) * torch.special.erf(t)
        + (2.0 * asafe - 4.0 * asafe**3) * torch.exp(-(t * t))
        - 3.0 * asafe
        + 4.0 * asafe**3
    )
    abig = _max(a, 8.0)
    series = 1.0 / (36.0 * abig * abig) - 1.0 / (960.0 * abig**4)
    return torch.where(a < 8.0, direct, series)


def _ex_slater_erf(ra, rb, saa, sab, sbb, *, omega=0.5):
    """Short-range (erfc-kernel) LDA exchange: the semilocal complement used
    by LC-type range-separated hybrids (libxc lda_x_erf analogue). Exact
    spin scaling E[ra, rb] = (E[2 ra] + E[2 rb]) / 2."""
    cx = -0.75 * (3.0 / _PI) ** (1.0 / 3.0)

    def one(r):
        r2 = 2.0 * r
        kf = (3.0 * _PI**2 * _max(r2, _TINY)) ** (1.0 / 3.0)
        f = _sr_lda_factor(omega / (2.0 * kf))
        return 0.5 * cx * r2 ** (4.0 / 3.0) * f

    return one(ra) + one(rb)


# ----------------------------------------------------------------------------
# VWN5 correlation
# ----------------------------------------------------------------------------


def _vwn_F(x, A, x0, b, c):
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4.0 * c - b * b)
    atn = torch.atan(Q / (2.0 * x + b))
    return A * (
        torch.log(x * x / X)
        + 2.0 * b / Q * atn
        - b * x0 / X0 * (torch.log((x - x0) ** 2 / X) + 2.0 * (b + 2.0 * x0) / Q * atn)
    )


def _ec_vwn5(ra, rb, saa, sab, sbb):
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    rs = (3.0 / (4.0 * _PI * rho)) ** (1.0 / 3.0)
    x = torch.sqrt(rs)
    ecP = _vwn_F(x, 0.0310907, -0.10498, 3.72744, 12.9352)
    ecF = _vwn_F(x, 0.01554535, -0.32500, 7.06042, 18.0578)
    ac = _vwn_F(x, -1.0 / (6.0 * _PI**2), -0.00475840, 1.13107, 13.0045)
    fz = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 * (2.0 ** (1.0 / 3.0) - 1.0)
    )
    fpp0 = 8.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))
    z4 = zeta**4
    ec = ecP + ac * fz / fpp0 * (1.0 - z4) + (ecF - ecP) * fz * z4
    return ec * rho


# ----------------------------------------------------------------------------
# PW92 correlation
# ----------------------------------------------------------------------------


def _pw92_G(rs, A, a1, b1, b2, b3, b4, p):
    srs = torch.sqrt(rs)
    den = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs ** (p + 1.0))
    return -2.0 * A * (1.0 + a1 * rs) * torch.log(1.0 + 1.0 / den)


def _ec_pw92_eps(rho, zeta):
    rs = (3.0 / (4.0 * _PI * rho)) ** (1.0 / 3.0)
    ec0 = _pw92_G(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294, 1.0)
    ec1 = _pw92_G(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517, 1.0)
    mac = _pw92_G(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671, 1.0)
    fz = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 * (2.0 ** (1.0 / 3.0) - 1.0)
    )
    fpp0 = 1.709920934161365617563962776245
    z4 = zeta**4
    return ec0 - mac * fz / fpp0 * (1.0 - z4) + (ec1 - ec0) * fz * z4


def _ec_pw92(ra, rb, saa, sab, sbb):
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    return _ec_pw92_eps(rho, zeta) * rho


# ----------------------------------------------------------------------------
# PBE exchange and correlation
# ----------------------------------------------------------------------------


def _ex_pbe(ra, rb, saa, sab, sbb, *, kappa=0.804, mu=0.2195149727645171):

    def exs(r2, s2x4):
        # E_x[rho] for the closed-shell density 2*rho_s with sigma 4*sigma_ss;
        # the reduced gradient from n^(-4/3) factors, as helfem_tpu forms it
        kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
        r13 = r2 ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r13 / (4.0 * _PI)
        inv43 = r2 ** (-4.0 / 3.0)
        s2 = (s2x4 * inv43) * inv43 / (4.0 * kf1**2)
        Fx = 1.0 + kappa - kappa / (1.0 + mu * s2 / kappa)
        return r2 * exu * Fx

    return 0.5 * (exs(2.0 * ra, 4.0 * saa) + exs(2.0 * rb, 4.0 * sbb))


def _ex_rpbe(ra, rb, saa, sab, sbb, *, kappa=0.804, mu=0.2195149727645171):
    # RPBE (Hammer, Hansen, Norskov, PRB 59, 7413 (1999)): PBE's UEG limit,
    # small-s expansion and 1 + kappa bound, with an exponential saturation
    # Fx = 1 + kappa (1 - exp(-mu s^2 / kappa))
    def exs(r2, s2x4):
        kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
        r13 = r2 ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r13 / (4.0 * _PI)
        inv43 = r2 ** (-4.0 / 3.0)
        s2 = (s2x4 * inv43) * inv43 / (4.0 * kf1**2)
        Fx = 1.0 + kappa * (1.0 - torch.exp(-mu * s2 / kappa))
        return r2 * exu * Fx

    return 0.5 * (exs(2.0 * ra, 4.0 * saa) + exs(2.0 * rb, 4.0 * sbb))


def _ec_pbe(ra, rb, saa, sab, sbb, *, beta=0.06672455060314922):
    gamma = (1.0 - math.log(2.0)) / _PI**2
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    eps = _ec_pw92_eps(rho, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    sigma = saa + 2.0 * sab + sbb
    # t2 = sigma / (4 phi^2 ks^2 rho^2) with ks^2 = 4 kf / pi, from the
    # range-safe factors helfem_tpu uses
    kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
    inv43 = rho ** (-4.0 / 3.0)
    t2 = (sigma * inv43) / rho * (_PI / (16.0 * kf1)) / (phi * phi)
    expo = torch.exp(-eps / (gamma * phi**3))
    A = beta / gamma / (expo - 1.0 + _TINY)
    u = A * t2
    ratio = 1.0 / (1.0 + (u / (1.0 + u)) * u)
    H = gamma * phi**3 * torch.log(1.0 + beta / gamma * t2 * ratio)
    return (eps + H) * rho


# ----------------------------------------------------------------------------
# B88 exchange and LYP correlation
# ----------------------------------------------------------------------------


def _ex_b88(ra, rb, saa, sab, sbb, *, beta=0.0042):
    """Becke 1988 gradient-corrected exchange."""

    def exs(r, s):
        r43 = r ** (4.0 / 3.0)
        # x = |grad rho| / rho^(4/3); the 1e-30 sigma floor keeps sqrt's
        # derivative finite at sigma = 0
        x = torch.sqrt(_max(s, 0.0) + 1e-30) * r ** (-4.0 / 3.0)
        corr = -beta * r43 * x * x / (1.0 + 6.0 * beta * x * torch.asinh(x))
        lda = -0.75 * (6.0 / _PI) ** (1.0 / 3.0) * r43
        return lda + corr

    return exs(ra, saa) + exs(rb, sbb)


def _ec_lyp(ra, rb, saa, sab, sbb):
    """Lee-Yang-Parr correlation in the Miehlich et al. form, with the
    rho^(-11/3) weight carried by spin ratios and rho^(-5/3) factors as
    helfem_tpu writes it."""
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    CF = 0.3 * (3.0 * _PI**2) ** (2.0 / 3.0)
    rho = ra + rb
    r13 = rho ** (-1.0 / 3.0)
    den = 1.0 + d * r13
    delta = c * r13 + d * r13 / den
    sigma = saa + 2.0 * sab + sbb
    t1 = -a * 4.0 / den * (ra / rho) * rb
    xa, xb = ra / rho, rb / rho
    inv43 = rho ** (-4.0 / 3.0)

    def m53(q):  # q * rho^(-5/3)
        return (q * inv43) * r13

    T2 = (
        2.0 ** (11.0 / 3.0) * CF * (xa ** (8.0 / 3.0) + xb ** (8.0 / 3.0)) * rho
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * m53(sigma)
        - (2.5 - delta / 18.0) * m53(saa + sbb)
        - (delta - 11.0) / 9.0 * m53(xa * saa + xb * sbb)
    )
    T3 = (
        -2.0 / 3.0 * m53(sigma)
        + (2.0 / 3.0 - xa * xa) * m53(sbb)
        + (2.0 / 3.0 - xb * xb) * m53(saa)
    )
    omega0 = torch.exp(-c * r13) / den
    return t1 - a * b * omega0 * (xa * xb * T2 + T3)


# ----------------------------------------------------------------------------
# TPSS meta-GGA (Tao-Perdew-Staroverov-Scuseria 2003)
# ----------------------------------------------------------------------------


def _tpss_Fx(p, z, alpha):
    """TPSS exchange enhancement factor, eqs. (5)-(10) of PRL 91, 146401."""
    kappa = 0.804
    b = 0.40
    c = 1.59096
    e = 1.537
    mu = 0.21951
    qb = 0.45 * (alpha - 1.0) / torch.sqrt(1.0 + b * alpha * (alpha - 1.0)) + 2.0 * p / 3.0
    z2 = z * z
    num = (
        (10.0 / 81.0 + c * z2 / (1.0 + z2) ** 2) * p
        + 146.0 / 2025.0 * qb * qb
        - 73.0 / 405.0 * qb * torch.sqrt(0.5 * (0.6 * z) ** 2 + 0.5 * p * p + 1e-30)
        + (1.0 / kappa) * (10.0 / 81.0) ** 2 * p * p
        + 2.0 * math.sqrt(e) * (10.0 / 81.0) * (0.6 * z) ** 2
        + e * mu * p**3
    )
    den = 1.0 + math.sqrt(e) * p
    x = (num / den) / den
    return 1.0 + kappa - kappa / (1.0 + x / kappa)


def _ex_tpss(ra, rb, saa, sab, sbb, ta, tb):
    def exs(r2, s4, t2):
        # closed-shell quantities of the density 2 rho_s; z = tw / tau from
        # ratios scaled by n^(-5/3), as helfem_tpu forms them
        kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r2 ** (1.0 / 3.0) / (4.0 * _PI)
        inv43 = r2 ** (-4.0 / 3.0)
        inv53 = r2 ** (-5.0 / 3.0)
        p = (s4 * inv43) * inv43 / (4.0 * kf1**2)
        tw = s4 / (8.0 * r2 + _TINY)  # von Weizsaecker
        tau = torch.maximum(t2, tw + _TINY)
        tws = tw * inv53
        taus = tau * inv53
        z = _clip(tws / torch.maximum(taus, _max(tws, 1e-15)), 0.0, 1.0)
        alpha = _max((tau - tw) * inv53 / (0.3 * kf1**2), 0.0)
        return r2 * exu * _tpss_Fx(p, z, alpha)

    return 0.5 * (exs(2.0 * ra, 4.0 * saa, 2.0 * ta) + exs(2.0 * rb, 4.0 * sbb, 2.0 * tb))


def _ec_tpss(ra, rb, saa, sab, sbb, ta, tb):
    """TPSS correlation: revPKZB with the z^3 self-interaction correction."""
    d = 2.8
    rho = ra + rb
    tau = ta + tb
    sigma = saa + 2.0 * sab + sbb
    tw = sigma / (8.0 * rho + _TINY)
    inv53 = rho ** (-5.0 / 3.0)
    tws = tw * inv53
    taus = torch.maximum(tau, tw + _TINY) * inv53
    z = _clip(tws / torch.maximum(taus, _max(tws, 1e-15)), 0.0, 1.0)
    zeta = _clip((ra - rb) / rho, -1.0 + 1e-14, 1.0 - 1e-14)
    # C(zeta, xi)
    C0 = 0.53 + 0.87 * zeta**2 + 0.50 * zeta**4 + 2.26 * zeta**6
    xa, xb = ra / rho, rb / rho
    gz2 = 4.0 * (xb * xb * saa - 2.0 * xa * xb * sab + xa * xa * sbb) * rho ** (-2.0)
    kf = (3.0 * _PI**2 * rho) ** (1.0 / 3.0)
    xi2 = gz2 / (4.0 * kf**2 + _TINY)
    fz = 0.5 * ((1.0 + zeta) ** (-4.0 / 3.0) + (1.0 - zeta) ** (-4.0 / 3.0))
    C = C0 * torch.exp(-4.0 * torch.log1p(xi2 * fz))  # C0 / (1 + xi2 fz)^4
    # epsilon_c^PBE of the full density (per particle)
    eps = _ec_pbe(ra, rb, saa, sab, sbb) / rho
    # per-spin fully polarized PBE epsilon, floored at 1e-12 as helfem_tpu
    # floors it (a vanishing spin density enters with weight rho_s / rho)
    ra_s = _max(ra, 1e-12)
    rb_s = _max(rb, 1e-12)
    epsa = _ec_pbe(ra_s, _TINY, saa, 0.0, 0.0) / ra_s
    epsb = _ec_pbe(rb_s, _TINY, sbb, 0.0, 0.0) / rb_s
    epsta = torch.maximum(epsa, eps)
    epstb = torch.maximum(epsb, eps)
    sumterm = (ra * epsta + rb * epstb) / rho
    epsrev = eps * (1.0 + C * z * z) - (1.0 + C) * z * z * sumterm
    return rho * epsrev * (1.0 + d * epsrev * z**3)


# ----------------------------------------------------------------------------
# SCAN meta-GGA (Sun-Ruzsinszky-Perdew, PRL 115, 036402 (2015))
# ----------------------------------------------------------------------------


def _scan_falpha(alpha, c1, c2, d):
    """SCAN's iso-orbital interpolation f(alpha): exp(-c1 a/(1-a)) below
    a = 1, -d exp(c2/(1-a)) above, each branch on clipped inputs so that
    the branch torch.where drops has a finite derivative."""
    a_lo = _clip(alpha, 0.0, 1.0 - 1e-9)
    lo = torch.exp(-c1 * a_lo / (1.0 - a_lo))
    a_hi = _max(alpha, 1.0 + 1e-9)
    hi = -d * torch.exp(c2 / (1.0 - a_hi))
    return torch.where(alpha < 1.0, lo, hi)


def _scan_gx_block(k1):
    """SCAN exchange's gradient-expansion constants (b1, b2, b3, b4) from
    their exact fractions."""
    muak = 10.0 / 81.0
    b2 = (5913.0 / 405000.0) ** 0.5
    b1 = (511.0 / 13500.0) / (2.0 * b2)
    b4 = muak * muak / k1 - 1606.0 / 18225.0 - b1 * b1
    return b1, b2, 0.5, b4


def _scan_Fx(p, alpha, fx, k1, k0):
    """SCAN's exchange enhancement factor at iso-orbital indicator alpha
    with the interpolation value fx = f_x(alpha)."""
    muak = 10.0 / 81.0
    b1, b2, b3, b4 = _scan_gx_block(k1)
    a1 = 4.9479
    oma = 1.0 - alpha
    x = muak * p * (1.0 + (b4 * p / muak) * torch.exp(-abs(b4) * p / muak)) + (
        b1 * p + b2 * oma * torch.exp(-b3 * oma * oma)
    ) ** 2
    # h1x saturates at 1 + k1 for x >> k1; the cap changes it by < 4e-11
    x = _min(x, 1e8)
    h1x = 1.0 + k1 - k1 / (1.0 + x / k1)
    # g_x = 1 - exp(-a1 p^(-1/4)), p floored where the exponential is 0
    pf = _max(p, 1e-20)
    gx = 1.0 - torch.exp(-a1 / torch.sqrt(torch.sqrt(pf)))
    return (h1x + fx * (1.0 + k0 - h1x)) * gx


def _ex_scan(ra, rb, saa, sab, sbb, ta, tb, *, k1=0.065, k0=0.174):
    """SCAN exchange (constants from the PRL 115, 036402 supplement)."""

    def exs(r2, s4, t2):
        kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r2 ** (1.0 / 3.0) / (4.0 * _PI)
        inv43 = r2 ** (-4.0 / 3.0)
        inv53 = r2 ** (-5.0 / 3.0)
        p = (s4 * inv43) * inv43 / (4.0 * kf1**2)
        tw = s4 / (8.0 * r2 + _TINY)
        tau = torch.maximum(t2, tw + _TINY)
        alpha = _max((tau - tw) * inv53 / (0.3 * kf1**2), 0.0)
        fx = _scan_falpha(alpha, 0.667, 0.8, 1.24)
        return r2 * exu * _scan_Fx(p, alpha, fx, k1, k0)

    return 0.5 * (exs(2.0 * ra, 4.0 * saa, 2.0 * ta) + exs(2.0 * rb, 4.0 * sbb, 2.0 * tb))


def _scan_eps_c(rho, zeta, sigma, fc_of_alpha, alpha_of):
    """SCAN-type correlation per volume: the alpha = 1 limit (PW92 + H1)
    and the alpha = 0 limit (LDA0 + H0, spin factor g_c) interpolated by
    fc_of_alpha(alpha), alpha = alpha_of(num53, den53, inv53)."""
    b1c, b2c, b3c = 0.0285764, 0.0889, 0.125541
    chi_inf = 0.128026
    gamma = 0.031091
    kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
    inv43 = rho ** (-4.0 / 3.0)
    rs = (3.0 / (4.0 * _PI)) ** (1.0 / 3.0) * rho ** (-1.0 / 3.0)
    p = (sigma * inv43) * inv43 / (4.0 * kf1**2)
    ds = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    alpha = alpha_of(0.3 * kf1**2 * ds)

    eps_lsda = _ec_pw92_eps(rho, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    phi3 = phi * phi * phi
    t2 = (sigma * inv43) / rho * (_PI / (16.0 * kf1)) / (phi * phi)
    w1 = torch.expm1(-eps_lsda / (gamma * phi3))
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    y = beta_rs / (gamma * (w1 + _TINY)) * t2
    g = (1.0 + 4.0 * y) ** (-0.25)
    H1 = gamma * phi3 * torch.log1p(w1 * (1.0 - g))
    eps1 = eps_lsda + H1

    eps_lda0 = -b1c / (1.0 + b2c * torch.sqrt(rs) + b3c * rs)
    w0 = torch.expm1(-eps_lda0 / b1c)
    ginf = (1.0 + 4.0 * chi_inf * p) ** (-0.25)
    H0 = b1c * torch.log1p(w0 * (1.0 - ginf))
    dxz = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gcz = (1.0 - 2.3631 * (dxz - 1.0)) * (1.0 - zeta**12)
    eps0 = (eps_lda0 + H0) * gcz

    fc = fc_of_alpha(alpha)
    return rho * (eps1 + fc * (eps0 - eps1))


def _ec_scan(ra, rb, saa, sab, sbb, ta, tb):
    """SCAN correlation: single-orbital (alpha = 0) and slowly varying
    (alpha = 1) limits interpolated by f_c(alpha)."""
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    sigma = saa + 2.0 * sab + sbb
    tw = sigma / (8.0 * rho + _TINY)
    taus = torch.maximum(ta + tb, tw + _TINY)
    inv53 = rho ** (-5.0 / 3.0)
    return _scan_eps_c(
        rho, zeta, sigma, lambda a: _scan_falpha(a, 0.64, 1.5, 0.7),
        lambda den53: _max((taus - tw) * inv53 / den53, 0.0))


# ----------------------------------------------------------------------------
# rSCAN meta-GGA (Bartok-Yates, JCP 150, 161101 (2019)): SCAN with a
# regularized iso-orbital indicator and polynomial interpolation functions
# ----------------------------------------------------------------------------

# Degree-7 interpolation polynomials replacing SCAN's exponentials on
# [0, 2.5): coefficients 0-2 are the Taylor expansion of exp(-c1 a/(1-a))
# at a = 0, and value and first two derivatives meet the -d exp(c2/(1-a))
# branch at a = 2.5
_RSCAN_CX = (1.0, -0.667, -0.4445555, -0.663086601049, 1.451297044490,
             -0.887998041597, 0.234528941479, -0.023185843322)
_RSCAN_CC = (1.0, -0.64, -0.4352, -1.535685604549, 3.061560252175,
             -1.915710236206, 0.516884468372, -0.051848879792)
_RSCAN_TAU_R = 1.0e-4
_RSCAN_ALPHA_R = 1.0e-3


def _rscan_falpha(alpha, cs, c2, d):
    """rSCAN interpolation: the degree-7 polynomial below alpha = 2.5,
    SCAN's damped exponential above."""
    poly = torch.zeros_like(alpha)
    for c in reversed(cs):
        poly = poly * alpha + c
    a_hi = _max(alpha, 2.5)
    hi = -d * torch.exp(c2 / (1.0 - a_hi))
    return torch.where(alpha < 2.5, poly, hi)


def _rscan_alpha(num53, den53, inv53):
    """Regularized alpha' = a^3 / (a^2 + alpha_r) of
    a = (tau - tau_W) / (tau_unif + tau_r), from the tunif-scaled numerator
    (tau - tw) rho^(-5/3), the scaled tau_unif prefactor and rho^(-5/3); a
    capped at 1e6, where f(alpha) is constant to 1e-6."""
    a = num53 / (den53 + _RSCAN_TAU_R * inv53)
    a = _min(a, 1e6)
    return a * a * a / (a * a + _RSCAN_ALPHA_R)


def _ex_rscan(ra, rb, saa, sab, sbb, ta, tb, *, k1=0.065, k0=0.174):
    """rSCAN exchange: SCAN's F_x with alpha -> alpha' and f_x -> the
    polynomial interpolation."""

    def exs(r2, s4, t2):
        kf1 = (3.0 * _PI**2) ** (1.0 / 3.0)
        exu = -3.0 * kf1 * r2 ** (1.0 / 3.0) / (4.0 * _PI)
        inv43 = r2 ** (-4.0 / 3.0)
        inv53 = r2 ** (-5.0 / 3.0)
        p = (s4 * inv43) * inv43 / (4.0 * kf1**2)
        tw = s4 / (8.0 * r2 + _TINY)
        tau = torch.maximum(t2, tw + _TINY)
        alpha = _rscan_alpha(_max((tau - tw) * inv53, 0.0), 0.3 * kf1**2, inv53)
        fx = _rscan_falpha(alpha, _RSCAN_CX, 0.8, 1.24)
        return r2 * exu * _scan_Fx(p, alpha, fx, k1, k0)

    return 0.5 * (exs(2.0 * ra, 4.0 * saa, 2.0 * ta) + exs(2.0 * rb, 4.0 * sbb, 2.0 * tb))


def _ec_rscan(ra, rb, saa, sab, sbb, ta, tb):
    """rSCAN correlation: SCAN's eps_c0 / eps_c1 interpolated by the f_c
    polynomial of the regularized alpha'."""
    rho = ra + rb
    zeta = _clip_zeta((ra - rb) / rho)
    sigma = saa + 2.0 * sab + sbb
    tw = sigma / (8.0 * rho + _TINY)
    taus = torch.maximum(ta + tb, tw + _TINY)
    inv53 = rho ** (-5.0 / 3.0)
    return _scan_eps_c(
        rho, zeta, sigma, lambda a: _rscan_falpha(a, _RSCAN_CC, 1.5, 0.7),
        lambda den53: _rscan_alpha(_max((taus - tw) * inv53, 0.0), den53, inv53))


# ----------------------------------------------------------------------------
# BR89 exchange (laplacian-level meta-GGA)
# ----------------------------------------------------------------------------


def _br89_g(x):
    return x * torch.exp(-2.0 * x / 3.0) / (x - 2.0)


def _br89_solve_x(y):
    """Invert y = x exp(-2x/3)/(x-2) (xc.py:633-668): g decreases on both
    branches, (0,2) -> (-inf, 0) and (2, inf) -> (0, inf), so 80 halvings
    of the branch's bracket (without autograd) find x, and three Newton
    steps on ln|g(x)| - ln|y| with autograd on polish it, so that the
    derivative is the implicit-function one, as in helfem_tpu."""
    neg = y < 0.0
    # helfem_tpu's 1e-30 floor, kept so the comparison holds term for term
    ys = torch.where(torch.abs(y) > 1e-30, y,
                     torch.where(neg, torch.full_like(y, -1e-30), torch.full_like(y, 1e-30)))
    with torch.no_grad():
        yd = ys.detach()
        lo = torch.where(neg, torch.full_like(yd, 1e-10), torch.full_like(yd, 2.0 + 1e-10))
        hi = torch.where(neg, torch.full_like(yd, 2.0 - 1e-10), torch.full_like(yd, 600.0))
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            too_small = _br89_g(mid) > yd  # g(mid) > y: x must grow
            lo = torch.where(too_small, mid, lo)
            hi = torch.where(too_small, hi, mid)
        x = 0.5 * (lo + hi)
    for _ in range(3):
        h = torch.log(torch.abs(_br89_g(x))) - torch.log(torch.abs(ys))
        hp = 1.0 / x - 2.0 / 3.0 - 1.0 / (x - 2.0)
        x = x - h / hp
    return x


def _ex_br89(ra, rb, saa, sab, sbb, ta, tb, la, lb, *, gamma=0.8):
    """Becke-Roussel 1989 exchange (PRA 38, 3761; xc.py:671-692): the
    exchange hole modelled by a displaced exponential matched to the exact
    small-separation expansion; exact for one-electron (hydrogenic)
    densities. tau carries the 1/2 convention (BR's tau = 2 tau here)."""

    def exs(r, s, t, lap):
        D = 2.0 * t - 0.25 * s / (r + _TINY)
        Q = (lap - 2.0 * gamma * D) / 6.0
        # helfem_tpu's 1e-15 floor on |Q| (far tails only)
        Qs = torch.where(torch.abs(Q) > 1e-15, Q,
                         torch.where(Q < 0.0, torch.full_like(Q, -1e-15),
                                     torch.full_like(Q, 1e-15)))
        y = (2.0 / 3.0) * _PI ** (2.0 / 3.0) * r ** (5.0 / 3.0) / Qs
        x = _br89_solve_x(y)
        ex = torch.exp(-x)
        b3 = x**3 * ex / (8.0 * _PI * r + _TINY)
        b = torch.sign(b3) * torch.abs(b3) ** (1.0 / 3.0)  # jnp.cbrt: b3 < 0 where x < 0
        U = -(1.0 - ex - 0.5 * x * ex) / (b + 1e-15)
        return 0.5 * r * U

    return exs(ra, saa, ta, la) + exs(rb, sbb, tb, lb)


# ----------------------------------------------------------------------------
# catalog + method parsing
# ----------------------------------------------------------------------------

_CATALOG = {
    "lda_x": Functional("lda_x", "lda", _ex_slater),
    "lda_c_vwn": Functional("lda_c_vwn", "lda", _ec_vwn5),
    "lda_c_pw": Functional("lda_c_pw", "lda", _ec_pw92),
    "gga_x_pbe": Functional("gga_x_pbe", "gga", _ex_pbe),
    "gga_c_pbe": Functional("gga_c_pbe", "gga", _ec_pbe),
    "gga_x_rpbe": Functional("gga_x_rpbe", "gga", _ex_rpbe),
    "gga_x_b88": Functional("gga_x_b88", "gga", _ex_b88),
    "gga_c_lyp": Functional("gga_c_lyp", "gga", _ec_lyp),
    "mgga_x_tpss": Functional("mgga_x_tpss", "mgga", _ex_tpss),
    "mgga_c_tpss": Functional("mgga_c_tpss", "mgga", _ec_tpss),
    "mgga_x_scan": Functional("mgga_x_scan", "mgga", _ex_scan),
    "mgga_c_scan": Functional("mgga_c_scan", "mgga", _ec_scan),
    "mgga_x_rscan": Functional("mgga_x_rscan", "mgga", _ex_rscan),
    "mgga_c_rscan": Functional("mgga_c_rscan", "mgga", _ec_rscan),
    "mgga_x_br89": Functional("mgga_x_br89", "mggal", _ex_br89),
    "lda_x_erf": Functional("lda_x_erf", "lda", _ex_slater_erf),
}

# alias -> (kfrac, [(weight, functional-name, params-dict), ...])
_ALIASES = {
    "lda": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_pw", {})]),
    "svwn": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_vwn", {})]),
    "svwn5": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_vwn", {})]),
    "pbe": (0.0, [(1.0, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    "blyp": (0.0, [(1.0, "gga_x_b88", {}), (1.0, "gga_c_lyp", {})]),
    "tpss": (0.0, [(1.0, "mgga_x_tpss", {}), (1.0, "mgga_c_tpss", {})]),
    "scan": (0.0, [(1.0, "mgga_x_scan", {}), (1.0, "mgga_c_scan", {})]),
    "rscan": (0.0, [(1.0, "mgga_x_rscan", {}), (1.0, "mgga_c_rscan", {})]),
    # PBE0 (Adamo-Barone): 25 % exact exchange
    "pbe0": (0.25, [(0.75, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    "pbeh": (0.25, [(0.75, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    # TPSSh: 10 % exact exchange (Staroverov et al. 2003)
    "tpssh": (0.10, [(0.9, "mgga_x_tpss", {}), (1.0, "mgga_c_tpss", {})]),
    # B3LYP with the VWN5 correlation ("B3LYP5"): the 0.72 weight multiplies
    # the whole B88 (LDA + gradient correction), so Slater's is 0.80 - 0.72
    "b3lyp5": (0.20, [(0.08, "lda_x", {}), (0.72, "gga_x_b88", {}),
                      (0.19, "lda_c_vwn", {}), (0.81, "gga_c_lyp", {})]),
    # parameter-override variants (Hammer et al. RPBE; Zhang-Yang revPBE;
    # Perdew et al. PBEsol)
    "rpbe": (0.0, [(1.0, "gga_x_rpbe", {}), (1.0, "gga_c_pbe", {})]),
    "revpbe": (0.0, [(1.0, "gga_x_pbe", {"kappa": 1.245}), (1.0, "gga_c_pbe", {})]),
    "pbesol": (0.0, [(1.0, "gga_x_pbe", {"mu": 10.0 / 81.0}),
                     (1.0, "gga_c_pbe", {"beta": 0.046})]),
}


def get_functional(name: str) -> Functional:
    key = name.lower()
    if key not in _CATALOG:
        raise ValueError(f"unknown functional '{name}'")
    return _CATALOG[key]


def with_params(f: Functional, **overrides) -> Functional:
    """Functional with named parameter overrides (the equivalent of the
    reference's libxc ext_params files, src/atomic/main.cpp:107-108). Keys
    are validated against the functional's keyword parameters."""
    if not overrides:
        return f
    valid = {
        k for k, p in inspect.signature(f.f).parameters.items()
        if p.kind == inspect.Parameter.KEYWORD_ONLY
    }
    bad = set(overrides) - valid
    if bad:
        raise ValueError(f"{f.name} has no parameters {sorted(bad)}; valid: {sorted(valid)}")
    params = dict(f.params)
    params.update(overrides)
    tag = ",".join(f"{k}={v:g}" for k, v in sorted(params.items()))
    return Functional(f"{f.name}[{tag}]", f.family, f.f, tuple(sorted(params.items())))


def scale_functional(w: float, f: Functional) -> Functional:
    if w == 1.0:
        return f
    return Functional(
        f"{w}*{f.name}", f.family,
        lambda *a, _f=f.f, _w=w, **kw: _w * _f(*a, **kw),
        f.params,
    )


def _parse_part(part: str) -> Functional:
    """'name' or 'name[k=v,k=v]' -> Functional with overrides."""
    if "[" in part:
        if not part.endswith("]"):
            raise ValueError(f"malformed functional spec '{part}'")
        name, argstr = part[:-1].split("[", 1)
        kv = {}
        for item in argstr.split(","):
            k, v = item.split("=")
            kv[k.strip()] = float(v)
        return with_params(get_functional(name), **kv)
    return get_functional(part)


class MethodSpec(NamedTuple):
    """Parsed method: semilocal functionals plus the exact-exchange mixing
    kfull * K + kshort * K_sr(omega) (helfem_tpu's MethodSpec). K_sr uses
    the short-range kernel named by `kernel`: 'erfc' for the erf/erfc
    split, 'yukawa' for exp(-omega r)/r screening."""

    funcs: tuple
    kfull: float
    kshort: float
    omega: float = 0.0
    kernel: str = "erfc"


# range-separated aliases: name -> (kfull, kshort, default omega, kernel,
# [(weight, func, params, give_omega)]); give_omega passes the (possibly
# overridden) omega into the functional's own parameter set
_RS_ALIASES = {
    # LC-type LDA: full long-range HF + short-range LDA exchange
    # (Savin's RSH scheme with the erf split)
    "lc-lda": (1.0, -1.0, 0.5, "erfc",
               [(1.0, "lda_x_erf", {}, True), (1.0, "lda_c_pw", {}, False)]),
    "ldaerf": (1.0, -1.0, 0.5, "erfc",
               [(1.0, "lda_x_erf", {}, True), (1.0, "lda_c_pw", {}, False)]),
    # Yukawa-kernel variant of the same split; the semilocal part keeps the
    # erf complement form (the closed-form SR-LDA hole), the HF part is
    # screened with the Yukawa kernel like the reference's CAMY functionals
    "lcy-lda": (1.0, -1.0, 0.5, "yukawa",
                [(1.0, "lda_x_erf", {}, True), (1.0, "lda_c_pw", {}, False)]),
    # short-range-only exact exchange + PBE correlation (HSE-like mixing
    # without the wPBE semilocal complement; useful for limit tests)
    "sr-pbe0": (0.0, 0.25, 0.11, "erfc",
                [(0.75, "gga_x_pbe", {}, False), (1.0, "gga_c_pbe", {}, False)]),
}


def _split_bracket(m: str):
    """'name[k=v,...]' -> (name, {k: v}); 'name' -> (name, {})."""
    if "[" not in m:
        return m, {}
    if not m.endswith("]"):
        raise ValueError(f"malformed method spec '{m}'")
    base, args = m[:-1].split("[", 1)
    kv = {}
    for item in args.split(","):
        k, v = item.split("=")
        kv[k.strip()] = float(v)
    return base, kv


@lru_cache(maxsize=None)
def parse_method_rs(method: str) -> MethodSpec:
    """'HF', a ported alias ('PBE', 'PBE0', 'LC-LDA[omega=0.4]', ...) or an
    'x_func,c_func' pair (each with optional bracketed parameter overrides),
    as helfem_tpu parses them. kshort and omega are zero for global
    hybrids."""
    m = method.strip().lower()
    if m in ("hf", ""):
        return MethodSpec((), 1.0, 0.0)
    # an RS alias with overrides is a single 'name[...]' token; anything
    # else (e.g. 'x[k=v],c' pairs) falls through to the generic parser
    base, kv = m, {}
    if "[" in m and m.index("[") > 0 and m[: m.index("[")] in _RS_ALIASES:
        base, kv = _split_bracket(m)
    if base in _RS_ALIASES:
        kfull, kshort, omega, kernel, parts = _RS_ALIASES[base]
        omega = kv.pop("omega", omega)
        kfull = kv.pop("kfull", kfull)
        kshort = kv.pop("kshort", kshort)
        if kv:
            raise ValueError(f"unknown method overrides {sorted(kv)} for '{base}'")
        funcs = tuple(
            scale_functional(
                w, with_params(_CATALOG[k], **({**pv, "omega": omega} if go else pv))
            )
            for w, k, pv, go in parts
        )
        return MethodSpec(funcs, kfull, kshort, omega, kernel)
    if m in _ALIASES:
        kfrac, parts = _ALIASES[m]
        return MethodSpec(
            tuple(scale_functional(w, with_params(_CATALOG[k], **pv)) for w, k, pv in parts),
            kfrac,
            0.0,
        )
    # reference-compatible 'x-c' pair syntax: split at the FIRST top-level
    # dash (parse_xc_func, ref src/general/dftfuncs.cpp:99-108); catalog
    # names use underscores, so a top-level dash is always the pair
    # separator (dash-named RS aliases were already resolved above)
    if "," not in m:
        depth = 0
        for i, ch in enumerate(m):
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            elif ch == "-" and depth == 0:
                m = m[:i] + "," + m[i + 1:]
                break
    # bracket-aware comma split: 'a[k=1,m=2],b' -> ['a[k=1,m=2]', 'b']
    parts, depth, cur = [], 0, ""
    for ch in m:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    parts.append(cur)
    parts = [p for p in parts if p and p != "none"]
    return MethodSpec(tuple(_parse_part(p) for p in parts), 0.0, 0.0)


def parse_method(method: str):
    """(funcs, kfrac) of a method without range separation. A
    range-separated method raises ValueError, as helfem_tpu's does, so that
    no caller drops its short-range exchange silently."""
    spec = parse_method_rs(method)
    if spec.omega != 0.0 or spec.kshort != 0.0:
        raise ValueError(
            f"'{method}' is range-separated; use parse_method_rs / the scf "
            "drivers, which wire kshort*K_sr(omega)"
        )
    return list(spec.funcs), spec.kfull


_NARGS = {"lda": 5, "gga": 5, "mgga": 7, "mggal": 9}


def xc_eval(funcs, ra, rb, saa, sab, sbb, thr: float = 1e-12, ta=None, tb=None, la=None,
            lb=None):
    """Energy density and potentials on grid tensors (xc.py:932-978):
    returns (e, vra, vrb, vsaa, vsab, vsbb[, vta, vtb][, vla, vlb]), the tau
    potentials when ta and tb are given, the density-laplacian potentials
    when la and lb are given (family 'mggal'; without ta, tb the tau slots
    are zeros and are dropped from the result, as helfem_tpu drops them).
    Points where rho < thr give exactly zero.

    The inputs are substituted before any functional sees them -- masked
    points by 1.0, each spin density floored at thr, the same-spin sigmas
    at 0 and tau at 1e-30 -- and differentiated as new leaves, as jax.vjp
    differentiates helfem_tpu's substituted arguments, so no branch that
    torch.where drops can feed a NaN into a potential."""
    with torch.profiler.record_function("xc_eval"):  # a profiler range, inert otherwise
        mask = (ra + rb) > thr
        one = torch.ones_like(ra)
        args = [
            _max(torch.where(mask, ra, one), thr),
            _max(torch.where(mask, rb, one), thr),
            _max(saa, 0.0),
            sab,
            _max(sbb, 0.0),
        ]
        with_tau, with_lapl = ta is not None, la is not None
        if with_tau:
            args += [_max(ta, _TINY), _max(tb, _TINY)]
        if with_lapl:
            if not with_tau:
                args += [torch.zeros_like(la), torch.zeros_like(la)]
            args += [la, lb]
        args = [a.detach().requires_grad_(True) for a in args]
        with torch.enable_grad():
            e = (sum(f.f(*args[:_NARGS[f.family]], **dict(f.params)) for f in funcs)
                 if funcs else args[0] * 0.0)
            grads = torch.autograd.grad(e, args, grad_outputs=torch.ones_like(e),
                                        allow_unused=True)
        z = torch.zeros_like(ra)
        grads = [z if g is None else g for g in grads]
        out = [torch.where(mask, x, z) for x in (e.detach(), *grads)]
        if with_lapl and not with_tau:
            out = out[:6] + out[8:]  # drop the dummy tau slots
        return tuple(out)
