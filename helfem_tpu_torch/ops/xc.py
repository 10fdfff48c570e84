"""Exchange-correlation functionals (L6), ported from helfem_tpu/ops/xc.py.

Each functional is a pointwise energy density f(rho_a, rho_b, sigma_aa,
sigma_ab, sigma_bb) -> e (energy per unit volume) written in plain torch
ops; every potential (vrho, vsigma) comes from one reverse-mode
torch.autograd.grad pass in f64, where helfem_tpu takes jax.vjp, so the
potentials match the energy by construction.

Ported: Slater exchange, VWN5 and PW92 correlation (LDA); PBE exchange and
correlation (GGA), with the revPBE and PBEsol parameter variants. Methods:
HF, lda, svwn/svwn5, pbe, revpbe, pbesol, and 'x,c' (or 'x-c') pairs of the
catalog's functionals. Every other catalog entry, every hybrid, every
range-separated method and every meta-GGA raises NotImplementedError.
Formulas from the original publications (Vosko-Wilk-Nusair 1980;
Perdew-Wang 1992; Perdew-Burke-Ernzerhof 1996).

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


def _clip_zeta(zeta):
    # keep |zeta| strictly below 1: phi = (1 -+ zeta)^{2/3} has an infinite
    # rho-derivative at zeta = +-1 (reached exactly when one spin density
    # rounds away), which would poison the autodiff potentials with NaNs
    return torch.clamp(zeta, -1.0 + 1e-15, 1.0 - 1e-15)


class Functional(NamedTuple):
    name: str
    family: str  # 'lda' or 'gga'
    f: Callable  # (ra, rb, saa, sab, sbb, **params) -> energy per volume
    params: tuple = ()  # sorted ((key, value), ...) overrides, hashable


# ----------------------------------------------------------------------------
# LDA exchange (Slater/Dirac)
# ----------------------------------------------------------------------------


def _ex_slater(ra, rb, saa, sab, sbb):
    cx = -0.75 * (6.0 / _PI) ** (1.0 / 3.0)
    return cx * (ra ** (4.0 / 3.0) + rb ** (4.0 / 3.0))


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
# catalog + method parsing
# ----------------------------------------------------------------------------

_CATALOG = {
    "lda_x": Functional("lda_x", "lda", _ex_slater),
    "lda_c_vwn": Functional("lda_c_vwn", "lda", _ec_vwn5),
    "lda_c_pw": Functional("lda_c_pw", "lda", _ec_pw92),
    "gga_x_pbe": Functional("gga_x_pbe", "gga", _ex_pbe),
    "gga_c_pbe": Functional("gga_c_pbe", "gga", _ec_pbe),
}

# helfem_tpu catalog entries outside this port's slice
_UNPORTED_FUNCS = ("gga_x_rpbe", "gga_x_b88", "gga_c_lyp", "mgga_x_tpss", "mgga_c_tpss",
                   "mgga_x_scan", "mgga_c_scan", "mgga_x_rscan", "mgga_c_rscan",
                   "mgga_x_br89", "lda_x_erf")

# alias -> (kfrac, [(weight, functional-name, params-dict), ...])
_ALIASES = {
    "lda": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_pw", {})]),
    "svwn": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_vwn", {})]),
    "svwn5": (0.0, [(1.0, "lda_x", {}), (1.0, "lda_c_vwn", {})]),
    "pbe": (0.0, [(1.0, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    # parameter-override variants (Zhang-Yang revPBE; Perdew et al. PBEsol)
    "revpbe": (0.0, [(1.0, "gga_x_pbe", {"kappa": 1.245}), (1.0, "gga_c_pbe", {})]),
    "pbesol": (0.0, [(1.0, "gga_x_pbe", {"mu": 10.0 / 81.0}),
                     (1.0, "gga_c_pbe", {"beta": 0.046})]),
    # PBE0 (Adamo-Barone): 25 % exact exchange
    "pbe0": (0.25, [(0.75, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
    "pbeh": (0.25, [(0.75, "gga_x_pbe", {}), (1.0, "gga_c_pbe", {})]),
}

# helfem_tpu aliases outside this port's slice: meta-GGAs and their hybrids,
# other GGAs and their hybrids, and the range-separated methods
_UNPORTED_METHODS = ("blyp", "tpss", "scan", "rscan", "tpssh", "b3lyp5",
                     "rpbe", "lc-lda", "ldaerf", "lcy-lda", "sr-pbe0")


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to helfem_tpu_torch yet; "
                               "ported: HF, LDA, SVWN, PBE, revPBE, PBEsol, PBE0 (see ROADMAP.md)")


def get_functional(name: str) -> Functional:
    key = name.lower()
    if key in _UNPORTED_FUNCS:
        raise _unported(f"functional '{name}'")
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
    kfull * K + kshort * K_sr(omega) (same fields as helfem_tpu's; the port
    produces kfull 1 for HF, 0.25 for PBE0 and 0 for pure functionals, and
    never a short-range part)."""

    funcs: tuple
    kfull: float
    kshort: float
    omega: float = 0.0
    kernel: str = "erfc"


@lru_cache(maxsize=None)
def parse_method_rs(method: str) -> MethodSpec:
    """'HF', a ported alias ('PBE', 'SVWN', ...) or an 'x_func,c_func' pair
    (each with optional bracketed parameter overrides), as helfem_tpu parses
    them."""
    m = method.strip().lower()
    if m in ("hf", ""):
        return MethodSpec((), 1.0, 0.0)
    base = m.split("[", 1)[0]
    if base in _UNPORTED_METHODS:
        raise _unported(f"method '{method}'")
    if m in _ALIASES:
        kfrac, parts = _ALIASES[m]
        return MethodSpec(
            tuple(scale_functional(w, with_params(_CATALOG[k], **pv)) for w, k, pv in parts),
            kfrac,
            0.0,
        )
    # reference-compatible 'x-c' pair syntax: split at the FIRST top-level
    # dash (parse_xc_func, ref src/general/dftfuncs.cpp:99-108)
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
    """(funcs, kfrac) of a method without range separation."""
    spec = parse_method_rs(method)
    return list(spec.funcs), spec.kfull


def xc_eval(funcs, ra, rb, saa, sab, sbb, thr: float = 1e-12):
    """Energy density and potentials on grid tensors (xc.py:932-978 for
    LDA/GGA): returns (e, vra, vrb, vsaa, vsab, vsbb). Points where rho <
    thr give exactly zero.

    The inputs are substituted before any functional sees them -- masked
    points by 1.0, each spin density floored at thr and the same-spin sigmas
    at 0 -- and differentiated as new leaves, as jax.vjp differentiates
    helfem_tpu's substituted arguments, so no branch that torch.where drops
    can feed a NaN into a potential."""
    mask = (ra + rb) > thr
    one = torch.ones_like(ra)
    args = [
        torch.clamp(torch.where(mask, ra, one), min=thr),
        torch.clamp(torch.where(mask, rb, one), min=thr),
        torch.clamp(saa, min=0.0),
        sab,
        torch.clamp(sbb, min=0.0),
    ]
    args = [a.detach().requires_grad_(True) for a in args]
    with torch.enable_grad():
        e = sum(f.f(*args, **dict(f.params)) for f in funcs) if funcs else args[0] * 0.0
        grads = torch.autograd.grad(e, args, grad_outputs=torch.ones_like(e),
                                    allow_unused=True)
    z = torch.zeros_like(ra)
    grads = [z if g is None else g for g in grads]
    return tuple(torch.where(mask, x, z) for x in (e.detach(), *grads))
