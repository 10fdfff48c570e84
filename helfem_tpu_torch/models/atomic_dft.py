"""Atomic DFT quadrature grid and XC Fock build (L6), ported from
helfem_tpu/models/atomic_dft.py for LDA, GGA, meta-GGA and laplacian-level
meta-GGA functionals.

Grid = (element x radial point) x (Gauss-Legendre point in cos theta);
phi is eliminated analytically (the density is m-block-diagonal), and the
angular factors are products of normalized associated Legendre functions
Theta_a(theta) = Pbar_{l_a}^{|m_a|}(cos theta). Weight per point
w = wr r^2 2 pi wth.

The grid runs on the diatomic XC kernels unchanged: dia_xc_fields (K4)
computes rho = sum_ab TT D1, u = invh sum_ab TT Dmu and v = invh sqeta
sum_ab dTT D1, which with invh = sqeta = 1 are rho, drho/dr and r times
(1/r) drho/dtheta; dia_xc_fock (K5) contracts w vr, w gr and w gt / r with
the same tables, term for term helfem_tpu's fock_spin. Meta-GGAs run the
kernels' tau mode with the factors f1 = 1, f2 = f3 = 1/r^2
(atomic_dft.py:109-114, :170-176). The laplacian-level BR89 runs their
laplacian mode with the factors 1, 2/r, 1/r^2, 0 (models/xc_grid.py; the
grid carries its laplacian tables only when built with lapl=True). The
pointwise functional (ops/xc.py:xc_eval) is plain PyTorch with autograd.
"""

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from helfem_tpu_torch.kernels import dia_xc_fields, dia_xc_fock
from helfem_tpu_torch.models.xc_grid import build_grid
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.ops.spherical import legendre_Pbar, ylm_dtheta
from helfem_tpu_torch.ops.xc import xc_eval

__all__ = ["AtomGridOps", "atomic_grid_tables", "build_atomic_grid", "check_lapl", "eval_fxc",
           "eval_kinetic_grid", "eval_overlap_grid", "from_jax_atomic_grid", "lapl_factors",
           "needs_lapl"]


class AtomGridOps(NamedTuple):
    """The atomic grid in the layout of the XC kernels (the fields of
    diatomic_dft.DiaGridOps that the kernels read, so dia_xc_fields and
    dia_xc_fock take it as they are), plus r."""

    Bg: torch.Tensor  # [nelem, nq, nprim] radial b values
    dBg: torch.Tensor  # [nelem, nq, nprim] db/dr
    w: torch.Tensor  # [nelem, nq, nt] w2 wth
    invh: torch.Tensor  # [nelem, nq, nt] ones
    TT: torch.Tensor  # [nang, nang, nt] Theta_a Theta_b delta_{ma mb}
    dTT: torch.Tensor  # [nang, nang, nt] Theta'_a Theta_b + Theta_a Theta'_b
    dTT2: torch.Tensor  # [nang, nang, nt] Theta'_a Theta'_b
    TTm2: torch.Tensor  # [nang, nang, nt] m_a m_b Theta_a Theta_b / sin^2
    tfac: torch.Tensor  # [3, nelem, nq, nt] tau factors 1, 1/r^2, 1/r^2
    sqeta: torch.Tensor  # [nt] ones
    gidx: torch.Tensor  # [nelem, nprim] int32, trash slot = nrad
    pairs: torch.Tensor  # the live-pair and element tables (models/xc_grid.py)
    TTp: torch.Tensor
    dTTp: torch.Tensor
    dTT2p: torch.Tensor
    TTm2p: torch.Tensor
    owners: torch.Tensor
    band: torch.Tensor
    ijs: torch.Tensor
    BBs: torch.Tensor
    SSs: torch.Tensor
    DDs: torch.Tensor
    r: torch.Tensor  # [nelem, nq]
    # the laplacian tables (models/xc_grid.py), None unless built with lapl=True
    d2Bg: torch.Tensor | None = None  # [nelem, nq, nprim] d2b/dr2
    LLTT: torch.Tensor | None = None  # [nang, nang, nt] (l_a(l_a+1) + l_b(l_b+1)) TT
    TTmm: torch.Tensor | None = None  # [nang, nang, nt] zeros (no phi term here)
    lfac: torch.Tensor | None = None  # [4, nelem, nq, nt] 1, 2/r, 1/r^2, 0
    LLTTp: torch.Tensor | None = None  # [npl, nt] LLTT rows of the live pairs
    TTmmp: torch.Tensor | None = None  # [npl, nt]
    S2s: torch.Tensor | None = None  # [nelem, nq, nijp] d2B_i B_j + B_i d2B_j

    def to(self, device) -> "AtomGridOps":
        return AtomGridOps(*(None if t is None else t.to(device) for t in self))


def atomic_grid_tables(basis, ntheta: int = 0, lapl: bool = False) -> dict[str, np.ndarray]:
    """helfem_tpu's DFTGridOps fields of the LDA, GGA and tau branches as
    numpy arrays (atomic_dft.py:56-96): bg, dbg, r, w2, wth, TT, dTT, dTT2,
    TTm2, gidx; with lapl also d2bg and LTT (the laplacian's). ntheta = 0
    takes 2 lmax + 12 points in cos theta."""
    if ntheta == 0:
        ntheta = 2 * basis.lmax + 12
    cth, wth = gauss_legendre(ntheta)
    lmax = int(basis.lval.max())
    P = legendre_Pbar(lmax, cth)
    D = ylm_dtheta(lmax, cth)  # d/dtheta
    sin2 = 1.0 - cth**2
    nang = basis.nang
    Th = np.zeros((nang, ntheta))
    dTh = np.zeros((nang, ntheta))
    for a in range(nang):
        Th[a] = P[basis.lval[a], abs(basis.mval[a])]
        dTh[a] = D[basis.lval[a], abs(basis.mval[a])]
    same_m = (basis.mval[:, None] == basis.mval[None, :]).astype(np.float64)
    TT = same_m[:, :, None] * Th[:, None, :] * Th[None, :, :]
    dTT = same_m[:, :, None] * (dTh[:, None, :] * Th[None, :, :] + Th[:, None, :] * dTh[None, :, :])
    dTT2 = same_m[:, :, None] * dTh[:, None, :] * dTh[None, :, :]
    mm = (basis.mval[:, None] * basis.mval[None, :]).astype(np.float64)
    TTm2 = same_m[:, :, None] * mm[:, :, None] * Th[:, None, :] * Th[None, :, :] / sin2[None, None, :]
    rb = basis.rb
    out = dict(bg=rb.b, dbg=rb.db, r=rb.r, w2=rb.wr * rb.r**2 * 2.0 * np.pi, wth=wth, TT=TT,
               dTT=dTT, dTT2=dTT2, TTm2=TTm2, gidx=rb.fem.gidx)
    if lapl:
        ll = basis.lval * (basis.lval + 1.0)
        out.update(d2bg=rb.d2b,
                   LTT=2.0 * dTT2 + 2.0 * TTm2 - (ll[:, None] + ll[None, :])[:, :, None] * TT)
    return out


def tau_factors(r: np.ndarray, nt: int) -> np.ndarray:
    """The atomic grid's tau factors [3, nelem, nq, nt]: 1 for the TT Ddd
    term, 1/r^2 for dTT2 D1 and TTm2 D1 (atomic_dft.py:109-114)."""
    inv_r2 = np.broadcast_to((1.0 / np.asarray(r) ** 2)[:, :, None], (*np.shape(r), nt))
    return np.stack((np.ones_like(inv_r2), inv_r2, inv_r2))


def lapl_factors(r: np.ndarray, nt: int) -> np.ndarray:
    """The atomic grid's laplacian factors [4, nelem, nq, nt]: 1 for the
    d2b b product, 2/r for the db b product, 1/r^2 for LLTT and 0 for TTmm
    (models/xc_grid.py; atomic_dft.py:116-123)."""
    r = np.broadcast_to(np.asarray(r)[:, :, None], (*np.shape(r), nt))
    return np.stack((np.ones_like(r), 2.0 / r, 1.0 / r**2, np.zeros_like(r)))


def from_jax_atomic_grid(arrays: Mapping[str, np.ndarray], nrad: int, device,
                         lapl: bool = False) -> AtomGridOps:
    """The port's grid from helfem_tpu's DFTGridOps fields given as numpy
    arrays (bg, dbg, r, w2, wth, TT, dTT, dTT2, TTm2, gidx; with lapl also
    d2bg and LTT, from which LLTT = 2 dTT2 + 2 TTm2 - LTT); nrad is the
    basis's radial size, which gidx's checks need."""
    a = {k: np.asarray(v) for k, v in arrays.items()}
    w = a["w2"][:, :, None] * a["wth"][None, None, :]
    tables = dict(
        Bg=a["bg"], dBg=a["dbg"], w=w, invh=np.ones_like(w), TT=a["TT"], dTT=a["dTT"],
        dTT2=a["dTT2"], TTm2=a["TTm2"], tfac=tau_factors(a["r"], w.shape[2]),
        sqeta=np.ones_like(a["wth"]), gidx=a["gidx"], r=a["r"])
    if lapl:
        tables.update(d2Bg=a["d2bg"], LLTT=2.0 * a["dTT2"] + 2.0 * a["TTm2"] - a["LTT"],
                      TTmm=np.zeros_like(a["TT"]), lfac=lapl_factors(a["r"], w.shape[2]))
    return build_grid(AtomGridOps, tables, nrad, device)


def build_atomic_grid(basis, device, ntheta: int = 0, lapl: bool = False) -> AtomGridOps:
    """The atomic grid on `device`, with the laplacian tables when lapl (a
    laplacian-level functional needs them; no other method pays for them)."""
    return from_jax_atomic_grid(atomic_grid_tables(basis, ntheta, lapl), basis.nrad, device,
                                lapl)


def needs_lapl(funcs) -> bool:
    """Whether a functional list needs the laplacian (family 'mggal')."""
    return any(f.family == "mggal" for f in funcs)


def check_lapl(g, funcs) -> bool:
    """needs_lapl(funcs), after checking that the grid g carries the
    laplacian tables when they are needed (raises ValueError)."""
    lapl = needs_lapl(funcs)
    if lapl and g.lfac is None:
        raise ValueError("a laplacian-level functional (family mggal) needs a grid built with "
                         "lapl=True")
    return lapl


def eval_fxc(funcs, g: AtomGridOps, Pa: torch.Tensor, Pb: torch.Tensor, thr: float = 1e-12):
    """(Fxca, Fxcb, Exc, Nel) on the atomic grid (atomic_dft.py:134-182) for
    LDA, GGA, meta-GGA and laplacian-level functionals: one dia_xc_fields
    launch, the functional, and one dia_xc_fock launch, each for both spins,
    or for one spin when Pb is Pa (Fxcb is then Fxca, the same tensor); a
    meta-GGA runs both kernels in tau mode, a laplacian-level one (which
    needs a grid built with lapl=True) in laplacian mode. The theta
    gradient is divided by r after the dTT contraction, and its Fock weight
    formed as (w gt) / r, in helfem_tpu's order."""
    lapl = check_lapl(g, funcs)
    mgga = lapl or any(f.family == "mgga" for f in funcs)
    same = Pb is Pa
    fields = dia_xc_fields(Pa.contiguous()[None] if same else torch.stack((Pa, Pb)), g, mgga,
                           lapl)
    rho, du, dv = fields[:3]
    r = g.r[:, :, None]
    ra, ra_r, ra_t = rho[0], du[0], dv[0] / r
    rb, rb_r, rb_t = (ra, ra_r, ra_t) if same else (rho[1], du[1], dv[1] / r)
    saa = ra_r * ra_r + ra_t * ra_t
    sab = ra_r * rb_r + ra_t * rb_t
    sbb = rb_r * rb_r + rb_t * rb_t
    meta = tuple(f[s] for f in fields[3:] for s in (0, -1))  # ta, tb[, la, lb]
    out = xc_eval(funcs, ra, rb, saa, sab, sbb, thr, *meta)
    e, vra, vrb, vsaa, vsab, vsbb = out[:6]
    Exc = torch.sum(g.w * e)
    Nel = torch.sum(g.w * (ra + rb))
    # an LDA's sigma potentials are exact zeros, and so are gr and gt
    pots = [(vra, 2.0 * vsaa * ra_r + vsab * rb_r, 2.0 * vsaa * ra_t + vsab * rb_t)]
    if not same:
        pots.append((vrb, 2.0 * vsbb * rb_r + vsab * ra_r, 2.0 * vsbb * rb_t + vsab * ra_t))
    vr, gr, gt = (torch.stack(x) for x in zip(*pots))
    ns = len(pots)
    wvt = g.w * torch.stack(out[6:6 + ns]) if mgga else None
    wvl = g.w * torch.stack(out[8:8 + ns]) if lapl else None
    F = dia_xc_fock(g.w * vr, g.w * gr, g.w * gt / r, g, wvt=wvt, wvl=wvl)
    return F[0], F[-1], Exc, Nel


def _check_size(g: AtomGridOps, nrad: int) -> None:
    if g.owners.shape[0] != nrad:
        raise ValueError(f"grid has {g.owners.shape[0]} radial functions, expected {nrad}")


def eval_overlap_grid(g: AtomGridOps, nrad: int) -> torch.Tensor:
    """The overlap matrix through the XC grid, the reference's grid
    self-check (atomic_dft.py:185-192), through dia_xc_fock with vr = 1 and
    no gradient terms."""
    _check_size(g, nrad)
    w = g.w[None]
    zero = torch.zeros_like(w)
    return dia_xc_fock(w, zero, zero, g)[0]


def eval_kinetic_grid(g: AtomGridOps, nrad: int) -> torch.Tensor:
    """The kinetic matrix 1/2 int grad(chi_A).grad(chi_B) through the grid,
    the second half of the self-check (atomic_dft.py:195-206): dia_xc_fock's
    tau contraction with wvt = w and every other potential zero."""
    _check_size(g, nrad)
    w = g.w[None]
    zero = torch.zeros_like(w)
    return dia_xc_fock(zero, zero, zero, g, wvt=w)[0]
