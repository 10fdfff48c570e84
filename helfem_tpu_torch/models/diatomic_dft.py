"""Diatomic DFT quadrature grid and XC Fock build (L5/L6), ported from
helfem_tpu/models/diatomic_dft.py.

Grid = (mu element x mu point) x (eta Gauss-Legendre point); phi is
eliminated analytically (axial symmetry). Volume weight Rh^3 (cosh^2 mu -
eta^2) sinh mu, metric h^2 = Rh^2 (cosh^2 mu - eta^2) for the gradient
components

    u f = (1/h) df/dmu,     v f = (sqrt(1-eta^2)/h) df/deta.

The grid tables are built on the host in numpy, as helfem_tpu builds them.
The density fields and the XC Fock assembly are the CUDA kernels
dia_xc_fields and dia_xc_fock (kernels/), whose plain PyTorch versions run
on CPU tensors, meta-GGAs in the kernels' tau mode (tau factors invh^2,
invh^2 and invhphi2, diatomic_dft.py:104-110, :174-181), the
laplacian-level BR89 in their laplacian mode (factors invh^2, invh^2 coth
mu, invh^2 and invh^2 / sinh^2 mu, diatomic_dft.py:112-123, :182-203; the
grid carries its laplacian tables only when built with lapl=True); the
pointwise functional (ops/xc.py:xc_eval) is plain PyTorch with autograd.
"""

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from helfem_tpu_torch.kernels import dia_xc_fields, dia_xc_fock
from helfem_tpu_torch.models.atomic_dft import check_lapl
from helfem_tpu_torch.models.xc_grid import build_grid
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.ops.spherical import legendre_Pbar, ylm_dtheta
from helfem_tpu_torch.ops.xc import xc_eval

__all__ = ["DiaGridOps", "build_dia_grid", "dia_grid_tables", "eval_fxc_dia",
           "eval_overlap_dia", "from_jax_grid", "lapl_factors"]


class DiaGridOps(NamedTuple):
    """The LDA, GGA and tau tables of helfem_tpu's DiaGridOps, on one
    device, and the shell-pair tables the XC kernels read (built once with
    the grid)."""

    Bg: torch.Tensor  # [nelem, nq, nprim]
    dBg: torch.Tensor
    w: torch.Tensor  # [nelem, nq, nt] full volume weight (incl. 2 pi Rh^3)
    invh: torch.Tensor  # [nelem, nq, nt] 1/h
    TT: torch.Tensor  # [nang, nang, nt] Theta_a Theta_b delta_{ma mb}
    dTT: torch.Tensor  # [nang, nang, nt] d/deta products
    dTT2: torch.Tensor  # [nang, nang, nt] (1-eta^2) Theta'_a Theta'_b (tau)
    TTm2: torch.Tensor  # [nang, nang, nt] m_a m_b Theta_a Theta_b / (1-eta^2) (tau)
    invhphi2: torch.Tensor  # [nelem, nq] 1/(Rh^2 sinh^2 mu) (tau)
    tfac: torch.Tensor  # [3, nelem, nq, nt] tau factors invh^2, invh^2, invhphi2
    sqeta: torch.Tensor  # [nt] sqrt(1 - eta^2)
    gidx: torch.Tensor  # [nelem, nprim] int32, trash slot = nrad
    pairs: torch.Tensor  # [npl, 2] int32: live shell pairs a <= b
    TTp: torch.Tensor  # [npl, nt] TT rows of the live pairs
    dTTp: torch.Tensor  # [npl, nt] dTT rows of the live pairs
    dTT2p: torch.Tensor  # [npl, nt] dTT2 rows of the live pairs
    TTm2p: torch.Tensor  # [npl, nt] TTm2 rows of the live pairs
    owners: torch.Tensor  # [nrad, 2] int32: element slots e * nprim + i covering n, else -1
    band: torch.Tensor  # [nrad, 2] int32: first and last radial index sharing an element with n
    ijs: torch.Tensor  # [nij] int32: (i << 16) | j of the element pairs i <= j, row by row
    BBs: torch.Tensor  # [nelem, nq, nijp] B_i B_j at i <= j, zero-padded to nijp = 8k
    SSs: torch.Tensor  # [nelem, nq, nijp] dB_i B_j + B_i dB_j
    DDs: torch.Tensor  # [nelem, nq, nijp] dB_i dB_j (tau)
    # the laplacian tables (models/xc_grid.py), None unless built with lapl=True
    d2Bg: torch.Tensor | None = None  # [nelem, nq, nprim] d^2 B / dmu^2
    LLTT: torch.Tensor | None = None  # [nang, nang, nt] (l_a(l_a+1) + l_b(l_b+1)) TT
    TTmm: torch.Tensor | None = None  # [nang, nang, nt] 2 m_a m_b TT
    lfac: torch.Tensor | None = None  # [4, nelem, nq, nt] invh^2 (1, coth, 1, 1/sinh^2)
    LLTTp: torch.Tensor | None = None  # [npl, nt] LLTT rows of the live pairs
    TTmmp: torch.Tensor | None = None  # [npl, nt]
    S2s: torch.Tensor | None = None  # [nelem, nq, nijp] d2B_i B_j + B_i d2B_j

    def to(self, device) -> "DiaGridOps":
        return DiaGridOps(*(None if t is None else t.to(device) for t in self))


def dia_grid_tables(basis, neta: int = 0, lapl: bool = False) -> dict[str, np.ndarray]:
    """The DiaGridOps fields as numpy arrays (diatomic_dft.py:46-92), with
    lapl also helfem_tpu's laplacian tables d2Bg, coth, inv_sh2, LLTT and
    TTmm."""
    lmax = int(basis.lval.max())
    if neta == 0:
        neta = 2 * lmax + 12
    eta, weta = gauss_legendre(neta)
    P = legendre_Pbar(lmax, eta)
    D = ylm_dtheta(lmax, eta)  # d/dtheta; d/deta = -D / sqrt(1-eta^2)
    sx = np.sqrt(1.0 - eta**2)
    nang = basis.nang
    Th = np.zeros((nang, neta))
    dTh = np.zeros((nang, neta))
    for a in range(nang):
        Th[a] = P[basis.lval[a], abs(basis.mval[a])]
        dTh[a] = -D[basis.lval[a], abs(basis.mval[a])] / sx
    same_m = (basis.mval[:, None] == basis.mval[None, :]).astype(np.float64)
    TT = same_m[:, :, None] * Th[:, None, :] * Th[None, :, :]
    dTT = same_m[:, :, None] * (dTh[:, None, :] * Th[None, :, :] + Th[:, None, :] * dTh[None, :, :])
    dTT2 = same_m[:, :, None] * (1.0 - eta**2)[None, None, :] * dTh[:, None, :] * dTh[None, :, :]
    mm = (basis.mval[:, None] * basis.mval[None, :]).astype(np.float64)
    TTm2 = (same_m[:, :, None] * mm[:, :, None] * Th[:, None, :] * Th[None, :, :]
            / (1.0 - eta**2)[None, None, :])
    Rh = basis.Rhalf
    ch = np.cosh(basis.mu)
    sh = np.sinh(basis.mu)
    vol = ch[:, :, None] ** 2 - eta[None, None, :] ** 2
    w = 2.0 * np.pi * Rh**3 * basis.wmu[:, :, None] * sh[:, :, None] * vol * weta[None, None, :]
    invh = 1.0 / (Rh * np.sqrt(vol))
    out = dict(Bg=basis.B, dBg=basis.dB, w=w, invh=invh, TT=TT, dTT=dTT, dTT2=dTT2,
               TTm2=TTm2, invhphi2=1.0 / (Rh**2 * sh**2), sqeta=sx, gidx=basis.fem.gidx)
    if lapl:
        ll = basis.lval * (basis.lval + 1.0)
        out.update(d2Bg=basis.d2B, coth=ch / sh, inv_sh2=1.0 / sh**2,
                   LLTT=(ll[:, None] + ll[None, :])[:, :, None] * TT,
                   TTmm=2.0 * mm[:, :, None] * same_m[:, :, None] * Th[:, None, :] * Th[None, :, :])
    return out


def tau_factors(invh: np.ndarray, invhphi2: np.ndarray) -> np.ndarray:
    """The diatomic grid's tau factors [3, nelem, nq, nt]: invh^2 for the
    TT Ddd and dTT2 D1 terms, invhphi2 for TTm2 D1 (diatomic_dft.py:104-110)."""
    invh2 = np.asarray(invh) ** 2
    return np.stack((invh2, invh2, np.broadcast_to(np.asarray(invhphi2)[:, :, None],
                                                   invh2.shape)))


def lapl_factors(invh: np.ndarray, coth: np.ndarray, inv_sh2: np.ndarray) -> np.ndarray:
    """The diatomic grid's laplacian factors [4, nelem, nq, nt]: invh^2 for
    the d2B B product and for LLTT, invh^2 coth mu for the dB B product,
    invh^2 / sinh^2 mu for TTmm (diatomic_dft.py:112-123)."""
    invh2 = np.asarray(invh) ** 2
    return np.stack((invh2, invh2 * np.asarray(coth)[:, :, None], invh2,
                     invh2 * np.asarray(inv_sh2)[:, :, None]))


def from_jax_grid(arrays: Mapping[str, np.ndarray], nrad: int, device,
                  lapl: bool = False) -> DiaGridOps:
    """The port's grid from helfem_tpu's DiaGridOps fields given as numpy
    arrays, with lapl also its laplacian tables (d2Bg, coth, inv_sh2, LLTT,
    TTmm); nrad is the basis's radial size, which gidx's checks need."""
    tables = {k: v for k, v in arrays.items()
              if k not in ("d2Bg", "coth", "inv_sh2", "LLTT", "TTmm")}
    tables["tfac"] = tau_factors(arrays["invh"], arrays["invhphi2"])
    if lapl:
        tables.update(d2Bg=arrays["d2Bg"], LLTT=arrays["LLTT"], TTmm=arrays["TTmm"],
                      lfac=lapl_factors(arrays["invh"], arrays["coth"], arrays["inv_sh2"]))
    return build_grid(DiaGridOps, tables, nrad, device)


def build_dia_grid(basis, device, neta: int = 0, lapl: bool = False) -> DiaGridOps:
    """The diatomic grid on `device`, with the laplacian tables when lapl (a
    laplacian-level functional needs them; no other method pays for them)."""
    return from_jax_grid(dia_grid_tables(basis, neta, lapl), basis.nrad, device, lapl)


def _fields_dia(g: DiaGridOps, P: torch.Tensor, need_tau: bool = False,
                need_lapl: bool = False):
    """(rho, drho_u, drho_v, tau, lapl) [nelem, nq, nt] of one density P
    [nbf, nbf] (diatomic_dft.py:95-124), tau None unless need_tau or
    need_lapl, lapl None unless need_lapl (a grid built with lapl=True),
    through the dia_xc_fields kernel."""
    mgga = need_tau or need_lapl
    fields = tuple(f[0] for f in dia_xc_fields(P.contiguous()[None], g, mgga, need_lapl))
    return fields + (None,) * (5 - len(fields))


def eval_fxc_dia(funcs, g: DiaGridOps, ops, Pa: torch.Tensor, Pb: torch.Tensor,
                 thr: float = 1e-12):
    """(Fxca, Fxcb, Exc, Nel) on the diatomic grid (diatomic_dft.py:127-209)
    for LDA, GGA, meta-GGA and laplacian-level functionals. Both spins go
    through one launch of each kernel, in tau mode for a meta-GGA and in
    laplacian mode for a laplacian-level one (which needs a grid built with
    lapl=True); when Pb is Pa the fields are formed once and reused (the
    same bits as forming them twice: the kernel is deterministic per
    spin)."""
    lapl = check_lapl(g, funcs)
    mgga = lapl or any(f.family == "mgga" for f in funcs)
    same = Pb is Pa
    fields = dia_xc_fields(Pa.contiguous()[None] if same else torch.stack((Pa, Pb)), g, mgga,
                           lapl)
    rho, du, dv = fields[:3]
    ra, ua, va = rho[0], du[0], dv[0]
    rb, ub, vb = (ra, ua, va) if same else (rho[1], du[1], dv[1])
    saa = ua * ua + va * va
    sab = ua * ub + va * vb
    sbb = ub * ub + vb * vb
    meta = tuple(f[s] for f in fields[3:] for s in (0, -1))  # ta, tb[, la, lb]
    out = xc_eval(funcs, ra, rb, saa, sab, sbb, thr, *meta)
    e, vra, vrb, vsaa, vsab, vsbb = out[:6]
    Exc = torch.sum(g.w * e)
    Nel = torch.sum(g.w * (ra + rb))
    # an LDA's sigma potentials are exact zeros, and so are gu and gv
    gu = torch.stack((2.0 * vsaa * ua + vsab * ub, 2.0 * vsbb * ub + vsab * ua))
    gv = torch.stack((2.0 * vsaa * va + vsab * vb, 2.0 * vsbb * vb + vsab * va))
    wvt = g.w * torch.stack(out[6:8]) if mgga else None
    wvl = g.w * torch.stack(out[8:10]) if lapl else None
    F = dia_xc_fock(g.w * torch.stack((vra, vrb)), g.w * gu * g.invh,
                    g.w * gv * g.invh * g.sqeta[None, None, :], g, ops.shellmask.reshape(-1),
                    wvt, wvl)
    return F[0], F[1], Exc, Nel


def eval_overlap_dia(g: DiaGridOps, nang: int, nrad: int) -> torch.Tensor:
    """Grid overlap for the accuracy self-check (diatomic_dft.py:212-219),
    through the dia_xc_fock kernel with vr = 1 and no gradient terms."""
    if g.TT.shape[0] != nang or g.owners.shape[0] != nrad:
        raise ValueError(f"grid has {g.TT.shape[0]} x {g.owners.shape[0]} functions, "
                         f"expected {nang} x {nrad}")
    w = g.w[None]
    zero = torch.zeros_like(w)
    return dia_xc_fock(w, zero, zero, g)[0]
