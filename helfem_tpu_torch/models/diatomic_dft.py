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
on CPU tensors; the pointwise functional (ops/xc.py:xc_eval) is plain
PyTorch with autograd. LDA and GGA only: the meta-GGA (tau) and
laplacian branches are not ported yet and raise.
"""

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from helfem_tpu_torch.kernels import check_gidx, dia_xc_fields, dia_xc_fock
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.ops.spherical import legendre_Pbar, ylm_dtheta
from helfem_tpu_torch.ops.xc import xc_eval

__all__ = ["DiaGridOps", "build_dia_grid", "dia_grid_tables", "eval_fxc_dia",
           "eval_overlap_dia", "from_jax_grid"]


class DiaGridOps(NamedTuple):
    """The LDA/GGA tables of helfem_tpu's DiaGridOps, on one device."""

    Bg: torch.Tensor  # [nelem, nq, nprim]
    dBg: torch.Tensor
    w: torch.Tensor  # [nelem, nq, nt] full volume weight (incl. 2 pi Rh^3)
    invh: torch.Tensor  # [nelem, nq, nt] 1/h
    TT: torch.Tensor  # [nang, nang, nt] Theta_a Theta_b delta_{ma mb}
    dTT: torch.Tensor  # [nang, nang, nt] d/deta products
    sqeta: torch.Tensor  # [nt] sqrt(1 - eta^2)
    gidx: torch.Tensor  # [nelem, nprim] int32, trash slot = nrad

    def to(self, device) -> "DiaGridOps":
        return DiaGridOps(*(t.to(device) for t in self))


def dia_grid_tables(basis, neta: int = 0) -> dict[str, np.ndarray]:
    """The DiaGridOps fields as numpy arrays (diatomic_dft.py:46-92)."""
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
    Rh = basis.Rhalf
    ch = np.cosh(basis.mu)
    sh = np.sinh(basis.mu)
    vol = ch[:, :, None] ** 2 - eta[None, None, :] ** 2
    w = 2.0 * np.pi * Rh**3 * basis.wmu[:, :, None] * sh[:, :, None] * vol * weta[None, None, :]
    invh = 1.0 / (Rh * np.sqrt(vol))
    return dict(Bg=basis.B, dBg=basis.dB, w=w, invh=invh, TT=TT, dTT=dTT, sqeta=sx,
                gidx=basis.fem.gidx)


def _grid(arrays: Mapping[str, np.ndarray], nrad: int, device) -> DiaGridOps:
    check_gidx(arrays["gidx"], nrad)
    return DiaGridOps(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=torch.int32 if name == "gidx" else torch.float64,
                           device=device)
        for name in DiaGridOps._fields
    })


def from_jax_grid(arrays: Mapping[str, np.ndarray], nrad: int, device) -> DiaGridOps:
    """The port's grid from helfem_tpu's DiaGridOps fields given as numpy
    arrays (the meta-GGA tables are not carried); nrad is the basis's radial
    size, which gidx's checks need."""
    return _grid(arrays, nrad, device)


def build_dia_grid(basis, device, neta: int = 0) -> DiaGridOps:
    return _grid(dia_grid_tables(basis, neta), basis.nrad, device)


def _fields_dia(g: DiaGridOps, P: torch.Tensor, need_tau: bool = False,
                need_lapl: bool = False):
    """(rho, drho_u, drho_v) [nelem, nq, nt] of the density P [nbf, nbf]
    (diatomic_dft.py:95-103), through the dia_xc_fields kernel."""
    if need_tau or need_lapl:
        raise NotImplementedError("meta-GGA (tau) and laplacian fields on the diatomic "
                                  "grid are not ported to helfem_tpu_torch yet")
    return dia_xc_fields(P.contiguous(), g.gidx, g.Bg, g.dBg, g.TT, g.dTT, g.invh, g.sqeta)


def eval_fxc_dia(funcs, g: DiaGridOps, ops, Pa: torch.Tensor, Pb: torch.Tensor,
                 thr: float = 1e-12):
    """(Fxca, Fxcb, Exc, Nel) on the diatomic grid (diatomic_dft.py:127-209)
    for LDA and GGA functionals."""
    if any(f.family not in ("lda", "gga") for f in funcs):
        raise NotImplementedError("meta-GGA functionals on the diatomic grid are not "
                                  "ported to helfem_tpu_torch yet")
    nrad = ops.shellmask.shape[-1]
    ra, ua, va = _fields_dia(g, Pa)
    rb, ub, vb = _fields_dia(g, Pb)
    saa = ua * ua + va * va
    sab = ua * ub + va * vb
    sbb = ub * ub + vb * vb
    e, vra, vrb, vsaa, vsab, vsbb = xc_eval(funcs, ra, rb, saa, sab, sbb, thr)
    Exc = torch.sum(g.w * e)
    Nel = torch.sum(g.w * (ra + rb))

    def fock(vr, gu, gv):
        # an LDA's sigma potentials are exact zeros, and so are gu and gv
        return dia_xc_fock(g.w * vr, g.w * gu * g.invh,
                           g.w * gv * g.invh * g.sqeta[None, None, :],
                           g.gidx, g.Bg, g.dBg, g.TT, g.dTT, nrad)

    gua = 2.0 * vsaa * ua + vsab * ub
    gva = 2.0 * vsaa * va + vsab * vb
    gub = 2.0 * vsbb * ub + vsab * ua
    gvb = 2.0 * vsbb * vb + vsab * va
    m2 = ops.shellmask.reshape(-1)
    Fa = fock(vra, gua, gva) * m2[:, None] * m2[None, :]
    Fb = fock(vrb, gub, gvb) * m2[:, None] * m2[None, :]
    return Fa, Fb, Exc, Nel


def eval_overlap_dia(g: DiaGridOps, nang: int, nrad: int) -> torch.Tensor:
    """Grid overlap for the accuracy self-check (diatomic_dft.py:212-219),
    through the dia_xc_fock kernel with vr = 1 and no gradient terms."""
    if g.TT.shape[0] != nang:
        raise ValueError(f"grid has {g.TT.shape[0]} angular shells, expected {nang}")
    zero = torch.zeros_like(g.w)
    return dia_xc_fock(g.w, zero, zero, g.gidx, g.Bg, g.dBg, g.TT, g.dTT, nrad)
