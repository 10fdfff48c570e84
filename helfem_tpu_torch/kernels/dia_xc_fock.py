"""K5 dia_xc_fock: the XC Fock matrices from the weighted grid potentials of
the XC grids (diatomic, atomic, SAD), for one or two spins, with the vtau
terms of meta-GGAs in tau mode and the vtau and vlapl terms of
laplacian-level meta-GGAs in laplacian mode, as a hand-written CUDA kernel
(csrc/dia_xc_fock.cu) and its plain PyTorch version.

Replaces helfem_tpu/models/diatomic_dft.py:eval_fxc_dia.fock
(diatomic_dft.py:155-200), its scatter-add and the shell mask that
eval_fxc_dia applies after it (:206-208), and models/atomic_dft.py:
eval_fxc.fock_spin (atomic_dft.py:160-189).
"""

import ctypes

import torch

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import launch_template, launches, on_cpu

__all__ = ["dia_xc_fock", "dia_xc_fock_plain"]

_GRID = ("pairs", "band", "owners", "TTp", "dTTp", "dTT2p", "TTm2p", "tfac", "ijs", "BBs", "SSs",
         "DDs")
_LAPL = ("LLTTp", "TTmmp", "lfac", "S2s")  # the grid tables the laplacian mode reads
_SMEM = 232448  # one block's shared memory on the H100


class _Launch(ctypes.Structure):
    """csrc/dia_xc_fock.cu:XckLaunch: the pointers, then the sizes."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("wvr", "wgu", "wgv", "wvt", "wvl", *_GRID, *_LAPL,
                                                 "mask", "XY", "Fel", "F", "stream")]
                + [(n, ctypes.c_int) for n in ("ns", "nang", "nelem", "nq", "nprim", "nrad", "nt",
                                               "npl", "device", "mode")])


_templates: dict = {}  # _common.launch_template's cache of _template


def _template(g, ns: int, mode: int, dev):
    """The launch arguments that depend only on the grid and the mode (0
    GGA, 1 tau, 2 laplacian), and the sizes."""
    nang = g.TT.shape[0]
    nelem, nq, nprim = g.Bg.shape
    nrad, nt, npl = g.owners.shape[0], g.sqeta.shape[0], g.pairs.shape[0]
    if 4 * (4 * nrad + 2 * npl) > _SMEM:  # the kernel's tables in shared memory
        raise ValueError(f"dia_xc_fock: {nrad} radial functions and {npl} live shell pairs "
                         f"need more than the card's {_SMEM} bytes of shared memory")
    t = _Launch(**{n: getattr(g, n).data_ptr() for n in _GRID},
                **{n: getattr(g, n).data_ptr() if mode == 2 else None for n in _LAPL},
                ns=ns, nang=nang, nelem=nelem, nq=nq, nprim=nprim, nrad=nrad, nt=nt, npl=npl,
                device=dev.index, mode=mode)
    nbf = nang * nrad
    sizes = (nbf, (ns, nelem, nq, nt), ns * nbf * nbf, ns * nelem * (2 + mode) * nq * npl,
             ns * nelem * npl * nprim * nprim)
    return t, sizes


def _mode(g, wvt, wvl) -> int:
    """0 (GGA), 1 (tau) or 2 (laplacian: wvl, which needs wvt and a grid
    built with its laplacian tables; raises ValueError otherwise)."""
    if wvl is None:
        return int(wvt is not None)
    if wvt is None:
        raise ValueError("dia_xc_fock: the laplacian terms (wvl) need the tau terms (wvt)")
    if g.lfac is None:
        raise ValueError("dia_xc_fock: the laplacian needs a grid built with lapl=True")
    return 2


def dia_xc_fock(wvr: torch.Tensor, wgu: torch.Tensor, wgv: torch.Tensor, g,
                mask: torch.Tensor | None = None, wvt: torch.Tensor | None = None,
                wvl: torch.Tensor | None = None) -> torch.Tensor:
    """F [ns, nbf, nbf] (bf = a * nrad + n) from wvr = w vr, wgu = w gu invh
    and wgv = w gv invh sqeta, in tau mode wvt = w vtau and in laplacian
    mode also wvl = w vlapl, each [ns, nelem, nq, nt] (ns 1 or 2), on the
    grid g (a DiaGridOps or AtomGridOps, whose tables were checked when it
    was built; for wvl built with its laplacian tables); F[s] * mask[:,
    None] * mask[None, :] when the 0/1 shell mask [nbf] is given.

    CPU inputs run the plain version; CUDA inputs launch the kernel, one
    launch for all spins and terms. Only the potentials and the mask are
    checked per call."""
    name = "dia_xc_fock"
    mode = _mode(g, wvt, wvl)
    tensors = (wvr, wgu, wgv, g.Bg) + tuple(x for x in (mask, wvt, wvl) if x is not None)
    if on_cpu(name, *tensors):
        return dia_xc_fock_plain(wvr, wgu, wgv, g, mask, wvt, wvl)
    ns = wvr.shape[0] if wvr.dim() == 4 else 0
    dev = wvr.device
    t, (nbf, shape, nF, nXY, nFel) = launch_template(_templates, (g,), (ns, mode),
                                                     lambda: _template(g, ns, mode, dev))
    for arg, x in (("wvr", wvr), ("wgu", wgu), ("wgv", wgv), ("wvt", wvt), ("wvl", wvl),
                   ("mask", mask)):
        if x is None:
            continue
        if x.dtype != torch.float64:
            raise TypeError(f"{name}: {arg} must be float64, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        want = (nbf,) if arg == "mask" else shape
        if ns not in (1, 2) or x.shape != want:
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, expected {want} "
                             "with ns 1 or 2")
    # F [ns, nbf, nbf], then the scratch X, Y[, Z[, V]] [ns, nelem, nXY, nq, npl] and
    # the element blocks [ns, nelem, npl, nprim^2]: one allocation
    buf = torch.empty(nF + nXY + nFel, dtype=torch.float64, device=dev)
    a = _Launch.from_buffer_copy(t)
    a.wvr, a.wgu, a.wgv = wvr.data_ptr(), wgu.data_ptr(), wgv.data_ptr()
    a.wvt = None if wvt is None else wvt.data_ptr()
    a.wvl = None if wvl is None else wvl.data_ptr()
    a.mask = None if mask is None else mask.data_ptr()
    a.F = buf.data_ptr()
    a.XY = a.F + 8 * nF
    a.Fel = a.XY + 8 * nXY
    # the current stream's handle without a Stream object (which costs 7.6 us
    # per call on the H100's host)
    a.stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _build.lib().dia_xc_fock_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return buf[:nF].view(ns, nbf, nbf)


def _fock_one(wvr, wgu, wgv, wvt, wvl, g, nrad):
    """One spin, diatomic_dft.py:156-181 and :197-200 with index_add_ over
    gidx; the angular weights of each product of element functions summed
    first, then one two-operand einsum per product (B B, dB B, dB dB: no
    contraction-path search per call); the tau factors are the grid's tfac
    (invh^2, invh^2, invhphi2 on the diatomic grid), and the laplacian
    terms are models/xc_grid.py's form with the grid's lfac: the tau terms
    with wvt + 4 wvl, the dB B terms with wgu + g2 wvl, and the d2B B and
    B B terms."""
    nang = g.TT.shape[0]
    n1 = nrad + 1
    gi = g.gidx.long()
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)

    def product(W, Bi, Bj):  # sum_q W[a,b,e,q] Bi[e,q,i] Bj[e,q,j]
        return torch.einsum("abeqi,eqj->abeij", W[..., None] * Bi[None, None], Bj)

    if wvl is not None:
        l1, l2, l3, l4 = g.lfac
        wvt = wvt + 4.0 * wvl
        wgu = wgu + wvl * l2
    # the B_i B_j weights, then the dB_i B_j ones (with their transpose)
    W = (torch.einsum("eqt,abt->abeq", wvr, g.TT)
         + torch.einsum("eqt,abt->abeq", wgv, g.dTT))
    if wvt is not None:
        f1, f2, f3 = g.tfac
        W = W + (torch.einsum("eqt,abt->abeq", 0.5 * wvt * f2, g.dTT2)
                 + torch.einsum("eqt,abt->abeq", 0.5 * wvt * f3, g.TTm2))
    if wvl is not None:
        W = W - (torch.einsum("eqt,abt->abeq", wvl * l3, g.LLTT)
                 + torch.einsum("eqt,abt->abeq", wvl * l4, g.TTmm))
    Fel = product(W, g.Bg, g.Bg)
    rad = product(torch.einsum("eqt,abt->abeq", wgu, g.TT), g.dBg, g.Bg)
    if wvl is not None:
        rad = rad + product(torch.einsum("eqt,abt->abeq", wvl * l1, g.TT), g.d2Bg, g.Bg)
    Fel = Fel + rad + rad.transpose(0, 1).transpose(3, 4)
    if wvt is not None:
        Fel = Fel + product(torch.einsum("eqt,abt->abeq", 0.5 * wvt * f1, g.TT), g.dBg,
                            g.dBg)
    F4 = torch.zeros((nang, nang, n1 * n1), dtype=Fel.dtype, device=Fel.device)
    F4.index_add_(2, lin, Fel.reshape(nang, nang, -1))
    F4 = F4.reshape(nang, nang, n1, n1)[:, :, :nrad, :nrad]
    return F4.permute(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)


def dia_xc_fock_plain(wvr, wgu, wgv, g, mask=None, wvt=None, wvl=None) -> torch.Tensor:
    """Plain PyTorch version of dia_xc_fock: each spin on its own, then the
    mask as eval_fxc_dia applies it (diatomic_dft.py:206-208). Reads only
    helfem_tpu's tables, tfac and the laplacian tables (d2Bg, LLTT, TTmm,
    lfac), not the live-pair tables."""
    _mode(g, wvt, wvl)
    nrad = g.owners.shape[0]
    F = torch.stack([_fock_one(wvr[s], wgu[s], wgv[s], None if wvt is None else wvt[s],
                               None if wvl is None else wvl[s], g, nrad)
                     for s in range(wvr.shape[0])])
    if mask is not None:
        F = F * mask[None, :, None] * mask[None, None, :]
    return F
