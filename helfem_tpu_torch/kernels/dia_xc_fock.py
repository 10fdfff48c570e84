"""K5 dia_xc_fock: the XC Fock matrix from the weighted grid potentials of
the diatomic DFT grid, as a hand-written CUDA kernel (csrc/dia_xc_fock.cu)
and its plain PyTorch version.

Replaces the LDA/GGA part of helfem_tpu/models/diatomic_dft.py:
eval_fxc_dia.fock (diatomic_dft.py:156-165) and its scatter-add
(:197-200). The shell mask is applied by the caller.
"""

import torch

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    check_kernel_inputs, expect_shape, launches, on_cpu,
)

__all__ = ["dia_xc_fock", "dia_xc_fock_plain"]


def dia_xc_fock(wvr: torch.Tensor, wgu: torch.Tensor, wgv: torch.Tensor,
                gidx: torch.Tensor, Bg: torch.Tensor, dBg: torch.Tensor,
                TT: torch.Tensor, dTT: torch.Tensor, nrad: int) -> torch.Tensor:
    """F [nang * nrad, nang * nrad] from wvr = w vr, wgu = w gu invh and
    wgv = w gv invh sqeta [nelem, nq, nt].

    gidx [nelem, np] int32 (nrad = trash slot), Bg/dBg [nelem, nq, np],
    TT/dTT [nang, nang, nt]. CPU inputs run the plain version; CUDA inputs
    launch the kernel. The kernel does not check gidx's values: pass the
    gidx of a grid made by build_dia_grid or from_jax_grid."""
    name = "dia_xc_fock"
    args = (wvr, wgu, wgv, gidx, Bg, dBg, TT, dTT)
    if on_cpu(name, *args):
        return dia_xc_fock_plain(*args, nrad)
    check_kernel_inputs(
        name, {"wvr": wvr, "wgu": wgu, "wgv": wgv, "Bg": Bg, "dBg": dBg, "TT": TT,
               "dTT": dTT},
        {"gidx": gidx},
    )
    nang, _, nt = TT.shape
    nelem, nq, nprim = Bg.shape
    for arg, t in (("wvr", wvr), ("wgu", wgu), ("wgv", wgv)):
        expect_shape(name, arg, t, (nelem, nq, nt))
    expect_shape(name, "gidx", gidx, (nelem, nprim))
    expect_shape(name, "dBg", dBg, (nelem, nq, nprim))
    expect_shape(name, "dTT", dTT, (nang, nang, nt))
    if nprim * nprim > 1024:
        raise ValueError(f"{name}: nprim={nprim} exceeds the kernel's 32")
    if 3 * nq * 8 > 48 * 1024:
        raise ValueError(f"{name}: nq={nq} exceeds the kernel's 2048 radial points")
    dev = wvr.device
    opts = dict(dtype=torch.float64, device=dev)
    Fel = torch.empty((nang * nang, nelem, nprim * nprim), **opts)
    Fout = torch.empty((nang * nrad, nang * nrad), **opts)
    err = _build.lib().dia_xc_fock_launch(
        *(t.data_ptr() for t in (*args, Fel, Fout)),
        nang, nelem, nq, nprim, nrad, nt, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return Fout


def dia_xc_fock_plain(wvr, wgu, wgv, gidx, Bg, dBg, TT, dTT, nrad: int) -> torch.Tensor:
    """Plain PyTorch version of dia_xc_fock, faithful to
    diatomic_dft.py:156-165 and :197-200 with index_add_ over gidx."""
    nang = TT.shape[0]
    n1 = nrad + 1
    gi = gidx.long()
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)
    A1 = torch.einsum("eqt,abt->abeq", wvr, TT)
    Fel = torch.einsum("abeq,eqi,eqj->abeij", A1, Bg, Bg)
    B1 = torch.einsum("eqt,abt->abeq", wgu, TT)
    rad = torch.einsum("abeq,eqi,eqj->abeij", B1, dBg, Bg)
    Fel = Fel + rad + rad.transpose(0, 1).transpose(3, 4)
    C1 = torch.einsum("eqt,abt->abeq", wgv, dTT)
    Fel = Fel + torch.einsum("abeq,eqi,eqj->abeij", C1, Bg, Bg)
    F4 = torch.zeros((nang, nang, n1 * n1), dtype=Fel.dtype, device=Fel.device)
    F4.index_add_(2, lin, Fel.reshape(nang, nang, -1))
    F4 = F4.reshape(nang, nang, n1, n1)[:, :, :nrad, :nrad]
    return F4.permute(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)
