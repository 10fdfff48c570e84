"""K4 dia_xc_fields: the density and its gradient components on the
diatomic DFT grid, as a hand-written CUDA kernel (csrc/dia_xc_fields.cu) and
its plain PyTorch version.

Replaces the LDA/GGA part of helfem_tpu/models/diatomic_dft.py:_fields_dia
(diatomic_dft.py:97-103).
"""

import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    check_kernel_inputs, expect_shape, launches, on_cpu,
)

__all__ = ["dia_xc_fields", "dia_xc_fields_plain"]


def dia_xc_fields(P: torch.Tensor, gidx: torch.Tensor, Bg: torch.Tensor,
                  dBg: torch.Tensor, TT: torch.Tensor, dTT: torch.Tensor,
                  invh: torch.Tensor, sqeta: torch.Tensor):
    """(rho, drho_u, drho_v) [nelem, nq, nt] of the density P [nbf, nbf]
    (bf = a * nrad + n).

    gidx [nelem, np] int32 (nrad = trash slot), Bg/dBg [nelem, nq, np],
    TT/dTT [nang, nang, nt], invh [nelem, nq, nt], sqeta [nt]. CPU inputs
    run the plain version; CUDA inputs launch the kernel. The kernel does
    not check gidx's values: pass the gidx of a grid made by build_dia_grid
    or from_jax_grid."""
    name = "dia_xc_fields"
    args = (P, gidx, Bg, dBg, TT, dTT, invh, sqeta)
    if on_cpu(name, *args):
        return dia_xc_fields_plain(*args)
    check_kernel_inputs(
        name, {"P": P, "Bg": Bg, "dBg": dBg, "TT": TT, "dTT": dTT, "invh": invh,
               "sqeta": sqeta},
        {"gidx": gidx},
    )
    nang, _, nt = TT.shape
    nelem, nq, nprim = Bg.shape
    nbf = P.shape[0]
    if nbf % nang:
        raise ValueError(f"{name}: P has size {nbf}, not a multiple of nang={nang}")
    nrad = nbf // nang
    expect_shape(name, "P", P, (nbf, nbf))
    expect_shape(name, "gidx", gidx, (nelem, nprim))
    expect_shape(name, "dBg", dBg, (nelem, nq, nprim))
    expect_shape(name, "dTT", dTT, (nang, nang, nt))
    expect_shape(name, "invh", invh, (nelem, nq, nt))
    expect_shape(name, "sqeta", sqeta, (nt,))
    if nprim * nprim > 1024:
        raise ValueError(f"{name}: nprim={nprim} exceeds the kernel's 32")
    dev = P.device
    opts = dict(dtype=torch.float64, device=dev)
    D1 = torch.empty((nang * nang, nelem, nq), **opts)
    Dmu = torch.empty((nang * nang, nelem, nq), **opts)
    rho, du, dv = (torch.empty((nelem, nq, nt), **opts) for _ in range(3))
    err = _build.lib().dia_xc_fields_launch(
        *(t.data_ptr() for t in (*args, D1, Dmu, rho, du, dv)),
        nang, nelem, nq, nprim, nrad, nt, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return rho, du, dv


def dia_xc_fields_plain(P, gidx, Bg, dBg, TT, dTT, invh, sqeta):
    """Plain PyTorch version of dia_xc_fields, faithful to
    diatomic_dft.py:97-103 on the padded 4-index density, with
    index_select over gidx."""
    nang = TT.shape[0]
    nrad = P.shape[0] // nang
    n1 = nrad + 1
    nelem, nprim = gidx.shape
    gi = gidx.long()
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)
    P4p = F.pad(P.reshape(nang, nrad, nang, nrad).permute(0, 2, 1, 3), (0, 1, 0, 1))
    Pg = P4p.reshape(nang, nang, n1 * n1).index_select(2, lin)
    Pg = Pg.reshape(nang, nang, nelem, nprim, nprim)
    D1 = torch.einsum("abeij,eqi,eqj->abeq", Pg, Bg, Bg)
    Dmu = 2.0 * torch.einsum("abeij,eqi,eqj->abeq", Pg, dBg, Bg)
    rho = torch.einsum("abeq,abt->eqt", D1, TT)
    drho_u = torch.einsum("abeq,abt->eqt", Dmu, TT) * invh
    drho_v = torch.einsum("abeq,abt->eqt", D1, dTT) * (sqeta[None, None, :] * invh)
    return rho, drho_u, drho_v
