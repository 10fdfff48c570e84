"""K2 radial_coulomb: the radial core of the Coulomb build, as a hand-written
CUDA kernel (csrc/radial_coulomb.cu) and its plain PyTorch version.

Replaces the radial part of helfem_tpu/models/atomic.py:coulomb
(atomic.py:447-462): element-window gather, disjoint traces with their
prefix/suffix sums over elements, the in-element TEI contraction and the
assembly. The Gaunt contractions around it stay torch.einsum
(models/atomic.py:coulomb).
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    band_table, check_kernel_inputs, expect_shape, launch_template, launches, on_cpu,
    owner_table, stream_scratch,
)
from helfem_tpu_torch.kernels._radial import WARPS, band_plan, fixed_bytes, sm_count

__all__ = ["radial_coulomb", "radial_coulomb_plain"]


class _Launch(ctypes.Structure):
    """csrc/radial_coulomb.cu:RcLaunch: the pointers, then the sizes and the
    tile plan."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("Paux", "tei", "U", "V", "Lfac", "gidx",
                                                 "owners", "band", "Jin", "tr", "Jaux",
                                                 "stream")]
                + [(n, ctypes.c_int) for n in ("NL", "NM", "nelem", "nprim", "nrad", "R", "CG",
                                               "NU", "device")])


_templates: dict = {}  # _common.launch_template's cache of _template


def plan(NL: int, NM: int, nelem: int, nprim: int, nrad: int, nsm: int = 132):
    """The kernel's band tiles: rows (i,j) of each (L, e) slice plus the two
    trace rows, against the NM density helpers."""
    # besides the owner table and gidx: the column bands, each warp's prefix
    # and suffix sums
    fixed = fixed_bytes(nelem, nprim, nrad) + 8 * nrad + 8 * 2 * WARPS * nelem
    return band_plan("radial_coulomb", nprim * nprim + 2, nprim, NM, NL * nelem, fixed, nsm)


def _template(tei, disjL, disjm1L, Lfac, gidx, NM: int, nrad: int):
    """The launch arguments that depend only on the operators (checked
    here, once), the owner and band tables they need, and the sizes."""
    name = "radial_coulomb"
    check_kernel_inputs(name, {"tei": tei, "disjL": disjL, "disjm1L": disjm1L, "Lfac": Lfac},
                        {"gidx": gidx})
    NL = Lfac.shape[0]
    nelem, nprim = gidx.shape
    expect_shape(name, "tei", tei, (NL, nelem) + (nprim,) * 4)
    expect_shape(name, "disjL", disjL, (NL, nelem, nprim, nprim))
    expect_shape(name, "disjm1L", disjm1L, (NL, nelem, nprim, nprim))
    dev = tei.device
    gi = gidx.cpu().numpy()
    own = owner_table(gi, nrad)
    tables = torch.tensor(np.concatenate([own.ravel(), band_table(gi, own, nrad).ravel()]),
                          dtype=torch.int32, device=dev)
    p = plan(NL, NM, nelem, nprim, nrad, sm_count(dev))
    t = _Launch(tei=tei.data_ptr(), U=disjL.data_ptr(), V=disjm1L.data_ptr(),
                Lfac=Lfac.data_ptr(), gidx=gidx.data_ptr(), owners=tables.data_ptr(),
                band=tables.data_ptr() + 4 * own.size, NL=NL,
                NM=NM, nelem=nelem, nprim=nprim, nrad=nrad, R=p.R, CG=p.CG, NU=p.NU,
                device=dev.index)
    # the scratch Jin [NL, NM, nelem, np^2] and the traces [NL, NM, 2, nelem]
    nscratch = NL * NM * nelem * (nprim * nprim + 2)
    return t, (NL, NM, nrad, nrad), nscratch, {}, tables


def radial_coulomb(Paux: torch.Tensor, tei: torch.Tensor, disjL: torch.Tensor,
                   disjm1L: torch.Tensor, Lfac: torch.Tensor,
                   gidx: torch.Tensor) -> torch.Tensor:
    """Jaux[L, M] from the radial density helpers Paux [NL, NM, nrad, nrad].

    tei [NL, nelem, np, np, np, np], disjL/disjm1L [NL, nelem, np, np], Lfac
    [NL], gidx [nelem, np] int32 (nrad = trash slot); returns Jaux
    [NL, NM, nrad, nrad]. CPU inputs run the plain version; CUDA inputs
    launch the kernel, once. The operators are checked, and the launch
    arguments that depend on them built, once per operator set; per call
    only Paux is checked. Pass the gidx of operators made by
    AtomicBasis.build_operators or from_jax_operators, which check_gidx."""
    name = "radial_coulomb"
    if on_cpu(name, Paux, tei, disjL, disjm1L, Lfac, gidx):
        return radial_coulomb_plain(Paux, tei, disjL, disjm1L, Lfac, gidx)
    if Paux.dim() != 4:
        raise ValueError(f"{name}: Paux has shape {tuple(Paux.shape)}, expected "
                         "[NL, NM, nrad, nrad]")
    NM, nrad = Paux.shape[1], Paux.shape[2]
    t, shape, nscratch, scratch, _ = launch_template(
        _templates, (tei, disjL, disjm1L, Lfac, gidx), (NM, nrad),
        lambda: _template(tei, disjL, disjm1L, Lfac, gidx, NM, nrad))
    if Paux.dtype != torch.float64:
        raise TypeError(f"{name}: Paux must be float64, got {Paux.dtype}")
    if not Paux.is_contiguous():
        raise ValueError(f"{name}: Paux must be contiguous")
    if Paux.shape != shape:
        raise ValueError(f"{name}: Paux has shape {tuple(Paux.shape)}, expected {shape}")
    # the current stream's handle without a Stream object (which costs 7.6 us
    # per call on the H100's host)
    stream = torch._C._cuda_getCurrentRawStream(t.device)
    Jaux = torch.empty(shape, dtype=torch.float64, device=Paux.device)
    a = _Launch.from_buffer_copy(t)
    a.Paux, a.Jaux, a.stream = Paux.data_ptr(), Jaux.data_ptr(), stream
    a.Jin = stream_scratch(scratch, stream, nscratch, Paux.device)
    a.tr = a.Jin + 8 * (nscratch - 2 * shape[0] * shape[1] * t.nelem)
    err = _build.lib().radial_coulomb_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return Jaux


def radial_coulomb_plain(Paux: torch.Tensor, tei: torch.Tensor, disjL: torch.Tensor,
                         disjm1L: torch.Tensor, Lfac: torch.Tensor,
                         gidx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of radial_coulomb, faithful to
    atomic.py:447-462 with index_select/index_add_ over gidx."""
    NL, NM, nrad = Paux.shape[:3]
    n1 = nrad + 1
    gi = gidx.long()
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)  # [(e i j)]
    Pp = F.pad(Paux, (0, 1, 0, 1)).reshape(NL, NM, n1 * n1)
    Pg = Pp.index_select(2, lin).reshape(NL, NM, *disjL.shape[1:])  # [L,M,e,i,j]
    tsmall = torch.einsum("Leij,LMeij->LMe", disjL, Pg)
    tbig = torch.einsum("Leij,LMeij->LMe", disjm1L, Pg)
    pre = torch.cumsum(tsmall, dim=-1) - tsmall
    suf = torch.flip(torch.cumsum(torch.flip(tbig, (-1,)), dim=-1), (-1,)) - tbig
    Jel = (
        disjm1L[:, None] * pre[..., None, None]
        + disjL[:, None] * suf[..., None, None]
        + torch.einsum("Leijkl,LMekl->LMeij", tei, Pg)
    )
    Jel = Jel * Lfac[:, None, None, None, None]
    Jaux = torch.zeros((NL, NM, n1 * n1), dtype=Paux.dtype, device=Paux.device)
    Jaux.index_add_(2, lin, Jel.reshape(NL, NM, -1))
    return Jaux.reshape(NL, NM, n1, n1)[:, :, :nrad, :nrad]
