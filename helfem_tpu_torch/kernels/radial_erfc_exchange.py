"""K10 radial_erfc_exchange: the short-range (erfc) exchange contraction of
every (L, density channel) pair on the dense element-pair tables, as a
hand-written CUDA kernel (csrc/radial_erfc_exchange.cu) and its plain
PyTorch version.

Replaces helfem_tpu/models/atomic.py:erfc_exchange_bd's contraction
("efijkl,aefil->aefjk" over every element pair) and its one-hot assembly.
The plain version follows those einsums, with index_select/index_add_ over
gidx in place of the one-hot assembler matmuls.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    check_kernel_inputs, expect_shape, launch_template, launches, on_cpu, owner_table,
    stream_scratch,
)
from helfem_tpu_torch.kernels._radial import band_plan, fixed_bytes, sm_count

__all__ = ["radial_erfc_exchange", "radial_erfc_exchange_plain"]


class _Launch(ctypes.Structure):
    """csrc/radial_erfc_exchange.cu:ReLaunch: the pointers, then the sizes
    and the band plan."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("tei", "Pd", "gidx", "owners", "bounds",
                                                 "Kpair", "KK", "stream")]
                + [(n, ctypes.c_int) for n in ("NL", "nelem", "nprim", "nang", "nrad", "nb", "R",
                                               "CG", "NU", "device")])


_templates: dict = {}  # _common.launch_template's cache of _template


def plan(NL: int, nang: int, nelem: int, nprim: int, nrad: int, nsm: int = 132):
    """The kernel's band tiles: rows (j,k) of each of the NL nelem^2 (g, e,
    f) slices against the nang density channels."""
    # besides the owner table and gidx: the slot table, the shared functions
    fixed = fixed_bytes(nelem, nprim, nrad) + 4 * (nelem * nprim + nrad)
    return band_plan("radial_erfc_exchange", nprim * nprim, nprim, nang, NL * nelem * nelem,
                     fixed, nsm)


def _template(tei, gidx, nang: int, nrad: int):
    """The launch arguments that depend only on the tables (checked here,
    once), the owner table and the functions two element slots share, and
    the sizes."""
    name = "radial_erfc_exchange"
    check_kernel_inputs(name, {"tei": tei}, {"gidx": gidx})
    NL, nelem = tei.shape[:2]
    nprim = gidx.shape[1]
    expect_shape(name, "tei", tei, (NL, nelem, nelem) + (nprim,) * 4)
    expect_shape(name, "gidx", gidx, (nelem, nprim))
    dev = tei.device
    own = owner_table(gidx.cpu().numpy(), nrad)
    tables = torch.tensor(np.concatenate([own.ravel(), np.nonzero(own[:, 1] >= 0)[0]]),
                          dtype=torch.int32, device=dev)  # owners, then the shared functions
    band = plan(NL, nang, nelem, nprim, nrad, sm_count(dev))
    t = _Launch(tei=tei.data_ptr(), gidx=gidx.data_ptr(), owners=tables.data_ptr(),
                bounds=tables.data_ptr() + 4 * own.size, NL=NL, nelem=nelem, nprim=nprim,
                nang=nang, nrad=nrad, nb=len(tables) - own.size, R=band.R, CG=band.CG,
                NU=band.NU, device=dev.index)
    # the scratch Kpair [NL, nang, nelem, np, nelem, np] (only its boundary
    # rows and columns are used)
    return t, (NL, nang, nrad, nrad), NL * nang * (nelem * nprim) ** 2, {}, tables


def radial_erfc_exchange(tei: torch.Tensor, gidx: torch.Tensor, Pd: torch.Tensor) -> torch.Tensor:
    """KK[g, a] = the erfc exchange contraction of multipole channel g
    applied to Pd[a].

    tei [NL, nelem, nelem, np, np, np, np] (ErfcOperators.tei), gidx
    [nelem, np] int32 (nrad = trash slot), Pd [nang, nrad, nrad] (the
    channels of one or more spins, stacked); returns KK [NL, nang, nrad,
    nrad] (trash dropped). CPU inputs run the plain version; CUDA inputs
    launch the kernel, once. The tables are checked, and the launch
    arguments that depend on them built, once per table set; per call only
    Pd is checked. Pass the gidx of operators made by
    AtomicBasis.build_operators or from_jax_operators, which check_gidx."""
    name = "radial_erfc_exchange"
    if on_cpu(name, tei, gidx, Pd):
        return radial_erfc_exchange_plain(tei, gidx, Pd)
    if Pd.dim() != 3:
        raise ValueError(f"{name}: Pd has shape {tuple(Pd.shape)}, expected [nang, nrad, nrad]")
    nang, nrad = Pd.shape[:2]
    t, shape, nscratch, scratch, _ = launch_template(
        _templates, (tei, gidx), (nang, nrad), lambda: _template(tei, gidx, nang, nrad))
    if Pd.dtype != torch.float64:
        raise TypeError(f"{name}: Pd must be float64, got {Pd.dtype}")
    if not Pd.is_contiguous():
        raise ValueError(f"{name}: Pd must be contiguous")
    if Pd.shape[2] != nrad:
        raise ValueError(f"{name}: Pd has shape {tuple(Pd.shape)}, expected "
                         f"{(nang, nrad, nrad)}")
    stream = torch._C._cuda_getCurrentRawStream(t.device)
    KK = torch.empty(shape, dtype=torch.float64, device=Pd.device)
    a = _Launch.from_buffer_copy(t)
    a.Pd, a.KK, a.stream = Pd.data_ptr(), KK.data_ptr(), stream
    a.Kpair = stream_scratch(scratch, stream, nscratch, Pd.device)
    err = _build.lib().radial_erfc_exchange_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return KK


def radial_erfc_exchange_plain(tei: torch.Tensor, gidx: torch.Tensor,
                               Pd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of radial_erfc_exchange, faithful to
    atomic.py:729-749: the windows W[a,e,f] of every element pair, the
    contraction with the dense tables, the assembly over gidx."""
    NL, nelem, _, nprim = tei.shape[:4]
    nang, nrad = Pd.shape[:2]
    n1 = nrad + 1
    flat = gidx.long().reshape(-1)
    lin = (flat[:, None] * n1 + flat[None, :]).reshape(-1)  # [(e i), (f l)]
    Rp = F.pad(Pd, (0, 1, 0, 1)).reshape(nang, n1 * n1)  # trash row/col zero
    Rw = Rp.index_select(1, lin).reshape(nang, nelem, nprim, nelem, nprim).transpose(2, 3)
    Kp = torch.einsum("gefijkl,aefil->gaefjk", tei, Rw)  # [g, a, e, f, j, k]
    out = torch.zeros((NL, nang, n1 * n1), dtype=Pd.dtype, device=Pd.device)
    out.index_add_(2, lin.reshape(nelem, nprim, nelem, nprim).transpose(1, 2).reshape(-1),
                   Kp.reshape(NL, nang, -1))
    return out.reshape(NL, nang, n1, n1)[:, :, :nrad, :nrad]
