"""K1 radial_exchange: the radial exchange contraction of every (L, angular
channel) pair, as a hand-written CUDA kernel (csrc/radial_exchange.cu) and
its plain PyTorch version.

Replaces helfem_tpu/models/atomic.py:exchange_kernel_L as exchange_general_bd
vmaps it over (L, channel), and exchange_kernel_L_pairwise on the Yukawa
tables of the range-separated exchange. The kernel uses the pairwise
element-window form for both. There are two plain versions, with
index_select/index_add_ over gidx in place of the one-hot assembler matmuls:
radial_exchange_plain follows the JAX function's prefix-sum form (what
helfem_tpu computes on the Coulomb tables), radial_exchange_pairwise_plain
its pairwise form (atomic.py:468-496), the only one that keeps the Yukawa
tables' element scales paired: their i_L and k_L span e^(+-lam rmax), and
the prefix sums lose about 1e-5 of the operator there.
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
from helfem_tpu_torch.kernels._radial import (
    band_plan, cross_doubles, cross_plan, fixed_bytes, sm_count,
)

__all__ = ["radial_exchange", "radial_exchange_pairwise_plain", "radial_exchange_plain"]


class _Launch(ctypes.Structure):
    """csrc/radial_exchange.cu:RxLaunch: the pointers, then the sizes and the
    tile plan."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("tei", "U", "V", "Pd", "gidx", "owners",
                                                 "bounds", "Kpair", "KK", "stream")]
                + [(n, ctypes.c_int) for n in ("NL", "nelem", "nprim", "nang", "nrad", "nb", "R",
                                               "CG", "NU", "AG", "GG", "device")])


_templates: dict = {}  # _common.launch_template's cache of _template


def plan(NL: int, nang: int, nelem: int, nprim: int, nrad: int, nsm: int = 132):
    """The kernel's band tiles (rows (j,k) of each (g, e) slice against the
    nang channels) and cross tiles (channels and g per element pair)."""
    # besides the owner table and gidx: the slot table, the shared functions
    fixed = fixed_bytes(nelem, nprim, nrad) + 4 * (nelem * nprim + nrad)
    cross = cross_plan(nprim, nang, NL, nelem, fixed)
    band = band_plan("radial_exchange", nprim * nprim, nprim, nang, NL * nelem, fixed, nsm,
                     cross.tasks, 8 * cross_doubles(cross.AG, cross.GG, nprim))
    return band, cross


def _template(tei, U, V, gidx, nang: int, nrad: int):
    """The launch arguments that depend only on the operators (checked
    here, once), the owner table and the list of the radial functions two
    element slots share (the boundary rows and columns of the assembly),
    and the sizes."""
    name = "radial_exchange"
    check_kernel_inputs(name, {"tei": tei, "U": U, "V": V}, {"gidx": gidx})
    NL, nelem, nprim = U.shape[:3]
    expect_shape(name, "tei", tei, (NL, nelem) + (nprim,) * 4)
    expect_shape(name, "U", U, (NL, nelem, nprim, nprim))
    expect_shape(name, "V", V, (NL, nelem, nprim, nprim))
    expect_shape(name, "gidx", gidx, (nelem, nprim))
    dev = tei.device
    own = owner_table(gidx.cpu().numpy(), nrad)
    tables = torch.tensor(np.concatenate([own.ravel(), np.nonzero(own[:, 1] >= 0)[0]]),
                          dtype=torch.int32, device=dev)  # owners, then the shared functions
    band, cross = plan(NL, nang, nelem, nprim, nrad, sm_count(dev))
    t = _Launch(tei=tei.data_ptr(), U=U.data_ptr(), V=V.data_ptr(), gidx=gidx.data_ptr(),
                owners=tables.data_ptr(), bounds=tables.data_ptr() + 4 * own.size, NL=NL,
                nelem=nelem, nprim=nprim, nang=nang, nrad=nrad, nb=len(tables) - own.size,
                R=band.R, CG=band.CG, NU=band.NU, AG=cross.AG, GG=cross.GG, device=dev.index)
    # the scratch Kpair [NL, nang, nelem, np, nelem, np] (only its boundary
    # rows and columns are used)
    return t, (NL, nang, nrad, nrad), NL * nang * (nelem * nprim) ** 2, {}, tables


def radial_exchange(tei: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                    gidx: torch.Tensor, Pd: torch.Tensor, pairwise: bool = False) -> torch.Tensor:
    """KK[g, a] = exchange kernel of channel g applied to Pd[a].

    tei [NL, nelem, np, np, np, np], U = disjL and V = disjm1L (or the
    Yukawa tables iL and kL) [NL, nelem, np, np], gidx [nelem, np] int32
    (nrad = trash slot), Pd [nang, nrad, nrad]; returns KK [NL, nang, nrad,
    nrad] (trash dropped). CPU inputs run a plain version, the pairwise one
    when pairwise (the Yukawa tables), else the prefix-sum one; CUDA inputs
    launch the kernel, once, which computes the pairwise form either way.
    The operators are checked, and the launch arguments that depend on them
    built, once per operator set; per call only Pd is checked. Pass the
    gidx of operators made by AtomicBasis.build_operators or
    from_jax_operators, which check_gidx."""
    name = "radial_exchange"
    if on_cpu(name, tei, U, V, gidx, Pd):
        plain = radial_exchange_pairwise_plain if pairwise else radial_exchange_plain
        return plain(tei, U, V, gidx, Pd)
    if Pd.dim() != 3:
        raise ValueError(f"{name}: Pd has shape {tuple(Pd.shape)}, expected [nang, nrad, nrad]")
    nang, nrad = Pd.shape[:2]
    t, shape, nscratch, scratch, _ = launch_template(
        _templates, (tei, U, V, gidx), (nang, nrad),
        lambda: _template(tei, U, V, gidx, nang, nrad))
    if Pd.dtype != torch.float64:
        raise TypeError(f"{name}: Pd must be float64, got {Pd.dtype}")
    if not Pd.is_contiguous():
        raise ValueError(f"{name}: Pd must be contiguous")
    if Pd.shape[2] != nrad:
        raise ValueError(f"{name}: Pd has shape {tuple(Pd.shape)}, expected "
                         f"{(nang, nrad, nrad)}")
    # the current stream's handle without a Stream object (which costs 7.6 us
    # per call on the H100's host)
    stream = torch._C._cuda_getCurrentRawStream(t.device)
    KK = torch.empty(shape, dtype=torch.float64, device=Pd.device)
    a = _Launch.from_buffer_copy(t)
    a.Pd, a.KK, a.stream = Pd.data_ptr(), KK.data_ptr(), stream
    a.Kpair = stream_scratch(scratch, stream, nscratch, Pd.device)
    err = _build.lib().radial_exchange_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return KK


def _globalize(X: torch.Tensor, gi: torch.Tensor, nrad: int) -> torch.Tensor:
    """G[..., f, gi[f,q], gi[f,j]] = X[..., f, j, q] in the padded global
    square (the JAX GU/GV factors, atomic.py:532-535)."""
    *lead, nelem, nprim, _ = X.shape
    n1 = nrad + 1
    f = torch.arange(nelem, device=gi.device)[:, None, None]
    lin = (f * n1 + gi[:, None, :]) * n1 + gi[:, :, None]  # [f, j, q]
    out = torch.zeros((*lead, nelem * n1 * n1), dtype=X.dtype, device=X.device)
    out.index_add_(-1, lin.reshape(-1), X.reshape(*lead, -1))
    return out.reshape(*lead, nelem, n1, n1)


def radial_exchange_plain(tei: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                          gidx: torch.Tensor, Pd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of radial_exchange, faithful to
    atomic.py:499-553: cross-element triangles as prefix sums of global
    factors, the in-element term through the element windows."""
    NL, nelem, nprim = U.shape[:3]
    nang, nrad = Pd.shape[:2]
    n1 = nrad + 1
    gi = gidx.long()
    flat = gi.reshape(-1)
    Rp = F.pad(Pd, (0, 1, 0, 1))  # [a, n1, n1], trash row/col zero
    Rrows = Rp.index_select(1, flat).reshape(nang, nelem, nprim, n1)  # Rp[a, gi[e,p], :]
    GU = _globalize(U, gi, nrad)  # [g, f, n1, n1]
    GV = _globalize(V, gi, nrad)
    SUlow = torch.cumsum(GU, dim=1) - GU  # sum over f < e
    SVhigh = torch.flip(torch.cumsum(torch.flip(GV, (1,)), dim=1), (1,)) - GV  # f > e

    def triangle(X, Ssum):
        Y = torch.einsum("geip,aepm->gaeim", X, Rrows)
        Z = torch.einsum("gaeix,gexm->gaeim", Y, Ssum)
        K = torch.zeros((NL, nang, n1, n1), dtype=Pd.dtype, device=Pd.device)
        return K.index_add_(2, flat, Z.reshape(NL, nang, nelem * nprim, n1))

    K = triangle(V, SUlow) + triangle(U, SVhigh)
    # in-element term: windows Rg[a,e,i,l] = Rp[a, gi[e,i], gi[e,l]]
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)  # [(e i l)]
    Rg = Rp.reshape(nang, n1 * n1).index_select(1, lin).reshape(nang, nelem, nprim, nprim)
    Kd = torch.einsum("geijkl,aeil->gaejk", tei, Rg)
    K = K.reshape(NL, nang, n1 * n1).index_add_(2, lin, Kd.reshape(NL, nang, -1))
    return K.reshape(NL, nang, n1, n1)[:, :, :nrad, :nrad]


def radial_exchange_pairwise_plain(tei: torch.Tensor, U: torch.Tensor, V: torch.Tensor,
                                   gidx: torch.Tensor, Pd: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of radial_exchange in the pairwise form
    (atomic.py:468-496), the kernel's own: every element pair's product
    V[e] W[e,f] U[f]^T (e > f) or U[e] W[e,f] V[f]^T (e < f) on the window
    W[e,f][p,q] = Pd[gidx[e,p], gidx[f,q]], the in-element term on e == f,
    then the assembly over gidx. Exact on tables whose element scales span
    many orders (the Yukawa i_L/k_L), where the prefix sums are not."""
    NL, nelem, nprim = U.shape[:3]
    nang, nrad = Pd.shape[:2]
    n1 = nrad + 1
    gi = gidx.long()
    Rp = F.pad(Pd, (0, 1, 0, 1)).reshape(nang, n1 * n1)  # trash row/col zero
    lin = (gi.reshape(-1)[:, None] * n1 + gi.reshape(-1)[None, :]).reshape(-1)
    Rw = Rp.index_select(1, lin).reshape(nang, nelem, nprim, nelem, nprim).transpose(2, 3)
    e = torch.arange(nelem, device=Pd.device)
    lower = (e[:, None] > e[None, :])[None, :, :, None, None]  # [1, e, f, 1, 1]
    # the factor on each side of a pair: (V[e], U[f]) below the diagonal,
    # (U[e], V[f]) above it
    X = torch.where(lower, V[:, :, None], U[:, :, None])  # [g, e, f, i, p]
    Y = torch.where(lower, U[:, None], V[:, None])  # [g, e, f, j, q]
    T = torch.einsum("gefjq,aefpq->gaefpj", Y, Rw)
    Kp = torch.einsum("gefip,gaefpj->gaefij", X, T)
    Kd = torch.einsum("geijkl,aeil->gaejk", tei, Rw[:, e, e])
    Kp[:, :, e, e] = Kd
    out = torch.zeros((NL, nang, n1 * n1), dtype=Pd.dtype, device=Pd.device)
    out.index_add_(2, lin.reshape(nelem, nprim, nelem, nprim).transpose(1, 2).reshape(-1),
                   Kp.reshape(NL, nang, -1))
    return out.reshape(NL, nang, n1, n1)[:, :, :nrad, :nrad]
