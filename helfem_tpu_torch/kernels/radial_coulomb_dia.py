"""K3 radial_coulomb_dia: the radial core of the diatomic Coulomb build, as
a hand-written CUDA kernel (csrc/radial_coulomb_dia.cu) and its plain
PyTorch version.

Replaces the radial part of helfem_tpu/models/diatomic.py:coulomb_dia
(diatomic.py:759-786): element-window gathers of both Gaunt-contracted
helpers, the disjoint P/Q traces with their prefix/suffix sums over
elements, the in-element contraction with the reduced 3-family TEI table
and the assembly, scaled by LMfac. The Gaunt contractions around it stay
torch.einsum (models/diatomic.py:coulomb_dia).
"""

import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    check_kernel_inputs, expect_shape, launches, on_cpu,
)

__all__ = ["radial_coulomb_dia", "radial_coulomb_dia_plain", "element_sums"]


def radial_coulomb_dia(Paux0: torch.Tensor, Paux2: torch.Tensor, teiJ3: torch.Tensor,
                       dP0: torch.Tensor, dP2: torch.Tensor, dQ0: torch.Tensor,
                       dQ2: torch.Tensor, LMfac: torch.Tensor, ilm: torch.Tensor,
                       gidx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Jr0, Jr2) [S, nrad, nrad] from the helpers Paux0, Paux2 [S, nrad,
    nrad] of S signed (L, M) channels.

    teiJ3 [nlm, 3, nelem, np^2, np^2] (families (0,0), (0,2), (2,2)),
    dP0/dP2/dQ0/dQ2 [nlm, nelem, np, np], LMfac [nlm], ilm [S] int32 (row
    of each channel in the (L,|M|) tables), gidx [nelem, np] int32 (nrad =
    trash slot). CPU inputs run the plain version; CUDA inputs launch the
    kernel. The kernel does not check ilm's or gidx's values: pass those of
    operators made by DiatomicBasis.build_operators or from_jax_operators."""
    name = "radial_coulomb_dia"
    args = (Paux0, Paux2, teiJ3, dP0, dP2, dQ0, dQ2, LMfac, ilm, gidx)
    if on_cpu(name, *args):
        return radial_coulomb_dia_plain(*args)
    check_kernel_inputs(
        name, {"Paux0": Paux0, "Paux2": Paux2, "teiJ3": teiJ3, "dP0": dP0, "dP2": dP2,
               "dQ0": dQ0, "dQ2": dQ2, "LMfac": LMfac},
        {"ilm": ilm, "gidx": gidx},
    )
    S, nrad = Paux0.shape[:2]
    nelem, nprim = gidx.shape
    nlm = teiJ3.shape[0]
    expect_shape(name, "Paux0", Paux0, (S, nrad, nrad))
    expect_shape(name, "Paux2", Paux2, (S, nrad, nrad))
    expect_shape(name, "teiJ3", teiJ3, (nlm, 3, nelem, nprim * nprim, nprim * nprim))
    for arg, t in (("dP0", dP0), ("dP2", dP2), ("dQ0", dQ0), ("dQ2", dQ2)):
        expect_shape(name, arg, t, (nlm, nelem, nprim, nprim))
    expect_shape(name, "LMfac", LMfac, (nlm,))
    expect_shape(name, "ilm", ilm, (S,))
    if nprim * nprim > 1024:
        raise ValueError(f"{name}: nprim={nprim} exceeds the kernel's 32")
    dev = Paux0.device
    # scratch and outputs come from PyTorch's stream-ordered caching allocator
    # and the launch goes on the current stream, so the scratch may be freed
    # when this function returns: later users of the memory run after it
    opts = dict(dtype=torch.float64, device=dev)
    Jin0 = torch.empty((S, nelem, nprim * nprim), **opts)
    Jin2 = torch.empty((S, nelem, nprim * nprim), **opts)
    ts = torch.empty((S, nelem), **opts)
    tb = torch.empty((S, nelem), **opts)
    Jr0 = torch.empty((S, nrad, nrad), **opts)
    Jr2 = torch.empty((S, nrad, nrad), **opts)
    err = _build.lib().radial_coulomb_dia_launch(
        *(t.data_ptr() for t in (*args, Jin0, Jin2, ts, tb, Jr0, Jr2)),
        S, nelem, nprim, nrad, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return Jr0, Jr2


def radial_coulomb_dia_plain(Paux0, Paux2, teiJ3, dP0, dP2, dQ0, dQ2, LMfac, ilm,
                             gidx) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of radial_coulomb_dia, faithful to
    diatomic.py:761-786 with index_select/index_add_ over gidx; the family
    (2,0) is read as the transpose of (0,2), and the element prefix and
    suffix sums are exclusive sums, as the kernel forms them."""
    S, nrad = Paux0.shape[:2]
    n1 = nrad + 1
    nelem, nprim = gidx.shape
    gi = gidx.long()
    il = ilm.long()
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)  # [(e i j)]

    def windows(Paux):
        Pp = F.pad(Paux, (0, 1, 0, 1)).reshape(S, n1 * n1)
        return Pp.index_select(1, lin).reshape(S, nelem, nprim, nprim)

    Pg0, Pg2 = windows(Paux0), windows(Paux2)
    p0, p2, q0, q2 = (d.index_select(0, il) for d in (dP0, dP2, dQ0, dQ2))
    tJ = teiJ3.index_select(0, il)  # [s, 3, e, np^2(ij), np^2(kl)]
    ts = torch.einsum("seij,seij->se", p0, Pg0) - torch.einsum("seij,seij->se", p2, Pg2)
    tb = torch.einsum("seij,seij->se", q0, Pg0) - torch.einsum("seij,seij->se", q2, Pg2)
    sA, sB = element_sums(ts, tb)
    J0 = p0 * sB[..., None, None] + q0 * sA[..., None, None]
    J2 = -p2 * sB[..., None, None] - q2 * sA[..., None, None]
    Pg0v = Pg0.reshape(S, nelem, -1)
    Pg2v = Pg2.reshape(S, nelem, -1)
    dJ0 = (torch.einsum("sexy,sey->sex", tJ[:, 0], Pg0v)
           + torch.einsum("sexy,sey->sex", tJ[:, 1], -Pg2v))
    dJ2 = (torch.einsum("seyx,sey->sex", tJ[:, 1], -Pg0v)
           + torch.einsum("sexy,sey->sex", tJ[:, 2], Pg2v))
    fac = LMfac.index_select(0, il)[:, None, None, None]
    J0 = (J0 + dJ0.reshape(J0.shape)) * fac
    J2 = (J2 + dJ2.reshape(J2.shape)) * fac

    def assemble(J):
        out = torch.zeros((S, n1 * n1), dtype=J.dtype, device=J.device)
        out.index_add_(1, lin, J.reshape(S, -1))
        return out.reshape(S, n1, n1)[:, :nrad, :nrad]

    return assemble(J0), assemble(J2)


def element_sums(ts: torch.Tensor, tb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sA, sB) [S, nelem]: the sum of the traces ts over the earlier
    elements and of tb over the later ones, formed as exclusive sums, as the
    kernel forms them. helfem_tpu forms them as an inclusive sum minus the
    element's own term (diatomic.py:771-772); the trace ts of the outermost
    element can exceed the sum over the inner ones by many orders of
    magnitude, and the subtraction then loses those digits
    (tests/test_torch_dia_fock.py::test_coulomb_element_sums_at_n2_bench)."""
    sA = F.pad(torch.cumsum(ts[:, :-1], dim=1), (1, 0))
    sB = F.pad(torch.flip(torch.cumsum(torch.flip(tb[:, 1:], (1,)), dim=1), (1,)), (0, 1))
    return sA, sB
