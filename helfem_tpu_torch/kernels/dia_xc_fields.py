"""K4 dia_xc_fields: the density, its gradient components, in tau mode the
kinetic energy density and in laplacian mode also the density laplacian on
the XC grids (diatomic, atomic, SAD) for one or two spin densities, as a
hand-written CUDA kernel (csrc/dia_xc_fields.cu) and its plain PyTorch
version.

Replaces helfem_tpu/models/diatomic_dft.py:_fields_dia (diatomic_dft.py:
95-124) and models/atomic_dft.py:_density_fields (atomic_dft.py:99-124).
"""

import ctypes

import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import launch_template, launches, on_cpu

__all__ = ["dia_xc_fields", "dia_xc_fields_plain"]

_SMEM = 232448  # one block's shared memory on the H100
_LAPL = ("d2Bg", "LLTTp", "TTmmp", "lfac")  # the grid tables the laplacian mode reads


class _Launch(ctypes.Structure):
    """csrc/dia_xc_fields.cu:XcfLaunch: the pointers, then the sizes."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("P", "pairs", "gidx", "Bg", "dBg", "TTp", "dTTp",
                                                 "dTT2p", "TTm2p", "invh", "sqeta", "tfac",
                                                 *_LAPL, "D", "out", "stream")]
                + [(n, ctypes.c_int) for n in ("ns", "nang", "nelem", "nq", "nprim", "nrad", "nt",
                                               "npl", "pc", "qc", "smem", "device", "mode")])


def _ld(n: int) -> int:
    """csrc/dmma.cuh:dmma_ld: a row stride >= n, 4 mod 16 (in doubles)."""
    return n + (20 - n % 16) % 16


def fields_plan(nprim: int, nq: int, tau: bool = False,
                lapl: bool = False) -> tuple[int, int, int]:
    """(pairs, radial points, dynamic shared-memory bytes) of one phase-1
    item of the kernel (csrc/dia_xc_fields.cu takes them as given): the
    windows of up to 8 pairs and the B and dB tables (and d2B in laplacian
    mode) of up to 128 points (a multiple of 8), each within 64 KB, and at
    least phase 2's partial tiles (12 KB, 24 KB in tau mode, 36 KB in
    laplacian mode; tau mode stages nothing more in phase 1). Raises
    ValueError past the card's shared memory (nprim above about 150)."""
    mp = -(-nprim // 8) * 8
    nb = 3 if lapl else 2  # staged element tables
    qc = min(-(-nq // 8) * 8, 128)
    while qc > 8 and nb * mp * _ld(qc) > 8192:
        qc -= 8
    pc = max(1, min(8, 8192 // (mp * _ld(mp))))
    smem = max(8 * (pc * mp * _ld(mp) + nb * mp * _ld(qc)) + 4 * (2 * pc + nprim),
               8 * (9 if lapl else 6 if tau else 3) * 8 * 64)
    if smem > _SMEM:
        raise ValueError(f"dia_xc_fields: nprim={nprim} needs {smem} bytes of shared memory, "
                         f"above the card's {_SMEM}")
    return pc, qc, smem


_templates: dict = {}  # _common.launch_template's cache of _template


def _template(g, ns: int, mode: int, dev):
    """The launch arguments that depend only on the grid and the mode (0
    GGA, 1 tau, 2 laplacian), and the sizes."""
    nang = g.TT.shape[0]
    nelem, nq, nprim = g.Bg.shape
    nrad, nt, npl = g.owners.shape[0], g.sqeta.shape[0], g.pairs.shape[0]
    pc, qc, smem = fields_plan(nprim, nq, mode >= 1, mode == 2)
    t = _Launch(**{n: getattr(g, n).data_ptr() for n in ("pairs", "gidx", "Bg", "dBg", "TTp",
                                                         "dTTp", "dTT2p", "TTm2p", "invh",
                                                         "sqeta", "tfac")},
                **{n: getattr(g, n).data_ptr() if mode == 2 else None for n in _LAPL},
                ns=ns, nang=nang, nelem=nelem, nq=nq, nprim=nprim, nrad=nrad, nt=nt, npl=npl,
                pc=pc, qc=qc, smem=smem, device=dev.index, mode=mode)
    nf, nD = 3 + mode, 2 + mode
    sizes = (nang * nrad, nf, ns * nelem * nq * nt, nD * ns * nelem * npl * nq, (nelem, nq, nt))
    return t, sizes


def _mode(g, tau: bool, lapl: bool) -> int:
    """0 (GGA), 1 (tau) or 2 (laplacian, which implies tau); raises
    ValueError for a laplacian on a grid built without its tables."""
    if lapl and g.lfac is None:
        raise ValueError("dia_xc_fields: the laplacian needs a grid built with lapl=True")
    return 2 if lapl else int(bool(tau))


def dia_xc_fields(P: torch.Tensor, g, tau: bool = False, lapl: bool = False):
    """(rho, drho_u, drho_v), with tau=True also tau, and with lapl=True
    also tau and the density laplacian, each [ns, nelem, nq, nt], of the
    spin densities P [ns, nbf, nbf] (ns 1 or 2; bf = a * nrad + n) on the
    grid g (a DiaGridOps or AtomGridOps, whose tables were checked when it
    was built; with lapl=True built with its laplacian tables).

    CPU inputs run the plain version; CUDA inputs launch the kernel, one
    launch for all spins and fields. Only P is checked per call."""
    name = "dia_xc_fields"
    mode = _mode(g, tau, lapl)
    if on_cpu(name, P, g.Bg):
        return dia_xc_fields_plain(P, g, tau, lapl)
    if P.dtype != torch.float64:
        raise TypeError(f"{name}: P must be float64, got {P.dtype}")
    if not P.is_contiguous():
        raise ValueError(f"{name}: P must be contiguous")
    ns = P.shape[0] if P.dim() == 3 else 0
    dev = P.device
    t, (nbf, nf, nfield, nscratch, shape) = launch_template(
        _templates, (g,), (ns, mode), lambda: _template(g, ns, mode, dev))
    if ns not in (1, 2) or P.shape[1] != nbf or P.shape[2] != nbf:
        raise ValueError(f"{name}: P has shape {tuple(P.shape)}, expected (ns, {nbf}, {nbf}) "
                         "with ns 1 or 2")
    # fields [nf, ns, nelem, nq, nt], then the scratch D1, Dmu[, Ddd[, D2]]
    # [ns, nelem, nD, npl, nq]
    buf = torch.empty(nf * nfield + nscratch, dtype=torch.float64, device=dev)
    a = _Launch.from_buffer_copy(t)
    a.P, a.out = P.data_ptr(), buf.data_ptr()
    a.D = a.out + 8 * nf * nfield
    # the current stream's handle without a Stream object (which costs 7.6 us
    # per call on the H100's host)
    a.stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = _build.lib().dia_xc_fields_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return buf[:nf * nfield].view(nf, ns, *shape).unbind(0)


def _fields_one(P, g, tau, lapl):
    """One spin, faithful to diatomic_dft.py:97-110 on the padded 4-index
    density, with index_select over gidx; the tau factors are the grid's
    tfac (invh^2, invh^2, invhphi2 on the diatomic grid), and the
    laplacian is models/xc_grid.py's form with the grid's lfac."""
    nang = g.TT.shape[0]
    nrad = P.shape[0] // nang
    n1 = nrad + 1
    nelem, nprim = g.gidx.shape
    gi = g.gidx.long()
    lin = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)
    P4p = F.pad(P.reshape(nang, nrad, nang, nrad).permute(0, 2, 1, 3), (0, 1, 0, 1))
    Pg = P4p.reshape(nang, nang, n1 * n1).index_select(2, lin)
    Pg = Pg.reshape(nang, nang, nelem, nprim, nprim)
    D1 = torch.einsum("abeij,eqi,eqj->abeq", Pg, g.Bg, g.Bg)
    Dmu = 2.0 * torch.einsum("abeij,eqi,eqj->abeq", Pg, g.dBg, g.Bg)
    rho = torch.einsum("abeq,abt->eqt", D1, g.TT)
    DmuT = torch.einsum("abeq,abt->eqt", Dmu, g.TT)
    drho_u = DmuT * g.invh
    drho_v = torch.einsum("abeq,abt->eqt", D1, g.dTT) * (g.sqeta[None, None, :] * g.invh)
    if not (tau or lapl):
        return rho, drho_u, drho_v
    Ddd = torch.einsum("abeij,eqi,eqj->abeq", Pg, g.dBg, g.dBg)
    f1, f2, f3 = g.tfac
    tau = 0.5 * (torch.einsum("abeq,abt->eqt", Ddd, g.TT) * f1
                 + torch.einsum("abeq,abt->eqt", D1, g.dTT2) * f2
                 + torch.einsum("abeq,abt->eqt", D1, g.TTm2) * f3)
    if not lapl:
        return rho, drho_u, drho_v, tau
    D2 = 2.0 * torch.einsum("abeij,eqi,eqj->abeq", Pg, g.d2Bg, g.Bg)
    l1, l2, l3, l4 = g.lfac
    lap = (torch.einsum("abeq,abt->eqt", D2, g.TT) * l1 + DmuT * l2
           - torch.einsum("abeq,abt->eqt", D1, g.LLTT) * l3
           - torch.einsum("abeq,abt->eqt", D1, g.TTmm) * l4 + 4.0 * tau)
    return rho, drho_u, drho_v, tau, lap


def dia_xc_fields_plain(P, g, tau: bool = False, lapl: bool = False):
    """Plain PyTorch version of dia_xc_fields: each spin on its own, so a
    spin's fields do not depend on ns. Reads only helfem_tpu's tables (TT,
    dTT, dTT2, TTm2, gidx, ...), tfac and the laplacian tables (d2Bg, LLTT,
    TTmm, lfac), not the live-pair tables."""
    _mode(g, tau, lapl)
    per_spin = [_fields_one(P[s], g, tau, lapl) for s in range(P.shape[0])]
    return tuple(torch.stack(f) for f in zip(*per_spin))
