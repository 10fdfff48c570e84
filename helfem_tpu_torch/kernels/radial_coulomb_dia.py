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

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    band_table, check_kernel_inputs, expect_shape, launch_template, launches, on_cpu,
    owner_table, stream_scratch,
)

__all__ = ["radial_coulomb_dia", "radial_coulomb_dia_plain", "element_sums"]

WARPS = 8  # RB_WARPS
MAX_K = 8  # RCD_MAX_K: columns per lane, so at most 256 columns per band
MAX_R = 256  # RCD_MAX_R: rows per band


def depth(K: int) -> int:
    """csrc/radial_coulomb_dia.cu:rcd_depth: rows in flight per warp."""
    return 4 if K <= 4 else 3

SMEM_BLOCK = 232448  # the shared memory one block may use on the H100


class _Launch(ctypes.Structure):
    """csrc/radial_coulomb_dia.cu:RcdLaunch: the pointers, then the sizes and
    the plan."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("P0", "P2", "tei", "dP0", "dP2", "dQ0", "dQ2",
                                                 "cfac", "gidx", "owners", "band", "groups",
                                                 "chan", "rowpart", "colpart", "sab", "J0", "J2",
                                                 "stream")]
                + [(n, ctypes.c_int) for n in ("S", "G", "CH", "nelem", "nprim", "nrad", "R",
                                               "K", "W", "ncb", "device")])


_templates: dict = {}  # _common.launch_template's cache of _template


class Plan(NamedTuple):
    R: int  # rows per row band (of a slice's nprim^2 rows)
    K: int  # columns per lane
    W: int  # columns per column band
    ncb: int  # column bands
    nrb: int  # row bands
    tasks: int


def smem_bytes(CH: int, W: int, K: int, R: int, S: int, nelem: int, nprim: int,
               nrad: int) -> int:
    """csrc/radial_coulomb_dia.cu:rcd_smem: the warps' rings of depth(K) rows
    (an mbarrier, three segments of 32 K doubles and the slack of their bulk
    copies),
    the windows' band entries, the warps' column partials, a trace task's
    traces and each channel's LMfac (doubles, an even count), then the owner
    table, the column bands, gidx and each channel's slot and table row."""
    doubles = (WARPS * depth(K) * (1 + 3 * (32 * K + 2)) + CH * (2 * W + R) + WARPS * CH * 32 * K
               + 2 * CH * nelem + S)
    return 8 * (doubles + doubles % 2) + 4 * (6 * nrad + nelem * nprim + 2 * S)


def columns(nprim: int) -> tuple[int, int, int]:
    """(K, W, ncb): a slice's nprim^2 columns in the fewest bands of at most
    32 MAX_K, of near-equal width W, K = ceil(W / 32) per lane."""
    ncb = math.ceil(nprim * nprim / (32 * MAX_K))
    W = math.ceil(nprim * nprim / ncb)
    return math.ceil(W / 32), W, ncb


def plan(S: int, G: int, CH: int, nelem: int, nprim: int, nrad: int, nblocks: int) -> Plan:
    """The kernel's row tasks for S channels in G groups of CH channels: each
    (c, e) slice's np^2 rows in bands of R, its np^2 columns in the fewest
    bands of at most 256 (K = ceil(W / 32) per lane). R is the multiple of 8
    (up to 256) with the fewest doubles on a block: the table rows of its
    tasks (rounds of all tasks over the nblocks blocks, times R rows of 3 W,
    plus a task's fixed cost: the gathers, two barriers and the column
    partials, counted as two more rows per warp) and its share of the
    partial sums that the assembly reads (per entry, 2 ncb row and nrb
    column partials); ties to the larger R. Raises
    ValueError, naming the shape, where the shared memory of the smallest
    band does not fit one block."""
    np2 = nprim * nprim
    K, W, ncb = columns(nprim)
    best = None
    for R in range(8, min(MAX_R, -(-np2 // 8) * 8) + 1, 8):
        if smem_bytes(CH, W, K, R, S, nelem, nprim, nrad) > SMEM_BLOCK:
            break
        nrb = math.ceil(np2 / R)
        tasks = G * nelem * nrb * ncb
        cost = (math.ceil(tasks / nblocks) * (R + 2 * WARPS) * 3 * W
                + math.ceil(G * CH * nelem * np2 * (2 * ncb + nrb) / nblocks), -R)
        if best is None or cost < best[0]:
            best = (cost, Plan(R, K, W, ncb, nrb, tasks))
    if best is None:
        need = smem_bytes(CH, W, K, 8, S, nelem, nprim, nrad)
        raise ValueError(f"radial_coulomb_dia: nprim={nprim}, nelem={nelem}, nrad={nrad} need "
                         f"{need} bytes of shared memory, more than the card's {SMEM_BLOCK}")
    return best[1]


def tasks(p: Plan, G: int, nelem: int, nprim: int):
    """(g, e, first row, rows, first column, columns) of every row task, in
    the kernel's order (csrc/radial_coulomb_dia.cu:rcd_task)."""
    np2 = nprim * nprim
    for task in range(p.tasks):
        cb, rb, ge = task % p.ncb, task // p.ncb % p.nrb, task // (p.ncb * p.nrb)
        g, e = divmod(ge, nelem)
        r0, c0 = rb * p.R, cb * p.W
        yield g, e, r0, min(p.R, np2 - r0), c0, min(p.W, np2 - c0)


def channel_groups(ilm: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(groups [G, 1 + CH], slot [S], CH): the channels that share a table
    row c in groups of up to two (the +-M pair of a row), each group (c,
    then its channels, -1 where it has fewer than CH); slot[s] = g * CH +
    the place of channel s in its group g. CH = 2 where some row has two
    channels, else 1, so that each slice is read once for all its
    channels."""
    ilm = np.asarray(ilm)
    by_row: dict = {}
    for s, c in enumerate(ilm.tolist()):
        by_row.setdefault(c, []).append(s)
    CH = 2 if any(len(v) > 1 for v in by_row.values()) else 1
    groups, slot = [], np.zeros(len(ilm), dtype=np.int32)
    for c, chans in by_row.items():
        for i in range(0, len(chans), CH):
            part = chans[i:i + CH]
            for k, s in enumerate(part):
                slot[s] = len(groups) * CH + k
            groups.append([c] + part + [-1] * (CH - len(part)))
    return np.array(groups, dtype=np.int32).reshape(-1, 1 + CH), slot, CH


def _template(teiJ3, dP0, dP2, dQ0, dQ2, LMfac, ilm, gidx, S: int, nrad: int):
    """The launch arguments that depend only on the operators (checked
    here, once), the owner, band and channel tables they need (each
    channel's slot, table row and LMfac), the plan and the sizes."""
    name = "radial_coulomb_dia"
    on_cpu(name, teiJ3, dP0, dP2, dQ0, dQ2, LMfac, ilm, gidx)  # raises unless on one device
    if not teiJ3.is_cuda:
        raise ValueError(f"{name}: the operators lie on {teiJ3.device}, the helpers on a GPU")
    check_kernel_inputs(
        name, {"teiJ3": teiJ3, "dP0": dP0, "dP2": dP2, "dQ0": dQ0, "dQ2": dQ2, "LMfac": LMfac},
        {"ilm": ilm, "gidx": gidx})
    nelem, nprim = gidx.shape
    nlm = teiJ3.shape[0]
    expect_shape(name, "teiJ3", teiJ3, (nlm, 3, nelem, nprim * nprim, nprim * nprim))
    for arg, t in (("dP0", dP0), ("dP2", dP2), ("dQ0", dQ0), ("dQ2", dQ2)):
        expect_shape(name, arg, t, (nlm, nelem, nprim, nprim))
    expect_shape(name, "LMfac", LMfac, (nlm,))
    expect_shape(name, "ilm", ilm, (S,))
    il = ilm.cpu().numpy()
    if il.size and (il.min() < 0 or il.max() >= nlm):
        raise ValueError(f"{name}: ilm values must lie in [0, {nlm})")
    groups, slot, CH = channel_groups(il)
    G = groups.shape[0]
    dev = teiJ3.device
    chan = np.stack([slot, il.astype(np.int32)], axis=1)
    cfac = torch.tensor(LMfac.cpu().numpy()[il], dtype=torch.float64, device=dev)
    gi = gidx.cpu().numpy()
    own = owner_table(gi, nrad)
    band = band_table(gi, own, nrad)
    tables = torch.tensor(np.concatenate([own.ravel(), band.ravel(), groups.ravel(),
                                          chan.ravel()]), dtype=torch.int32, device=dev)
    base = tables.data_ptr()
    t = _Launch(tei=teiJ3.data_ptr(), dP0=dP0.data_ptr(), dP2=dP2.data_ptr(),
                dQ0=dQ0.data_ptr(), dQ2=dQ2.data_ptr(), cfac=cfac.data_ptr(),
                gidx=gidx.data_ptr(), owners=base, band=base + 4 * own.size,
                groups=base + 4 * (own.size + band.size),
                chan=base + 4 * (own.size + band.size + groups.size),
                S=S, G=G, CH=CH, nelem=nelem, nprim=nprim, nrad=nrad, device=dev.index)
    # the grid at the smallest row band (a band's rows add at most 4 KB to
    # the kernel's shared memory, the rings up to 170 KB)
    t.K, t.W, t.ncb = columns(nprim)
    t.R = 8
    nblocks = _build.lib().radial_coulomb_dia_grid(ctypes.byref(t))
    if nblocks < 1:
        raise RuntimeError(f"{name}: no cooperative grid for {S} channels at nprim={nprim}")
    p = plan(S, G, CH, nelem, nprim, nrad, nblocks)
    t.R = p.R
    # rowpart [G, nelem, ncb, np^2, 2, CH], colpart [G, nelem, nrb, np^2,
    # CH], then sab [S, 2, nelem]
    nrow = G * nelem * p.ncb * nprim * nprim * 2 * CH
    ncol = G * nelem * p.nrb * nprim * nprim * CH
    return t, (S, nrad, nrad), (nrow, nrow + ncol), nrow + ncol + S * 2 * nelem, {}, \
        (tables, cfac)


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
    kernel, once. The operators are checked, and the launch arguments that
    depend on them built, once per operator set (ilm, a fresh view
    ops.LM_ilm[:njbd] on each call, is found by its memory); per call only
    Paux0 and Paux2 are checked. Pass the gidx of operators made by
    DiatomicBasis.build_operators or from_jax_operators, which check_gidx."""
    name = "radial_coulomb_dia"
    # a CUDA Paux0 goes to the kernel: the template holds the operators'
    # device (every operator on it, checked once), each call Paux0's and
    # Paux2's; anything else goes through on_cpu, which raises on a mix
    if not Paux0.is_cuda and on_cpu(name, Paux0, Paux2, teiJ3, dP0, dP2, dQ0, dQ2, LMfac,
                                    ilm, gidx):
        return radial_coulomb_dia_plain(Paux0, Paux2, teiJ3, dP0, dP2, dQ0, dQ2, LMfac, ilm,
                                        gidx)
    if Paux0.dim() != 3:
        raise ValueError(f"{name}: Paux0 has shape {tuple(Paux0.shape)}, expected "
                         "[S, nrad, nrad]")
    S, nrad = ilm.shape[0], Paux0.shape[1]
    t, shape, (nrow, nsab), nscratch, scratch, _ = launch_template(
        _templates, (teiJ3, dP0, dP2, dQ0, dQ2, LMfac, gidx), (S, nrad),
        lambda: _template(teiJ3, dP0, dP2, dQ0, dQ2, LMfac, ilm, gidx, S, nrad), views=(ilm,))
    for arg, P in (("Paux0", Paux0), ("Paux2", Paux2)):
        if P.get_device() != t.device:
            raise ValueError(f"{name}: {arg} lies on {P.device}, the operators on cuda:{t.device}")
        if P.dtype != torch.float64:
            raise TypeError(f"{name}: {arg} must be float64, got {P.dtype}")
        if not P.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if P.shape != shape:
            raise ValueError(f"{name}: {arg} has shape {tuple(P.shape)}, expected {shape}")
    # the current stream's handle without a Stream object (which costs 7.6 us
    # per call on the H100's host)
    stream = torch._C._cuda_getCurrentRawStream(t.device)
    out = torch.empty((2, *shape), dtype=torch.float64, device=Paux0.device)
    a = _Launch.from_buffer_copy(t)
    a.P0, a.P2, a.stream = Paux0.data_ptr(), Paux2.data_ptr(), stream
    a.J0 = out.data_ptr()
    a.J2 = a.J0 + 8 * S * nrad * nrad
    a.rowpart = stream_scratch(scratch, stream, nscratch, Paux0.device)
    a.colpart = a.rowpart + 8 * nrow
    a.sab = a.rowpart + 8 * nsab
    err = _build.lib().radial_coulomb_dia_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return out.unbind(0)


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
