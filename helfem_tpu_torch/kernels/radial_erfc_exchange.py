"""K10 radial_erfc_exchange: the short-range (erfc) exchange contraction of
every (L, density channel) pair on the element-pair tables, as a
hand-written CUDA kernel (csrc/radial_erfc_exchange.cu) and its plain
PyTorch version.

Replaces helfem_tpu/models/atomic.py:erfc_exchange_bd's contraction
("efijkl,aefil->aefjk" over every element pair) and its one-hot assembly.
The plain version follows those einsums, with index_select/index_add_ over
gidx in place of the one-hot assembler matmuls.

The kernel reads the table packed to its unique entries (pack_erfc_table):
the pairs e <= f, the index pairs i <= j and k <= l, and (ij) <= (kl) on
e = f. The wrapper packs each table set once, on its device, and keeps the
packed copy with its launch arguments.
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    check_kernel_inputs, expect_shape, launch_template, launches, on_cpu, owner_table,
    stream_scratch,
)
from helfem_tpu_torch.kernels._radial import SMEM_BLOCK, _up, dmma_ld

__all__ = ["radial_erfc_exchange", "radial_erfc_exchange_plain", "pack_erfc_table",
           "unpack_erfc_table"]

SYMMETRY_TOL = 1e-12  # of the table's max-abs: the largest asymmetry the packed copy drops


class _Launch(ctypes.Structure):
    """csrc/radial_erfc_exchange.cu:ReLaunch: the pointers, then the sizes
    and the plan."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("tei", "Pd", "gidx", "owners", "bounds",
                                                 "Kpair", "KK", "nbytes", "stream")]
                + [(n, ctypes.c_int) for n in ("NL", "nelem", "nprim", "nang", "nrad", "nb",
                                               "MT", "NG", "NS", "RC", "STG", "CPP", "JP",
                                               "NWB", "device")])


_templates: dict = {}  # _common.launch_template's cache of _template
_packs: dict = {}  # and of the packed tables


def _sym_pairs(nprim: int, device) -> torch.Tensor:
    """The flat indices i * nprim + j of the pairs i <= j, in packed order."""
    iu = torch.triu_indices(nprim, nprim, device=device)
    return iu[0] * nprim + iu[1]


def pack_erfc_table(tei: torch.Tensor) -> torch.Tensor:
    """[NL, gstride]: one copy of each unique entry of the erfc tables tei
    [NL, nelem, nelem, np, np, np, np], which are symmetric under i <-> j,
    k <-> l and the pair swap tei[g,e,f,i,j,k,l] = tei[g,f,e,k,l,i,j]. Per
    g, the slabs M[r, s] = tei[g,e,f,i,j,k,l] of the element pairs e < f
    (row-major) over r = (i <= j), s = (k <= l) (npk = np (np + 1) / 2 rows of
    npk, in the order of torch.triu_indices), then the slabs e = f as the
    rows s >= r of their upper triangles."""
    NL, nelem, _, npr = tei.shape[:4]
    T = tei.reshape(NL, nelem, nelem, npr * npr, npr * npr)
    sym = _sym_pairs(npr, tei.device)
    nr = len(sym)
    eu = torch.triu_indices(nelem, nelem, 1, device=tei.device)
    el = torch.arange(nelem, device=tei.device)
    ru = torch.triu_indices(nr, nr, device=tei.device)
    off = T[:, eu[0], eu[1]][..., sym, :][..., sym].reshape(NL, -1)
    diag = T[:, el, el][..., sym, :][..., sym][..., ru[0], ru[1]].reshape(NL, -1)
    return torch.cat([off, diag], dim=1)


def unpack_erfc_table(packed: torch.Tensor, nelem: int, nprim: int) -> torch.Tensor:
    """pack_erfc_table's inverse: tei [NL, nelem, nelem, np, np, np, np],
    each dropped entry from its kept partner."""
    NL, dev, npr = packed.shape[0], packed.device, nprim
    nr = npr * (npr + 1) // 2
    eu = torch.triu_indices(nelem, nelem, 1, device=dev)
    el = torch.arange(nelem, device=dev)
    ru = torch.triu_indices(nr, nr, device=dev)
    npo = eu.shape[1]
    M = torch.zeros((NL, nelem, nelem, nr, nr), dtype=packed.dtype, device=dev)
    off = packed[:, :npo * nr * nr].reshape(NL, npo, nr, nr)
    M[:, eu[0], eu[1]] = off
    M[:, eu[1], eu[0]] = off.transpose(-1, -2)  # the pair swap
    tri = packed[:, npo * nr * nr:].reshape(NL, nelem, -1)
    D = torch.zeros((NL, nelem, nr, nr), dtype=packed.dtype, device=dev)
    D[..., ru[1], ru[0]] = tri
    D[..., ru[0], ru[1]] = tri
    M[:, el, el] = D
    ij = torch.arange(npr * npr, device=dev)
    i, j = ij // npr, ij % npr
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    r = lo * npr - lo * (lo - 1) // 2 + hi - lo  # the packed row of (i, j)
    M = M[..., r, :][..., r]
    return M.reshape(NL, nelem, nelem, npr, npr, npr, npr)


def check_symmetric(name: str, tei: torch.Tensor) -> None:
    """Raise unless tei has the three symmetries pack_erfc_table relies on,
    within SYMMETRY_TOL of its max-abs."""
    scale = float(tei.abs().max())
    for what, other in (("i <-> j", tei.transpose(3, 4)), ("k <-> l", tei.transpose(5, 6)),
                        ("the pair swap", tei.permute(0, 2, 1, 5, 6, 3, 4))):
        err = float((tei - other).abs().max())
        if err > SYMMETRY_TOL * scale:
            raise ValueError(f"{name}: the table is not symmetric under {what} (max-abs "
                             f"difference {err:.3e} of {scale:.3e}); the kernel reads one copy "
                             "of each symmetric entry")


class ErfcPlan(NamedTuple):
    MT: int  # 8-row tiles of k per item (1, or 2 for 9 <= nprim <= 16)
    NG: int  # 8-column tiles per column group (8 for nprim <= 8, 4 to 20, then 4 or 1)
    NS: int  # ring stages
    RC: int  # slab rows per chunk
    STG: int  # doubles per stage
    CPP: int  # column groups per part
    JP: int  # output rows j per part (nprim, or a multiple of 8 MT)
    NWB: int  # window buffers: 2 gathers a task's windows during the task before
    smem: int  # bytes of dynamic shared memory
    tasks: int


def _instances(nprim: int) -> list:
    """(MT, NG) of the kernel's instances that take nprim
    (csrc/radial_erfc_exchange.cu:re_kernel): one up to nprim 20, then the
    run-time depth with NG 4 or 1."""
    nmt = math.ceil(nprim / 8)
    if nprim <= 20:
        return [(2 if nmt == 2 else 1, 8 if nmt == 1 else 4)]
    return [(1, 4), (1, 1)]


def _rows_per_part(nprim: int, nmg: int, MT: int, CPP: int, cap: int) -> int:
    """JP: every row where a part's items fit the registers, else the most
    rows (a multiple of 8 MT) whose cross task's items fit (re_sizes:
    maxitem); 0 where none do."""
    if CPP * nprim * nmg <= cap:
        return nprim
    gm = 8 * MT
    for JP in range((nprim - 1) // gm * gm, 0, -gm):
        if CPP * (JP * nmg + (nprim - JP) * math.ceil(JP / gm)) <= cap:
            return JP
    return 0


def plan(NL: int, nang: int, nelem: int, nprim: int, nrad: int) -> ErfcPlan:
    """The kernel's tiles (csrc/radial_erfc_exchange.cu:re_sizes, re_smem):
    of the instances that take nprim, the column groups per part and rows
    per part with the fewest reads of each slab (parts), then the fewest
    row parts (every column in one part up to 64 columns at nprim 11-16, 96
    at 9-10, 256 at <= 8, 32 at 17-20), then the largest chunks with which
    four ring stages, or three, fit beside the windows, two window buffers
    where they fit, else one. Raises ValueError, naming the shape, where
    nothing fits (past nprim 52 the windows of one column group outgrow a
    block's shared memory)."""
    npr = nprim
    nr = npr * (npr + 1) // 2
    ldw = dmma_ld(npr * (_up(npr, 4) + 1))
    nct = math.ceil(2 * nang / 8)
    fixed = 4 * (5 * nrad + 2 * nelem * npr)  # pair_assembly.cuh:pair_tables_bytes
    npairs = nelem * (nelem + 1) // 2
    best = None
    for MT, NG in _instances(npr):
        nmg = math.ceil(math.ceil(npr / 8) / MT)
        cap = 8 * min(16, 32 // (MT * NG))  # items per task: 8 warps, 64 doubles of sums each
        ngrp = math.ceil(nct / NG)
        for CPP in range(ngrp, 0, -1):
            JP = _rows_per_part(npr, nmg, MT, CPP, cap)
            if not JP:
                continue
            nparts = math.ceil(ngrp / CPP), math.ceil(npr / JP)
            key = (nparts[0] * nparts[1], nparts[1])
            if best is not None and key >= best[0]:
                continue
            wbd = min(nct, NG * CPP) * 8 * ldw
            for NWB, NS in ((2, 4), (2, 3), (1, 4), (1, 3)):
                room = (SMEM_BLOCK - fixed) // 8 - NWB * wbd - 2 * NS  # doubles for the ring
                rc_max = min(nr, (room // NS - 3) // nr)
                if rc_max >= 1:
                    RC = math.ceil(nr / math.ceil(nr / rc_max))
                    STG = _up(RC * nr + 2, 2)
                    best = key, ErfcPlan(MT, NG, NS, RC, STG, CPP, JP, NWB,
                                         8 * (2 * NS + NS * STG + NWB * wbd) + fixed,
                                         key[0] * NL * npairs)
                    break
    if best is None:
        raise ValueError(f"radial_erfc_exchange: nprim={npr} with {nang} channels does not fit "
                         f"the shared memory of a block ({SMEM_BLOCK} bytes)")
    return best[1]


def _packed(tei: torch.Tensor) -> torch.Tensor:
    """The packed table of tei on its device, with 2 doubles of padding (a
    chunk's bulk copy may read up to 8 bytes past its last row); checked and
    built once per table set."""
    def build():
        check_symmetric("radial_erfc_exchange", tei)
        flat = pack_erfc_table(tei).reshape(-1)
        return torch.cat([flat, flat.new_zeros(2)])

    return launch_template(_packs, (tei,), (), build)


def _template(tei, gidx, nang: int, nrad: int):
    """The launch arguments that depend only on the tables (checked and
    packed here, once), the owner table and the functions two element slots
    share, and the sizes."""
    name = "radial_erfc_exchange"
    check_kernel_inputs(name, {"tei": tei}, {"gidx": gidx})
    NL, nelem = tei.shape[:2]
    nprim = gidx.shape[1]
    expect_shape(name, "tei", tei, (NL, nelem, nelem) + (nprim,) * 4)
    expect_shape(name, "gidx", gidx, (nelem, nprim))
    dev = tei.device
    p = plan(NL, nang, nelem, nprim, nrad)
    packed = _packed(tei)
    own = owner_table(gidx.cpu().numpy(), nrad)
    tables = torch.tensor(np.concatenate([own.ravel(), np.nonzero(own[:, 1] >= 0)[0]]),
                          dtype=torch.int32, device=dev)  # owners, then the shared functions
    t = _Launch(tei=packed.data_ptr(), gidx=gidx.data_ptr(), owners=tables.data_ptr(),
                bounds=tables.data_ptr() + 4 * own.size, NL=NL, nelem=nelem, nprim=nprim,
                nang=nang, nrad=nrad, nb=len(tables) - own.size, MT=p.MT, NG=p.NG, NS=p.NS,
                RC=p.RC, STG=p.STG, CPP=p.CPP, JP=p.JP, NWB=p.NWB, device=dev.index)
    # the scratch Kpair [NL, nang, nelem, np, nelem, np] (only its boundary
    # rows and columns are used)
    return t, (NL, nang, nrad, nrad), NL * nang * (nelem * nprim) ** 2, {}, (tables, packed, p)


def radial_erfc_exchange(tei: torch.Tensor, gidx: torch.Tensor, Pd: torch.Tensor) -> torch.Tensor:
    """KK[g, a] = the erfc exchange contraction of multipole channel g
    applied to Pd[a].

    tei [NL, nelem, nelem, np, np, np, np] (ErfcOperators.tei), gidx
    [nelem, np] int32 (nrad = trash slot), Pd [nang, nrad, nrad] (the
    channels of one or more spins, stacked); returns KK [NL, nang, nrad,
    nrad] (trash dropped). CPU inputs run the plain version; CUDA inputs
    launch the kernel, once. The tables are checked (their symmetries too)
    and packed, and the launch arguments that depend on them built, once per
    table set; per call only Pd is checked. Pass the gidx of operators made
    by AtomicBasis.build_operators or from_jax_operators, which
    check_gidx."""
    name = "radial_erfc_exchange"
    if on_cpu(name, tei, gidx, Pd):
        return radial_erfc_exchange_plain(tei, gidx, Pd)
    return _launch(tei, gidx, Pd)


def _launch(tei, gidx, Pd, nbytes: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of the kernel; nbytes, if given, an int64 tensor of at
    least one entry per block of the grid that receives the bytes each
    block's bulk copies requested."""
    name = "radial_erfc_exchange"
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
    if nbytes is not None:
        a.nbytes = nbytes.data_ptr()
    err = _build.lib().radial_erfc_exchange_launch(ctypes.byref(a))
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return KK


def issued_bytes(tei: torch.Tensor, gidx: torch.Tensor, Pd: torch.Tensor) -> int:
    """The bytes of the table that one launch's bulk copies request (the sum
    of the kernel's own per-block counts): a measure of how often each slab
    is read. One launch, counted."""
    nsm = torch.cuda.get_device_properties(Pd.device).multi_processor_count
    counts = torch.zeros(4 * nsm, dtype=torch.int64, device=Pd.device)  # >= the grid
    _launch(tei, gidx, Pd, counts)
    return int(counts.sum())


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
