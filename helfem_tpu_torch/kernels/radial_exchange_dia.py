"""K6 radial_exchange_dia_occ and K7 radial_exchange_dia: the radial core of
the diatomic exchange build, as hand-written CUDA kernels
(csrc/radial_exchange_dia.cu) and their plain PyTorch versions.

They replace the radial parts of helfem_tpu/models/diatomic.py:
exchange_dia_occ (diatomic.py:1061-1113) and exchange_dia (:912-928). Per
(L,|M|) channel and radial family F = (q, r) in {(0,0), (0,2), (2,0), (2,2)}
there is a weight tensor R_F[b, c, n, m] over shell pairs and global radial
indices; the core contracts its element windows with the in-element TEI
table in the exchange index order, and its (e > f) element-pair windows with
the disjoint Q moments on the left and the P moments on the right, assembles
both, and adds the upper cross-element triangle as the (b<->c, n<->m)
transpose of the lower one. K7 takes the dense R; K6 takes its rank factors
U, V and never forms R outside shared memory. The Gaunt transforms that make
R or U, V stay torch.einsum (models/diatomic.py).

Both read the reduced table teiJ3 directly: helfem_tpu's teiK is the index
permutation (ij|kl) -> rows (jk), columns (il) of teiJ, and family (2,0) is
the transpose of (0,2). The cross-element terms are formed pairwise, element
window by element window, so no prefix sum over elements is taken (the P
moments grow and the Q moments fall by orders of magnitude from element to
element, and helfem_tpu's inclusive-sum-minus-self loses those digits).

The in-element term, one GEMM per element and 8 x 8 tile of shell pairs,
runs on the H100's FP64 tensor cores (mma.sync DMMA): producer warps bulk-
copy one contiguous table slab per depth chunk (TMA) and form K6's R tile
from the U/V windows on DMMA, three stages ahead of eight DMMA warps
(csrc/radial_exchange_dia.cu has the design). _inelem_plan mirrors its
shared-memory sizing, _channel_groups picks its grid.
"""

import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import (
    check_kernel_inputs, expect_shape, launches, on_cpu,
)

__all__ = ["radial_exchange_dia_occ", "radial_exchange_dia_occ_plain",
           "radial_exchange_dia", "radial_exchange_dia_plain"]

_TILE = 8  # shell-pair tile edge of the kernel (XT in the source)
_SMEM = 232448 - 256  # one block's on the H100, less the kernel's static shared memory
_SM_SMEM = 233472  # shared memory of one multiprocessor, for resident blocks
_MAX_NPRIM = 72  # EX_MAX_NPRIM: the cross kernel's static gidx slots


def _inelem_plan(name: str, nprim: int, no: int | None) -> tuple[int, int, int, int]:
    """(TM, shared-memory bytes, stages, window buffers) of the in-element
    GEMM, as csrc/radial_exchange_dia.cu sizes them (exdia_tm, exdia_geom,
    exdia_smem_doubles, exdia_gs_doubles): three stages of the A slab and
    the R tile and two U/V window buffers where they fit, then fewer, and
    the element's gidx slots; no is None for the dense kernel, which stages
    no windows. Raises ValueError when two stages (and one window buffer)
    do not fit: past nprim 62 for K6, past 72 for K7's in-element GEMM."""
    np2 = nprim * nprim
    tm = 1 if np2 <= 64 else (2 if np2 <= 128 or nprim > 16 else 4)
    kpad = -(-nprim // 8) * 8
    rows = min(64 * tm, -(-np2 // 64) * 64)
    stage = (rows * nprim + kpad + 3) // 2 * 2 + kpad * (8 * _TILE + 4)
    slots = (nprim + 1) // 2
    if no is None:
        for ns in (3, 2):
            smem = 8 * (ns * stage + slots)
            if smem <= _SMEM:
                return tm, smem, ns, 0
        raise ValueError(f"{name}: nprim={nprim} needs {smem} bytes of shared memory for two "
                         f"stages, above the card's {_SMEM}")
    xk = -(-2 * no // 4) * 4
    window = 2 * _TILE * (kpad * (xk if xk % 8 else xk + 4) + 4)
    # the next windows land two chunks after they are issued
    for ns, wbuf in ((3, 2), (3, 1), (2, 2), (2, 1)) if nprim >= 2 else ((3, 1), (2, 1)):
        smem = 8 * (ns * stage + wbuf * window + slots)
        if smem <= _SMEM:
            return tm, smem, ns, wbuf
    raise ValueError(f"{name}: no={no} occupied columns at nprim={nprim} need {smem} bytes "
                     f"of shared memory, above the card's {_SMEM}")


def _cross_dense_smem(name: str, nprim: int) -> int:
    """Dynamic shared memory of K7's cross kernel (exdia_cross_dense_kernel):
    six [np, np] tables, beside its static gidx slots of two elements (2 x
    EX_MAX_NPRIM ints). Raises ValueError past nprim 69, where they exceed
    one block's."""
    smem = 8 * 6 * nprim * nprim
    if smem > 232448 - 8 * _MAX_NPRIM:
        raise ValueError(f"{name}: nprim={nprim} needs {smem} bytes of shared memory for the "
                         f"cross-element term, above the card's {232448 - 8 * _MAX_NPRIM}")
    return smem


def _column_chunks(name: str, nprim: int, no: int) -> list[tuple[int, int]]:
    """(start, stop) of the occupied-column chunks that the occupied-orbital
    kernel runs one launch each: all no columns when _inelem_plan admits
    them, else the fewest chunks of near-equal width that it admits. R is a
    sum over the columns, so the chunks' results add up to the whole (up to
    the order of the sums)."""
    try:
        _inelem_plan(name, nprim, no)
        return [(0, no)]
    except ValueError:
        pass
    lo, hi = 1, no  # the widest admitted width lies in [lo, hi)
    _inelem_plan(name, nprim, lo)  # raises if not even one column fits
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            _inelem_plan(name, nprim, mid)
            lo = mid
        except ValueError:
            hi = mid
    k = -(-no // lo)
    bounds = [no * c // k for c in range(k + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def _channel_groups(S: int, nang: int, nelem: int, nprim: int, tm: int, smem: int,
                    sms: int) -> int:
    """Channel groups G of the in-element GEMM: the G that finishes in the
    fewest block waves on `sms` multiprocessors, each wave as long as one
    group's chunks (4 nprim per channel, plus about eight for the zeroing,
    the prologue and the two partial-sum writes), with the 2 G partial sums
    within 512 MiB; the smallest such G."""
    ntile = -(-nang // _TILE)
    blocks = -(-nprim * nprim // (64 * tm)) * nelem * ntile * (ntile + 1) // 2
    slots = sms * max(1, min(1 if tm == 4 else 2, _SM_SMEM // (smem + 1024)))
    gmax = max(1, min(S, 2**25 // (nelem * nang * nang * nprim * nprim)))
    return min(range(1, gmax + 1),
               key=lambda G: (-(-blocks * G // slots) * (-(-S // G) * 4 * nprim + 8), G))


def _check_tables(name, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx, S):
    nelem, nprim = gidx.shape
    nlm = teiJ3.shape[0]
    expect_shape(name, "teiJ3", teiJ3, (nlm, 3, nelem, nprim * nprim, nprim * nprim))
    for arg, t in (("dP0", dP0), ("dP2", dP2), ("dQ0", dQ0), ("dQ2", dQ2)):
        expect_shape(name, arg, t, (nlm, nelem, nprim, nprim))
    expect_shape(name, "ilm", ilm, (S,))


def radial_exchange_dia_occ(Uw: torch.Tensor, V: torch.Tensor, teiJ3: torch.Tensor,
                            dP0: torch.Tensor, dP2: torch.Tensor, dQ0: torch.Tensor,
                            dQ2: torch.Tensor, ilm: torch.Tensor,
                            gidx: torch.Tensor) -> torch.Tensor:
    """K4 [nang, nang, nrad, nrad] (positive; the caller negates) from the
    rank factors of S exchange channels: R_qr[b,c,n,m] = s_q s_r sum_{t,o}
    Uw[s,q,t,b,n,o] V[s,r,t,c,m,o] with s = (+1, -1).

    Uw, V [S, 2(q), 2(t), nang, nrad+1, no], row nrad zero (the trash slot).
    Uw = w[s,t] U and V = U diag(sgn) for one U, and the tables have the
    real ones' symmetries ((ij|kl) under i<->j and k<->l, symmetric moment
    blocks): the kernel computes the shell pairs b <= c and takes the rest,
    like the upper cross-element triangle, by R_qr[b,c,n,m] = R_rq[c,b,m,n].
    teiJ3 [nlm, 3, nelem, np^2, np^2], dP0/dP2/dQ0/dQ2 [nlm, nelem, np, np],
    ilm [S] int32 (table row of each channel), gidx [nelem, np] int32. CPU
    inputs run the plain version; CUDA inputs launch the kernel, once per
    column chunk of _column_chunks (once for all no columns where the
    shared-memory plan admits them), the chunks' results summed in order.
    ilm's and gidx's values are not checked: pass
    those of operators made by DiatomicBasis.build_operators or
    from_jax_operators."""
    name = "radial_exchange_dia_occ"
    args = (Uw, V, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx)
    if on_cpu(name, *args):
        return radial_exchange_dia_occ_plain(*args)
    check_kernel_inputs(
        name, {"Uw": Uw, "V": V, "teiJ3": teiJ3, "dP0": dP0, "dP2": dP2, "dQ0": dQ0,
               "dQ2": dQ2}, {"ilm": ilm, "gidx": gidx})
    if Uw.dim() != 6:
        raise ValueError(f"{name}: Uw has shape {tuple(Uw.shape)}, expected 6 axes")
    S, _, _, nang, n1, no = Uw.shape
    nelem, nprim = gidx.shape
    expect_shape(name, "Uw", Uw, (S, 2, 2, nang, n1, no))
    expect_shape(name, "V", V, (S, 2, 2, nang, n1, no))
    _check_tables(name, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx, S)
    K4 = None
    for o0, o1 in _column_chunks(name, nprim, no):
        whole = o1 - o0 == no
        part = _launch_occ(name, Uw if whole else Uw[..., o0:o1].contiguous(),
                           V if whole else V[..., o0:o1].contiguous(), args[2:])
        K4 = part if K4 is None else K4.add_(part)
    return K4


def _launch_occ(name, Uw, V, tables):
    """One launch of the occupied-orbital kernel on the columns of Uw, V."""
    teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx = tables
    S, _, _, nang, n1, no = Uw.shape
    nelem, nprim = gidx.shape
    nrad = n1 - 1
    tm, smem, ns, wbuf = _inelem_plan(name, nprim, no)
    dev = Uw.device
    G = _channel_groups(S, nang, nelem, nprim, tm, smem,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    # scratch and output come from PyTorch's stream-ordered allocator and the
    # launches go on the current stream, so the scratch may be freed on return
    opts = dict(dtype=torch.float64, device=dev)
    npairs = nelem * (nelem - 1) // 2
    part = torch.empty((2 * G, nelem, nang, nang, nprim * nprim), **opts)
    ud = torch.empty((nelem, S * 2 * no, nang * nprim), **opts)
    vd = torch.empty((nelem, S * 2 * no, nang * nprim), **opts)
    X = torch.empty((npairs, nang * nprim, nang * nprim), **opts)
    K4 = torch.empty((nang, nang, nrad, nrad), **opts)
    err = _build.lib().radial_exchange_dia_occ_launch(
        *(t.data_ptr() for t in (Uw, V, *tables, part, ud, vd, X, K4)),
        S, nelem, nprim, nang, nrad, no, G, ns, wbuf, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return K4


def radial_exchange_dia(R: torch.Tensor, teiJ3: torch.Tensor, dP0: torch.Tensor,
                        dP2: torch.Tensor, dQ0: torch.Tensor, dQ2: torch.Tensor,
                        ilm: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """K4 [nang, nang, nrad, nrad] (positive) from the dense weights R [S,
    4, nang, nang, nrad, nrad] of S exchange channels, families in the order
    (0,0), (0,2), (2,0), (2,2) with their signs included. The upper
    cross-element triangle is the transpose of the lower one, which is K
    only when R_qr[b,c,n,m] = R_rq[c,b,m,n], as it is for a symmetric
    density. Tables, routing and unchecked index values as
    radial_exchange_dia_occ."""
    name = "radial_exchange_dia"
    args = (R, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx)
    if on_cpu(name, *args):
        return radial_exchange_dia_plain(*args)
    check_kernel_inputs(
        name, {"R": R, "teiJ3": teiJ3, "dP0": dP0, "dP2": dP2, "dQ0": dQ0, "dQ2": dQ2},
        {"ilm": ilm, "gidx": gidx})
    if R.dim() != 6:
        raise ValueError(f"{name}: R has shape {tuple(R.shape)}, expected 6 axes")
    S, _, nang, _, nrad, _ = R.shape
    nelem, nprim = gidx.shape
    expect_shape(name, "R", R, (S, 4, nang, nang, nrad, nrad))
    _check_tables(name, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx, S)
    tm, smem, ns, _ = _inelem_plan(name, nprim, None)
    if nelem > 1:
        _cross_dense_smem(name, nprim)
    dev = R.device
    G = _channel_groups(S, nang, nelem, nprim, tm, smem,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    opts = dict(dtype=torch.float64, device=dev)
    npairs = nelem * (nelem - 1) // 2
    part = torch.empty((2 * G, nelem, nang, nang, nprim * nprim), **opts)
    X = torch.empty((npairs, nang * nprim, nang * nprim), **opts)
    K4 = torch.empty((nang, nang, nrad, nrad), **opts)
    err = _build.lib().radial_exchange_dia_launch(
        *(t.data_ptr() for t in (*args, part, X, K4)),
        S, nelem, nprim, nang, nrad, G, ns, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return K4


# ----------------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------------


def _tei4(t3: torch.Tensor, nprim: int) -> torch.Tensor:
    """One channel's table rows [3, nelem, np^2, np^2] as T[q, r, e, i, j, k,
    l] = (ij|kl) of family (q, r); (2,0) is (0,2) with (ij) and (kl)
    swapped."""
    T = torch.stack([torch.stack([t3[0], t3[1]]),
                     torch.stack([t3[1].transpose(-1, -2), t3[2]])])
    return T.reshape(2, 2, t3.shape[1], nprim, nprim, nprim, nprim)


def _assemble(Kd: torch.Tensor, X: torch.Tensor, gi: torch.Tensor,
              nrad: int) -> torch.Tensor:
    """K4 from the in-element blocks Kd [b, c, e, j, k] and the element-pair
    blocks X [e, f, b, i, c, x], of which only e > f is used: scatter-add
    through gi, then the upper cross triangle as the transpose."""
    nang, nelem = Kd.shape[0], Kd.shape[2]
    n1 = nrad + 1
    out = torch.zeros((nang, nang, n1 * n1), dtype=Kd.dtype, device=Kd.device)
    lin_in = (gi[:, :, None] * n1 + gi[:, None, :]).reshape(-1)  # (e, j, k)
    out.index_add_(2, lin_in, Kd.reshape(nang, nang, -1))
    low = torch.tril(torch.ones((nelem, nelem), dtype=Kd.dtype, device=Kd.device), -1)
    Xl = (X * low[:, :, None, None, None, None]).permute(2, 4, 0, 3, 1, 5)  # b c e i f x
    lin_x = (gi[:, :, None, None] * n1 + gi[None, None, :, :]).reshape(-1)  # (e, i, f, x)
    cr = torch.zeros_like(out)
    cr.index_add_(2, lin_x, Xl.reshape(nang, nang, -1))
    out = out.reshape(nang, nang, n1, n1)
    cr = cr.reshape(nang, nang, n1, n1)
    return (out + cr + cr.permute(1, 0, 3, 2))[:, :, :nrad, :nrad].contiguous()


_SIGN = ((1.0, -1.0), (-1.0, 1.0))


def radial_exchange_dia_occ_plain(Uw, V, teiJ3, dP0, dP2, dQ0, dQ2, ilm,
                                  gidx) -> torch.Tensor:
    """Plain PyTorch version of radial_exchange_dia_occ: per channel, the
    element windows of U and V through gidx, the rank product over the full
    shell-pair grid, the TEI contraction in the exchange index order, the
    pairwise cross factors, and the scatter-add assembly."""
    S, _, _, nang, n1, no = Uw.shape
    nelem, nprim = gidx.shape
    gi = gidx.long()
    opts = dict(dtype=Uw.dtype, device=Uw.device)
    sign = torch.tensor(_SIGN, **opts)
    s2 = sign[0]
    Kd = torch.zeros((nang, nang, nelem, nprim, nprim), **opts)
    X = torch.zeros((nelem, nelem, nang, nprim, nang, nprim), **opts)
    for s in range(S):
        c = int(ilm[s])
        Ue = Uw[s][:, :, :, gi]  # [q, t, b, e, i, o]
        Ve = V[s][:, :, :, gi]
        T4 = _tei4(teiJ3[c], nprim) * sign[:, :, None, None, None, None, None]
        Rg = torch.einsum("qtbeio,rtcelo->qrebcil", Ue, Ve)
        Kd += torch.einsum("qreijkl,qrebcil->bcejk", T4, Rg)
        dQ = torch.stack([dQ0[c], dQ2[c]]) * s2[:, None, None, None]
        dP = torch.stack([dP0[c], dP2[c]]) * s2[:, None, None, None]
        ud = torch.einsum("qeip,qtbepo->tebio", dQ, Ue)
        vd = torch.einsum("rfxm,rtcfmo->tfcxo", dP, Ve)
        X += torch.einsum("tebio,tfcxo->efbicx", ud, vd)
    return _assemble(Kd, X, gi, n1 - 1)


def radial_exchange_dia_plain(R, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx) -> torch.Tensor:
    """Plain PyTorch version of radial_exchange_dia: per channel, the
    diagonal and the element-pair windows of the dense R through gidx (trash
    slot read as zero), contracted as radial_exchange_dia_occ_plain
    contracts its rank products."""
    S, _, nang, _, nrad, _ = R.shape
    nelem, nprim = gidx.shape
    gi = gidx.long()
    opts = dict(dtype=R.dtype, device=R.device)
    Kd = torch.zeros((nang, nang, nelem, nprim, nprim), **opts)
    X = torch.zeros((nelem, nelem, nang, nprim, nang, nprim), **opts)
    for s in range(S):
        c = int(ilm[s])
        Rp = F.pad(R[s], (0, 1, 0, 1))  # [4, b, c, nrad+1, nrad+1]
        Rg = Rp[:, :, :, gi[:, :, None], gi[:, None, :]]  # [4, b, c, e, i, l]
        T4 = _tei4(teiJ3[c], nprim).reshape(4, nelem, nprim, nprim, nprim, nprim)
        Kd += torch.einsum("Feijkl,Fbceil->bcejk", T4, Rg)
        Rw = Rp[:, :, :, gi[:, None, :, None], gi[None, :, None, :]]  # [4,b,c,e,f,p,m]
        dQ = torch.stack([dQ0[c], dQ0[c], dQ2[c], dQ2[c]])
        dP = torch.stack([dP0[c], dP2[c], dP0[c], dP2[c]])
        Y = torch.einsum("Feip,Fbcefpm->Fbcefim", dQ, Rw)
        X += torch.einsum("Fbcefim,Ffxm->efbicx", Y, dP)
    return _assemble(Kd, X, gi, nrad)
