"""The shell-pair and element tables that the XC grid kernels dia_xc_fields
(K4) and dia_xc_fock (K5) read, shared by every grid that runs on them: the
diatomic grid (models/diatomic_dft.py), the atomic grid
(models/atomic_dft.py) and the spherically averaged atom's radial grid
(models/sadatom.py). Built once per grid on the host in numpy.

The meta-GGA (tau) terms read two more angular tables, dTT2 and TTm2, and
three per-point factors tfac [3, nelem, nq, nt] that each grid supplies:

  tau = 1/2 [f1 sum_ab TT Ddd + f2 sum_ab dTT2 D1 + f3 sum_ab TTm2 D1]

with Ddd = sum_ij P dB_i dB_j and D1 = sum_ij P B_i B_j; f1 = f2 = 1/h^2,
f3 = 1/(Rh^2 sinh^2 mu) on the diatomic grid, f1 = 1, f2 = f3 = 1/r^2 on
the atomic and SAD grids. The Fock terms of vtau use the same factors.

The laplacian-level meta-GGAs (BR89) read the density laplacian, which on
both the diatomic and the atomic grid is

  lapl = g1 sum_ab TT D2 + g2 sum_ab TT Dmu - g3 sum_ab LLTT D1
         - g4 sum_ab TTmm D1 + 4 tau

with D2 = 2 sum_ij P d2B_i B_j, Dmu = 2 sum_ij P dB_i B_j, LLTT = (l_a(l_a+1)
+ l_b(l_b+1)) TT, TTmm = 2 m_a m_b TT and the per-point factors lfac [4,
nelem, nq, nt] = (g1..g4): invh^2, invh^2 coth mu, invh^2, invh^2 /
sinh^2 mu on the diatomic grid (helfem_tpu's diatomic_dft.py:112-123); 1,
2/r, 1/r^2, 0 on the atomic grid (atomic_dft.py:116-123, where 4 tau
carries the dB dB and dTT2, TTm2 terms). Its Fock side is the tau Fock
with wvt -> wvt + 4 wvl, plus g1 wvl TT against d2B_i B_j + B_i d2B_j,
g2 wvl TT against dB_i B_j + B_i dB_j, and -wvl (g3 LLTT + g4 TTmm)
against B_i B_j. These tables are built only for a grid that a
laplacian-level functional asks for.
helfem_tpu forms dTT2 and TTm2 with a factor between the two angular
functions ((1 - eta^2) Theta'_a Theta'_b, m^2 Theta_a Theta_b), so their
(a, b) and (b, a) entries can differ in the last bit; build_grid takes the
a <= b entry for both, which the kernels' fold needs.
"""

from collections.abc import Mapping

import numpy as np
import torch

from helfem_tpu_torch.kernels import band_table, check_gidx, owner_table

__all__ = ["build_grid", "element_tables", "pair_tables"]

_ANGULAR = ("TT", "dTT", "dTT2", "TTm2")
_LAPL_ANGULAR = ("LLTT", "TTmm")


def pair_tables(TT: np.ndarray, dTT: np.ndarray, dTT2: np.ndarray, TTm2: np.ndarray,
                gidx: np.ndarray, nrad: int) -> dict[str, np.ndarray]:
    """The shell-pair tables of the XC kernels: the live pairs a <= b (one
    of TT, dTT, dTT2, TTm2 not identically zero), their rows of the four
    angular tables, the element slots covering each radial function and the
    run of radial indices those elements span.

    Raises ValueError unless every angular table is exactly symmetric in
    (a, b): the kernels fold (a, b) with (b, a) on that ground (D1[a,b] +
    D1[b,a] = B^T (W_ab + W_ba) B for the density windows W, and the Fock
    element block of (b, a) is that of (a, b))."""
    tables = dict(zip(_ANGULAR, (np.asarray(T) for T in (TT, dTT, dTT2, TTm2))))
    for name, T in tables.items():
        if not np.array_equal(T, T.transpose(1, 0, 2)):
            raise ValueError(f"{name} is not exactly symmetric in its two shell indices")
    live = np.triu(np.any([(T != 0).any(-1) for T in tables.values()], axis=0))
    a, b = np.nonzero(live)
    gidx = np.asarray(gidx)
    owners = owner_table(gidx, nrad)
    band = band_table(gidx, owners, nrad)
    return dict(pairs=np.stack([a, b], axis=1).astype(np.int32),
                **{f"{name}p": T[a, b] for name, T in tables.items()}, owners=owners, band=band)


def element_tables(Bg: np.ndarray, dBg: np.ndarray,
                   d2Bg: np.ndarray | None = None) -> dict[str, np.ndarray]:
    """The products of the element functions that the XC Fock kernel
    contracts its pair potentials with, on the i <= j half (the element
    blocks are symmetric in (i, j)): B_i B_j, dB_i B_j + B_i dB_j and
    dB_i dB_j (tau), and with d2Bg d2B_i B_j + B_i d2B_j (laplacian)."""
    Bg, dBg = np.asarray(Bg), np.asarray(dBg)
    nelem, nq, nprim = Bg.shape
    i, j = np.triu_indices(nprim)
    nijp = -(-len(i) // 8) * 8

    def half(x):
        out = np.zeros((nelem, nq, nijp))
        out[:, :, :len(i)] = x
        return out

    out = dict(ijs=(i << 16 | j).astype(np.int32), BBs=half(Bg[:, :, i] * Bg[:, :, j]),
               SSs=half(dBg[:, :, i] * Bg[:, :, j] + Bg[:, :, i] * dBg[:, :, j]),
               DDs=half(dBg[:, :, i] * dBg[:, :, j]))
    if d2Bg is not None:
        d2Bg = np.asarray(d2Bg)
        out["S2s"] = half(d2Bg[:, :, i] * Bg[:, :, j] + Bg[:, :, i] * d2Bg[:, :, j])
    return out


def _lapl_tables(arrays: Mapping[str, np.ndarray], pairs: np.ndarray) -> dict[str, np.ndarray]:
    """The laplacian tables of a grid: LLTT and TTmm made exactly symmetric,
    their live-pair rows LLTTp, TTmmp (the pairs of TT's tables: both are
    TT times a factor of the pair), and lfac checked. Raises ValueError
    unless lfac is [4, nelem, nq, nt] and finite."""
    lfac, w = np.asarray(arrays["lfac"]), np.asarray(arrays["w"])
    if lfac.shape != (4, *w.shape) or not np.isfinite(lfac).all():
        raise ValueError(f"lfac has shape {lfac.shape}, expected (4, {', '.join(map(str, w.shape))})"
                         " and finite values")
    out = {name: _upper_mirrored(arrays[name]) for name in _LAPL_ANGULAR}
    a, b = pairs[:, 0], pairs[:, 1]
    return {**out, **{f"{name}p": out[name][a, b] for name in _LAPL_ANGULAR}}


_INT_FIELDS = ("gidx", "pairs", "owners", "band", "ijs")


def _upper_mirrored(T: np.ndarray) -> np.ndarray:
    """T [nang, nang, nt] with its a <= b entries copied onto b > a."""
    T = np.asarray(T)
    upper = np.triu(np.ones(T.shape[:2], dtype=bool))[:, :, None]
    return np.where(upper, T, T.transpose(1, 0, 2))


def build_grid(cls, arrays: Mapping[str, np.ndarray], nrad: int, device):
    """A grid of NamedTuple type cls on `device` from its host tables
    (Bg, dBg, w, invh, TT, dTT, dTT2, TTm2, tfac, sqeta, gidx and whatever
    else cls carries; with lfac, also the laplacian tables d2Bg, LLTT and
    TTmm), with dTT2 and TTm2 (and LLTT, TTmm) made exactly symmetric and
    the pair and element tables added; nrad is the basis's radial size,
    which gidx's checks need. The fields cls has defaults for stay at them
    when their tables are not given (a grid without the laplacian). Raises
    ValueError unless tfac is [3, nelem, nq, nt] and finite (and lfac [4,
    nelem, nq, nt] and finite)."""
    check_gidx(arrays["gidx"], nrad)
    arrays = {**arrays, **{name: _upper_mirrored(arrays[name]) for name in ("dTT2", "TTm2")}}
    tfac, w = np.asarray(arrays["tfac"]), np.asarray(arrays["w"])
    if tfac.shape != (3, *w.shape) or not np.isfinite(tfac).all():
        raise ValueError(f"tfac has shape {tfac.shape}, expected (3, {', '.join(map(str, w.shape))})"
                         " and finite values")
    arrays = {**arrays, **pair_tables(*(arrays[n] for n in _ANGULAR), arrays["gidx"], nrad)}
    lapl = "lfac" in arrays
    if lapl:
        arrays = {**arrays, **_lapl_tables(arrays, arrays["pairs"])}
    arrays = {**arrays, **element_tables(arrays["Bg"], arrays["dBg"],
                                         arrays["d2Bg"] if lapl else None)}
    return cls(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=torch.int32 if name in _INT_FIELDS else torch.float64,
                           device=device)
        for name in cls._fields if name in arrays or name not in cls._field_defaults
    })
