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


def element_tables(Bg: np.ndarray, dBg: np.ndarray) -> dict[str, np.ndarray]:
    """The products of the element functions that the XC Fock kernel
    contracts its pair potentials with, on the i <= j half (the element
    blocks are symmetric in (i, j)): B_i B_j, dB_i B_j + B_i dB_j and
    dB_i dB_j (tau)."""
    Bg, dBg = np.asarray(Bg), np.asarray(dBg)
    nelem, nq, nprim = Bg.shape
    i, j = np.triu_indices(nprim)
    nijp = -(-len(i) // 8) * 8
    BBs = np.zeros((nelem, nq, nijp))
    SSs = np.zeros((nelem, nq, nijp))
    DDs = np.zeros((nelem, nq, nijp))
    BBs[:, :, :len(i)] = Bg[:, :, i] * Bg[:, :, j]
    SSs[:, :, :len(i)] = dBg[:, :, i] * Bg[:, :, j] + Bg[:, :, i] * dBg[:, :, j]
    DDs[:, :, :len(i)] = dBg[:, :, i] * dBg[:, :, j]
    return dict(ijs=(i << 16 | j).astype(np.int32), BBs=BBs, SSs=SSs, DDs=DDs)


_INT_FIELDS = ("gidx", "pairs", "owners", "band", "ijs")


def _upper_mirrored(T: np.ndarray) -> np.ndarray:
    """T [nang, nang, nt] with its a <= b entries copied onto b > a."""
    T = np.asarray(T)
    upper = np.triu(np.ones(T.shape[:2], dtype=bool))[:, :, None]
    return np.where(upper, T, T.transpose(1, 0, 2))


def build_grid(cls, arrays: Mapping[str, np.ndarray], nrad: int, device):
    """A grid of NamedTuple type cls on `device` from its host tables
    (Bg, dBg, w, invh, TT, dTT, dTT2, TTm2, tfac, sqeta, gidx and whatever
    else cls carries), with dTT2 and TTm2 made exactly symmetric and the
    pair and element tables added; nrad is the basis's radial size, which
    gidx's checks need. Raises ValueError unless tfac is [3, nelem, nq, nt]
    and finite."""
    check_gidx(arrays["gidx"], nrad)
    arrays = {**arrays, **{name: _upper_mirrored(arrays[name]) for name in ("dTT2", "TTm2")}}
    tfac, w = np.asarray(arrays["tfac"]), np.asarray(arrays["w"])
    if tfac.shape != (3, *w.shape) or not np.isfinite(tfac).all():
        raise ValueError(f"tfac has shape {tfac.shape}, expected (3, {', '.join(map(str, w.shape))})"
                         " and finite values")
    arrays = {**arrays, **pair_tables(*(arrays[n] for n in _ANGULAR), arrays["gidx"], nrad),
              **element_tables(arrays["Bg"], arrays["dBg"])}
    return cls(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=torch.int32 if name in _INT_FIELDS else torch.float64,
                           device=device)
        for name in cls._fields
    })
