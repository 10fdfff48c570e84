"""The shell-pair and element tables that the XC grid kernels dia_xc_fields
(K4) and dia_xc_fock (K5) read, shared by every grid that runs on them: the
diatomic grid (models/diatomic_dft.py), the atomic grid
(models/atomic_dft.py) and the spherically averaged atom's radial grid
(models/sadatom.py). Built once per grid on the host in numpy.
"""

from collections.abc import Mapping

import numpy as np
import torch

from helfem_tpu_torch.kernels import band_table, check_gidx, owner_table

__all__ = ["build_grid", "element_tables", "pair_tables"]


def pair_tables(TT: np.ndarray, dTT: np.ndarray, gidx: np.ndarray,
                nrad: int) -> dict[str, np.ndarray]:
    """The shell-pair tables of the XC kernels: the live pairs a <= b (TT or
    dTT not identically zero), their TT and dTT rows, the element slots
    covering each radial function and the run of radial indices those
    elements span.

    Raises ValueError unless TT and dTT are exactly symmetric in (a, b): the
    kernels fold (a, b) with (b, a) on that ground (D1[a,b] + D1[b,a] =
    B^T (W_ab + W_ba) B for the density windows W, and the Fock element
    block of (b, a) is that of (a, b))."""
    TT, dTT = np.asarray(TT), np.asarray(dTT)
    for name, T in (("TT", TT), ("dTT", dTT)):
        if not np.array_equal(T, T.transpose(1, 0, 2)):
            raise ValueError(f"{name} is not exactly symmetric in its two shell indices")
    live = np.triu((TT != 0).any(-1) | (dTT != 0).any(-1))
    a, b = np.nonzero(live)
    gidx = np.asarray(gidx)
    owners = owner_table(gidx, nrad)
    band = band_table(gidx, owners, nrad)
    return dict(pairs=np.stack([a, b], axis=1).astype(np.int32), TTp=TT[a, b], dTTp=dTT[a, b],
                owners=owners, band=band)


def element_tables(Bg: np.ndarray, dBg: np.ndarray) -> dict[str, np.ndarray]:
    """The products of the element functions that the XC Fock kernel
    contracts its pair potentials with, on the i <= j half (the element
    blocks are symmetric in (i, j))."""
    Bg, dBg = np.asarray(Bg), np.asarray(dBg)
    nelem, nq, nprim = Bg.shape
    i, j = np.triu_indices(nprim)
    nijp = -(-len(i) // 8) * 8
    BBs = np.zeros((nelem, nq, nijp))
    SSs = np.zeros((nelem, nq, nijp))
    BBs[:, :, :len(i)] = Bg[:, :, i] * Bg[:, :, j]
    SSs[:, :, :len(i)] = dBg[:, :, i] * Bg[:, :, j] + Bg[:, :, i] * dBg[:, :, j]
    return dict(ijs=(i << 16 | j).astype(np.int32), BBs=BBs, SSs=SSs)


_INT_FIELDS = ("gidx", "pairs", "owners", "band", "ijs")


def build_grid(cls, arrays: Mapping[str, np.ndarray], nrad: int, device):
    """A grid of NamedTuple type cls on `device` from its host tables
    (Bg, dBg, w, invh, TT, dTT, sqeta, gidx and whatever else cls carries),
    with the pair and element tables added; nrad is the basis's radial
    size, which gidx's checks need."""
    check_gidx(arrays["gidx"], nrad)
    arrays = {**arrays, **pair_tables(arrays["TT"], arrays["dTT"], arrays["gidx"], nrad),
              **element_tables(arrays["Bg"], arrays["dBg"])}
    return cls(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=torch.int32 if name in _INT_FIELDS else torch.float64,
                           device=device)
        for name in cls._fields
    })
