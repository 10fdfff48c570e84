"""Initial-guess model potentials (L7), carried over from
helfem_tpu/scf/guess.py: core, Thomas-Fermi, GSZ and SAP.

Screened-nucleus effective charges Z_eff(r); guess Hamiltonian is
T - Z_eff(r)/r (reference: src/general/{gsz,sap,model_potential}.cpp).

* Thomas-Fermi: analytic fit of the TF screening function
  (arXiv physics/0511017; reference: gsz.cpp Z_thomasfermi).
* GSZ (Green-Sellin-Zachor): analytic form with the d_Z parameters of
  Green 1969 (reference: gsz.cpp).
* SAP (superposition of atomic potentials): the reference ships a tabulated
  Z_eff(r) generated by its own `gensap` program; here the table is
  regenerated by the port's sadatom solver (models/sadatom.py), on the
  device the caller names, once per element and process.
"""

import numpy as np

__all__ = ["Z_thomasfermi", "Z_gsz", "Z_sap", "potential"]

# Green 1969 d_Z parameters, Z = 0..103 (published data table)
_D_GSZ = np.array([
    1.00, 0.215, 0.563, 0.858, 0.979, 0.880, 0.776, 0.708, 0.575, 0.500,
    0.561, 0.621, 0.729, 0.817, 0.868, 0.885, 0.881, 0.862, 1.006, 1.154,
    1.116, 1.060, 0.996, 0.837, 0.866, 0.807, 0.751, 0.700, 0.606, 0.612,
    0.631, 0.649, 0.663, 0.675, 0.684, 0.689, 0.744, 0.798, 0.855, 0.866,
    0.831, 0.825, 0.855, 0.803, 0.788, 0.737, 0.754, 0.775, 0.810, 0.841,
    0.870, 0.896, 0.919, 0.940, 1.022, 1.108, 1.150, 1.081, 0.970, 0.938,
    0.905, 0.873, 0.842, 0.862, 0.830, 0.754, 0.728, 0.702, 0.677, 0.654,
    0.665, 0.672, 0.676, 0.679, 0.680, 0.680, 0.679, 0.661, 0.657, 0.671,
    0.690, 0.708, 0.726, 0.744, 0.761, 0.777, 0.818, 0.859, 0.899, 0.927,
    0.887, 0.880, 0.872, 0.832, 0.822, 0.842, 0.830, 0.790, 0.778, 0.766,
    0.754, 0.742, 0.755,
])


def Z_thomasfermi(r: np.ndarray, Z: int) -> np.ndarray:
    alpha, beta, gamma = 0.7280642371, -0.5430794693, 0.3612163121
    x = r * np.cbrt(128.0 * Z / (9.0 * np.pi**2))
    sx = np.sqrt(x)
    return Z * (1.0 + alpha * sx + beta * x * np.exp(-gamma * sx)) ** 2 * np.exp(-2.0 * alpha * sx)


def Z_gsz(r: np.ndarray, Z: int) -> np.ndarray:
    if Z >= len(_D_GSZ):
        raise ValueError(f"no GSZ parameters for Z={Z}")
    d = _D_GSZ[Z]
    H = d * (Z - 1) ** 0.4 if Z > 1 else d
    return 1.0 + (Z - 1) / (1.0 + (np.exp(r / d) - 1.0) * H)


_SAP_CACHE: dict[int, tuple] = {}


def Z_sap(r: np.ndarray, Z: int, device) -> np.ndarray:
    """SAP effective charge, generated on demand by solving the spherically
    averaged atom with exchange-only LDA on `device` (the construction of
    the reference's sap.cpp table; see models/sadatom.sap_potential_table)
    and linearly interpolated, with a 40-bohr cutoff like the reference
    (sap.cpp:33-47)."""
    if Z not in _SAP_CACHE:
        from helfem_tpu_torch.models.sadatom import sap_potential_table

        rt, zt, _ = sap_potential_table(Z, method="lda_x", lmax=min(3, 2 if Z <= 20 else 3),
                                        device=device)
        _SAP_CACHE[Z] = (rt, zt)
    rt, zt = _SAP_CACHE[Z]
    out = np.interp(r, rt, zt, left=float(Z), right=0.0)
    return np.where(r > 40.0, 0.0, out)


def potential(kind: str, Z: int, device=None):
    """V(r) callable: -Z_eff(r)/r. kind in {'core','TF','GSZ','SAP'}; SAP
    solves its atom on `device` (the caller's operators' device) at the
    first call for Z."""
    if kind == "core":
        return lambda r: -Z / r
    if kind == "TF":
        return lambda r: -Z_thomasfermi(r, Z) / r
    if kind == "GSZ":
        return lambda r: -Z_gsz(r, Z) / r
    if kind == "SAP":
        if device is None:
            raise ValueError("the SAP guess needs the device to solve its atom on")
        return lambda r: -Z_sap(r, Z, device) / r
    raise ValueError(f"unknown guess {kind}")
