"""Model potentials on the diatomic (mu, eta) quadrature grid, the
finite-nucleus attraction and the SAP/GSZ/TF guess Hamiltonian of two
atoms, ported from helfem_tpu/models/diatomic_tools.py
(potential_matrix_dia, finite_nucleus_Vnuc and guess_hamiltonian_dia; host
numpy on the grid tables of build_dia_grid).
"""

import numpy as np
import torch

from helfem_tpu_torch.models.atomic import nuclear_model_V
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.diatomic_dft import DiaGridOps, build_dia_grid
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.scf.guess import potential

__all__ = ["potential_matrix_dia", "finite_nucleus_Vnuc", "guess_hamiltonian_dia"]


def potential_matrix_dia(basis: DiatomicBasis, g: DiaGridOps, V) -> np.ndarray:
    """<chi_A | V | chi_B> for a phi-independent potential V(r1, r2) of the
    two focus distances (reference: TwoDGridWorker::model_potential,
    twodquadrature.cpp)."""
    neta = g.TT.shape[-1]
    etav, _ = gauss_legendre(neta)
    Rh = basis.Rhalf
    xi = np.cosh(basis.mu)
    r1 = Rh * (xi[:, :, None] + etav[None, None, :])
    r2 = Rh * (xi[:, :, None] - etav[None, None, :])
    Vg = V(r1, r2)
    w = g.w.cpu().numpy()
    A1 = np.einsum("eqt,abt->abeq", w * Vg, g.TT.cpu().numpy(), optimize=True)
    Vel = np.einsum("abeq,eqi,eqj->abeij", A1, basis.B, basis.B, optimize=True)
    nang, nrad = basis.nang, basis.nrad
    gi = basis.fem.gidx
    out = np.zeros((nang, nang, nrad + 1, nrad + 1))
    for e in range(basis.fem.nelem):
        out[:, :, gi[e][:, None], gi[e][None, :]] += Vel[:, :, e]
    out = out[:, :, :nrad, :nrad].transpose(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)
    m2 = basis.shell_mask().reshape(-1)
    return out * m2[:, None] * m2[None, :]


def finite_nucleus_Vnuc(basis: DiatomicBasis, model: str, Rrms1: float, Rrms2: float,
                        g: DiaGridOps | None = None) -> np.ndarray:
    """Nuclear attraction of finite-nucleus charge models on the 2D (mu,
    eta) quadrature grid (diatomic_tools.py:53-71; reference:
    src/diatomic/main.cpp:492-514, qgrid.model_potential(pot1, pot2)): model
    'gaussian', 'spherical', 'hollow' or 'regularized', Rrms1/Rrms2 the
    nuclei's rms radii. The grid tables are made on the host unless g is
    given."""
    if g is None:
        g = build_dia_grid(basis, torch.device("cpu"))
    V1 = nuclear_model_V(model, basis.Z1, Rrms1) if basis.Z1 > 0 else (lambda r: 0.0 * r)
    V2 = nuclear_model_V(model, basis.Z2, Rrms2) if basis.Z2 > 0 else (lambda r: 0.0 * r)
    return potential_matrix_dia(basis, g, lambda r1, r2: V1(r1) + V2(r2))


def guess_hamiltonian_dia(basis: DiatomicBasis, kind: str, device) -> np.ndarray:
    """T + the sum of the two atoms' screened-nucleus potentials on the 2D
    grid (reference: src/diatomic/main.cpp:654-701). The grid tables are
    made on the host; a SAP atom is solved on `device`."""
    g = build_dia_grid(basis, torch.device("cpu"))
    V1 = potential(kind, basis.Z1, device=device) if basis.Z1 > 0 else (lambda r: 0.0 * r)
    V2 = potential(kind, basis.Z2, device=device) if basis.Z2 > 0 else (lambda r: 0.0 * r)
    Vmat = potential_matrix_dia(basis, g, lambda r1, r2: V1(r1) + V2(r2))
    m = basis.shell_mask().reshape(-1)
    return basis.kinetic() * np.outer(m, m) + Vmat
