"""Model potentials on the diatomic (mu, eta) quadrature grid, the
finite-nucleus attraction, the SAP/GSZ/TF guess Hamiltonian of two atoms,
the post-SCF analysis (the density at points and at the nuclei, the
orbitals' radial moments), the density along the axis and on a (z, rho)
grid (the diatomic_dline and diatomic_dgrid programs) and the core-basis
scan (diatomic_cbasis), ported from helfem_tpu/models/diatomic_tools.py.
Host numpy on the basis and on the grid tables of build_dia_grid; the
density's contraction at points and the core Hamiltonian's eigensolves run
in torch on the caller's device.
"""

import numpy as np
import torch

from helfem_tpu_torch.models.atomic import nuclear_model_V
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.diatomic_dft import DiaGridOps, build_dia_grid
from helfem_tpu_torch.ops.quadrature import gauss_legendre
from helfem_tpu_torch.ops.spherical import legendre_Pbar
from helfem_tpu_torch.scf.guess import potential

__all__ = ["potential_matrix_dia", "finite_nucleus_Vnuc", "guess_hamiltonian_dia",
           "eval_density_points", "nuclear_densities_dia", "occupied_orbital_vectors_dia",
           "orbital_moments_dia", "density_line", "density_grid", "num_orbs",
           "core_channel_energies", "core_basis_scan"]


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


def _shell_Pbar(basis: DiatomicBasis, eta: np.ndarray) -> np.ndarray:
    """[nang, len(eta)] normalised Legendre Pbar_l^|m|(eta) of each shell."""
    Pb = legendre_Pbar(int(basis.lval.max()), eta)
    return np.stack([Pb[basis.lval[a], abs(basis.mval[a])] for a in range(basis.nang)])


def _point_to_prolate(basis: DiatomicBasis, z, rho):
    """(mu, eta) of the cylindrical points (z, rho)."""
    Rh = basis.Rhalf
    r1 = np.sqrt(rho**2 + (z + Rh) ** 2)
    r2 = np.sqrt(rho**2 + (z - Rh) ** 2)
    xi = np.clip((r1 + r2) / (2 * Rh), 1.0, None)
    eta = np.clip((r1 - r2) / (2 * Rh), -1.0, 1.0)
    return np.arccosh(xi), eta


def eval_density_points(basis: DiatomicBasis, P: np.ndarray, z, rho,
                        device=None) -> np.ndarray:
    """Electron density at the cylindrical points (z, rho) of the m-block-
    diagonal density P (helfem_tpu diatomic_tools.py:97-130): the basis
    values at the points on the host, their contraction with the same-m
    blocks of P on `device` (None: the CPU)."""
    z = np.atleast_1d(np.asarray(z, dtype=float))
    rho = np.broadcast_to(np.atleast_1d(np.asarray(rho, dtype=float)), z.shape)
    mu, eta = _point_to_prolate(basis, z, rho)
    nang, nrad = basis.nang, basis.nrad
    fem = basis.fem
    Bv = np.zeros((len(z), nrad + 1))
    eidx = np.clip(np.searchsorted(fem.bval, mu, side="right") - 1, 0, fem.nelem - 1)
    for k, e in enumerate(eidx):
        x = (mu[k] - fem.mids[e]) / (0.5 * fem.lengths[e])
        Bv[k][fem.gidx[e]] += fem.eval_element(e, np.array([x]), 0)[0][0]
    Bv = Bv[:, :nrad]
    Th = torch.as_tensor(_shell_Pbar(basis, eta), device=device)
    Bm = torch.as_tensor(Bv[None] * basis.shell_mask()[:, None, :], device=device)
    same_m = torch.as_tensor(basis.mval[:, None] == basis.mval[None, :], device=device)
    P4 = torch.as_tensor(np.asarray(P, dtype=float), device=device).reshape(nang, nrad, nang,
                                                                             nrad)
    W = torch.einsum("akI,aIbJ,bkJ->abk", Bm, P4, Bm)  # [nang, nang, npts]
    dens = torch.einsum("abk,ak,bk->k", W * same_m[:, :, None], Th, Th)
    return dens.cpu().numpy()


def orbital_moments_dia(basis: DiatomicBasis, c: np.ndarray) -> dict:
    """Radial moments of one orbital |phi|^2 about the left and right
    nuclei and the centre (helfem_tpu diatomic_tools.py:256-300; reference:
    TwoDBasis::radial_moments, src/diatomic/main.cpp:1033-1086). c is a
    full-basis vector [nbf] of one m channel. Returns {'left': {n: <r_l^n>},
    'right': ..., 'center': {2: <r_c^2>}} for n in (-1, 1, 2, 3); in prolate
    coordinates r_{l,r} = Rh (cosh mu +- eta), so the moments are quadrature
    sums."""
    nang, nrad = basis.nang, basis.nrad
    eta, weta = gauss_legendre(2 * int(basis.lval.max()) + 16)
    Th = _shell_Pbar(basis, eta)
    cpad = np.zeros((nang, nrad + 1))
    cpad[:, :nrad] = c.reshape(nang, nrad) * basis.shell_mask()
    phi_mu = np.einsum("eqi,aei->aeq", basis.B, cpad[:, basis.fem.gidx])
    F = np.einsum("aeq,at->eqt", phi_mu, Th)
    ch = np.cosh(basis.mu)
    w3 = (ch[:, :, None] ** 2 - eta[None, None, :] ** 2) * (
        np.sinh(basis.mu) * basis.wmu)[:, :, None] * weta[None, None, :]
    dens = F * F * w3
    norm = dens.sum()
    Rh = basis.Rhalf
    r_l = Rh * (ch[:, :, None] + eta[None, None, :])
    r_r = Rh * (ch[:, :, None] - eta[None, None, :])
    rc2 = Rh**2 * (ch[:, :, None] ** 2 + eta[None, None, :] ** 2 - 1.0)
    out = {"left": {}, "right": {}, "center": {}}
    for n in (-1, 1, 2, 3):
        out["left"][n] = float((dens * r_l**n).sum() / norm)
        out["right"][n] = float((dens * r_r**n).sum() / norm)
    out["center"][2] = float((dens * rc2).sum() / norm)
    return out


def nuclear_densities_dia(basis: DiatomicBasis, P: np.ndarray) -> tuple[float, float]:
    """Electron density at the two nuclei (helfem_tpu diatomic_tools.py:
    303-309; reference: TwoDBasis::nuclear_density, src/diatomic/main.cpp:
    1024-1031), a relative 1e-7 of Rh off the axis point."""
    eps = 1e-7
    z = np.array([-basis.Rhalf * (1.0 - eps), basis.Rhalf * (1.0 - eps)])
    n = eval_density_points(basis, P, z, np.full(2, basis.Rhalf * eps))
    return float(n[0]), float(n[1])


def occupied_orbital_vectors_dia(basis: DiatomicBasis, orbs, occ, E_blocks):
    """The occupied block orbitals as full-basis vectors, sorted by
    eigenvalue: [(E, occ, c [nbf]), ...] (helfem_tpu diatomic_tools.py:
    312-333). The blocks are the g/u-split ones or the merged ones, by
    their count."""
    orbs = np.asarray(orbs)
    blocks = next((b for b in (basis.sym_blocks(True), basis.sym_blocks(False))
                   if len(b) == orbs.shape[0]), None)
    if blocks is None:
        raise ValueError("orbital block count matches no symmetry setup")
    out = []
    for b, idx in enumerate(blocks):
        for k in range(np.asarray(occ).shape[1]):
            if occ[b][k] <= 0:
                continue
            c = np.zeros(basis.nbf)
            c[idx] = orbs[b][:len(idx), k]
            out.append((float(E_blocks[b][k]), float(occ[b][k]), c))
    out.sort(key=lambda t: t[0])
    return out


def density_line(basis: DiatomicBasis, P: np.ndarray, npts: int = 200, zmax: float = None,
                 device=None):
    """Density along the internuclear axis (reference: diatomic_dline,
    src/diatomic/density_line.cpp; helfem_tpu diatomic_tools.py:133-140).
    Returns (z, n(z)); zmax None: 3 Rh."""
    if zmax is None:
        zmax = 3.0 * basis.Rhalf
    z = np.linspace(-zmax, zmax, npts)
    return z, eval_density_points(basis, P, z, np.zeros_like(z) + 1e-9, device)


def density_grid(basis: DiatomicBasis, P: np.ndarray, nz: int = 100, nrho: int = 50,
                 zmax: float = None, rhomax: float = None, device=None):
    """Density on a (z, rho) half-plane grid (reference: diatomic_dgrid;
    helfem_tpu diatomic_tools.py:143-155). Returns (z, rho, n[nz, nrho]);
    zmax None: 3 Rh, rhomax None: 2 Rh."""
    if zmax is None:
        zmax = 3.0 * basis.Rhalf
    if rhomax is None:
        rhomax = 2.0 * basis.Rhalf
    z = np.linspace(-zmax, zmax, nz)
    rho = np.linspace(1e-9, rhomax, nrho)
    Z, R = np.meshgrid(z, rho, indexing="ij")
    n = eval_density_points(basis, P, Z.ravel(), R.ravel(), device).reshape(nz, nrho)
    return z, rho, n


# Z at which each new (n,l) shell opens in the Madelung filling order, with
# its l (helfem_tpu diatomic_tools.py:163-171)
_SHELL_OPEN = [
    (1, 0), (3, 0), (5, 1), (11, 0), (13, 1), (19, 0), (21, 2), (31, 1),
    (37, 0), (39, 2), (49, 1), (55, 0), (57, 3), (71, 2), (81, 1), (87, 0),
    (89, 3), (103, 2), (113, 1),
]


def num_orbs(Z1: int, Z2: int) -> list[int]:
    """Occupied orbitals per m-type (sigma, pi, delta, phi) in the
    separated-atom limit (reference: num_orbs, src/general/elements.cpp:
    48-79): each open (n,l) shell of either atom gives one orbital to every
    m-type <= l."""
    counts = [0, 0, 0, 0]
    for Z in (Z1, Z2):
        for z0, l in _SHELL_OPEN:
            if Z >= z0:
                for m in range(l + 1):
                    counts[m] += 1
    while counts and counts[-1] == 0:
        counts.pop()
    return counts


def core_channel_energies(basis: DiatomicBasis, norb_per_m: dict, device=None) -> dict:
    """{m: the sum of the lowest norb core-Hamiltonian eigenvalues of the
    |m| = m channel}, from the generalized symmetric eigensolve on the
    masked channel subspace (helfem_tpu diatomic_tools.py:193-212, there
    scipy.linalg.eigh), here through the Cholesky factor of the overlap on
    `device` (None: the CPU)."""
    H0 = basis.kinetic() + basis.nuclear()
    S = basis.overlap()
    mask = basis.shell_mask().reshape(-1) > 0
    mrow = np.repeat(basis.mval, basis.nrad)
    out = {}
    for m, norb in norb_per_m.items():
        idx = np.nonzero(mask & (mrow == m))[0]
        L = torch.linalg.cholesky(torch.as_tensor(S[np.ix_(idx, idx)], device=device))
        Hs = torch.as_tensor(H0[np.ix_(idx, idx)], device=device)
        A = torch.linalg.solve_triangular(L, Hs, upper=False)
        A = torch.linalg.solve_triangular(L, A.T, upper=False)
        w = torch.linalg.eigvalsh(0.5 * (A + A.T))
        out[m] = float(w[:norb].sum())
    return out


def core_basis_scan(Z1: int, Z2: int, Rbond: float, thresh: int = 8, nadd: int = 2,
                    rmax: float = 40.0, nelem: int = 1, nnodes: int = 15, igrid: int = 4,
                    zexp: float = 1.0, verbose: bool = False, device=None):
    """The per-m lmax that converges the occupied core orbitals to each of
    the thresholds 1e-1 .. 1e-thresh (reference: corebasis.cpp main loop;
    helfem_tpu diatomic_tools.py:215-253), the eigensolves on `device`.
    Returns [(threshold, lmax per m-type tuple)]."""
    norbs = num_orbs(Z1, Z2)
    nm = len(norbs)
    lmax = list(range(nm))  # minimal start: one function per channel
    results = []

    def energies(lm):
        b = DiatomicBasis(Z1=Z1, Z2=Z2, Rbond=Rbond, lmax=tuple(lm), rmax=rmax, nelem=nelem,
                          nnodes=nnodes, igrid=igrid, zexp=zexp)
        return core_channel_energies(b, {m: norbs[m] for m in range(nm)}, device)

    E = energies(lmax)
    for ithr in range(1, thresh + 1):
        thr = 10.0 ** (-ithr)
        for m in range(nm - 1, -1, -1):
            while lmax[m] < 60:
                trial = list(lmax)
                trial[m] += nadd
                # channels are nested: lmax must not increase with m-type
                for mm in range(m):
                    trial[mm] = max(trial[mm], trial[m])
                Et = energies(trial)
                dE = E[m] - Et[m]
                if verbose:
                    print(f"thr=1e-{ithr} m={m}: lmax {lmax[m]} -> {trial[m]}, dE = {dE:.3e}")
                if abs(dE) < thr:
                    break
                lmax = trial
                E = Et
        results.append((thr, tuple(lmax)))
    return results
