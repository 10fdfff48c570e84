"""Atomic two-dimensional basis chi_{nlm} = b_n(r) Y_lm(theta, phi) (L5),
ported from helfem_tpu/models/atomic.py.

* The full basis index is angular-major: bf = a * nrad + n for angular shell a
  (with quantum numbers l_a, m_a) and radial function n.
* One-electron operators are Kronecker-structured: S = I_ang (x) S_rad, etc.,
  built on the host in numpy exactly as helfem_tpu builds them.
* The Coulomb and exchange builds (the SCF hot path, reference
  TwoDBasis.cpp:817-1150) contract the density against the exact Gaunt
  tensor with torch.einsum and hand the radial work to the CUDA kernels
  radial_coulomb and radial_exchange (kernels/), which run their plain
  PyTorch versions on CPU tensors.
* The range-separated exchange: the Yukawa part through radial_exchange on
  the Yukawa tables, the erfc part through radial_erfc_exchange on the
  dense element-pair tables.
* The exchange of a density with cross-channel blocks (symmetry 0 and 1:
  fields and off-centre nuclei) runs the same kernels on the channel-pair
  windows P4[a, d], a != d included (exchange_general and its erfc form).
* The one-electron field, confinement, finite-nucleus and off-centre
  nucleus operators, and the grid variants of form_grid, on the host.
* zeroder drops the derivative DOF at rmax too (Hermite bases); an
  explicit bval (a checkpoint's element boundaries) replaces form_grid.
"""

import math
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from helfem_tpu_torch.kernels import (
    check_gidx,
    radial_coulomb,
    radial_erfc_exchange,
    radial_exchange,
)
from helfem_tpu_torch.ops.fem import FEMBasis
from helfem_tpu_torch.ops.gaunt import cosk_coupling, gaunt_coefficient, gaunt_table, sine2_coupling
from helfem_tpu_torch.ops.grids import form_grid
from helfem_tpu_torch.ops.gygi import gygi_V
from helfem_tpu_torch.ops.polynomials import get_basis
from helfem_tpu_torch.ops.radial import RadialBasis

__all__ = ["angular_basis", "AtomicBasis", "AtomicOperators", "ErfcOperators", "RSOperators",
           "channel_pairs", "confinement_Vr", "coulomb", "erfc_exchange", "erfc_exchange_bd",
           "exchange", "exchange_bd", "exchange_general", "from_jax_operators",
           "from_jax_rs_operators", "nuclear_model_V", "rs_exchange", "rs_exchange_bd"]


def angular_basis(lmax: int, mmax: int):
    """Angular shell enumeration (reference: src/atomic/basis.cpp:174-198):
    ordered by |m| then l, with +m before -m."""
    lval, mval = [], []
    for mabs in range(mmax + 1):
        for l in range(mabs, lmax + 1):
            lval.append(l)
            mval.append(mabs)
            if mabs > 0:
                lval.append(l)
                mval.append(-mabs)
    return np.array(lval), np.array(mval)


class AtomicOperators(NamedTuple):
    """Device constants of the SCF hot path (fields as helfem_tpu's
    AtomicOperators). nang/nrad are read from G.shape[-1] and
    Sinvh_rad.shape[0]."""

    gidx: torch.Tensor  # [nelem, nprim] int32, trash slot = nrad
    G: torch.Tensor  # [NL, NM, nang, nang] Gaunt tensor
    Lfac: torch.Tensor  # [NL] = 4 pi / (2L+1)
    tei: torch.Tensor  # [NL, nelem, nprim, nprim, nprim, nprim]
    disjL: torch.Tensor  # [NL, nelem, nprim, nprim]
    disjm1L: torch.Tensor  # [NL, nelem, nprim, nprim]
    S: torch.Tensor  # [nbf, nbf]
    H0: torch.Tensor  # [nbf, nbf]
    T: torch.Tensor  # [nbf, nbf]
    Vnuc: torch.Tensor  # [nbf, nbf]
    Sinvh_rad: torch.Tensor  # [nrad, nrad]

    @property
    def device(self) -> torch.device:
        return self.S.device

    def to(self, device) -> "AtomicOperators":
        return AtomicOperators(*(t.to(device) for t in self))


def from_jax_operators(arrays: Mapping[str, np.ndarray], device) -> AtomicOperators:
    """The port's operators from helfem_tpu's AtomicOperators fields given as
    numpy arrays (e.g. {k: np.asarray(v) for k, v in ops._asdict().items()})."""
    gidx = np.asarray(arrays["gidx"])
    check_gidx(gidx, np.asarray(arrays["Sinvh_rad"]).shape[0])
    fields = {}
    for name in AtomicOperators._fields:
        dtype = torch.int32 if name == "gidx" else torch.float64
        fields[name] = torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
    return AtomicOperators(**fields)


class RSOperators(NamedTuple):
    """Range-separated (Yukawa) exchange tables (helfem_tpu's RSOperators)."""

    tei: torch.Tensor  # [NL, nelem, np, np, np, np] Yukawa in-element
    iL: torch.Tensor  # [NL, nelem, np, np] <i_L(lam r)> small side
    kL: torch.Tensor  # [NL, nelem, np, np] <k_L(lam r)> big side
    Lfac: torch.Tensor  # [NL] = 4 pi lam


class ErfcOperators(NamedTuple):
    """erfc short-range exchange tables, dense over element pairs
    (helfem_tpu's ErfcOperators)."""

    tei: torch.Tensor  # [NL, nelem, nelem, np, np, np, np]
    Lfac: torch.Tensor  # [NL] = 4 pi mu / (2L+1)


def from_jax_rs_operators(arrays: Mapping[str, np.ndarray], device):
    """The port's ErfcOperators or RSOperators (by the fields present) from
    helfem_tpu's given as numpy arrays."""
    kind = RSOperators if "iL" in arrays else ErfcOperators
    return kind(*(torch.tensor(np.asarray(arrays[name]), dtype=torch.float64, device=device)
                  for name in kind._fields))


def confinement_Vr(r: np.ndarray, rmax: float, N, R: float, iconf: int = 1,
                   shift: float = 0.0) -> np.ndarray:
    """Confinement potentials on radial points (helfem_tpu atomic.py:69-106;
    reference: RadialBasis.cpp:361-455): 1 polynomial ((r-shift)/R)^N, 2
    exponential N! (e^x - sum_{k<N} x^k/k!) with x = (r-shift)/R, 3 barrier
    V0 theta(r-R) (N is the height V0), 4 Junquera V0
    e^{-(rmax-shift)/(r-shift)} / (rmax-r)^N (V0 in the R slot), capped at
    1e8 so that quadrature points at or past rmax give a huge finite wall."""
    if iconf == 1:
        Vr = np.where(r > shift, ((r - shift) / R) ** int(N), 0.0)
    elif iconf == 2:
        x = np.where(r > shift, (r - shift) / R, 0.0)
        s = np.zeros_like(x)
        fact = 1.0
        xk = np.ones_like(x)
        for k in range(int(N)):
            s += xk / fact
            fact *= k + 1
            xk = xk * x
        Vr = np.where(r > shift, fact * (np.exp(x) - s), 0.0)
    elif iconf == 3:
        Vr = np.where(r > R, float(N), 0.0)
    elif iconf == 4:
        with np.errstate(over="ignore", divide="ignore"):
            Vr = np.where(
                r > shift,
                R * np.exp(-(rmax - shift) / np.maximum(r - shift, 1e-300))
                / np.maximum(rmax - r, 1e-300) ** int(N),
                0.0,
            )
        Vr = np.minimum(Vr, 1e8)
    else:
        raise NotImplementedError(f"confinement type {iconf}")
    return Vr


def nuclear_model_V(model: str, Z: float, Rrms: float):
    """V(r) callable of a finite-nucleus charge model (helfem_tpu
    atomic.py:109-140; reference: libhelfem {Gaussian,Spherical,Hollow,
    Regularized}Nucleus.cpp): 'point', 'gaussian', 'spherical', 'hollow' or
    'regularized'; Rrms is the rms charge radius (the Gygi width a for
    'regularized')."""
    if model == "point":
        return lambda r: -Z / r
    if model == "gaussian":
        mu = math.sqrt(1.5) / Rrms
        erf = np.vectorize(math.erf)
        return lambda r: -Z * erf(mu * r) / r
    if model == "spherical":
        # uniformly charged ball (Visscher-Dyall 1997 eq. 7)
        R0 = math.sqrt(5.0 / 3.0) * Rrms
        return lambda r: np.where(r >= R0, -Z / r, -Z * (3.0 - (r / R0) ** 2) / (2.0 * R0))
    if model == "hollow":
        return lambda r: np.where(r >= Rrms, -Z / r, -Z / Rrms)
    if model == "regularized":
        return lambda r: gygi_V(Z, Rrms, r)
    raise ValueError(model)


@dataclass
class AtomicBasis:
    """Host-side setup: builds all constant tensors for an atomic calculation
    (helfem_tpu's AtomicBasis). nelem0 > 0 adds the finite-nucleus sub-grid
    (with finitenuc/Rrms) or the off-centre sections (with Zl/Zr/Rmid);
    conf_boundary inserts an element boundary at the confinement onset
    (ops/grids.py:form_grid; reference: src/atomic/basis.cpp:56-167).
    zeroder drops the derivative DOF at rmax too (Hermite bases; reference
    --zeroder); bval, when given, are the element boundaries, and nelem and
    rmax follow from them (helfem_tpu atomic.py:165-192)."""

    Z: int
    lmax: int
    mmax: int
    rmax: float = 40.0
    nelem: int = 10
    nnodes: int = 15
    nquad: int = 0
    igrid: int = 4
    zexp: float = 2.0
    primbas: int = 4
    finitenuc: str = "point"
    Rrms: float = 0.0
    nelem0: int = 0
    igrid0: int = 2
    zexp0: float = 2.0
    Zl: int = 0
    Zr: int = 0
    Rmid: float = 0.0
    conf_boundary: float = 0.0
    zeroder: bool = False
    bval: np.ndarray | None = None

    lval: np.ndarray = field(init=False)
    mval: np.ndarray = field(init=False)
    rb: RadialBasis = field(init=False)

    def __post_init__(self):
        self.lval, self.mval = angular_basis(self.lmax, self.mmax)
        poly = get_basis(self.primbas, self.nnodes)
        if self.nquad == 0:
            self.nquad = 5 * self.nnodes
        if self.bval is not None:
            bval = np.asarray(self.bval, dtype=float)
            self.nelem = len(bval) - 1
            self.rmax = float(bval[-1])
        else:
            bval = form_grid(self.finitenuc, self.Rrms, self.nelem, self.rmax, self.igrid,
                             self.zexp, self.nelem0, self.igrid0, self.zexp0, self.Z, self.Zl,
                             self.Zr, self.Rmid, self.conf_boundary)
        fem = FEMBasis(poly, bval, drop_first=True, drop_last=True,
                       drop_last_deriv=self.zeroder)
        self.rb = RadialBasis(fem, self.nquad)

    # --- sizes ---------------------------------------------------------------
    @property
    def nang(self) -> int:
        return len(self.lval)

    @property
    def nrad(self) -> int:
        return self.rb.fem.nbf

    @property
    def nbf(self) -> int:
        return self.nang * self.nrad

    @property
    def NL(self) -> int:
        return 2 * int(self.lval.max()) + 1

    # --- one-electron operators (host, setup-time) ----------------------------
    def overlap(self) -> np.ndarray:
        return np.kron(np.eye(self.nang), self.rb.overlap())

    def kinetic(self) -> np.ndarray:
        Trad = self.rb.kinetic()
        Tl = self.rb.kinetic_l()
        ll1 = self.lval * (self.lval + 1.0)
        blocks = Trad[None, :, :] + ll1[:, None, None] * Tl[None, :, :]
        return _blockdiag(blocks)

    def nuclear(self) -> np.ndarray:
        return np.kron(np.eye(self.nang), self.Z * self.rb.nuclear())

    def model_potential(self, V) -> np.ndarray:
        """Guess Hamiltonian potential from V(r) callable (spherical)."""
        Vr = V(self.rb.r)
        return np.kron(np.eye(self.nang), self.rb.model_potential(Vr))

    # --- field, confinement and nuclear-model operators (atomic.py:230-316) ----
    def _angular_matrix(self, coupling) -> np.ndarray:
        """[nang, nang] table of an angular coupling function (la,ma,lb,mb)."""
        A = np.zeros((self.nang, self.nang))
        for a in range(self.nang):
            for b in range(self.nang):
                A[a, b] = coupling(int(self.lval[a]), int(self.mval[a]), int(self.lval[b]),
                                   int(self.mval[b]))
        return A

    def dipole_z(self) -> np.ndarray:
        """<z> = <r cos theta> (reference: TwoDBasis::dipole_z,
        src/atomic/TwoDBasis.cpp:508-545)."""
        A = self._angular_matrix(lambda la, ma, lb, mb: cosk_coupling(1, la, ma, lb, mb))
        return np.kron(A, self.rb.radial_integral(1))

    def quadrupole_zz(self) -> np.ndarray:
        """<(3 z^2 - r^2)/2> (reference: TwoDBasis::quadrupole_zz)."""
        A2 = self._angular_matrix(lambda la, ma, lb, mb: cosk_coupling(2, la, ma, lb, mb))
        return np.kron(1.5 * A2 - 0.5 * np.eye(self.nang), self.rb.radial_integral(2))

    def Bz_field(self, B: float) -> np.ndarray:
        """Orbital Zeeman B/2 L_z + diamagnetic B^2/8 r^2 sin^2(theta)
        (reference: TwoDBasis::Bz_field, src/atomic/TwoDBasis.cpp:591-636).
        The spin Zeeman -+ B/2 S is added per spin in the SCF."""
        S2 = self._angular_matrix(sine2_coupling)
        out = np.kron(np.diag(self.mval * B / 2.0), self.rb.overlap())
        out += B * B / 8.0 * np.kron(S2, self.rb.radial_integral(2))
        return out

    def confinement(self, N, R: float, iconf: int = 1, shift: float = 0.0) -> np.ndarray:
        Vr = confinement_Vr(self.rb.r, self.rmax, N, R, iconf, shift)
        return np.kron(np.eye(self.nang), self.rb.model_potential(Vr))

    def nuclear_offcenter(self, Zl: int, Zr: int, Rhalf: float) -> np.ndarray:
        """Attraction to the off-centre charges Zr at +Rhalf z and Zl at
        -Rhalf z by multipole expansion (reference: TwoDBasis::nuclear's
        off-centre path, src/atomic/TwoDBasis.cpp:378-454), most accurate with
        an element boundary at r = Rhalf (form_grid inserts one)."""
        out = np.zeros((self.nbf, self.nbf))
        r = self.rb.r
        for L in range(0, 2 * self.lmax + 1):
            zfac = Zr + (-1) ** L * Zl
            if zfac == 0:
                continue
            with np.errstate(over="ignore", divide="ignore"):
                fr = np.where(r <= Rhalf, r**L / Rhalf ** (L + 1), Rhalf**L / r ** (L + 1))
            rad = -np.sqrt(4.0 * np.pi / (2 * L + 1)) * zfac * self.rb.model_potential(fr)
            A = self._angular_matrix(
                lambda la, ma, lb, mb, L=L: gaunt_coefficient(la, ma, L, 0, lb, mb))
            out += np.kron(A, rad)
        return out

    def nuclear_model(self, model: str, Rrms: float) -> np.ndarray:
        """Finite-nucleus attraction (nuclear_model_V's models; 'point' is
        nuclear())."""
        if model == "point":
            return self.nuclear() * 1.0
        Vr = nuclear_model_V(model, self.Z, Rrms)(self.rb.r)
        return np.kron(np.eye(self.nang), self.rb.model_potential(Vr))

    def sinvh_rad(self) -> np.ndarray:
        S = self.rb.overlap()
        w, U = np.linalg.eigh(S)
        if w.min() < 1e-12 * w.max():
            raise RuntimeError("overlap matrix nearly singular")
        return U @ np.diag(w**-0.5) @ U.T

    # --- symmetry index sets ----------------------------------------------------
    def sym_blocks(self, symm: int = 2):
        """List of arrays of full-basis indices per symmetry block.

        symm=1: group angular shells by m; symm=2: each (l,m) shell its own
        block (reference: TwoDBasis::get_sym_idx, src/atomic/TwoDBasis.cpp:202)."""
        if symm == 0:
            return [np.arange(self.nbf)]
        blocks = []
        if symm == 1:
            for m in np.unique(self.mval):
                shells = np.nonzero(self.mval == m)[0]
                idx = np.concatenate(
                    [a * self.nrad + np.arange(self.nrad) for a in shells]
                )
                blocks.append(idx)
        else:
            for a in range(self.nang):
                blocks.append(a * self.nrad + np.arange(self.nrad))
        return blocks

    def sym_labels(self, symm: int = 2) -> list[str]:
        """Human-readable label per sym_blocks entry."""
        spd = "spdfghikl"
        if symm == 0:
            return ["all"]
        if symm == 1:
            return [f"m={m:+d}" for m in np.unique(self.mval)]
        return [
            f"{spd[self.lval[a]] if self.lval[a] < len(spd) else 'l' + str(self.lval[a])}"
            f"(m={self.mval[a]:+d})"
            for a in range(self.nang)
        ]

    # --- device constants ---------------------------------------------------------
    def host_operators(self) -> dict[str, np.ndarray]:
        """The AtomicOperators fields as numpy arrays, computed exactly as
        helfem_tpu's AtomicBasis.build_operators computes them."""
        NL = self.NL
        tei = self.rb.twoe_integral(NL - 1)
        disjL, disjm1L = self.rb.disjoint_integrals(NL - 1)
        T = self.kinetic()
        Vnuc = self.nuclear()
        return dict(
            gidx=self.rb.fem.gidx,
            G=gaunt_table(self.lval, self.mval, NL - 1),
            Lfac=4.0 * np.pi / (2.0 * np.arange(NL) + 1.0),
            tei=tei,
            disjL=disjL,
            disjm1L=disjm1L,
            S=self.overlap(),
            H0=T + Vnuc,
            T=T,
            Vnuc=Vnuc,
            Sinvh_rad=self.sinvh_rad(),
        )

    def build_operators(self, device) -> AtomicOperators:
        return from_jax_operators(self.host_operators(), device)

    def host_erfc(self, mu: float) -> dict[str, np.ndarray]:
        """erfc short-range TEI tables as numpy arrays (helfem_tpu's
        build_erfc; reference: TwoDBasis::compute_erfc,
        src/atomic/TwoDBasis.cpp:781)."""
        NL = self.NL
        return dict(tei=self.rb.erfc_integral(NL - 1, mu),
                    Lfac=4.0 * np.pi * mu / (2.0 * np.arange(NL) + 1.0))

    def host_yukawa(self, lam: float) -> dict[str, np.ndarray]:
        """Yukawa (screened-Coulomb) TEI tables as numpy arrays (helfem_tpu's
        build_yukawa; reference: TwoDBasis::compute_yukawa,
        src/atomic/TwoDBasis.cpp:747)."""
        NL = self.NL
        iL, kL = self.rb.yukawa_disjoint(NL - 1, lam)
        return dict(tei=self.rb.yukawa_integral(NL - 1, lam), iL=iL, kL=kL,
                    Lfac=np.full(NL, 4.0 * np.pi * lam))

    def build_erfc(self, mu: float, device) -> ErfcOperators:
        return from_jax_rs_operators(self.host_erfc(mu), device)

    def build_yukawa(self, lam: float, device) -> RSOperators:
        return from_jax_rs_operators(self.host_yukawa(lam), device)


def _blockdiag(blocks: np.ndarray) -> np.ndarray:
    n, r, _ = blocks.shape
    out = np.zeros((n * r, n * r))
    for i in range(n):
        out[i * r : (i + 1) * r, i * r : (i + 1) * r] = blocks[i]
    return out


# ----------------------------------------------------------------------------
# SCF hot path: Coulomb and exchange builds
# (reference: TwoDBasis::coulomb / exchange, src/atomic/TwoDBasis.cpp:817-1150)
# ----------------------------------------------------------------------------


def _to4(P: torch.Tensor, nang: int, nrad: int) -> torch.Tensor:
    """[nbf,nbf] -> [nang, nang, nrad, nrad]"""
    return P.reshape(nang, nrad, nang, nrad).permute(0, 2, 1, 3)


def _from4(P4: torch.Tensor, nang: int, nrad: int) -> torch.Tensor:
    return P4.permute(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)


def coulomb(ops: AtomicOperators, P: torch.Tensor) -> torch.Tensor:
    """J(P): Gaunt contraction to the (L, M) radial helpers, the radial
    kernel radial_coulomb, Gaunt expansion back (atomic.py:436-465)."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    P4 = _to4(P, nang, nrad)
    Paux = torch.einsum("LMab,abIJ->LMIJ", ops.G, P4).contiguous()
    Jaux = radial_coulomb(Paux, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, ops.gidx)
    J4 = torch.einsum("LMba,LMIJ->abIJ", ops.G, Jaux)
    return _from4(J4, nang, nrad)


def exchange_kernel_L(teiL, UL, VL, gidx, nrad, R):
    """Radial exchange contraction for ONE L channel and a batch of radial
    helper matrices R [batch, nrad, nrad] (atomic.py:499-553), through the
    radial_exchange kernel. Unlike helfem_tpu's, the result is the
    [batch, nrad, nrad] square with the trash slot already dropped."""
    if R.shape[-1] != nrad:
        raise ValueError(f"R has radial size {R.shape[-1]}, expected {nrad}")
    return radial_exchange(teiL[None].contiguous(), UL[None].contiguous(),
                           VL[None].contiguous(), gidx, R.contiguous())[0]


def channel_diag(P: torch.Tensor, nang: int, nrad: int) -> torch.Tensor:
    """Per-angular-channel diagonal radial blocks Pd[a] = P[a-block, a-block]
    of a full density matrix ([nbf,nbf] -> [nang, nrad, nrad])."""
    a = torch.arange(nang, device=P.device)
    return _to4(P, nang, nrad)[a, a]


def _gaunt_weight(ops: AtomicOperators, Lfacv, KK: torch.Tensor, ns: int) -> torch.Tensor:
    """-K[s] [ns, nbf, nbf] from the radial results KK [NL, ns * nang, nrad,
    nrad] of ns spins' channels: K[b, c] = sum_{g,a} wG[g,b,c,a] KK[g,a],
    wG[g,b,c,a] = Lfac_g sum_M G[g,M,b,a] G[g,M,c,a]."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    KK = KK.reshape(KK.shape[0], ns, nang, nrad, nrad)
    wG = torch.einsum("gMba,gMca->gbca", ops.G, ops.G) * Lfacv[:, None, None, None]
    return -torch.einsum("gbca,gsaNM->sbNcM", wG, KK).reshape(ns, nang * nrad, nang * nrad)


def exchange_general_bd(ops: AtomicOperators, tei, U, V, Lfacv,
                        Pd: torch.Tensor, pairwise: bool = False) -> torch.Tensor:
    """Exchange for a density that is BLOCK-DIAGONAL over angular channels,
    P4[a, d] = delta_ad Pd[a] (atomic.py:683-714): the radial kernel runs on
    every (L, channel) pair, KK[g, a] = kernel_L(Pd[a]), then one
    Gaunt-weighting contraction K[b, c] = sum_{g,a} wG[g,b,c,a] KK[g,a] with
    wG[g,b,c,a] = Lfac_g sum_M G[g,M,b,a] G[g,M,c,a]. Returns the NEGATIVE
    exchange contribution to F.

    Pd [ns, nang, nrad, nrad] holds ns spin densities: their ns * nang
    channels go through ONE radial_exchange launch (the kernel is linear in
    each channel), and the result is [ns, nbf, nbf]. pairwise selects the
    pairwise plain form on the CPU (the Yukawa tables; the kernel always
    runs it)."""
    nrad = ops.Sinvh_rad.shape[0]
    ns = Pd.shape[0] if Pd.dim() == 4 else 1
    KK = radial_exchange(tei, U, V, ops.gidx, Pd.reshape(-1, nrad, nrad).contiguous(),
                         pairwise=pairwise)
    K = _gaunt_weight(ops, Lfacv, KK, ns)
    return K if Pd.dim() == 4 else K[0]


def exchange_bd(ops: AtomicOperators, Pd: torch.Tensor) -> torch.Tensor:
    """Full-range exchange K(P) for channel-block-diagonal P, from the
    per-channel diagonal radial blocks Pd [nang, nrad, nrad] (or [ns, nang,
    nrad, nrad] for ns spins in one kernel launch)."""
    return exchange_general_bd(ops, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, Pd)


def rs_exchange_bd(ops: AtomicOperators, rs: RSOperators, Pd: torch.Tensor) -> torch.Tensor:
    """Yukawa short-range exchange for channel-block-diagonal P
    (atomic.py:723): radial_exchange on the Yukawa tables, Lfac = 4 pi lam.
    Its i_L/k_L tables span e^(+-lam rmax), which only the pairwise form
    pairs per element: the kernel's form, and the plain form the CPU runs
    here. Pd as exchange_bd's, one launch for one or two spins."""
    return exchange_general_bd(ops, rs.tei, rs.iL, rs.kL, rs.Lfac, Pd, pairwise=True)


def erfc_exchange_bd(ops: AtomicOperators, rs: ErfcOperators, Pd: torch.Tensor) -> torch.Tensor:
    """erfc short-range exchange for channel-block-diagonal P
    (atomic.py:729-749): KK from radial_erfc_exchange, which contracts the
    dense element-pair tables with every channel's windows, then the Gaunt
    weighting with Lfac = 4 pi mu / (2L+1). Pd as exchange_bd's, one launch
    for one or two spins."""
    nrad = ops.Sinvh_rad.shape[0]
    ns = Pd.shape[0] if Pd.dim() == 4 else 1
    KK = radial_erfc_exchange(rs.tei, ops.gidx, Pd.reshape(-1, nrad, nrad).contiguous())
    K = _gaunt_weight(ops, rs.Lfac, KK, ns)
    return K if Pd.dim() == 4 else K[0]


# ----------------------------------------------------------------------------
# Exchange of a density with cross-channel blocks (symmetry 0 and 1)
# ----------------------------------------------------------------------------


def channel_pairs(mval: np.ndarray, symm: int) -> tuple[np.ndarray, np.ndarray]:
    """The channel pairs (a, d) whose radial windows P4[a, d] a density of
    symmetry `symm` may hold nonzero: every one of the nang^2 under
    symmetry 0, the pairs with m_a = m_d under symmetry 1 (the density is
    block-diagonal over m), the diagonal a = d under symmetry 2."""
    m = np.asarray(mval)
    a, d = np.meshgrid(np.arange(len(m)), np.arange(len(m)), indexing="ij")
    keep = {0: np.ones_like(a, dtype=bool), 1: m[a] == m[d], 2: a == d}[symm]
    return a[keep], d[keep]


def _pair_windows(P: torch.Tensor, nang: int, nrad: int, pairs) -> torch.Tensor:
    """The windows P4[a_p, d_p] [..., npairs, nrad, nrad] of P [..., nbf,
    nbf] (not symmetric for a_p != d_p: P4[d, a] = P4[a, d]^T)."""
    pa, pd = (torch.as_tensor(x, dtype=torch.long, device=P.device) for x in pairs)
    P4 = P.reshape(*P.shape[:-2], nang, nrad, nang, nrad).transpose(-3, -2)
    return P4[..., pa, pd, :, :]


def _pair_weight(ops: AtomicOperators, Lfacv, KK: torch.Tensor, ns: int, pairs) -> torch.Tensor:
    """-K[s] [ns, nbf, nbf] from the radial results KK [NL, ns * npairs,
    nrad, nrad] of ns spins' channel-pair windows: K[b, c] = sum_{g,p}
    W[g,b,c,p] KK[g,p], W[g,b,c,p] = Lfac_g sum_M G[g,M,b,a_p] G[g,M,c,d_p]
    (helfem_tpu atomic.py:612-614, with the kernel moved in front of the
    Gaunt weighting: it is linear in its window)."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    pa, pd = (torch.as_tensor(x, dtype=torch.long, device=KK.device) for x in pairs)
    W = torch.einsum("gMbp,gMcp->gbcp", ops.G[:, :, :, pa], ops.G[:, :, :, pd])
    W = W * Lfacv[:, None, None, None]
    KK = KK.reshape(KK.shape[0], ns, len(pa), nrad, nrad)
    return -torch.einsum("gbcp,gspNM->sbNcM", W, KK).reshape(ns, nang * nrad, nang * nrad)


def _spins_and_pairs(P: torch.Tensor, pairs, nang: int):
    """(the spins of P [nbf, nbf] or [ns, nbf, nbf], the channel pairs: all
    nang^2 when None)."""
    if pairs is None:
        pairs = channel_pairs(np.zeros(nang), 0)
    return (P.shape[0] if P.dim() == 3 else 1), pairs


def exchange_general(ops: AtomicOperators, tei, U, V, Lfacv, P: torch.Tensor, pairs=None,
                     pairwise: bool = False) -> torch.Tensor:
    """Exchange of a density with cross-channel blocks (helfem_tpu's
    exchange_general, atomic.py:556-619): ONE radial_exchange launch on the
    channel-pair windows P4[a, d] of every pair in `pairs` (channel_pairs;
    all nang^2 when None), KK[g, p] = kernel_L(P4[a_p, d_p]), then the
    Gaunt weighting K[b, c] = sum_{g,p} W[g,b,c,p] KK[g,p] (_pair_weight).
    A pair left out must have a zero window: channel_pairs(mval, 1) is
    exact for the m-block-diagonal densities of symmetry 1. Returns the
    NEGATIVE exchange contribution to F. P [nbf, nbf], or [ns, nbf, nbf]
    for ns spins in the same launch (the result then [ns, nbf, nbf]);
    pairwise as exchange_general_bd's."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    ns, pairs = _spins_and_pairs(P, pairs, nang)
    Pw = _pair_windows(P, nang, nrad, pairs).reshape(-1, nrad, nrad).contiguous()
    KK = radial_exchange(tei, U, V, ops.gidx, Pw, pairwise=pairwise)
    K = _pair_weight(ops, Lfacv, KK, ns, pairs)
    return K if P.dim() == 3 else K[0]


def exchange(ops: AtomicOperators, P: torch.Tensor, pairs=None) -> torch.Tensor:
    """Full-range exchange K(P) of a density with cross-channel blocks."""
    return exchange_general(ops, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, P, pairs)


def rs_exchange(ops: AtomicOperators, rs: RSOperators, P: torch.Tensor,
                pairs=None) -> torch.Tensor:
    """Yukawa short-range exchange of a density with cross-channel blocks
    (atomic.py:636): radial_exchange on the Yukawa tables, pairwise form."""
    return exchange_general(ops, rs.tei, rs.iL, rs.kL, rs.Lfac, P, pairs, pairwise=True)


def erfc_exchange(ops: AtomicOperators, rs: ErfcOperators, P: torch.Tensor,
                  pairs=None) -> torch.Tensor:
    """erfc short-range exchange of a density with cross-channel blocks
    (atomic.py:650-680): ONE radial_erfc_exchange launch on the channel-pair
    windows, then the Gaunt weighting with Lfac = 4 pi mu / (2L+1). P and
    pairs as exchange_general's."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    ns, pairs = _spins_and_pairs(P, pairs, nang)
    Pw = _pair_windows(P, nang, nrad, pairs).reshape(-1, nrad, nrad).contiguous()
    KK = radial_erfc_exchange(rs.tei, ops.gidx, Pw)
    K = _pair_weight(ops, rs.Lfac, KK, ns, pairs)
    return K if P.dim() == 3 else K[0]
