"""Diatomic molecules: prolate-spheroidal two-center FEM basis (L5), ported
from helfem_tpu/models/diatomic.py.

Electron coordinates (mu, nu, phi) with xi = cosh mu, eta = cos nu; nuclei
at z = +-Rh on the z axis (Rh = R/2); volume element Rh^3 (cosh^2 mu -
eta^2) sinh mu. Basis chi_{n l m} = B_n(mu) Y_lm(nu, phi), angular-major
(bf = a * nrad + n); the first radial function of every m != 0 shell is
masked (shell_mask).

* Host setup (one-electron operators, the Neumann-expansion TEI tables
  from Legendre P/Q, symmetry blocks) is numpy, computed exactly as
  helfem_tpu computes it.
* The Coulomb build contracts the density with the (modified) Gaunt tables
  in torch.einsum and hands the radial core to the CUDA kernel
  radial_coulomb_dia (kernels/), whose plain PyTorch version runs on CPU
  tensors. The reduced 3-family in-element table teiJ3 stays on the
  device; helfem_tpu's fourth family (2,0) is the per-block transpose of
  (0,2) and the kernel reads it so.

* The exchange build (exchange_dia_occ from occupied orbitals, the path of
  the SCF, and exchange_dia from a symmetric density) forms its Gaunt
  transforms in torch.einsum and hands the radial core to the CUDA kernels
  radial_exchange_dia_occ and radial_exchange_dia (kernels/), which read
  the same teiJ3 table through the exchange index permutation.

* The axial field operators (dipole_z, quadrupole_zz, Bz_field) are host
  numpy; the SCF folds them into H0. Under Ez the g/u split of the
  symmetry blocks is dropped (build_operators(parity=False)).

build_operators(chol=True) whitens the symmetry blocks with the inverse
Cholesky factor (--diag 0). bval, when given, are the element boundaries in mu (the
bases of checkpoints, utils/checkpoint.py and utils/checkpoint_h5.py).
"""

from collections.abc import Mapping
from dataclasses import dataclass, field
from math import factorial
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels import (
    check_gidx,
    radial_coulomb_dia,
    radial_exchange_dia,
    radial_exchange_dia_occ,
)
from helfem_tpu_torch.ops.fem import FEMBasis
from helfem_tpu_torch.ops.gaunt import (
    cos2sin2_coupling,
    cosk_coupling,
    gaunt_coefficient,
    modified_gaunt_coefficient,
    sine2_coupling,
)
from helfem_tpu_torch.ops.grids import get_grid
from helfem_tpu_torch.ops.legendreq import legendre_PQ
from helfem_tpu_torch.ops.polynomials import get_basis
from helfem_tpu_torch.ops.quadrature import chebyshev
from helfem_tpu_torch.utils.linalg import build_blocks

__all__ = ["lm_to_l_m", "DiatomicBasis", "DiatomicOperators", "coulomb_dia",
           "exchange_dia", "exchange_dia_occ", "exchange_factors", "exchange_weights",
           "from_jax_operators"]


def lm_to_l_m(lmax_per_m):
    """Angular shells from a per-|m| lmax list
    (reference: diatomic::basis::lm_to_l_m, basis.cpp:287-302)."""
    lv, mv = [], []
    for mabs, lmax in enumerate(lmax_per_m):
        for l in range(mabs, lmax + 1):
            lv.append(l)
            mv.append(mabs)
            if mabs > 0:
                lv.append(l)
                mv.append(-mabs)
    return np.array(lv), np.array(mv)


class DiatomicOperators(NamedTuple):
    """Device constants of the diatomic SCF: helfem_tpu's DiatomicOperators
    with the in-element table kept in its reduced form teiJ3 (family axis
    (0,0), (0,2), (2,2)) and without teiK. helfem_tpu's teiK is the fixed
    index permutation (i,j,k,l) -> (j,k,i,l) of teiJ, materialised there
    only so that the exchange contraction is a matmul; the exchange kernels
    and their plain versions read teiJ3 through that permutation, and
    family (2,0) as the transpose of (0,2), as radial_coulomb_dia does."""

    gidx: torch.Tensor  # [nelem, nprim] int32, trash slot = nrad
    shellmask: torch.Tensor  # [nang, nrad]
    S: torch.Tensor  # [nbf, nbf]
    H0: torch.Tensor
    T: torch.Tensor
    Vnuc: torch.Tensor
    GmLM: torch.Tensor  # [nLM, nang, nang] modified-Gaunt couplings
    GpLM: torch.Tensor  # [nLM, nang, nang] plain-Gaunt couplings
    LM_ilm: torch.Tensor  # [nLM] int32 -> row of the (L,|M|) radial tables
    LMfac: torch.Tensor  # [nlm] = 4 pi Rh^5 (-1)^M (L-|M|)!/(L+|M|)!
    teiJ3: torch.Tensor  # [nlm, 3, nelem, np^2(ij), np^2(kl)]
    dP0: torch.Tensor  # [nlm, nelem, np, np] disjoint P/Q moments
    dP2: torch.Tensor
    dQ0: torch.Tensor
    dQ2: torch.Tensor
    step_ilm: torch.Tensor  # [nlm] int32: exchange channel -> (L,|M|) table row
    step_sp: torch.Tensor  # [nlm] int32: its (L, +|M|) row of GmLM/GpLM
    step_sm: torch.Tensor  # [nlm] int32: its (L, -|M|) row (= step_sp if none)
    step_wm: torch.Tensor  # [nlm] weight of the -|M| term: 1 if it exists, else 0
    blk_idx: torch.Tensor  # [nblk, blen] int32 global indices (padded with nbf)
    blk_sinvh: torch.Tensor  # [nblk, blen, blen]

    @property
    def device(self) -> torch.device:
        return self.S.device

    def to(self, device) -> "DiatomicOperators":
        return DiatomicOperators(*(t.to(device) for t in self))


_INT_FIELDS = ("gidx", "LM_ilm", "step_ilm", "step_sp", "step_sm", "blk_idx")


def _operators(arrays: Mapping[str, np.ndarray], device) -> DiatomicOperators:
    check_gidx(arrays["gidx"], np.asarray(arrays["shellmask"]).shape[-1])
    return DiatomicOperators(**{
        name: torch.tensor(np.asarray(arrays[name]),
                           dtype=torch.int32 if name in _INT_FIELDS else torch.float64,
                           device=device)
        for name in DiatomicOperators._fields
    })


def from_jax_operators(arrays: Mapping[str, np.ndarray], device) -> DiatomicOperators:
    """The port's operators from helfem_tpu's DiatomicOperators fields given
    as numpy arrays (e.g. {k: np.asarray(v) for k, v in ops._asdict().items()}):
    the 4-family teiJ [(0,0), (0,2), (2,0), (2,2)] keeps families 0, 1 and 3
    and the exchange step tables are carried; teiK, a permuted copy of teiJ,
    is not (see DiatomicOperators)."""
    arrays = dict(arrays)
    arrays["teiJ3"] = np.asarray(arrays["teiJ"])[:, [0, 1, 3]]
    return _operators(arrays, device)


@dataclass
class DiatomicBasis:
    """Host-side setup of a diatomic calculation (helfem_tpu's
    DiatomicBasis): the element boundaries come from rmax/nelem/igrid/zexp,
    or are bval (in mu), and then nelem and rmax follow from them
    (helfem_tpu diatomic.py:112-135)."""

    Z1: int
    Z2: int
    Rbond: float
    lmax: tuple  # per-|m| lmax list, len = mmax+1
    rmax: float = 40.0
    nelem: int = 8
    nnodes: int = 12
    nquad: int = 0
    igrid: int = 4
    zexp: float = 2.0
    primbas: int = 4
    bval: np.ndarray | None = None

    lval: np.ndarray = field(init=False)
    mval: np.ndarray = field(init=False)
    fem: FEMBasis = field(init=False)

    def __post_init__(self):
        if isinstance(self.lmax, int):
            self.lmax = (self.lmax,)
        self.lval, self.mval = lm_to_l_m(self.lmax)
        if self.nquad == 0:
            self.nquad = 5 * self.nnodes
        self.Rhalf = 0.5 * self.Rbond
        if self.bval is not None:
            bval = np.asarray(self.bval, dtype=float)
            self.nelem = len(bval) - 1
            self.rmax = float(self.Rhalf * np.cosh(bval[-1]))
        else:
            bval = get_grid(np.arccosh(self.rmax / self.Rhalf), self.nelem, self.igrid,
                            self.zexp)
        poly = get_basis(self.primbas, self.nnodes)
        self.fem = FEMBasis(poly, bval, drop_first=False, drop_last=True)
        self.xq, self.wq = chebyshev(self.nquad)
        self.mu = self.fem.coords(self.xq)  # [nelem, nq]
        self.wmu = self.wq[None, :] * (0.5 * self.fem.lengths)[:, None]
        dn = self.fem.eval_dnf(self.xq, 1)
        self.B, self.dB = dn[0], dn[1]
        self._d2B = None
        self._build_channels()

    @property
    def d2B(self) -> np.ndarray:
        """d^2B/dmu^2 at the quadrature points [nelem, nq, nprim], formed at
        first use (the laplacian meta-GGA's grid alone reads it;
        diatomic.py:147-152)."""
        if self._d2B is None:
            self._d2B = self.fem.eval_dnf(self.xq, 2)[2]
        return self._d2B

    # --- sizes ----------------------------------------------------------------
    @property
    def nang(self) -> int:
        return len(self.lval)

    @property
    def nrad(self) -> int:
        return self.fem.nbf

    @property
    def nbf(self) -> int:
        return self.nang * self.nrad  # incl. masked per-shell functions

    def shell_mask(self) -> np.ndarray:
        """[nang, nrad]: zero at the first radial function for m != 0 shells."""
        mask = np.ones((self.nang, self.nrad))
        mask[self.mval != 0, 0] = 0.0
        return mask

    def _build_channels(self):
        lms = set()
        LMs = set()
        for a in range(self.nang):
            for b in range(self.nang):
                M = int(self.mval[a] - self.mval[b])
                Lmin = max(abs(int(self.lval[a] - self.lval[b])) - 2, abs(M))
                Lmaxv = int(self.lval[a] + self.lval[b]) + 2
                for L in range(Lmin, Lmaxv + 1):
                    lms.add((L, abs(M)))
                    LMs.add((L, M))
        self.lm_map = sorted(lms)
        # M = 0 channels first: a symmetry-block-diagonal density (m_a = m_b)
        # projects to zero on every M != 0 channel, so the Coulomb build of
        # the SCF runs on this prefix alone (coulomb_dia njbd)
        self.LM_map = sorted(LMs, key=lambda p: (p[1] != 0, p))
        self.njbd = sum(1 for (_, M) in self.LM_map if M == 0)
        self.lm_index = {p: i for i, p in enumerate(self.lm_map)}

    # --- radial integrals -------------------------------------------------------
    def radial_integral(self, m: int, n: int) -> np.ndarray:
        """<B_i | sinh^m mu cosh^n mu | B_j>, assembled."""
        f = np.sinh(self.mu) ** m if m else np.ones_like(self.mu)
        if n:
            f = f * np.cosh(self.mu) ** n
        el = np.einsum("eqi,eq,eqj->eij", self.B, self.wmu * f, self.B, optimize=True)
        return self.fem.assemble(el)

    def kinetic_radial(self) -> np.ndarray:
        return self.fem.assemble(
            np.einsum("eqi,eq,eqj->eij", self.dB, self.wmu * np.sinh(self.mu), self.dB)
        )

    # --- one-electron operators ---------------------------------------------------
    def _couple(self, radial_blocks: dict) -> np.ndarray:
        """Assemble sum over couplings: radial_blocks maps coupling-kind
        ('delta' or ('cos', k)) -> radial matrix."""
        nang, nrad = self.nang, self.nrad
        out = np.zeros((nang * nrad, nang * nrad))
        for a in range(nang):
            for b in range(nang):
                if self.mval[a] != self.mval[b]:
                    continue
                blk = np.zeros((nrad, nrad))
                use = False
                for kind, mat in radial_blocks.items():
                    if kind == "delta":
                        if self.lval[a] == self.lval[b]:
                            blk = blk + mat
                            use = True
                    else:
                        k = kind[1]
                        c = cosk_coupling(
                            k, int(self.lval[a]), int(self.mval[a]), int(self.lval[b]), int(self.mval[b])
                        )
                        if c != 0.0:
                            blk = blk + c * mat
                            use = True
                if use:
                    out[a * nrad : (a + 1) * nrad, b * nrad : (b + 1) * nrad] = blk
        return out

    def overlap(self) -> np.ndarray:
        I12 = self.radial_integral(1, 2)
        I10 = self.radial_integral(1, 0)
        Rh = self.Rhalf
        return Rh**3 * self._couple({"delta": I12, ("cos", 2): -I10})

    def kinetic(self) -> np.ndarray:
        Trad = self.kinetic_radial()
        I10 = self.radial_integral(1, 0)
        Im10 = self.radial_integral(-1, 0)
        nang, nrad = self.nang, self.nrad
        out = np.zeros((nang * nrad, nang * nrad))
        for a in range(nang):
            l, m = int(self.lval[a]), int(self.mval[a])
            blk = Trad + l * (l + 1) * I10 + m * m * Im10
            out[a * nrad : (a + 1) * nrad, a * nrad : (a + 1) * nrad] = blk
        return 0.5 * self.Rhalf * out

    def nuclear(self) -> np.ndarray:
        I11 = self.radial_integral(1, 1)
        I10 = self.radial_integral(1, 0)
        Rh = self.Rhalf
        return -(Rh**2) * self._couple(
            {"delta": (self.Z1 + self.Z2) * I11, ("cos", 1): (self.Z2 - self.Z1) * I10}
        )

    def dipole_z(self) -> np.ndarray:
        """<z> in prolate coordinates (diatomic.py:262-265)."""
        I11 = self.radial_integral(1, 1)
        I13 = self.radial_integral(1, 3)
        return self.Rhalf**4 * self._couple({("cos", 1): I13, ("cos", 3): -I11})

    def quadrupole_zz(self) -> np.ndarray:
        """z^2 - (x^2 + y^2)/2 in prolate coordinates (reference: diatomic
        TwoDBasis::quadrupole_zz, src/diatomic/basis.cpp:857-900)."""
        I10 = self.radial_integral(1, 0)
        I12 = self.radial_integral(1, 2)
        I14 = self.radial_integral(1, 4)
        return (self.Rhalf**5 / 2.0) * self._couple(
            {
                ("cos", 4): I10 - 3.0 * I12,
                ("cos", 2): 3.0 * I14 - I10,
                "delta": I12 - I14,
            }
        )

    def Bz_field(self, B: float) -> np.ndarray:
        """Orbital Zeeman and diamagnetic operator of a uniform field B
        along the bond, -B/2 L_z + B^2/8 (x^2 + y^2), shell-masked (reference:
        diatomic TwoDBasis::Bz_field, src/diatomic/basis.cpp:902-953). The
        spin term -+ B/2 is applied by the SCF."""
        Rh = self.Rhalf
        I10 = self.radial_integral(1, 0) * Rh**3
        I12 = self.radial_integral(1, 2) * Rh**3
        I30 = self.radial_integral(3, 0) * Rh**5
        I32 = self.radial_integral(3, 2) * Rh**5
        nang, nrad = self.nang, self.nrad
        out = np.zeros((nang * nrad, nang * nrad))
        cs = B * B / 8.0
        for a in range(nang):
            la, ma = int(self.lval[a]), int(self.mval[a])
            for b in range(nang):
                lb, mb = int(self.lval[b]), int(self.mval[b])
                if ma != mb:
                    continue
                blk = np.zeros((nrad, nrad))
                use = False
                # diamagnetic rho^2 = Rh^2 sinh^2 mu sin^2 nu: the sinh^2
                # cosh^2-weighted sin^2 and the sinh^2-weighted cos^2 sin^2
                c2 = sine2_coupling(lb, mb, la, ma)
                if c2 != 0.0:
                    blk += cs * c2 * I32
                    use = True
                c22 = cos2sin2_coupling(lb, mb, la, ma)
                if c22 != 0.0:
                    blk -= cs * c22 * I30
                    use = True
                # paramagnetic -B/2 m <chi|chi>
                ds = -0.5 * ma * B
                if ds != 0.0:
                    if la == lb:
                        blk += ds * I12
                        use = True
                    c = cosk_coupling(2, lb, mb, la, ma)
                    if c != 0.0:
                        blk -= ds * c * I10
                        use = True
                if use:
                    out[a * nrad : (a + 1) * nrad, b * nrad : (b + 1) * nrad] = blk
        m2 = self.shell_mask().reshape(-1)
        return out * m2[:, None] * m2[None, :]

    # --- symmetry blocks -----------------------------------------------------------
    def sym_blocks(self, parity: bool = True):
        """Valid global indices per symmetry block: by m, plus gerade/
        ungerade (l parity) for homonuclear (reference: m_indices(m, odd),
        src/diatomic/basis.h:262-266). Respects per-shell radial masks."""
        mask = self.shell_mask()
        blocks = []
        parities = [0, 1] if (self.Z1 == self.Z2 and parity) else [None]
        for m in sorted(set(self.mval)):
            for par in parities:
                idx = []
                for a in range(self.nang):
                    if self.mval[a] != m:
                        continue
                    if par is not None and self.lval[a] % 2 != par:
                        continue
                    base = a * self.nrad
                    start = 0 if mask[a, 0] else 1
                    idx.extend(range(base + start, base + self.nrad))
                if idx:
                    blocks.append(np.array(idx))
        return blocks

    def sym_labels(self, parity: bool = True) -> list[str]:
        """Spectroscopic label per symmetry block, in sym_blocks order:
        sigma/pi/delta/... by |m|, with g/u parity for homonuclear
        (reference: classify_orbitals, src/diatomic/main.cpp)."""
        greek = ["sigma", "pi", "delta", "phi", "gamma", "eta"]
        labels = []
        parities = [0, 1] if (self.Z1 == self.Z2 and parity) else [None]
        for m in sorted(set(self.mval)):
            for par in parities:
                has = any(
                    self.mval[a] == m and (par is None or self.lval[a] % 2 == par)
                    for a in range(self.nang)
                )
                if not has:
                    continue
                name = greek[abs(m)] if abs(m) < len(greek) else f"m={m}"
                if par is not None:
                    name += "g" if par == 0 else "u"
                labels.append(name)
        return labels

    # --- TEI tables -------------------------------------------------------------------
    def _legendre_tables(self):
        """P/Q at all outer and inner quadrature points, per element."""
        Lmax = max(L for L, _ in self.lm_map)
        Mmax = max(M for _, M in self.lm_map)
        nelem, nq = self.mu.shape
        # inner points per (element, segment)
        mu_in = np.empty((nelem, nq, nq))
        for e in range(nelem):
            lo = np.concatenate([[self.fem.bval[e]], self.mu[e][:-1]])
            hi = self.mu[e]
            mid, hlen = 0.5 * (lo + hi), 0.5 * (hi - lo)
            mu_in[e] = mid[:, None] + hlen[:, None] * self.xq[None, :]
        self._mu_in = mu_in
        P_out, Q_out = legendre_PQ(Lmax, Mmax, mu=self.mu.ravel())
        P_in, Q_in = legendre_PQ(Lmax, Mmax, mu=mu_in.ravel())
        return (
            P_out.reshape(Lmax + 1, Mmax + 1, nelem, nq),
            Q_out.reshape(Lmax + 1, Mmax + 1, nelem, nq),
            P_in.reshape(Lmax + 1, Mmax + 1, nelem, nq, nq),
            Q_in.reshape(Lmax + 1, Mmax + 1, nelem, nq, nq),
        )

    def compute_tei(self):
        """Radial TEI tables of the (L,|M|) channel list (helfem_tpu's
        compute_tei(k_layout=False)): the in-element table teiJ3 [nlm, 3,
        nelem, np^2(ij), np^2(kl)] with families (0,0), (0,2), (2,2), and the
        disjoint moments dP0, dP2, dQ0, dQ2 [nlm, nelem, np, np]."""
        nelem, nq = self.mu.shape
        nprim = self.fem.nprim
        nlm = len(self.lm_map)
        P_out, Q_out, P_in, Q_in = self._legendre_tables()
        ch_out = np.cosh(self.mu)
        sh_out = np.sinh(self.mu)
        mu_in = self._mu_in
        ch_in = np.cosh(mu_in)
        sh_in = np.sinh(mu_in)
        # channel-indexed P/Q slices: [nlm, nelem, nq(, nq)]
        Ls = np.array([L for L, _ in self.lm_map])
        Ms = np.array([Ma for _, Ma in self.lm_map])
        Pc_out, Qc_out = P_out[Ls, Ms], Q_out[Ls, Ms]
        Pc_in = P_in[Ls, Ms]

        # disjoint moments: <B_i B_j sinh cosh^k {P,Q}_LM>_e, batched over c
        def dmom(tab, k):
            w = (self.wmu * sh_out * ch_out**k)[None] * tab  # [c, e, q]
            return np.einsum("eqi,ceq,eqj->ceij", self.B, w, self.B, optimize=True)

        dP0, dQ0 = dmom(Pc_out, 0), dmom(Qc_out, 0)
        dP2, dQ2 = dmom(Pc_out, 2), dmom(Qc_out, 2)

        np2 = nprim * nprim
        teiJ3 = np.empty((nlm, 3, nelem, np2, np2))
        # basis values at inner points
        Bin = np.empty((nelem, nq, nq, nprim))
        for e in range(nelem):
            xpoly = (mu_in[e] - self.fem.mids[e]) / (0.5 * self.fem.lengths[e])
            Bin[e] = self.fem.eval_element(e, xpoly.ravel(), 0)[0].reshape(nq, nq, nprim)
        seg_hlen = np.empty((nelem, nq))
        for e in range(nelem):
            lo = np.concatenate([[self.fem.bval[e]], self.mu[e][:-1]])
            seg_hlen[e] = 0.5 * (self.mu[e] - lo)

        for e in range(nelem):
            # inner-point pair products [p, q, kl] and outer pair products [p, ij]
            BBin = (Bin[e][:, :, :, None] * Bin[e][:, :, None, :]).reshape(nq, nq, np2)
            BBout = (self.B[e][:, :, None] * self.B[e][:, None, :]).reshape(nq, np2)
            wbase = self.wq[None, None, :] * seg_hlen[e][None, :, None] * sh_in[e][None] * Pc_in[:, e]
            wrk = {}
            for l in (0, 2):
                wseg = wbase * ch_in[e][None] ** l  # [c, p, q]
                # segment integrals as p-batched GEMMs: [p,c,q] @ [p,q,kl]
                seg = np.matmul(wseg.transpose(1, 0, 2), BBin)  # [p, c, kl]
                inner = np.cumsum(seg, axis=0).transpose(1, 0, 2)  # [c, p, kl]
                for k in (0, 2):
                    wout = (self.wmu[e] * sh_out[e] * ch_out[e] ** k)[None] * Qc_out[:, e]
                    # [c, ij, kl] = sum_p wout[c,p] BBout[p,ij] inner[c,p,kl]
                    A = wout[:, :, None] * BBout[None]  # [c, p, ij]
                    wrk[(k, l)] = np.matmul(A.transpose(0, 2, 1), inner)  # [c,ij,kl]
            # symmetrize (ij)<->(kl): family (k,l) pairs with (l,k) transposed
            for F, (k, l) in enumerate([(0, 0), (0, 2), (2, 2)]):
                for c in range(nlm):
                    teiJ3[c, F, e] = wrk[(k, l)][c] + wrk[(l, k)][c].T
        return teiJ3, dP0, dP2, dQ0, dQ2

    # --- device constants ----------------------------------------------------------------
    def host_operators(self, parity: bool = True, chol: bool = False) -> dict[str, np.ndarray]:
        """The DiatomicOperators fields as numpy arrays, computed as
        helfem_tpu's DiatomicBasis.build_operators computes them; chol=True
        whitens each symmetry block with the inverse Cholesky factor
        (reference --diag 0)."""
        nang = self.nang
        nLM = len(self.LM_map)
        GmLM = np.zeros((nLM, nang, nang))
        GpLM = np.zeros((nLM, nang, nang))
        LM_ilm = np.zeros(nLM, dtype=np.int32)
        for s, (L, M) in enumerate(self.LM_map):
            LM_ilm[s] = self.lm_index[(L, abs(M))]
            for a in range(nang):
                for b in range(nang):
                    if self.mval[a] - self.mval[b] != M:
                        continue
                    la, ma = int(self.lval[a]), int(self.mval[a])
                    lb, mb = int(self.lval[b]), int(self.mval[b])
                    GmLM[s, a, b] = modified_gaunt_coefficient(la, ma, L, M, lb, mb)
                    GpLM[s, a, b] = gaunt_coefficient(la, ma, L, M, lb, mb)
        LMfac = np.array([
            4.0 * np.pi * self.Rhalf**5 * (-1.0) ** Ma * factorial(L - Ma) / factorial(L + Ma)
            for (L, Ma) in self.lm_map
        ])
        teiJ3, dP0, dP2, dQ0, dQ2 = self.compute_tei()
        # balance the disjoint P/Q tables per (L,|M|) channel: only same-channel
        # P x Q products are consumed, so dP * alpha and dQ / alpha leave them
        # unchanged in f64 and keep the tables equal to helfem_tpu's
        mP = np.maximum(np.abs(dP0).max(axis=(1, 2, 3)), np.abs(dP2).max(axis=(1, 2, 3)))
        mQ = np.maximum(np.abs(dQ0).max(axis=(1, 2, 3)), np.abs(dQ2).max(axis=(1, 2, 3)))
        ok = (mP > 0) & (mQ > 0)
        alpha = np.where(ok, np.sqrt(np.where(ok, mQ, 1.0) / np.where(ok, mP, 1.0)), 1.0)
        a4 = alpha[:, None, None, None]
        dP0, dP2 = dP0 * a4, dP2 * a4
        dQ0, dQ2 = dQ0 / a4, dQ2 / a4

        # exchange channels: one per (L,|M|), with the rows of its signed
        # (L, +|M|) and (L, -|M|) Gaunt tables
        LM_pos = {p: i for i, p in enumerate(self.LM_map)}
        step_sp = [LM_pos[(L, Ma)] for (L, Ma) in self.lm_map]
        has_m = [Ma > 0 and (L, -Ma) in LM_pos for (L, Ma) in self.lm_map]
        step_sm = [LM_pos[(L, -Ma)] if h else LM_pos[(L, Ma)]
                   for (L, Ma), h in zip(self.lm_map, has_m)]

        S = self.overlap()
        blk_idx, blk_sinvh = build_blocks(S, self.sym_blocks(parity), chol=chol)
        T = self.kinetic()
        V = self.nuclear()
        mask = self.shell_mask()
        mv = mask.reshape(-1)
        mm = mv[:, None] * mv[None, :]  # mask garbage rows/cols
        S, T, V = S * mm, T * mm, V * mm
        return dict(
            gidx=self.fem.gidx, shellmask=mask, S=S, H0=T + V, T=T, Vnuc=V,
            GmLM=GmLM, GpLM=GpLM, LM_ilm=LM_ilm, LMfac=LMfac, teiJ3=teiJ3,
            dP0=dP0, dP2=dP2, dQ0=dQ0, dQ2=dQ2,
            step_ilm=np.arange(len(self.lm_map), dtype=np.int32),
            step_sp=np.array(step_sp, dtype=np.int32),
            step_sm=np.array(step_sm, dtype=np.int32),
            step_wm=np.array(has_m, dtype=np.float64),
            blk_idx=blk_idx, blk_sinvh=blk_sinvh,
        )

    def build_operators(self, device, parity: bool = True, chol: bool = False) -> DiatomicOperators:
        return _operators(self.host_operators(parity, chol), device)


# --------------------------------------------------------------------------------
# Coulomb build (reference: src/diatomic/basis.cpp:1359-1531)
# --------------------------------------------------------------------------------


def _to4(P: torch.Tensor, nang: int, nrad: int) -> torch.Tensor:
    return P.reshape(nang, nrad, nang, nrad).permute(0, 2, 1, 3)


def _from4(P4: torch.Tensor, nang: int, nrad: int) -> torch.Tensor:
    return P4.permute(0, 2, 1, 3).reshape(nang * nrad, nang * nrad)


def coulomb_dia(ops: DiatomicOperators, P: torch.Tensor,
                njbd: int | None = None) -> torch.Tensor:
    """J(P) (diatomic.py:709-796): Gaunt contractions to the per-channel
    radial helpers, the radial kernel radial_coulomb_dia (scaled by LMfac),
    Gaunt expansion back, shell mask.

    njbd (= basis.njbd) restricts the build to the leading M = 0 channels:
    exact for any symmetry-block-diagonal density (m_a = m_b wherever P is
    nonzero), since GmLM/GpLM carry the selection m_a - m_b = M. None runs
    every channel."""
    sl = slice(None) if njbd is None else slice(0, njbd)
    GmLM, GpLM, LM_ilm = ops.GmLM[sl], ops.GpLM[sl], ops.LM_ilm[sl]
    nang = ops.GmLM.shape[-1]
    nrad = ops.shellmask.shape[-1]
    P4 = _to4(P, nang, nrad)
    Paux0 = torch.einsum("sab,abIJ->sIJ", GmLM, P4).contiguous()
    Paux2 = torch.einsum("sab,abIJ->sIJ", GpLM, P4).contiguous()
    Jr0, Jr2 = radial_coulomb_dia(Paux0, Paux2, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0,
                                  ops.dQ2, ops.LMfac, LM_ilm, ops.gidx)
    J4 = (torch.einsum("sba,sIJ->abIJ", GmLM, Jr0)
          + torch.einsum("sba,sIJ->abIJ", GpLM, Jr2))
    m2 = ops.shellmask.reshape(-1)
    return _from4(J4, nang, nrad) * m2[:, None] * m2[None, :]


# --------------------------------------------------------------------------------
# Exchange build (reference: src/diatomic/basis.cpp:1532-1734)
# --------------------------------------------------------------------------------


def _step_tables(ops: DiatomicOperators):
    """Per exchange channel: Gq [nlm, 2(q: Gm, Gp), 2(t: +|M|, -|M|), nang,
    nang] and the weights w2 [nlm, 2(t)] = LMfac * (1, step_wm)."""
    s2 = torch.stack([ops.step_sp, ops.step_sm], dim=1).long()  # [nlm, 2]
    Gq = torch.stack([ops.GmLM[s2], ops.GpLM[s2]], dim=1)
    fac = ops.LMfac[ops.step_ilm.long()]
    w2 = fac[:, None] * torch.stack([torch.ones_like(ops.step_wm), ops.step_wm], dim=1)
    return Gq, w2


def _finish_K(ops: DiatomicOperators, K4: torch.Tensor) -> torch.Tensor:
    nang, nrad = ops.shellmask.shape
    m2 = ops.shellmask.reshape(-1)
    return -_from4(K4, nang, nrad) * m2[:, None] * m2[None, :]


def exchange_factors(ops: DiatomicOperators, Co: torch.Tensor,
                     sgn: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank factors (Uw, V) [nlm, 2(q), 2(t), nang, nrad+1, no] of
    P = Co diag(sgn) Co^T for the kernel radial_exchange_dia_occ: the Gaunt
    transform U[s,q,t,b,n,o] = sum_a Gq[s,q,t,b,a] Co[(a,n),o] with a zero
    trash row nrad, Uw = w2[s,t] U and V = U diag(sgn)
    (diatomic.py:1056-1060)."""
    nang, nrad = ops.shellmask.shape
    no = Co.shape[-1]
    C4p = F.pad(Co.reshape(nang, nrad, no), (0, 0, 0, 1))  # [a, nrad+1, o]
    Gq, w2 = _step_tables(ops)
    U = torch.einsum("sqtba,ano->sqtbno", Gq, C4p)
    V = U if sgn is None else U * sgn
    return (w2[:, None, :, None, None, None] * U).contiguous(), V.contiguous()


def exchange_dia_occ(ops: DiatomicOperators, Co: torch.Tensor,
                     sgn: torch.Tensor | None = None) -> torch.Tensor:
    """K(P) for P = Co diag(sgn) Co^T, the occupied-orbital factorised
    exchange (diatomic.py:944-1115; negative contribution, like
    helfem_tpu's). Co [nbf, no] holds sqrt(f)-weighted occupied columns; a
    zero column is an exact no-op. sgn [no] (default +1) admits an
    indefinite symmetric P through a signed eigenfactorisation.

    K is linear in P and P has rank no << nbf, so per (L,|M|) channel the
    four R families factor as R_qr[b,c,n,m] = +-sum_{t,o} U[q,t,b,n,o]
    V[r,t,c,m,o]. The two Gaunt transforms (exchange_factors: U weighted by
    LMfac and the +-|M| weights, and V) are torch.einsum; the radial core
    (window rank products, the in-element TEI contraction, the
    cross-element Q x R x P terms and the assembly) is the kernel
    radial_exchange_dia_occ, launched once for all channels (once per
    column chunk past the widest occupied width its shared-memory plan
    admits). The dense R never exists in device memory. No column (a spin
    with no electron, as beta in H2+) is the zero density: K = 0, and no
    kernel launches."""
    if Co.shape[-1] == 0:
        return torch.zeros((Co.shape[0], Co.shape[0]), dtype=Co.dtype, device=Co.device)
    Uw, V = exchange_factors(ops, Co, sgn)
    K4 = radial_exchange_dia_occ(Uw, V, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2,
                                 ops.step_ilm, ops.gidx)
    return _finish_K(ops, K4)


# device memory that exchange_dia lets one batch of dense R families take
_R_BATCH_BYTES = 2**31


def exchange_weights(ops: DiatomicOperators, P: torch.Tensor,
                     channels: slice = slice(None)) -> torch.Tensor:
    """The dense weights R [S, 4, nang, nang, nrad, nrad] of the exchange
    channels in `channels` for the kernel radial_exchange_dia: the
    two-sided Gaunt transforms of P, families (0,0), (0,2), (2,0), (2,2)
    with their signs and channel weights (diatomic.py:900-911)."""
    nang, nrad = ops.shellmask.shape
    P4 = _to4(P, nang, nrad)
    Gq, w2 = _step_tables(ops)
    Gq, w2 = Gq[channels], w2[channels]
    sign = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=P.dtype, device=P.device)
    half = torch.einsum("sqtba,adIJ->sqtbdIJ", w2[:, None, :, None, None] * Gq, P4)
    R = torch.einsum("qr,srtcd,sqtbdIJ->sqrbcIJ", sign, Gq, half)
    return R.reshape(R.shape[0], 4, nang, nang, nrad, nrad).contiguous()


def exchange_dia(ops: DiatomicOperators, P: torch.Tensor) -> torch.Tensor:
    """K(P) for a SYMMETRIC P (diatomic.py:799-941; negative contribution):
    the upper cross-element triangle is taken as the transpose of the lower
    one, which needs P = P^T, as every SCF density is. A caller with a
    non-symmetric P symmetrises it first. For callers that have only P;
    the SCF has the occupied orbitals and calls exchange_dia_occ.

    Per (L,|M|) channel the dense R families (exchange_weights,
    torch.einsum) go to the kernel radial_exchange_dia, in batches of
    channels that keep R below 2 GiB."""
    nang, nrad = ops.shellmask.shape
    nlm = ops.step_ilm.shape[0]
    batch = max(1, _R_BATCH_BYTES // (8 * 4 * nang * nang * nrad * nrad))
    K4 = torch.zeros((nang, nang, nrad, nrad), dtype=P.dtype, device=P.device)
    for s0 in range(0, nlm, batch):
        sl = slice(s0, min(s0 + batch, nlm))
        K4 = K4 + radial_exchange_dia(exchange_weights(ops, P, sl), ops.teiJ3, ops.dP0,
                                      ops.dP2, ops.dQ0, ops.dQ2, ops.step_ilm[sl], ops.gidx)
    return _finish_K(ops, K4)
