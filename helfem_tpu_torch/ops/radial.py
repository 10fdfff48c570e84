"""Atomic radial basis (L3): functions b_n(r) = B_n(r)/r on the FEM grid.

Carried over from helfem_tpu/ops/radial.py (numpy/longdouble host setup):
the one-electron matrices, the disjoint moments and the numpy path of the
in-element TEI tensor, and the Yukawa and erfc tables of the
range-separated exchange, and the origin values of the post-SCF
analysis. Not ported: the opt-in native C++ TEI builder.

Redesign of atomic::basis::RadialBasis (libhelfem/src/RadialBasis.cpp,
include/RadialBasis.h):

* The reference stabilizes B(r)/r near the nucleus with an automatically
  located small-r Taylor-series switchover (RadialBasis.cpp:59-133). Here the
  r factor is cancelled ANALYTICALLY: in the first element r=0 is a LIP node,
  so every retained basis function carries an exact (x+1) product factor,
  which LIPBasis.eval_div divides out in exact arithmetic. No cutoff, no
  Taylor error.

* All operators are built from element-stacked tensors [nelem, nq, nprim]
  (B, B', b, b', b'') with one einsum + scatter-add, replacing the
  OpenMP-over-elements matrix_element driver.

* Two-electron radial integrals:
  - disjoint moments <r^L>, <r^-L-1> per element (RadialBasis.cpp:478-558),
  - in-element integrals by double quadrature with a segment-wise cumulative
    inner integral, rescaled by ratio powers (r'/r_q)^L for stability --
    algebraically identical to quadrature::twoe_inner_integral
    (libhelfem/src/quadrature.cpp:23-126) but fully vectorized over
    (L, segment, inner-point, function-pair).

Conventions (identical to the reference):
  overlap            = int B_i B_j dr
  kinetic            = 1/2 int B_i' B_j' dr
  kinetic_l          = 1/2 int B_i B_j / r^2 dr       (multiplied by l(l+1))
  nuclear            = -int B_i B_j / r dr            (multiplied by Z)
  radial_integral(n) = int B_i B_j r^n dr
"""

from dataclasses import dataclass, field

import numpy as np

from helfem_tpu_torch.ops.bessel import bessel_il, bessel_kl
from helfem_tpu_torch.ops.erfc_expn import phi_table
from helfem_tpu_torch.ops.fem import FEMBasis
from helfem_tpu_torch.ops.quadrature import chebyshev

__all__ = ["RadialBasis"]


@dataclass
class RadialBasis:
    fem: FEMBasis
    nquad: int

    xq: np.ndarray = field(init=False)  # [nq]
    wq: np.ndarray = field(init=False)  # [nq]
    r: np.ndarray = field(init=False)  # [nelem, nq]
    wr: np.ndarray = field(init=False)  # [nelem, nq] quadrature weight incl. rlen
    B: np.ndarray = field(init=False)  # [nelem, nq, nprim]
    dB: np.ndarray = field(init=False)
    d2B: np.ndarray = field(init=False)
    b: np.ndarray = field(init=False)  # B/r, exact at the origin
    db: np.ndarray = field(init=False)
    d2b: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.fem.bval[0] != 0.0:
            raise ValueError("atomic radial basis requires bval[0] == 0")
        self.xq, self.wq = chebyshev(self.nquad)
        self.r = self.fem.coords(self.xq)
        self.wr = self.wq[None, :] * (0.5 * self.fem.lengths)[:, None]
        dn = self.fem.eval_dnf(self.xq, 2)
        self.B, self.dB, self.d2B = dn[0], dn[1], dn[2]
        self.b, self.db, self.d2b = self._eval_b()

    # --- b = B/r evaluation ---------------------------------------------------
    def _eval_b(self):
        nelem, nq = self.r.shape
        b = np.empty_like(self.B)
        db = np.empty_like(self.B)
        d2b = np.empty_like(self.B)
        # elements > 0: plain quotient rules, r bounded away from 0
        r = self.r[1:, :, None]
        b[1:] = self.B[1:] / r
        db[1:] = self.dB[1:] / r - self.B[1:] / r**2
        d2b[1:] = self.d2B[1:] / r - 2 * self.dB[1:] / r**2 + 2 * self.B[1:] / r**3
        # element 0: exact/stable division by the (x+1) root; the FEM layer
        # applies the d/dr chain rule, leaving one extra 1/half for 1/r
        g = self.fem.eval_element_div(0, self.xq, -1.0, 2)  # [3, nq, nprim]
        half = 0.5 * self.fem.lengths[0]
        b[0] = g[0] / half
        db[0] = g[1] / half
        d2b[0] = g[2] / half
        return b, db, d2b

    # --- generic quadrature contraction ----------------------------------------
    def _elmat(self, lh, rh, f=None):
        w = self.wr if f is None else self.wr * f
        return np.einsum("eqi,eq,eqj->eij", lh, w, rh, optimize=True)

    def _me(self, lh, rh, f=None):
        return self.fem.assemble(self._elmat(lh, rh, f))

    # --- one-electron operators -------------------------------------------------
    def overlap(self) -> np.ndarray:
        return self._me(self.B, self.B)

    def kinetic(self) -> np.ndarray:
        return 0.5 * self._me(self.dB, self.dB)

    def kinetic_l(self) -> np.ndarray:
        return 0.5 * self._me(self.b, self.b)

    def nuclear(self) -> np.ndarray:
        return -self._me(self.b, self.b, f=self.r)

    def radial_integral(self, n: int) -> np.ndarray:
        """<B_i | r^n | B_j> assembled globally."""
        return self._me(self.b, self.b, f=self.r ** (n + 2))

    def model_potential(self, Vr: np.ndarray) -> np.ndarray:
        """<b_i | V(r) | b_j> r^2 for V values on the element grid [nelem, nq]."""
        return self._me(self.b, self.b, f=self.r**2 * Vr)

    def radial_integral_el(self, n: int) -> np.ndarray:
        """Per-element moment matrices [nelem, nprim, nprim] (no assembly):
        the 'disjoint' factors of cross-element TEIs
        (reference: RadialBasis::radial_integral(L, iel))."""
        return self._elmat(self.b, self.b, f=self.r ** (n + 2))

    # --- nuclear values --------------------------------------------------------
    def bf_at_origin(self) -> np.ndarray:
        """b_i(0) = B_i'(0) of the first element's functions, global [nbf]
        (helfem_tpu radial.py:125-130)."""
        g = self.fem.eval_element_div(0, np.array([-1.0]), -1.0, 0)[0, 0]
        vals = np.zeros((self.fem.nelem, self.fem.nprim))
        vals[0] = g / (0.5 * self.fem.lengths[0])
        return self.fem.assemble_vec(vals)

    def dbf_at_origin(self) -> np.ndarray:
        """b_i'(0), global [nbf], for the cusp (helfem_tpu radial.py:132-138)."""
        g = self.fem.eval_element_div(0, np.array([-1.0]), -1.0, 1)[1, 0]
        vals = np.zeros((self.fem.nelem, self.fem.nprim))
        vals[0] = g / (0.5 * self.fem.lengths[0])
        return self.fem.assemble_vec(vals)

    # --- two-electron integrals --------------------------------------------------
    def twoe_integral(self, Lmax: int) -> np.ndarray:
        """In-element TEI tensor [NL, nelem, nprim, nprim, nprim, nprim] with
        NL = Lmax+1, entry (L, e, i, j, k, l) =
          int_e int_e B_i(r) B_j(r) r_<^L / r_>^{L+1} B_k(r') B_l(r') dr dr'.

        Vectorized double quadrature: outer points r_q; inner integral built
        from per-segment fresh quadratures and a cumulative ratio-rescaled
        recurrence (reference: quadrature.cpp:60-126). Stable because only
        ratio powers (r'/r_q)^L <= 1 appear.
        """
        nelem, nq = self.r.shape
        nprim = self.fem.nprim
        NL = Lmax + 1
        x, w = self.xq, self.wq
        out = np.empty((NL, nelem, nprim, nprim, nprim, nprim))
        Ls = np.arange(NL)[:, None, None]  # [NL,1,1]
        for e in range(nelem):
            rq = self.r[e]  # [nq] outer points
            lo = np.concatenate([[self.fem.bval[e]], rq[:-1]])  # segment lows
            hi = rq  # segment highs
            mid = 0.5 * (lo + hi)
            hlen = 0.5 * (hi - lo)
            rp = mid[:, None] + hlen[:, None] * x[None, :]  # [nq_seg, nq_in]
            # basis values at inner points (mask via fem.eval path)
            xpoly = (rp - self.fem.mids[e]) / (0.5 * self.fem.lengths[e])
            Bin = self.fem.eval_element(e, xpoly.ravel(), 0)[0].reshape(nq, nq, nprim)
            # segment integrals for all L: weight w_q' * hlen_p * (r'/r_p)^L / r_p
            ratio = rp / hi[:, None]  # <= 1
            wseg = (
                w[None, None, :]
                * hlen[None, :, None]
                * ratio[None, :, :] ** Ls
                / hi[None, :, None]
            )  # [NL, nq_seg, nq_in]
            seg = np.einsum("Lpq,pqk,pql->Lpkl", wseg, Bin, Bin, optimize=True)
            # cumulative inner integral with ratio rescaling:
            # inner[p] = seg[p] + inner[p-1] * (r_{p-1}/r_p)^{L+1}
            inner = np.empty_like(seg)
            inner[:, 0] = seg[:, 0]
            rr = rq[:-1] / rq[1:]  # [nq-1]
            fac = rr[None, :] ** (np.arange(NL)[:, None] + 1)  # [NL, nq-1]
            for p in range(1, nq):
                inner[:, p] = seg[:, p] + inner[:, p - 1] * fac[:, p - 1, None, None]
            # outer contraction + symmetrization
            Bw = self.B[e] * self.wr[e][:, None]  # [nq, nprim]
            I = np.einsum("pi,pj,Lpkl->Lijkl", Bw, self.B[e], inner, optimize=True)
            out[:, e] = I + I.transpose(0, 3, 4, 1, 2)
        return out

    def yukawa_disjoint(self, Lmax: int, lam: float):
        """(i_el, k_el): per-element <B_i B_j i_L(lam r)> and <.. k_L(lam r)>
        [NL, nelem, nprim, nprim] for the range-separated exchange
        (reference: RadialBasis::bessel_il/kl_integral). k of element 0 is
        zeroed (never used; integrand singular at r -> 0)."""
        nelem, nq = self.r.shape
        iv = bessel_il(lam * self.r.ravel(), Lmax).reshape(Lmax + 1, nelem, nq)
        kv = bessel_kl(lam * self.r.ravel(), Lmax).reshape(Lmax + 1, nelem, nq)
        w = self.wr * self.r**2
        i_el = np.einsum("eqi,Leq,eq,eqj->Leij", self.b, iv, w, self.b, optimize=True)
        k_el = np.einsum("eqi,Leq,eq,eqj->Leij", self.b, kv, w, self.b, optimize=True)
        k_el[:, 0] = 0.0
        return i_el, k_el

    def yukawa_integral(self, Lmax: int, lam: float) -> np.ndarray:
        """In-element Yukawa TEI tensor [NL, nelem, np, np, np, np]:
        int int B_i B_j i_L(lam r<) k_L(lam r>) B_k B_l dr dr'
        (reference: quadrature::yukawa_integral, quadrature.cpp:128-169)."""
        nelem, nq = self.r.shape
        nprim = self.fem.nprim
        NL = Lmax + 1
        x, w = self.xq, self.wq
        out = np.empty((NL, nelem, nprim, nprim, nprim, nprim))
        for e in range(nelem):
            rq = self.r[e]
            lo = np.concatenate([[self.fem.bval[e]], rq[:-1]])
            hi = rq
            mid, hlen = 0.5 * (lo + hi), 0.5 * (hi - lo)
            rp = mid[:, None] + hlen[:, None] * x[None, :]
            xpoly = (rp - self.fem.mids[e]) / (0.5 * self.fem.lengths[e])
            Bin = self.fem.eval_element(e, xpoly.ravel(), 0)[0].reshape(nq, nq, nprim)
            iv_in = bessel_il(lam * rp.ravel(), Lmax).reshape(NL, nq, nq)
            kv_out = bessel_kl(lam * rq, Lmax)  # [NL, nq]
            # inner segment weights: w * hlen * i_L(lam r') * k_L(lam r_p)
            wseg = w[None, None, :] * hlen[None, :, None] * iv_in * kv_out[:, :, None]
            seg = np.einsum("Lpq,pqk,pql->Lpkl", wseg, Bin, Bin, optimize=True)
            inner = np.empty_like(seg)
            inner[:, 0] = seg[:, 0]
            fac = kv_out[:, 1:] / kv_out[:, :-1]  # [NL, nq-1]
            for p in range(1, nq):
                inner[:, p] = seg[:, p] + inner[:, p - 1] * fac[:, p - 1, None, None]
            Bw = self.B[e] * self.wr[e][:, None]
            I = np.einsum("pi,pj,Lpkl->Lijkl", Bw, self.B[e], inner, optimize=True)
            out[:, e] = I + I.transpose(0, 3, 4, 1, 2)
        return out

    def erfc_integral(self, Lmax: int, mu: float) -> np.ndarray:
        """Dense short-range (erfc) TEI tensor over ALL element pairs
        [NL, nelem, nelem, np, np, np, np]:
        int_e int_f B_i B_j(r) Phi_L(mu r, mu r') B_k B_l(r') dr dr'
        -- the erfc kernel does not factorize (reference:
        quadrature::erfc_integral, quadrature.cpp:171-222). Phi is symmetric
        in its two arguments, so it is evaluated on the upper triangle of the
        (point, point') grid and mirrored: the same values as on the full
        grid, in half the host time."""
        nelem, nq = self.r.shape
        NL = Lmax + 1
        rflat = self.r.ravel()
        npt = rflat.size
        iu, ju = np.triu_indices(npt)
        Fu = phi_table(NL - 1, mu * rflat[iu], mu * rflat[ju])
        F = np.empty((NL, npt, npt))
        F[:, iu, ju] = Fu
        F[:, ju, iu] = Fu
        F = F.reshape(NL, nelem, nq, nelem, nq)
        Bw = self.B * self.wr[:, :, None]  # [e, q, i]
        # pair products with outer weights on the bra side only
        return np.einsum(
            "eqi,eqj,Leqfp,fpk,fpl->Lefijkl", Bw, self.B, F, Bw, self.B, optimize=True
        )

    def disjoint_integrals(self, Lmax: int):
        """(disjoint_L, disjoint_m1L): per-element moment matrices
        [NL, nelem, nprim, nprim] of r^L and r^{-L-1}.

        disjoint_m1L of element 0 is zeroed: it is never used (element 0 is
        always the innermost) and its integrand is singular for L >= 2
        (reference computes-but-never-uses it, TwoDBasis.cpp:672-678)."""
        NL = Lmax + 1
        dL = np.stack([self.radial_integral_el(L) for L in range(NL)])
        dm = np.stack([self.radial_integral_el(-L - 1) for L in range(NL)])
        dm[:, 0] = 0.0
        return dL, dm
