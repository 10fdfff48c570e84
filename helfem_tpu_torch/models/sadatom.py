"""Spherically averaged atom solver (sadatom / gensap), ported from
helfem_tpu/models/sadatom.py: the restricted and the unrestricted
(spin-polarised) solvers and their configuration searches.

Orbitals live in per-l radial channels with integer shell occupations
(fractional filling of a degenerate shell by capacity weighting); the
density is spherically averaged, so

  * Coulomb is pure L=0: models/atomic.py:coulomb with a trivial angular
    shell on a second operator set that holds only the L=0 tables, so the
    radial_coulomb kernel (K2) streams one TEI slice set, not NL;
  * exact exchange is l-resolved with m-averaged angular weights
    totcoup(L; lout, lin) = sum_{mo,mi} G(lo mo; L M; li mi)^2 / (2 lout + 1)
    (reference: sadatom TwoDBasis::exchange, src/sadatom/basis.cpp:360-460).
    The radial kernel is linear in its density, so ONE radial_exchange
    launch (K1) on the m-averaged cube Pang gives KK[L, k] for every (L, k)
    and K[o] = -sum_{L,k} Lfac_L totcoup[L, o, k] KK[L, k]; unrestricted,
    both spins' cubes go through that one launch as 2 nl channels;
  * XC lives on a radial-only grid: the single-angle case of the atomic
    grid (nang = 1, nt = 1, TT = 1/(4 pi), dTT = 0), built once with the
    operators, so the XC kernels dia_xc_fields (K4) and dia_xc_fock (K5)
    run it, one launch each per Fock build (LDA/GGA). Meta-GGAs run a
    second radial grid with two shells (sad_tau_grid): shell 0 holds
    sum_l P_l, shell 1 sum_l l(l+1) P_l, and the tables put the centrifugal
    piece of tau and of its Fock term on shell 1, so one tau-mode launch
    of each kernel per Fock build gives tau and the per-l Fock cube
    F + F1 + l(l+1) F2 (sadatom.py:202-267).

The per-l channel axis is a batch axis: one batched whitened eigensolve
(torch.linalg.eigh with helfem_tpu's refinement passes) across all
channels, of both spins when unrestricted. After two host iterations (numpy
DIIS) the SCF runs as steps over device tensors, with the level shift
switched off on the device once the DIIS error drops below 1e-3, and one
boolean per iteration back to the host.

SadAtomBasis takes helfem_tpu's finite nuclei with their sub-grid, the
confinement (folded into the nuclear slot) and --zeroder. Not ported (it
raises NotImplementedError): the multiplicative potential of a meta-GGA
(_mult_vxc_radial, as in helfem_tpu). The laplacian-level BR89 raises SadLaplacianError (a
ValueError): helfem_tpu's SAD atom has no laplacian path. diisthr is taken
and handed to the DIIS, where it is inert, as in helfem_tpu: its blend
needs the ADIIS weights, which the SAD solvers switch off.
"""

from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from helfem_tpu_torch.kernels import radial_exchange
from helfem_tpu_torch.models.atomic import (
    AtomicOperators,
    confinement_Vr,
    coulomb,
    from_jax_operators,
    nuclear_model_V,
)
from helfem_tpu_torch.kernels import dia_xc_fields, dia_xc_fock
from helfem_tpu_torch.models.atomic_dft import AtomGridOps, eval_fxc, tau_factors
from helfem_tpu_torch.models.xc_grid import build_grid
from helfem_tpu_torch.models.sadconf import aufbau_from_energies as aufbau_occs
from helfem_tpu_torch.models.sadconf import shell_capacity
from helfem_tpu_torch.ops.fem import FEMBasis
from helfem_tpu_torch.ops.gaunt import gaunt_coefficient
from helfem_tpu_torch.ops.grids import form_grid
from helfem_tpu_torch.ops.polynomials import get_basis
from helfem_tpu_torch.ops.radial import RadialBasis
from helfem_tpu_torch.ops.xc import parse_method, xc_eval
from helfem_tpu_torch.scf.common import vdot, warm_gate
from helfem_tpu_torch.scf.diis import DIIS, device_diis_step
from helfem_tpu_torch.scf.guess import potential
from helfem_tpu_torch.utils.linalg import eigh_refined, eigh_warm, form_sinvh

__all__ = ["SadAtomBasis", "SadLaplacianError", "SadOps", "SadResult", "from_jax_sad_ops",
           "sad_coulomb", "sad_method",
           "sad_exchange", "sad_xc", "search_sadatom_unrestricted", "solve_sadatom",
           "solve_sadatom_unrestricted", "sap_potential_table", "totcoup_table"]

class SadLaplacianError(ValueError):
    """A laplacian-level functional (family mggal, BR89) asked of the
    spherically averaged atom: helfem_tpu's SAD atom (sadatom.py:sad_xc)
    forms no density laplacian, so neither does the port's."""


def sad_method(method: str):
    """(funcs, kfrac) of a SAD method; raises SadLaplacianError for a
    laplacian-level functional."""
    funcs, kfrac = parse_method(method)
    if any(f.family == "mggal" for f in funcs):
        raise SadLaplacianError(
            f"'{method}' is a laplacian-level functional (family mggal): helfem_tpu's "
            "spherically averaged atom has no laplacian path, so the SAD solvers and gensap "
            "take LDA, GGA and meta-GGA functionals only")
    return funcs, kfrac


def totcoup_table(lmax: int) -> np.ndarray:
    """m-averaged squared Gaunt couplings [NL, nl, nl] with NL = 2*lmax+1."""
    NL = 2 * lmax + 1
    t = np.zeros((NL, lmax + 1, lmax + 1))
    for lo in range(lmax + 1):
        for li in range(lmax + 1):
            for mo in range(-lo, lo + 1):
                for mi in range(-li, li + 1):
                    M = mo - mi
                    for L in range(abs(lo - li), lo + li + 1):
                        c = gaunt_coefficient(lo, mo, L, M, li, mi)
                        t[L, lo, li] += c * c
            t[:, lo, li] /= 2 * lo + 1
    return t


class SadOps(NamedTuple):
    """Device constants of the solver (fields of helfem_tpu's SadOps, plus
    at0 and grid)."""

    at: AtomicOperators  # nang=1 operators (radial S/T/Vnuc, TEI tensors)
    at0: AtomicOperators  # at with only its L=0 slices (contiguous): Coulomb's set
    Tl: torch.Tensor  # [nrad, nrad] 1/2 <BB/r^2>
    totcoup: torch.Tensor  # [NL, nl, nl]
    # radial XC grid
    bg: torch.Tensor
    dbg: torch.Tensor
    r: torch.Tensor
    w2: torch.Tensor  # wr * 4 pi r^2
    grid: AtomGridOps  # the radial grid in the XC kernels' layout (sad_grid)
    tgrid: AtomGridOps  # its two-shell form for meta-GGAs (sad_tau_grid)

    @property
    def device(self) -> torch.device:
        return self.at.device

    def to(self, device) -> "SadOps":
        at = self.at.to(device)
        return SadOps(at, _l0_operators(at), *(t.to(device) for t in self[2:]))


def _l0_operators(at: AtomicOperators) -> AtomicOperators:
    """The L=0 slices of the TEI tensors, G and Lfac as contiguous tensors of
    their own (built once per operator set: K2's launch template is keyed by
    them); the one-electron matrices are shared."""
    return at._replace(**{k: getattr(at, k)[:1].contiguous()
                          for k in ("G", "Lfac", "tei", "disjL", "disjm1L")})


def sad_grid(arrays: Mapping, nrad: int, device) -> AtomGridOps:
    """The radial XC grid as the XC kernels take it: the atomic grid with
    one angular shell and one angular point, TT = 1/(4 pi) and dTT = 0, so
    rho = D1 / (4 pi) and u = Dmu / (4 pi) are helfem_tpu's n and dn/dr
    (sadatom.py:202-267), and w = w2. arrays holds bg, dbg, r, w2 and
    at["gidx"] (from_jax_sad_ops's layout); nrad is the radial size."""
    one, zero = np.ones((1, 1, 1)), np.zeros((1, 1, 1))
    return _radial_grid(arrays, nrad, device, one / (4.0 * np.pi), zero)


def sad_tau_grid(arrays: Mapping, nrad: int, device) -> AtomGridOps:
    """The meta-GGA form of sad_grid: two angular shells on one point, the
    density blockdiag(sum_l P_l, sum_l l(l+1) P_l), TT = diag(1, 0) / (4 pi)
    and TTm2 = diag(0, 1) / (4 pi) with the atomic tau factors (1, 1/r^2,
    1/r^2). Then rho and u are sad_grid's, and the kernels' tau is
    1/2 [Ddd(sum_l P_l) + D1(sum_l l(l+1) P_l) / r^2] / (4 pi), helfem_tpu's
    (sadatom.py:220-230); the Fock's shell-0 block is F + F1 and its
    shell-1 block F2, so channel l's Fock is F + F1 + l(l+1) F2
    (sadatom.py:256-265)."""
    TT = np.zeros((2, 2, 1))
    TTm2 = np.zeros((2, 2, 1))
    TT[0, 0, 0] = TTm2[1, 1, 0] = 1.0 / (4.0 * np.pi)
    return _radial_grid(arrays, nrad, device, TT, TTm2)


def _radial_grid(arrays: Mapping, nrad: int, device, TT: np.ndarray,
                 TTm2: np.ndarray) -> AtomGridOps:
    w = np.asarray(arrays["w2"])[:, :, None]
    zero = np.zeros_like(TT)
    return build_grid(AtomGridOps, dict(
        Bg=arrays["bg"], dBg=arrays["dbg"], w=w, invh=np.ones_like(w), TT=TT, dTT=zero,
        dTT2=zero, TTm2=TTm2, tfac=tau_factors(arrays["r"], 1), sqeta=np.ones(1),
        gidx=arrays["at"]["gidx"], r=arrays["r"]), nrad, device)


def from_jax_sad_ops(arrays: Mapping, device) -> SadOps:
    """The port's SadOps from helfem_tpu's SadOps given as numpy arrays:
    arrays["at"] holds the AtomicOperators fields (models/atomic.py:
    from_jax_operators), the other keys the SadOps fields; the XC grids are
    built from them (sad_grid, sad_tau_grid)."""
    at = from_jax_operators(arrays["at"], device)

    def dev(name):
        return torch.tensor(np.asarray(arrays[name]), dtype=torch.float64, device=device)

    nrad = at.Sinvh_rad.shape[0]
    return SadOps(at, _l0_operators(at), *(dev(n) for n in SadOps._fields[2:-2]),
                  sad_grid(arrays, nrad, device), sad_tau_grid(arrays, nrad, device))


@dataclass
class SadAtomBasis:
    """The radial basis of the spherically averaged atom (helfem_tpu's
    SadAtomBasis, sadatom.py:79-150): finitenuc/Rrms the nuclear charge
    model, nelem0/igrid0/zexp0 its sub-grid (reference gensap --finitenuc
    --Rrms --nelem0 --grid0 --zexp0); iconf with conf_N, conf_R,
    conf_barrier and shift_conf the confinement (--iconf family), folded
    into the nuclear slot (Vconf keeps it, for Econf); conf_boundary an
    element boundary; zeroder drops the derivative DOF at rmax too."""

    Z: int
    lmax: int = 3
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
    iconf: int = 0
    conf_N: int = 0
    conf_R: float = 0.0
    conf_barrier: float = 0.0
    shift_conf: float = 0.0
    conf_boundary: float = 0.0
    zeroder: bool = False

    rb: RadialBasis = field(init=False)
    Vconf: np.ndarray | None = field(init=False)

    def __post_init__(self):
        poly = get_basis(self.primbas, self.nnodes)
        if self.nquad == 0:
            self.nquad = 5 * self.nnodes
        bval = form_grid(self.finitenuc, self.Rrms, self.nelem, self.rmax, self.igrid, self.zexp,
                         self.nelem0, self.igrid0, self.zexp0, self.Z, 0, 0, 0.0,
                         self.conf_boundary)
        self.rb = RadialBasis(FEMBasis(poly, bval, drop_last_deriv=self.zeroder), self.nquad)
        self.Vconf = None
        if self.iconf:
            N = self.conf_N if self.iconf != 3 else self.conf_barrier
            self.Vconf = self.rb.model_potential(
                confinement_Vr(self.rb.r, self.rmax, N, self.conf_R, self.iconf,
                               self.shift_conf))

    @property
    def nrad(self) -> int:
        return self.rb.fem.nbf

    @property
    def NL(self) -> int:
        return 2 * self.lmax + 1

    def host_ops(self) -> dict:
        """The SadOps fields as numpy arrays (from_jax_sad_ops's layout),
        computed as helfem_tpu's SadAtomBasis.build_ops computes them."""
        rb = self.rb
        NL = self.NL
        disjL, disjm1L = rb.disjoint_integrals(NL - 1)
        G = np.zeros((NL, 1, 1, 1))
        G[0, 0, 0, 0] = 1.0 / np.sqrt(4.0 * np.pi)
        T = rb.kinetic()
        if self.finitenuc == "point":
            Vnuc = self.Z * rb.nuclear()
        else:
            Vnuc = rb.model_potential(nuclear_model_V(self.finitenuc, self.Z, self.Rrms)(rb.r))
        if self.Vconf is not None:
            # folded into the nuclear slot: the Fock build and the total
            # energy take it; the CLI prints Econf = <P, Vconf> apart
            Vnuc = Vnuc + self.Vconf
        S = rb.overlap()
        at = dict(gidx=rb.fem.gidx, G=G, Lfac=4.0 * np.pi / (2.0 * np.arange(NL) + 1.0),
                  tei=rb.twoe_integral(NL - 1), disjL=disjL, disjm1L=disjm1L, S=S,
                  H0=T + Vnuc, T=T, Vnuc=Vnuc, Sinvh_rad=form_sinvh(S))
        return dict(at=at, Tl=rb.kinetic_l(), totcoup=totcoup_table(self.lmax), bg=rb.b,
                    dbg=rb.db, r=rb.r, w2=rb.wr * 4.0 * np.pi * rb.r**2)

    def build_ops(self, device) -> SadOps:
        return from_jax_sad_ops(self.host_ops(), device)


# ----------------------------------------------------------------------------
# Fock pieces
# ----------------------------------------------------------------------------


def sad_exchange(ops: SadOps, Pang: torch.Tensor) -> torch.Tensor:
    """l-resolved exchange cube K[..., nl, nrad, nrad] (negative
    contribution) from the m-averaged angular density cube Pang[..., nl,
    nrad, nrad] (a leading spin axis optional): one radial_exchange call for
    every (L, channel) of every spin, then the totcoup and Lfac contraction
    (helfem_tpu's per-L scan, sadatom.py:181-199, by linearity)."""
    at = ops.at
    KK = radial_exchange(at.tei, at.disjL, at.disjm1L, at.gidx,
                         Pang.reshape(-1, *Pang.shape[-2:]).contiguous())
    KK = KK.reshape(KK.shape[0], *Pang.shape)
    return -torch.einsum("Lok,L...kIJ->...oIJ", at.Lfac[:, None, None] * ops.totcoup, KK)


def sad_coulomb(ops: SadOps, Pr: torch.Tensor) -> torch.Tensor:
    """J[nrad, nrad] of the spherically averaged density Pr [nrad, nrad]:
    models/atomic.py:coulomb on the L=0 operator set (G[L>0] = 0, so the
    L>0 slices would contribute exact zeros)."""
    return coulomb(ops.at0, Pr)


def sad_xc(funcs, ops: SadOps, Pla: torch.Tensor, Plb: torch.Tensor, thr: float = 1e-12):
    """Radial XC (sadatom.py:202-267): returns (Fxc_a, Fxc_b, Exc, Nel), the
    Fock a single radial matrix for LDA/GGA and an [nl, nrad, nrad] cube
    for meta-GGAs (the vtau term carries the l(l+1) centrifugal piece).

    LDA/GGA: the density n_s(r) = sum_l P^s_l[I,J] b_I b_J / (4 pi) is the
    atomic grid's on ops.grid (one angular shell and point, dTT = 0), so
    this is atomic_dft.eval_fxc there. Meta-GGAs run ops.tgrid
    (sad_tau_grid). Either way one dia_xc_fields and one dia_xc_fock launch
    per call, for one spin when Plb is Pla."""
    if not any(f.family == "mgga" for f in funcs):
        Pa = Pla.sum(0)
        return eval_fxc(funcs, ops.grid, Pa, Pa if Plb is Pla else Plb.sum(0), thr)
    g = ops.tgrid
    nl = Pla.shape[0]
    ll1 = torch.arange(nl, dtype=Pla.dtype, device=Pla.device)
    ll1 = ll1 * (ll1 + 1.0)

    def two_shells(Pl):  # blockdiag(sum_l P_l, sum_l l(l+1) P_l)
        return torch.block_diag(Pl.sum(0), torch.einsum("l,lij->ij", ll1, Pl))

    same = Plb is Pla
    P = two_shells(Pla)[None] if same else torch.stack((two_shells(Pla), two_shells(Plb)))
    rho, du, _, tau = dia_xc_fields(P, g, True)
    na, dna, ta = rho[0], du[0], tau[0]
    nb, dnb, tb = (na, dna, ta) if same else (rho[1], du[1], tau[1])
    e, vra, vrb, vsaa, vsab, vsbb, vta, vtb = xc_eval(funcs, na, nb, dna * dna, dna * dnb,
                                                      dnb * dnb, thr, ta, tb)
    Exc = torch.sum(g.w * e)
    Nel = torch.sum(g.w * (na + nb))
    pots = [(vra, 2.0 * vsaa * dna + vsab * dnb, vta)]
    if not same:
        pots.append((vrb, 2.0 * vsbb * dnb + vsab * dna, vtb))
    vr, gr, vt = (torch.stack(x) for x in zip(*pots))
    F = dia_xc_fock(g.w * vr, g.w * gr, torch.zeros_like(vr), g, wvt=g.w * vt)
    nrad = F.shape[-1] // 2
    cubes = F[:, :nrad, :nrad][:, None] + ll1[None, :, None, None] * F[:, nrad:, nrad:][:, None]
    return cubes[0], cubes[-1], Exc, Nel


def make_sad_fock(funcs, kfrac: float, nl: int, dftthr: float = 1e-12):
    """fock(ops, Pla, Plb, Panga, Pangb) -> (Fla, Flb, Ekin, Enuc, Ecoul,
    Exx, Exc, Nel) (sadatom.py:409-439). One K2 launch per call, on the
    total density; when kfrac != 0 one K1 launch, for Panga alone when
    Pangb is Panga (the restricted solver's call) and for both spins'
    stacked cubes otherwise; the energies are device scalars."""

    def fock(ops: SadOps, Pla, Plb, Panga, Pangb):
        Pl = Pla + Plb
        Pr = Pl.sum(0)
        J = sad_coulomb(ops, Pr)
        ll1 = torch.arange(nl, dtype=Pl.dtype, device=Pl.device)
        kc = (ll1 * (ll1 + 1.0))[:, None, None] * ops.Tl[None]
        Fla = Flb = (ops.at.H0 + J)[None] + kc
        zero = torch.zeros((), dtype=Pl.dtype, device=Pl.device)
        Exx = Exc = Nel = zero
        if kfrac != 0.0:
            if Pangb is Panga:
                Ka = Kb = kfrac * sad_exchange(ops, Panga)
            else:
                Ka, Kb = kfrac * sad_exchange(ops, torch.stack((Panga, Pangb)))
            Fla, Flb = Fla + Ka, Flb + Kb
            Exx = 0.5 * (vdot(Pla, Ka) + vdot(Plb, Kb))
        if funcs:
            XCa, XCb, Exc, Nel = sad_xc(funcs, ops, Pla, Plb, dftthr)
            # a radial matrix for LDA/GGA, a per-l cube for meta-GGAs
            Fla = Fla + (XCa if XCa.dim() == 3 else XCa[None])
            Flb = Flb + (XCb if XCb.dim() == 3 else XCb[None])
        Ekin = vdot(Pr, ops.at.T) + vdot(Pl, kc)
        Enuc = vdot(Pr, ops.at.Vnuc)
        Ecoul = 0.5 * vdot(Pr, J)
        return Fla, Flb, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    return fock


# ----------------------------------------------------------------------------
# occupations, eigensolves and the SCF step
# ----------------------------------------------------------------------------


def density_cubes(C: np.ndarray, occs: np.ndarray, restricted: bool = True):
    """(Pl, Pang): integer-occupation and capacity-averaged density cubes
    from orbitals C[nl, nrad, nmo] and per-l electron counts occs[nl]
    (restricted capacities 2(2l+1), or 2l+1 for one spin)."""
    nl, nrad, _ = C.shape
    Pl = np.zeros((nl, nrad, nrad))
    Pang = np.zeros((nl, nrad, nrad))
    for l in range(nl):
        cap = shell_capacity(l, restricted)
        left = int(occs[l])
        io = 0
        while left > 0:
            nocc = min(cap, left)
            c = C[l][:, io]
            Pl[l] += nocc * np.outer(c, c)
            Pang[l] += (nocc / cap) * np.outer(c, c)
            left -= nocc
            io += 1
    return Pl, Pang


def occ_weight_vectors(occs: np.ndarray, nl: int, nmo: int, restricted: bool = True):
    """(occw, angw)[nl, nmo]: per-orbital electron counts and capacity-
    averaged angular weights for fixed per-l electron counts, the static-
    occupation form of density_cubes."""
    occw = np.zeros((nl, nmo))
    angw = np.zeros((nl, nmo))
    for l in range(nl):
        cap = shell_capacity(l, restricted)
        left = int(occs[l])
        io = 0
        while left > 0:
            nocc = min(cap, left)
            occw[l, io] = nocc
            angw[l, io] = nocc / cap
            left -= nocc
            io += 1
    return occw, angw


def eig_channels(Fl: torch.Tensor, Sinvh: torch.Tensor):
    """Batched whitened eigensolve of the channel Fock cube [nl, nrad, nrad]:
    (E [nl, nrad] ascending, C [nl, nrad, nrad])."""
    Forth = Sinvh.T @ Fl @ Sinvh
    E, V = eigh_refined(Forth)
    return E, torch.einsum("pi,lij->lpj", Sinvh, V)


def shifted_fock(Fl: np.ndarray, C_prev: np.ndarray, occs, S: np.ndarray, shift: float,
                 restricted: bool = True) -> np.ndarray:
    """The channel Fock cube with the virtual orbitals of each l channel
    pushed up by `shift` via S Cv Cv^T S (reference:
    OrbitalChannel::UpdateOrbitalsShifted, solver.cpp:351-380). Host numpy."""
    Fl = np.array(Fl, copy=True)
    for l in range(Fl.shape[0]):
        cap = shell_capacity(l, restricted)
        nsh = int(np.ceil(occs[l] / cap)) if occs[l] > 0 else 0
        if nsh:
            Cv = C_prev[l][:, nsh:]
            Fl[l] += shift * (S @ Cv) @ (Cv.T @ S)
    return Fl


def _channel_error(Fl, Pl, S, Sinvh):
    """DIIS error Sinvh^T (F P S - its transpose) Sinvh of every channel."""
    FPS = Fl @ Pl @ S
    return (Sinvh.T @ (FPS - FPS.transpose(1, 2)) @ Sinvh).reshape(-1)


def make_sad_step(funcs, kfrac: float, nl: int, dftthr: float = 1e-12, shift: float = 1.0):
    """One SCF iteration on the device (the body of helfem_tpu's
    make_sad_fused_chunk, sadatom.py:325-405): densities -> Fock -> C2-DIIS
    (history updated in place) -> eigensolve with the level shift on the
    previous virtuals while the DIIS error is above 1e-3. occw, angw and C
    are tuples with one entry per spin (one when restricted, whose density
    is split evenly over the spins); unrestricted, the DIIS error is both
    spins' concatenated, the history holds the spin-stacked Focks, K1 runs
    once for both spins and both spins' 2 nl channels go through one
    batched eigensolve. The eigensolve is the warm-started one (eigh_warm,
    K11 with a certificate per spin against wgate) from Vw [ns nl, nrad,
    nrad], the previous whitened eigenvectors; the level shift's switch at
    1e-3 fails the certificate once, as helfem_tpu's comment says
    (sadatom.py:355-358)."""
    fock = make_sad_fock(funcs, kfrac, nl, dftthr)

    def step(ops: SadOps, occw, angw, C, Vw, histF, histE, count, wgate):
        S, Sinvh = ops.at.S, ops.at.Sinvh_rad
        restricted = len(C) == 1
        Pl = [(c * w[:, None, :]) @ c.mT for c, w in zip(C, occw)]
        Pang = [(c * w[:, None, :]) @ c.mT for c, w in zip(C, angw)]
        if restricted:
            Pl = [Pl[0] / 2.0]
        Fla, Flb, Ekin, Enuc, Ecoul, Exx, Exc, Nel = fock(ops, Pl[0], Pl[-1], Pang[0],
                                                          Pang[-1])
        F = (Fla, Flb)[:len(C)]
        err = torch.cat([_channel_error(f, p, S, Sinvh) for f, p in zip(F, Pl)])
        errmax = torch.max(torch.abs(err))
        Fuse, count = device_diis_step(histF, histE, count,
                                       F[0] if restricted else torch.stack(F), err)
        shift_eff = shift * (errmax > 1e-3).to(errmax.dtype)
        Fsh = []
        for f, c, w in zip(Fuse.reshape(-1, nl, *Fuse.shape[-2:]), C, occw):
            SC = torch.einsum("pq,lqk->lpk", S, c * (w <= 0.0).to(c.dtype)[:, None, :])
            Fsh.append(f + shift_eff * torch.einsum("lpk,lrk->lpr", SC, SC))
        E, V, _ = eigh_warm(Sinvh.T @ torch.cat(Fsh) @ Sinvh, Vw, gate=wgate, groups=len(C))
        Cn = torch.einsum("pi,lij->lpj", Sinvh, V)
        Etot = Ekin + Enuc + Ecoul + Exx + Exc
        return (Cn.split(nl), V, E.split(nl), count, Etot, errmax,
                torch.stack([Ekin, Ecoul, Exx, Exc, Nel]))

    return step


def make_sad_chunk(funcs, kfrac: float, nl: int, dftthr: float = 1e-12, shift: float = 1.0):
    """Up to `nrun` device steps with the convergence test (err < convthr
    and |dE| < convthr, the host loop's own) on the device after each; the
    occupations are fixed; Vw seeds the warm eigensolve (make_sad_step).
    Returns the per-step orbitals and eigenvalues (a tuple per spin),
    energies, errors and energy components, the new DIIS count, the number
    of steps run and the last step's whitened eigenvectors."""
    step = make_sad_step(funcs, kfrac, nl, dftthr, shift)

    def chunk(ops, occw, angw, C, Vw, histF, histE, count, convthr, Eprev, nrun):
        Ep = torch.tensor(Eprev, dtype=torch.float64, device=C[0].device)
        wgate = warm_gate(convthr)
        Cs, Es, Etots, errs, comps = [], [], [], [], []
        for _ in range(nrun):
            C, Vw, E, count, Etot, errmax, comp = step(ops, occw, angw, C, Vw, histF, histE,
                                                       count, wgate)
            Cs.append(C)
            Es.append(E)
            Etots.append(Etot)
            errs.append(errmax)
            comps.append(comp)
            done = (errmax < convthr) & (torch.abs(Etot - Ep) < convthr)
            Ep = Etot
            if bool(done):
                break
        return (Cs, Es, count, torch.stack(Etots), torch.stack(errs), torch.stack(comps),
                len(Cs), Vw)

    return chunk


@dataclass
class SadResult:
    converged: bool
    E: float
    occs: np.ndarray  # per-l electron counts (alpha's when unrestricted)
    Ekin: float
    Ecoul: float
    Exx: float
    Exc: float
    orbE: np.ndarray  # [nl, nmo]
    orbs: np.ndarray
    Pl: np.ndarray
    # beta of the unrestricted solver (None when restricted)
    occs_b: np.ndarray | None = None
    Plb: np.ndarray | None = None
    orbE_b: np.ndarray | None = None
    orbs_b: np.ndarray | None = None
    # energy-ordered configuration list from the ground-state search:
    # [(occs_key, E, converged)] with occs_key the per-l electron counts, or
    # an (occa, occb) pair of them when unrestricted
    conf_list: list | None = None
    # gensap --unrestricted: the spin-polarised solve beside this restricted one
    spin_polarised: "SadResult | None" = None
    niter: int = 0  # SCF iterations of the reported configuration
    nfock: int = 0  # Fock builds over every configuration solved
    walls: dict = field(default_factory=dict)  # phase -> seconds (CLI)
    Econf: float = 0.0  # <P, Vconf>, inside Enuc's slot (the gensap CLI's)


# ----------------------------------------------------------------------------
# solver
# ----------------------------------------------------------------------------


def _guess_channels(basis: SadAtomBasis, ops: SadOps, guess: str):
    """(E [nl, nrad], C [nl, nrad, nrad]) on the host: the channel
    eigenpairs of the kinetic energy plus the guess model potential."""
    nl = basis.lmax + 1
    rb = basis.rb
    Vg = torch.as_tensor(rb.model_potential(potential(guess, basis.Z, device=ops.device)(rb.r)),
                         dtype=torch.float64, device=ops.device)
    ll1 = torch.as_tensor(np.arange(nl) * (np.arange(nl) + 1.0), dtype=torch.float64,
                          device=ops.device)
    Hg = (ops.at.T + Vg)[None] + ll1[:, None, None] * ops.Tl[None]
    E, C = eig_channels(Hg, ops.at.Sinvh_rad)
    return E.cpu().numpy(), C.cpu().numpy()


def _sad_ops(basis: SadAtomBasis, ops: SadOps | None, device, fn: str) -> SadOps:
    if ops is None:
        if device is None:
            raise ValueError(f"{fn} needs a device (or prebuilt ops)")
        ops = basis.build_ops(device)
    return ops


def solve_sadatom_unrestricted(
    basis: SadAtomBasis,
    nela: int,
    nelb: int,
    method: str = "HF",
    occs_a: np.ndarray | None = None,
    occs_b: np.ndarray | None = None,
    maxit: int = 128,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    ops: SadOps | None = None,
    shift: float = 1.0,
    dftthr: float = 1e-12,
    diisorder: int = 10,
    diiseps: float = 0.1,
    device=None,
    diisthr: float | None = None,
) -> SadResult:
    """Spin-polarised spherically averaged SCF (helfem_tpu's
    solve_sadatom_unrestricted, sadatom.py:816-992; reference: the uconf_t
    path of src/sadatom/solver.cpp): occupations per l channel and spin,
    capacities 2l+1 per spin. occs_a and occs_b given fix the configuration;
    otherwise the aufbau occupations of each spin are refreshed after every
    host iteration and every device chunk (fixed chunks of 4, as
    helfem_tpu's). Each Fock build launches K2 once on the total density,
    K1 once for both spins' stacked cubes (HF and hybrids) and K4/K5 once
    with two spins (functionals). The operators are built on `device`
    unless `ops` is given, in which case the solve runs on ops' device."""
    fixed = occs_a is not None and occs_b is not None
    ops = _sad_ops(basis, ops, device, "solve_sadatom_unrestricted")
    device = ops.device
    nl, nrad = basis.lmax + 1, basis.nrad
    funcs, kfrac = sad_method(method)
    funcs = tuple(funcs)
    fock = make_sad_fock(funcs, kfrac, nl, dftthr)
    S_np = ops.at.S.cpu().numpy()
    Sinvh_np = ops.at.Sinvh_rad.cpu().numpy()
    Sinvh = ops.at.Sinvh_rad

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    Ea, Ca = _guess_channels(basis, ops, guess)
    Eb, Cb = Ea.copy(), Ca
    if occs_a is None:
        occs_a = aufbau_occs(Ea, nela, False)
    if occs_b is None:
        occs_b = aufbau_occs(Eb, nelb, False)
    diis = DIIS(S_np, Sinvh_np, max_hist=diisorder, diis_eps=diiseps, diis_thr=diisthr,
                adiis=False)
    Eold, Etot, converged = 0.0, 0.0, False
    Ekin = Ecoul = Exx = Exc = 0.0
    out = None
    warmup, CH = 2, 4
    chunk = None
    it = 0
    while it < maxit:
        it += 1
        if it > warmup:
            if chunk is None:
                chunk = make_sad_chunk(funcs, kfrac, nl, dftthr, shift)
                histF = torch.zeros((diisorder, 2, nl, nrad, nrad), dtype=torch.float64,
                                    device=device)
                histE = torch.zeros((diisorder, 2 * nl * nrad * nrad), dtype=torch.float64,
                                    device=device)
                count = 0
                # the warm eigensolve's seed: the identity fails the first
                # fused step's certificate, which then solves cold; the
                # whitened eigenvectors persist across chunks, per spin
                Vw = torch.eye(nrad, dtype=torch.float64, device=device).repeat(2 * nl, 1, 1)
            wa = occ_weight_vectors(occs_a, nl, nrad, False)
            wb = occ_weight_vectors(occs_b, nl, nrad, False)
            Cs, Es, count, Etots, errs, comps, kmax, Vw = chunk(
                ops, (as_dev(wa[0]), as_dev(wb[0])), (as_dev(wa[1]), as_dev(wb[1])),
                (as_dev(Ca), as_dev(Cb)), Vw, histF, histE, count, float(convthr), Eold,
                min(CH, maxit - it + 1))
            Etots = Etots.cpu().numpy()
            errs = errs.cpu().numpy()
            k = 0
            for k in range(kmax):
                Etot = float(Etots[k])
                err = float(errs[k])
                dE = Etot - Eold
                Eold = Etot
                if verbose:
                    print(f"  it {it + k:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
                if err < convthr and abs(dE) < convthr:
                    converged = True
                    break
            it += k
            Ekin, Ecoul, Exx, Exc = (float(x) for x in comps[k][:4].cpu())
            if converged or it >= maxit:
                # orbitals consistent with the reported Etot: step k's energy
                # comes from the post-eigh orbitals of step k-1 (the chunk
                # input for k = 0), as in the restricted solver
                if k > 0:
                    (Ca, Cb), (Ea, Eb) = ([x.cpu().numpy() for x in Cs[k - 1]],
                                          [x.cpu().numpy() for x in Es[k - 1]])
                out = (Etot, Ekin, Ecoul, Exx, Exc)
                break
            (Ca, Cb), (Ea, Eb) = ([x.cpu().numpy() for x in Cs[k]],
                                  [x.cpu().numpy() for x in Es[k]])
            if not fixed:
                occs_a = aufbau_occs(Ea, nela, False)
                occs_b = aufbau_occs(Eb, nelb, False)
            continue

        Pla, Panga = density_cubes(Ca, occs_a, False)
        Plb, Pangb = density_cubes(Cb, occs_b, False)
        Fla, Flb, Ekin_, Enuc, Ecoul_, Exx_, Exc_, _ = fock(
            ops, as_dev(Pla), as_dev(Plb), as_dev(Panga), as_dev(Pangb))
        Etot = float(Ekin_ + Enuc + Ecoul_ + Exx_ + Exc_)
        Ekin, Ecoul, Exx, Exc = float(Ekin_), float(Ecoul_), float(Exx_), float(Exc_)
        dE = Etot - Eold
        Eold = Etot
        Fa, Fb = Fla.cpu().numpy(), Flb.cpu().numpy()
        errv = []
        for l in range(nl):
            for F_, P_ in ((Fa[l], Pla[l]), (Fb[l], Plb[l])):
                FPS = F_ @ P_ @ S_np
                errv.append((Sinvh_np.T @ (FPS - FPS.T) @ Sinvh_np).ravel())
        err = diis.update_with_error([Fa[l] for l in range(nl)] + [Fb[l] for l in range(nl)],
                                     np.concatenate(errv))
        if verbose:
            print(f"  it {it:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
        if err < convthr and abs(dE) < convthr and it > 1:
            converged = True
        if converged or it == maxit:
            out = (Etot, Ekin, Ecoul, Exx, Exc)
            break
        sols = diis.solve()
        Fa, Fb = np.stack(sols[:nl]), np.stack(sols[nl:])
        if err > 1e-3 and shift != 0.0:
            # level shift on the virtuals until DIIS takes over
            # (reference: solver.cpp:1190-1193)
            Fa = shifted_fock(Fa, Ca, occs_a, S_np, shift, False)
            Fb = shifted_fock(Fb, Cb, occs_b, S_np, shift, False)
        E, C = eig_channels(as_dev(np.concatenate((Fa, Fb))), Sinvh)
        E, C = E.cpu().numpy(), C.cpu().numpy()
        Ea, Eb, Ca, Cb = E[:nl], E[nl:], C[:nl], C[nl:]
        if not fixed:
            occs_a = aufbau_occs(Ea, nela, False)
            occs_b = aufbau_occs(Eb, nelb, False)

    Etot, Ekin, Ecoul, Exx, Exc = out
    Pla, _ = density_cubes(Ca, occs_a, False)
    Plb, _ = density_cubes(Cb, occs_b, False)
    return SadResult(
        converged=converged, E=Etot, occs=np.asarray(occs_a), Ekin=Ekin, Ecoul=Ecoul,
        Exx=Exx, Exc=Exc, orbE=Ea, orbs=Ca, Pl=Pla, occs_b=np.asarray(occs_b), Plb=Plb,
        orbE_b=Eb, orbs_b=Cb, niter=it, nfock=it,
    )


def search_sadatom_unrestricted(
    basis: SadAtomBasis,
    nel: int | None = None,
    method: str = "HF",
    mode: str = "aufbau",
    maxit: int = 128,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    max_dx: int = 5,
    shift: float = 1.0,
    dftthr: float = 1e-12,
    diisorder: int = 10,
    diiseps: float = 0.1,
    ops: SadOps | None = None,
    device=None,
    diisthr: float | None = None,
) -> SadResult:
    """Unrestricted ground-configuration search (helfem_tpu's
    search_sadatom_unrestricted, sadatom.py:1209-1292). mode 'aufbau':
    Hund-rule-coupled aufbau and MoveElectrons search (reference
    restricted=-1, src/sadatom/main.cpp:367-460); 'scan': the multiplicity
    scan over spin splits dx = 0..max_dx (restricted=0, main.cpp:460-560).
    Returns the best configuration's SadResult with the energy-ordered
    conf_list [((occa, occb), E, converged), ...]; its nfock counts the
    Fock builds of every configuration solved."""
    from helfem_tpu_torch.models.sadconf import (
        hund_rule,
        initial_occs,
        search_spin_scan,
        search_unrestricted,
    )

    sad_method(method)
    if nel is None:
        nel = basis.Z
    ops = _sad_ops(basis, ops, device, "search_sadatom_unrestricted")
    results: dict[tuple, SadResult] = {}

    def solve_cb(key):
        if key not in results:
            occa, occb = key
            results[key] = solve_sadatom_unrestricted(
                basis, int(sum(occa)), int(sum(occb)), method=method,
                occs_a=np.array(occa, dtype=int), occs_b=np.array(occb, dtype=int),
                maxit=maxit, convthr=convthr, guess=guess, verbose=verbose, ops=ops,
                shift=shift, dftthr=dftthr, diisorder=diisorder, diiseps=diiseps,
                diisthr=diisthr)
        r = results[key]
        return r.E, r.converged, r.orbE, r.orbE_b

    if mode == "aufbau":
        try:
            occ0 = initial_occs(nel, basis.lmax)
        except ValueError:
            occ0 = aufbau_occs(_guess_channels(basis, ops, guess)[0], nel, True)
        conf_list = search_unrestricted(solve_cb, *hund_rule(occ0), nel, verbose=verbose)
    elif mode == "scan":
        conf_list = search_spin_scan(solve_cb, nel, basis.lmax, max_dx=max_dx, verbose=verbose)
    else:
        raise ValueError(f"unknown search mode {mode}")
    best = results[conf_list[0][0]]
    best.conf_list = conf_list
    best.nfock = sum(r.nfock for r in results.values())
    return best


def solve_sadatom(
    basis: SadAtomBasis,
    nel: int | None = None,
    method: str = "HF",
    occs: np.ndarray | None = None,
    maxit: int = 128,
    convthr: float = 1e-7,
    guess: str = "TF",
    verbose: bool = False,
    ops: SadOps | None = None,
    search: bool = True,
    shift: float = 1.0,
    dftthr: float = 1e-12,
    diisorder: int = 10,
    diiseps: float = 0.1,
    device=None,
    diisthr: float | None = None,
) -> SadResult:
    """Restricted spherically averaged SCF (helfem_tpu's solve_sadatom).
    occs given -> one fixed-occupation solve;
    search=True -> exhaustive ground-configuration search (aufbau self-
    consistency + MoveElectrons neighbours, reference sadatom/main.cpp:280-
    560); else aufbau self-consistency only. `shift` is the level shift
    applied until the DIIS error drops below 1e-3. The operators are built on
    `device` unless `ops` is given, in which case the solve runs on ops'
    device."""
    if nel is None:
        nel = basis.Z
    ops = _sad_ops(basis, ops, device, "solve_sadatom")
    device = ops.device
    nl, nrad = basis.lmax + 1, basis.nrad
    funcs, kfrac = sad_method(method)
    funcs = tuple(funcs)
    fock = make_sad_fock(funcs, kfrac, nl, dftthr)
    S_np = ops.at.S.cpu().numpy()
    Sinvh_np = ops.at.Sinvh_rad.cpu().numpy()
    Sinvh = ops.at.Sinvh_rad

    def as_dev(x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)

    Eg, Cg = _guess_channels(basis, ops, guess)
    nfock = [0]

    def run_scf(occs, E0, C0):
        # two host iterations on the numpy DIIS, then device steps: only
        # per-iteration (E, err) scalars reach the host
        E_, C_ = E0.copy(), C0
        Eold, Etot = 0.0, 0.0
        diis = DIIS(S_np, Sinvh_np, max_hist=diisorder, diis_eps=diiseps, diis_thr=diisthr,
                    adiis=False)
        occw_np, angw_np = occ_weight_vectors(occs, nl, nrad)
        occw, angw = as_dev(occw_np), as_dev(angw_np)
        converged = False
        out = None
        warmup = 2
        chunk_len, CH = 4, 16  # chunk schedule 4, 8, 16
        chunk = None
        it = 0
        while it < maxit:
            it += 1
            if it > warmup:
                if chunk is None:
                    chunk = make_sad_chunk(funcs, kfrac, nl, dftthr, shift)
                    histF = torch.zeros((diisorder, nl, nrad, nrad), dtype=torch.float64,
                                        device=device)
                    histE = torch.zeros((diisorder, nl * nrad * nrad), dtype=torch.float64,
                                        device=device)
                    count = 0
                    # the warm eigensolve's seed, as in the unrestricted solver
                    Vw = torch.eye(nrad, dtype=torch.float64, device=device).repeat(nl, 1, 1)
                nrun = min(chunk_len, CH, maxit - it + 1)
                chunk_len = min(2 * chunk_len, CH)
                Cin = as_dev(C_)
                Cs, Es, count, Etots, errs, comps, kmax, Vw = chunk(
                    ops, (occw,), (angw,), (Cin,), Vw, histF, histE, count, float(convthr), Eold,
                    nrun)
                Etots = Etots.cpu().numpy()
                errs = errs.cpu().numpy()
                k = 0
                for k in range(kmax):
                    Etot = float(Etots[k])
                    err = float(errs[k])
                    dE = Etot - Eold
                    Eold = Etot
                    if verbose:
                        print(f"  it {it + k:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
                    if err < convthr and abs(dE) < convthr:
                        converged = True
                        break
                # the chunk ran k+1 counted iterations, one already counted above
                it += k
                Ekin, Ecoul, Exx, Exc = (float(x) for x in comps[k][:4].cpu())
                if converged or it >= maxit:
                    # orbitals CONSISTENT with the reported Etot: step k's
                    # energy comes from the PRE-eigh density, i.e. the
                    # post-eigh orbitals of step k-1 (the chunk input for
                    # k=0), as the host path, which stops before updating C_
                    C_ = (Cs[k - 1][0] if k > 0 else Cin).cpu().numpy()
                    if k > 0:
                        E_ = Es[k - 1][0].cpu().numpy()
                    Pl, _ = density_cubes(C_, occs)
                    out = (Etot, Ekin, Ecoul, Exx, Exc, E_, C_, Pl)
                    break
                E_ = Es[k][0].cpu().numpy()
                C_ = Cs[k][0].cpu().numpy()
                continue

            Pl, Pang = density_cubes(C_, occs)
            # with restricted capacities 2(2l+1), Pang IS the per-spin
            # m-averaged density (fracocc = nocc/cap), matching the
            # reference's AngularDensity (src/sadatom/solver.cpp:505-528)
            Pla = as_dev(Pl / 2.0)
            Panga = as_dev(Pang)
            Fla, _, Ekin_, Enuc, Ecoul_, Exx_, Exc_, _ = fock(ops, Pla, Pla, Panga, Panga)
            Etot = float(Ekin_ + Enuc + Ecoul_ + Exx_ + Exc_)
            Ekin, Ecoul, Exx, Exc = float(Ekin_), float(Ecoul_), float(Exx_), float(Exc_)
            dE = Etot - Eold
            Eold = Etot
            Fn = Fla.cpu().numpy()
            errv = []
            for l in range(nl):
                FPS = Fn[l] @ (Pl[l] / 2.0) @ S_np
                errv.append((Sinvh_np.T @ (FPS - FPS.T) @ Sinvh_np).ravel())
            err = diis.update_with_error([Fn[l] for l in range(nl)], np.concatenate(errv))
            if verbose:
                print(f"  it {it:3d} E={Etot:+.10f} dE={dE:+.2e} err={err:.2e}")
            if err < convthr and abs(dE) < convthr and it > 1:
                converged = True
            if converged or it == maxit:
                out = (Etot, Ekin, Ecoul, Exx, Exc, E_, C_, Pl)
                break
            Fuse = np.stack(diis.solve())
            if err > 1e-3 and shift != 0.0:
                # level shift on virtuals until DIIS takes over
                # (reference: solver.cpp:1190-1193)
                E_, C_ = eig_channels(as_dev(shifted_fock(Fuse, C_, occs, S_np, shift)), Sinvh)
            else:
                E_, C_ = eig_channels(as_dev(Fuse), Sinvh)
            E_, C_ = E_.cpu().numpy(), C_.cpu().numpy()
        nfock[0] += it
        return converged, out, E_, C_, it

    # memoized fixed-occupation solves, keyed by the occupation tuple
    results: dict[tuple, tuple] = {}

    def solve_cb(key):
        if key not in results:
            results[key] = run_scf(np.array(key, dtype=int), Eg, Cg)
        conv_, out_, Efin_, _, _ = results[key]
        return out_[0], conv_, Efin_

    if occs is not None:
        # enforced occupations: one fixed-occupation SCF, no search
        key = tuple(int(x) for x in occs)
        E_, conv_, _ = solve_cb(key)
        conf_list = [(key, E_, conv_)]
    elif search:
        # exhaustive ground-configuration search (aufbau self-consistency +
        # MoveElectrons neighbors; reference: src/sadatom/main.cpp:300-350)
        from helfem_tpu_torch.models.sadconf import initial_occs, search_restricted

        try:
            occs0 = initial_occs(nel, basis.lmax)
        except ValueError:
            occs0 = aufbau_occs(Eg, nel, True)
        conf_list = search_restricted(solve_cb, occs0, nel, verbose=verbose)
    else:
        # aufbau self-consistency only
        key = tuple(int(x) for x in aufbau_occs(Eg, nel, True))
        seen = {key}
        for _ in range(6):
            _, _, Efin_ = solve_cb(key)
            newkey = tuple(int(x) for x in aufbau_occs(Efin_, nel, True))
            if newkey in seen:
                break
            seen.add(newkey)
            key = newkey
        conf_list = sorted(
            ((k, results[k][1][0], results[k][0]) for k in seen if k in results),
            key=lambda t: t[1],
        )

    best_key = conf_list[0][0]
    conv, out, _, _, niter = results[best_key]
    Etot, Ekin, Ecoul, Exx, Exc, Eorb, Corb, Pl = out
    return SadResult(
        converged=conv, E=Etot, occs=np.array(best_key, dtype=int), Ekin=Ekin, Ecoul=Ecoul,
        Exx=Exx, Exc=Exc, orbE=np.asarray(Eorb), orbs=np.asarray(Corb), Pl=Pl,
        conf_list=conf_list, niter=niter, nfock=nfock[0],
    )


# ----------------------------------------------------------------------------
# densities and potentials on the radial grid (gensap outputs), host numpy
# ----------------------------------------------------------------------------


def _element_windows(basis: SadAtomBasis, Prad: np.ndarray) -> np.ndarray:
    gi = basis.rb.fem.gidx
    Pp = np.zeros((basis.nrad + 1, basis.nrad + 1))
    Pp[: basis.nrad, : basis.nrad] = Prad
    return Pp[gi[:, :, None], gi[:, None, :]]


def radial_density(basis: SadAtomBasis, Prad: np.ndarray):
    """(r, n, dn/dr, lapl n, weights) flattened over the element grid;
    n(r) = P_IJ b_I b_J / (4 pi) (reference: sadatom electron_density)."""
    rb = basis.rb
    Pg = _element_windows(basis, Prad)
    fourpi = 4.0 * np.pi
    n = np.einsum("eij,eqi,eqj->eq", Pg, rb.b, rb.b) / fourpi
    dn = 2.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.b) / fourpi
    ln = (
        2.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.d2b, rb.b)
        + 2.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.db)
        + 4.0 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.b) / rb.r
    ) / fourpi
    return rb.r.ravel(), n.ravel(), dn.ravel(), ln.ravel(), (rb.wr * fourpi * rb.r**2).ravel()


def occupied_orbital_table(basis: SadAtomBasis, occs: np.ndarray, orbE: np.ndarray,
                           orbs, restricted: bool = True) -> list[dict]:
    """Per-occupied-shell analysis rows (reference: OrbitalChannel::Print,
    src/sadatom/solver.cpp:152-186, with the <r^i> operator set of
    TwoDBasis::Rmatrices, basis.cpp:1274-1282): for each occupied shell,
    (n, l, nocc, E, <r^i>^(1/i) for i in -2,-1,1,2,3, and the radius of the
    maximum of the r^2-weighted orbital density); shell capacities 2(2l+1),
    or 2l+1 for one spin of the unrestricted solver."""
    powers = (-2, -1, 1, 2, 3)
    rb = basis.rb
    R = {i: rb.radial_integral(i) for i in powers}
    gi = rb.fem.gidx
    rows = []
    for l in range(basis.lmax + 1):
        left = int(occs[l])
        cap = shell_capacity(l, restricted)
        k = 0
        while left > 0:
            nocc = min(left, cap)
            left -= nocc
            c = np.asarray(orbs[l])[:, k]
            cp = np.append(c, 0.0)[gi]  # [nelem, nprim], trash slot dropped
            mom = {i: float(c @ R[i] @ c) ** (1.0 / i) for i in powers}
            # coarse max of r^2 |u(r)|^2 on the quadrature grid ...
            u = np.einsum("eqi,ei->eq", rb.b, cp)
            rfd = (rb.r * u) ** 2
            e0, q0 = np.unravel_index(np.argmax(rfd), rfd.shape)
            # ... then zoomed refinement within the winning element
            lo = rb.xq[q0 - 1] if q0 > 0 else -1.0
            hi = rb.xq[q0 + 1] if q0 + 1 < len(rb.xq) else 1.0
            for _ in range(4):
                xs = np.linspace(lo, hi, 65)
                Bf = rb.fem.eval_dnf(xs, 0)[0][e0]  # [nxs, nprim]
                rs = rb.fem.coords(xs)[e0]
                us = Bf @ cp[e0]  # u*r = B c
                j = int(np.argmax(us**2))  # (r u)^2 = (B c)^2
                lo = xs[max(j - 1, 0)]
                hi = xs[min(j + 1, len(xs) - 1)]
            rows.append({
                "n": k + l + 1, "l": l, "nocc": nocc, "E": float(np.asarray(orbE)[l][k]),
                "moments": mom, "rmax": float(rs[j]),
            })
            k += 1
    return rows


def xc_ingredients(basis: SadAtomBasis, Pl: np.ndarray):
    """XC-ingredient table on the radial grid of a restricted density cube
    (split evenly over the spins): columns [r, rho_a, rho_b, sigma_aa,
    sigma_ab, sigma_bb, lapl_a, lapl_b, tau_a, tau_b] (reference:
    SCFSolver::XCIngredients, src/sadatom/solver.cpp:1585-1597; gensap
    --saveing writes it)."""
    Pla = Pl / 2.0
    r, n, dn, ln, _ = radial_density(basis, Pla.sum(axis=0))
    tau = kinetic_energy_density(basis, Pla)
    return np.column_stack([r, n, n, dn * dn, dn * dn, dn * dn, ln, ln, tau, tau])


def kinetic_energy_density(basis: SadAtomBasis, Pl: np.ndarray):
    """tau(r) = 1/2 sum_l P_l[IJ] (b'_I b'_J + l(l+1) b_I b_J / r^2) / (4 pi)."""
    rb = basis.rb
    tau = np.zeros_like(rb.r)
    for l in range(Pl.shape[0]):
        Pg = _element_windows(basis, Pl[l])
        tau += 0.5 * np.einsum("eij,eqi,eqj->eq", Pg, rb.db, rb.db)
        tau += 0.5 * l * (l + 1) * np.einsum("eij,eqi,eqj->eq", Pg, rb.b, rb.b) / rb.r**2
    return tau.ravel() / (4.0 * np.pi)


def coulomb_screening(basis: SadAtomBasis, Prad: np.ndarray) -> np.ndarray:
    """r * V_H(r) on the radial grid (effective electron screening charge;
    reference: sadatom TwoDBasis::coulomb_screening, basis.cpp:778-840).

    V_H(r) = (1/r) int_0^r rho_B dr' + int_r^inf rho_B / r' dr' with
    rho_B(r) = P_IJ B_I B_J (the radial charge density)."""
    rb = basis.rb
    nelem, nq = rb.r.shape
    Pg = _element_windows(basis, Prad)
    # per-element totals of <BB> and <BB/r>
    q0 = np.einsum("eij,eqi,eq,eqj->e", Pg, rb.B, rb.wr, rb.B)
    qm1 = np.einsum("eij,eqi,eq,eqj->e", Pg, rb.B / rb.r[:, :, None], rb.wr, rb.B)
    pre = np.concatenate([[0.0], np.cumsum(q0)[:-1]])  # charge inside element start
    suf = np.concatenate([np.cumsum(qm1[::-1])[::-1][1:], [0.0]])  # 1/r-weighted outside
    # in-element cumulative integrals per quadrature point (segment sums)
    V = np.zeros((nelem, nq))
    for e in range(nelem):
        rq = rb.r[e]
        lo = np.concatenate([[rb.fem.bval[e]], rq[:-1]])
        hi = rq
        mid, hlen = 0.5 * (lo + hi), 0.5 * (hi - lo)
        rp = mid[:, None] + hlen[:, None] * rb.xq[None, :]
        xpoly = (rp - rb.fem.mids[e]) / (0.5 * rb.fem.lengths[e])
        Bin = rb.fem.eval_element(e, xpoly.ravel(), 0)[0].reshape(nq, nq, -1)
        dens = np.einsum("ij,pqi,pqj->pq", Pg[e], Bin, Bin)
        seg0 = np.einsum("pq,q,p->p", dens, rb.wq, hlen)  # int B B over segment
        segm1 = np.einsum("pq,pq,q,p->p", dens, 1.0 / rp, rb.wq, hlen)
        cum0 = np.cumsum(seg0)  # int_lo(e)^rq
        cumm1_above = np.cumsum(segm1[::-1])[::-1] - segm1  # int_rq^hi(e)
        V[e] = (pre[e] + cum0) / rq + cumm1_above + suf[e]
    return (V * rb.r).ravel()


def _mult_vxc_radial(funcs, na, nb, dna, dnb, lna, lnb, r, thr: float = 1e-12):
    """Multiplicative xc potential per spin on the radial grid,

        v_s = dE/dn_s - div(2 v_sigma_ss grad n_s + v_sigma_st grad n_t),

    with the divergence in spherical symmetry div A = dA/dr + 2A/r and the
    radial derivative of v_sigma taken by ONE torch.func.jvp through the
    functional's potentials (torch.func.grad of its energy; helfem_tpu takes
    jax.jvp through xc_eval). The inputs are substituted as ops/xc.py:xc_eval
    substitutes them (masked points by 1, spin densities floored at thr,
    same-spin sigmas at 0), inside the differentiated function. LDA
    functionals give zero v_sigma, and HF (no functional) zero potentials;
    meta-GGAs raise."""
    if any(f.family not in ("lda", "gga") for f in funcs):
        raise NotImplementedError("multiplicative xc potential: LDA/GGA only")
    if not funcs:
        zero = np.zeros(np.shape(na))
        return zero, zero.copy()
    t = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64)
         for k, v in dict(na=na, nb=nb, dna=dna, dnb=dnb, lna=lna, lnb=lnb, r=r).items()}
    na, nb, dna, dnb, r = t["na"], t["nb"], t["dna"], t["dnb"], t["r"]
    # pure second radial derivative from the full laplacian: n'' = lapl - 2 n'/r
    d2na = t["lna"] - 2.0 * dna / r
    d2nb = t["lnb"] - 2.0 * dnb / r

    def energy(*a):
        return sum(f.f(*a, **dict(f.params)) for f in funcs).sum()

    grad = torch.func.grad(energy, argnums=(0, 1, 2, 3, 4))

    def pots(ra, rb, saa, sab, sbb):
        mask = (ra + rb) > thr
        one = torch.ones_like(ra)
        args = (torch.clamp(torch.where(mask, ra, one), min=thr),
                torch.clamp(torch.where(mask, rb, one), min=thr),
                torch.clamp(saa, min=0.0), sab, torch.clamp(sbb, min=0.0))
        return torch.stack([torch.where(mask, g, torch.zeros_like(g)) for g in grad(*args)])

    prim = (na, nb, dna * dna, dna * dnb, dnb * dnb)
    tang = (dna, dnb, 2.0 * dna * d2na, d2na * dnb + dna * d2nb, 2.0 * dnb * d2nb)
    V, dV = torch.func.jvp(pots, prim, tang)
    vra, vrb, vsaa, vsab, vsbb = V
    _, _, dvsaa, dvsab, dvsbb = dV
    Aa = 2.0 * vsaa * dna + vsab * dnb
    Ab = 2.0 * vsbb * dnb + vsab * dna
    dAa = 2.0 * (dvsaa * dna + vsaa * d2na) + dvsab * dnb + vsab * d2nb
    dAb = 2.0 * (dvsbb * dnb + vsbb * d2nb) + dvsab * dna + vsab * d2na
    va = vra - (dAa + 2.0 * Aa / r)
    vb = vrb - (dAb + 2.0 * Ab / r)
    return va.numpy(), vb.numpy()


def xc_screening(basis: SadAtomBasis, Prad: np.ndarray, funcs) -> np.ndarray:
    """r * v_xc(r) for LDA and GGA functionals (reference: sadatom
    TwoDBasis::xc_screening, src/sadatom/basis.cpp:1284-1288, incl. the GGA
    gradient-divergence correction)."""
    r, n, dn, ln, _ = radial_density(basis, Prad)
    va, vb = _mult_vxc_radial(funcs, n / 2, n / 2, dn / 2, dn / 2, ln / 2, ln / 2, r)
    return r * 0.5 * (va + vb)


def xc_screening_polarized(basis: SadAtomBasis, Prad_a: np.ndarray, Prad_b: np.ndarray,
                           funcs):
    """(r*vxc_a, r*vxc_b) for spin-polarized densities, LDA/GGA (reference:
    sadatom TwoDBasis::xc_screening(Pa,Pb,...), src/sadatom/basis.cpp:1289)."""
    r, na, dna, lna, _ = radial_density(basis, Prad_a)
    _, nb, dnb, lnb, _ = radial_density(basis, Prad_b)
    va, vb = _mult_vxc_radial(funcs, na, nb, dna, dnb, lna, lnb, r)
    return r * va, r * vb


def potential_table(basis: SadAtomBasis, Pla: np.ndarray, Plb: np.ndarray, funcs,
                    mode: str = "average", dftthr: float = 1e-12):
    """9-column SAP potential table (r, rho, drho/dr, lapl rho, tau, r*V_H,
    r*v_xc, w, Z - Zeff), sorted by r. The spin-resolved xc column follows
    the reference's potential variants (src/sadatom/solver.cpp:1414-1571):

      average   restricted v_xc of the total density (AveragePotential)
      mean      mean of the spin-resolved potentials (UnrestrictedPotential)
      weighted  density-weighted spin average (WeightedPotential)
      highspin  restricted v_xc of 2*rho_alpha (HighSpinPotential)
      lowspin   restricted v_xc of 2*rho_beta (LowSpinPotential)
    """
    Pa, Pb = Pla.sum(axis=0), Plb.sum(axis=0)
    P = Pa + Pb
    r, na, dna, lna, wt = radial_density(basis, Pa)
    _, nb, dnb, lnb, _ = radial_density(basis, Pb)
    tau = kinetic_energy_density(basis, Pla) + kinetic_energy_density(basis, Plb)
    vcoul = coulomb_screening(basis, P)
    if mode == "average":
        vxc = xc_screening(basis, P, funcs)
    elif mode == "mean":
        va, vb = xc_screening_polarized(basis, Pa, Pb, funcs)
        vxc = 0.5 * (va + vb)
    elif mode == "weighted":
        va, vb = xc_screening_polarized(basis, Pa, Pb, funcs)
        n = na + nb
        vxc = np.where(n > dftthr, (va * na + vb * nb) / np.maximum(n, dftthr), 0.0)
    elif mode == "highspin":
        vxc = xc_screening(basis, 2.0 * Pa, funcs)
    elif mode == "lowspin":
        vxc = xc_screening(basis, 2.0 * Pb, funcs)
    else:
        raise ValueError(f"unknown potential mode {mode}")
    zeff = basis.Z - (vcoul + vxc)
    out = np.column_stack([r, na + nb, dna + dnb, lna + lnb, tau, vcoul, vxc, wt, zeff])
    return out[np.argsort(r)]


def vdw_radius(basis: SadAtomBasis, Prad: np.ndarray, threshold: float = 0.001) -> float:
    """Radius where the electron density drops to `threshold` (the van der
    Waals radius criterion; reference: sadatom TwoDBasis::vdw_radius,
    src/sadatom/basis.cpp:1043-1100), by log-linear interpolation at the
    outermost crossing."""
    r, n, _, _, _ = radial_density(basis, Prad)
    order = np.argsort(r)
    r, n = r[order], n[order]
    above = np.nonzero(n > threshold)[0]
    if len(above) == 0:
        return 0.0
    i = above[-1]
    if i + 1 >= len(r):
        return r[-1]
    r1, r2 = r[i], r[i + 1]
    n1, n2 = n[i], max(n[i + 1], 1e-300)
    t = (np.log(threshold) - np.log(n1)) / (np.log(n2) - np.log(n1))
    return float(r1 + t * (r2 - r1))


def electron_count_radius(basis: SadAtomBasis, Prad: np.ndarray, nel_inside: float) -> float:
    """Radius enclosing `nel_inside` electrons (reference:
    TwoDBasis::electron_count_radius, src/sadatom/basis.cpp:1119-1165;
    callers pass nel_inside = nel_total - eps), by linear interpolation on
    the cumulative quadrature sum."""
    r, n, _, _, w = radial_density(basis, Prad)
    order = np.argsort(r)
    r, nw = r[order], (n * w)[order]
    cum = np.cumsum(nw)
    idx = int(np.searchsorted(cum, nel_inside))
    if idx >= len(r):
        return float(r[-1])
    if idx == 0:
        return float(r[0])
    c1, c2 = cum[idx - 1], cum[idx]
    t = (nel_inside - c1) / max(c2 - c1, 1e-300)
    return float(r[idx - 1] + t * (r[idx] - r[idx - 1]))


def xc_potential_table(basis: SadAtomBasis, Pla, Plb, funcs):
    """(r, vxc_a, vxc_b) on the radial grid for potential export (reference:
    SCFSolver::XCPotential -> xcpot.dat), LDA and GGA."""
    r, na, dna, lna, _ = radial_density(basis, Pla.sum(axis=0))
    _, nb, dnb, lnb, _ = radial_density(basis, Plb.sum(axis=0))
    va, vb = _mult_vxc_radial(funcs, na, nb, dna, dnb, lna, lnb, r)
    order = np.argsort(r)
    return r[order], va[order], vb[order]


def sap_potential_table(Z: int, method: str = "lda_x", lmax: int = 3, device=None, **kw):
    """The SAP effective-charge table of element Z from the spherically
    averaged atom solved on `device` in the Saito ground configuration
    (sadconf.get_configuration; one fixed-occupation solve). `kw` goes to
    SadAtomBasis. Returns (r, Zeff, result) with Zeff(r) = Z - r V_H(r) -
    r v_xc(r), sorted by r."""
    from helfem_tpu_torch.models.sadconf import get_configuration

    conf = get_configuration(Z)
    if lmax < 3:
        if conf[lmax + 1:].any():
            raise ValueError(f"Z={Z} ground state needs lmax >= {np.nonzero(conf)[0].max()}")
        conf = conf[: lmax + 1]
    basis = SadAtomBasis(Z=Z, lmax=lmax, **kw)
    res = solve_sadatom(basis, method=method, occs=conf, device=device)
    Prad = res.Pl.sum(axis=0)
    funcs, _ = parse_method(method)
    vcoul = coulomb_screening(basis, Prad)
    vxc = xc_screening(basis, Prad, funcs)
    r = basis.rb.r.ravel()
    Zeff = Z - (vcoul + vxc)
    order = np.argsort(r)
    return r[order], Zeff[order], res
