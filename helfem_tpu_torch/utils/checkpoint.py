"""npz checkpoints of the port, ported from helfem_tpu/utils/checkpoint.py.

The basis definition plus the orbitals, occupations and energies of an SCF,
key for key and dtype for dtype helfem_tpu's schema, so a file written by
either package loads in the other (np.load with allow_pickle=False), and
warm starts in a DIFFERENT basis by cross-basis overlap projection (the
reference's --load path, src/atomic/main.cpp:508-609). Host numpy, as in
helfem_tpu: the SCF drivers take the host densities this module returns.
"""

import numpy as np

__all__ = [
    "save_atomic", "load_atomic",
    "save_diatomic", "load_diatomic",
    "save_sadatom", "load_sadatom",
    "cross_radial_overlap", "project_orbitals", "warm_start_density",
    "density_from_blocks_dia", "cross_radial_overlap_dia", "cross_overlap_dia",
    "warm_start_density_dia",
]


def _opt(x):
    return x if x is not None else np.zeros(0)


def save_atomic(path: str, basis, res) -> None:
    np.savez(
        path,
        kind="atomic",
        Z=basis.Z, lmax=basis.lmax, mmax=basis.mmax, rmax=basis.rmax,
        nelem=basis.nelem, nnodes=basis.nnodes, nquad=basis.nquad,
        igrid=basis.igrid, zexp=basis.zexp, primbas=basis.primbas,
        finitenuc=basis.finitenuc, Rrms=basis.Rrms, nelem0=basis.nelem0,
        igrid0=basis.igrid0, zexp0=basis.zexp0, Zl=basis.Zl, Zr=basis.Zr,
        Rmid=basis.Rmid, conf_boundary=basis.conf_boundary,
        zeroder=basis.zeroder,
        bval_r=basis.rb.fem.bval,
        converged=res.converged, E=res.E,
        orbE_a=res.orbE_a, orbs_a=res.orbs_a, occ_a=res.occ_a,
        orbE_b=_opt(res.orbE_b), orbs_b=_opt(res.orbs_b), occ_b=_opt(res.occ_b),
    )


def load_atomic(path: str):
    """Returns (basis, data-dict)."""
    from helfem_tpu_torch.models.atomic import AtomicBasis

    d = np.load(path, allow_pickle=False)
    basis = AtomicBasis(
        Z=int(d["Z"]), lmax=int(d["lmax"]), mmax=int(d["mmax"]),
        rmax=float(d["rmax"]), nelem=int(d["nelem"]), nnodes=int(d["nnodes"]),
        nquad=int(d["nquad"]), igrid=int(d["igrid"]), zexp=float(d["zexp"]),
        primbas=int(d["primbas"]) if "primbas" in d else 4,
        finitenuc=str(d["finitenuc"]) if "finitenuc" in d else "point",
        Rrms=float(d["Rrms"]) if "Rrms" in d else 0.0,
        nelem0=int(d["nelem0"]) if "nelem0" in d else 0,
        igrid0=int(d["igrid0"]) if "igrid0" in d else 2,
        zexp0=float(d["zexp0"]) if "zexp0" in d else 2.0,
        Zl=int(d["Zl"]) if "Zl" in d else 0,
        Zr=int(d["Zr"]) if "Zr" in d else 0,
        Rmid=float(d["Rmid"]) if "Rmid" in d else 0.0,
        conf_boundary=float(d["conf_boundary"]) if "conf_boundary" in d else 0.0,
        zeroder=bool(d["zeroder"]) if "zeroder" in d else False,
        # explicit boundaries win over the grid parameters (exact restart
        # for bases built from a reference HDF5 checkpoint's bval)
        bval=d["bval_r"] if "bval_r" in d else None,
    )
    return basis, dict(d)


def save_diatomic(path: str, basis, res) -> None:
    """Diatomic checkpoint: basis definition + block orbitals/occupations
    (reference: HDF5 checkpoint in src/diatomic/main.cpp --save)."""
    np.savez(
        path,
        kind="diatomic",
        Z1=basis.Z1, Z2=basis.Z2, Rbond=basis.Rbond,
        lmax=np.asarray(basis.lmax, dtype=np.int64),
        rmax=basis.rmax, nelem=basis.nelem, nnodes=basis.nnodes,
        nquad=basis.nquad, igrid=basis.igrid, zexp=basis.zexp,
        primbas=basis.primbas,
        bval_mu=basis.fem.bval,
        converged=res.converged, E=res.E,
        orbE_a=res.orbE_a, orbs_a=_opt(res.orbs_a), occ_a=_opt(res.occ_a),
        orbE_b=_opt(res.orbE_b), orbs_b=_opt(res.orbs_b), occ_b=_opt(res.occ_b),
    )


def load_diatomic(path: str):
    """Returns (basis, data-dict). Use density_dia(ops, orbs_a, occ_a) to
    rebuild the density and scf_diatomic(..., P0a=...) to warm-start."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    d = np.load(path, allow_pickle=False)
    basis = DiatomicBasis(
        Z1=int(d["Z1"]), Z2=int(d["Z2"]), Rbond=float(d["Rbond"]),
        lmax=tuple(int(l) for l in d["lmax"]),
        rmax=float(d["rmax"]), nelem=int(d["nelem"]), nnodes=int(d["nnodes"]),
        nquad=int(d["nquad"]), igrid=int(d["igrid"]), zexp=float(d["zexp"]),
        primbas=int(d["primbas"]) if "primbas" in d else 4,
        bval=d["bval_mu"] if "bval_mu" in d else None,
    )
    return basis, dict(d)


def save_sadatom(path: str, basis, res) -> None:
    """Spherically-averaged-atom checkpoint (reference: gensap result files,
    src/sadatom/main.cpp)."""
    np.savez(
        path,
        kind="sadatom",
        Z=basis.Z, lmax=basis.lmax, rmax=basis.rmax,
        nelem=basis.nelem, nnodes=basis.nnodes, nquad=basis.nquad,
        igrid=basis.igrid, zexp=basis.zexp, primbas=basis.primbas,
        converged=res.converged, E=res.E,
        occs=res.occs, occs_b=_opt(res.occs_b),
        orbE=res.orbE, orbs=res.orbs, Pl=res.Pl,
        Plb=_opt(res.Plb), orbE_b=_opt(res.orbE_b), orbs_b=_opt(res.orbs_b),
    )


def load_sadatom(path: str):
    """Returns (basis, data-dict); Pl/Plb are the per-l density matrices."""
    from helfem_tpu_torch.models.sadatom import SadAtomBasis

    d = np.load(path, allow_pickle=False)
    basis = SadAtomBasis(
        Z=int(d["Z"]), lmax=int(d["lmax"]), rmax=float(d["rmax"]),
        nelem=int(d["nelem"]), nnodes=int(d["nnodes"]), nquad=int(d["nquad"]),
        igrid=int(d["igrid"]), zexp=float(d["zexp"]),
        primbas=int(d["primbas"]) if "primbas" in d else 4,
    )
    return basis, dict(d)


def cross_radial_overlap(rb_new, rb_old) -> np.ndarray:
    """<B_i^new | B_j^old> between two radial bases on different element
    grids, by overlap-restricted quadrature (reference:
    RadialBasis::radial_integral(rh,...), libhelfem/src/RadialBasis.cpp:211-309)."""
    from helfem_tpu_torch.ops.quadrature import chebyshev

    nq = max(rb_new.nquad, rb_old.nquad)
    xq, wq = chebyshev(nq)
    fa, fb = rb_new.fem, rb_old.fem
    S = np.zeros((fa.nbf + 1, fb.nbf + 1))
    for ie in range(fa.nelem):
        a0, a1 = fa.bval[ie], fa.bval[ie + 1]
        for je in range(fb.nelem):
            b0, b1 = fb.bval[je], fb.bval[je + 1]
            lo, hi = max(a0, b0), min(a1, b1)
            if hi <= lo:
                continue
            mid, hl = 0.5 * (hi + lo), 0.5 * (hi - lo)
            r = mid + hl * xq
            xa = (r - fa.mids[ie]) / (0.5 * fa.lengths[ie])
            xb = (r - fb.mids[je]) / (0.5 * fb.lengths[je])
            Ba = fa.eval_element(ie, xa, 0)[0]
            Bb = fb.eval_element(je, xb, 0)[0]
            blk = np.einsum("qi,q,qj->ij", Ba, wq * hl, Bb)
            S[np.ix_(fa.gidx[ie], fb.gidx[je])] += blk
    return S[: fa.nbf, : fb.nbf]


def warm_start_density(basis_new, basis_old, d: dict):
    """(P0a, P0b) warm-start densities in the NEW atomic basis from a loaded
    checkpoint dict: old block orbitals are cross-projected per (l,m) shell
    and contracted with the stored occupations (the reference's --load
    orbital-projection restart, src/atomic/main.cpp:507-609). P0b is None
    for restricted checkpoints. Requires per-(l,m) blocks (symm=2 runs)."""
    nang_old = len(basis_old.lval)
    if d["orbs_a"].shape[0] != nang_old:
        raise ValueError("checkpoint was not written with (l,m) symmetry blocks")
    new_shell = {
        (int(l), int(m)): a
        for a, (l, m) in enumerate(zip(basis_new.lval, basis_new.mval))
    }
    nrad, nbf = basis_new.nrad, basis_new.nbf

    def build(C_blocks, occ):
        Cp = project_orbitals(basis_new, basis_old, C_blocks, basis_new.rb.overlap())
        P = np.zeros((nbf, nbf))
        for a_old in range(nang_old):
            key = (int(basis_old.lval[a_old]), int(basis_old.mval[a_old]))
            a_new = new_shell.get(key)
            if a_new is None:
                continue
            Pblk = np.einsum("pk,k,qk->pq", Cp[a_old], occ[a_old], Cp[a_old])
            sl = slice(a_new * nrad, (a_new + 1) * nrad)
            P[sl, sl] = Pblk
        return P

    P0a = build(d["orbs_a"], d["occ_a"])
    P0b = None
    if d["orbs_b"].size:
        P0b = build(d["orbs_b"], d["occ_b"])
    return P0a, P0b


def project_orbitals(basis_new, basis_old, C_old_blocks, S_new: np.ndarray):
    """Project old orbitals into the new basis: C1 = S11^-1 S12 C2, followed
    by S-orthonormalization by the caller (reference: main.cpp:565-599).

    Works per angular shell (shells must match in (l,m))."""
    S12_rad = cross_radial_overlap(basis_new.rb, basis_old.rb)
    S11_rad = basis_new.rb.overlap()
    proj = np.linalg.solve(S11_rad, S12_rad)
    return np.einsum("pq,aqk->apk", proj, C_old_blocks)


def density_from_blocks_dia(basis, orbs: np.ndarray, occ: np.ndarray) -> np.ndarray:
    """Full density matrix from a diatomic checkpoint's block orbitals,
    without building operators (no TEI tables). The block structure
    (m blocks, optionally split by l parity) is inferred from the stored
    shapes."""
    nbf = basis.nbf
    blocks = None
    for parity in (True, False):
        b = basis.sym_blocks(parity)
        if len(b) == orbs.shape[0]:
            blocks = b
            break
    if blocks is None:
        raise ValueError("checkpoint block count matches no symmetry setup")
    P = np.zeros((nbf, nbf))
    for i, idx in enumerate(blocks):
        ni = len(idx)
        C = orbs[i][:ni, :]
        P[np.ix_(idx, idx)] += np.einsum("pk,k,qk->pq", C, occ[i], C)
    return P


def cross_radial_overlap_dia(bnew, bold, m: int, n: int) -> np.ndarray:
    """<B_i^new(mu) | sinh^m cosh^n | B_j^old(mu)> between two prolate
    radial bases on different mu element grids, by overlap-restricted
    quadrature (the mu-coordinate analogue of cross_radial_overlap;
    reference: RadialBasis::overlap(rad, rad), used by the diatomic
    restart projection in src/diatomic/main.cpp)."""
    from helfem_tpu_torch.ops.quadrature import chebyshev

    nq = max(bnew.nquad, bold.nquad)
    xq, wq = chebyshev(nq)
    fa, fb = bnew.fem, bold.fem
    S = np.zeros((fa.nbf + 1, fb.nbf + 1))
    for ie in range(fa.nelem):
        a0, a1 = fa.bval[ie], fa.bval[ie + 1]
        for je in range(fb.nelem):
            b0, b1 = fb.bval[je], fb.bval[je + 1]
            lo, hi = max(a0, b0), min(a1, b1)
            if hi <= lo:
                continue
            mid, hl = 0.5 * (hi + lo), 0.5 * (hi - lo)
            mu = mid + hl * xq
            w = wq * hl * np.sinh(mu) ** m * np.cosh(mu) ** n
            xa = (mu - fa.mids[ie]) / (0.5 * fa.lengths[ie])
            xb = (mu - fb.mids[je]) / (0.5 * fb.lengths[je])
            Ba = fa.eval_element(ie, xa, 0)[0]
            Bb = fb.eval_element(je, xb, 0)[0]
            S[np.ix_(fa.gidx[ie], fb.gidx[je])] += np.einsum("qi,q,qj->ij", Ba, w, Bb)
    return S[: fa.nbf, : fb.nbf]


def cross_overlap_dia(bnew, bold) -> np.ndarray:
    """Full cross overlap <chi^new | chi^old> between two diatomic bases at
    the SAME bond length (the mu <-> r mapping depends on Rhalf). Angular
    factors are shared Legendre functions, so only the radial integrals
    cross; the nu integral gives the same delta/cos^2 coupling pattern as
    DiatomicBasis.overlap."""
    if abs(bnew.Rbond - bold.Rbond) > 1e-10:
        raise ValueError("cross-basis diatomic projection requires equal Rbond")
    from helfem_tpu_torch.ops.gaunt import cosk_coupling

    I12 = cross_radial_overlap_dia(bnew, bold, 1, 2)
    I10 = cross_radial_overlap_dia(bnew, bold, 1, 0)
    Rh = bnew.Rhalf
    nrn, nro = bnew.nrad, bold.nrad
    S = np.zeros((bnew.nbf, bold.nbf))
    for a in range(bnew.nang):
        la, ma = int(bnew.lval[a]), int(bnew.mval[a])
        for b in range(bold.nang):
            lb, mb = int(bold.lval[b]), int(bold.mval[b])
            if ma != mb:
                continue
            blk = np.zeros((nrn, nro))
            if la == lb:
                blk += I12
            c = cosk_coupling(2, la, ma, lb, mb)
            if c != 0.0:
                blk -= c * I10
            S[a * nrn : (a + 1) * nrn, b * nro : (b + 1) * nro] = Rh**3 * blk
    return S


def warm_start_density_dia(bnew, bold, d: dict):
    """(P0a, P0b) warm-start densities in a NEW diatomic basis from a
    checkpoint written in a different discretization (element grid, nnodes,
    lmax) at the same bond length: P_new = T P_old T^T with the projector
    T = S11^-1 S12 (reference --load restart projection,
    src/diatomic/main.cpp)."""
    S12 = cross_overlap_dia(bnew, bold)
    # solve on the valid (shell-masked) subspace only: masked functions are
    # not part of the basis and would otherwise leak into the projector
    valid = np.flatnonzero(bnew.shell_mask().reshape(-1) > 0)
    S11 = bnew.overlap()
    T = np.zeros_like(S12)
    T[valid] = np.linalg.solve(S11[np.ix_(valid, valid)], S12[valid])

    def build(orbs, occ):
        P_old = density_from_blocks_dia(bold, orbs, occ)
        return T @ P_old @ T.T

    P0a = build(d["orbs_a"], d["occ_a"])
    P0b = build(d["orbs_b"], d["occ_b"]) if d["orbs_b"].size else None
    return P0a, P0b
