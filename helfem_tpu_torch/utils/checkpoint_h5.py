"""Reference-schema HDF5 checkpoints of the port, ported from
helfem_tpu/utils/checkpoint_h5.py.

Writes and reads the HDF5 layout of the reference HelFEM ``Checkpoint``
class (ref: src/general/checkpoint.cpp, src/general/checkpoint.h) so that
results move between the port, helfem_tpu and upstream HelFEM binaries:

- ``save_atomic_chk`` / ``save_diatomic_chk`` export a converged SCF state
  under the reference's dataset names (basis serialization + S/T/Vnuc +
  Sinvh/Sh + P/Pa/Pb + Ca/Cb + Ea/Eb + nela/nelb), readable by the
  reference's ``--load`` orbital-projection restart path
  (ref: src/atomic/main.cpp:508-609) and its post-processing tools
  (density_line.cpp, density_grid.cpp).
- ``load_atomic_chk`` / ``load_diatomic_chk`` reconstruct the basis from a
  reference-written file (HelFEM_ID + Z/bval/poly/lval/mval, ref:
  checkpoint.cpp:477-631) and return the stored matrices for warm starts.

Storage conventions of the reference (all reproduced here exactly):

- ``arma::mat`` (double): dataset shape ``(n_cols, n_rows)`` holding the
  column-major buffer (checkpoint.cpp:130-133) -> numpy ``M = dset[...].T``.
- ``arma::vec`` binds the ``arma::mat`` overload as an n x 1 column ->
  dataset shape ``(1, n)``.
- ``arma::ivec`` binds the ``arma::imat`` overload, which uses dims
  ``(n_rows, n_cols)`` (checkpoint.cpp:236-238) -> dataset shape ``(n, 1)``
  of native int.
- scalars: ``H5S_SCALAR`` datasets of native int / double
  (checkpoint.cpp:632-740).

Per-iteration work matrices (J, Ka/Kb, XCa/XCb, Fa/Fb) are not exported:
the reference's orbital-projection restart (its default) and its
post-processing tools only need the datasets written here. Note one
reference quirk kept for compatibility: the atomic program stores the
nuclear attraction matrix under the name ``Vuc`` (src/atomic/main.cpp:468)
while the diatomic program uses ``Vnuc`` (src/diatomic/main.cpp:514).

h5py is imported where a file is opened, so the module imports without it;
without h5py every reader and writer raises ImportError (nothing falls back
to npz). Host numpy throughout, as in helfem_tpu.
"""

from __future__ import annotations

import numpy as np

_BIG = 1e6

# reference nuclear_model_t enum order (src/general/model_potential.h:16-23)
_NUC_MODELS = ["point", "gaussian", "spherical", "hollow", "regularized"]


# --- low-level arma <-> hdf5 conventions -----------------------------------------------


def require_h5py():
    """The h5py module, or ImportError naming it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("reference-schema HDF5 checkpoints (.chk/.h5/.hdf5) need the "
                          "h5py package, which is not installed") from exc
    return h5py


def _w_mat(f, name, M):
    f.create_dataset(name, data=np.asarray(M, dtype=np.float64).T)


def _r_mat(f, name):
    return np.asarray(f[name], dtype=np.float64).T


def _w_vec(f, name, v):
    f.create_dataset(name, data=np.asarray(v, dtype=np.float64).reshape(1, -1))


def _r_vec(f, name):
    return np.asarray(f[name], dtype=np.float64).ravel()


def _w_ivec(f, name, v):
    f.create_dataset(name, data=np.asarray(v, dtype=np.int32).reshape(-1, 1))


def _r_ivec(f, name):
    return np.asarray(f[name]).ravel().astype(np.int64)


def _w_int(f, name, v):
    f.create_dataset(name, data=np.int32(v))


def _w_float(f, name, v):
    f.create_dataset(name, data=np.float64(v))


def _r_scalar(f, name):
    return np.asarray(f[name])[()]


# --- orbital assembly -------------------------------------------------------------------


def _global_orbitals(nbf, blocks, C_blocks, E_blocks):
    """Energy-sorted global orbital matrix from the block eigensolve output
    (the layout eig_gsym_sub produces in the reference,
    ref: src/general/scf_helpers.cpp:142-162)."""
    cols, Es = [], []
    C_blocks = np.asarray(C_blocks)
    E_blocks = np.asarray(E_blocks)
    for b, idx in enumerate(blocks):
        n = len(idx)
        for j in range(E_blocks.shape[1]):
            if E_blocks[b, j] > _BIG / 2:
                continue
            v = np.zeros(nbf)
            v[idx] = C_blocks[b, :n, j]
            cols.append(v)
            Es.append(E_blocks[b, j])
    order = np.argsort(np.asarray(Es), kind="stable")
    return np.stack(cols, axis=1)[:, order], np.asarray(Es)[order]


def _full_P(nbf, blocks, C_blocks, occ):
    P = np.zeros((nbf, nbf))
    Pb = np.einsum("bpk,bk,bqk->bpq", np.asarray(C_blocks), np.asarray(occ),
                   np.asarray(C_blocks))
    for b, idx in enumerate(blocks):
        n = len(idx)
        P[np.ix_(idx, idx)] += Pb[b, :n, :n]
    return P


def _block_sinvh_full(S, blocks, nbf):
    from helfem_tpu_torch.utils.linalg import form_sinvh

    out = np.zeros((nbf, nbf))
    for idx in blocks:
        out[np.ix_(idx, idx)] = form_sinvh(S[np.ix_(idx, idx)])
    return out


# --- atomic -------------------------------------------------------------------------------


def save_atomic_chk(path: str, basis, res, nela: int, nelb: int) -> None:
    """Write an atomic SCF state in the reference checkpoint schema
    (basis: ref checkpoint.cpp:477-508; datasets: ref src/atomic/main.cpp)."""
    h5py = require_h5py()
    from helfem_tpu_torch.utils.linalg import form_sh

    symm = res.symm_used if res.symm_used is not None else 2
    blocks = basis.sym_blocks(symm)
    nbf = basis.nbf
    S = basis.overlap()
    with h5py.File(path, "w") as f:
        # basis serialization (ref checkpoint.cpp:477-508)
        _w_int(f, "HelFEM_ID", 1)
        _w_int(f, "Z", basis.Z)
        _w_int(f, "Zl", basis.Zl)
        _w_int(f, "Zr", basis.Zr)
        _w_float(f, "Rhalf", basis.Rmid)
        _w_vec(f, "bval", basis.rb.fem.bval)
        _w_int(f, "finitenuc", _NUC_MODELS.index(basis.finitenuc))
        _w_float(f, "Rrms", basis.Rrms)
        _w_int(f, "n_quad", basis.nquad)
        _w_int(f, "poly_id", basis.primbas)
        _w_int(f, "poly_nnodes", basis.nnodes)
        _w_int(f, "zeroder", int(basis.zeroder))
        # N/A here: B(r)/r is evaluated by exact polynomial division, the
        # -1 sentinel means "automatic" to the reference reader
        _w_int(f, "taylor_order", -1)
        _w_ivec(f, "lval", basis.lval)
        _w_ivec(f, "mval", basis.mval)

        _w_int(f, "nela", nela)
        _w_int(f, "nelb", nelb)

        _w_mat(f, "S", S)
        _w_mat(f, "T", basis.kinetic())
        _w_mat(f, "Vuc", basis.nuclear())  # [sic] ref src/atomic/main.cpp:468
        _w_mat(f, "Sinvh", _block_sinvh_full(S, blocks, nbf))
        _w_mat(f, "Sh", form_sh(S))

        Ca, Ea = _global_orbitals(nbf, blocks, res.orbs_a, res.orbE_blocks_a)
        _w_mat(f, "Ca", Ca)
        _w_vec(f, "Ea", Ea)
        Pa = _full_P(nbf, blocks, res.orbs_a, res.occ_a)
        if res.orbs_b is None:
            Cb, Eb, Pb = Ca, Ea, Pa
        else:
            Cb, Eb = _global_orbitals(nbf, blocks, res.orbs_b, res.orbE_blocks_b)
            Pb = _full_P(nbf, blocks, res.orbs_b, res.occ_b)
        _w_mat(f, "Cb", Cb)
        _w_vec(f, "Eb", Eb)
        _w_mat(f, "Pa", Pa)
        _w_mat(f, "Pb", Pb)
        _w_mat(f, "P", Pa + Pb)


def load_atomic_chk(path: str):
    """Reconstruct (AtomicBasis, data-dict) from a reference-schema atomic
    checkpoint (ref checkpoint.cpp:511-559). The dict holds the global
    matrices present in the file (Ca/Cb, Ea/Eb, P/Pa/Pb, nela/nelb, ...)."""
    h5py = require_h5py()
    from helfem_tpu_torch.models.atomic import AtomicBasis, angular_basis

    with h5py.File(path, "r") as f:
        if int(_r_scalar(f, "HelFEM_ID")) != 1:
            raise ValueError("checkpoint is not an atomic calculation")
        lval = _r_ivec(f, "lval")
        mval = _r_ivec(f, "mval")
        lmax, mmax = int(lval.max()), int(np.abs(mval).max())
        lv, mv = angular_basis(lmax, mmax)
        if not (np.array_equal(lv, lval) and np.array_equal(mv, mval)):
            raise ValueError(
                "checkpoint angular shell list is not an angular_basis(lmax,"
                "mmax) enumeration; cannot reconstruct this basis")
        basis = AtomicBasis(
            Z=int(_r_scalar(f, "Z")), lmax=lmax, mmax=mmax,
            bval=_r_vec(f, "bval"),
            nnodes=int(_r_scalar(f, "poly_nnodes")),
            primbas=int(_r_scalar(f, "poly_id")),
            nquad=int(_r_scalar(f, "n_quad")),
            zeroder=bool(int(_r_scalar(f, "zeroder"))),
            finitenuc=_NUC_MODELS[int(_r_scalar(f, "finitenuc"))],
            Rrms=float(_r_scalar(f, "Rrms")),
            Zl=int(_r_scalar(f, "Zl")), Zr=int(_r_scalar(f, "Zr")),
            Rmid=float(_r_scalar(f, "Rhalf")),
        )
        d = {"nela": int(_r_scalar(f, "nela")), "nelb": int(_r_scalar(f, "nelb"))}
        for key in ("S", "T", "Vuc", "Sinvh", "Sh", "P", "Pa", "Pb",
                    "Ca", "Cb", "Fa", "Fb", "J", "Ka", "Kb", "XCa", "XCb"):
            if key in f:
                d[key] = _r_mat(f, key)
        for key in ("Ea", "Eb"):
            if key in f:
                d[key] = _r_vec(f, key)
    return basis, d


# --- diatomic -----------------------------------------------------------------------------


def _pure_indices(basis):
    """Map from the port's padded (nang*nrad) layout to the
    reference's compacted layout, which drops the first radial function of
    every m != 0 shell (ref: src/diatomic/basis.cpp:461-472 Nbf)."""
    mask = basis.shell_mask().reshape(-1).astype(bool)
    return np.nonzero(mask)[0]


def save_diatomic_chk(path: str, basis, res, nela: int, nelb: int) -> None:
    """Write a diatomic SCF state in the reference checkpoint schema
    (basis: ref checkpoint.cpp:560-631; datasets: ref src/diatomic/main.cpp).
    Matrices are compacted to the reference's pure-function layout."""
    h5py = require_h5py()
    from helfem_tpu_torch.utils.linalg import form_sh

    keep = _pure_indices(basis)
    nbf_pad = basis.nbf

    # the solve's parity setting is recovered from the stored block count
    # (same probe as density_from_blocks_dia)
    nblk = np.asarray(res.orbE_blocks_a).shape[0]
    parity = None
    for par in (True, False):
        if len(basis.sym_blocks(par)) == nblk:
            parity = par
            break
    if parity is None:
        raise ValueError("checkpoint block count matches neither parity setting")
    blocks = basis.sym_blocks(parity)

    S_pad = basis.overlap()
    mvv = basis.shell_mask().reshape(-1)
    S_pad = S_pad * mvv[:, None] * mvv[None, :]
    S = S_pad[np.ix_(keep, keep)]

    with h5py.File(path, "w") as f:
        _w_int(f, "HelFEM_ID", 2)
        _w_int(f, "Z1", basis.Z1)
        _w_int(f, "Z2", basis.Z2)
        _w_float(f, "Rhalf", basis.Rhalf)
        _w_vec(f, "bval", basis.fem.bval)
        _w_int(f, "n_quad", basis.nquad)
        _w_int(f, "poly_id", basis.primbas)
        _w_int(f, "poly_nnodes", basis.nnodes)
        _w_ivec(f, "lval", basis.lval)
        _w_ivec(f, "mval", basis.mval)

        _w_int(f, "nela", nela)
        _w_int(f, "nelb", nelb)
        _w_float(f, "Enucr", basis.Z1 * basis.Z2 / basis.Rbond)

        _w_mat(f, "S", S)
        T = (basis.kinetic() * mvv[:, None] * mvv[None, :])[np.ix_(keep, keep)]
        V = (basis.nuclear() * mvv[:, None] * mvv[None, :])[np.ix_(keep, keep)]
        _w_mat(f, "T", T)
        _w_mat(f, "Vnuc", V)
        blocks_pure = [np.searchsorted(keep, idx) for idx in blocks]
        _w_mat(f, "Sinvh", _block_sinvh_full(S, blocks_pure, len(keep)))
        _w_mat(f, "Sh", form_sh(S))

        Ca_pad, Ea = _global_orbitals(nbf_pad, blocks, res.orbs_a,
                                      res.orbE_blocks_a)
        _w_mat(f, "Ca", Ca_pad[keep])
        _w_vec(f, "Ea", Ea)
        Pa = _full_P(nbf_pad, blocks, res.orbs_a, res.occ_a)[np.ix_(keep, keep)]
        if res.orbs_b is None:
            Cb_pad, Eb, Pb = Ca_pad, Ea, Pa
        else:
            Cb_pad, Eb = _global_orbitals(nbf_pad, blocks, res.orbs_b,
                                          res.orbE_blocks_b)
            Pb = _full_P(nbf_pad, blocks, res.orbs_b,
                         res.occ_b)[np.ix_(keep, keep)]
        _w_mat(f, "Cb", Cb_pad[keep])
        _w_vec(f, "Eb", Eb)
        _w_mat(f, "Pa", Pa)
        _w_mat(f, "Pb", Pb)
        _w_mat(f, "P", Pa + Pb)


def load_diatomic_chk(path: str):
    """Reconstruct (DiatomicBasis, data-dict) from a reference-schema
    diatomic checkpoint (ref checkpoint.cpp:589-631). Matrices stay in the
    reference's compacted layout; ``_pure_indices(basis)`` maps them into
    the port's padded coordinates."""
    h5py = require_h5py()
    from helfem_tpu_torch.models.diatomic import DiatomicBasis, lm_to_l_m

    with h5py.File(path, "r") as f:
        if int(_r_scalar(f, "HelFEM_ID")) != 2:
            raise ValueError("checkpoint is not a diatomic calculation")
        lval = _r_ivec(f, "lval")
        mval = _r_ivec(f, "mval")
        mmax = int(np.abs(mval).max())
        lmax = tuple(int(lval[np.abs(mval) == m].max()) for m in range(mmax + 1))
        lv, mv = lm_to_l_m(lmax)
        if not (np.array_equal(lv, lval) and np.array_equal(mv, mval)):
            raise ValueError(
                "checkpoint angular shell list is not an lm_to_l_m "
                "enumeration; cannot reconstruct this basis")
        Rhalf = float(_r_scalar(f, "Rhalf"))
        basis = DiatomicBasis(
            Z1=int(_r_scalar(f, "Z1")), Z2=int(_r_scalar(f, "Z2")),
            Rbond=2.0 * Rhalf, lmax=lmax,
            bval=_r_vec(f, "bval"),
            nnodes=int(_r_scalar(f, "poly_nnodes")),
            primbas=int(_r_scalar(f, "poly_id")),
            nquad=int(_r_scalar(f, "n_quad")),
        )
        d = {"nela": int(_r_scalar(f, "nela")), "nelb": int(_r_scalar(f, "nelb"))}
        for key in ("S", "T", "Vnuc", "Sinvh", "Sh", "P", "Pa", "Pb",
                    "Ca", "Cb", "Fa", "Fb"):
            if key in f:
                d[key] = _r_mat(f, key)
        for key in ("Ea", "Eb"):
            if key in f:
                d[key] = _r_vec(f, key)
        if "Enucr" in f:
            d["Enucr"] = float(_r_scalar(f, "Enucr"))
    return basis, d


def load_diatomic_chk_density(path: str):
    """(basis, total density P in padded coordinates) from a
    reference-schema diatomic checkpoint — the input the density
    post-processing tools need (ref: density_line.cpp:37-104 reads
    basis + P from the HDF5 checkpoint)."""
    basis, d = load_diatomic_chk(path)
    if "P" in d:
        P = d["P"]
    elif "Pb" in d:
        P = d["Pa"] + d["Pb"]
    else:
        P = 2.0 * d["Pa"]
    return basis, expand_to_padded(basis, P)


def warm_start_density_atomic_h5(basis_new, basis_old, d):
    """(P0a, P0b) warm-start densities in basis_new from an HDF5-loaded
    atomic state: the stored density is used directly when the
    discretization matches, otherwise projected with the global
    T = S11^-1 S12 blocked per matching (l,m) shell (the reference --load
    restart, ref src/atomic/main.cpp:508-609)."""
    same = (
        np.array_equal(basis_new.lval, basis_old.lval)
        and np.array_equal(basis_new.mval, basis_old.mval)
        and basis_new.nnodes == basis_old.nnodes
        and basis_new.primbas == basis_old.primbas
        and len(basis_new.rb.fem.bval) == len(basis_old.rb.fem.bval)
        and np.allclose(basis_new.rb.fem.bval, basis_old.rb.fem.bval)
    )
    if same:
        return d["Pa"], d.get("Pb")
    from helfem_tpu_torch.utils.checkpoint import cross_radial_overlap

    S12_rad = cross_radial_overlap(basis_new.rb, basis_old.rb)
    T_rad = np.linalg.solve(basis_new.rb.overlap(), S12_rad)
    nr_n, nr_o = T_rad.shape
    old_shell = {
        (int(l), int(m)): a
        for a, (l, m) in enumerate(zip(basis_old.lval, basis_old.mval))
    }
    T = np.zeros((basis_new.nbf, basis_old.nbf))
    for a_new, (l, m) in enumerate(zip(basis_new.lval, basis_new.mval)):
        a_old = old_shell.get((int(l), int(m)))
        if a_old is None:
            continue
        T[a_new * nr_n:(a_new + 1) * nr_n, a_old * nr_o:(a_old + 1) * nr_o] = T_rad
    P0a = T @ d["Pa"] @ T.T
    P0b = T @ d["Pb"] @ T.T if "Pb" in d else None
    return P0a, P0b


def warm_start_density_dia_h5(basis_new, basis_old, d):
    """(P0a, P0b) warm-start densities in basis_new from an HDF5-loaded
    diatomic state (stored in the reference's compacted layout). Same
    projector as warm_start_density_dia, applied to the stored density."""
    Pa = expand_to_padded(basis_old, d["Pa"])
    Pb = expand_to_padded(basis_old, d["Pb"]) if "Pb" in d else None
    same = (
        np.array_equal(basis_new.lval, basis_old.lval)
        and np.array_equal(basis_new.mval, basis_old.mval)
        and basis_new.nnodes == basis_old.nnodes
        and basis_new.primbas == basis_old.primbas
        and len(basis_new.fem.bval) == len(basis_old.fem.bval)
        and np.allclose(basis_new.fem.bval, basis_old.fem.bval)
    )
    if same:
        return Pa, Pb
    from helfem_tpu_torch.utils.checkpoint import cross_overlap_dia

    S12 = cross_overlap_dia(basis_new, basis_old)
    valid = np.flatnonzero(basis_new.shell_mask().reshape(-1) > 0)
    S11 = basis_new.overlap()
    T = np.zeros_like(S12)
    T[valid] = np.linalg.solve(S11[np.ix_(valid, valid)], S12[valid])
    P0a = T @ Pa @ T.T
    P0b = T @ Pb @ T.T if Pb is not None else None
    return P0a, P0b


def expand_to_padded(basis, M):
    """Lift a compacted (reference-layout) diatomic matrix or orbital block
    back into the port's padded nang*nrad coordinates."""
    keep = _pure_indices(basis)
    M = np.asarray(M)
    if M.ndim == 1:
        out = np.zeros(basis.nbf)
        out[keep] = M
        return out
    if M.shape[0] == M.shape[1] == len(keep):
        out = np.zeros((basis.nbf, basis.nbf))
        out[np.ix_(keep, keep)] = M
        return out
    out = np.zeros((basis.nbf, M.shape[1]))
    out[keep] = M
    return out
