"""Symmetry-blocked generalized eigensolves (L7 support), ported from
helfem_tpu/utils/linalg.py.

Because S = I_ang (x) S_rad, every (l,m) symmetry block has the same radial
dimension, so the per-block whitened eigensolves batch into ONE
torch.linalg.eigh over a leading block axis (replacing the per-block LAPACK
loop of scf::eig_gsym_sub, src/general/scf_helpers.cpp:142-186), followed
by helfem_tpu's first-order refinement passes (eigh_refined: f64 eigh seed,
four passes). The card has native IEEE f64, but its batched eigh leaves a
residual that stalls the DIIS error of Xe HF at the bench basis at 2.1e-9
(3.5e-10 with the host's LAPACK eigh on the same card); the passes are
matmuls and bring the card below the 1e-9 threshold.

The fused SCF chunks take helfem_tpu's warm start instead (eigh_warm,
eigh_warm_with, eig_blocks_b_warm): the previous iteration's eigenvectors
seed the same sweeps, run by one launch of the kernel K11
(kernels/refine_eig.py) on the card, and a residual certificate per group
of blocks (per spin) decides whether they stand or the group is solved
cold by eigh_refined. warm_counts counts both outcomes.

The --diag 0 whitening (form_sinvh_chol, build_blocks(chol=True)) is the
inverse Cholesky factor L^-T: not symmetric, so every use is Sinvh^T X Sinvh
and C = Sinvh V. The --eigiter solvers (eig_blocks_iter: host scipy ARPACK
shift-invert per block; eig_iter_gsym: torch.lobpcg on -F) and the
subspace and m-block solves (eig_gsym_sub, eig_gsym_m, eig_gsym_lm) are
helfem_tpu's, on tensors.
"""

import numpy as np
import torch
import torch.nn.functional as F

from helfem_tpu_torch.kernels.refine_eig import refine_eig, refine_sweeps

__all__ = ["form_sinvh", "form_sinvh_chol", "form_sh", "perturbation_matrix", "rohf_update",
           "build_blocks", "gather_blocks", "eig_blocks", "eig_blocks_b", "eig_blocks_b_warm",
           "eig_blocks_iter", "eig_gsym_lm", "eig_gsym_m", "eig_gsym_sub", "eig_iter_gsym",
           "density_blocks", "eigh_refined", "eigh_warm", "eigh_warm_with", "warm_counts",
           "reset_warm_counts"]

_BIG = 1e6

# decisions of the warm eigensolve, one per group of blocks (spin): "warm",
# the certificate passed and K11's eigenvectors stand; "cold", it failed and
# eigh_refined solved the group
warm_counts = {"warm": 0, "cold": 0}


def reset_warm_counts() -> None:
    for key in warm_counts:
        warm_counts[key] = 0


def form_sinvh(S: np.ndarray) -> np.ndarray:
    """Symmetric inverse square root via eigendecomposition
    (reference: utils::invh, libhelfem/src/utils.cpp)."""
    w, U = np.linalg.eigh(S)
    return U @ np.diag(w**-0.5) @ U.T


def form_sinvh_chol(S: np.ndarray) -> np.ndarray:
    """Inverse Cholesky factor L^-T, with Sinvh^T S Sinvh = I (reference: the
    --diag 0 path, TwoDBasis::Sinvh(chol=true), src/atomic/main.cpp:88,446)."""
    L = np.linalg.cholesky(S)
    return np.linalg.inv(L).T


def form_sh(S: np.ndarray) -> np.ndarray:
    """Symmetric square root S^{1/2}, eigenvalues clamped at zero (a masked,
    singular overlap gives no NaN from roundoff-negative eigenvalues)."""
    w, U = np.linalg.eigh(S)
    return U @ np.diag(np.sqrt(np.clip(w, 0.0, None))) @ U.T


def perturbation_matrix(n: int, magnitude: float, seed: int = 0) -> np.ndarray:
    """Random orthogonal rotation [n, n] (helfem_tpu's, utils/linalg.py:
    271-283; reference scf::perturbation_matrix): expm of a random
    antisymmetric matrix of the given magnitude, made strictly orthogonal
    through its SVD. Host numpy."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    A = magnitude * (A - A.T) / 2.0
    w, V = np.linalg.eig(A)  # antisymmetric: imaginary spectrum
    R = (V @ np.diag(np.exp(w)) @ np.linalg.inv(V)).real
    U, _, Vt = np.linalg.svd(R)
    return U @ Vt


def rohf_update(Fa, Fb, P, Sh, Sinvh, nocca, noccb):
    """Constrained-UHF (ROHF) Fock update of Tsuchimochi and Scuseria, JCP
    134, 064101 (2011), as helfem_tpu's (utils/linalg.py:293-315; reference
    scf::ROHF_update): flip the sign of the core-virtual blocks of
    (Fa - Fb)/2 in the natural-orbital basis of P = Pa + Pb. Host numpy;
    returns the updated (Fa, Fb)."""
    M = Sh.T @ P @ Sh
    occs, V = np.linalg.eigh(M)  # natural orbitals, ascending occupation
    C = Sinvh @ V  # AO to NO, S-orthonormal columns
    no_to_ao = V.T @ Sh
    Delta_NO = C.T @ ((Fa - Fb) / 2.0) @ C
    n = C.shape[1]
    Nc = min(nocca, noccb)
    Na = max(nocca, noccb) - Nc
    Nv = n - Na - Nc
    lam = np.zeros_like(Delta_NO)
    # the cores are the LAST Nc columns (highest occupation), the virtuals
    # the first Nv
    lam[n - Nc:, :Nv] = -Delta_NO[n - Nc:, :Nv]
    lam[:Nv, n - Nc:] = -Delta_NO[:Nv, n - Nc:]
    lam_AO = no_to_ao.T @ lam @ no_to_ao
    return Fa + lam_AO, Fb - lam_AO


def build_blocks(S: np.ndarray, blocks, chol: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of index arrays into (blk_idx [nblk, blen] with trash=nbf,
    blk_sinvh [nblk, blen, blen]) for the batched blocked eigensolve (host
    numpy, as helfem_tpu's). chol=True whitens with the inverse Cholesky
    factor instead of the symmetric inverse square root (--diag 0)."""
    nbf = S.shape[0]
    blen = max(len(b) for b in blocks)
    nblk = len(blocks)
    blk_idx = np.full((nblk, blen), nbf, dtype=np.int32)
    blk_sinvh = np.zeros((nblk, blen, blen))
    inv = form_sinvh_chol if chol else form_sinvh
    for i, idx in enumerate(blocks):
        blk_idx[i, : len(idx)] = idx
        blk_sinvh[i, : len(idx), : len(idx)] = inv(S[np.ix_(idx, idx)])
    return blk_idx, blk_sinvh


def eigh_refined(A: torch.Tensor, npass: int = 4, tau: float = 1e-9):
    """torch.linalg.eigh of the symmetric A (batched over leading axes),
    then `npass` first-order refinement passes, as helfem_tpu's eigh_refined
    and _refine_passes (helfem_tpu/utils/linalg.py:21-64) make them:

        M = V^T A V;  E = diag(M);  C_ij = M_ij / (E_j - E_i)  (i != j)
        V <- V (I + C);  V <- V (3I - V^T V) / 2

    Near-degenerate pairs (|E_j - E_i| <= tau (max(|E_i|, |E_j|) + 1)) are
    left out of C (rotations inside a degenerate cluster do not change the
    density) and C is clipped to [-0.1, 0.1]. Returns (E ascending, V)."""
    E, V = torch.linalg.eigh(A)
    if npass:
        E, V, _ = refine_sweeps(A, V, npass, tau, groups=0)
    return _sort_eigs(E, V)


def _sort_eigs(E: torch.Tensor, V: torch.Tensor):
    """E ascending along its last axis, V's columns in the same order."""
    order = torch.argsort(E, dim=-1)
    return (torch.take_along_dim(E, order, dim=-1),
            torch.take_along_dim(V, order[..., None, :], dim=-1))


def eigh_warm(A: torch.Tensor, V0: torch.Tensor, npass: int = 3, tau: float = 1e-9,
              gate: float = 1e-10, groups: int = 1):
    """Warm-started symmetric eigendecomposition (helfem_tpu's eigh_warm and
    eigh_warm_with, utils/linalg.py:105-149): refine the previous
    iteration's eigenvectors V0 instead of solving A from scratch. Inside an
    SCF the Fock matrix moves by about the DIIS error between iterations,
    so V0^T A V0 is nearly diagonal and a few sweeps recover the new
    eigensystem. npass + 1 sweeps run (K11 on the card); the largest
    |off-diagonal| of V^T A V in the last one, the residual after npass
    sweeps in the units of the DIIS error, is the certificate. The blocks of
    A [..., n, n] (leading axes flattened) split into `groups` equal runs,
    each with its own certificate: one K11 launch for all of them, one host
    read of the groups' residuals, and one eigh_refined call on the blocks
    of the groups whose residual is not below `gate`, as helfem_tpu's
    lax.cond does per call (per spin); the fused SCF chunks pass gate =
    min(0.1 convthr, 1e-9). On the card that read stands in for the
    synchronisation torch.linalg.eigh makes anyway. Returns (E ascending,
    V, good), good a tuple of one host bool per group; V0 must be
    orthonormal (the identity is safe: its certificate fails and the cold
    path runs)."""
    shape = A.shape
    n = shape[-1]
    A3 = A.reshape(-1, n, n).contiguous()
    V3 = V0.reshape(-1, n, n).contiguous()
    E, V, off = refine_eig(A3, V3, npass, tau, groups)
    good = tuple(bool(x) for x in (off < gate).tolist())
    nwarm = sum(good)
    warm_counts["warm"] += nwarm
    warm_counts["cold"] += groups - nwarm
    if nwarm == 0:
        E, V = eigh_refined(A3, tau=tau)
    else:
        E, V = _sort_eigs(E, V)
        if nwarm < groups:
            nb = A3.shape[0] // groups
            rows = torch.cat([torch.arange(g * nb, (g + 1) * nb) for g in range(groups)
                              if not good[g]]).to(A.device)
            Ec, Vc = eigh_refined(A3[rows], tau=tau)
            E, V = E.index_copy(0, rows, Ec), V.index_copy(0, rows, Vc)
    return E.reshape(shape[:-1]), V.reshape(shape), good


def eigh_warm_with(A: torch.Tensor, V0: torch.Tensor, gate: float, npass: int = 3,
                   tau: float = 1e-9, groups: int = 1):
    """eigh_warm with its gate first, under helfem_tpu's name for it
    (utils/linalg.py:134). helfem_tpu's cold_fn argument, which put the
    TPU's workspace-chunked eigh in place of eigh_refined, has no
    counterpart: the card's eigh needs no chunking."""
    return eigh_warm(A, V0, npass, tau, gate, groups)


def gather_blocks(F_: torch.Tensor, blk_idx: torch.Tensor) -> torch.Tensor:
    """Symmetry-block coordinates [nblk, blen, blen] of a global matrix
    (padded slots read the zero pad row/col)."""
    Fp = F.pad(F_, (0, 1, 0, 1))
    bi = blk_idx.long()
    return Fp[bi[:, :, None], bi[:, None, :]]


def _whitened(Fb: torch.Tensor, blk_idx: torch.Tensor, blk_sinvh: torch.Tensor,
              nbf: int) -> torch.Tensor:
    """Sinvh^T Fb Sinvh per block, its padded slots (blk_idx == nbf) set to
    eigenvalue _BIG (never occupied)."""
    Forth = blk_sinvh.mT @ Fb @ blk_sinvh
    pad = (blk_idx == nbf).to(Fb.dtype)
    eye = torch.eye(blk_idx.shape[1], dtype=Fb.dtype, device=Fb.device)
    return Forth + _BIG * eye[None] * pad[:, None, :]


def eig_blocks_b(Fb: torch.Tensor, blk_idx: torch.Tensor, blk_sinvh: torch.Tensor,
                 nbf: int):
    """Batched whitened eigensolve from BLOCK-coordinate Fock matrices
    [nblk, blen, blen]; padded slots (blk_idx == nbf) get eigenvalue _BIG
    (never occupied). Returns (E [nblk, blen], C [nblk, blen, blen]) in
    block coordinates, E ascending per block."""
    E, V = eigh_refined(_whitened(Fb, blk_idx, blk_sinvh, nbf))
    C = torch.einsum("bpi,bij->bpj", blk_sinvh, V)
    return E, C


def eig_blocks_b_warm(Fb: torch.Tensor, blk_idx: torch.Tensor, blk_sinvh: torch.Tensor,
                      nbf: int, V0: torch.Tensor, gate: float, groups: int = 1):
    """eig_blocks_b with the warm-started eigensolve (helfem_tpu's
    eig_blocks_b_warm, utils/linalg.py:229-243): V0 [nblk, blen, blen] are
    the previous iteration's whitened block eigenvectors (the identity on
    the first call: the certificate then fails and the cold solve runs),
    `gate` the absolute residual tolerance, `groups` the number of equal
    runs of blocks with a certificate each (the spins, stacked in blk_idx
    and blk_sinvh or on a leading axis of Fb and V0 [ns, nblk, blen, blen],
    over which blk_idx and blk_sinvh broadcast). Returns (E, C, V, good) of
    Fb's shape; V seeds the next call."""
    E, V, good = eigh_warm(_whitened(Fb, blk_idx, blk_sinvh, nbf), V0, gate=gate,
                           groups=groups)
    return E, blk_sinvh @ V, V, good


def eig_blocks(F_: torch.Tensor, blk_idx: torch.Tensor, blk_sinvh: torch.Tensor):
    """eig_blocks_b of the symmetry blocks of a global matrix."""
    return eig_blocks_b(gather_blocks(F_, blk_idx), blk_idx, blk_sinvh, F_.shape[0])


def scatter_blocks(Pb: torch.Tensor, blk_idx: torch.Tensor, nbf: int) -> torch.Tensor:
    """Scatter block-coordinate matrices [nblk, blen, blen] into a global
    [nbf, nbf] (padded slots land on the trash row/col and are dropped)."""
    bi = blk_idx.long()
    lin = (bi[:, :, None] * (nbf + 1) + bi[:, None, :]).reshape(-1)
    P = torch.zeros((nbf + 1) * (nbf + 1), dtype=Pb.dtype, device=Pb.device)
    P.index_add_(0, lin, Pb.reshape(-1))
    return P.reshape(nbf + 1, nbf + 1)[:nbf, :nbf]


def density_blocks(C: torch.Tensor, occ: torch.Tensor, blk_idx: torch.Tensor,
                   S: torch.Tensor) -> torch.Tensor:
    """Scatter block orbitals x occupations into the global density matrix."""
    Pb = (C * occ[:, None, :]) @ C.mT
    return scatter_blocks(Pb, blk_idx, S.shape[0])


def eig_gsym_lm(F_: torch.Tensor, Sinvh_rad: torch.Tensor):
    """Generalized eigensolve on the (l,m) blocks (symmetry 2): one batched
    whitened eigh over the angular axis. Returns (E [nang, nrad], C [nang,
    nrad, nrad]), C[a] the radial coefficients of block a."""
    nrad = Sinvh_rad.shape[0]
    nang = F_.shape[0] // nrad
    a = torch.arange(nang, device=F_.device)
    Fb = F_.reshape(nang, nrad, nang, nrad)[a, :, a, :]
    E, V = eigh_refined(Sinvh_rad.T @ Fb @ Sinvh_rad)
    return E, torch.einsum("pi,aij->apj", Sinvh_rad, V)


def eig_gsym_m(F_: torch.Tensor, Sinvh_rad: torch.Tensor, mgroups, nrad: int):
    """Generalized eigensolve on the m blocks (symmetry 1). mgroups: arrays
    of the angular shells that share an m. Returns [(idx, E, C)] per group,
    idx the block's global indices, C [len(idx), len(idx)]."""
    out = []
    for shells in mgroups:
        idx = np.concatenate([a * nrad + np.arange(nrad) for a in shells])
        it = torch.as_tensor(idx, device=F_.device)
        Sinvh = torch.kron(torch.eye(len(shells), dtype=F_.dtype, device=F_.device), Sinvh_rad)
        E, V = eigh_refined(Sinvh.T @ F_[it][:, it] @ Sinvh)
        out.append((idx, E, Sinvh @ V))
    return out


def eig_gsym_sub(F_: torch.Tensor, C0: torch.Tensor):
    """Rayleigh-Ritz solution of F in the span of the S-orthonormal columns
    of C0 (reference: scf::eig_gsym_sub, src/general/scf_helpers.h:37-44).
    Returns (E [nsub], C = C0 V [n, nsub]), still S-orthonormal."""
    E, V = eigh_refined(C0.T @ F_ @ C0)
    return E, C0 @ V


def eig_iter_gsym(F_: torch.Tensor, Sinvh: torch.Tensor, neig: int, maxit: int = 100,
                  tol: float = 1e-9, seed: int = 0):
    """The lowest neig eigenpairs of the whitened F by LOBPCG (helfem_tpu's
    eig_iter_gsym, utils/linalg.py:347; reference: scf::eig_iter): the top
    end of -Sinvh^T F Sinvh by torch.lobpcg, from a QR-orthonormalized
    random start (numpy seed). Returns (E [neig] ascending, C [n, neig]) in
    the non-orthonormal basis."""
    Forth = Sinvh.T @ F_ @ Sinvh
    X0 = torch.as_tensor(np.random.default_rng(seed).standard_normal((Forth.shape[0], neig)),
                         dtype=F_.dtype, device=F_.device)
    X0, _ = torch.linalg.qr(X0)
    theta, U = torch.lobpcg(-Forth, k=neig, X=X0, niter=maxit, tol=tol, largest=True)
    E = -theta
    order = torch.argsort(E)
    return E[order], Sinvh @ U[:, order]


def eig_blocks_iter(F_, blk_idx: np.ndarray, blk_sinvh: np.ndarray, neig: int, sigma: float):
    """The lowest neig eigenpairs of each symmetry block by shift-invert
    Lanczos (host scipy ARPACK, helfem_tpu's eig_blocks_iter,
    utils/linalg.py:370; reference: scf::eig_iter, the --eigiter option).
    sigma must lie below the spectrum (the SCF passes -0.6 Z^2 - 10). A
    block with 3 neig >= its size, or where ARPACK fails, takes the dense
    eigh; uncomputed slots carry _BIG, so aufbau never fills them. Returns
    host (E [nblk, blen], C [nblk, blen, blen]) in eig_blocks' block
    coordinates; ARPACK's start vector is random, so the pairs agree with a
    dense solve to the solver's tolerance, not bit for bit."""
    from scipy.sparse.linalg import ArpackError, eigsh

    F_ = np.asarray(F_)
    nbf = F_.shape[0]
    Fp = np.pad(F_, ((0, 1), (0, 1)))
    nblk, blen = blk_idx.shape
    E = np.full((nblk, blen), _BIG)
    C = np.zeros((nblk, blen, blen))
    for b in range(nblk):
        valid = blk_idx[b] < nbf
        nv = int(valid.sum())
        idx = blk_idx[b][valid]
        Sb = blk_sinvh[b][:nv, :nv]
        Forth = Sb.T @ Fp[np.ix_(idx, idx)] @ Sb
        k = min(neig, nv)
        if 3 * k >= nv:
            w, V = np.linalg.eigh(Forth)
            E[b, :nv] = w
            C[b, :nv, :nv] = Sb @ V
            continue
        try:
            w, V = eigsh(Forth, k=k, sigma=sigma, which="LM")
        except (ArpackError, RuntimeError):  # no convergence, or a singular shift
            w, V = np.linalg.eigh(Forth)
            w, V = w[:k], V[:, :k]
        order = np.argsort(w)
        E[b, :k] = w[order]
        C[b, :nv, :k] = Sb @ V[:, order]
    return E, C
