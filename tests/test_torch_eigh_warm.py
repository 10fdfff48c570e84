"""The port's warm-started eigensolve (utils/linalg.py: eigh_warm,
eig_blocks_b_warm; scf/diatomic_scf.py: eig_blocks_dia_b_warm; K11's plain
version kernels/refine_eig.py on the CPU) and the fused SCF chunks that run
it, against helfem_tpu on the CPU.

Tolerances: the same certificate decisions, on inputs whose residual lies
at least 10x from the gate on either side; on the warm path E and V within
1e-12 x the max-abs of the unpadded entries (V is fixed by its seed, so it
is compared directly); on the cold path E within 1e-12 x max-abs and the
spectral projectors within 1e-10 (two LAPACK eigh seeds refined by the
same sweeps: a projector onto eigenvalues set apart by a gap g moves by
about eps ||A|| / g, so each cluster of eigenvalues within 1e-4 x max|E|
is compared as one, by the orthonormal whitened vectors V); converged SCF
energies within 1e-9 Eh in
helfem_tpu's iteration counts, at a convthr no closer than 2x to the DIIS
error floor of its case (the port's on the CPU, run on to convthr 1e-12:
Ne RHF 5e-13, N UHF 6e-13, N2 HF 1.5e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models import sadatom as jsad
from helfem_tpu.models.atomic import AtomicBasis as JaxAtomicBasis
from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiaBasis
from helfem_tpu.scf import atomic_scf as jax_atomic
from helfem_tpu.scf import diatomic_scf as jax_dia
from helfem_tpu.utils import linalg as jl
from helfem_tpu_torch.kernels import refine_eig, refine_eig_plain
from helfem_tpu_torch.models import sadatom
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf import atomic_scf, diatomic_scf
from helfem_tpu_torch.utils import linalg

TOL = 1e-12
PROJ_TOL = 1e-10
CLUSTER = 1e-4  # relative gap that sets eigenvalue clusters apart (_cold_close)
GATE = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread and one BLAS thread for this module: the SCFs
    are streams of small ops, and the test workers share the machine's
    cores (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _sym(rng, n, scale=1.0):
    A = rng.standard_normal((n, n)) * scale
    return 0.5 * (A + A.T)


def _off(A: np.ndarray, V0: np.ndarray, groups: int = 1) -> np.ndarray:
    """The port's certificate residuals of (A, V0) [B, n, n]."""
    return refine_eig_plain(torch.tensor(A), torch.tensor(V0), groups=groups)[2].numpy()


def _far_from_gate(off, gate=GATE) -> bool:
    return bool(np.all((off <= 0.1 * gate) | (off >= 10.0 * gate)))


def _warm_close(E, V, Eref, Vref, valid=None):
    """The warm path: E and V entrywise, within TOL x the max-abs of the
    unpadded entries (valid [..., n] masks the padded slots)."""
    E, V, Eref, Vref = (np.asarray(x) for x in (E, V, Eref, Vref))
    if valid is not None:
        E, Eref = E[valid], Eref[valid]
        keep = valid[..., :, None] & valid[..., None, :]
        V, Vref = V[keep], Vref[keep]
    assert np.abs(E - Eref).max() <= TOL * np.abs(Eref).max()
    assert np.abs(V - Vref).max() <= TOL * np.abs(Vref).max()


def _cold_close(E, V, Eref, Vref):
    """The cold path: E, and the spectral projector of each cluster of
    eigenvalues closer than CLUSTER x max|E| to their neighbours (E
    ascending; a single eigenvector inside a near-degenerate pair is fixed
    only to eps ||A|| / gap, the cluster's projector to about eps / CLUSTER)."""
    E, V, Eref, Vref = (np.asarray(x) for x in (E, V, Eref, Vref))
    scale = np.abs(Eref).max()
    assert np.abs(E - Eref).max() <= TOL * scale
    n = E.shape[-1]
    for e, v, vr in zip(E.reshape(-1, n), V.reshape(-1, V.shape[-2], n),
                        Vref.reshape(-1, V.shape[-2], n)):
        for k in np.split(np.arange(n), np.flatnonzero(np.diff(e) > CLUSTER * scale) + 1):
            P, Pref = v[:, k] @ v[:, k].T, vr[:, k] @ vr[:, k].T
            assert np.abs(P - Pref).max() <= PROJ_TOL


def _warm_pair(A, V0, gate=GATE):
    """(port, helfem_tpu) eigh_warm of the same inputs."""
    got = linalg.eigh_warm(torch.tensor(A), torch.tensor(V0), gate=gate)
    ref = jl.eigh_warm(jnp.asarray(A), jnp.asarray(V0), gate=gate)
    return got, ref


# ----------------------------------------------------------------------------
# eigh_warm: helfem_tpu's four cases (tests/test_eigh_warm.py)
# ----------------------------------------------------------------------------


def test_eigh_warm_accepts_near_seed():
    rng = np.random.default_rng(0)
    A = _sym(rng, 40, 10.0)
    _, Vref = jl.eigh_refined(jnp.asarray(A))
    A2 = A + _sym(rng, 40, 1e-6)
    V0 = np.asarray(Vref)
    assert _far_from_gate(_off(A2[None], V0[None]))
    (E, V, good), (Ej, Vj, goodj) = _warm_pair(A2, V0)
    assert good == (True,) and bool(goodj)
    _warm_close(E, V, Ej, Vj)


def test_eigh_warm_rejects_identity_seed():
    rng = np.random.default_rng(1)
    A = _sym(rng, 40, 10.0)
    V0 = np.eye(40)
    assert _far_from_gate(_off(A[None], V0[None]))
    before = dict(linalg.warm_counts)
    (E, V, good), (Ej, Vj, goodj) = _warm_pair(A, V0)
    assert good == (False,) and not bool(goodj)
    assert linalg.warm_counts["cold"] == before["cold"] + 1
    _cold_close(E, V, Ej, Vj)


def test_eigh_warm_batched():
    rng = np.random.default_rng(2)
    A = np.stack([_sym(rng, 24, 5.0) for _ in range(3)])
    V0 = np.asarray(jl.eigh_refined(jnp.asarray(A))[1])
    A2 = A + np.stack([_sym(rng, 24, 1e-7) for _ in range(3)])
    assert _far_from_gate(_off(A2, V0))
    (E, V, good), (Ej, Vj, goodj) = _warm_pair(A2, V0)
    assert good == (True,) and bool(goodj)
    _warm_close(E, V, Ej, Vj)


def test_eigh_warm_certificate_is_honest():
    """An accepted warm result's true residual beats the gate, and V is
    orthonormal either way."""
    rng = np.random.default_rng(3)
    A = _sym(rng, 30, 100.0)
    V0 = np.asarray(jl.eigh_refined(jnp.asarray(A))[1])
    A2 = A + _sym(rng, 30, 1e-5)
    E, V, good = linalg.eigh_warm(torch.tensor(A2), torch.tensor(V0), gate=GATE)
    goodj = jl.eigh_warm(jnp.asarray(A2), jnp.asarray(V0), gate=GATE)[2]
    assert good == (bool(goodj),)
    V = V.numpy()
    if good[0]:
        M = V.T @ A2 @ V
        assert np.abs(M - np.diag(np.diag(M))).max() < GATE
    assert np.allclose(V.T @ V, np.eye(30), atol=1e-12)


def test_refine_eig_cpu_runs_plain_and_checks_inputs():
    rng = np.random.default_rng(4)
    A = torch.tensor(np.stack([_sym(rng, 9) for _ in range(4)]))
    V0 = torch.eye(9, dtype=torch.float64).repeat(4, 1, 1)
    for x, y in zip(refine_eig(A, V0, groups=2), refine_eig_plain(A, V0, groups=2)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="groups"):
        refine_eig(A, V0, groups=3)
    with pytest.raises(ValueError, match="shape"):
        refine_eig(A, V0[:, :8, :8])


# ----------------------------------------------------------------------------
# eig_blocks_b_warm on padded blocks, and two groups
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def blocks():
    """An overlap of 23 functions in blocks of 9, 8 and 6 (padded to 9), a
    Fock matrix, its perturbation and the cold whitened eigenvectors of the
    unperturbed one (helfem_tpu's)."""
    rng = np.random.default_rng(5)
    nbf = 23
    X = rng.standard_normal((nbf, nbf))
    S = np.eye(nbf) + 0.05 * (X + X.T)
    idx = [np.arange(0, 9), np.arange(9, 17), np.arange(17, 23)]
    blk_idx, blk_sinvh = jl.build_blocks(S, idx)
    F = _sym(rng, nbf, 3.0)
    dF = _sym(rng, nbf, 1e-8)
    Fb = np.asarray(jl.gather_blocks(jnp.asarray(F), jnp.asarray(blk_idx)))
    Fb2 = np.asarray(jl.gather_blocks(jnp.asarray(F + dF), jnp.asarray(blk_idx)))
    Forth = np.einsum("bpi,bpq,bqj->bij", blk_sinvh, Fb, blk_sinvh)
    pad = (blk_idx == nbf).astype(float)
    Forth = Forth + 1e6 * np.eye(9)[None] * pad[:, None, :]
    V0 = np.asarray(jl.eigh_refined(jnp.asarray(Forth))[1])
    return dict(nbf=nbf, blk_idx=blk_idx, blk_sinvh=blk_sinvh, Fb=Fb2, V0=V0,
                valid=blk_idx < nbf)


def _blocks_pair(b, V0, gate=GATE):
    got = linalg.eig_blocks_b_warm(torch.tensor(b["Fb"]), torch.tensor(b["blk_idx"]),
                                   torch.tensor(b["blk_sinvh"]), b["nbf"], torch.tensor(V0),
                                   gate)
    ref = jl.eig_blocks_b_warm(jnp.asarray(b["Fb"]), jnp.asarray(b["blk_idx"]),
                               jnp.asarray(b["blk_sinvh"]), b["nbf"], jnp.asarray(V0), gate)
    return got, ref


@pytest.mark.parametrize("seed", ["near", "identity"])
def test_eig_blocks_b_warm_matches_jax(blocks, seed):
    V0 = blocks["V0"] if seed == "near" else np.broadcast_to(np.eye(9), (3, 9, 9)).copy()
    (E, C, V, good), (Ej, Cj, Vj, goodj) = _blocks_pair(blocks, V0)
    assert good == (seed == "near",) and bool(goodj) == good[0]
    valid = blocks["valid"]
    if good[0]:
        _warm_close(E, V, Ej, Vj, valid)
        _warm_close(E, C, Ej, Cj, valid)
    else:
        _cold_close(E, V, Ej, Vj)  # the padded slots' 1e6 form one cluster


def test_eig_blocks_b_warm_two_groups(blocks):
    """Two spins stacked, groups=2: the near seed's spin accepted and the
    identity's rejected in one call, as helfem_tpu's two calls decide."""
    b = blocks
    V0 = np.concatenate([b["V0"], np.broadcast_to(np.eye(9), (3, 9, 9))])
    off = _off(np.einsum("bpi,bpq,bqj->bij", np.tile(b["blk_sinvh"], (2, 1, 1)),
                         np.tile(b["Fb"], (2, 1, 1)), np.tile(b["blk_sinvh"], (2, 1, 1)))
               + 1e6 * np.eye(9)[None] * np.tile(b["blk_idx"] == b["nbf"], (2, 1))[:, None, :],
               V0, groups=2)
    assert _far_from_gate(off) and off[0] < GATE < off[1]
    before = dict(linalg.warm_counts)
    E, C, V, good = linalg.eig_blocks_b_warm(
        torch.tensor(np.tile(b["Fb"], (2, 1, 1))), torch.tensor(np.tile(b["blk_idx"], (2, 1))),
        torch.tensor(np.tile(b["blk_sinvh"], (2, 1, 1))), b["nbf"], torch.tensor(V0), GATE,
        groups=2)
    assert good == (True, False)
    assert linalg.warm_counts == {"warm": before["warm"] + 1, "cold": before["cold"] + 1}
    refs = [jl.eig_blocks_b_warm(jnp.asarray(b["Fb"]), jnp.asarray(b["blk_idx"]),
                                 jnp.asarray(b["blk_sinvh"]), b["nbf"], jnp.asarray(v), GATE)
            for v in (V0[:3], V0[3:])]
    assert [bool(r[3]) for r in refs] == [True, False]
    valid = b["valid"]
    _warm_close(E[:3], V[:3], refs[0][0], refs[0][2], valid)
    _cold_close(E[3:], V[3:], refs[1][0], refs[1][2])


@pytest.mark.parametrize("seed", ["near", "identity"])
def test_eig_blocks_dia_b_warm_matches_jax(seed):
    """H2's blocks at a small basis: a Fock matrix of random symmetric
    blocks from a near seed (the cold eigenvectors of a 1e-8 perturbation)
    or the identity. Gate 1e-8: the whitening (|S^-1/2| up to 368 here) and
    the padded slots' 1e6 put the residual's rounding floor at 2e-10."""
    gate = 1e-8
    cfg = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=5)
    jops = JaxDiaBasis(**cfg).build_operators()
    ops = DiatomicBasis(**cfg).build_operators("cpu")
    nblk, blen = ops.blk_idx.shape
    rng = np.random.default_rng(6)
    F = np.stack([_sym(rng, blen, 2.0) for _ in range(nblk)])
    F2 = F + np.stack([_sym(rng, blen, 1e-8) for _ in range(nblk)])
    if seed == "near":
        V0 = np.asarray(jax_dia.eig_blocks_dia_b_warm(jops, jnp.asarray(F),
                                                      jnp.eye(blen)[None].repeat(nblk, 0),
                                                      gate)[2])
    else:
        V0 = np.broadcast_to(np.eye(blen), (nblk, blen, blen)).copy()
    Forth = (np.einsum("bpi,bpq,bqj->bij", ops.blk_sinvh.numpy(), F2, ops.blk_sinvh.numpy())
             + 1e6 * np.eye(blen)[None] * (ops.blk_idx.numpy() == ops.S.shape[0])[:, None, :])
    assert _far_from_gate(_off(Forth, V0), gate)
    E, C, V, good = diatomic_scf.eig_blocks_dia_b_warm(ops, torch.tensor(F2), torch.tensor(V0),
                                                       gate)
    Ej, Cj, Vj, goodj = jax_dia.eig_blocks_dia_b_warm(jops, jnp.asarray(F2), jnp.asarray(V0),
                                                      gate)
    assert good == (seed == "near",) and bool(goodj) == good[0]
    valid = np.asarray(jops.blk_idx) < ops.S.shape[0]
    if good[0]:
        _warm_close(E, V, Ej, Vj, valid)
    else:
        _cold_close(E, V, Ej, Vj)


# ----------------------------------------------------------------------------
# the fused SCF chunks
# ----------------------------------------------------------------------------


def _warm_scf(run):
    linalg.reset_warm_counts()
    res = run()
    counts = dict(linalg.warm_counts)
    assert counts["warm"] > 0, counts
    return res, counts


@pytest.mark.parametrize("case", ["rhf", "uhf"])
def test_atomic_fused_chunks_warm(case):
    """Ne RHF and quartet N UHF (two certificates per step) at small bases."""
    if case == "rhf":
        cfg, na, nb = dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 5, 5
    else:
        cfg, na, nb = dict(Z=7, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 5, 2
    ref = jax_atomic.scf_atom(JaxAtomicBasis(**cfg), na, nb, convthr=1e-9, guess="TF")
    got, counts = _warm_scf(lambda: atomic_scf.scf_atom(AtomicBasis(**cfg), na, nb,
                                                        convthr=1e-9, guess="TF", device="cpu"))
    assert ref.converged and got.converged
    assert got.niter == ref.niter
    assert abs(got.E - ref.E) < 1e-9
    # the first fused step's identity seed fails once per spin
    assert counts["cold"] == (1 if case == "rhf" else 2)


def test_diatomic_fused_chunk_warm():
    cfg = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
    ref = jax_dia.scf_diatomic(JaxDiaBasis(**cfg), 7, 7, method="HF", convthr=1e-9)
    got, counts = _warm_scf(lambda: diatomic_scf.scf_diatomic(
        DiatomicBasis(**cfg), 7, 7, method="HF", convthr=1e-9, device="cpu"))
    assert ref.converged and got.converged
    assert got.niter == ref.niter
    assert abs(got.E - ref.E) < 1e-9
    assert counts["cold"] >= 1


def _last_iteration(text: str) -> int:
    """The number of the last "  it N E=..." line of a verbose SAD solve."""
    return [int(line.split()[1]) for line in text.splitlines()
            if line.startswith("  it ")][-1]


def test_sad_fused_chunk_warm(capsys):
    """Be HF's spherically averaged atom at fixed occupations [4, 0]: its
    fused chunks run the warm eigensolve on the two l channels. helfem_tpu's
    SadResult has no iteration count: both solvers' verbose iteration lines
    give it."""
    cfg = dict(Z=4, lmax=1, nelem=4, nnodes=6)
    occs = np.array([4.0, 0.0])
    ref = jsad.solve_sadatom(jsad.SadAtomBasis(**cfg), method="HF", convthr=1e-9, occs=occs,
                             verbose=True)
    ref_its = _last_iteration(capsys.readouterr().out)
    got, counts = _warm_scf(lambda: sadatom.solve_sadatom(
        sadatom.SadAtomBasis(**cfg), method="HF", convthr=1e-9, occs=occs, device="cpu",
        verbose=True))
    assert ref.converged and got.converged
    assert _last_iteration(capsys.readouterr().out) == got.niter == ref_its
    assert abs(got.E - ref.E) < 1e-9
