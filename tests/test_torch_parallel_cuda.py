"""The kernels on the shards of the multi-device layer (parallel/mesh.py), on
the card (marked `cuda`, skipped without one): K1 and K2 on L ranges (one
L, and an empty range, at four ranks), K3 on ranges of the M = 0 Coulomb
channels, K6 on ranges of the exchange steps, K4 and K5 on element ranges
of the diatomic and atomic grids (their owner rows of the uncovered radial
functions -1), each against its plain version on the CPU within 1e-12 x
max-abs with one launch per call, and the sum over the shards against the
unsharded kernels'; then two gloo ranks sharing the card run Be HF to the
single-rank energy within 1e-9 Eh.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch

from helfem_tpu_torch import kernels
from helfem_tpu_torch.models import atomic, atomic_dft, diatomic, diatomic_dft
from helfem_tpu_torch.ops.xc import parse_method
from helfem_tpu_torch.parallel import launch
from helfem_tpu_torch.parallel.mesh import shard_atomic_ops, shard_grid, split_range
from helfem_tpu_torch.scf.atomic_scf import scf_atom

TOL = 1e-12
NE = dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8)  # NL 3
N2 = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(4, 4), rmax=20.0, nelem=4, nnodes=8)
BE = dict(Z=4, lmax=1, mmax=1, rmax=15.0, nelem=4, nnodes=6, nquad=40)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _close(got: torch.Tensor, ref: torch.Tensor) -> None:
    got, ref = got.cpu(), ref.cpu()
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= TOL * float(ref.abs().max())


def _launched(names, fn):
    """fn() with each kernel in names launched exactly once."""
    before = {n: kernels.launches[n] for n in names}
    out = fn()
    torch.cuda.synchronize()
    assert {n: kernels.launches[n] - before[n] for n in names} == dict.fromkeys(names, 1)
    return out


def _block_density(blocks, nbf: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    P = np.zeros((nbf, nbf))
    for idx in blocks:
        X = rng.standard_normal((len(idx), 2)) * 0.1
        P[np.ix_(idx, idx)] = X @ X.T
    return P


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_atomic_kernels_on_L_shards(cuda_device, n):
    """K2 and K1 on each rank's L range against plain; their sum over the
    ranks against the unsharded kernels."""
    basis = atomic.AtomicBasis(**NE)
    host = basis.host_operators()
    og, oc = (atomic.from_jax_operators(host, d) for d in (cuda_device, "cpu"))
    Pc = torch.tensor(_block_density(basis.sym_blocks(2), basis.nbf, 5))
    Pg = Pc.to(cuda_device)
    nang, nrad = basis.nang, basis.nrad
    Jsum = Ksum = 0.0
    for r in range(n):
        lo, hi = split_range(basis.NL, n, r)
        if hi == lo:
            continue
        sg, sc = shard_atomic_ops(og, lo, hi), shard_atomic_ops(oc, lo, hi)
        J = _launched(["radial_coulomb"], lambda: atomic.coulomb(sg, Pg))
        K = _launched(["radial_exchange"], lambda: atomic.exchange_bd(
            sg, atomic.channel_diag(Pg, nang, nrad)))
        _close(J, atomic.coulomb(sc, Pc))
        _close(K, atomic.exchange_bd(sc, atomic.channel_diag(Pc, nang, nrad)))
        Jsum, Ksum = Jsum + J, Ksum + K
    _close(Jsum, atomic.coulomb(og, Pg))
    _close(Ksum, atomic.exchange_bd(og, atomic.channel_diag(Pg, nang, nrad)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_diatomic_kernels_on_channel_and_step_shards(cuda_device, n):
    """K3 on each rank's range of the M = 0 channels and K6 on its range of
    the exchange steps against plain; their sums against the unsharded
    kernels."""
    basis = diatomic.DiatomicBasis(**N2)
    oc = basis.build_operators("cpu")
    og = oc.to(cuda_device)
    Pc = torch.tensor(_block_density(basis.sym_blocks(), basis.nbf, 7))
    m2 = basis.shell_mask().reshape(-1)
    Coc = torch.tensor(np.random.default_rng(9).standard_normal((basis.nbf, 7)) * 0.2
                       * m2[:, None])
    Pg, Cog = Pc.to(cuda_device), Coc.to(cuda_device)
    Jsum = Ksum = 0.0
    nlm = og.step_ilm.shape[0]
    for r in range(n):
        lo, hi = split_range(basis.njbd, n, r)
        sg, sc = ({k: getattr(o, k)[lo:hi] for k in ("GmLM", "GpLM", "LM_ilm")}
                  for o in (og, oc))
        J = _launched(["radial_coulomb_dia"], lambda: diatomic.coulomb_dia(
            og._replace(**sg), Pg))
        _close(J, diatomic.coulomb_dia(oc._replace(**sc), Pc))
        lo, hi = split_range(nlm, n, r)
        steps = ("step_ilm", "step_sp", "step_sm", "step_wm")
        kg = og._replace(**{k: getattr(og, k)[lo:hi] for k in steps})
        kc = oc._replace(**{k: getattr(oc, k)[lo:hi] for k in steps})
        K = _launched(["radial_exchange_dia_occ"], lambda: diatomic.exchange_dia_occ(kg, Cog))
        _close(K, diatomic.exchange_dia_occ(kc, Coc))
        Jsum, Ksum = Jsum + J, Ksum + K
    _close(Jsum, diatomic.coulomb_dia(og, Pg, basis.njbd))
    _close(Ksum, diatomic.exchange_dia_occ(og, Cog))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_xc_kernels_on_element_shards(cuda_device, n):
    """K4 and K5 (through eval_fxc_dia and eval_fxc, two spins) on each
    rank's element range of the diatomic and the atomic grid, the owner and
    band tables rebuilt from the shard's rows, against plain; the sums of
    the Fock matrices, Exc and Nel against the unsharded build."""
    funcs = tuple(parse_method("PBE")[0])
    db = diatomic.DiatomicBasis(**N2)
    ab = atomic.AtomicBasis(**NE)
    ops = db.build_operators("cpu")
    dops = {cuda_device: ops.to(cuda_device), "cpu": ops}
    cases = [
        (db, {d: diatomic_dft.build_dia_grid(db, d) for d in dops}, db.sym_blocks(),
         lambda g, d, Pa, Pb: diatomic_dft.eval_fxc_dia(funcs, g, dops[d], Pa, Pb)),
        (ab, {d: atomic_dft.build_atomic_grid(ab, d) for d in dops}, ab.sym_blocks(2),
         lambda g, d, Pa, Pb: atomic_dft.eval_fxc(funcs, g, Pa, Pb)),
    ]
    for basis, grids, blocks, evaluate in cases:
        Pa = torch.tensor(_block_density(blocks, basis.nbf, 11))
        Pb = torch.tensor(_block_density(blocks, basis.nbf, 12))
        nelem = grids["cpu"].gidx.shape[0]
        sums = None
        for r in range(n):
            lo, hi = split_range(nelem, n, r)
            gg, gc = shard_grid(grids[cuda_device], lo, hi), shard_grid(grids["cpu"], lo, hi)
            assert (gg.owners.cpu() < 0).any()  # radial functions the shard does not cover
            out = _launched(["dia_xc_fields", "dia_xc_fock"], lambda: evaluate(
                gg, cuda_device, Pa.to(cuda_device), Pb.to(cuda_device)))
            for x, y in zip(out, evaluate(gc, "cpu", Pa, Pb)):
                _close(x, y)
            sums = out if sums is None else [s + x for s, x in zip(sums, out)]
        whole = evaluate(grids[cuda_device], cuda_device, Pa.to(cuda_device),
                         Pb.to(cuda_device))
        for s, x in zip(sums, whole):
            _close(s, x)


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(cuda_device):
    """Be HF over two gloo ranks on one card lands within 1e-9 Eh of the
    single-rank SCF; NCCL would need two cards and raises before starting."""
    basis = atomic.AtomicBasis(**BE)
    one = scf_atom(basis, 2, 2, convthr=1e-9, maxit=40, device=cuda_device)
    two = launch.call(scf_atom, 2, (basis, 2, 2), dict(convthr=1e-9, maxit=40, ndev=2),
                      cuda_device, backend="gloo")
    assert one.converged and two.converged and abs(two.E - one.E) < 1e-9
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="NCCL needs 2 CUDA devices"):
            scf_atom(basis, 2, 2, device=cuda_device, ndev=2)
