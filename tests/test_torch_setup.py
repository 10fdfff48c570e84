"""helfem_tpu_torch host setup against helfem_tpu: the operator arrays, the
symmetry blocks and the guess Hamiltonians must be BIT-identical (the port
carries the numpy/longdouble setup over unchanged)."""

import numpy as np
import pytest

from helfem_tpu.models.atomic import AtomicBasis as JaxBasis
from helfem_tpu.scf.guess import potential as jax_potential
from helfem_tpu_torch.models.atomic import AtomicBasis, AtomicOperators, from_jax_operators
from helfem_tpu_torch.scf.guess import potential

CONFIGS = {
    "ne_small": dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=4, nnodes=8),
    "ar_bench": dict(Z=18, lmax=1, mmax=1, rmax=40.0, nelem=10, nnodes=15),
}


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def bases(request):
    cfg = CONFIGS[request.param]
    jb, tb = JaxBasis(**cfg), AtomicBasis(**cfg)
    return jb, tb, jb.build_operators(), tb.build_operators("cpu")


def _bit_identical(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_operator_arrays_bit_identical(bases):
    _, _, jops, tops = bases
    for name in AtomicOperators._fields:
        assert _bit_identical(np.asarray(getattr(jops, name)), getattr(tops, name).numpy()), name


def test_from_jax_operators_bit_identical(bases):
    _, _, jops, tops = bases
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()}
    conv = from_jax_operators(arrays, "cpu")
    for name in AtomicOperators._fields:
        assert _bit_identical(getattr(conv, name).numpy(), getattr(tops, name).numpy()), name


def test_sizes_and_sym_blocks_identical(bases):
    jb, tb, _, _ = bases
    assert (jb.nang, jb.nrad, jb.nbf, jb.NL) == (tb.nang, tb.nrad, tb.nbf, tb.NL)
    for symm in (0, 1, 2):
        jblk, tblk = jb.sym_blocks(symm), tb.sym_blocks(symm)
        assert len(jblk) == len(tblk)
        assert all(np.array_equal(a, b) for a, b in zip(jblk, tblk))
        assert jb.sym_labels(symm) == tb.sym_labels(symm)


@pytest.mark.parametrize("guess", ["core", "TF", "GSZ"])
def test_guess_hamiltonian_bit_identical(bases, guess):
    jb, tb, _, _ = bases
    Hj = jb.kinetic() + jb.model_potential(jax_potential(guess, jb.Z))
    Ht = tb.kinetic() + tb.model_potential(potential(guess, tb.Z))
    assert _bit_identical(Hj, Ht)

