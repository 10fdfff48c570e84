"""The port's diatomic host setup against helfem_tpu's on the same basis:
one-electron operators, Gaunt tables, the reduced TEI table and disjoint
moments, symmetry blocks and the DFT grid tables, within 1e-14 x max-abs
(float64, numpy on both sides)."""

import numpy as np
import pytest

from helfem_tpu.models.diatomic import DiatomicBasis as JaxBasis
from helfem_tpu.models.diatomic_dft import build_dia_grid as jax_grid
from helfem_tpu.ops import gaunt as jax_gaunt
from helfem_tpu.ops.legendreq import legendre_PQ as jax_PQ
from helfem_tpu.ops.spherical import legendre_Pbar as jax_Pbar
from helfem_tpu.ops.spherical import ylm_dtheta as jax_dtheta
from helfem_tpu_torch.models.diatomic import DiatomicBasis, lm_to_l_m
from helfem_tpu_torch.models.diatomic_dft import dia_grid_tables
from helfem_tpu_torch.ops import gaunt
from helfem_tpu_torch.ops.legendreq import legendre_PQ
from helfem_tpu_torch.ops.spherical import legendre_Pbar, ylm_dtheta

TOL = 1e-14
CONFIGS = {
    "n2": dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5),
    "co": dict(Z1=6, Z2=8, Rbond=2.132, lmax=(3, 3), rmax=15.0, nelem=3, nnodes=5),
    "h2": dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=5),
}


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    jb = JaxBasis(**cfg)
    jops = {k: np.asarray(v) for k, v in jb.build_operators()._asdict().items()}
    tb = DiatomicBasis(**cfg)
    return jb, jops, tb, tb.host_operators()


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= tol * max(np.abs(ref).max(initial=0.0), 1e-300)


def test_basis_sizes_and_channels_match(pair):
    jb, _, tb, _ = pair
    assert (tb.nang, tb.nrad, tb.nbf, tb.njbd) == (jb.nang, jb.nrad, jb.nbf, jb.njbd)
    assert tb.lm_map == jb.lm_map and tb.LM_map == jb.LM_map
    assert tb.sym_labels() == jb.sym_labels()
    for a, b in zip(tb.sym_blocks(), jb.sym_blocks()):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("field", ["gidx", "shellmask", "S", "H0", "T", "Vnuc", "GmLM",
                                   "GpLM", "LM_ilm", "LMfac", "dP0", "dP2", "dQ0", "dQ2",
                                   "blk_idx", "blk_sinvh"])
def test_operator_tables_match(pair, field):
    _, jops, _, tops = pair
    _close(tops[field], jops[field])


def test_tei_families_match(pair):
    """The port keeps families (0,0), (0,2), (2,2); helfem_tpu's (2,0) is
    the per-block transpose of (0,2)."""
    _, jops, _, tops = pair
    _close(tops["teiJ3"], jops["teiJ"][:, [0, 1, 3]])
    _close(np.swapaxes(tops["teiJ3"][:, 1], -1, -2), jops["teiJ"][:, 2])


@pytest.mark.parametrize("field", ["Bg", "dBg", "w", "invh", "TT", "dTT", "sqeta", "gidx"])
def test_grid_tables_match(pair, field):
    jb, _, tb, _ = pair
    ref = np.asarray(getattr(jax_grid(jb), field))
    _close(dia_grid_tables(tb)[field], ref)


def test_host_helpers_match():
    mu = np.linspace(1e-3, 4.0, 57)
    for got, ref in zip(legendre_PQ(9, 5, mu=mu), jax_PQ(9, 5, mu=mu)):
        _close(got, ref)
    eta = np.linspace(-0.99, 0.99, 23)
    _close(legendre_Pbar(6, eta), jax_Pbar(6, eta))
    _close(ylm_dtheta(6, eta), jax_dtheta(6, eta))
    for args in [(1, 0, 2, 0, 1, 0), (2, 1, 3, 0, 3, 1), (3, -2, 4, 0, 1, -2)]:
        assert gaunt.modified_gaunt_coefficient(*args) == jax_gaunt.modified_gaunt_coefficient(*args)
    for k in (1, 2, 3):
        assert gaunt.cosk_coupling(k, 2, 1, 3, 1) == jax_gaunt.cosk_coupling(k, 2, 1, 3, 1)
    lv, mv = lm_to_l_m((3, 2, 2))
    assert lv.tolist() == [0, 1, 2, 3, 1, 1, 2, 2, 2, 2]
    assert mv.tolist() == [0, 0, 0, 0, 1, -1, 1, -1, 2, -2]
