"""Port's unrestricted spherically averaged atom (solve_sadatom_unrestricted,
search_sadatom_unrestricted, the two-spin Fock build, the potential
variants and gensap --unrestricted) against helfem_tpu on the CPU.

Tolerances: the two-spin Fock build within 1e-12 x max-abs of helfem_tpu's
on the same seeded densities; converged energies within 1e-9 Eh with equal
occupations; the potential-variant tables within 1e-9 x max-abs per column.
The Cr configuration search runs on the port alone, with helfem_tpu's own
assertions (tests/test_sadatom.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models import sadatom as jsad
from helfem_tpu.ops.xc import parse_method as jax_parse_method
from helfem_tpu_torch.cli import gensap
from helfem_tpu_torch.models import sadatom
from helfem_tpu_torch.ops.xc import parse_method

TOL = 1e-12
NE_OPS = dict(Z=10, lmax=2, nelem=4, nnodes=6)
N_SVWN = dict(Z=7, lmax=1, nelem=8, nnodes=12)
# label -> (SadAtomBasis arguments, nela, nelb, method, convthr)
SOLVES = {
    "li_hf": (dict(Z=3, lmax=1), 2, 1, "HF", 1e-8),
    "n_svwn": (N_SVWN, 5, 2, "SVWN", 1e-7),
    "o_pbe": (dict(Z=8, lmax=1, nelem=6, nnodes=8), 5, 3, "PBE", 1e-8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the solves are streams of small
    ops, and the test workers share the machine's cores. BLAS gets one thread
    too: each worker's own pool of a thread per core would spin against the
    others' (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved():
    out = {}

    def get(label):
        if label not in out:
            cfg, na, nb, method, thr = SOLVES[label]
            ref = jsad.solve_sadatom_unrestricted(jsad.SadAtomBasis(**cfg), na, nb,
                                                  method=method, convthr=thr)
            got = sadatom.solve_sadatom_unrestricted(sadatom.SadAtomBasis(**cfg), na, nb,
                                                     method=method, convthr=thr, device="cpu")
            out[label] = ref, got
        return out[label]

    return get


@pytest.mark.parametrize("label", list(SOLVES))
def test_unrestricted_solve_matches_jax(solved, label):
    ref, got = solved(label)
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert list(got.occs) == list(ref.occs) and list(got.occs_b) == list(ref.occs_b)
    for comp in ("Ekin", "Ecoul", "Exx", "Exc"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-8, comp
    assert np.abs(got.Pl - ref.Pl).max() < 1e-7 and np.abs(got.Plb - ref.Plb).max() < 1e-7
    assert got.nfock == got.niter > 2


def test_unrestricted_li_exact(solved):
    """tests/test_sadatom.py's gate: s-only atoms are exactly spherical, so
    SAD-UHF Li is the UHF limit."""
    got = solved("li_hf")[1]
    assert abs(got.E + 7.432751) < 1e-6
    assert list(got.occs) == [2, 0] and list(got.occs_b) == [1, 0]


def test_unrestricted_nitrogen_config(solved):
    got = solved("n_svwn")[1]
    assert list(got.occs) == [2, 3] and list(got.occs_b) == [2, 0]


def test_potential_variants_open_shell_order(solved):
    """High spin sees the alpha density doubled, so its screening differs
    from low spin; every variant shares the density and Coulomb columns;
    each table equals helfem_tpu's on helfem_tpu's own solution."""
    ref, got = solved("n_svwn")
    basis, jbasis = sadatom.SadAtomBasis(**N_SVWN), jsad.SadAtomBasis(**N_SVWN)
    funcs, jfuncs = parse_method("SVWN")[0], jax_parse_method("SVWN")[0]
    tables = {}
    for mode in gensap.VARIANTS.values():
        tables[mode] = sadatom.potential_table(basis, got.Pl, got.Plb, funcs, mode=mode)
        want = jsad.potential_table(jbasis, ref.Pl, ref.Plb, jfuncs, mode=mode)
        mine = sadatom.potential_table(basis, ref.Pl, ref.Plb, funcs, mode=mode)
        assert (np.abs(mine - want).max(0) <= 1e-9 * np.abs(want).max(0) + 1e-300).all(), mode
    hi, lo, wt = tables["highspin"], tables["lowspin"], tables["weighted"]
    assert np.abs(hi[:, 6] - lo[:, 6]).max() > 1e-3
    assert np.abs(hi[:, 1] - lo[:, 1]).max() < 1e-12
    assert np.abs(hi[:, 5] - wt[:, 5]).max() < 1e-12


@pytest.mark.parametrize("method", ["HF", "PBE0", "PBE"])
def test_two_spin_sad_fock_matches_jax(method):
    """The Fock build with two spin densities: K1 once on the stacked cubes
    (the same as two one-spin calls), K2 on the total, the XC for both
    spins."""
    jb = jsad.SadAtomBasis(**NE_OPS)
    jops = jb.build_ops()
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items() if k != "at"}
    arrays["at"] = {k: np.asarray(v) for k, v in jops.at._asdict().items()}
    ops = sadatom.from_jax_sad_ops(arrays, "cpu")
    nl, nrad = jb.lmax + 1, jb.nrad
    rng = np.random.default_rng(71)
    Pla, Plb, Panga, Pangb = (0.1 * np.einsum("lik,ljk->lij", X, X)
                              for X in rng.standard_normal((4, nl, nrad, 4)))
    funcs, kfrac = jax_parse_method(method)
    ref = jsad.make_sad_fock(tuple(funcs), kfrac, nl, nrad)(
        jops, *(jnp.asarray(P) for P in (Pla, Plb, Panga, Pangb)))
    funcs, kfrac = parse_method(method)
    got = sadatom.make_sad_fock(tuple(funcs), kfrac, nl)(
        ops, *(torch.tensor(P) for P in (Pla, Plb, Panga, Pangb)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= TOL * max(np.abs(r).max(), 1.0)
    assert float((got[0] - got[1]).abs().max()) > 1e-3
    both = sadatom.sad_exchange(ops, torch.stack((torch.tensor(Panga), torch.tensor(Pangb))))
    for s, P in enumerate((Panga, Pangb)):
        assert torch.equal(both[s], sadatom.sad_exchange(ops, torch.tensor(P)))


def test_unrestricted_search_cr_ground_state():
    """tests/test_sadatom.py's Cr search on the port: spin polarisation picks
    out 3d5 4s1, M = 7."""
    basis = sadatom.SadAtomBasis(Z=24, lmax=2, rmax=40.0, nelem=6, nnodes=10)
    ru = sadatom.search_sadatom_unrestricted(basis, method="lda_x", mode="aufbau",
                                             device="cpu")
    assert ru.converged
    assert list(np.array(ru.occs) + np.array(ru.occs_b)) == [7, 12, 5]
    assert int(sum(ru.occs) - sum(ru.occs_b) + 1) == 7
    assert ru.nfock > ru.niter and len(ru.conf_list) > 1

