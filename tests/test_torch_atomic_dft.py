"""Port's atomic DFT (models/atomic_dft.py on the XC kernels' plain
versions) and open-shell atomic SCF against helfem_tpu on the CPU.

Tolerances: grid tables equal; the XC Fock matrices within 1e-12 x max-abs,
Exc and Nel within 1e-12 relative; the grid overlap within 1e-12 x max-abs
of helfem_tpu's and 1e-10 of the analytic S (the reference's self-check
gate); converged SCF energies within 1e-9 Eh."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models import atomic_dft as jdft
from helfem_tpu.models.atomic import AtomicBasis as JaxBasis
from helfem_tpu.ops.xc import parse_method as jax_parse_method
from helfem_tpu.scf import atomic_scf as jax_scf
from helfem_tpu.utils import linalg as jax_linalg
from helfem_tpu_torch.cli.atomic import main
from helfem_tpu_torch.models import atomic_dft
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.ops.xc import Functional, parse_method
from helfem_tpu_torch.scf import atomic_scf
from helfem_tpu_torch.utils import linalg

TOL = 1e-12
NE = dict(Z=10, lmax=2, mmax=1, rmax=40.0, nelem=3, nnodes=5)


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The atomic CLI writes its checkpoint (helfem.npz by default) into the
    working directory: each test runs in its own."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the SCFs are streams of small ops,
    and the test workers share the machine's cores, which one pool of a thread
    per core in each worker oversubscribes many times over. BLAS gets one
    thread too: each worker's own pool of a thread per core would spin against
    the others' (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    jb, tb = JaxBasis(**NE), AtomicBasis(**NE)
    jg = jdft.build_dft_grid(jb)
    arrays = {k: np.asarray(v) for k, v in jg._asdict().items()}
    return jb, tb, jg, atomic_dft.from_jax_atomic_grid(arrays, jb.nrad, "cpu")


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_grid_tables_match_jax(grids):
    """The port's host tables are helfem_tpu's bit for bit, and its own
    grid is the one carried over from them."""
    jb, tb, jg, g = grids
    tables = atomic_dft.atomic_grid_tables(tb)
    for name, value in tables.items():
        assert np.array_equal(value, np.asarray(getattr(jg, name))), name
    mine = atomic_dft.build_atomic_grid(tb, "cpu")
    for name in atomic_dft.AtomGridOps._fields:
        a, b = getattr(mine, name), getattr(g, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    assert torch.equal(g.w, torch.tensor(np.asarray(jg.w2)[:, :, None]
                                         * np.asarray(jg.wth)[None, None, :]))
    assert not (g.invh - 1.0).any() and not (g.sqeta - 1.0).any()
    # the live pairs are the same-m pairs a <= b: every m-block of the basis
    same_m = tb.mval[:, None] == tb.mval[None, :]
    assert g.pairs.shape[0] == int(np.triu(same_m).sum())


def _densities(tb, case):
    """(Pa, Pb): random symmetric positive semidefinite densities that are
    channel-block-diagonal, or dense over the same-m channel pairs."""
    rng = np.random.default_rng({"block": 3, "dense": 4}[case])
    nang, nrad = tb.nang, tb.nrad
    same_m = (tb.mval[:, None] == tb.mval[None, :]).astype(float)
    mask = np.eye(nang) if case == "block" else same_m
    out = []
    for s in range(2):
        X = rng.standard_normal((nang, nrad, 4))
        P4 = 0.05 * np.einsum("aik,bjk->abij", X, X) * mask[:, :, None, None]
        out.append(P4.transpose(0, 2, 1, 3).reshape(tb.nbf, tb.nbf))
    return out


@pytest.mark.parametrize("method", ["SVWN", "PBE"])
@pytest.mark.parametrize("case", ["block_ns1", "block_ns2", "dense_ns2"])
def test_eval_fxc_matches_jax(grids, method, case):
    """Fxc of both spins, Exc and Nel: one spin (Pb is Pa) or two, on
    channel-block-diagonal densities and on a dense one with same-m cross
    blocks."""
    jb, tb, jg, g = grids
    Pa, Pb = _densities(tb, case.split("_")[0])
    if case.endswith("ns1"):
        Pb = Pa
    ref = jdft.eval_fxc(tuple(jax_parse_method(method)[0]), jg, jnp.asarray(Pa),
                        jnp.asarray(Pb), jb.nrad)
    ta = torch.tensor(Pa)
    got = atomic_dft.eval_fxc(tuple(parse_method(method)[0]), g, ta,
                              ta if Pb is Pa else torch.tensor(Pb))
    for x, r in zip(got, ref):
        _close(x.numpy(), r)


def test_eval_fxc_rejects_meta_gga(grids):
    """A laplacian-level meta-GGA (family mggal, BR89's) raises ValueError on
    a grid built without the laplacian tables (lapl=True builds them; BR89
    runs there, tests/test_torch_lapl.py); the tau level runs
    (tests/test_torch_mgga.py)."""
    *_, g = grids
    tau = Functional("mgga_x_fake", "mggal", lambda *a: a[0])
    P = torch.zeros(g.owners.shape[0] * g.TT.shape[0], g.owners.shape[0] * g.TT.shape[0])
    with pytest.raises(ValueError, match="lapl=True"):
        atomic_dft.eval_fxc((tau,), g, P, P)


def test_overlap_grid_matches_jax_and_the_analytic_overlap(grids):
    jb, tb, jg, g = grids
    S = atomic_dft.eval_overlap_grid(g, tb.nrad).numpy()
    _close(S, jdft.eval_overlap_grid(jg, jb.nrad))
    Sref = tb.overlap()
    norm = np.sqrt(np.outer(np.diag(Sref), np.diag(Sref)))
    assert np.abs((S - Sref) / norm).max() < 1e-10


def test_kinetic_grid_matches_jax(grids):
    jb, tb, jg, g = grids
    T = atomic_dft.eval_kinetic_grid(g, tb.nrad).numpy()
    _close(T, jdft.eval_kinetic_grid(jg, jb.nrad))
    Tref = tb.kinetic()
    assert (np.abs(T - Tref) / (1 + np.abs(Tref))).max() < 1e-9


def test_rohf_update_matches_jax():
    rng = np.random.default_rng(5)
    n = 12
    X = rng.standard_normal((n, n))
    S = X @ X.T + n * np.eye(n)
    Fa, Fb = (0.5 * (Y + Y.T) for Y in rng.standard_normal((2, n, n)))
    C = rng.standard_normal((n, 4))
    P = C @ C.T
    Sh, Sinvh = linalg.form_sh(S), linalg.form_sinvh(S)
    assert np.array_equal(Sh, np.asarray(jax_linalg.form_sh(S)))
    got = linalg.rohf_update(Fa, Fb, P, Sh, Sinvh, 3, 1)
    ref = jax_linalg.rohf_update(Fa, Fb, P, Sh, Sinvh, 3, 1)
    for x, r in zip(got, ref):
        _close(x, r)


SCF_CASES = {
    "he_svwn": (dict(Z=2, lmax=0, mmax=0, rmax=40.0, nelem=5, nnodes=8), 1, 1,
                dict(method="SVWN")),
    "ne_pbe0": (dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 5, 5,
                dict(method="PBE0")),
    "li_uhf": (dict(Z=3, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 2, 1,
               dict(method="HF")),
    "n_uks_pbe": (dict(Z=7, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 5, 2,
                  dict(method="PBE")),
    "n_rohf": (dict(Z=7, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 5, 2,
               dict(method="HF", restricted=1)),
}


_JAX_SCF: dict = {}


def _jax_scf(case):
    """helfem_tpu's converged SCF of a case, solved once per module."""
    if case not in _JAX_SCF:
        cfg, na, nb, kw = SCF_CASES[case]
        _JAX_SCF[case] = jax_scf.scf_atom(JaxBasis(**cfg), na, nb, convthr=1e-10, **kw)
    return _JAX_SCF[case]


@pytest.mark.parametrize("case", list(SCF_CASES))
def test_scf_energy_matches_jax(case):
    """Restricted DFT and hybrids, UHF, UKS and ROHF: the converged energy
    within 1e-9 Eh of helfem_tpu's, with the same occupations and grid
    electron count."""
    cfg, na, nb, kw = SCF_CASES[case]
    ref = _jax_scf(case)
    got = atomic_scf.scf_atom(AtomicBasis(**cfg), na, nb, convthr=1e-10, device="cpu", **kw)
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert abs(got.Nelgrid - ref.Nelgrid) < 1e-9
    for comp in ("Ekin", "Enuc", "Ecoul", "Exx", "Exc"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-7, comp
    assert np.array_equal(np.sort(got.occ_a.ravel()), np.sort(ref.occ_a.ravel()))
    assert (got.orbE_b is None) == (ref.orbE_b is None)
    if ref.orbE_b is not None:
        assert np.array_equal(np.sort(got.occ_b.ravel()), np.sort(ref.occ_b.ravel()))
        assert np.abs(got.orbE_b[:nb] - ref.orbE_b[:nb]).max() < 1e-7


def test_cli_runs_pbe_on_cpu(capsys):
    """The atomic CLI with --method PBE on the quartet N (--M 4: 5 alpha, 2
    beta, unrestricted): the grid self-check lines and the energy of
    helfem_tpu's scf_atom on the same basis."""
    res = main(["--Z", "N", "--lmax", "1", "--mmax", "1", "--nelem", "5", "--nnodes", "8",
                "--M", "4", "--method", "PBE", "--iguess", "3", "--convthr", "1e-10",
                "--device", "cpu"])
    out = capsys.readouterr().out
    ref = _jax_scf("n_uks_pbe")
    assert res.converged and abs(res.E - ref.E) < 1e-9
    assert "Error in overlap matrix evaluated through xc grid is" in out
    assert "Relative error in kinetic matrix evaluated through xc grid is" in out
    assert "(fused)" in out and "Exchange-correlation  energy:" in out
