"""Port's spherically averaged atom solver (models/sadatom.py, sadconf.py,
cli/gensap.py) and the SAP guess against helfem_tpu on the CPU.

Tolerances: the Fock pieces within 1e-12 x max-abs of each output (seeded
positive semidefinite densities through from_jax_sad_ops, so both packages
contract the same tables); converged SAD energies within 1e-9 Eh with equal
occupations; Z_eff tables within 1e-9; the diatomic SAP guess Hamiltonian
within 1e-12 x max-abs; the SAP-started atomic SCF within 1e-9 Eh.

The SAP guesses of the atomic and diatomic comparisons read Z_eff tables
solved here at a small basis (each package its own), put into each
package's per-element SAP cache; the solve at the default basis that Z_sap
runs itself is the same function, so only the table's size differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.cli import gensap as jax_gensap
from helfem_tpu.models import sadatom as jsad
from helfem_tpu.models import sadconf as jconf
from helfem_tpu.models.atomic import AtomicBasis as JaxAtomicBasis
from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiaBasis
from helfem_tpu.models.diatomic_tools import guess_hamiltonian_dia as jax_guess_dia
from helfem_tpu.ops.xc import parse_method as jax_parse_method
from helfem_tpu.scf import guess as jguess
from helfem_tpu.scf.atomic_scf import scf_atom as jax_scf_atom
from helfem_tpu_torch.cli import gensap
from helfem_tpu_torch.models import sadatom, sadconf
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.diatomic_tools import guess_hamiltonian_dia
from helfem_tpu_torch.ops.xc import parse_method
from helfem_tpu_torch.scf import guess
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

TOL = 1e-12
SMALL = dict(nelem=5, nnodes=8)  # the SAP tables' basis
NE_OPS = dict(Z=10, lmax=2, nelem=4, nnodes=6)  # the Fock pieces' basis
N2 = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the solves are streams of small
    ops, and the test workers share the machine's cores, which one pool of a
    thread per core in each worker oversubscribes many times over. BLAS gets
    one thread too: each worker's own pool of a thread per core would spin
    against the others' (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


# ----------------------------------------------------------------------------
# sadconf and totcoup: numpy, equal
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("lmax", [0, 1, 2, 3])
def test_totcoup_table_matches_jax(lmax):
    assert np.array_equal(sadatom.totcoup_table(lmax), jsad.totcoup_table(lmax))


def test_configurations_match_jax():
    for Z in range(1, 119):
        assert np.array_equal(sadconf.get_configuration(Z), jconf.get_configuration(Z)), Z
    for Z, lmax in ((1, 0), (11, 1), (26, 2), (64, 3)):
        occ = sadconf.initial_occs(Z, lmax)
        assert np.array_equal(occ, jconf.initial_occs(Z, lmax))
        assert all(np.array_equal(a, b) for a, b in zip(sadconf.hund_rule(occ),
                                                        jconf.hund_rule(occ)))
        for restricted in (True, False):
            mine = sadconf.move_electrons(occ, restricted)
            theirs = jconf.move_electrons(occ, restricted)
            assert len(mine) == len(theirs)
            assert all(np.array_equal(a, b) for a, b in zip(mine, theirs))


def _synthetic_solve(nl: int, spin: bool):
    """A deterministic solve(key) -> (E, converged, orbE...) whose energy has
    one minimum away from the Madelung start and whose orbital energies
    depend on the occupations."""
    target = np.array([5.0, 8.0, 3.0, 1.0][:nl])

    def orb(occ):
        occ = np.asarray(occ, dtype=float)
        return np.array([[-10.0 / (l + 1 + k) + 0.05 * occ[l] - 0.02 * occ.sum()
                          for k in range(4)] for l in range(nl)])

    def solve(key):
        if spin:
            a, b = (np.asarray(k, dtype=float) for k in key)
            E = float(((a + b - target) ** 2).sum() + 0.1 * ((a - b) ** 2).sum())
            return E, True, orb(a), orb(b)
        occ = np.asarray(key, dtype=float)
        return float(((occ - target) ** 2).sum()), True, orb(occ)

    return solve


@pytest.mark.parametrize("search", ["search_restricted", "search_unrestricted",
                                    "search_spin_scan"])
def test_searches_match_jax_on_synthetic_energies(search):
    nel, lmax = 17, 2
    if search == "search_restricted":
        args = (sadconf.initial_occs(nel, lmax), nel)
    elif search == "search_unrestricted":
        args = (*sadconf.hund_rule(sadconf.initial_occs(nel, lmax)), nel)
    else:
        args = (nel, lmax)
    solve = _synthetic_solve(lmax + 1, search != "search_restricted")
    got = getattr(sadconf, search)(solve, *args)
    ref = getattr(jconf, search)(solve, *args)
    assert got == ref
    assert len(got) > 3


# ----------------------------------------------------------------------------
# Fock pieces on the same tables
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ops_pair():
    jb = jsad.SadAtomBasis(**NE_OPS)
    jops = jb.build_ops()
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items() if k != "at"}
    arrays["at"] = {k: np.asarray(v) for k, v in jops.at._asdict().items()}
    return jb, jops, sadatom.from_jax_sad_ops(arrays, "cpu")


def _psd_cube(nl: int, nrad: int, seed: int, scale: float = 0.1) -> np.ndarray:
    """Seeded positive semidefinite [nl, nrad, nrad] (non-negative densities)."""
    X = np.random.default_rng(seed).standard_normal((nl, nrad, 4))
    return scale * np.einsum("lik,ljk->lij", X, X)


def test_sad_operators_match_the_port_setup(ops_pair):
    """The port's own setup gives the same tables as helfem_tpu's, and its
    L=0 Coulomb set is the L=0 slice of them."""
    _, jops, conv = ops_pair
    mine = sadatom.SadAtomBasis(**NE_OPS).build_ops("cpu")
    for name in ("Tl", "totcoup", "bg", "dbg", "r", "w2"):
        assert np.array_equal(getattr(mine, name).numpy(), np.asarray(getattr(jops, name))), name
    for name in ("tei", "disjL", "disjm1L", "S", "H0", "Sinvh_rad", "G", "Lfac"):
        _close(getattr(mine.at, name).numpy(), np.asarray(getattr(jops.at, name)))
    for name in ("tei", "disjL", "disjm1L", "G", "Lfac"):
        assert torch.equal(getattr(conv.at0, name), getattr(conv.at, name)[:1])
        assert getattr(conv.at0, name).is_contiguous()


def test_sad_exchange_matches_jax(ops_pair):
    jb, jops, ops = ops_pair
    Pang = _psd_cube(jb.lmax + 1, jb.nrad, 31)
    ref = np.asarray(jsad.sad_exchange(jops, jnp.asarray(Pang)))
    _close(sadatom.sad_exchange(ops, torch.tensor(Pang)).numpy(), ref)


def test_sad_coulomb_matches_jax(ops_pair):
    jb, jops, ops = ops_pair
    Pr = _psd_cube(1, jb.nrad, 32)[0]
    ref = np.asarray(jsad.coulomb(jops.at, jnp.asarray(Pr)))
    _close(sadatom.sad_coulomb(ops, torch.tensor(Pr)).numpy(), ref)


@pytest.mark.parametrize("method", ["SVWN", "PBE"])
@pytest.mark.parametrize("spins", ["same", "polarized"])
def test_sad_xc_matches_jax(ops_pair, method, spins):
    """Fxc of both spins, Exc and the electron count on the radial grid."""
    jb, jops, ops = ops_pair
    Pla = _psd_cube(jb.lmax + 1, jb.nrad, 33)
    Plb = Pla if spins == "same" else _psd_cube(jb.lmax + 1, jb.nrad, 34, 0.05)
    ref = jsad.sad_xc(tuple(jax_parse_method(method)[0]), jops, jnp.asarray(Pla),
                      jnp.asarray(Plb))
    ta = torch.tensor(Pla)
    tb = ta if spins == "same" else torch.tensor(Plb)
    got = sadatom.sad_xc(tuple(parse_method(method)[0]), ops, ta, tb)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("method", ["HF", "PBE0"])
def test_sad_fock_matches_jax(ops_pair, method):
    """The whole Fock build with its energies, as the restricted solver
    calls it (the same spin density twice)."""
    jb, jops, ops = ops_pair
    nl = jb.lmax + 1
    Pl = _psd_cube(nl, jb.nrad, 35)
    Pang = _psd_cube(nl, jb.nrad, 36)
    funcs, kfrac = jax_parse_method(method)
    ref = jsad.make_sad_fock(tuple(funcs), kfrac, nl, jb.nrad)(
        jops, jnp.asarray(Pl), jnp.asarray(Pl), jnp.asarray(Pang), jnp.asarray(Pang))
    funcs, kfrac = parse_method(method)
    P, A = torch.tensor(Pl), torch.tensor(Pang)
    got = sadatom.make_sad_fock(tuple(funcs), kfrac, nl)(ops, P, P, A, A)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r))


# ----------------------------------------------------------------------------
# solver and radial outputs
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    (dict(Z=4, lmax=1, nelem=4, nnodes=6), "HF", [4, 0]),
    (dict(Z=19, lmax=2, rmax=50.0, nelem=5, nnodes=8), "SVWN", [7, 12, 0]),
], ids=["be_hf", "k_svwn"])
def test_solve_sadatom_search_matches_jax(case):
    """The occupation search's ground state (K: the 19th electron in 4s),
    every configuration it tried and their energies."""
    cfg, method, occs = case
    ref = jsad.solve_sadatom(jsad.SadAtomBasis(**cfg), method=method, convthr=1e-9)
    got = sadatom.solve_sadatom(sadatom.SadAtomBasis(**cfg), method=method, convthr=1e-9,
                                device="cpu")
    assert got.converged and ref.converged
    assert list(got.occs) == list(ref.occs) == occs
    assert abs(got.E - ref.E) < 1e-9
    assert [k for k, _, _ in got.conf_list] == [k for k, _, _ in ref.conf_list]
    assert max(abs(a[1] - b[1]) for a, b in zip(got.conf_list, ref.conf_list)) < 1e-9
    assert got.nfock >= got.niter > 2


@pytest.fixture(scope="module")
def sap_tables():
    """sap_potential_table of Ne and N at the small basis (lmax 2, as Z_sap
    picks for Z <= 20) in both packages."""
    out = {}
    for Z in (10, 7):
        out[Z] = (jsad.sap_potential_table(Z, lmax=2, **SMALL),
                  sadatom.sap_potential_table(Z, lmax=2, device="cpu", **SMALL))
    return out


@pytest.fixture
def small_sap(sap_tables, monkeypatch):
    """Each package's SAP cache holds its own small-basis tables."""
    for Z, ((jr, jz, _), (tr, tz, _)) in sap_tables.items():
        monkeypatch.setitem(jguess._SAP_CACHE, Z, (jr, jz))
        monkeypatch.setitem(guess._SAP_CACHE, Z, (tr, tz))


@pytest.mark.parametrize("Z", [10, 7])
def test_sap_potential_table_matches_jax(sap_tables, Z):
    (jr, jz, jres), (tr, tz, tres) = sap_tables[Z]
    assert tres.converged and jres.converged
    assert np.array_equal(tr, jr)
    assert np.abs(tz - jz).max() < 1e-9
    assert abs(tres.E - jres.E) < 1e-9
    assert tz[0] > Z - 0.1 and abs(tz[-1]) < 1e-9


@pytest.mark.parametrize("method", ["SVWN", "PBE"])
def test_radial_outputs_match_jax(sap_tables, method):
    """xc_screening (the GGA divergence through torch.func), the 9-column
    table, the radii and the orbital table on JAX's converged Ne density."""
    jb = jsad.SadAtomBasis(Z=10, lmax=2, **SMALL)
    tb = sadatom.SadAtomBasis(Z=10, lmax=2, **SMALL)
    res = sap_tables[10][0][2]
    Prad = res.Pl.sum(axis=0)
    jf, tf = jax_parse_method(method)[0], parse_method(method)[0]
    _close(sadatom.xc_screening(tb, Prad, tf), jsad.xc_screening(jb, Prad, jf))
    _close(sadatom.potential_table(tb, res.Pl / 2, res.Pl / 2, tf),
           jsad.potential_table(jb, res.Pl / 2, res.Pl / 2, jf), 1e-11)
    _close(sadatom.xc_ingredients(tb, res.Pl), jsad.xc_ingredients(jb, res.Pl))
    assert abs(sadatom.vdw_radius(tb, Prad) - jsad.vdw_radius(jb, Prad)) < 1e-12
    assert abs(sadatom.electron_count_radius(tb, Prad, 9.9)
               - jsad.electron_count_radius(jb, Prad, 9.9)) < 1e-12
    rows = sadatom.occupied_orbital_table(tb, res.occs, res.orbE, res.orbs)
    assert rows == jsad.occupied_orbital_table(jb, res.occs, res.orbE, res.orbs)


@pytest.mark.parametrize("mode", ["mean", "weighted", "highspin", "lowspin"])
def test_potential_table_spin_modes_match_jax(sap_tables, mode):
    """The spin-resolved potential variants on a polarized split of JAX's
    converged Ne density (PBE: the divergence term in both spins)."""
    jb = jsad.SadAtomBasis(Z=10, lmax=2, **SMALL)
    tb = sadatom.SadAtomBasis(Z=10, lmax=2, **SMALL)
    Pl = sap_tables[10][0][2].Pl
    Pla, Plb = 0.6 * Pl, 0.4 * Pl
    _close(sadatom.potential_table(tb, Pla, Plb, parse_method("PBE")[0], mode=mode),
           jsad.potential_table(jb, Pla, Plb, jax_parse_method("PBE")[0], mode=mode), 1e-11)


def test_z_sap_matches_jax_on_one_table(monkeypatch):
    """Z_sap's lmax choice, interpolation (Z inside, 0 outside) and 40-bohr
    cutoff, both packages on the same table."""
    calls = []

    def table(Z, method="lda_x", lmax=3, device=None, **kw):
        calls.append((Z, method, lmax))
        r = np.linspace(0.05, 45.0, 50)
        return r, Z * np.exp(-r), None

    monkeypatch.setattr(jsad, "sap_potential_table", table)
    monkeypatch.setattr(sadatom, "sap_potential_table", table)
    for Z in (10, 36):
        monkeypatch.delitem(jguess._SAP_CACHE, Z, raising=False)
        monkeypatch.delitem(guess._SAP_CACHE, Z, raising=False)
    r = np.array([1e-3, 0.5, 3.0, 39.9, 40.5, 46.0])
    for Z in (10, 36):
        assert np.array_equal(guess.Z_sap(r, Z, "cpu"), jguess.Z_sap(r, Z))
    assert calls == [(10, "lda_x", 2), (10, "lda_x", 2), (36, "lda_x", 3), (36, "lda_x", 3)]


def test_scf_atom_sap_guess_matches_jax(small_sap):
    cfg = dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8)
    ref = jax_scf_atom(JaxAtomicBasis(**cfg), 5, 5, convthr=1e-9, guess="SAP")
    got = scf_atom(AtomicBasis(**cfg), 5, 5, convthr=1e-9, guess="SAP", device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9


def test_guess_hamiltonian_dia_sap_matches_jax(small_sap):
    _close(guess_hamiltonian_dia(DiatomicBasis(**N2), "SAP", "cpu"),
           jax_guess_dia(JaxDiaBasis(**N2), "SAP"))


@pytest.mark.parametrize("guess_kind", ["SAP", "GSZ", "TF"])
def test_scf_diatomic_guesses_converge_to_the_core_guess_energy(small_sap, guess_kind):
    basis = DiatomicBasis(**N2)
    ops = basis.build_operators("cpu")
    core = scf_diatomic(basis, 7, 7, method="HF", convthr=1e-9, ops=ops)
    got = scf_diatomic(basis, 7, 7, method="HF", convthr=1e-9, ops=ops, guess=guess_kind)
    assert core.converged and got.converged
    assert abs(got.E - core.E) < 1e-9


def test_gensap_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """result_He.dat: Z_eff within 1e-9, every column within 1e-9 of its
    max-abs (the laplacian reaches 4e8 at the first point); the xc
    potential, ingredient and orbital files are written."""
    monkeypatch.chdir(tmp_path)
    argv = ["--Z", "He", "--lmax", "0", "--nelem", "5", "--nnodes", "8", "--convthr", "1e-9"]
    ref = jax_gensap.main(argv + ["--output", "jax.dat"])
    res = gensap.main(argv + ["--output", "port.dat", "--savepot", "--saveing", "--saveorb",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert res.converged and abs(res.E - ref.E) < 1e-9
    got, want = np.loadtxt("port.dat"), np.loadtxt("jax.dat")
    assert got.shape == want.shape == (200, 9)
    assert np.abs(got[:, 8] - want[:, 8]).max() < 1e-9
    assert (np.abs(got - want).max(0) <= 1e-9 * np.abs(want).max(0)).all()
    for name in ("xcpot.dat", "xcing_He.dat", "orbs_He_l0.dat"):
        assert np.isfinite(np.loadtxt(name)).all(), name
    assert "Configuration: s^2" in out and "vdW radius" in out


@pytest.mark.parametrize("extra, match", [
    # He's rms charge radius, 1.68 fm (without one, Rrms 0 divides by zero
    # in both packages)
    (["--finitenuc", "gaussian", "--Rrms", "3.18e-5", "--completeness"], "--completeness"),
    (["--iconf", "1", "--completeness"], "--completeness"),
    (["--Q", "1", "--conf_R", "5", "--completeness"], "--completeness"),
], ids=["finite_nucleus", "confinement", "charge"])
def test_gensap_cli_unported_flags_raise(tmp_path, monkeypatch, capsys, extra, match):
    """--completeness runs beside --Q, the finite nuclei and the confinement
    (tests/test_torch_cli.py, tests/test_torch_lapl.py,
    tests/test_torch_scf_controls.py): it writes the GTO and STO profiles,
    log10 of 501 exponents then one column per l, the completeness in
    [0, 1] and reaching 1 where the basis spans the probe, the importance
    of the occupied 1s orbital at most 1, beside the SAP table of the run."""
    monkeypatch.chdir(tmp_path)
    res = gensap.main(["--Z", "He", "--lmax", "0", "--device", "cpu", *extra])
    assert res.converged and np.isfinite(res.E)
    for kind in ("GTO", "STO"):
        comp = np.loadtxt(f"{match[2:]}_{kind}_He.dat")
        imp = np.loadtxt(f"importance_{kind}_He.dat")
        assert comp.shape == imp.shape == (501, 2)
        assert np.allclose(comp[:, 0], np.linspace(-5, 10, 501)) and (imp[:, 0] == comp[:, 0]).all()
        assert comp[:, 1].min() >= 0.0 and 0.999 < comp[:, 1].max() <= 1.0 + 1e-10
        assert imp[:, 1].min() >= 0.0 and 0.5 < imp[:, 1].max() <= comp[:, 1].max() + 1e-10
    assert f"{kind} completeness + importance profiles written" in capsys.readouterr().out
    assert np.loadtxt("result_He.dat").shape[1] == 9


@pytest.mark.parametrize("kwargs", [dict(finitenuc="gaussian", Rrms=1e-2), dict(nelem0=2),
                                    dict(iconf=1, conf_N=2, conf_R=4.0),
                                    dict(zeroder=True, primbas=5)],
                         ids=["finitenuc", "nelem0", "iconf", "zeroder"])
def test_unported_basis_options_raise(kwargs):
    """The finite nucleus, its sub-grid, the confinement and zeroder, which
    raised before they were ported, give helfem_tpu's operators within
    1e-12 x max-abs (the confinement folded into the nuclear slot)."""
    cfg = dict(Z=2, lmax=0, nelem=4, nnodes=6, rmax=20.0, **kwargs)
    got = sadatom.SadAtomBasis(**cfg).host_ops()["at"]
    ref = jsad.SadAtomBasis(**cfg).build_ops().at
    for name in ("S", "T", "Vnuc", "H0", "tei"):
        want = np.asarray(getattr(ref, name))
        assert np.abs(got[name] - want).max() <= TOL * np.abs(want).max(), name


def test_unrestricted_solver_raises():
    """The unrestricted solver and search run (tests/test_torch_sadatom_open.py);
    a laplacian-level functional, which helfem_tpu's SAD atom has no path
    for, raises SadLaplacianError (a ValueError) before any solve."""
    basis = sadatom.SadAtomBasis(Z=3, lmax=1)
    with pytest.raises(sadatom.SadLaplacianError, match="no laplacian path"):
        sadatom.solve_sadatom_unrestricted(basis, 2, 1, method="mgga_x_br89", device="cpu")
    with pytest.raises(ValueError, match="no laplacian path"):
        sadatom.search_sadatom_unrestricted(basis, method="mgga_x_br89", device="cpu")
