"""The port's meta-GGA (tau) level and the GGA catalog it lacked (RPBE, B88,
LYP) against helfem_tpu on the CPU, where the XC kernels K4/K5 run their
plain versions.

Tolerances: pointwise energies and every potential within 1e-12 x max-abs
of helfem_tpu.ops.xc.xc_eval; the tau fields and Fock matrices within
1e-12 x max-abs; converged SCF energies within 1e-9 Eh, in helfem_tpu's
iteration count (one more or one fewer for a one-orbital meta-GGA: there
tau = tau_W at every point, where TPSS and SCAN are not differentiable,
and the last bit of tau - tau_W decides how the potential splits between
vsigma and vtau); the tau identities sum w tau = tr(P T) within 1e-10
relative and the grid kinetic matrix within 1e-9 of the analytic one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.cli.atomic import _apply_pars_files as jax_apply_pars_files
from helfem_tpu.models import atomic_dft as jadft
from helfem_tpu.models import diatomic as jdia
from helfem_tpu.models import diatomic_dft as jddft
from helfem_tpu.models import sadatom as jsad
from helfem_tpu.models.atomic import AtomicBasis as JaxBasis
from helfem_tpu.ops import xc as jxc
from helfem_tpu.scf import atomic_scf as jax_scf
from helfem_tpu.scf.diatomic_scf import scf_diatomic as jax_scf_diatomic
from helfem_tpu_torch.cli import atomic as cli_atomic
from helfem_tpu_torch.cli import diatomic as cli_diatomic
from helfem_tpu_torch.cli import gensap as cli_gensap
from helfem_tpu_torch.cli._common import apply_pars_files
from helfem_tpu_torch.kernels import dia_xc_fields_plain
from helfem_tpu_torch.models import atomic_dft, diatomic, diatomic_dft, sadatom
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.xc_grid import build_grid
from helfem_tpu_torch.ops import xc
from helfem_tpu_torch.scf import atomic_scf
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

TOL = 1e-12
METHODS = ["gga_x_rpbe,gga_c_pbe", "gga_x_b88", "gga_c_lyp", "mgga_x_tpss", "mgga_c_tpss",
           "mgga_x_scan", "mgga_c_scan", "mgga_x_rscan", "mgga_c_rscan", "RPBE", "BLYP", "TPSS",
           "TPSSh", "SCAN", "rSCAN", "B3LYP5"]


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The atomic CLI writes its checkpoint (helfem.npz by default) into the
    working directory: each test runs in its own."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the SCFs are streams of small ops,
    and the test workers share the machine's cores. BLAS gets one thread too:
    each worker's own pool of a thread per core would spin against the others'
    (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _points(seed: int = 0, n: int = 600):
    """Seeded grid points: densities from 1e-11 to 1e2 (some below and near
    the 1e-12 threshold), fully spin-polarized points, and tau from tau_W
    itself (exactly, and within rounding) up to ten times above it."""
    rng = np.random.default_rng(seed)
    ra, rb = 10.0 ** rng.uniform(-11, 2, (2, n))
    rb[:60] = 0.0
    ra[60:90] = 10.0 ** rng.uniform(-12.5, -11.5, 30)
    rb[60:90] = 10.0 ** rng.uniform(-12.5, -11.5, 30)
    ga = rng.standard_normal((n, 3)) * ra[:, None] ** (4.0 / 3.0)
    gb = rng.standard_normal((n, 3)) * rb[:, None] ** (4.0 / 3.0)
    saa, sbb, sab = (ga * ga).sum(1), (gb * gb).sum(1), (ga * gb).sum(1)
    twa = saa / (8.0 * ra)
    twb = sbb / (8.0 * np.maximum(rb, 1e-300))
    ta = twa * (1.0 + 10.0 ** rng.uniform(-6, 1, n))
    tb = twb * (1.0 + 10.0 ** rng.uniform(-6, 1, n))
    ta[90:130], tb[90:130] = twa[90:130], twb[90:130]
    ta[130:150] *= 1.0 - 1e-15
    return ra, rb, saa, sab, sbb, ta, tb


@pytest.mark.parametrize("method", METHODS)
def test_functional_matches_jax(method):
    """e and every potential (vrho, vsigma and, for a meta-GGA, vtau) of
    each new catalog entry and alias within 1e-12 x max-abs of helfem_tpu's
    on the same points."""
    ra, rb, saa, sab, sbb, ta, tb = _points()
    jfuncs, tfuncs = jxc.parse_method(method)[0], xc.parse_method(method)[0]
    mgga = any(f.family == "mgga" for f in jfuncs)
    assert mgga == any(f.family == "mgga" for f in tfuncs)
    tau = (ta, tb) if mgga else ()
    ref = jxc.xc_eval(jfuncs, *(jnp.asarray(x) for x in (ra, rb, saa, sab, sbb)), 1e-12,
                      *(jnp.asarray(x) for x in tau))
    got = xc.xc_eval(tfuncs, *(torch.tensor(x) for x in (ra, rb, saa, sab, sbb)), 1e-12,
                     *(torch.tensor(x) for x in tau))
    assert len(got) == len(ref) == (8 if mgga else 6)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        _close(g.numpy(), r)


# ---------------------------------------------------------------------------
# tau fields and Fock matrices on the three grids
# ---------------------------------------------------------------------------

NE = dict(Z=10, lmax=2, mmax=1, rmax=40.0, nelem=3, nnodes=5)
N2 = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
SAD_BE = dict(Z=4, lmax=1, nelem=4, nnodes=6)


@pytest.fixture(scope="module")
def atomic_grid():
    jb, tb = JaxBasis(**NE), AtomicBasis(**NE)
    jg = jadft.build_dft_grid(jb)
    g = atomic_dft.from_jax_atomic_grid({k: np.asarray(v) for k, v in jg._asdict().items()},
                                        jb.nrad, "cpu")
    rng = np.random.default_rng(5)
    same_m = (tb.mval[:, None] == tb.mval[None, :])[:, None, :, None]

    def density():
        X = rng.standard_normal((jb.nbf, 4)) * 0.3
        return ((X @ X.T).reshape(tb.nang, tb.nrad, tb.nang, tb.nrad) * same_m).reshape(
            jb.nbf, jb.nbf)

    return jb, tb, jg, g, density(), density()


@pytest.fixture(scope="module")
def dia_grid():
    jb = jdia.DiatomicBasis(**N2)
    jops, jg = jb.build_operators(), jddft.build_dia_grid(jb)
    tb = diatomic.DiatomicBasis(**N2)
    g = diatomic_dft.from_jax_grid({k: np.asarray(v) for k, v in jg._asdict().items()},
                                   tb.nrad, "cpu")
    ops = diatomic.from_jax_operators({k: np.asarray(v) for k, v in jops._asdict().items()},
                                      "cpu")
    rng = np.random.default_rng(7)

    def density():
        P = np.zeros((jb.nbf, jb.nbf))
        for idx in jb.sym_blocks():
            X = rng.standard_normal((len(idx), 2)) * 0.3
            P[np.ix_(idx, idx)] = X @ X.T
        return P

    return jb, jops, jg, tb, ops, g, density(), density()


def test_dia_grid_tau_tables(dia_grid):
    """The port's own diatomic grid carries helfem_tpu's tau tables (dTT2,
    TTm2 with the a <= b entry on both sides, invhphi2) and the tau factors
    invh^2, invh^2, invhphi2; the live pairs and DDs = dB_i dB_j."""
    jb, _, jg, tb, _, g, _, _ = dia_grid
    mine = diatomic_dft.build_dia_grid(tb, "cpu")
    for name in ("dTT2", "TTm2", "invhphi2"):
        _close(getattr(mine, name).numpy(), np.asarray(getattr(jg, name)), 1e-14)
        assert torch.equal(getattr(mine, name), getattr(g, name)), name
    for name in ("dTT2", "TTm2"):
        T = getattr(g, name)
        assert torch.equal(T, T.transpose(0, 1)), name
        upper = torch.triu(torch.ones(T.shape[:2], dtype=torch.bool))
        assert torch.equal(T[upper], torch.tensor(np.asarray(getattr(jg, name)))[upper]), name
    invh2 = np.asarray(jg.invh) ** 2
    _close(g.tfac[0].numpy(), invh2, 0.0)
    _close(g.tfac[1].numpy(), invh2, 0.0)
    _close(g.tfac[2].numpy(), np.broadcast_to(np.asarray(jg.invhphi2)[:, :, None],
                                              invh2.shape), 0.0)
    a, b = g.pairs[:, 0].long(), g.pairs[:, 1].long()
    assert torch.equal(g.dTT2p, g.dTT2[a, b]) and torch.equal(g.TTm2p, g.TTm2[a, b])
    same_m = jb.mval[:, None] == jb.mval[None, :]
    assert g.pairs.shape[0] == int(np.triu(same_m).sum())
    B = np.asarray(jg.dBg)
    i, j = g.ijs.numpy() >> 16, g.ijs.numpy() & 0xFFFF
    assert np.array_equal(g.DDs[:, :, :len(i)].numpy(), B[:, :, i] * B[:, :, j])
    assert not g.DDs[:, :, len(i):].any()


@pytest.mark.parametrize("field", ["dTT2", "TTm2"])
def test_grid_mirrors_tau_tables_and_checks_tfac(dia_grid, field):
    """build_grid checks the tau factors' shape; the tau tables are taken
    from their a <= b half, whatever the other half holds."""
    _, _, jg, tb, _, g, _, _ = dia_grid
    arrays = {k: np.array(v) for k, v in jg._asdict().items()}
    arrays[field][1, 0, 0] += 1.0
    mirrored = diatomic_dft.from_jax_grid(arrays, tb.nrad, "cpu")
    assert torch.equal(getattr(mirrored, field), getattr(g, field))
    with pytest.raises(ValueError, match="tfac"):
        build_grid(diatomic_dft.DiaGridOps, {**arrays, "tfac": np.ones(3)}, tb.nrad, "cpu")


def test_dia_tau_fields_match_jax(dia_grid):
    """K4's plain tau field of each spin against helfem_tpu's _fields_dia."""
    jb, _, jg, tb, _, g, Pa, Pb = dia_grid
    got = dia_xc_fields_plain(torch.tensor(np.stack((Pa, Pb))), g, True)
    assert len(got) == 4
    for s, P in enumerate((Pa, Pb)):
        P4p = jnp.pad(jnp.asarray(P).reshape(tb.nang, tb.nrad, tb.nang, tb.nrad)
                      .transpose(0, 2, 1, 3), ((0, 0), (0, 0), (0, 1), (0, 1)))
        ref = jddft._fields_dia(jg, P4p, True)
        for x, r in zip(got, ref[:4]):
            _close(x[s].numpy(), r)


@pytest.mark.parametrize("method", ["TPSS", "SCAN", "rSCAN", "BLYP", "TPSSh"])
def test_dia_fock_matches_jax(dia_grid, method):
    """eval_fxc_dia (K4/K5's plain versions in tau mode for a meta-GGA):
    both spins' Fock, Exc and Nel within 1e-12 x max-abs of helfem_tpu's."""
    _, jops, jg, _, ops, g, Pa, Pb = dia_grid
    ref = jddft.eval_fxc_dia(jxc.parse_method(method)[0], jg, jops, jnp.asarray(Pa),
                             jnp.asarray(Pb))
    got = diatomic_dft.eval_fxc_dia(xc.parse_method(method)[0], g, ops, torch.tensor(Pa),
                                    torch.tensor(Pb))
    for x, r in zip(got, ref):
        _close(x.numpy(), r)


def test_dia_tau_integrates_to_kinetic_energy(dia_grid):
    """sum w tau = tr(P T) (tests/test_diatomic.py:98-119's identity) through
    K4's tau mode."""
    jb, _, _, _, ops, g, Pa, _ = dia_grid
    m = ops.shellmask.reshape(-1).numpy()
    P = Pa * np.outer(m, m)
    tau = diatomic_dft._fields_dia(g, torch.tensor(P), True)[3]
    Tgrid = float(torch.sum(g.w * tau))
    Tref = float(np.vdot(P, ops.T.numpy()))
    assert abs(Tgrid - Tref) < 1e-10 * abs(Tref)


@pytest.mark.parametrize("method", ["TPSS", "SCAN", "rSCAN", "B3LYP5"])
@pytest.mark.parametrize("spins", ["two", "same"])
def test_atomic_fock_matches_jax(atomic_grid, method, spins):
    """Atomic eval_fxc for two spin densities and for one (Pb is Pa: one
    spin through each kernel) within 1e-12 x max-abs of helfem_tpu's."""
    jb, _, jg, g, Pa, Pb = atomic_grid
    Pb = Pa if spins == "same" else Pb
    ref = jadft.eval_fxc(jxc.parse_method(method)[0], jg, jnp.asarray(Pa), jnp.asarray(Pb),
                         jb.nrad)
    Ta = torch.tensor(Pa)
    got = atomic_dft.eval_fxc(xc.parse_method(method)[0], g, Ta,
                              Ta if spins == "same" else torch.tensor(Pb))
    for x, r in zip(got, ref):
        _close(x.numpy(), r)


def test_kinetic_grid_matches_analytic(atomic_grid):
    """The grid kinetic matrix through K5's tau contraction against the
    analytic T (tests/test_xc.py::test_grid_kinetic_check's gate)."""
    jb, tb, _, g, _, _ = atomic_grid
    T = atomic_dft.eval_kinetic_grid(g, tb.nrad).numpy()
    Tref = tb.kinetic()
    assert (np.abs(T - Tref) / (1.0 + np.abs(Tref))).max() < 1e-9


@pytest.mark.parametrize("method", ["TPSS", "SCAN"])
def test_sad_xc_matches_jax(method):
    """sad_xc's per-l Fock cube for meta-GGAs (the two-shell SAD grid, one
    K4 and one K5 call per Fock build), two spins and one, against
    helfem_tpu's."""
    jb, tb = jsad.SadAtomBasis(**SAD_BE), sadatom.SadAtomBasis(**SAD_BE)
    jops, ops = jb.build_ops(), tb.build_ops("cpu")
    rng = np.random.default_rng(11)
    Pla, Plb = (np.einsum("lik,ljk->lij", X, X) for X in
                rng.standard_normal((2, tb.lmax + 1, tb.nrad, 2)) * 0.3)
    jf, tf = jxc.parse_method(method)[0], xc.parse_method(method)[0]
    for ja, jb_ in ((Pla, Plb), (Pla, Pla)):
        ref = jsad.sad_xc(jf, jops, jnp.asarray(ja), jnp.asarray(jb_))
        ta = torch.tensor(ja)
        got = sadatom.sad_xc(tf, ops, ta, ta if jb_ is ja else torch.tensor(jb_))
        assert got[0].shape == (tb.lmax + 1, tb.nrad, tb.nrad)
        for x, r in zip(got, ref):
            _close(x.numpy(), r)


# ---------------------------------------------------------------------------
# SCF energies against helfem_tpu
# ---------------------------------------------------------------------------

SCF_CASES = {  # case -> (Z, nela, nelb, method, one orbital per spin)
    "he_tpss": (2, 1, 1, "TPSS", True),
    "be_scan": (4, 2, 2, "SCAN", False),
    "be_rscan": (4, 2, 2, "rSCAN", False),
    "li_uks_tpss": (3, 2, 1, "TPSS", False),
    "he_tpssh": (2, 1, 1, "TPSSh", True),
    "he_b3lyp5": (2, 1, 1, "B3LYP5", False),
}


@pytest.mark.parametrize("case", list(SCF_CASES))
def test_atomic_scf_matches_jax(case):
    """He TPSS, Be SCAN and rSCAN (Be tells them apart: He's one orbital
    has alpha = 0 everywhere), Li UKS-TPSS (2, 1), He TPSSh and B3LYP5
    (hybrids through K1): the energy within 1e-9 Eh of helfem_tpu's, in its
    iteration count."""
    Z, na, nb, method, one_orbital = SCF_CASES[case]
    cfg = dict(Z=Z, lmax=0, mmax=0, rmax=40.0, nelem=5, nnodes=8)
    ref = jax_scf.scf_atom(JaxBasis(**cfg), na, nb, method=method, convthr=1e-10)
    got = atomic_scf.scf_atom(AtomicBasis(**cfg), na, nb, method=method, convthr=1e-10,
                              device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert abs(got.niter - ref.niter) <= (1 if one_orbital else 0)
    assert (got.orbE_b is None) == (ref.orbE_b is None)


def test_diatomic_he_tpss_matches_jax():
    """He as a diatomic (Z2 = 0) with TPSS from the SAP guess (the basis at
    which helfem_tpu converges it): within 1e-9 Eh of helfem_tpu's, in its
    iteration count +-1 (one orbital)."""
    cfg = dict(Z1=2, Z2=0, Rbond=2.0, lmax=(4,), rmax=20.0, nelem=4, nnodes=8)
    ref = jax_scf_diatomic(jdia.DiatomicBasis(**cfg), 1, 1, method="TPSS", convthr=1e-7,
                           guess="SAP")
    got = scf_diatomic(diatomic.DiatomicBasis(**cfg), 1, 1, method="TPSS", convthr=1e-7,
                       guess="SAP", device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9 and abs(got.niter - ref.niter) <= 1


def test_sad_he_tpss_matches_jax():
    """The restricted SAD atom He with TPSS (helfem_tpu's SadResult has no
    iteration count): within 1e-9 Eh of helfem_tpu's, the per-l Fock cube
    through the two-shell SAD grid."""
    kw = dict(Z=2, lmax=0, nelem=5, nnodes=8)
    ref = jsad.solve_sadatom(jsad.SadAtomBasis(**kw), method="TPSS", convthr=1e-8,
                             search=False)
    got = sadatom.solve_sadatom(sadatom.SadAtomBasis(**kw), method="TPSS", convthr=1e-8,
                                search=False, device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9 and abs(got.Exc - ref.Exc) < 1e-9


# ---------------------------------------------------------------------------
# CLI parity: --x_pars, --c_pars, --mdft
# ---------------------------------------------------------------------------

ATOM_CLI = ["--Z", "He", "--lmax", "0", "--mmax", "0", "--nelem", "3", "--nnodes", "5",
            "--iguess", "3", "--convthr", "1e-9", "--device", "cpu"]
DIA_CLI = ["--Z1", "H", "--Z2", "H", "--Rbond", "1.4", "--lmax", "2", "--nelem", "2",
           "--nnodes", "5", "--Rmax", "10", "--convthr", "1e-9", "--device", "cpu"]
GENSAP_CLI = ["--Z", "He", "--lmax", "0", "--nelem", "3", "--nnodes", "5", "--nosearch",
              "--device", "cpu"]
CLIS = {"atomic": (cli_atomic.main, ATOM_CLI), "diatomic": (cli_diatomic.main, DIA_CLI),
        "gensap": (cli_gensap.main, GENSAP_CLI)}
PAIR = "gga_x_pbe,gga_c_pbe"


@pytest.fixture
def pars_files(tmp_path):
    x = tmp_path / "x.pars"
    x.write_text("# revPBE-like exchange\nkappa = 1.245\n")
    c = tmp_path / "c.pars"
    c.write_text("beta=0.046  # PBEsol's\n")
    return str(x), str(c)


@pytest.mark.parametrize("which", ["x", "c", "both"])
def test_pars_files_fold_like_jax(pars_files, which):
    """apply_pars_files gives helfem_tpu's method string, which parses to
    the same functionals with the same parameters."""
    x, c = pars_files
    xp, cp = (x if which != "c" else ""), (c if which != "x" else "")
    got, ref = apply_pars_files(PAIR, xp, cp), jax_apply_pars_files(PAIR, xp, cp)
    assert got == ref
    g, r = xc.parse_method_rs(got), jxc.parse_method_rs(ref)
    assert [(f.name, f.params) for f in g.funcs] == [(f.name, f.params) for f in r.funcs]
    with pytest.raises(SystemExit):
        apply_pars_files("PBE0[kappa=1.0]", xp, cp)


@pytest.mark.parametrize("cli, flag", [
    ("atomic", "x_pars"), ("atomic", "c_pars"), ("atomic", "mdft"),
    ("diatomic", "x_pars"), ("diatomic", "c_pars"), ("diatomic", "mdft"),
    ("gensap", "x_pars"), ("gensap", "c_pars"),
])
def test_cli_takes_xc_flag(pars_files, capsys, cli, flag):
    """Each CLI runs with the flag: a parameter file gives the energy of
    the method string helfem_tpu's _apply_pars_files makes of it (and not
    that of the plain pair), --mdft changes nothing."""
    main, argv = CLIS[cli]
    x, c = pars_files
    extra = {"x_pars": ["--x_pars", x], "c_pars": ["--c_pars", c], "mdft": ["--mdft", "4"]}[flag]
    folded = jax_apply_pars_files(PAIR, *{"x_pars": (x, ""), "c_pars": ("", c),
                                          "mdft": ("", "")}[flag])
    argv = argv + (["--output", "/dev/null"] if cli == "gensap" else [])
    got = main(argv + ["--method", PAIR] + extra)
    ref = main(argv + ["--method", folded])
    plain = main(argv + ["--method", PAIR])
    capsys.readouterr()
    assert got.converged and got.E == ref.E
    assert (got.E == plain.E) == (flag == "mdft")
