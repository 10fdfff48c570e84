"""Range-separated exchange of the port (LC-LDA, LDAERF, LCY-LDA, SR-PBE0 on
atoms) against helfem_tpu on the CPU.

Tolerances: the Bessel functions and the erfc expansion within 1e-14
relative; the Yukawa and erfc tables within 1e-13 x max-abs; the exchange
operators within 1e-12 x max-abs; lda_x_erf's values and first derivatives
within 1e-12 relative, or, where the closed form of the short-range factor
cancels (1.5 < a < 8, a = omega / 2 kF), within 4 ulp of the size of the
cancelling terms, the rounding helfem_tpu's own value carries there;
converged SCF energies within 1e-9 Eh in helfem_tpu's iteration count +-1.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models import atomic as jatomic
from helfem_tpu.ops import bessel as jbessel
from helfem_tpu.ops import erfc_expn as jerfc
from helfem_tpu.ops import xc as jxc
from helfem_tpu.scf.atomic_scf import scf_atom as jax_scf_atom
from helfem_tpu_torch.cli.atomic import main
from helfem_tpu_torch.kernels import (
    radial_erfc_exchange_plain,
    radial_exchange_pairwise_plain,
    radial_exchange_plain,
)
from helfem_tpu_torch.models import atomic
from helfem_tpu_torch.ops import bessel, erfc_expn, xc
from helfem_tpu_torch.scf.atomic_scf import scf_atom

# helfem_tpu's range-separation test basis (tests/test_rs_scf.py), and its
# lmax = 1 variant where NL > 1 matters
BASIS = dict(lmax=0, mmax=0, rmax=15.0, nelem=5, nnodes=8, nquad=40)
BASIS_L1 = dict(BASIS, lmax=1)
TOL = 1e-12
EPS = np.finfo(np.float64).eps


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The atomic CLI writes its checkpoint (helfem.npz by default) into the
    working directory: each test runs in its own."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the SCFs are streams of small ops, and the test
    workers share the machine's cores. BLAS gets one thread too: each worker's
    own pool of a thread per core would spin against the others'
    (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _legendre(L, x):
    from numpy.polynomial import legendre

    return legendre.legval(x, [0] * L + [1])


# ---------------------------------------------------------------- host tables


def test_bessel_functions_match_jax():
    x = np.geomspace(1e-3, 200.0, 301)
    for ours, theirs in ((bessel.bessel_il, jbessel.bessel_il),
                         (bessel.bessel_kl, jbessel.bessel_kl)):
        got, ref = ours(x, 12), theirs(x, 12)
        assert np.all(np.abs(got - ref) <= 1e-14 * np.abs(ref))


def test_phi_table_matches_jax_on_both_branches():
    """Points on the short-range series branch (small arguments) and on the
    general expansion, in both argument orders."""
    rng = np.random.default_rng(5)
    Xi = np.concatenate([rng.uniform(0.0, 0.45, 200), rng.uniform(0.4, 12.0, 400)])
    xi = np.concatenate([rng.uniform(0.0, 0.45, 200), rng.uniform(0.0, 12.0, 400)])
    got, ref = erfc_expn.phi_table(6, Xi, xi), jerfc.phi_table(6, Xi, xi)
    assert np.all(np.abs(got - ref) <= 1e-14 * np.abs(ref))
    assert np.array_equal(erfc_expn.phi_table(6, xi, Xi), got)


def _two_points(r1, c1, r2, c2):
    s1, s2 = np.sqrt(1 - c1**2), np.sqrt(1 - c2**2)
    cosg = c1 * c2 + s1 * s2
    return cosg, np.sqrt(r1**2 + r2**2 - 2 * r1 * r2 * cosg)


@pytest.mark.parametrize("pts", [((1.0, 0.2), (2.5, -0.6)), ((0.4, 0.9), (0.9, 0.3))])
def test_yukawa_addition_theorem(pts):
    """4 pi lam sum_LM i_L(lam r<) k_L(lam r>) Y Y* = e^{-lam r12}/r12 with the
    port's own Bessel functions."""
    lam, Lmax = 0.7, 60
    (r1, c1), (r2, c2) = pts
    cosg, r12 = _two_points(r1, c1, r2, c2)
    iv = bessel.bessel_il(np.array([lam * min(r1, r2)]), Lmax)[:, 0]
    kv = bessel.bessel_kl(np.array([lam * max(r1, r2)]), Lmax)[:, 0]
    tot = sum(lam * (2 * L + 1) * iv[L] * kv[L] * _legendre(L, cosg) for L in range(Lmax + 1))
    exact = np.exp(-lam * r12) / r12
    assert abs(tot - exact) < 1e-12 * exact


@pytest.mark.parametrize("pts", [((1.0, 0.2), (2.5, -0.6)), ((0.3, 0.9), (0.7, 0.3))])
def test_erfc_expansion_identity(pts):
    """erfc(mu r12)/r12 = mu sum_L Phi_L(mu r<, mu r>) P_L(cos gamma) with the
    port's own Phi (helfem_tpu's gate at these small-argument points)."""
    mu, Lmax = 0.3, 50
    (r1, c1), (r2, c2) = pts
    cosg, r12 = _two_points(r1, c1, r2, c2)
    P = erfc_expn.phi_table(Lmax, np.array([mu * max(r1, r2)]), np.array([mu * min(r1, r2)]))
    tot = sum(mu * P[L, 0] * _legendre(L, cosg) for L in range(Lmax + 1))
    exact = math.erfc(mu * r12) / r12
    assert abs(tot - exact) < 1e-6 * exact


@pytest.fixture(scope="module")
def bases():
    jb, tb = jatomic.AtomicBasis(Z=4, **BASIS_L1), atomic.AtomicBasis(Z=4, **BASIS_L1)
    jops = jb.build_operators()
    ops = atomic.from_jax_operators({k: np.asarray(v) for k, v in jops._asdict().items()},
                                    "cpu")
    return jb, tb, jops, ops


@pytest.mark.parametrize("table", ["yukawa_disjoint", "yukawa_integral", "erfc_integral"])
def test_radial_tables_match_jax(bases, table):
    jb, tb, _, _ = bases
    arg = 0.5 if table == "erfc_integral" else 0.7
    got, ref = getattr(tb.rb, table)(2, arg), getattr(jb.rb, table)(2, arg)
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        _close(g, r, 1e-13)
    if table == "yukawa_disjoint":
        assert not got[1][:, 0].any()  # k_L of element 0 zeroed, as helfem_tpu


# ---------------------------------------------------------- exchange operators


def _channel_densities(basis, ns, seed):
    """ns random symmetric channel-diagonal densities [ns, nang, nrad, nrad]."""
    X = np.random.default_rng(seed).standard_normal((ns, basis.nang, basis.nrad, basis.nrad))
    return X + X.transpose(0, 1, 3, 2)


@pytest.mark.parametrize("ns", [1, 2])
@pytest.mark.parametrize("kernel, arg", [("yukawa", 0.7), ("yukawa", 5.0), ("erfc", 0.11),
                                         ("erfc", 0.5)])
def test_rs_exchange_matches_jax(bases, kernel, arg, ns):
    """rs_exchange_bd (Yukawa tables, pairwise K1 form) and erfc_exchange_bd
    (K10) on one spin or two stacked, against helfem_tpu's, one spin at a
    time."""
    jb, tb, jops, ops = bases
    if kernel == "yukawa":
        jrs, fn, jfn = jb.build_yukawa(arg), atomic.rs_exchange_bd, jatomic.rs_exchange_bd
    else:
        jrs, fn, jfn = jb.build_erfc(arg), atomic.erfc_exchange_bd, jatomic.erfc_exchange_bd
    rs = atomic.from_jax_rs_operators({k: np.asarray(v) for k, v in jrs._asdict().items()},
                                      "cpu")
    assert type(rs).__name__ == type(jrs).__name__
    Pd = _channel_densities(tb, ns, 7)
    K = fn(ops, rs, torch.tensor(Pd if ns == 2 else Pd[0])).numpy()
    for s in range(ns):
        ref = np.asarray(jfn(jops, jrs, jnp.asarray(Pd[s])))
        _close(K[s] if ns == 2 else K, ref, TOL)


def test_pairwise_plain_is_exact_where_prefix_sums_are_not():
    """On Yukawa tables at lam = 5, rmax = 40 (i_L reaches ~1e28 there): the
    pairwise plain form of K1 matches helfem_tpu's rs_exchange_bd, and the
    prefix-sum form, which helfem_tpu keeps for the Coulomb tables, loses
    more than 1e-6 of the operator."""
    cfg = dict(BASIS, rmax=40.0)
    jb, tb = jatomic.AtomicBasis(Z=4, **cfg), atomic.AtomicBasis(Z=4, **cfg)
    jops, jrs = jb.build_operators(), jb.build_yukawa(5.0)
    rs = atomic.from_jax_rs_operators({k: np.asarray(v) for k, v in jrs._asdict().items()},
                                      "cpu")
    gidx = torch.tensor(tb.rb.fem.gidx, dtype=torch.int32)
    Pd = torch.tensor(_channel_densities(tb, 1, 11)[0])
    pair = radial_exchange_pairwise_plain(rs.tei, rs.iL, rs.kL, gidx, Pd)
    prefix = radial_exchange_plain(rs.tei, rs.iL, rs.kL, gidx, Pd)
    ops = atomic.from_jax_operators({k: np.asarray(v) for k, v in jops._asdict().items()},
                                    "cpu")
    K = atomic.rs_exchange_bd(ops, rs, Pd).numpy()
    _close(K, np.asarray(jatomic.rs_exchange_bd(jops, jrs, jnp.asarray(Pd.numpy()))), TOL)
    scale = float(pair.abs().max())
    assert float((pair - prefix).abs().max()) > 1e-6 * scale
    # on the Coulomb tables the two forms agree
    a = radial_exchange_pairwise_plain(ops.tei, ops.disjL, ops.disjm1L, gidx, Pd)
    b = radial_exchange_plain(ops.tei, ops.disjL, ops.disjm1L, gidx, Pd)
    _close(a, b, TOL)


def test_erfc_plain_matches_element_pair_reference(bases):
    """K10's plain version against element-pair loops over the windows."""
    _, tb, _, ops = bases
    tei = torch.tensor(tb.host_erfc(0.5)["tei"])
    Pd = torch.tensor(_channel_densities(tb, 1, 13)[0])
    got = radial_erfc_exchange_plain(tei, ops.gidx, Pd).numpy()
    gidx, nrad = tb.rb.fem.gidx, tb.nrad
    for g in range(tei.shape[0]):
        for a in range(Pd.shape[0]):
            Wp = np.pad(Pd[a].numpy(), ((0, 1), (0, 1)))
            ref = np.zeros((nrad + 1, nrad + 1))
            for e in range(gidx.shape[0]):
                for f in range(gidx.shape[0]):
                    W = Wp[np.ix_(gidx[e], gidx[f])]
                    ref[np.ix_(gidx[e], gidx[f])] += np.einsum("ijkl,il->jk",
                                                               tei[g, e, f].numpy(), W)
            _close(got[g, a], ref[:nrad, :nrad], TOL)


# -------------------------------------------------------------------- lda_x_erf


def _erf_points(n=600, seed=3):
    rng = np.random.default_rng(seed)
    ra = 10 ** rng.uniform(-13, 3, n)
    rb = 10 ** rng.uniform(-13, 3, n)
    rb[:50] = 1e-30  # one spin far below the threshold
    return ra, rb


@pytest.mark.parametrize("omega", [0.11, 0.5, 5.0])
def test_lda_x_erf_matches_jax(omega):
    """Energy density and vrho of lda_x_erf at points on the direct branch,
    the large-a series (a > 8) and tiny densities. Where the closed form
    cancels, both packages carry its rounding: the bound there is 4 ulp of
    the cancelling terms, relative to the result."""
    ra, rb = _erf_points()
    z = np.zeros_like(ra)
    spec, jspec = (m.parse_method_rs(f"lda_x_erf[omega={omega}]") for m in (xc, jxc))
    got = xc.xc_eval(spec.funcs, *(torch.tensor(v) for v in (ra, rb, z, z, z)))
    ref = jxc.xc_eval(jspec.funcs, *(jnp.asarray(v) for v in (ra, rb, z, z, z)))

    def cancel(r):
        """The size of the closed form's cancelling terms over its result,
        for a spin density r (on the series branch: 0)."""
        kf = (3.0 * np.pi**2 * np.maximum(2.0 * r, 1e-30)) ** (1.0 / 3.0)
        a = np.maximum(omega / (2.0 * kf), 1e-10)
        f = np.asarray(jxc._sr_lda_factor(jnp.asarray(a)))
        size = 8.0 * a / 3.0 * (math.sqrt(math.pi) + np.abs(2 * a - 4 * a**3) + 3 * a + 4 * a**3)
        return np.where(a < 8.0, size / np.abs(f), 0.0)

    ka, kb = cancel(ra), cancel(rb)
    e, va, vb = (np.asarray(x) for x in got[:3])
    je, jva, jvb = (np.asarray(x) for x in ref[:3])
    for g, r, k in ((e, je, np.maximum(ka, kb)), (va, jva, ka), (vb, jvb, kb)):
        bound = np.maximum(TOL, 4 * EPS * k) * np.abs(r)
        assert np.all(np.abs(g - r) <= bound)
    # both branches and the cancelling band are covered
    kf = (3.0 * np.pi**2 * 2.0 * ra) ** (1.0 / 3.0)
    a = omega / (2.0 * kf)
    assert (a < 1.5).sum() > 20 and (a > 8.0).sum() > 20 and ((a > 1.5) & (a < 8)).sum() > 5


def test_sr_lda_factor_gradients_are_finite():
    """Under autograd the branch torch.where discards leaks no NaN or inf:
    finite values and gradients at a < 8, at a > 8 (up to 1e12: xc_eval's
    floor of 1e-30 on 2 rho bounds a below 2e9 omega) and near rho -> 0."""
    a = torch.tensor([1e-12, 1e-3, 0.5, 3.0, 7.999, 8.0, 8.001, 50.0, 1e8, 1e12],
                     dtype=torch.float64, requires_grad=True)
    f = xc._sr_lda_factor(a)
    (g,) = torch.autograd.grad(f.sum(), a)
    assert torch.isfinite(f).all() and torch.isfinite(g).all()
    ra = torch.tensor([1e-300, 1e-40, 1e-13, 1e-6, 0.3], dtype=torch.float64)
    spec = xc.parse_method_rs("LC-LDA")
    out = xc.xc_eval(spec.funcs, ra, ra, *(torch.zeros_like(ra),) * 3)
    assert all(torch.isfinite(x).all() for x in out)


# ---------------------------------------------------------------------- parsing


@pytest.mark.parametrize("method", [
    "LC-LDA", "ldaerf", "LCY-LDA", "SR-PBE0", "lc-lda[omega=0.4]", "lcy-lda[omega=0.7]",
    "sr-pbe0[omega=0]", "sr-pbe0[omega=0,kshort=0]", "lc-lda[omega=0.3,kfull=0.8,kshort=-0.6]",
    "lda_x_erf[omega=2],lda_c_pw"])
def test_parse_method_rs_matches_jax(method):
    got, ref = xc.parse_method_rs(method), jxc.parse_method_rs(method)
    assert [f.name for f in got.funcs] == [f.name for f in ref.funcs]
    assert [f.params for f in got.funcs] == [f.params for f in ref.funcs]
    assert (got.kfull, got.kshort, got.omega, got.kernel) == \
        (ref.kfull, ref.kshort, ref.omega, ref.kernel)


def test_parse_method_rs_rejects_unknown_overrides():
    for mod in (xc, jxc):
        with pytest.raises(ValueError, match="unknown method overrides"):
            mod.parse_method_rs("lc-lda[mu=0.3]")


def _raised(call):
    with pytest.raises(ValueError) as info:
        call()
    return str(info.value)


@pytest.mark.parametrize("method", ["LC-LDA", "sr-pbe0[omega=0.2]", "lcy-lda"])
def test_parse_method_raises_like_jax(method):
    assert _raised(lambda: xc.parse_method(method)) == \
        _raised(lambda: jxc.parse_method(method))


def test_diatomic_sad_and_gensap_raise_like_jax(tmp_path):
    """Range separation exists on atoms only: scf_diatomic, the SAD atom and
    gensap raise helfem_tpu's ValueError for it."""
    from helfem_tpu.cli.gensap import main as jax_gensap
    from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiatomic
    from helfem_tpu.models.sadatom import SadAtomBasis as JaxSad
    from helfem_tpu.models.sadatom import solve_sadatom as jax_solve_sadatom
    from helfem_tpu.scf.diatomic_scf import scf_diatomic as jax_scf_diatomic
    from helfem_tpu_torch.cli.gensap import main as gensap
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.models.sadatom import SadAtomBasis, solve_sadatom
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

    dia = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=5)
    got = _raised(lambda: scf_diatomic(DiatomicBasis(**dia), 1, 1, method="LC-LDA",
                                       device="cpu"))
    assert got == _raised(lambda: jax_scf_diatomic(JaxDiatomic(**dia), 1, 1, method="LC-LDA"))
    sad = dict(Z=2, lmax=0, rmax=20.0, nelem=3, nnodes=5)
    got = _raised(lambda: solve_sadatom(SadAtomBasis(**sad), method="SR-PBE0", device="cpu"))
    assert got == _raised(lambda: jax_solve_sadatom(JaxSad(**sad), method="SR-PBE0"))
    argv = ["--Z", "He", "--lmax", "0", "--nelem", "3", "--nnodes", "5", "--method", "LC-LDA",
            "--output", str(tmp_path / "result_He.dat")]
    assert _raised(lambda: gensap(argv + ["--device", "cpu"])) == \
        _raised(lambda: jax_gensap(argv))


# ------------------------------------------------------------------------- SCFs

SCF_CASES = {
    "be_lc_lda": (4, 2, 2, "lc-lda[omega=0.5]", {}),
    "be_lcy_lda": (4, 2, 2, "lcy-lda[omega=0.7]", {}),
    "be_sr_pbe0": (4, 2, 2, "SR-PBE0", {}),
    "li_uks_lc_lda": (3, 2, 1, "LC-LDA", {}),
    "li_rohf_lc_lda": (3, 2, 1, "LC-LDA", {"restricted": 1}),
}


@pytest.fixture(scope="module")
def jax_scfs():
    """helfem_tpu's scf_atom of each SCF case, solved once."""
    return {case: jax_scf_atom(jatomic.AtomicBasis(Z=Z, **BASIS), na, nb, method=m,
                               convthr=1e-9, maxit=60, **kw)
            for case, (Z, na, nb, m, kw) in SCF_CASES.items()}


@pytest.mark.parametrize("case", list(SCF_CASES))
def test_rs_scf_matches_jax(jax_scfs, case):
    Z, na, nb, method, kw = SCF_CASES[case]
    got = scf_atom(atomic.AtomicBasis(Z=Z, **BASIS), na, nb, method=method, convthr=1e-9,
                   maxit=60, device="cpu", **kw)
    ref = jax_scfs[case]
    assert got.converged and ref.converged
    assert abs(got.E - ref.E) < 1e-9
    assert abs(got.niter - ref.niter) <= 1
    for comp in ("Ekin", "Enuc", "Ecoul", "Exx", "Exc"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-8, comp
    assert got.Exx < -0.1 if "lda" in method.lower() else got.Exx < 0.0
    assert (got.orbE_b is None) == (ref.orbE_b is None)


def test_sr_pbe0_at_omega_zero_is_pbe0():
    """omega = 0 folds kshort into kfrac (no tables are built): the port's
    sr-pbe0[omega=0] is its PBE0."""
    basis = atomic.AtomicBasis(Z=4, **BASIS)
    a = scf_atom(basis, 2, 2, method="sr-pbe0[omega=0]", convthr=1e-9, device="cpu")
    b = scf_atom(basis, 2, 2, method="PBE0", convthr=1e-9, device="cpu")
    assert a.converged and abs(a.E - b.E) < 1e-10


def test_cli_prints_range_separation_and_energies(capsys, jax_scfs):
    res = main(["--Z", "Be", "--lmax", "0", "--mmax", "0", "--Rmax", "15", "--nelem", "5",
                "--nnodes", "8", "--method", "LC-LDA", "--iguess", "3", "--convthr", "1e-9",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Using range-separated exchange with omega = 0.500 (erfc kernel)" in out
    assert "Using 0.000 % short-range and 100.000 % long-range exchange." in out
    ref = jax_scfs["be_lc_lda"]
    assert res.converged and abs(res.E - ref.E) < 1e-9
    assert f"Total                 energy: {res.E: .16f}" in out
    assert "Exact exchange        energy:" in out
    assert res.walls["rs tables"] >= 0.0
