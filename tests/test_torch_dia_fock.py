"""The port's diatomic Fock pieces against helfem_tpu's on the same inputs
(float64 on the CPU, where the wrappers run the kernels' plain versions):
coulomb_dia with and without the M = 0 prefix, the grid fields, the XC
Fock with Exc and Nel for LDA, SVWN and PBE, the grid overlap, and xc_eval
on random grids; within 1e-12 x max-abs. The port is fed both its own
setup and helfem_tpu's arrays (from_jax_operators, from_jax_grid)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helfem_tpu.models import diatomic as jdia
from helfem_tpu.models import diatomic_dft as jdft
from helfem_tpu.ops import xc as jxc
from helfem_tpu.scf.diatomic_scf import _aufbau_blocks, density_dia, eig_blocks_dia
from helfem_tpu_torch.models import diatomic, diatomic_dft
from helfem_tpu_torch.ops import xc

TOL = 1e-12
CONFIGS = {
    "n2": (dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5), 7),
    "co": (dict(Z1=6, Z2=8, Rbond=2.132, lmax=(3, 3), rmax=15.0, nelem=3, nnodes=5), 7),
}


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def setup(request):
    cfg, nel = CONFIGS[request.param]
    jb = jdia.DiatomicBasis(**cfg)
    jops = jb.build_operators()
    jg = jdft.build_dia_grid(jb)
    tb = diatomic.DiatomicBasis(**cfg)
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()}
    grid_arrays = {k: np.asarray(v) for k, v in jg._asdict().items()}
    port = {
        "port_setup": (tb.build_operators("cpu"), diatomic_dft.build_dia_grid(tb, "cpu")),
        "from_jax": (diatomic.from_jax_operators(arrays, "cpu"),
                     diatomic_dft.from_jax_grid(grid_arrays, tb.nrad, "cpu")),
    }
    # core-guess densities with nel and nel - 1 electrons per spin: physical,
    # symmetry-block-diagonal, and different for the two spins
    E, C = eig_blocks_dia(jops, jops.H0)
    E = np.asarray(E)
    Pa, Pb = (np.asarray(density_dia(jops, C, jnp.asarray(_aufbau_blocks(E, n))))
              for n in (nel, nel - 1))
    return jb, jops, jg, port, Pa, Pb


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _random_density(jb, seed, block_diagonal):
    rng = np.random.default_rng(seed)
    if not block_diagonal:
        X = rng.standard_normal((jb.nbf, jb.nbf))
        return X + X.T
    P = np.zeros((jb.nbf, jb.nbf))
    for idx in jb.sym_blocks():
        X = rng.standard_normal((len(idx), len(idx)))
        P[np.ix_(idx, idx)] = X + X.T
    return P


@pytest.mark.parametrize("source", ["port_setup", "from_jax"])
@pytest.mark.parametrize("njbd", [True, False], ids=["m0_prefix", "all_channels"])
def test_coulomb_matches_jax(setup, source, njbd):
    jb, jops, _, port, _, _ = setup
    P = _random_density(jb, 5, block_diagonal=njbd)
    nj = jb.njbd if njbd else None
    ref = np.asarray(jdia.coulomb_dia(jops, jnp.asarray(P), nj))
    got = diatomic.coulomb_dia(port[source][0], torch.tensor(P), nj).numpy()
    _close(got, ref)


def test_coulomb_m0_prefix_is_exact_for_block_diagonal_density(setup):
    jb, _, _, port, _, _ = setup
    ops = port["port_setup"][0]
    P = torch.tensor(_random_density(jb, 6, block_diagonal=True))
    _close(diatomic.coulomb_dia(ops, P, jb.njbd), diatomic.coulomb_dia(ops, P, None))


def test_coulomb_element_sums_at_n2_bench():
    """The element sums of the diatomic Coulomb core at the N2 bench shapes,
    for a random symmetry-block-diagonal density, against exact sums
    (math.fsum) of the same f64 traces: the port's exclusive sums (what the
    kernel and its plain version form) are exact to rounding, while
    helfem_tpu's inclusive-sum-minus-self (diatomic.py:771-772) loses
    digits in sA, the sums over the inner elements, because the outermost
    element's trace is orders of magnitude larger."""
    import math

    from helfem_tpu_torch.kernels.radial_coulomb_dia import element_sums

    cfg = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8)
    tb_ = diatomic.DiatomicBasis(**cfg)
    ops = tb_.build_operators("cpu")
    nang, nrad, njbd = tb_.nang, tb_.nrad, tb_.njbd
    P4 = diatomic._to4(torch.tensor(_random_density(tb_, 11, block_diagonal=True)), nang, nrad)
    Paux = [torch.einsum("sab,abIJ->sIJ", G[:njbd], P4).numpy() for G in (ops.GmLM, ops.GpLM)]
    il = ops.LM_ilm[:njbd].numpy()
    gidx = ops.gidx.numpy()
    S, nelem = njbd, gidx.shape[0]
    ts, tb = np.zeros((S, nelem)), np.zeros((S, nelem))
    for e, g in enumerate(gidx):
        win = [np.pad(P, ((0, 0), (0, 1), (0, 1)))[:, g[:, None], g[None, :]] for P in Paux]
        d = [x.numpy()[il, e] for x in (ops.dP0, ops.dP2, ops.dQ0, ops.dQ2)]
        ts[:, e] = ((d[0] * win[0]).sum((1, 2)) - (d[1] * win[1]).sum((1, 2)))
        tb[:, e] = ((d[2] * win[0]).sum((1, 2)) - (d[3] * win[1]).sum((1, 2)))
    exact_A = np.array([[math.fsum(ts[s, :e]) for e in range(nelem)] for s in range(S)])
    exact_B = np.array([[math.fsum(tb[s, e + 1:]) for e in range(nelem)] for s in range(S)])
    sA, sB = (x.numpy() for x in element_sums(torch.tensor(ts), torch.tensor(tb)))
    jA = np.asarray(jnp.cumsum(ts, axis=1) - ts)
    jB = np.asarray(jnp.cumsum(tb[:, ::-1], axis=1)[:, ::-1] - tb)

    def rel(x, ref):
        return np.abs(x - ref).max() / np.abs(ref).max()

    assert np.abs(ts[:, -1]).max() > 1e6 * np.abs(ts[:, :-1]).max()
    assert rel(sA, exact_A) <= 1e-15 and rel(sB, exact_B) <= 1e-15
    # helfem_tpu's form is off by 1.5e-7 x max-abs in sA for this density
    assert rel(jA, exact_A) > 1e-8


def _jax_fields(jg, P, nang, nrad):
    P4 = P.reshape(nang, nrad, nang, nrad).transpose(0, 2, 1, 3)
    P4p = jnp.pad(jnp.asarray(P4), ((0, 0), (0, 0), (0, 1), (0, 1)))
    return jdft._fields_dia(jg, P4p)[:3]


@pytest.mark.parametrize("source", ["port_setup", "from_jax"])
def test_fields_match_jax(setup, source):
    jb, _, jg, port, Pa, _ = setup
    ref = _jax_fields(jg, Pa, jb.nang, jb.nrad)
    got = diatomic_dft._fields_dia(port[source][1], torch.tensor(Pa))
    for g_, r_ in zip(got, ref):
        _close(g_.numpy(), r_)


@pytest.mark.parametrize("method", ["LDA", "SVWN", "PBE"])
@pytest.mark.parametrize("source", ["port_setup", "from_jax"])
def test_xc_fock_matches_jax(setup, method, source):
    jb, jops, jg, port, Pa, Pb = setup
    ops, g = port[source]
    jfuncs, _ = jxc.parse_method(method)
    Fa_r, Fb_r, Exc_r, Nel_r = jdft.eval_fxc_dia(jfuncs, jg, jops, jnp.asarray(Pa),
                                                 jnp.asarray(Pb))
    funcs, _ = xc.parse_method(method)
    Fa, Fb, Exc, Nel = diatomic_dft.eval_fxc_dia(funcs, g, ops, torch.tensor(Pa),
                                                 torch.tensor(Pb))
    _close(Fa.numpy(), Fa_r)
    _close(Fb.numpy(), Fb_r)
    assert abs(float(Exc) - float(Exc_r)) <= TOL * abs(float(Exc_r))
    assert abs(float(Nel) - float(Nel_r)) <= TOL * abs(float(Nel_r))


def test_grid_overlap_matches_jax_and_operator(setup):
    jb, jops, jg, port, _, _ = setup
    ref = np.asarray(jdft.eval_overlap_dia(jg, jb.nang, jb.nrad))
    got = diatomic_dft.eval_overlap_dia(port["port_setup"][1], jb.nang, jb.nrad).numpy()
    _close(got, ref)
    # the grid integrates the basis products nearly exactly
    mv = jb.shell_mask().reshape(-1)
    S = np.asarray(jops.S)
    assert np.abs(got * mv[:, None] * mv[None, :] - S).max() < 1e-6 * np.abs(S).max()


def _random_grid(seed, n=4000):
    """Spin densities over 1e-16..10 (a quarter of the points below the
    1e-12 threshold) and consistent sigmas."""
    rng = np.random.default_rng(seed)
    ra = 10.0 ** rng.uniform(-16, 1, n)
    rb = 10.0 ** rng.uniform(-16, 1, n)
    ga = rng.standard_normal((n, 2)) * ra[:, None] ** (4 / 3)
    gb = rng.standard_normal((n, 2)) * rb[:, None] ** (4 / 3)
    return ra, rb, (ga * ga).sum(1), (ga * gb).sum(1), (gb * gb).sum(1)


@pytest.mark.parametrize("method", ["PBE", "SVWN", "revPBE", "gga_x_pbe,lda_c_pw"])
def test_xc_eval_matches_jax_on_random_grid(method):
    args = _random_grid(17)
    ref = [np.asarray(x) for x in
           jxc.xc_eval(jxc.parse_method(method)[0], *(jnp.asarray(a) for a in args))]
    got = [x.numpy() for x in
           xc.xc_eval(xc.parse_method(method)[0], *(torch.tensor(a) for a in args))]
    below = (args[0] + args[1]) <= 1e-12
    assert below.sum() > 100
    for g_, r_ in zip(got, ref):
        assert np.isfinite(g_).all()
        assert (g_[below] == 0.0).all()
        # relative to the array's max-abs: per point, the potentials of a spin
        # density near the floor are differences of large terms, where the two
        # autodiff orders part after ~1e-11
        assert np.abs(g_ - r_).max() <= TOL * np.abs(r_).max()


def test_xc_eval_potentials_finite_at_tiny_spin_density():
    """One spin far below thr at live points: the floors keep every
    potential finite (no NaN from an untaken branch)."""
    n = 64
    ra = torch.full((n,), 0.3, dtype=torch.float64)
    rb = torch.full((n,), 1e-30, dtype=torch.float64)
    saa = torch.full((n,), 0.05, dtype=torch.float64)
    zero = torch.zeros(n, dtype=torch.float64)
    out = xc.xc_eval(xc.parse_method("PBE")[0], ra, rb, saa, zero, zero)
    assert all(torch.isfinite(x).all() for x in out)


@pytest.mark.parametrize("method, item", [
    ("mgga_x_br89,gga_c_pbe", 6), ("LDAERF", 7), ("mgga_x_br89", 6), ("SR-PBE0", 7),
    ("LC-LDA", 7), ("lcy-lda", 7), ("lda_x_erf,lda_c_pw", 7),
], ids=["br89_pair", "ldaerf", "br89", "sr_pbe0", "lc_lda", "lcy_lda", "lda_x_erf_pair"])
def test_unported_methods_raise(method, item):
    """The laplacian-level BR89 (ROADMAP queue 1 item 6), the
    range-separated methods and lda_x_erf (item 7) are ported: they parse
    as helfem_tpu parses them (BR89 as family mggal), and parse_method,
    which has no short-range exchange to wire, raises helfem_tpu's
    ValueError for a range-separated one."""
    if item == 6:
        got, ref = xc.parse_method(method), jxc.parse_method(method)
        assert [(f.name, f.family) for f in got[0]] == [(f.name, f.family) for f in ref[0]]
        assert got[0][0].family == "mggal" and got[1] == ref[1] == 0.0
        return
    got, ref = xc.parse_method_rs(method), jxc.parse_method_rs(method)
    assert [f.name for f in got.funcs] == [f.name for f in ref.funcs]
    assert (got.kfull, got.kshort, got.omega, got.kernel) == \
        (ref.kfull, ref.kshort, ref.omega, ref.kernel)
    if ref.kshort or ref.omega:
        with pytest.raises(ValueError) as ours:
            xc.parse_method(method)
        with pytest.raises(ValueError) as theirs:
            jxc.parse_method(method)
        assert str(ours.value) == str(theirs.value)


def test_ported_methods_parse_like_jax():
    for method in ["HF", "LDA", "SVWN", "SVWN5", "PBE", "revPBE", "PBEsol", "PBE0", "PBEh",
                   "lda_x,lda_c_vwn", "gga_x_pbe-gga_c_pbe", "gga_x_pbe[kappa=1.0],gga_c_pbe",
                   "RPBE", "BLYP", "TPSS", "SCAN", "rSCAN", "TPSSh", "B3LYP5",
                   "gga_x_b88,gga_c_lyp", "mgga_x_tpss-mgga_c_tpss", "mgga_x_scan,mgga_c_scan",
                   "mgga_x_rscan[k1=0.07],mgga_c_rscan", "gga_x_b88[beta=0.005],gga_c_lyp",
                   "gga_x_rpbe[kappa=1.0],gga_c_pbe"]:
        got, ref = xc.parse_method_rs(method), jxc.parse_method_rs(method)
        assert [f.name for f in got.funcs] == [f.name for f in ref.funcs]
        assert (got.kfull, got.kshort) == (ref.kfull, ref.kshort)
