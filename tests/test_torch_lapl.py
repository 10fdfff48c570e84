"""Port's laplacian-level meta-GGA (BR89, family mggal) and the SCF
convergence controls (the diatomic level shift, Fock damping, diisthr)
against helfem_tpu on the CPU, and the laplacian's identities on the port
alone.

Tolerances: BR89's pointwise energy and potentials within 1e-12 relative
of helfem_tpu's xc_eval (the x solve within 1e-13); the density laplacian
and the XC Fock within 1e-12 x max-abs of helfem_tpu's _density_fields,
_fields_dia, eval_fxc and eval_fxc_dia, Exc within 1e-12 relative;
converged SCF energies within 1e-9 Eh in helfem_tpu's iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models import atomic_dft as jdft
from helfem_tpu.models import diatomic_dft as jddft
from helfem_tpu.models import sadatom as jsad
from helfem_tpu.models.atomic import AtomicBasis as JaxAtomicBasis
from helfem_tpu.models.atomic import _pad_rad, _to4
from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiatomicBasis
from helfem_tpu.ops import xc as jxc
from helfem_tpu.scf import atomic_scf as jax_atomic_scf
from helfem_tpu.scf import diatomic_scf as jax_diatomic_scf
from helfem_tpu_torch.cli import atomic as atomic_cli
from helfem_tpu_torch.cli import diatomic as diatomic_cli
from helfem_tpu_torch.cli import gensap as gensap_cli
from helfem_tpu_torch.models import atomic_dft, diatomic_dft, sadatom
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.ops import xc
from helfem_tpu_torch.scf import atomic_scf, diatomic_scf
from helfem_tpu_torch.utils.linalg import build_blocks, density_blocks

TOL = 1e-12
BR89 = "mgga_x_br89"
C_ATOM = dict(Z=6, lmax=2, mmax=1, rmax=30.0, nelem=3, nnodes=6)
CO = dict(Z1=6, Z2=8, Rbond=2.132, lmax=(4, 3), rmax=15.0, nelem=3, nnodes=6)
HE = dict(Z=2, lmax=0, mmax=0, rmax=25.0, nelem=8, nnodes=10)
LI = dict(Z=3, lmax=0, mmax=0, rmax=25.0, nelem=5, nnodes=8)
H2 = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(2,), rmax=10.0, nelem=2, nnodes=6)
H2P = dict(Z1=1, Z2=1, Rbond=2.0, lmax=(8,), rmax=20.0, nelem=4, nnodes=12)
# label -> (atomic or diatomic, basis, nela, nelb, keywords of both scf drivers)
SCF_CASES = {
    "he": ("atomic", HE, 1, 1, dict(method=BR89, convthr=1e-6, maxit=160)),
    "he_dampfock": ("atomic", HE, 1, 1, dict(method=BR89, convthr=1e-6, maxit=160,
                                              dampfock=0.5, dampthr=0.1)),
    "li_uks_diisthr": ("atomic", LI, 2, 1, dict(method=BR89, convthr=1e-8, diiseps=5.0,
                                                 diisthr=0.01)),
    "h2": ("diatomic", H2, 1, 1, dict(method=BR89, convthr=1e-8, maxit=100)),
    "h2_shift_diisthr": ("diatomic", H2, 1, 1, dict(method=BR89, convthr=1e-8, maxit=100,
                                                     shift=1.0, diiseps=5.0, diisthr=0.01)),
}


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


# ---------------------------------------------------------------------------
# the functional, pointwise
# ---------------------------------------------------------------------------


def _points(branch: str, n: int = 400):
    """(ra, rb, saa, sab, sbb, ta, tb, la, lb) in the well-conditioned
    regimes of BR89's solve: y < 0 (the laplacian below 2 gamma D), y > 0
    (well above it), and near helfem_tpu's floors (|Q| near 1e-15, |y| near
    1e-30, one spin near the density threshold)."""
    rng = np.random.default_rng({"negative_y": 1, "positive_y": 2, "floors": 3}[branch])
    ra, rb = 10 ** rng.uniform(-4, 2, n), 10 ** rng.uniform(-4, 2, n)
    saa = rng.uniform(0.0, 3.0, n) ** 2 * ra ** (8 / 3)
    sbb = rng.uniform(0.0, 3.0, n) ** 2 * rb ** (8 / 3)
    sab = np.sqrt(saa * sbb) * rng.uniform(-1.0, 1.0, n)
    ta = saa / (8 * ra) + rng.uniform(0.0, 3.0, n) * ra ** (5 / 3)
    tb = sbb / (8 * rb) + rng.uniform(0.0, 3.0, n) * rb ** (5 / 3)
    D = lambda r, s, t: 2.0 * t - 0.25 * s / r  # noqa: E731
    if branch == "negative_y":
        la = rng.standard_normal(n) * ra ** (5 / 3)
        lb = rng.standard_normal(n) * rb ** (5 / 3)
    elif branch == "positive_y":
        la = 1.6 * D(ra, saa, ta) + rng.uniform(0.5, 20.0, n) * ra ** (5 / 3)
        lb = 1.6 * D(rb, sbb, tb) + rng.uniform(0.5, 20.0, n) * rb ** (5 / 3)
    else:
        # |Q| at and around the 1e-15 floor, and a few |y| below 1e-30
        la = 1.6 * D(ra, saa, ta) + rng.choice([0.0, 1e-16, -4e-15, 6e-15], n) * 6.0
        lb = 1.6 * D(rb, sbb, tb) + rng.uniform(0.5, 20.0, n) * rb ** (5 / 3)
        rb[: n // 4] = 2e-12  # one spin just above the threshold
        la[-10:] = 1e40
    return ra, rb, saa, sab, sbb, ta, tb, la, lb


@pytest.mark.parametrize("branch", ["negative_y", "positive_y", "floors"])
def test_br89_pointwise_matches_jax(branch):
    """e, vrho, vsigma, vtau and vlapl of BR89 within 1e-12 relative of
    helfem_tpu's xc_eval, alone and, away from the floors (where LYP's own
    terms at a spin density near the threshold are ill-conditioned),
    mixed with LYP (la, lb given with a GGA in the list); without ta, tb
    the tau slots are dropped."""
    args = _points(branch)
    for method in (BR89,) if branch == "floors" else (BR89, f"{BR89},gga_c_lyp"):
        ref = jxc.xc_eval(jxc.parse_method(method)[0], *map(jnp.asarray, args[:5]), 1e-12,
                          ta=jnp.asarray(args[5]), tb=jnp.asarray(args[6]),
                          la=jnp.asarray(args[7]), lb=jnp.asarray(args[8]))
        got = xc.xc_eval(xc.parse_method(method)[0], *map(torch.tensor, args[:5]), 1e-12,
                         *map(torch.tensor, args[5:]))
        assert len(got) == len(ref) == 10
        for k, (g, r) in enumerate(zip(got, ref)):
            g, r = g.numpy(), np.asarray(r)
            assert np.isfinite(g).all(), (method, k)
            err = np.abs(g - r) <= TOL * np.maximum(np.abs(r), 1e-300)
            assert err.all(), (method, k, np.abs(g - r).max())
    lap = xc.xc_eval(xc.parse_method("PBE")[0], *map(torch.tensor, args[:5]), 1e-12,
                     la=torch.tensor(args[7]), lb=torch.tensor(args[8]))
    assert len(lap) == 8 and not lap[6].any()


def test_br89_solve_x_matches_jax():
    """The inverse of y = x exp(-2x/3)/(x - 2) on both branches, from the
    floors to |y| ~ 1e30, within 1e-13 relative of helfem_tpu's."""
    y = np.concatenate([-np.logspace(-30, 30, 300), np.logspace(-30, 30, 300), [1e-31, -1e-40]])
    got = xc._br89_solve_x(torch.tensor(y)).numpy()
    ref = np.asarray(jxc._br89_solve_x(jnp.asarray(y)))
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert (np.abs(got - ref) <= 1e-13 * np.abs(ref)).all()


# ---------------------------------------------------------------------------
# the laplacian fields and the XC Fock on both grids
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def atom():
    """C at lmax=2, mmax=1: helfem_tpu's grid and the port's with its
    laplacian tables, and two random m-block-diagonal densities."""
    jb, tb = JaxAtomicBasis(**C_ATOM), AtomicBasis(**C_ATOM)
    rng = np.random.default_rng(7)
    same_m = (tb.mval[:, None] == tb.mval[None, :]).astype(float)
    Ps = []
    for _ in range(2):
        X = rng.standard_normal((tb.nang, tb.nrad, 2))
        P = np.einsum("aik,bjk->aibj", X, X) * 0.1 * same_m[:, None, :, None]
        Ps.append(P.reshape(tb.nbf, tb.nbf))
    return jb, tb, jdft.build_dft_grid(jb), atomic_dft.build_atomic_grid(tb, "cpu", lapl=True), Ps


@pytest.fixture(scope="module")
def molecule():
    """CO at lmax (4, 3): helfem_tpu's grid and operators, the port's grid
    with its laplacian tables, and two random symmetry-block densities."""
    jb, tb = JaxDiatomicBasis(**CO), DiatomicBasis(**CO)
    rng = np.random.default_rng(9)
    m = tb.shell_mask().reshape(-1)
    Ps = []
    for _ in range(2):
        P = np.zeros((tb.nbf, tb.nbf))
        for idx in tb.sym_blocks():
            X = rng.standard_normal((len(idx), 2)) * 0.3
            P[np.ix_(idx, idx)] = X @ X.T
        Ps.append(P * np.outer(m, m))
    return (jb, tb, jddft.build_dia_grid(jb), jb.build_operators(),
            diatomic_dft.build_dia_grid(tb, "cpu", lapl=True), tb.build_operators("cpu"), Ps)


def test_lapl_grid_tables_match_jax(atom, molecule):
    """The laplacian tables of the port's hosts are helfem_tpu's bit for bit
    (atomic d2bg, LTT; diatomic d2Bg, coth, inv_sh2, LLTT, TTmm); a grid
    built without them carries none, and refuses the laplacian."""
    jb, tb, jg, g, _ = atom
    tables = atomic_dft.atomic_grid_tables(tb, lapl=True)
    for name in ("d2bg", "LTT"):
        assert np.array_equal(tables[name], np.asarray(getattr(jg, name))), name
    jmb, tmb, jmg, *_ = molecule
    tables = diatomic_dft.dia_grid_tables(tmb, lapl=True)
    for name in ("d2Bg", "coth", "inv_sh2", "LLTT", "TTmm"):
        assert np.array_equal(tables[name], np.asarray(getattr(jmg, name))), name
    plain = atomic_dft.build_atomic_grid(tb, "cpu")
    assert plain.lfac is None and plain.d2Bg is None and g.lfac.shape == (4, *g.w.shape)
    P = torch.zeros(tb.nbf, tb.nbf, dtype=torch.float64)
    with pytest.raises(ValueError, match="lapl=True"):
        atomic_dft.dia_xc_fields(P[None], plain, True, True)


@pytest.mark.parametrize("ns", [1, 2])
def test_atomic_lapl_fields_match_jax(atom, ns):
    """K4's laplacian mode (plain) against helfem_tpu's _density_fields: the
    five fields of one or two spins in one call, 1e-12 x max-abs."""
    jb, tb, jg, g, Ps = atom
    got = atomic_dft.dia_xc_fields(torch.tensor(np.stack(Ps[:ns])), g, True, True)
    assert len(got) == 5
    for s in range(ns):
        P4 = _pad_rad(_to4(jnp.asarray(Ps[s]), tb.nang, tb.nrad))
        rho, dr, dth, tau, lap = jdft._density_fields(jg, P4, True, True)
        r = g.r[:, :, None].numpy()
        for x, ref in zip((got[0][s], got[1][s], got[2][s] / r, got[3][s], got[4][s]),
                          (rho, dr, dth, tau, lap)):
            _close(x.numpy(), ref)


@pytest.mark.parametrize("ns", [1, 2])
def test_diatomic_lapl_fields_match_jax(molecule, ns):
    """K4's laplacian mode (plain) against helfem_tpu's _fields_dia."""
    jb, tb, jg, _, g, _, Ps = molecule
    got = diatomic_dft.dia_xc_fields(torch.tensor(np.stack(Ps[:ns])), g, True, True)
    for s in range(ns):
        P4 = Ps[s].reshape(tb.nang, tb.nrad, tb.nang, tb.nrad).transpose(0, 2, 1, 3)
        ref = jddft._fields_dia(jg, jnp.pad(jnp.asarray(P4), ((0, 0), (0, 0), (0, 1), (0, 1))),
                                True, True)
        for x, r in zip(got, ref):
            _close(x[s].numpy(), r)


@pytest.mark.parametrize("method", [BR89, f"{BR89},gga_c_lyp"])
@pytest.mark.parametrize("spins", ["restricted", "unrestricted"])
def test_atomic_xc_fock_matches_jax(atom, method, spins):
    """eval_fxc of BR89 and of a BR89-LYP pair (K4/K5 in laplacian mode,
    plain) against helfem_tpu's eval_fxc: Fock 1e-12 x max-abs, Exc and Nel
    1e-12 relative."""
    jb, tb, jg, g, Ps = atom
    Pa, Pb = Ps[0], Ps[0] if spins == "restricted" else Ps[1]
    ref = jdft.eval_fxc(jxc.parse_method(method)[0], jg, jnp.asarray(Pa), jnp.asarray(Pb),
                        tb.nrad)
    ta = torch.tensor(Pa)
    got = atomic_dft.eval_fxc(tuple(xc.parse_method(method)[0]), g, ta,
                              ta if spins == "restricted" else torch.tensor(Pb))
    _close(got[0].numpy(), ref[0])
    _close(got[1].numpy(), ref[1])
    for x, r in zip(got[2:], ref[2:]):
        assert abs(float(x) - float(r)) <= TOL * abs(float(r))


@pytest.mark.parametrize("method", [BR89, f"{BR89},gga_c_lyp"])
def test_diatomic_xc_fock_matches_jax(molecule, method):
    """eval_fxc_dia of BR89 and of a BR89-LYP pair against helfem_tpu's
    eval_fxc_dia, two spins, shell mask included."""
    jb, tb, jg, jops, g, ops, Ps = molecule
    ref = jddft.eval_fxc_dia(jxc.parse_method(method)[0], jg, jops, jnp.asarray(Ps[0]),
                             jnp.asarray(Ps[1]))
    got = diatomic_dft.eval_fxc_dia(tuple(xc.parse_method(method)[0]), g, ops,
                                    torch.tensor(Ps[0]), torch.tensor(Ps[1]))
    _close(got[0].numpy(), ref[0])
    _close(got[1].numpy(), ref[1])
    for x, r in zip(got[2:], ref[2:]):
        assert abs(float(x) - float(r)) <= TOL * abs(float(r))


# ---------------------------------------------------------------------------
# identities on the port alone
# ---------------------------------------------------------------------------


def _atomic_density(basis, ops, res):
    blk = torch.as_tensor(build_blocks(ops.S.numpy(), basis.sym_blocks(2))[0])
    return density_blocks(torch.as_tensor(res.orbs_a), torch.as_tensor(res.occ_a), blk, ops.S)


def test_atomic_lapl_integrals():
    """On a converged He density (smooth across the elements): int lapl rho
    = 0 and int r^2 lapl rho = 6 N (tests/test_lapl.py's identities)."""
    b = AtomicBasis(Z=2, lmax=1, mmax=1, rmax=25.0, nelem=10, nnodes=14)
    ops = b.build_operators("cpu")
    res = atomic_scf.scf_atom(b, 1, 1, convthr=1e-10, ops=ops)
    g = atomic_dft.build_atomic_grid(b, "cpu", lapl=True)
    rho, *_, lap = (f[0] for f in atomic_dft.dia_xc_fields(
        _atomic_density(b, ops, res).contiguous()[None], g, True, True))
    r = g.r[:, :, None]
    N = float(torch.sum(g.w * rho))
    assert abs(N - 1.0) < 1e-10
    assert abs(float(torch.sum(g.w * lap))) < 1e-7
    assert abs(float(torch.sum(g.w * r**2 * lap)) - 6.0 * N) < 1e-7


def _directional(E, P, D, F, eps=1e-5):
    dE_num = (E(P + eps * D) - E(P - eps * D)) / (2 * eps)
    dE_an = float(torch.sum(D * F))
    assert abs(dE_num - dE_an) < 1e-6 * max(abs(dE_num), 1.0), (dE_num, dE_an)


def test_atomic_br89_fock_is_energy_derivative():
    """Tr(D (Fa + Fb)) equals the directional derivative of BR89's Exc
    (every laplacian Fock term at once), He at lmax=1."""
    b = AtomicBasis(Z=2, lmax=1, mmax=1, rmax=20.0, nelem=6, nnodes=8)
    g = atomic_dft.build_atomic_grid(b, "cpu", lapl=True)
    funcs = tuple(xc.parse_method(BR89)[0])
    rng = np.random.default_rng(1)
    X = rng.standard_normal((b.nbf, 4)) * 0.3
    P = torch.tensor(X @ X.T + 0.1 * np.eye(b.nbf))
    D = rng.standard_normal((b.nbf, b.nbf)) * 0.01
    D = torch.tensor(D + D.T)
    Fa, Fb, _, _ = atomic_dft.eval_fxc(funcs, g, P, P.clone())
    _directional(lambda Pm: float(atomic_dft.eval_fxc(funcs, g, Pm, Pm.clone())[2]), P, D,
                 Fa + Fb)


def test_hydrogen_br89_is_exact():
    """BR89 is exact for a hydrogenic density: Exc on the converged H
    density is -5/16 within 1e-7."""
    b = AtomicBasis(Z=1, lmax=0, mmax=0, rmax=30.0, nelem=8, nnodes=12)
    ops = b.build_operators("cpu")
    res = atomic_scf.scf_atom(b, 1, 0, convthr=1e-10, ops=ops)
    Pa = density_blocks(torch.as_tensor(res.orbs_a), torch.as_tensor(res.occ_a),
                        torch.arange(b.nrad, dtype=torch.int32)[None], ops.S)
    g = atomic_dft.build_atomic_grid(b, "cpu", lapl=True)
    _, _, Exc, Nel = atomic_dft.eval_fxc(tuple(xc.parse_method(BR89)[0]), g, Pa,
                                         torch.zeros_like(Pa))
    assert abs(float(Nel) - 1.0) < 1e-9
    assert abs(float(Exc) + 0.3125) < 1e-7


@pytest.fixture(scope="module")
def h2_cation():
    """H2+ (one electron) converged at lmax=6, its density and its grid with
    the laplacian tables."""
    b = DiatomicBasis(**H2P)
    ops = b.build_operators("cpu")
    res = diatomic_scf.scf_diatomic(b, 1, 0, convthr=1e-10, ops=ops)
    Pa = density_blocks(torch.as_tensor(res.orbs_a), torch.as_tensor(res.occ_a), ops.blk_idx,
                        ops.S)
    return b, ops, diatomic_dft.build_dia_grid(b, "cpu", lapl=True), Pa


def test_h2_cation_lapl_green_identity(h2_cation):
    """tests/test_diatomic_fields.py:196 on H2+ (its basis form): int rho
    lapl rho = -int |grad rho|^2 on the prolate grid."""
    b, ops, g, Pa = h2_cation
    rho, u, v, _, lap = diatomic_dft._fields_dia(g, Pa, True, True)
    assert abs(float(torch.sum(g.w * rho)) - 1.0) < 1e-8
    lhs = float(torch.sum(g.w * rho * lap))
    rhs = -float(torch.sum(g.w * (u * u + v * v)))
    assert abs(lhs - rhs) < 5e-4 * abs(rhs)


def test_h2_cation_br89_fock_is_energy_derivative(h2_cation):
    """tests/test_diatomic_fields.py:222 on H2+'s basis: Tr(D (Fa + Fb))
    equals the directional derivative of BR89's Exc on the prolate grid."""
    b, ops, g, _ = h2_cation
    funcs = tuple(xc.parse_method(BR89)[0])
    rng = np.random.default_rng(0)
    m2 = b.shell_mask().reshape(-1)
    X = rng.standard_normal((b.nbf, b.nbf)) * 0.05
    P = torch.tensor((X @ X.T + 0.05 * np.eye(b.nbf)) * np.outer(m2, m2))
    D = rng.standard_normal((b.nbf, b.nbf)) * 0.01
    D = torch.tensor((D + D.T) * np.outer(m2, m2))
    Fa, Fb, _, _ = diatomic_dft.eval_fxc_dia(funcs, g, ops, P, P.clone())
    _directional(lambda Pm: float(diatomic_dft.eval_fxc_dia(funcs, g, ops, Pm, Pm.clone())[2]),
                 P, D, Fa + Fb)


# ---------------------------------------------------------------------------
# SCFs and the convergence controls against helfem_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solved():
    """Each case solved once by each side."""
    out = {}

    def get(label):
        if label not in out:
            kind, cfg, na, nb, kw = SCF_CASES[label]
            if kind == "atomic":
                ref = jax_atomic_scf.scf_atom(JaxAtomicBasis(**cfg), na, nb, **kw)
                got = atomic_scf.scf_atom(AtomicBasis(**cfg), na, nb, device="cpu", **kw)
            else:
                ref = jax_diatomic_scf.scf_diatomic(JaxDiatomicBasis(**cfg), na, nb, **kw)
                got = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), na, nb, device="cpu",
                                                **kw)
            out[label] = ref, got
        return out[label]

    return get


@pytest.mark.parametrize("label", list(SCF_CASES))
def test_scf_matches_jax(solved, label):
    """He BR89 (exchange only), He with Fock damping, the two-spin Li with
    the sliding DIIS/ADIIS blend, H2 BR89, and H2 with the level shift and
    the blend on the host loop: within 1e-9 Eh of helfem_tpu's, in its
    iteration count."""
    ref, got = solved(label)
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert got.niter == ref.niter


def test_controls_change_the_path(solved):
    """The controls are live: damping, and the shift with the blend, each
    change the port's iteration count, as they change helfem_tpu's."""
    for plain, ctrl in (("he", "he_dampfock"), ("h2", "h2_shift_diisthr")):
        (ra, a), (rb, b) = solved(plain), solved(ctrl)
        assert a.niter != b.niter and ra.niter != rb.niter, (plain, ctrl)


def test_sad_diisthr_matches_jax():
    """The SAD solver takes diisthr (inert there, as in helfem_tpu: its blend
    needs the ADIIS weights the SAD solvers switch off): He SVWN with it
    equals helfem_tpu's."""
    cfg = dict(Z=2, lmax=0, nelem=5, nnodes=8)
    ref = jsad.solve_sadatom(jsad.SadAtomBasis(**cfg), method="SVWN", search=False,
                             diisthr=0.01)
    got = sadatom.solve_sadatom(sadatom.SadAtomBasis(**cfg), method="SVWN", search=False,
                                diisthr=0.01, device="cpu")
    assert got.converged and abs(got.E - ref.E) < 1e-9


def test_sad_and_gensap_refuse_br89(tmp_path):
    """helfem_tpu's SAD atom has no laplacian path: the SAD solvers and
    gensap raise SadLaplacianError, a ValueError, and no message of the port
    calls BR89 unported."""
    basis = sadatom.SadAtomBasis(Z=2, lmax=0, nelem=3, nnodes=5)
    for call in (lambda: sadatom.solve_sadatom(basis, method=BR89, device="cpu"),
                 lambda: gensap_cli.main(["--Z", "He", "--lmax", "0", "--method",
                                          f"{BR89},gga_c_lyp", "--device", "cpu",
                                          "--output", str(tmp_path / "r.dat")])):
        with pytest.raises(sadatom.SadLaplacianError) as err:
            call()
        assert isinstance(err.value, ValueError) and "not ported" not in str(err.value)


def test_clis_run_br89_and_the_controls_on_cpu(solved, tmp_path, capsys):
    """The atomic CLI with BR89, --dampfock/--dampthr and --diisthr (inert
    for a restricted atom, whose host DIIS has no density history), the
    diatomic CLI with a BR89-LYP pair and --diisthr, gensap with --diisthr:
    each runs on the CPU, the atomic one as scf_atom does."""
    he = ["--Z", "He", "--lmax", "0", "--mmax", "0", "--Rmax", "25", "--nelem", "8",
          "--nnodes", "10", "--iguess", "3", "--maxit", "160", "--convthr", "1e-6",
          "--method", BR89, "--device", "cpu"]
    res = atomic_cli.main(he + ["--dampfock", "0.5", "--dampthr", "0.1", "--diisthr", "0.01"])
    ref = solved("he_dampfock")[1]
    assert res.converged and abs(res.E - ref.E) < 1e-12 and res.niter == ref.niter
    assert "damping off-diagonal Fock elements by 0.500" in capsys.readouterr().out
    res = diatomic_cli.main(["--Z1", "H", "--Z2", "H", "--Rbond", "1.4", "--lmax", "2",
                             "--Rmax", "10", "--nelem", "2", "--nnodes", "6", "--convthr", "1e-8",
                             "--maxit", "100", "--method", f"{BR89},gga_c_lyp", "--diisthr",
                             "0.01", "--device", "cpu"])
    assert res.converged and -1.3 < res.E < -1.1
    res = gensap_cli.main(["--Z", "He", "--lmax", "0", "--nelem", "5", "--nnodes", "8",
                           "--method", "SVWN", "--nosearch", "--diisthr", "0.01", "--device",
                           "cpu", "--output", str(tmp_path / "result_He.dat")])
    assert res.converged and (tmp_path / "result_He.dat").exists()
