"""The port's diatomic exchange against helfem_tpu's on the same inputs
(float64 on the CPU, where the wrappers run the kernels' plain versions):
exchange_dia_occ (with a sign vector and with zero-padded columns) and
exchange_dia within 1e-12 x max-abs on a HeH and a CO basis, the port's own
occ-equals-dense identity, K = K^T at high angular momentum, the exchange
step tables, and the cross-element sums at the N2 bench tables against exact
sums. The port is fed both its own setup and helfem_tpu's arrays
(from_jax_operators)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helfem_tpu.models import diatomic as jdia
from helfem_tpu_torch import kernels
from helfem_tpu_torch.models import diatomic

TOL = 1e-12
CONFIGS = {
    # the HeH basis of helfem_tpu's own occ-factorisation test, and a small
    # CO basis, where the odd-L channels are live
    "heh": dict(Z1=2, Z2=1, Rbond=1.5, lmax=(3, 3), rmax=15.0, nelem=3, nnodes=6),
    "co": dict(Z1=6, Z2=8, Rbond=2.132, lmax=(3, 2), rmax=15.0, nelem=3, nnodes=5),
}
NO = 5


@pytest.fixture(scope="module", params=list(CONFIGS), ids=list(CONFIGS))
def setup(request):
    cfg = CONFIGS[request.param]
    jb = jdia.DiatomicBasis(**cfg)
    jops = jb.build_operators()
    tb = diatomic.DiatomicBasis(**cfg)
    arrays = {k: np.asarray(v) for k, v in jops._asdict().items()}
    port = {"port_setup": tb.build_operators("cpu"),
            "from_jax": diatomic.from_jax_operators(arrays, "cpu")}
    rng = np.random.default_rng(0)
    m2 = np.asarray(jops.shellmask).reshape(-1)
    Co = rng.standard_normal((jb.nbf, NO)) * 0.3 * m2[:, None]
    sgn = np.where(rng.standard_normal(NO) > 0, 1.0, -1.0)
    sgn[0], sgn[1] = 1.0, -1.0  # both signs present
    return jb, jops, arrays, port, Co, sgn


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("field", ["step_ilm", "step_sp", "step_sm", "step_wm"])
def test_step_tables_match_jax(setup, field):
    _, _, arrays, port, _, _ = setup
    for ops in port.values():
        assert np.array_equal(getattr(ops, field).numpy(), arrays[field])


@pytest.mark.parametrize("source", ["port_setup", "from_jax"])
@pytest.mark.parametrize("variant", ["plain", "signed", "padded"])
def test_exchange_occ_matches_jax(setup, source, variant):
    _, jops, _, port, Co, sgn = setup
    if variant == "padded":  # zero columns are exact no-ops
        Co = np.pad(Co, ((0, 0), (0, 3)))
    s = sgn if variant == "signed" else None
    ref = jdia.exchange_dia_occ(jops, jnp.asarray(Co), None if s is None else jnp.asarray(s))
    got = diatomic.exchange_dia_occ(port[source], torch.tensor(Co),
                                    None if s is None else torch.tensor(s))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("source", ["port_setup", "from_jax"])
@pytest.mark.parametrize("signed", [False, True], ids=["psd", "indefinite"])
def test_exchange_dense_matches_jax(setup, source, signed):
    _, jops, _, port, Co, sgn = setup
    P = (Co * sgn) @ Co.T if signed else Co @ Co.T
    ref = jdia.exchange_dia(jops, jnp.asarray(P))
    got = diatomic.exchange_dia(port[source], torch.tensor(P))
    _close(got.numpy(), ref)


def test_exchange_occ_equals_dense(setup):
    """The port's own identity: the rank-factorised build is the dense one
    of P = Co diag(sgn) Co^T, and padded zero columns change nothing."""
    _, _, _, port, Co, sgn = setup
    ops = port["port_setup"]
    Co_t, sgn_t = torch.tensor(Co), torch.tensor(sgn)
    K_occ = diatomic.exchange_dia_occ(ops, Co_t)
    _close(K_occ, diatomic.exchange_dia(ops, Co_t @ Co_t.T))
    _close(diatomic.exchange_dia_occ(ops, Co_t, sgn_t),
           diatomic.exchange_dia(ops, (Co_t * sgn_t) @ Co_t.T))
    padded = diatomic.exchange_dia_occ(ops, torch.nn.functional.pad(Co_t, (0, 3)))
    _close(padded, K_occ, 1e-13)


def test_exchange_dense_batches_agree(setup, monkeypatch):
    """exchange_dia in batches of one channel equals the single batch."""
    _, _, _, port, Co, _ = setup
    ops = port["port_setup"]
    P = torch.tensor(Co @ Co.T)
    whole = diatomic.exchange_dia(ops, P)
    monkeypatch.setattr(diatomic, "_R_BATCH_BYTES", 1)
    _close(diatomic.exchange_dia(ops, P), whole, 1e-14)


def test_exchange_dia_symmetry_high_L():
    """K(P) and K from a factorisation are symmetric to rounding at lmax
    (8,8), where the P_L/Q_L moment tables span many orders of magnitude
    (helfem_tpu's canary of the same name, on the port)."""
    b = diatomic.DiatomicBasis(Z1=7, Z2=7, Rbond=2.0743, lmax=(8, 8), rmax=30.0, nelem=4,
                               nnodes=7)
    ops = b.build_operators("cpu")
    rng = np.random.default_rng(3)
    m2 = ops.shellmask.reshape(-1).numpy()
    X = rng.standard_normal((b.nbf, 6)) * 0.1 * m2[:, None]
    for K in (diatomic.exchange_dia(ops, torch.tensor(X @ X.T)),
              diatomic.exchange_dia_occ(ops, torch.tensor(X))):
        K = K.numpy()
        assert np.abs(K - K.T).max() < 1e-11 * max(np.abs(K).max(), 1.0)


def test_exchange_cross_sums_at_n2_bench():
    """The sums over the inner elements f < e of the right-hand P factors
    G[f] (global radial coordinates) at the N2 bench tables, against exact
    sums (math.fsum): the port adds the element-pair terms one by one, which
    is exact to rounding, while helfem_tpu's inclusive-sum-minus-self
    (diatomic.py:848-849, :990) rounds the inner sum to the scale of the
    element's own block where neighbouring elements share a node, and the P
    moments grow by orders of magnitude from element to element. The
    port's form is read off its plain kernel: with identity Q moments, a
    zero TEI table and R = 1 for one shell pair, the assembled lower cross
    triangle is K[n in e, x] = sum_{f<e} sum_m G[f][m, x]."""
    cfg = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8)
    tb = diatomic.DiatomicBasis(**cfg)
    ops = tb.host_operators()
    gidx, nrad = ops["gidx"], tb.nrad
    nelem, npr = gidx.shape
    worst_port = worst_jax = 0.0
    eye = torch.eye(npr, dtype=torch.float64).expand(1, nelem, npr, npr).contiguous()
    zero = torch.zeros_like(eye)
    tei0 = torch.zeros((1, 3, nelem, npr * npr, npr * npr), dtype=torch.float64)
    ones = torch.ones((1, 4, 1, 1, nrad, nrad), dtype=torch.float64)
    ones[:, 1:] = 0.0  # family (0,0) only
    gi = torch.tensor(gidx, dtype=torch.int32)
    ilm = torch.zeros(1, dtype=torch.int32)
    first = gidx[:, 0]  # first[e]: a row covered by element e and, at its last slot, e - 1
    for c in range(0, len(tb.lm_map), 5):
        dP = ops["dP0"][c]
        G = np.zeros((nelem, nrad + 1, nrad + 1))  # G[f][m, x] = dP[f, x_loc, m_loc]
        for f in range(nelem):
            G[f][np.ix_(gidx[f], gidx[f])] = dP[f].T
        G = G[:, :nrad, :nrad]

        def colsum(M):  # exact sum over m
            return np.array([math.fsum(M[:, x]) for x in range(nrad)])

        rows = np.array([colsum(G[f]) for f in range(nelem)])  # [f, x]
        exact = np.array([[math.fsum(rows[:e, x]) for x in range(nrad)] for e in range(nelem)])
        jax_low = np.asarray(jnp.cumsum(jnp.asarray(G), axis=0) - jnp.asarray(G))
        jax_low = np.array([colsum(jax_low[e]) for e in range(nelem)])
        K = kernels.radial_exchange_dia_plain(
            ones, tei0, torch.tensor(dP[None]), zero, eye, zero, ilm, gi)[0, 0].numpy()
        scale = np.abs(exact).max()
        for e in range(2, nelem):
            # the lower triangle gives row first[e] the inner sums of e and of
            # e - 1 on the columns left of element e - 1, where no upper term
            # lands
            cols = slice(0, gidx[e - 1, 0])
            want = exact[e, cols] + exact[e - 1, cols]
            worst_port = max(worst_port, np.abs(K[first[e], cols] - want).max() / scale)
        worst_jax = max(worst_jax, np.abs(jax_low - exact).max() / scale)
    print(f"cross sums vs fsum: port {worst_port:.3e}, cumsum-minus-self {worst_jax:.3e}")
    assert worst_port <= 1e-15
    # helfem_tpu's form is off by 1.3e-7 x max-abs of the inner sums at these
    # tables (on the shared node, where the outer element's block dominates)
    assert worst_jax > 1e-9
