"""The port's diatomic XC kernels' plain versions for one and two spins
against helfem_tpu's _fields_dia and eval_fxc_dia (float64 on the CPU),
within 1e-12 x max-abs, and the grid tables the kernels read: the live
shell pairs, the owner and band tables, the element products, the symmetry
check."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helfem_tpu.models import diatomic as jdia
from helfem_tpu.models import diatomic_dft as jdft
from helfem_tpu.ops import xc as jxc
from helfem_tpu_torch.kernels import dia_xc_fields_plain, dia_xc_fock_plain
from helfem_tpu_torch.kernels.dia_xc_fields import fields_plan
from helfem_tpu_torch.models import diatomic, diatomic_dft
from helfem_tpu_torch.ops import xc

TOL = 1e-12
CFG = dict(Z1=6, Z2=8, Rbond=2.132, lmax=(3, 2), rmax=15.0, nelem=3, nnodes=5)


@pytest.fixture(scope="module")
def setup():
    jb = jdia.DiatomicBasis(**CFG)
    jops = jb.build_operators()
    jg = jdft.build_dia_grid(jb)
    tb = diatomic.DiatomicBasis(**CFG)
    ops = tb.build_operators("cpu")
    g = diatomic_dft.build_dia_grid(tb, "cpu")
    rng = np.random.default_rng(29)
    Pa, Pb = (rng.standard_normal((tb.nbf, tb.nbf)) for _ in range(2))
    return jb, jops, jg, tb, ops, g, Pa + Pa.T, Pb + Pb.T


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _jax_fields(jg, P, nang, nrad):
    P4 = P.reshape(nang, nrad, nang, nrad).transpose(0, 2, 1, 3)
    return jdft._fields_dia(jg, jnp.pad(jnp.asarray(P4), ((0, 0), (0, 0), (0, 1), (0, 1))))[:3]


@pytest.mark.parametrize("ns", [1, 2])
def test_fields_plain_matches_jax_per_spin(setup, ns):
    jb, _, jg, _, _, g, Pa, Pb = setup
    P = np.stack([Pa, Pb][:ns])
    got = dia_xc_fields_plain(torch.tensor(P), g)
    for s in range(ns):
        for field, ref in zip(got, _jax_fields(jg, P[s], jb.nang, jb.nrad)):
            assert field.shape[0] == ns
            _close(field[s].numpy(), ref)


def test_fock_plain_matches_jax_per_spin(setup, monkeypatch):
    """eval_fxc_dia of both packages with the functional replaced by the same
    random, spin-asymmetric potentials, so that K5's two spins see unrelated
    inputs; then K5's plain version for the first spin alone gives the same
    bits as in the two-spin call."""
    jb, jops, jg, tb, ops, g, Pa, Pb = setup
    rng = np.random.default_rng(31)
    pots = [rng.standard_normal(tuple(g.w.shape)) for _ in range(6)]

    def fake(module):
        def xc_eval(funcs, ra, *args, **kwargs):
            return tuple(module(x) for x in pots)
        return xc_eval

    monkeypatch.setattr(jdft, "xc_eval", fake(jnp.asarray))
    monkeypatch.setattr(diatomic_dft, "xc_eval", fake(torch.tensor))
    jfuncs, _ = jxc.parse_method("PBE")
    funcs, _ = xc.parse_method("PBE")
    Fa_r, Fb_r, Exc_r, _ = jdft.eval_fxc_dia(jfuncs, jg, jops, jnp.asarray(Pa), jnp.asarray(Pb))
    Fa, Fb, Exc, _ = diatomic_dft.eval_fxc_dia(funcs, g, ops, torch.tensor(Pa), torch.tensor(Pb))
    _close(Fa.numpy(), Fa_r)
    _close(Fb.numpy(), Fb_r)
    assert abs(float(Exc) - float(Exc_r)) <= TOL * abs(float(Exc_r))
    w = torch.stack([g.w * torch.tensor(pots[k]) for k in (1, 2)])
    mask = ops.shellmask.reshape(-1)
    both = dia_xc_fock_plain(w, 0.5 * w, 0.25 * w, g, mask)
    one = dia_xc_fock_plain(w[:1], 0.5 * w[:1], 0.25 * w[:1], g, mask)
    assert one.shape[0] == 1 and torch.equal(one[0], both[0])


def test_same_density_twice_gives_the_same_bits(setup):
    """Pb is Pa forms the fields once; a copy of Pa forms them twice."""
    _, _, _, _, ops, g, Pa, _ = setup
    funcs, _ = xc.parse_method("PBE")
    P = torch.tensor(Pa)
    once = diatomic_dft.eval_fxc_dia(funcs, g, ops, P, P)
    twice = diatomic_dft.eval_fxc_dia(funcs, g, ops, P, P.clone())
    for a, b in zip(once, twice):
        assert torch.equal(a, b)


def test_pair_and_owner_tables_match_the_grid(setup):
    jb, _, jg, tb, _, g, _, _ = setup
    TT, dTT = np.asarray(jg.TT), np.asarray(jg.dTT)
    live = (TT != 0).any(-1) | (dTT != 0).any(-1)
    a, b = np.nonzero(np.triu(live))
    assert np.array_equal(g.pairs.numpy(), np.stack([a, b], 1))
    assert live.sum() == 2 * len(a) - int((a == b).sum()) and np.array_equal(live, live.T)
    assert np.array_equal(g.TTp.numpy(), TT[a, b]) and np.array_equal(g.dTTp.numpy(), dTT[a, b])
    gidx, nrad, nprim = tb.fem.gidx, tb.nrad, tb.fem.gidx.shape[1]
    for n in range(nrad):
        slots = [int(s) for s in np.flatnonzero(gidx.ravel() == n)]
        own = [int(o) for o in g.owners[n] if o >= 0]
        assert own == slots and 1 <= len(own) <= 2
        cover = {int(m) for s in own for m in gidx[s // nprim] if m < nrad}
        assert (int(g.band[n, 0]), int(g.band[n, 1])) == (min(cover), max(cover))
        assert len(cover) == max(cover) - min(cover) + 1


def test_element_tables(setup):
    _, _, jg, _, _, g, _, _ = setup
    B, dB = np.asarray(jg.Bg), np.asarray(jg.dBg)
    nij = B.shape[2] * (B.shape[2] + 1) // 2
    ij = g.ijs.numpy()
    i, j = ij >> 16, ij & 0xFFFF
    assert len(ij) == nij and (i <= j).all() and g.BBs.shape[2] % 8 == 0
    assert np.array_equal(g.BBs[:, :, :nij].numpy(), B[:, :, i] * B[:, :, j])
    _close(g.SSs[:, :, :nij].numpy(), dB[:, :, i] * B[:, :, j] + B[:, :, i] * dB[:, :, j])
    assert not g.BBs[:, :, nij:].any() and not g.SSs[:, :, nij:].any()


@pytest.mark.parametrize("field", ["TT", "dTT"])
def test_grid_rejects_tables_not_symmetric(setup, field):
    _, _, jg, tb, _, _, _, _ = setup
    arrays = {k: np.array(v) for k, v in jg._asdict().items()}
    arrays[field][0, 1, 0] += 1e-14
    with pytest.raises(ValueError, match="symmetric"):
        diatomic_dft.from_jax_grid(arrays, tb.nrad, "cpu")


@pytest.mark.parametrize("nprim, nq", [(33, 165), (40, 200), (8, 2100)])
def test_fields_plan_takes_large_elements(nprim, nq):
    """K4's tiles past the old kernels' nprim 32 and K5's nq 2048: chunks of
    radial points and pairs that fit the card's shared memory."""
    pc, qc, smem = fields_plan(nprim, nq)
    assert pc >= 1 and 8 <= qc <= 128 and qc % 8 == 0 and smem <= 232448
