"""The port's atomic fields, confinement, finite and off-centre nuclei and the
dense exchange of symmetry 0/1 against helfem_tpu on the CPU.

Tolerances: the host operators, grids and couplings within 1e-12 x
max-abs (most are equal); the dense exchange (Coulomb, Yukawa and erfc
kernels on their plain versions) within 1e-12 x max-abs; converged SCF
energies and their field components within 1e-9 Eh in helfem_tpu's
iteration counts."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models import atomic as jatomic
from helfem_tpu.ops import gaunt as jgaunt
from helfem_tpu.ops import grids as jgrids
from helfem_tpu.ops import gygi as jgygi
from helfem_tpu.scf import atomic_scf as jax_scf
from helfem_tpu_torch.cli.atomic import main
from helfem_tpu_torch.models import atomic
from helfem_tpu_torch.ops import gaunt, grids, gygi
from helfem_tpu_torch.scf import atomic_scf
from helfem_tpu_torch.utils.checkpoint import load_atomic

TOL = 1e-12
SCF_TOL = 1e-9


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The atomic CLI writes its checkpoint (helfem.npz by default) into the
    working directory: each test runs in its own."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread and one BLAS thread for this module: the SCFs are
    streams of small ops, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def test_sin2_couplings_match_jax():
    for la in range(5):
        for lb in range(5):
            for m in range(-min(la, lb), min(la, lb) + 1):
                for fn in ("sine2_coupling", "cos2sin2_coupling"):
                    assert getattr(gaunt, fn)(la, m, lb, m) == getattr(jgaunt, fn)(la, m, lb, m)


def test_gygi_matches_jax():
    r = np.concatenate([[0.0, 1e-9, 1e-6, 3e-5], np.linspace(1e-4, 8.0, 50)])
    for a in (2.0, 3.0):
        b = gygi.gygi_b(a)
        assert b == jgygi.gygi_b(a)
        _close(gygi.gygi_phi(a, b, r), jgygi.gygi_phi(a, b, r))
        for Z in (1, 18):
            _close(gygi.gygi_V(Z, a, r, b), jgygi.gygi_V(Z, a, r, b))


GRID_VARIANTS = {
    "point": dict(),
    "gaussian": dict(model="gaussian", Rrms=0.05, nelem0=3),
    "spherical": dict(model="spherical", Rrms=0.05, nelem0=2, igrid0=3, zexp0=1.5),
    "hollow": dict(model="hollow", Rrms=0.05, nelem0=2),
    "regularized": dict(model="regularized", Rrms=2.0, nelem0=2),
    "offcentre": dict(Z=2, Zl=1, Zr=1, Rhalf=0.7, nelem0=3),
    "offcentre_Z0": dict(Zl=1, Zr=2, Rhalf=1.2, nelem0=2),
    "boundary": dict(add_boundary=2.5),
}


@pytest.mark.parametrize("variant", list(GRID_VARIANTS))
def test_form_grid_variants_match_jax(variant):
    kw = dict(model="point", Rrms=0.0, nelem=5, rmax=30.0, igrid=4, zexp=2.0)
    kw.update(GRID_VARIANTS[variant])
    got, ref = grids.form_grid(**kw), jgrids.form_grid(**kw)
    assert np.array_equal(got, ref)
    args = dict(Z=kw.get("Z", 0), lmax=1, mmax=0, rmax=30.0, nelem=5, nnodes=5,
                finitenuc=kw["model"], Rrms=kw["Rrms"], nelem0=kw.get("nelem0", 0),
                igrid0=kw.get("igrid0", 2), zexp0=kw.get("zexp0", 2.0), Zl=kw.get("Zl", 0),
                Zr=kw.get("Zr", 0), Rmid=kw.get("Rhalf", 0.0),
                conf_boundary=kw.get("add_boundary", 0.0))
    assert np.array_equal(atomic.AtomicBasis(**args).rb.fem.bval,
                          jatomic.AtomicBasis(**args).rb.fem.bval)


def test_offcentre_with_finite_nucleus_raises_as_jax():
    kw = dict(model="gaussian", Rrms=0.05, nelem=4, rmax=20.0, nelem0=2, Zl=1)
    for fn in (grids.form_grid, jgrids.form_grid):
        with pytest.raises(ValueError, match="off-center"):
            fn(**kw)


@pytest.fixture(scope="module")
def bases():
    cfg = dict(Z=10, lmax=3, mmax=2, rmax=20.0, nelem=3, nnodes=6)
    return atomic.AtomicBasis(**cfg), jatomic.AtomicBasis(**cfg)


@pytest.mark.parametrize("iconf, N, R, shift", [(1, 6, 3.0, 0.5), (2, 3, 2.0, 1.0),
                                                (3, 2.5, 4.0, 0.0), (4, 2, 1.5, 0.5)],
                         ids=["polynomial", "exponential", "barrier", "junquera"])
def test_confinement_matches_jax(bases, iconf, N, R, shift):
    b, jb = bases
    r = np.linspace(0.0, 25.0, 301)
    assert np.array_equal(atomic.confinement_Vr(r, 20.0, N, R, iconf, shift),
                          jatomic.confinement_Vr(r, 20.0, N, R, iconf, shift))
    _close(b.confinement(N, R, iconf, shift), jb.confinement(N, R, iconf, shift))


@pytest.mark.parametrize("op", ["dipole_z", "quadrupole_zz", "Bz_field", "nuclear_offcenter",
                                "gaussian", "spherical", "hollow", "regularized"])
def test_host_operators_match_jax(bases, op):
    b, jb = bases
    call = {
        "Bz_field": lambda x: x.Bz_field(0.3),
        "nuclear_offcenter": lambda x: x.nuclear_offcenter(1, 2, 0.8),
        "regularized": lambda x: x.nuclear_model("regularized", 3.0),
    }.get(op, (lambda x: x.nuclear_model(op, 1e-2)) if op in ("gaussian", "spherical", "hollow")
          else (lambda x: getattr(x, op)()))
    _close(call(b), call(jb))


@pytest.fixture(scope="module")
def exchange_case():
    cfg = dict(Z=10, lmax=2, mmax=1, rmax=20.0, nelem=3, nnodes=6)
    b, jb = atomic.AtomicBasis(**cfg), jatomic.AtomicBasis(**cfg)
    X = np.random.default_rng(5).standard_normal((b.nbf, b.nbf))
    return b, jb, b.build_operators("cpu"), jb.build_operators(), X + X.T


KERNELS = {
    "coulomb": (lambda b: None, lambda jb: None, atomic.exchange, jatomic.exchange,
                atomic.exchange_bd),
    "yukawa": (lambda b: b.build_yukawa(0.7, "cpu"), lambda jb: jb.build_yukawa(0.7),
               atomic.rs_exchange, jatomic.rs_exchange, atomic.rs_exchange_bd),
    "erfc": (lambda b: b.build_erfc(0.4, "cpu"), lambda jb: jb.build_erfc(0.4),
             atomic.erfc_exchange, jatomic.erfc_exchange, atomic.erfc_exchange_bd),
}


def _call(fn, ops, rs, *args, **kw):
    return fn(ops, *args, **kw) if rs is None else fn(ops, rs, *args, **kw)


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_dense_exchange_matches_jax(exchange_case, kernel):
    """All nang^2 channel-pair windows of a random symmetric P with
    cross-channel blocks, against helfem_tpu's exchange / rs_exchange /
    erfc_exchange; on an m-block-diagonal P the same-m pairs alone give the
    same K; on a channel-block-diagonal P the dense form is exchange_bd's."""
    b, jb, ops, jops, P = exchange_case
    mk, jmk, dense, jdense, bd = KERNELS[kernel]
    rs, jrs = mk(b), jmk(jb)
    got = _call(dense, ops, rs, torch.tensor(P))
    _close(got, _call(jdense, jops, jrs, jnp.asarray(P)))
    Pm = np.zeros_like(P)
    for idx in b.sym_blocks(1):
        Pm[np.ix_(idx, idx)] = P[np.ix_(idx, idx)]
    pairs = atomic.channel_pairs(b.mval, 1)
    assert len(pairs[0]) < b.nang**2
    _close(_call(dense, ops, rs, torch.tensor(Pm), pairs=pairs),
           _call(dense, ops, rs, torch.tensor(Pm)))
    Pb = np.zeros_like(P)
    for idx in b.sym_blocks(2):
        Pb[np.ix_(idx, idx)] = P[np.ix_(idx, idx)]
    Pd = atomic.channel_diag(torch.tensor(Pb), b.nang, b.nrad)
    _close(_call(dense, ops, rs, torch.tensor(Pb)), _call(bd, ops, rs, Pd))
    # two spins in one launch
    two = _call(dense, ops, rs, torch.stack((torch.tensor(P), torch.tensor(Pm))))
    _close(two[0], got)


H = dict(Z=1, lmax=2, mmax=0, rmax=40.0, nelem=5, nnodes=8)
SCF_CASES = {
    "H Ez": (H, (1, 0), dict(Ez=0.002, convthr=1e-9, maxit=40)),
    "He Bz": (dict(Z=2, lmax=2, mmax=1, rmax=20.0, nelem=4, nnodes=7), (1, 1),
              dict(Bz=0.5, convthr=1e-9)),
    "Ne HF Ez": (dict(Z=10, lmax=2, mmax=0, rmax=20.0, nelem=4, nnodes=7), (5, 5),
                 dict(Ez=0.01, convthr=1e-9)),
    "Ne HF symmetry 0": (dict(Z=10, lmax=2, mmax=1, rmax=20.0, nelem=3, nnodes=6), (5, 5),
                         dict(Ez=0.01, symmetry=0, convthr=1e-9)),
    "confined H": (dict(Z=1, lmax=0, mmax=0, rmax=10.0, nelem=4, nnodes=8, conf_boundary=1.0),
                   (1, 0), dict(iconf=1, conf_N=10, conf_R=2.0, shift_conf=1.0, convthr=1e-9)),
    "H gaussian": (dict(Z=1, lmax=0, mmax=0, rmax=30.0, nelem=4, nnodes=8, finitenuc="gaussian",
                        Rrms=1e-2, nelem0=2), (1, 0),
                   dict(finitenuc="gaussian", Rrms=1e-2, convthr=1e-9)),
    "H regularized": (dict(Z=1, lmax=0, mmax=0, rmax=30.0, nelem=10, nnodes=12), (1, 0),
                      dict(finitenuc="regularized", Rrms=2.0, convthr=1e-9)),
    "off-centre H2+": (dict(Z=0, lmax=4, mmax=0, rmax=20.0, nelem=4, nnodes=7, Zl=1, Zr=1,
                            Rmid=1.0, nelem0=2), (1, 0),
                       dict(Zl=1, Zr=1, Rmid=1.0, convthr=1e-9)),
    "Li LC-LDA Ez": (dict(Z=3, lmax=2, mmax=1, rmax=20.0, nelem=3, nnodes=6), (2, 1),
                     dict(Ez=0.01, method="LC-LDA", convthr=1e-9)),
}


@pytest.fixture(scope="module")
def jax_refs():
    """helfem_tpu's SCF of each case, solved once."""
    out = {}
    for label, (cfg, nel, kw) in SCF_CASES.items():
        out[label] = jax_scf.scf_atom(jatomic.AtomicBasis(**cfg), *nel, **kw)
    out["H E0"] = jax_scf.scf_atom(jatomic.AtomicBasis(**H), 1, 0, convthr=1e-9, maxit=40)
    return out


@pytest.mark.parametrize("label", list(SCF_CASES))
def test_scf_in_fields_matches_jax(jax_refs, label):
    cfg, nel, kw = SCF_CASES[label]
    ref = jax_refs[label]
    got = atomic_scf.scf_atom(atomic.AtomicBasis(**cfg), *nel, device="cpu", **kw)
    assert ref.converged and got.converged
    assert got.niter == ref.niter
    assert abs(got.E - ref.E) < SCF_TOL
    assert abs(got.Efield - ref.Efield) < SCF_TOL
    assert got.symm_used == ref.symm_used
    if label == "H Ez":  # the finite-field dipole polarizability of H: 4.5
        alpha = -2.0 * (got.E - jax_refs["H E0"].E) / kw["Ez"] ** 2
        assert abs(alpha - 4.5) < 0.05
    if label == "H regularized":  # the Gygi nucleus keeps E0 = -Z^2/2
        assert abs(got.E + 0.5) < 1e-9
    if "Bz" in kw:  # no restricted run in a magnetic field
        assert got.orbs_b is not None


def test_cli_field_flags_match_scf_atom(capsys):
    """The CLI's field, confinement and off-centre flags reach scf_atom."""
    argv = ["--Z", "0", "--Zl", "1", "--Zr", "1", "--Rmid", "0.37042404", "--angstrom",
            "--lmax", "4", "--mmax", "0", "--Rmax", "20", "--nelem", "4", "--nnodes", "7",
            "--nelem0", "2", "--iguess", "3", "--convthr", "1e-9", "--Ez", "0.01",
            "--iconf", "1", "--conf_N", "8", "--conf_R", "6", "--shift_conf", "2",
            "--symmetry", "0", "--device", "cpu"]
    res = main(argv)
    out = capsys.readouterr().out
    Rmid = 0.37042404 / 0.529177210903
    basis = atomic.AtomicBasis(Z=0, lmax=4, mmax=0, rmax=20.0, nelem=4, nnodes=7, nelem0=2,
                               Zl=1, Zr=1, Rmid=Rmid, conf_boundary=2.0)
    ref = atomic_scf.scf_atom(basis, 1, 1, convthr=1e-9, maxit=50, device="cpu", Zl=1, Zr=1,
                              Rmid=Rmid, Ez=0.01, iconf=1, conf_N=8, conf_R=6.0,
                              shift_conf=2.0, symmetry=0)
    assert res.converged and res.E == ref.E and res.niter == ref.niter
    assert res.symm_used == 0 and "with 1+1 electrons" in out
    assert "Field/confinement     energy" in out


@pytest.mark.parametrize("flag", ["--maverage --save he.npz", "--eigiter 4 --load he.npz",
                                  "--readocc occs.dat --ndev 1", "--zeroder --save he.npz"],
                         ids=["--maverage", "--eigiter 4", "--readocc occs.dat", "--zeroder"])
def test_cli_unported_flags_still_raise(flag):
    """The SCF-control and basis flags run (tests/test_torch_scf_controls.py),
    in Ez: --readocc beside --ndev 1 (tests/test_torch_parallel.py) within
    1e-9 Eh of the same run without it; beside the checkpoint flags the
    --save file (its m blocks, one for He) loads back with the run's energy
    and basis, and --load warm-starts from one written before it."""
    he = ["--Z", "He", "--lmax", "0", "--mmax", "0", "--nelem", "3", "--Ez", "0.01",
          "--device", "cpu"]
    if "--ndev" in flag:
        with open("occs.dat", "w") as f:
            f.write("0 0 1 1\n")
        res = main(he + ["--symmetry", "2"] + flag.split())
        ref = main(he + ["--symmetry", "2"] + flag.split()[:-2])
        assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
        return
    if "--load" in flag:
        main(he + ["--save", "he.npz"])
    res = main(he + flag.split())
    basis, d = load_atomic("he.npz")
    assert res.converged and basis.nbf == res.orbs_a.shape[1]
    assert basis.zeroder == ("--zeroder" in flag)
    if "--save" in flag:
        assert float(d["E"]) == res.E and np.array_equal(d["orbs_a"], res.orbs_a)
    else:
        assert abs(float(d["E"]) - res.E) < 1e-9


@pytest.mark.parametrize("kw", [dict(zeroder=True), dict(bval=np.linspace(0.0, 20.0, 4))],
                         ids=["zeroder", "bval"])
def test_unported_basis_options_raise(kw):
    """zeroder and an explicit bval, which raised before they were ported,
    give helfem_tpu's radial basis: the same element boundaries, radial
    size and overlap (within 1e-12 x max-abs)."""
    cfg = dict(Z=2, lmax=0, mmax=0, nelem=3, nnodes=5, **kw)
    if "zeroder" in kw:
        cfg["primbas"] = 5
    got, ref = atomic.AtomicBasis(**cfg), jatomic.AtomicBasis(**cfg)
    assert np.array_equal(got.rb.fem.bval, ref.rb.fem.bval)
    assert got.nrad == ref.nrad and (got.nelem, got.rmax) == (ref.nelem, ref.rmax)
    _close(got.overlap(), ref.overlap())


def test_finite_nucleus_shift_is_small_and_positive():
    """A Gaussian nucleus raises the 1s energy of a heavy one-electron ion
    a little (helfem_tpu's tests/test_fields.py check, on the port)."""
    cfg = dict(Z=80, lmax=0, mmax=0, rmax=30.0, nelem=10, nnodes=12, zexp=3.0)
    e_point = atomic_scf.scf_atom(atomic.AtomicBasis(**cfg), 1, 0, convthr=1e-8,
                                  device="cpu").E
    e_fin = atomic_scf.scf_atom(atomic.AtomicBasis(**cfg), 1, 0, convthr=1e-8, device="cpu",
                                finitenuc="gaussian", Rrms=1e-4).E
    assert 0.0 < e_fin - e_point < 1.0
    assert math.isfinite(e_fin)
