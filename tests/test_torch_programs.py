"""The port's one-electron and post-processing programs and gensap
--completeness against helfem_tpu's on the CPU: harmonic, softcoulomb,
diatomic_1e, atomic_1e (npz and HDF5 export), diatomic_cbasis,
diatomic_dline and diatomic_dgrid (npz and HDF5 input), diatomic_cpl and
gensap's GTO/STO profiles, each from the same input (the post-processing
programs of both packages read one checkpoint, the port's).

Tolerance: returned and printed values and written files within 1e-12
relative (per value, or of a column's max-abs where a column crosses
zero); orbital columns up to their sign; diatomic_cbasis's lmax list
identical; gensap's profiles against helfem_tpu's profile functions on the
run's basis and orbitals. diatomic_cpl's completeness Y = diag(p S^+ p^T)
comes from the pseudo-inverse of an overlap whose condition number is
~1e8 here: it is held to twice the spread of helfem_tpu's own formula
under scipy's eigh drivers (evr, ev, evd against numpy's), since no
eigensolver defines it closer; its exponents and importances to 1e-12."""

import contextlib
import io
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.cli import atomic_1e as jax_atomic_1e
from helfem_tpu.cli import diatomic_1e as jax_diatomic_1e
from helfem_tpu.cli import diatomic_cbasis as jax_cbasis
from helfem_tpu.cli import diatomic_cpl as jax_cpl
from helfem_tpu.cli import diatomic_dgrid as jax_dgrid
from helfem_tpu.cli import diatomic_dline as jax_dline
from helfem_tpu.cli import harmonic as jax_harmonic
from helfem_tpu.cli import softcoulomb as jax_softcoulomb
from helfem_tpu.models.diatomic_cpl import probe_projection as jax_probe_projection
from helfem_tpu.utils import checkpoint as jck
from helfem_tpu_torch.cli import (
    atomic_1e,
    diatomic_1e,
    diatomic_cbasis,
    diatomic_cpl,
    diatomic_dgrid,
    diatomic_dline,
    gensap,
    harmonic,
    softcoulomb,
)
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
from helfem_tpu_torch.utils import checkpoint as ck

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TOL = 1e-12
LIH = dict(Z1=3, Z2=1, Rbond=3.015, lmax=(3, 3), rmax=20.0, nelem=3, nnodes=5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op and one BLAS thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lih(tmp_path_factory):
    """The port's LiH HF checkpoint (npz; m = 0 and +-1 shells), which both
    packages read (tests/test_torch_checkpoint.py holds the schema)."""
    path = tmp_path_factory.mktemp("lih") / "lih.npz"
    basis = DiatomicBasis(**LIH)
    ck.save_diatomic(str(path), basis, scf_diatomic(basis, 2, 2, convthr=1e-9, device="cpu"))
    return path


def _run(main, argv):
    """(return value, printed lines) of a CLI main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines()


def _numbers(lines):
    vals = []
    for line in lines:
        for tok in line.replace("(", " ").replace(")", " ").split():
            try:
                vals.append(float(tok))
            except ValueError:
                pass
    return np.array(vals)


def _rel(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) <= tol * np.maximum(np.abs(ref), 1e-300)).all()


def _columns(got, ref, tol=TOL):
    """Each column within tol of its max-abs."""
    got, ref = np.atleast_2d(got), np.atleast_2d(ref)
    assert got.shape == ref.shape
    assert (np.abs(got - ref).max(axis=0) <= tol * np.abs(ref).max(axis=0)).all()


def _in_dirs(tmp_path, monkeypatch, jax_main, main, argv):
    """Run both programs in their own directories under tmp_path."""
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    ref = _run(jax_main, argv)
    monkeypatch.chdir(tmp_path / "port")
    got = _run(main, argv + ["--device", "cpu"])
    return got, ref


@pytest.mark.parametrize("prog", ["harmonic", "softcoulomb", "diatomic_1e"])
def test_spectra_match(prog):
    main, jax_main, argv = {
        "harmonic": (harmonic.main, jax_harmonic.main, ["--nelem", "8", "--nnodes", "10"]),
        "softcoulomb": (softcoulomb.main, jax_softcoulomb.main, ["--asoft", "0.5"]),
        "diatomic_1e": (diatomic_1e.main, jax_diatomic_1e.main,
                        ["--Z1", "H", "--Z2", "H", "--Rbond", "2", "--lmax", "6",
                         "--nelem", "4", "--nnodes", "8"]),
    }[prog]
    (got, out), (ref, jout) = _run(main, argv + ["--device", "cpu"]), _run(jax_main, argv)
    _rel(got, ref)
    _rel(_numbers(out), _numbers(jout))
    if prog == "diatomic_1e":  # H2+ at R = 2: -0.6026342144949 Eh with 1/R
        assert abs(got[0] + 0.5 - (-0.6026342144949)) < 2e-4  # this small basis


@pytest.mark.parametrize("fmt", ["npz", "chk"])
def test_atomic_1e_matches(tmp_path, monkeypatch, fmt):
    """Z = 1: hydrogenic levels within 1e-10; eigenvalues, grid and orbitals
    (up to each column's sign) as helfem_tpu exports them."""
    argv = ["--Z", "1", "--nelem", "6", "--nnodes", "15", "--lmax", "2", "--save",
            f"h.{fmt}"]
    (got, out), (ref, jout) = _in_dirs(tmp_path, monkeypatch, jax_atomic_1e.main,
                                       atomic_1e.main, argv)
    _rel(_numbers(out), _numbers(jout))
    # 1s, 2s, 2p
    assert np.abs(got["E_0"][:2] - [-0.5, -0.125]).max() < 1e-10
    assert abs(got["E_1"][0] + 0.125) < 1e-10
    if fmt == "chk":
        h5py = pytest.importorskip("h5py")
        with h5py.File(tmp_path / "port" / "h.chk") as f, \
                h5py.File(tmp_path / "jax" / "h.chk") as g:
            assert sorted(f) == sorted(g)
            got = {k: np.asarray(f[k]).T for k in f}
            ref = {k: np.asarray(g[k]).T for k in g}
    else:
        got = dict(np.load(tmp_path / "port" / "h.npz"))
        ref = dict(np.load(tmp_path / "jax" / "h.npz"))
    assert sorted(got) == sorted(ref)
    for key in ref:
        if key.startswith("orbs"):
            sign = np.sign((got[key] * ref[key]).sum(axis=0))
            _columns(got[key] * sign, ref[key], 1e-11)
        else:
            _rel(got[key], ref[key])


def test_diatomic_cbasis_matches():
    argv = ["--Z1", "Li", "--Z2", "H", "--Rbond", "3.0", "--thresh", "6", "--nnodes", "8"]
    (got, out), (ref, jout) = _run(diatomic_cbasis.main, argv + ["--device", "cpu"]), \
        _run(jax_cbasis.main, argv)
    assert got == ref and len(got) == 6
    dE = [float(line.split("dE = ")[1]) for line in out if "dE = " in line]
    jdE = [float(line.split("dE = ")[1]) for line in jout if "dE = " in line]
    assert len(dE) == len(jdE)
    # printed with four digits: equal where the values are far from rounding
    assert np.allclose(dE, jdE, rtol=1e-3, atol=1e-15)


@pytest.mark.parametrize("prog, fmt", [("dline", "npz"), ("dline", "chk"), ("dgrid", "npz"),
                                       ("dgrid", "chk")])
def test_density_programs_match(tmp_path, monkeypatch, lih, prog, fmt):
    """The density along the axis and on the (z, rho) grid from the LiH
    checkpoint, and from the upstream-layout H2 HDF5 fixture."""
    src = lih if fmt == "npz" else FIXTURES / "h2_hf_ref_layout.chk"
    main, jax_main, extra, name = {
        "dline": (diatomic_dline.main, jax_dline.main, ["--npts", "101"], "density_line.dat"),
        "dgrid": (diatomic_dgrid.main, jax_dgrid.main, ["--nz", "30", "--nrho", "12"],
                  "density_grid.dat"),
    }[prog]
    _in_dirs(tmp_path, monkeypatch, jax_main, main, ["--load", str(src)] + extra)
    got = np.loadtxt(tmp_path / "port" / name)
    ref = np.loadtxt(tmp_path / "jax" / name)
    _columns(got, ref)
    assert ref[:, -1].min() >= 0.0 and ref[:, -1].max() > 0.0


def test_diatomic_cpl_matches(tmp_path, monkeypatch, lih):
    argv = ["--load", str(lih), "--nexp", "15", "--completeness", "1"]
    (_, out), (_, jout) = _in_dirs(tmp_path, monkeypatch, jax_cpl.main, diatomic_cpl.main,
                                   argv)
    assert [line.split("->")[1] for line in out] == [line.split("->")[1] for line in jout]
    basis, _ = jck.load_diatomic(str(lih))
    S = basis.overlap()
    mv = basis.shell_mask().reshape(-1)
    S = S * mv[:, None] * mv[None, :]
    pinvs = []
    for w, U in (np.linalg.eigh(S), *(scipy.linalg.eigh(S, driver=d)
                                      for d in ("evr", "ev", "evd"))):
        keep = w >= 1e-13 * w.max()
        pinvs.append((U[:, keep] / w[keep]) @ U[:, keep].T)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 12
    for name in files:
        got, ref = np.loadtxt(tmp_path / "port" / name), np.loadtxt(tmp_path / "jax" / name)
        _rel(got[:, 0], ref[:, 0])
        _columns(got[:, 2:], ref[:, 2:])
        m, l, center = name[:-4].split("_")[2:]
        p = jax_probe_projection(basis, int(l[1:]), int(m[1:]), ref[:, 0], center, "GTO")
        Ys = [np.einsum("ai,ij,aj->a", p, Si, p) for Si in pinvs]
        spread = max(np.abs(Y - Ys[0]).max() for Y in Ys[1:])
        assert np.abs(Ys[0] - ref[:, 1]).max() <= 1e-13 * np.abs(ref[:, 1]).max()
        assert np.abs(got[:, 1] - ref[:, 1]).max() <= max(2 * spread, TOL * ref[:, 1].max())


def test_gensap_completeness_matches(tmp_path, monkeypatch):
    """gensap --completeness: the four profile files of Ne (s and p) hold
    helfem_tpu's completeness profiles of its basis and its importance
    profiles of the run's occupied orbitals (helfem_tpu/cli/gensap.py:
    275-294), within 1e-12 of each column's max-abs."""
    from helfem_tpu.models.sadatom import SadAtomBasis as JaxSadAtomBasis
    from helfem_tpu.ops import lcao as jax_lcao

    monkeypatch.chdir(tmp_path)
    res, out = _run(gensap.main, ["--Z", "Ne", "--lmax", "1", "--nelem", "3", "--nnodes", "5",
                                  "--nosearch", "--convthr", "1e-9", "--completeness",
                                  "--device", "cpu"])
    assert res.converged
    assert sum("completeness + importance profiles written" in line for line in out) == 2
    rb = JaxSadAtomBasis(Z=10, lmax=1, nelem=3, nnodes=5).rb
    expn = np.logspace(-5, 10, 501)
    for kind in ("GTO", "STO"):
        comp = [np.log10(expn)] + [jax_lcao.completeness_profile(rb, l, expn, kind)
                                   for l in range(2)]
        imp = [np.log10(expn)] + [
            jax_lcao.importance_profile(
                rb, np.asarray(res.orbs[l])[:, :int(np.ceil(res.occs[l] / (4 * l + 2)))], l,
                expn, kind) for l in range(2)]
        for name, ref in ((f"completeness_{kind}_Ne.dat", comp),
                          (f"importance_{kind}_Ne.dat", imp)):
            got = np.loadtxt(name)
            assert got.shape == (501, 3)
            _columns(got, np.column_stack(ref))
