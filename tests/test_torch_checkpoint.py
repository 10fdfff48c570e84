"""The port's checkpoints against helfem_tpu's on the CPU: npz files
cross-read both ways (one schema, key for key and dtype for dtype), the
reference-schema HDF5 files (the port's read by helfem_tpu, the golden
upstream-layout fixtures read by the port), the warm-start densities on
the same and on a finer basis, warm-started SCFs, the crash-recovery hook
save_cb and the CLIs' --save/--load.

Tolerances: bases' S, T and V within 1e-12 x max-abs; warm-start densities
within 1e-12 x max-abs of helfem_tpu's from the same file; warm-started
SCF energies within 1e-9 Eh in helfem_tpu's iteration counts. Be HF (lmax
0, coarse; lmax 1 on a finer grid) and H2 HF (m = 0 and 1 shells); each
package solves each reference once per module."""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models.atomic import AtomicBasis as JaxAtomicBasis
from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiatomicBasis
from helfem_tpu.models.sadatom import SadAtomBasis as JaxSadAtomBasis
from helfem_tpu.scf.atomic_scf import scf_atom as jax_scf_atom
from helfem_tpu.scf.diatomic_scf import scf_diatomic as jax_scf_diatomic
from helfem_tpu.utils import checkpoint as jck
from helfem_tpu.utils import checkpoint_h5 as jh5
from helfem_tpu_torch.cli import atomic as atomic_cli
from helfem_tpu_torch.cli import diatomic as diatomic_cli
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.sadatom import SadAtomBasis, solve_sadatom
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
from helfem_tpu_torch.utils import checkpoint as ck
from helfem_tpu_torch.utils import checkpoint_h5 as h5

h5py = pytest.importorskip("h5py")

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TOL = 1e-12
E_TOL = 1e-9
BE = dict(Z=4, lmax=0, mmax=0, rmax=30.0, nelem=4, nnodes=7)
BE_FINE = dict(Z=4, lmax=1, mmax=1, rmax=30.0, nelem=6, nnodes=9)
H2 = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4, 2), rmax=15.0, nelem=3, nnodes=6)
H2_FINE = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(5, 3), rmax=15.0, nelem=4, nnodes=7)
CONV = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op and one BLAS thread: the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def be(tmp_path_factory):
    """helfem_tpu's Be HF and its npz file, and the port's of the same basis."""
    out = tmp_path_factory.mktemp("be")
    jb, tb = JaxAtomicBasis(**BE), AtomicBasis(**BE)
    jres = jax_scf_atom(jb, 2, 2, convthr=CONV)
    tres = scf_atom(tb, 2, 2, convthr=CONV, device="cpu")
    jck.save_atomic(str(out / "jax.npz"), jb, jres)
    ck.save_atomic(str(out / "port.npz"), tb, tres)
    return types.SimpleNamespace(dir=out, jb=jb, tb=tb, jres=jres, tres=tres)


@pytest.fixture(scope="module")
def h2(tmp_path_factory):
    """helfem_tpu's H2 HF and its npz file, and the port's of the same basis."""
    out = tmp_path_factory.mktemp("h2")
    jb, tb = JaxDiatomicBasis(**H2), DiatomicBasis(**H2)
    jres = jax_scf_diatomic(jb, 1, 1, convthr=CONV)
    tres = scf_diatomic(tb, 1, 1, convthr=CONV, device="cpu")
    jck.save_diatomic(str(out / "jax.npz"), jb, jres)
    ck.save_diatomic(str(out / "port.npz"), tb, tres)
    return types.SimpleNamespace(dir=out, jb=jb, tb=tb, jres=jres, tres=tres)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _same_operators(a, b):
    for name in ("overlap", "kinetic", "nuclear"):
        _close(getattr(a, name)(), getattr(b, name)())


def _same_schema(path_a, path_b):
    a, b = np.load(path_a, allow_pickle=False), np.load(path_b, allow_pickle=False)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key


def test_atomic_npz_cross_reads(be):
    """Each package's file loads in the other into an equal basis and equal
    arrays; both files share keys, dtypes and shapes."""
    _same_schema(be.dir / "jax.npz", be.dir / "port.npz")
    tb, td = ck.load_atomic(str(be.dir / "jax.npz"))
    jb, jd = jck.load_atomic(str(be.dir / "port.npz"))
    _same_operators(tb, be.jb)
    _same_operators(jb, be.tb)
    assert np.array_equal(td["orbs_a"], be.jres.orbs_a)
    assert np.array_equal(jd["orbs_a"], be.tres.orbs_a)
    assert float(td["E"]) == be.jres.E and float(jd["E"]) == be.tres.E
    _close(be.tres.orbE_a, be.jres.orbE_a, 1e-9)


def test_diatomic_and_sad_npz_cross_read(h2, tmp_path):
    _same_schema(h2.dir / "jax.npz", h2.dir / "port.npz")
    tb, td = ck.load_diatomic(str(h2.dir / "jax.npz"))
    jb, jd = jck.load_diatomic(str(h2.dir / "port.npz"))
    _same_operators(tb, h2.jb)
    _same_operators(jb, h2.tb)
    assert np.array_equal(tb.fem.bval, h2.jb.fem.bval) and tb.lmax == h2.jb.lmax
    assert float(td["E"]) == h2.jres.E and np.array_equal(jd["orbs_a"], h2.tres.orbs_a)
    # the spherically averaged atom: one solve, written by both packages
    cfg = dict(Z=3, lmax=1, rmax=20.0, nelem=3, nnodes=5)
    tres = solve_sadatom(SadAtomBasis(**cfg), method="lda_x", device="cpu")
    jck.save_sadatom(str(tmp_path / "jax.npz"), JaxSadAtomBasis(**cfg), tres)
    ck.save_sadatom(str(tmp_path / "port.npz"), SadAtomBasis(**cfg), tres)
    _same_schema(tmp_path / "jax.npz", tmp_path / "port.npz")
    tsb, tsd = ck.load_sadatom(str(tmp_path / "jax.npz"))
    jsb, jsd = jck.load_sadatom(str(tmp_path / "port.npz"))
    _close(tsb.rb.overlap(), JaxSadAtomBasis(**cfg).rb.overlap())
    assert jsb.nrad == tsb.nrad and float(tsd["E"]) == float(jsd["E"]) == tres.E
    assert np.array_equal(jsd["Pl"], tres.Pl) and np.array_equal(tsd["orbs"], tres.orbs)


@pytest.mark.parametrize("kind", ["atomic", "diatomic"])
def test_hdf5_written_by_the_port_reads_in_helfem_tpu(be, h2, tmp_path, kind):
    """One state written by both packages' writers: helfem_tpu's reader
    gets equal bases and equal matrices from the two files; the port's
    reader gets the same from helfem_tpu's file."""
    sys_ = be if kind == "atomic" else h2
    nel = 2 if kind == "atomic" else 1
    save, jsave = ((h5.save_atomic_chk, jh5.save_atomic_chk) if kind == "atomic"
                   else (h5.save_diatomic_chk, jh5.save_diatomic_chk))
    load, jload = ((h5.load_atomic_chk, jh5.load_atomic_chk) if kind == "atomic"
                   else (h5.load_diatomic_chk, jh5.load_diatomic_chk))
    save(str(tmp_path / "port.chk"), sys_.tb, sys_.jres, nel, nel)
    jsave(str(tmp_path / "jax.chk"), sys_.jb, sys_.jres, nel, nel)
    with h5py.File(tmp_path / "port.chk") as f, h5py.File(tmp_path / "jax.chk") as g:
        assert sorted(f.keys()) == sorted(g.keys())
        for key in f:
            assert f[key].shape == g[key].shape and f[key].dtype == g[key].dtype, key
    jb, jd = jload(str(tmp_path / "port.chk"))
    rb, rd = jload(str(tmp_path / "jax.chk"))
    tb, td = load(str(tmp_path / "jax.chk"))
    _same_operators(jb, rb)
    _same_operators(tb, rb)
    assert sorted(jd) == sorted(rd) == sorted(td)
    for key in rd:
        if np.ndim(rd[key]):
            _close(jd[key], rd[key])
            _close(td[key], rd[key])
        else:
            assert jd[key] == rd[key] == td[key]


@pytest.mark.parametrize("name", ["he", "h2"])
def test_golden_reference_layout_fixtures(name):
    """The upstream-layout files (written by raw h5py calls, by neither
    package's writer) load in the port as in helfem_tpu."""
    path = str(FIXTURES / f"{name}_hf_ref_layout.chk")
    if name == "he":
        tb, td = h5.load_atomic_chk(path)
        jb, jd = jh5.load_atomic_chk(path)
    else:
        tb, td = h5.load_diatomic_chk(path)
        jb, jd = jh5.load_diatomic_chk(path)
        _close(h5.load_diatomic_chk_density(path)[1], jh5.load_diatomic_chk_density(path)[1])
        _close(h5.expand_to_padded(tb, td["Ca"]), jh5.expand_to_padded(jb, jd["Ca"]))
        assert np.array_equal(h5._pure_indices(tb), jh5._pure_indices(jb))
    _same_operators(tb, jb)
    assert sorted(td) == sorted(jd)
    for key in jd:
        assert np.array_equal(td[key], jd[key]), key


@pytest.mark.parametrize("target", ["same", "finer"])
def test_warm_start_densities_match(be, h2, target):
    """warm_start_density(_dia) and their HDF5 twins from one file, on the
    same and on a finer basis (the finer atomic one adds p shells)."""
    acfg, dcfg = (BE, H2) if target == "same" else (BE_FINE, H2_FINE)
    path = str(be.dir / "jax.npz")
    got = ck.warm_start_density(AtomicBasis(**acfg), ck.load_atomic(path)[0],
                                ck.load_atomic(path)[1])
    ref = jck.warm_start_density(JaxAtomicBasis(**acfg), *jck.load_atomic(path))
    _close(got[0], ref[0])
    assert got[1] is None and ref[1] is None
    path = str(h2.dir / "jax.npz")
    got = ck.warm_start_density_dia(DiatomicBasis(**dcfg), *ck.load_diatomic(path))
    ref = jck.warm_start_density_dia(JaxDiatomicBasis(**dcfg), *jck.load_diatomic(path))
    _close(got[0], ref[0])
    path = str(FIXTURES / "he_hf_ref_layout.chk")
    he = dict(BE if target == "same" else BE_FINE, Z=2)
    got = h5.warm_start_density_atomic_h5(AtomicBasis(**he), *h5.load_atomic_chk(path))
    ref = jh5.warm_start_density_atomic_h5(JaxAtomicBasis(**he), *jh5.load_atomic_chk(path))
    _close(got[0], ref[0])
    _close(got[1], ref[1])
    path = str(FIXTURES / "h2_hf_ref_layout.chk")
    got = h5.warm_start_density_dia_h5(DiatomicBasis(**dcfg), *h5.load_diatomic_chk(path))
    ref = jh5.warm_start_density_dia_h5(JaxDiatomicBasis(**dcfg), *jh5.load_diatomic_chk(path))
    _close(got[0], ref[0])


@pytest.mark.parametrize("case", ["atomic_finer", "atomic_hdf5", "diatomic_same",
                                  "diatomic_finer"])
def test_warm_started_scf_matches(be, h2, tmp_path, case):
    """SCFs warm-started from helfem_tpu's checkpoints: the port's energy
    within 1e-9 Eh of helfem_tpu's from the same start, in its iteration
    count."""
    if case.startswith("atomic"):
        path = str(be.dir / "jax.npz")
        tb, jb = AtomicBasis(**BE_FINE), JaxAtomicBasis(**BE_FINE)
        if case == "atomic_hdf5":
            path = str(tmp_path / "be.chk")
            jh5.save_atomic_chk(path, be.jb, be.jres, 2, 2)
            tP, _ = h5.warm_start_density_atomic_h5(tb, *h5.load_atomic_chk(path))
            jP, _ = jh5.warm_start_density_atomic_h5(jb, *jh5.load_atomic_chk(path))
        else:
            tP, _ = ck.warm_start_density(tb, *ck.load_atomic(path))
            jP, _ = jck.warm_start_density(jb, *jck.load_atomic(path))
        got = scf_atom(tb, 2, 2, convthr=CONV, P0a=tP, device="cpu")
        ref = jax_scf_atom(jb, 2, 2, convthr=CONV, P0a=jP)
    else:
        path = str(h2.dir / "jax.npz")
        cfg = H2 if case == "diatomic_same" else H2_FINE
        tb, jb = DiatomicBasis(**cfg), JaxDiatomicBasis(**cfg)
        if case == "diatomic_same":
            d = np.load(path)
            tP = ck.density_from_blocks_dia(tb, d["orbs_a"], d["occ_a"])
            jP = jck.density_from_blocks_dia(jb, d["orbs_a"], d["occ_a"])
            _close(tP, jP)
        else:
            tP, _ = ck.warm_start_density_dia(tb, *ck.load_diatomic(path))
            jP, _ = jck.warm_start_density_dia(jb, *jck.load_diatomic(path))
        got = scf_diatomic(tb, 1, 1, convthr=CONV, P0a=tP, device="cpu")
        ref = jax_scf_diatomic(jb, 1, 1, convthr=CONV, P0a=jP)
    assert got.converged and ref.converged
    assert abs(got.E - ref.E) < E_TOL and got.niter == ref.niter


def _recorder(seen, path=None, basis=None, save=None):
    def save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb):
        seen.append((it, Etot))
        if path is not None:
            state = types.SimpleNamespace(
                converged=False, E=Etot, orbE_a=np.sort(np.asarray(Ea).ravel()),
                orbs_a=np.asarray(Ca), occ_a=occa,
                orbE_b=None if Eb is None else np.sort(np.asarray(Eb).ravel()),
                orbs_b=None if Cb is None else np.asarray(Cb), occ_b=occb)
            save(path, basis, state)
    return save_cb


@pytest.mark.parametrize("case", ["atomic_rhf", "atomic_uhf", "diatomic_rhf"])
def test_save_cb_sees_helfem_tpus_iterations(case):
    """The hook's calls: helfem_tpu's iterations (host ones, then one per
    fused chunk) with its energies within 1e-9 Eh."""
    seen, jseen = [], []
    if case.startswith("atomic"):
        kw = {} if case == "atomic_rhf" else dict(restricted=0)
        scf_atom(AtomicBasis(**BE), 2, 2, convthr=CONV, device="cpu",
                 save_cb=_recorder(seen), **kw)
        jax_scf_atom(JaxAtomicBasis(**BE), 2, 2, convthr=CONV, save_cb=_recorder(jseen),
                     **kw)
    else:
        scf_diatomic(DiatomicBasis(**H2), 1, 1, convthr=CONV, device="cpu",
                     save_cb=_recorder(seen))
        jax_scf_diatomic(JaxDiatomicBasis(**H2), 1, 1, convthr=CONV,
                         save_cb=_recorder(jseen))
    assert [it for it, _ in seen] == [it for it, _ in jseen]
    assert max(abs(a - b) for (_, a), (_, b) in zip(seen, jseen)) < E_TOL


def test_kill_and_restart_resumes(be, tmp_path):
    """tests/test_checkpoint.py:102 in both packages: a run cut after three
    iterations leaves the hook's checkpoint; the restart from it converges
    to the uninterrupted energy, in helfem_tpu's iteration counts."""
    runs = {}
    for pkg, basis, scf, save, load, warm in (
            ("port", AtomicBasis(**BE), lambda *a, **k: scf_atom(*a, device="cpu", **k),
             ck.save_atomic, ck.load_atomic, ck.warm_start_density),
            ("jax", JaxAtomicBasis(**BE), jax_scf_atom, jck.save_atomic, jck.load_atomic,
             jck.warm_start_density)):
        path, seen = str(tmp_path / f"{pkg}.npz"), []
        part = scf(basis, 2, 2, convthr=CONV, maxit=3,
                   save_cb=_recorder(seen, path, basis, save))
        assert not part.converged and len(seen) >= 3
        P0a, P0b = warm(basis, *load(path))
        runs[pkg] = (scf(basis, 2, 2, convthr=CONV, maxit=50, P0a=P0a, P0b=P0b), seen)
    (res, seen), (jres, jseen) = runs["port"], runs["jax"]
    assert [it for it, _ in seen] == [it for it, _ in jseen]
    assert res.converged and abs(res.E - be.tres.E) < 1e-8 and res.niter <= be.tres.niter
    assert abs(res.E - jres.E) < E_TOL and res.niter == jres.niter


def test_symmetry_blocks_and_missing_h5py_raise(tmp_path, monkeypatch):
    """A checkpoint of m blocks (Ez: symmetry 1) refuses the npz warm
    start, as helfem_tpu's does; without h5py the HDF5 paths raise
    ImportError naming it, and the CLIs raise before their SCF, writing
    no npz in its place."""
    basis = AtomicBasis(Z=4, lmax=1, mmax=1, rmax=30.0, nelem=4, nnodes=7)
    res = scf_atom(basis, 2, 2, convthr=1e-7, Ez=0.01, device="cpu")
    assert res.symm_used == 1
    path = str(tmp_path / "ez.npz")
    ck.save_atomic(path, basis, res)
    with pytest.raises(ValueError, match="symmetry blocks"):
        ck.warm_start_density(basis, *ck.load_atomic(path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        h5.load_atomic_chk(str(FIXTURES / "he_hf_ref_layout.chk"))
    he = ["--Z", "He", "--lmax", "0", "--mmax", "0", "--nelem", "3", "--nnodes", "5",
          "--iguess", "3", "--device", "cpu"]
    for argv in (["--save", "he.chk"], ["--load", "he.h5"]):
        with pytest.raises(ImportError, match="h5py"):
            atomic_cli.main(he + argv)
    with pytest.raises(ImportError, match="h5py"):
        diatomic_cli.main(["--Z1", "H", "--Z2", "H", "--Rbond", "1.4", "--lmax", "2",
                           "--nelem", "2", "--nnodes", "4", "--device", "cpu", "--save",
                           "h2.hdf5"])
    assert not list(tmp_path.glob("he*")) and not list(tmp_path.glob("h2*"))


@pytest.mark.parametrize("kind, fmt", [("atomic", "npz"), ("diatomic", "chk")])
def test_clis_save_and_load(tmp_path, monkeypatch, capsys, kind, fmt):
    """--save then --load onto a finer basis through the atomic (npz) and
    the diatomic (HDF5) CLI: the final file is written (beside an HDF5 one
    the crash-recovery npz), its energy the run's; the warm start's energy
    and iteration count are helfem_tpu's CLI's from the same file."""
    from helfem_tpu.cli import atomic as jax_atomic_cli
    from helfem_tpu.cli import diatomic as jax_diatomic_cli

    monkeypatch.chdir(tmp_path)
    if kind == "atomic":
        main, jax_main, extra = atomic_cli.main, jax_atomic_cli.main, ["--save", ""]
        cli = ["--Z", "Be", "--Rmax", "30", "--iguess", "3", "--convthr", "1e-9"]
        coarse = cli + ["--lmax", "0", "--mmax", "0", "--nelem", "4", "--nnodes", "7"]
        fine = cli + ["--lmax", "1", "--mmax", "1", "--nelem", "6", "--nnodes", "9"]
    else:
        main, jax_main, extra = diatomic_cli.main, jax_diatomic_cli.main, []
        cli = ["--Z1", "H", "--Z2", "H", "--Rbond", "1.4", "--Rmax", "15", "--convthr", "1e-9"]
        coarse = cli + ["--lmax", "4,2", "--nelem", "3", "--nnodes", "6"]
        fine = cli + ["--lmax", "5,3", "--nelem", "4", "--nnodes", "7"]
    res = main(coarse + ["--device", "cpu", "--save", f"x.{fmt}"])
    saved = np.load("x.chk.crash.npz" if fmt == "chk" else "x.npz")
    assert abs(float(saved["E"]) - res.E) < 1e-9 and (tmp_path / f"x.{fmt}").exists()
    warm = main(fine + ["--device", "cpu", "--load", f"x.{fmt}"] + extra)
    jwarm = jax_main(fine + ["--load", f"x.{fmt}"] + extra)
    out = capsys.readouterr().out
    assert f"checkpoint saved to x.{fmt}" in out and "arm start from" in out
    assert res.converged and warm.converged
    assert abs(warm.E - jwarm.E) < E_TOL and warm.niter == jwarm.niter
