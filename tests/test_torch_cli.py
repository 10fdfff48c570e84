"""The port's CLIs (atomic; the open-shell flags of the diatomic CLI and of
gensap; the checkpoint flags --save and --load), their isolation from JAX,
and the kernel wrappers' routing on CPU tensors."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helfem_tpu_torch import kernels
from helfem_tpu_torch.cli import diatomic, gensap
from helfem_tpu_torch.cli.atomic import main
from helfem_tpu_torch.kernels.matmul_probe import split_dd
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.sadatom import (
    SadAtomBasis,
    search_sadatom_unrestricted,
    solve_sadatom_unrestricted,
)
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
from helfem_tpu_torch.utils.checkpoint import load_atomic, load_diatomic

REPO = Path(__file__).resolve().parents[1]
HE = ["--Z", "He", "--lmax", "0", "--mmax", "0", "--nelem", "5", "--nnodes", "8",
      "--iguess", "3", "--convthr", "1e-9"]
HE_JAX = -2.861679941883  # helfem_tpu scf_atom on the same basis
O2 = dict(Z1=8, Z2=8, Rbond=2.282, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
O2_CLI = ["--Z1", "O", "--Z2", "O", "--Rbond", "2.282", "--lmax", "2,2", "--nelem", "3",
          "--nnodes", "5", "--Rmax", "15", "--convthr", "1e-8", "--device", "cpu"]
LI = ["--Z", "Li", "--lmax", "1", "--nelem", "5", "--nnodes", "8", "--nosearch",
      "--device", "cpu"]
# the triplet's ground-state electrons (na nb) in its blocks pi-g, pi-u (m = -1),
# sigma-g, sigma-u, pi-g, pi-u (m = +1) at O2_CLI's basis
O2_OCCS = "1 1\n1 0\n3 3\n2 2\n1 1\n1 0\n"


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The atomic CLI writes its checkpoint (helfem.npz by default) into the
    working directory: each test runs in its own."""
    monkeypatch.chdir(tmp_path)


def test_cli_runs_on_cpu(capsys):
    res = main(HE + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert res.converged and abs(res.E - HE_JAX) < 1e-9
    assert "(fused)" in out
    assert "Total                 energy: -2.86167994188" in out


def test_cli_runs_with_its_default_sap_guess(capsys):
    """No --iguess: the SAP guess (--iguess 2), its He atom solved on the
    CPU, converges to the TF-started energy. One intra-op thread: the SAD
    solve is a stream of small ops, and the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = main([a for a in HE if a not in ("--iguess", "3")] + ["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert res.converged and abs(res.E - HE_JAX) < 1e-9
    assert "(fused)" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["--Ez", "0.01", "--maverage", "--save", "he.npz"],
    ["--ndev", "2"],
    ["--symmetry", "1", "--eigiter", "4", "--load", "he.npz"],
], ids=["field_flag", "ndev_flag", "symmetry_flag"])
def test_cli_unported_raises(extra):
    """The checkpoint flags run beside the field, symmetry, SCF-control and
    --ndev flags (tests/test_torch_fields.py, tests/test_torch_scf_controls.py,
    tests/test_torch_parallel.py): --save names the file, without it the CLI
    writes helfem.npz (under --ndev 2 its parent process, rank 0's); the file
    loads back and holds the run's energy. --load reads a checkpoint written
    by a run before it. --ndev 2 runs the SCF on two gloo ranks to the energy
    of the run without it, within 1e-9 Eh."""
    if "--load" in extra:
        main(HE + ["--device", "cpu", "--save", extra[extra.index("--load") + 1]])
    res = main(HE + extra + ["--device", "cpu"])
    path = extra[extra.index("--save") + 1] if "--save" in extra else "helfem.npz"
    basis, d = load_atomic(path)
    assert res.converged and bool(d["converged"]) and float(d["E"]) == res.E
    assert basis.nbf == res.orbs_a.shape[1] and np.array_equal(d["orbs_a"], res.orbs_a)
    if "--ndev" in extra:
        assert abs(res.E - main(HE + ["--device", "cpu", "--save", ""]).E) < 1e-9


def test_cli_unknown_flag_exits():
    with pytest.raises(SystemExit):
        main(HE + ["--device", "cpu", "--no-such-flag"])


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("extra, nela, nelb, kw", [
    (["--M", "3"], 9, 7, {}),
    (["--nela", "9", "--nelb", "7", "--restricted", "1"], 9, 7, dict(restricted=1)),
    (["--Q", "1", "--restricted", "0", "--perturb", "0.01", "--seed", "3"], 8, 7,
     dict(restricted=0, perturb=0.01, seed=3)),
    (["--restricted", "0"], 8, 8, dict(restricted=0)),
], ids=["multiplicity", "nela_nelb_rohf", "cation_uhf_perturbed", "closed_shell_uhf"])
def test_dia_cli_open_shell_flags(capsys, one_thread, extra, nela, nelb, kw):
    """The diatomic CLI passes --nela/--nelb/--M/--Q, --restricted,
    --perturb and --seed through to scf_diatomic and prints both spins'
    orbital energies."""
    res = diatomic.main(O2_CLI + extra)
    out = capsys.readouterr().out
    ref = scf_diatomic(DiatomicBasis(**O2), nela, nelb, convthr=1e-8, maxit=50,
                       device="cpu", **kw)
    assert res.converged and abs(res.E - ref.E) < 1e-12 and res.niter == ref.niter
    assert f"with {nela}+{nelb} electrons" in out
    assert "beta occupied + lowest virtual orbital energies:" in out
    assert res.orbE_b is not None and res.occ_b.sum() == nelb


@pytest.mark.parametrize("extra", [
    ["--M", "3", "--symmetry", "1", "--save", "o2.npz"],
    ["--M", "3", "--readocc", "1", "--load", "o2.npz"],
    ["--M", "3", "--Bz", "0.1", "--maverage", "--ndev", "1"],
], ids=["symmetry", "readocc", "magnetic_field"])
def test_dia_cli_still_rejects_the_rest(tmp_path, one_thread, extra):
    """--symmetry, --readocc, --maverage (tests/test_torch_scf_controls.py),
    --Bz (tests/test_torch_dia_fields.py) and --ndev (tests/test_torch_parallel.py)
    run: --ndev 1 beside --Bz and --maverage to the energy of the same run
    without it, within 1e-9 Eh; the checkpoint flags run beside them too: the
    --save file loads back with the run's energy and both spins' orbitals;
    --load warm-starts from a triplet's file written before it, and writes
    none itself."""
    if "--ndev" in extra:
        res = diatomic.main(O2_CLI + extra)
        ref = diatomic.main(O2_CLI + extra[:-2])
        assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
        return
    (tmp_path / "occs.dat").write_text(O2_OCCS)
    if "--load" in extra:
        diatomic.main(O2_CLI + ["--M", "3", "--save", "o2.npz"])
    mtime = (tmp_path / "o2.npz").stat().st_mtime_ns if "--load" in extra else None
    res = diatomic.main(O2_CLI + extra)
    basis, d = load_diatomic(tmp_path / "o2.npz")
    assert res.converged and res.occ_a.sum() == 9 and res.occ_b.sum() == 7
    if mtime is None:
        assert float(d["E"]) == res.E and np.array_equal(d["orbs_b"], res.orbs_b)
        assert basis.nbf == DiatomicBasis(**O2).nbf
    else:
        assert (tmp_path / "o2.npz").stat().st_mtime_ns == mtime
        assert abs(float(d["E"]) - res.E) < 1e-7


@pytest.mark.parametrize("extra, check", [
    (["--unrestricted"], lambda b: search_sadatom_unrestricted(b, method="lda_x",
                                                               device="cpu")),
    (["--unrestricted", "--M", "2"], lambda b: solve_sadatom_unrestricted(
        b, 2, 1, method="lda_x", device="cpu")),
    (["--unrestricted", "--scan"], lambda b: search_sadatom_unrestricted(
        b, method="lda_x", mode="scan", device="cpu")),
    (["--restricted", "-1", "--Q", "1"], lambda b: search_sadatom_unrestricted(
        b, nel=2, method="lda_x", device="cpu")),
], ids=["aufbau_search", "multiplicity", "scan", "cation"])
def test_gensap_cli_unrestricted_flags(tmp_path, monkeypatch, one_thread, extra, check):
    """gensap --unrestricted (or --restricted -1/0), --M, --scan and --Q run
    the spin-polarised solver as the library calls do, and write the SAP
    table and its five potential variants beside --output."""
    monkeypatch.chdir(tmp_path)
    res = gensap.main(LI + extra + ["--output", str(tmp_path / "sap.dat")])
    ref = check(SadAtomBasis(Z=3, lmax=1, nelem=5, nnodes=8))
    r_u = res.spin_polarised
    assert r_u.converged and abs(r_u.E - ref.E) < 1e-12
    assert list(r_u.occs) == list(ref.occs) and list(r_u.occs_b) == list(ref.occs_b)
    assert res.Pl.sum(axis=0).trace() != 0.0 and np.loadtxt(tmp_path / "sap.dat").shape[1] == 9
    for tag in gensap.VARIANTS:
        table = np.loadtxt(tmp_path / f"result{tag}_Li.dat")
        assert table.shape[1] == 9 and np.isfinite(table).all(), tag


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import pkgutil, importlib, helfem_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(helfem_tpu_torch.__path__, 'helfem_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for name in ('models.diatomic', 'models.diatomic_dft', 'scf.diatomic_scf',\n"
        "             'cli.diatomic', 'ops.xc', 'ops.legendreq', 'ops.spherical',\n"
        "             'kernels.radial_exchange_dia', 'kernels.matmul_probe',\n"
        "             'tools.f64_ablation', 'tools.profile_dia_scf', 'utils.profiling',\n"
        "             'models.sadatom', 'models.sadconf', 'models.diatomic_tools', 'cli.gensap',\n"
        "             'models.atomic_dft', 'models.xc_grid'):\n"
        "    assert 'helfem_tpu_torch.' + name in names, name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'helfem_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_kernels_import_and_cpu_path_need_no_nvcc():
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    env["CUDA_HOME"] = str(REPO / "no-cuda-here")
    code = (
        "import torch\n"
        "from helfem_tpu_torch.kernels import _build, radial_coulomb, launches\n"
        "x = torch.zeros(1, 1, 2, 2, dtype=torch.float64)\n"
        "z = torch.zeros(1, 1, 2, 2, 2, 2, dtype=torch.float64)\n"
        "d = torch.zeros(1, 1, 2, 2, dtype=torch.float64)\n"
        "radial_coulomb(x, z, d, d, torch.ones(1, dtype=torch.float64),\n"
        "               torch.tensor([[2, 0]], dtype=torch.int32))\n"
        "assert _build._lib is None and launches['radial_coulomb'] == 0\n"
        "try:\n"
        "    _build._nvcc()\n"
        "except RuntimeError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('nvcc found')\n"
    )
    proc = _run(code, env)
    assert proc.returncode == 0, proc.stderr


def _inputs(name):
    from helfem_tpu_torch.models.atomic import AtomicBasis

    if name in _DIA:
        return _dia_inputs(name)
    if name in _PROBES:
        rng = np.random.default_rng(33)
        a, b = (torch.tensor(rng.standard_normal((128, 128))) for _ in range(2))
        if name == "matmul_f32":
            return (a.float(), b.float())
        return (*split_dd(a), *split_dd(b))
    basis = AtomicBasis(Z=4, lmax=1, mmax=0, rmax=20.0, nelem=3, nnodes=5)
    ops = basis.build_operators("cpu")
    X = np.random.default_rng(31).standard_normal((basis.nang, basis.nrad, basis.nrad))
    Pd = torch.tensor(X + X.transpose(0, 2, 1))
    if name == "radial_exchange":
        return (ops.tei, ops.disjL, ops.disjm1L, ops.gidx, Pd)
    Paux = torch.einsum("LMaa,aIJ->LMIJ", ops.G, Pd).contiguous()
    return (Paux, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, ops.gidx)


_DIA = ["radial_coulomb_dia", "dia_xc_fields", "dia_xc_fock", "radial_exchange_dia_occ",
        "radial_exchange_dia"]
_PROBES = ["matmul_f32", "matmul_dd"]
_ALL = ["radial_exchange", "radial_coulomb"] + _DIA + _PROBES


def _dia_inputs(name):
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.models.diatomic_dft import build_dia_grid

    basis = DiatomicBasis(Z1=3, Z2=1, Rbond=3.0, lmax=(2, 1), rmax=12.0, nelem=2, nnodes=4)
    ops = basis.build_operators("cpu")
    g = build_dia_grid(basis, "cpu")
    rng = np.random.default_rng(32)
    X = rng.standard_normal((basis.nbf, basis.nbf))
    if name == "dia_xc_fields":
        return (torch.tensor(X + X.T)[None], g)
    if name == "dia_xc_fock":
        w = g.w[None]
        return (w, w * 0.5, w * 0.25, g, ops.shellmask.reshape(-1))
    if name.startswith("radial_exchange_dia"):
        U = torch.tensor(rng.standard_normal((ops.step_ilm.shape[0], 2, 2, basis.nang,
                                              basis.nrad + 1, 3)))
        U[:, :, :, :, -1] = 0.0
        tables = (ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.step_ilm, ops.gidx)
        if name == "radial_exchange_dia_occ":
            return (0.5 * U, U, *tables)
        sign = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=torch.float64)
        R = torch.einsum("qr,sqtbno,srtcmo->sqrbcnm", sign, U[..., :-1, :], U[..., :-1, :])
        return (R.reshape(R.shape[0], 4, *R.shape[3:]).contiguous(), *tables)
    shape = (ops.LM_ilm.shape[0], basis.nrad, basis.nrad)
    Paux0, Paux2 = (torch.tensor(rng.standard_normal(shape)) for _ in range(2))
    return (Paux0, Paux2, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.LMfac,
            ops.LM_ilm, ops.gidx)


def _tensors(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", _ALL)
def test_wrapper_routes_cpu_to_plain(name):
    args = _inputs(name)
    before = dict(kernels.launches)
    out = getattr(kernels, name)(*args)
    ref = getattr(kernels, name + "_plain")(*args)
    assert all(torch.equal(o, r) for o, r in zip(_tensors(out), _tensors(ref)))
    assert kernels.launches == before


@pytest.mark.parametrize("name", _ALL)
def test_wrapper_rejects_other_devices(name):
    args = _inputs(name)
    with pytest.raises(ValueError, match="no kernel"):
        getattr(kernels, name)(*(a.to("meta") if hasattr(a, "to") else a for a in args))
    mixed = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError, match="several devices"):
        getattr(kernels, name)(*mixed)
