"""The port's diatomic PBE SCF against helfem_tpu's scf_diatomic on the same
basis (core guess, converged energies within 1e-9 Eh, orbital energies
within 1e-7), and the port's diatomic CLI on the CPU with its rejection of
unported flags, methods and options, and its checkpoints (--save, --load,
the SCF's crash-recovery hook save_cb)."""

import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models.diatomic import DiatomicBasis as JaxBasis
from helfem_tpu.scf import diatomic_scf as jax_scf
from helfem_tpu_torch.cli.diatomic import main
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf import diatomic_scf
from helfem_tpu_torch.utils.checkpoint import load_diatomic, save_diatomic

CASES = {
    "H2": (dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=5), 1),
    "N2": (dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5), 7),
}
N2_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "2,2", "--nelem", "3",
          "--nnodes", "5", "--Rmax", "15", "--method", "PBE", "--convthr", "1e-9"]
N2_JAX = -79.449353410152  # helfem_tpu scf_diatomic on the same basis
# N2+ (7 alpha, 6 beta) in the blocks pi-g, pi-u (m = -1), sigma-g, sigma-u,
# pi-g, pi-u (m = +1) of N2_CLI's basis: the beta hole in sigma-g
N2P_OCCS = "0 0\n1 1\n3 2\n2 2\n0 0\n1 1\n"
# helfem_tpu's first 20 iteration energies (its verbose lines) of
# scf_diatomic(DiatomicBasis(**CASES["N2"][0]), 7, 7, method="PBE", convthr=1e-9,
# restricted=0, Bz=0.1, diag=False, ndev=1, verbose=True) on the CPU: its ndev
# host loop does not converge there (50 iterations; ROADMAP queue 3)
N2_UKS_BZ_NDEV1 = [
    -69.324866314241, -66.907160702771, -79.368817778792, -79.400785989293, -79.411303744672,
    -79.404728297777, -79.412823579024, -79.411468299396, -79.412292355943, -79.410889222974,
    -79.412115457744, -79.412120992353, -79.412104011262, -79.411971889343, -79.411121470044,
    -79.410925086828, -79.410782859336, -79.411404515469, -79.411846303004, -79.413106277001]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread and one BLAS thread for this module: the SCFs
    are streams of small ops, and the test workers share the machine's
    cores (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("molecule", list(CASES))
def test_pbe_energy_matches_jax(molecule):
    cfg, nel = CASES[molecule]
    ref = jax_scf.scf_diatomic(JaxBasis(**cfg), nel, nel, method="PBE", convthr=1e-9)
    got = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), nel, nel, method="PBE",
                                    convthr=1e-9, device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert np.abs(got.orbE_a[:nel + 2] - ref.orbE_a[:nel + 2]).max() < 1e-7
    # degenerate pi(+m)/pi(-m) levels may come in either order
    assert sorted(got.orbsym_a[:nel]) == sorted(ref.orbsym_a[:nel])
    for comp in ("Ekin", "Enucattr", "Ecoul", "Exc"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-7, comp
    assert abs(got.Nelgrid - 2 * nel) < 1e-6


def test_cli_runs_on_cpu(capsys):
    res = main(N2_CLI + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert res.converged and abs(res.E - N2_JAX) < 1e-9
    assert "(fused)" in out
    assert "Total                 energy: -79.4493534101" in out
    assert "piu" in out and "occ" in out


def _iteration_energies(out: str) -> np.ndarray:
    return np.array([float(line.split()[4]) for line in out.splitlines()
                     if line.startswith("iter ")])


@pytest.mark.parametrize("extra, error, match", [
    (["--method", "LC-LDA"], ValueError, "LC-LDA' is range-separated"),
    (["--method", "sr-pbe0"], ValueError, "sr-pbe0' is range-separated"),
    (["--Q", "1", "--readocc", "1", "--save", "n2.npz"], None, None),
    (["--Ez", "0.01", "--maverage", "--load", "n2.npz"], None, None),
    (["--ndev", "2"], None, None),
    (["--restricted", "0", "--Bz", "0.1", "--diag", "0", "--ndev", "1"], None, None),
], ids=["range_separated", "sr_hybrid", "open_shell", "field_flag", "ndev_flag",
        "uhf_flag"])
def test_cli_unported_raises(tmp_path, monkeypatch, capsys, extra, error, match):
    """A range-separated method raises helfem_tpu's ValueError (range
    separation exists on atoms only). --ndev 2 runs the SCF on two gloo
    ranks to the energy of the same run without it, within 1e-9 Eh. Beside
    UHF in Bz with Cholesky whitening, --ndev 1's host loop (helfem_tpu's
    ndev path) does not converge in 50 iterations, and neither does
    helfem_tpu's ndev=1 run: the port's first 20 iterations lie within 1e-9
    Eh of helfem_tpu's (N2_UKS_BZ_NDEV1). The field and SCF-control flags run
    (tests/test_torch_dia_fields.py, tests/test_torch_scf_controls.py). The
    checkpoint flags run beside the others: the --save file loads back with
    the run's energy and orbitals; --load of a file written without the
    field warm-starts the run in Ez (its blocks merge g and u) from the
    file's energy."""
    monkeypatch.chdir(tmp_path)
    if error is not None:
        with pytest.raises(error, match=match):
            main(N2_CLI + extra + ["--device", "cpu"])
        return
    if "--ndev" in extra:
        i = extra.index("--ndev")
        res = main(N2_CLI + extra + ["--device", "cpu"])
        if "--Bz" in extra:
            got = _iteration_energies(capsys.readouterr().out)
            assert not res.converged and len(got) == 50
            assert np.abs(got[:20] - N2_UKS_BZ_NDEV1).max() < 1e-9
            return
        ref = main(N2_CLI + extra[:i] + extra[i + 2:] + ["--device", "cpu"])
        assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
        return
    (tmp_path / "occs.dat").write_text(N2P_OCCS)
    if "--load" in extra:
        main(N2_CLI + ["--device", "cpu", "--save", "n2.npz"])
        capsys.readouterr()
    res = main(N2_CLI + extra + ["--device", "cpu"])
    out = capsys.readouterr().out
    basis, d = load_diatomic("n2.npz")
    assert res.converged and basis.nbf == DiatomicBasis(**CASES["N2"][0]).nbf
    if "--save" in extra:
        assert float(d["E"]) == res.E and np.array_equal(d["orbs_b"], res.orbs_b)
        assert "checkpoint saved to n2.npz" in out
    else:
        assert f"warm start from n2.npz (E = {float(d['E']):.9f})" in out
        assert abs(float(d["E"]) - N2_JAX) < 1e-9 and len(res.orbE_blocks_a) == 3


def test_cli_unknown_flag_exits():
    with pytest.raises(SystemExit):
        main(N2_CLI + ["--device", "cpu", "--no-such-flag"])


@pytest.mark.parametrize("kwargs", [
    {"Ez": 0.01, "maverage": True, "ndev": 1}, {"Bz": 0.1, "ndev": 1},
    {"restricted": 0, "Bz": 0.1, "diag": False, "save_cb": "npz"},
    {"maverage": True, "save_cb": "npz"}, {"diag": False, "ndev": 1}, {"ndev": 1},
    {"perturb": 0.1, "P0a": "zeros", "ndev": 1},
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(tmp_path, kwargs):
    """ndev runs (tests/test_torch_parallel.py) beside fields, m-averaging,
    Cholesky whitening and a perturbed warm start from the zero density, to
    the energy of the same call without it within 1e-9 Eh; UHF, perturbed
    guesses, fields, m-averaging, Cholesky whitening and warm starts run
    (tests/test_torch_dia_open.py, tests/test_torch_dia_fields.py,
    tests/test_torch_scf_controls.py). The crash-recovery hook save_cb runs
    beside them: it sees the two host iterations, then rising iterations up
    to the run's last (the fused chunks' reported ones), and the npz file it
    writes loads back with the last iteration's energy, the run's."""
    cfg, nel = CASES["H2"]
    basis = DiatomicBasis(**cfg)
    if "ndev" in kwargs:
        if kwargs.get("P0a") == "zeros":
            kwargs = dict(kwargs, P0a=np.zeros((basis.nbf, basis.nbf)))
        res = diatomic_scf.scf_diatomic(basis, nel, nel, method="PBE", device="cpu", **kwargs)
        ref = diatomic_scf.scf_diatomic(basis, nel, nel, method="PBE", device="cpu",
                                        **{k: v for k, v in kwargs.items() if k != "ndev"})
        assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
        return
    path, seen = tmp_path / "h2.npz", []

    def save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb):
        state = types.SimpleNamespace(converged=False, E=Etot, orbE_a=np.sort(Ea.ravel()),
                                      orbs_a=Ca, occ_a=occa, orbE_b=Eb, orbs_b=Cb, occ_b=occb)
        save_diatomic(path, basis, state)
        seen.append(it)

    res = diatomic_scf.scf_diatomic(basis, nel, nel, method="PBE", device="cpu",
                                    **dict(kwargs, save_cb=save_cb))
    _, d = load_diatomic(path)
    assert res.converged and seen[:2] == [1, 2] and seen == sorted(set(seen))
    assert seen[-1] == res.niter
    assert float(d["E"]) == res.E
    assert (d["orbs_b"].size > 0) == (res.orbs_b is not None)


def test_unported_basis_paths_raise():
    """The basis's field operators, which raised before they were ported,
    agree with helfem_tpu's within 1e-12 x max-abs."""
    basis, jbasis = DiatomicBasis(**CASES["H2"][0]), JaxBasis(**CASES["H2"][0])
    for name, args in (("dipole_z", ()), ("quadrupole_zz", ()), ("Bz_field", (0.1,))):
        got, ref = getattr(basis, name)(*args), getattr(jbasis, name)(*args)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), name
