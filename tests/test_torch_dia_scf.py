"""The port's diatomic PBE SCF against helfem_tpu's scf_diatomic on the same
basis (core guess, converged energies within 1e-9 Eh, orbital energies
within 1e-7), and the port's diatomic CLI on the CPU with its rejection of
unported flags, methods and options."""

import numpy as np
import pytest

from helfem_tpu.models.diatomic import DiatomicBasis as JaxBasis
from helfem_tpu.scf import diatomic_scf as jax_scf
from helfem_tpu_torch.cli.diatomic import main
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf import diatomic_scf

CASES = {
    "H2": (dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=5), 1),
    "N2": (dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5), 7),
}
N2_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "2,2", "--nelem", "3",
          "--nnodes", "5", "--Rmax", "15", "--method", "PBE", "--convthr", "1e-9"]
N2_JAX = -79.449353410152  # helfem_tpu scf_diatomic on the same basis


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


@pytest.mark.parametrize("extra, error, match", [
    (["--method", "LC-LDA"], ValueError, "LC-LDA' is range-separated"),
    (["--method", "sr-pbe0"], ValueError, "sr-pbe0' is range-separated"),
    (["--Q", "1", "--readocc", "1", "--save", "n2.npz"], NotImplementedError, "--save"),
    (["--Ez", "0.01", "--maverage", "--load", "n2.npz"], NotImplementedError, "--load"),
    (["--ndev", "2"], NotImplementedError, "--ndev"),
    (["--restricted", "0", "--Bz", "0.1", "--diag", "0", "--ndev", "1"], NotImplementedError,
     "--ndev"),
], ids=["range_separated", "sr_hybrid", "open_shell", "field_flag", "ndev_flag",
        "uhf_flag"])
def test_cli_unported_raises(extra, error, match):
    """Unported flags (the checkpoints' --save/--load, --ndev) raise
    NotImplementedError (the field and SCF-control flags run,
    tests/test_torch_dia_fields.py, tests/test_torch_scf_controls.py;
    beside an unported flag the latter raises); a range-separated method raises helfem_tpu's ValueError
    (range separation exists on atoms only)."""
    with pytest.raises(error, match=match):
        main(N2_CLI + extra + ["--device", "cpu"])


def test_cli_unknown_flag_exits():
    with pytest.raises(SystemExit):
        main(N2_CLI + ["--device", "cpu", "--no-such-flag"])


@pytest.mark.parametrize("kwargs", [
    {"Ez": 0.01, "maverage": True, "ndev": 1}, {"Bz": 0.1, "ndev": 1},
    {"restricted": 0, "Bz": 0.1, "diag": False, "save_cb": print},
    {"maverage": True, "save_cb": print}, {"diag": False, "ndev": 1}, {"ndev": 1},
    {"perturb": 0.1, "P0a": np.zeros((1, 1)), "ndev": 1},
], ids=lambda kw: next(iter(kw)))
def test_unported_options_raise(kwargs):
    """Unported options (ndev, the checkpoint hook save_cb) raise; UHF,
    perturbed guesses, fields, m-averaging, Cholesky whitening and warm
    starts run (tests/test_torch_dia_open.py, tests/test_torch_dia_fields.py,
    tests/test_torch_scf_controls.py), beside an unported option they
    still raise."""
    cfg, nel = CASES["H2"]
    with pytest.raises(NotImplementedError):
        diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), nel, nel, method="PBE",
                                  device="cpu", **kwargs)


def test_unported_basis_paths_raise():
    """The basis's field operators, which raised before they were ported,
    agree with helfem_tpu's within 1e-12 x max-abs."""
    basis, jbasis = DiatomicBasis(**CASES["H2"][0]), JaxBasis(**CASES["H2"][0])
    for name, args in (("dipole_z", ()), ("quadrupole_zz", ()), ("Bz_field", (0.1,))):
        got, ref = getattr(basis, name)(*args), getattr(jbasis, name)(*args)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max(), name
