"""The port's diatomic field operators, finite nuclei and SCFs in fields
against helfem_tpu on the CPU.

Tolerances: the field operators and the finite-nucleus attraction within
1e-12 x max-abs; converged SCF energies and Efield within 1e-9 Eh in
helfem_tpu's iteration counts."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models.diatomic import DiatomicBasis as JaxBasis
from helfem_tpu.models.diatomic_tools import finite_nucleus_Vnuc as jax_finite_nucleus_Vnuc
from helfem_tpu.scf import diatomic_scf as jax_scf
from helfem_tpu_torch.cli.diatomic import main
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.models.diatomic_tools import finite_nucleus_Vnuc
from helfem_tpu_torch.scf import diatomic_scf
from helfem_tpu_torch.utils.checkpoint import load_diatomic

TOL = 1e-12
SCF_TOL = 1e-9
H2P = dict(Z1=1, Z2=1, Rbond=2.0, lmax=(4, 4), rmax=20.0, nelem=4, nnodes=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread and one BLAS thread for this module (the test
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.fixture(scope="module")
def bases():
    return DiatomicBasis(**H2P), JaxBasis(**H2P)


@pytest.mark.parametrize("op", ["dipole_z", "quadrupole_zz", "Bz_field"])
def test_field_operators_match_jax(bases, op):
    b, jb = bases
    call = (lambda x: x.Bz_field(0.7)) if op == "Bz_field" else (lambda x: getattr(x, op)())
    _close(call(b), call(jb))


@pytest.mark.parametrize("model, R1, R2", [("gaussian", 0.01, 0.02), ("spherical", 0.01, 0.01),
                                           ("hollow", 0.02, 0.01), ("regularized", 2.0, 3.0)])
def test_finite_nucleus_matches_jax(bases, model, R1, R2):
    b, jb = bases
    _close(finite_nucleus_Vnuc(b, model, R1, R2), jax_finite_nucleus_Vnuc(jb, model, R1, R2))


def test_ez_drops_the_parity_blocks(bases):
    """Under Ez the g/u blocks merge: one block per m."""
    b, _ = bases
    ops = b.build_operators("cpu", parity=False)
    assert ops.blk_idx.shape[0] == len(set(b.mval.tolist()))
    assert b.build_operators("cpu").blk_idx.shape[0] == 2 * ops.blk_idx.shape[0]


SCF_CASES = {
    "H2+ Ez": (H2P, (1, 0), dict(Ez=0.01)),
    "H2+ Qzz": (H2P, (1, 0), dict(Qzz=0.01)),
    "H2+ Bz": (H2P, (1, 0), dict(Bz=0.1)),
    "H2+ gaussian": (H2P, (1, 0), dict(finitenuc="gaussian", Rrms1=0.01, Rrms2=0.02)),
    "H2+ Ez Bz gaussian": (H2P, (1, 0), dict(Ez=0.01, Bz=0.1, finitenuc="gaussian",
                                             Rrms1=0.01, Rrms2=0.01)),
    "H2 UHF Ez Bz": (H2P, (1, 1), dict(Ez=0.01, Bz=0.05)),
    "H2 PBE Ez": (H2P, (1, 1), dict(Ez=0.01, method="PBE")),
}


@pytest.fixture(scope="module")
def jax_refs():
    """helfem_tpu's SCF of each case, solved once."""
    return {label: jax_scf.scf_diatomic(JaxBasis(**cfg), *nel, convthr=1e-9, **kw)
            for label, (cfg, nel, kw) in SCF_CASES.items()}


@pytest.mark.parametrize("label", list(SCF_CASES))
def test_scf_in_fields_matches_jax(jax_refs, label):
    cfg, nel, kw = SCF_CASES[label]
    ref = jax_refs[label]
    got = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), *nel, convthr=1e-9, device="cpu",
                                    **kw)
    assert ref.converged and got.converged
    assert got.niter == ref.niter
    assert abs(got.E - ref.E) < SCF_TOL
    assert abs(got.Efield - ref.Efield) < SCF_TOL
    assert (got.orbs_b is None) == (ref.orbs_b is None)
    if "Bz" in kw:
        assert got.orbs_b is not None  # no restricted run in a magnetic field


def test_cli_field_flags(capsys):
    """The diatomic CLI's --Ez/--Qzz/--Bz/--finitenuc/--Rrms1/--Rrms2 reach
    scf_diatomic, on the parity-free blocks under Ez."""
    argv = ["--Z1", "H", "--Z2", "H", "--Rbond", "2.0", "--lmax", "4,4", "--Rmax", "20",
            "--nelem", "4", "--nnodes", "8", "--Q", "1", "--convthr", "1e-9", "--Ez", "0.01",
            "--Qzz", "0.02", "--Bz", "0.1", "--finitenuc", "gaussian", "--Rrms1", "0.01",
            "--Rrms2", "0.01", "--device", "cpu"]
    res = main(argv)
    ref = jax_scf.scf_diatomic(JaxBasis(**H2P), 1, 0, convthr=1e-9, Ez=0.01, Qzz=0.02, Bz=0.1,
                               finitenuc="gaussian", Rrms1=0.01, Rrms2=0.01)
    assert res.converged and abs(res.E - ref.E) < SCF_TOL and res.niter == ref.niter
    assert "with 1+0 electrons" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--maverage --save h2.npz", "--readocc 1 --load h2.npz",
                                  "--symmetry 1 --ndev 1", "--diag 0 --save h2.npz"],
                         ids=["--maverage", "--readocc", "--symmetry 1", "--diag 0"])
def test_cli_unported_flags_still_raise(tmp_path, monkeypatch, flag):
    """The SCF-control flags run (tests/test_torch_scf_controls.py), in Ez:
    beside --ndev 1 (tests/test_torch_parallel.py) within 1e-9 Eh of the same
    run without it; beside the checkpoint flags the --save file loads back
    with the run's energy, and --load (with --readocc 1 and occs.dat's one
    block) warm-starts from one written before it."""
    monkeypatch.chdir(tmp_path)
    h2 = ["--Z1", "H", "--Z2", "H", "--Rbond", "2.0", "--lmax", "2", "--nelem", "2", "--Ez",
          "0.01", "--device", "cpu"]
    if "--ndev" in flag:
        res = main(h2 + flag.split())
        ref = main(h2 + flag.split()[:-2])
        assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
        return
    (tmp_path / "occs.dat").write_text("1 1\n")
    if "--load" in flag:
        main(h2 + ["--save", "h2.npz"])
    res = main(h2 + flag.split())
    basis, d = load_diatomic("h2.npz")
    assert res.converged and basis.nbf == DiatomicBasis(Z1=1, Z2=1, Rbond=2.0, lmax=(2,),
                                                        nelem=2, nnodes=15).nbf
    if "--save" in flag:
        assert float(d["E"]) == res.E and np.array_equal(d["orbs_a"], res.orbs_a)
    else:
        assert abs(float(d["E"]) - res.E) < 1e-9
