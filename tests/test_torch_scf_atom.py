"""Port's restricted-HF SCF against helfem_tpu's scf_atom on the same basis
(converged energies within 1e-9 Eh), and its SCF building blocks against
their JAX counterparts."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models.atomic import AtomicBasis as JaxBasis
from helfem_tpu.scf import atomic_scf as jax_scf
from helfem_tpu.scf.diatomic_scf import _aufbau_blocks as jax_dia_aufbau
from helfem_tpu.scf.diis import device_diis_step as jax_diis_step
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.scf import atomic_scf, common
from helfem_tpu_torch.scf.diis import device_diis_step
from helfem_tpu_torch.utils.checkpoint import load_atomic, save_atomic

CASES = {
    "He": (dict(Z=2, lmax=0, mmax=0, rmax=40.0, nelem=5, nnodes=8), 1),
    "Ne": (dict(Z=10, lmax=1, mmax=1, rmax=40.0, nelem=5, nnodes=8), 5),
}


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


@pytest.mark.parametrize("atom", list(CASES))
def test_rhf_energy_matches_jax(atom):
    cfg, nel = CASES[atom]
    ref = jax_scf.scf_atom(JaxBasis(**cfg), nel, nel, convthr=1e-10)
    got = atomic_scf.scf_atom(AtomicBasis(**cfg), nel, nel, convthr=1e-10, device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert np.abs(got.orbE_a[:nel] - ref.orbE_a[:nel]).max() < 1e-7
    assert sorted(got.orbsym_a[:nel]) == sorted(ref.orbsym_a[:nel])  # degenerate p(m) order is free
    for comp in ("Ekin", "Enuc", "Ecoul", "Exx"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-7, comp


def test_rhf_energy_matches_jax_with_the_xe_cli_options():
    """The options of the Xe HF path (chip_smoke.py's XE_CLI: lmax = mmax =
    3, zexp 2.5, the TF guess, convthr 1e-9) at a small closed shell, Ne on
    four elements: the port's energy within 1e-9 Eh of helfem_tpu's."""
    cfg = dict(Z=10, lmax=3, mmax=3, rmax=40.0, nelem=4, nnodes=8, zexp=2.5)
    ref = jax_scf.scf_atom(JaxBasis(**cfg), 5, 5, convthr=1e-9, guess="TF")
    got = atomic_scf.scf_atom(AtomicBasis(**cfg), 5, 5, convthr=1e-9, guess="TF",
                              device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9


def test_aufbau_matches_jax():
    rng = np.random.default_rng(21)
    E = np.sort(rng.standard_normal((4, 6)), axis=1)
    E[1, 0] = E[2, 0] = E[3, 0] = E[0, 1]  # a degenerate p-like shell
    for nel in (1, 2, 3.5, 5, 9):
        got = common.aufbau_blocks(E, nel)
        # one aufbau serves both drivers: it matches helfem_tpu's atomic and
        # diatomic ones, degenerate levels included
        assert np.array_equal(got, jax_scf.aufbau_blocks(E, nel))
        assert np.array_equal(got, jax_dia_aufbau(E, nel))


def test_diis_error_blocks_matches_jax():
    rng = np.random.default_rng(22)
    Fb, Pb, Sb, Sh = (rng.standard_normal((3, 5, 5)) for _ in range(4))
    ref = np.asarray(jax_scf._diis_error_blocks(*(jnp.asarray(x) for x in (Fb, Pb, Sb, Sh))))
    got = common.diis_error_blocks(*(torch.tensor(x) for x in (Fb, Pb, Sb, Sh))).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("count", [0, 3, 12])
def test_device_diis_step_matches_jax(count):
    """Same history and new entry -> same extrapolated Fock (the port
    updates the history in place)."""
    rng = np.random.default_rng(23 + count)
    H, nerr = 10, 18
    histF = rng.standard_normal((H, 2, 3, 3))
    histE = rng.standard_normal((H, nerr))
    F = rng.standard_normal((2, 3, 3))
    err = 1e-3 * rng.standard_normal(nerr)
    Fj, hFj, hEj, cj = jax_diis_step(jnp.asarray(histF), jnp.asarray(histE),
                                     jnp.asarray(count), jnp.asarray(F), jnp.asarray(err))
    hF, hE = torch.tensor(histF), torch.tensor(histE)
    Ft, ct = device_diis_step(hF, hE, count, torch.tensor(F), torch.tensor(err))
    assert ct == int(cj)
    assert np.array_equal(hF.numpy(), np.asarray(hFj))
    assert np.array_equal(hE.numpy(), np.asarray(hEj))
    assert np.abs(Ft.numpy() - np.asarray(Fj)).max() <= 1e-10 * np.abs(np.asarray(Fj)).max()


@pytest.mark.parametrize("nel, kwargs", [
    # symmetry 0/1, range separation there and fields run
    # (tests/test_torch_fields.py), and so do eigiter, maverage, perturb and
    # diag (tests/test_torch_scf_controls.py), beside ndev too
    # (tests/test_torch_parallel.py) but for range separation, which ndev
    # refuses as helfem_tpu's does. The checkpoint hook save_cb runs beside them
    ((1, 1), {"method": "LDAERF", "symmetry": 1, "eigiter": 4, "ndev": 1}),
    ((1, 1), {"method": "LC-LDA", "symmetry": 0, "maverage": True, "save_cb": "npz"}),
    ((1, 1), {"symmetry": 1, "perturb": 0.1, "ndev": 1}),
    ((1, 1), {"Ez": 0.01, "diag": False, "save_cb": "npz"}),
    ((1, 1), {"ndev": 1}),
    ((1, 1), {"eigiter": 4, "save_cb": "npz"}),
    ((1, 1), {"maverage": True, "ndev": 2}),
], ids=["ldaerf", "lc-lda", "symm1", "field", "ndev", "eigiter", "maverage"])
def test_unported_options_raise(tmp_path, nel, kwargs):
    """ndev runs to the energy of the same call without it, within 1e-9 Eh,
    and raises helfem_tpu's reason for range separation; save_cb sees the
    two host iterations, then rising ones up to the run's last, and the npz
    file it writes (as the atomic CLI's hook does) loads back with the
    run's energy and orbitals."""
    basis = AtomicBasis(Z=sum(nel), lmax=0, mmax=0, rmax=20.0, nelem=2, nnodes=4)
    if "ndev" in kwargs:
        if kwargs.get("method") == "LDAERF":
            with pytest.raises(NotImplementedError, match="--ndev does not support "
                                                          "range-separated exchange yet"):
                atomic_scf.scf_atom(basis, *nel, device="cpu", **kwargs)
            return
        res = atomic_scf.scf_atom(basis, *nel, device="cpu", **kwargs)
        ref = atomic_scf.scf_atom(basis, *nel, device="cpu",
                                  **{k: v for k, v in kwargs.items() if k != "ndev"})
        assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
        return
    path, seen = str(tmp_path / "he.npz"), []

    def save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb):
        state = types.SimpleNamespace(converged=False, E=Etot, orbE_a=np.sort(Ea.ravel()),
                                      orbs_a=Ca, occ_a=occa, orbE_b=None, orbs_b=None,
                                      occ_b=None)
        save_atomic(path, basis, state)
        seen.append(it)

    res = atomic_scf.scf_atom(basis, *nel, device="cpu", **dict(kwargs, save_cb=save_cb))
    _, d = load_atomic(path)
    assert res.converged and seen[:2] == [1, 2] and seen == sorted(set(seen))
    assert seen[-1] == res.niter and float(d["E"]) == res.E
    assert np.array_equal(d["orbs_a"], res.orbs_a)
