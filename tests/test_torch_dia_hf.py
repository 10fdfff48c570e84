"""The port's diatomic Hartree-Fock and PBE0 SCF against helfem_tpu's
scf_diatomic on the same basis (core guess; total energy and exact-exchange
energy within 1e-9 Eh), the two exchange routes of make_dia_fock, the selector
of the occupied columns, and the port's diatomic CLI with --method HF on the
CPU."""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models.diatomic import DiatomicBasis as JaxBasis
from helfem_tpu.scf import diatomic_scf as jax_scf
from helfem_tpu_torch.cli.diatomic import main
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf import diatomic_scf
from helfem_tpu_torch.utils.linalg import density_blocks, eig_blocks

CASES = {
    "H2": (dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=5), 1),
    "N2": (dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5), 7),
}
N2_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "2,2", "--nelem", "3",
          "--nnodes", "5", "--Rmax", "15", "--convthr", "1e-9"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the SCFs are streams of small ops,
    and the test workers share the machine's cores. BLAS gets one thread too:
    each worker's own pool of a thread per core would spin against the others'
    (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def references():
    """helfem_tpu's converged results, one SCF per (method, molecule)."""
    cache = {}

    def get(method, molecule):
        if (method, molecule) not in cache:
            cfg, nel = CASES[molecule]
            cache[method, molecule] = jax_scf.scf_diatomic(
                JaxBasis(**cfg), nel, nel, method=method, convthr=1e-9, guess="core")
        return cache[method, molecule]

    return get


@pytest.mark.parametrize("molecule", list(CASES))
@pytest.mark.parametrize("method", ["HF", "PBE0"])
def test_energy_matches_jax(references, method, molecule):
    cfg, nel = CASES[molecule]
    ref = references(method, molecule)
    got = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), nel, nel, method=method,
                                    convthr=1e-9, device="cpu")
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert abs(got.Exx - ref.Exx) < 1e-9 and got.Exx < 0.0
    for comp in ("Ekin", "Enucattr", "Ecoul", "Exc"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-7, comp
    assert np.abs(got.orbE_a[:nel + 2] - ref.orbE_a[:nel + 2]).max() < 1e-7
    if method == "HF":  # pure HF builds no grid
        assert got.Exc == 0.0 and got.Nelgrid == 0.0
    else:
        assert abs(got.Nelgrid - 2 * nel) < 1e-6


def test_cli_hf_is_the_default_and_runs_on_cpu(references, capsys):
    res = main(N2_CLI + ["--device", "cpu"])  # --method defaults to HF
    out = capsys.readouterr().out
    ref = references("HF", "N2")
    assert res.converged and abs(res.E - ref.E) < 1e-9
    assert "Running HF" in out and "(fused)" in out
    assert f"Exact exchange        energy: {res.Exx: .16f}"[:45] in out
    explicit = main(N2_CLI + ["--method", "HF", "--device", "cpu"])
    assert abs(explicit.E - res.E) < 1e-12


def test_cli_pbe0_runs_on_cpu(references):
    res = main(N2_CLI + ["--method", "PBE0", "--device", "cpu"])
    assert res.converged and abs(res.E - references("PBE0", "N2").E) < 1e-9


@pytest.fixture(scope="module")
def core_state():
    cfg, nel = CASES["N2"]
    basis = DiatomicBasis(**cfg)
    ops = basis.build_operators("cpu")
    E, C = eig_blocks(ops.H0, ops.blk_idx, ops.blk_sinvh)
    occ = diatomic_scf.aufbau_blocks(E.numpy(), nel)
    return basis, ops, C, occ


def test_occupied_columns_reproduce_the_density(core_state):
    _, ops, C, occ = core_state
    sel = diatomic_scf.occ_select(occ, "cpu")
    assert sel[2].shape[0] == int((occ > 0).sum())  # the exact count, no padding
    Co = diatomic_scf.occupied_dia(ops, C, sel)
    Pa = density_blocks(C, torch.tensor(occ), ops.blk_idx, ops.S)
    assert float((Co @ Co.T - Pa).abs().max()) < 1e-13 * float(Pa.abs().max())


@pytest.mark.parametrize("kfrac", [1.0, 0.25])
def test_fock_exchange_routes_agree(core_state, kfrac):
    """make_dia_fock with the occupied columns and with the density alone."""
    basis, ops, C, occ = core_state
    Co = diatomic_scf.occupied_dia(ops, C, diatomic_scf.occ_select(occ, "cpu"))
    Pa = density_blocks(C, torch.tensor(occ), ops.blk_idx, ops.S)
    fock = diatomic_scf.make_dia_fock((), kfrac, njbd=basis.njbd)
    a = fock(ops, None, Pa, Pa, Co)
    b = fock(ops, None, Pa, Pa)
    assert a[1] is a[0]  # restricted: Fb is Fa
    assert float((a[0] - b[0]).abs().max()) < 1e-12 * float(b[0].abs().max())
    assert abs(float(a[5]) - float(b[5])) < 1e-12 * abs(float(b[5]))
    assert float(a[5]) < 0.0 and float(a[6]) == 0.0 and float(a[7]) == 0.0
    # Exx = <Pa, Ka> with Ka = kfrac K(Pa)
    J_only = diatomic_scf.make_dia_fock((), 0.0, njbd=basis.njbd)(ops, None, Pa, Pa)
    assert abs(float(a[5]) - float(((a[0] - J_only[0]) * Pa).sum())) < 1e-12


@pytest.mark.parametrize("method", ["LC-LDA", "sr-PBE0"])
def test_range_separated_methods_raise(method):
    """Range separation exists on atoms only: scf_diatomic raises
    helfem_tpu's ValueError (parse_method's)."""
    cfg, nel = CASES["H2"]
    with pytest.raises(ValueError, match="is range-separated"):
        diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), nel, nel, method=method, device="cpu")


def test_open_shell_hf_raises():
    """Open shells run (tests/test_torch_dia_open.py), in a magnetic field
    too (tests/test_torch_dia_fields.py), with Fock m-averaging as well
    (tests/test_torch_scf_controls.py), and over a device mesh (ndev,
    tests/test_torch_parallel.py): H2+ in Bz with m-averaging on one rank
    lands within 1e-9 Eh of the same call without ndev."""
    cfg, _ = CASES["H2"]
    kw = dict(method="HF", device="cpu", Bz=0.1, maverage=True)
    res = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), 1, 0, ndev=1, **kw)
    ref = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), 1, 0, **kw)
    assert res.converged and ref.converged and abs(res.E - ref.E) < 1e-9
