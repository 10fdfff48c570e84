"""The kernels on the inputs of fields and symmetry 0/1 on the card (marked
`cuda`, skipped without one): K1 and K10 on non-symmetric channel-pair
windows, K4/K5 on densities with same-m cross-l blocks, against their plain
versions (1e-12 x max-abs, equal bits twice, one launch per call), and SCFs
in fields on the card against the CPU.

This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_fields_cuda.py
"""

import pytest
import torch

from helfem_tpu_torch import kernels
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

TOL = 1e-12
NE = dict(Z=10, lmax=2, mmax=1, rmax=20.0, nelem=3, nnodes=8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _check_twice(name, args):
    """One launch per call and the same bits from two calls."""
    before = kernels.launches[name]
    first = _outputs(getattr(kernels, name)(*args))
    second = _outputs(getattr(kernels, name)(*args))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    return first


def _close(out, ref):
    for o, r in zip(_outputs(out), _outputs(ref)):
        assert float((o - r).abs().max()) <= TOL * float(r.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("symm", [1, 0])
def test_radial_exchange_on_channel_pair_windows_on_card(cuda_device, symm):
    """K1 on the non-symmetric windows P4[a, d] of symmetry 1 (same-m pairs)
    and 0 (all pairs), on the Coulomb and the Yukawa tables."""
    import chip_smoke as cs

    basis = AtomicBasis(**NE)
    ops = basis.build_operators(cuda_device)
    Pw = cs.pair_window_inputs(basis, ops, symm, 31)
    args = (ops.tei, ops.disjL, ops.disjm1L, ops.gidx, Pw)
    _close(_check_twice("radial_exchange", args), kernels.radial_exchange_plain(*args))
    rs = basis.build_yukawa(0.7, cuda_device)
    args = (rs.tei, rs.iL, rs.kL, ops.gidx, Pw)
    _close(_check_twice("radial_exchange", args), kernels.radial_exchange_pairwise_plain(*args))


@pytest.mark.cuda
def test_erfc_exchange_on_channel_pair_windows_on_card(cuda_device):
    import chip_smoke as cs

    basis = AtomicBasis(**NE)
    ops = basis.build_operators(cuda_device)
    rs = basis.build_erfc(0.4, cuda_device)
    args = (rs.tei, ops.gidx, cs.pair_window_inputs(basis, ops, 1, 37))
    _close(_check_twice("radial_erfc_exchange", args), kernels.radial_erfc_exchange_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("ns", [1, 2])
def test_xc_kernels_on_cross_l_densities_on_card(cuda_device, ns):
    """K4/K5 on the Ne field grid with densities dense over the same-m
    shell pairs (l != l' included)."""
    import chip_smoke as cs

    for name, (args, _, _) in cs.atomic_xc_inputs("ne_l2", cuda_device, ns).items():
        _close(_check_twice(name, args), getattr(kernels, name + "_plain")(*args))


def _same_scf(gpu, cpu):
    assert gpu.converged, "the card's SCF did not converge"
    assert abs(gpu.E - cpu.E) < 1e-10, f"E card - CPU = {gpu.E - cpu.E:+.3e}"
    assert gpu.niter == cpu.niter, f"{gpu.niter} iterations, the CPU {cpu.niter}"


# each threshold between the CPU's last two DIIS errors, a factor 2.5 or
# more from each (the count must not hang on the last bits)
@pytest.mark.cuda
@pytest.mark.parametrize("nel, thr, kw", [
    ((5, 5), 1.5e-8, dict(Ez=0.01)),
    ((5, 5), 1.5e-8, dict(Ez=0.01, symmetry=0)),
    ((2, 1), 2.5e-8, dict(Ez=0.01, method="LC-LDA")),
    ((3, 1), 2e-8, dict(Bz=0.2, symmetry=1)),
], ids=["ne_ez", "ne_symmetry0", "li_lc_lda_ez", "b_bz"])
def test_atomic_scf_in_fields_on_card_matches_cpu(cuda_device, nel, thr, kw):
    """Dense exchange on the card: K1 (and K10) once per Fock build for both
    spins, the CPU's energy within 1e-10 Eh in its iteration count."""
    cfg = dict(NE, Z=sum(nel))
    cpu = scf_atom(AtomicBasis(**cfg), *nel, convthr=thr, device="cpu", **kw)
    kernels.reset_launches()
    gpu = scf_atom(AtomicBasis(**cfg), *nel, convthr=thr, device=cuda_device, **kw)
    _same_scf(gpu, cpu)
    assert kernels.launches["radial_exchange"] == gpu.niter
    assert kernels.launches["radial_coulomb"] == gpu.niter
    erfc = kw.get("method") == "LC-LDA"
    assert kernels.launches["radial_erfc_exchange"] == (gpu.niter if erfc else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nel, thr, kw", [((1, 1), 2e-8, dict(Ez=0.01)),
                                         ((1, 0), 1e-10, dict(Bz=0.1, Ez=0.01))],
                         ids=["h2_ez", "h2p_bz_ez"])
def test_diatomic_scf_in_fields_on_card_matches_cpu(cuda_device, nel, thr, kw):
    """K3 and K6 on the merged g/u blocks of Ez: once per iteration (K6
    once per spin with electrons, once when restricted), the CPU's energy
    within 1e-10 Eh."""
    cfg = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4, 4), rmax=15.0, nelem=3, nnodes=8)
    cpu = scf_diatomic(DiatomicBasis(**cfg), *nel, convthr=thr, device="cpu", **kw)
    kernels.reset_launches()
    gpu = scf_diatomic(DiatomicBasis(**cfg), *nel, convthr=thr, device=cuda_device, **kw)
    _same_scf(gpu, cpu)
    assert kernels.launches["radial_coulomb_dia"] == gpu.niter
    spins = 1 if gpu.orbs_b is None else 1 + (nel[1] > 0)  # restricted: K once
    assert kernels.launches["radial_exchange_dia_occ"] == gpu.niter * spins
