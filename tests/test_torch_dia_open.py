"""Port's open-shell diatomic SCF (UHF, UKS, ROHF, restricted=0 and perturbed
guesses, one-electron H2+) against helfem_tpu's scf_diatomic on the CPU.

Tolerances: the two-spin Fock matrices within 1e-12 x max-abs of
helfem_tpu's on the same densities, their energies within 1e-12 relative;
converged SCF energies within 1e-9 Eh, with the same iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.models.diatomic import DiatomicBasis as JaxBasis
from helfem_tpu.models.diatomic_dft import build_dia_grid as jax_grid
from helfem_tpu.ops.xc import parse_method as jax_parse_method
from helfem_tpu.scf import diatomic_scf as jax_scf
from helfem_tpu.utils.linalg import form_sinvh as jax_form_sinvh
from helfem_tpu_torch.models.diatomic import DiatomicBasis, exchange_dia_occ
from helfem_tpu_torch.models.diatomic_dft import build_dia_grid
from helfem_tpu_torch.ops.xc import parse_method
from helfem_tpu_torch.scf import diatomic_scf
from helfem_tpu_torch.scf.common import aufbau_blocks
from helfem_tpu_torch.utils.linalg import build_blocks, density_blocks, eig_blocks

TOL = 1e-12
O2 = dict(Z1=8, Z2=8, Rbond=2.282, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
BEH = dict(Z1=4, Z2=1, Rbond=2.537, lmax=(3, 3), rmax=20.0, nelem=3, nnodes=6)
H2 = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=6)
H2P = dict(Z1=1, Z2=1, Rbond=2.0, lmax=(4,), rmax=15.0, nelem=3, nnodes=6)
# chip_smoke.py's lmax=12 bases (nbf 4130): O2 UHF's and N2 HF's
L12 = {"o2": dict(Z1=8, Z2=8, Rbond=2.282), "n2": dict(Z1=7, Z2=7, Rbond=2.068)}
# label -> (basis, nela, nelb, scf_diatomic options)
SCF_CASES = {
    "o2_uhf": (O2, 9, 7, dict(method="HF", restricted=0)),
    "o2_uks_pbe": (O2, 9, 7, dict(method="PBE")),
    "o2_uks_pbe0": (O2, 9, 7, dict(method="PBE0")),
    "o2_rohf": (O2, 9, 7, dict(method="HF", restricted=1)),
    "beh_uhf": (BEH, 3, 2, dict(method="HF", restricted=0)),
    "beh_rohf": (BEH, 3, 2, dict(method="HF", restricted=1)),
    "h2_restricted0": (H2, 1, 1, dict(method="HF", restricted=0)),
    "h2_perturb": (H2, 1, 1, dict(method="HF", perturb=0.05, seed=1, diisorder=6)),
    "h2_uhf_perturb": (H2, 1, 1, dict(method="HF", restricted=0, perturb=0.05, seed=1)),
    "h2p": (H2P, 1, 0, dict(method="HF")),
}


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
def solved():
    """Every case solved once by each side (core guess, convthr 1e-9)."""
    out = {}

    def get(label):
        if label not in out:
            cfg, na, nb, kw = SCF_CASES[label]
            ref = jax_scf.scf_diatomic(JaxBasis(**cfg), na, nb, convthr=1e-9, maxit=80, **kw)
            got = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), na, nb, convthr=1e-9,
                                            maxit=80, device="cpu", **kw)
            out[label] = ref, got
        return out[label]

    return get


@pytest.mark.parametrize("label", list(SCF_CASES))
def test_scf_matches_jax(solved, label):
    ref, got = solved(label)
    assert ref.converged and got.converged
    assert abs(got.E - ref.E) < 1e-9
    assert got.niter == ref.niter
    for comp in ("Ekin", "Enucattr", "Ecoul", "Exx", "Exc"):
        assert abs(getattr(got, comp) - getattr(ref, comp)) < 1e-8, comp
    assert (got.orbE_b is None) == (ref.orbE_b is None)
    if got.orbE_b is not None:
        na, nb = SCF_CASES[label][1:3]
        assert np.abs(got.orbE_a[:na + 1] - ref.orbE_a[:na + 1]).max() < 1e-7
        assert np.abs(got.orbE_b[:nb + 1] - ref.orbE_b[:nb + 1]).max() < 1e-7
        assert got.occ_a.sum() == na and got.occ_b.sum() == nb
        assert np.array_equal(got.occ_a, ref.occ_a) and np.array_equal(got.occ_b, ref.occ_b)


@pytest.mark.parametrize("molecule", ["o2", "beh"])
def test_rohf_lies_above_uhf(solved, molecule):
    """ROHF is variationally above UHF, and close (test_beh_rohf's gates)."""
    uhf, rohf = solved(f"{molecule}_uhf")[1], solved(f"{molecule}_rohf")[1]
    assert rohf.E >= uhf.E - 1e-8 and rohf.E - uhf.E < 5e-2
    assert rohf.orbE_b is not None and rohf.orbs_b is not None


def test_closed_shell_uhf_and_perturbed_guess_reach_rhf(solved):
    """test_dia_scf_control_knobs's restricted=0 and perturb legs: the same
    H2 HF energy as the restricted SCF."""
    e_ref = diatomic_scf.scf_diatomic(DiatomicBasis(**H2), 1, 1, convthr=1e-9,
                                      device="cpu").E
    for label in ("h2_restricted0", "h2_perturb", "h2_uhf_perturb"):
        assert abs(solved(label)[1].E - e_ref) < 1e-8, label


def test_h2_cation_exchange_cancels_self_interaction(solved):
    """One electron: the exchange cancels the Coulomb self-interaction and
    beta, with no electron, has no exchange at all."""
    _, got = solved("h2p")
    assert abs(got.Exx + got.Ecoul) < 1e-12 * got.Ecoul
    assert got.occ_b.sum() == 0 and got.occ_a.sum() == 1
    ops = DiatomicBasis(**H2P).build_operators("cpu")
    K = exchange_dia_occ(ops, torch.zeros((ops.S.shape[0], 0), dtype=torch.float64))
    assert K.shape == ops.S.shape and not K.any()


def _spin_state(cfg, na, nb):
    """Port and JAX operators of cfg and two different spin densities, with
    their occupied columns, from the core guess's aufbau."""
    basis, jbasis = DiatomicBasis(**cfg), JaxBasis(**cfg)
    ops, jops = basis.build_operators("cpu"), jbasis.build_operators()
    E, C = eig_blocks(ops.H0, ops.blk_idx, ops.blk_sinvh)
    occ = [aufbau_blocks(E.numpy(), n) for n in (na, nb)]
    P = [density_blocks(C, torch.tensor(o), ops.blk_idx, ops.S) for o in occ]
    Co = [diatomic_scf.occupied_dia(ops, C, diatomic_scf.occ_select(o, "cpu")) for o in occ]
    return basis, jbasis, ops, jops, P, Co


@pytest.mark.parametrize("method", ["HF", "PBE", "PBE0"])
def test_two_spin_fock_matches_jax(method):
    """make_dia_fock for two spins (K3 once on Pa + Pb, K6 per spin from its
    occupied columns, K4/K5 for both spins) against helfem_tpu's
    make_dia_fock with restricted=False on the same densities."""
    basis, jbasis, ops, jops, (Pa, Pb), (Coa, Cob) = _spin_state(O2, 9, 7)
    funcs, kfrac = parse_method(method)
    jfuncs, jkfrac = jax_parse_method(method)
    g = build_dia_grid(basis, "cpu") if funcs else None
    jg = jax_grid(jbasis) if funcs else None
    got = diatomic_scf.make_dia_fock(tuple(funcs), kfrac, njbd=basis.njbd)(
        ops, g, Pa, Pb, Coa, Cob)
    ref = jax_scf.make_dia_fock(tuple(jfuncs), jkfrac, njbd=jbasis.njbd)(
        jops, jg, jnp.asarray(Pa.numpy()), jnp.asarray(Pb.numpy()))
    for name, a, b in zip(("Fa", "Fb"), got[:2], ref[:2]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= TOL * np.abs(b).max(), name
    assert float((got[0] - got[1]).abs().max()) > 1e-3  # the spins differ
    for name, a, b in zip(("Ekin", "Enuc", "Ecoul", "Exx", "Exc", "Nel"), got[2:], ref[2:]):
        assert abs(float(a) - float(b)) <= TOL * max(abs(float(b)), 1.0), name


def _whitening_defect(Sinvh: np.ndarray, S: np.ndarray) -> float:
    return float(np.abs(Sinvh.T @ S @ Sinvh - np.eye(len(S))).max())


@pytest.mark.parametrize("mol", list(L12))
def test_lmax12_whitening_matches_jax(mol):
    """The lmax=12 bases of chip_smoke.py's O2 UHF and N2 HF cells have
    overlap blocks with condition numbers near 1e12. S^-1/2 whitens them
    only to ~1e-6 (max |Sinvh^T S Sinvh - I|), so tr(P S) counts the
    electrons only to ~1e-9, whatever the SCF. The port's overlap equals
    helfem_tpu's within 1e-12 x max-abs; the port's host S^-1/2 per block
    (build_blocks) whitens within 10x of helfem_tpu's form_sinvh on the same
    blocks, and helfem_tpu's own defect is above 1e-8. Run with -s to print
    the defects and the largest condition number."""
    cfg = dict(L12[mol], lmax=(12, 12, 12), rmax=40.0, nelem=5, nnodes=15)
    basis, jbasis = DiatomicBasis(**cfg), JaxBasis(**cfg)
    S, jS = basis.overlap(), np.asarray(jbasis.overlap())
    assert np.abs(S - jS).max() <= TOL * np.abs(jS).max()
    blocks = basis.sym_blocks()
    _, blk_sinvh = build_blocks(S, blocks)
    port = max(_whitening_defect(blk_sinvh[i, :len(idx), :len(idx)], S[np.ix_(idx, idx)])
               for i, idx in enumerate(blocks))
    ref = max(_whitening_defect(jax_form_sinvh(jS[np.ix_(idx, idx)]), jS[np.ix_(idx, idx)])
              for idx in jbasis.sym_blocks())
    cond = max(np.linalg.cond(S[np.ix_(idx, idx)]) for idx in blocks)
    print(f"{mol} lmax=12 (nbf {basis.nbf}): whitening defect port {port:.3e}, helfem_tpu "
          f"{ref:.3e}; largest block condition number {cond:.3e}")
    assert port <= 10 * ref
    assert ref > 1e-8
