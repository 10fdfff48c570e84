"""The port's SCF controls, the SAD atom's nuclear models and confinement,
the CLI gaps and the post-SCF analysis against helfem_tpu on the CPU.

Tolerances: whitening and operators within 1e-12 x max-abs; the
eigensolvers' eigenvalues within 1e-10 (ARPACK's random start: energies,
not vectors); converged energies within 1e-9 Eh in helfem_tpu's iteration
counts; the analysis values within 1e-10 relative (a multipole that
vanishes by symmetry within 1e-10 of the molecule's scale)."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch
from threadpoolctl import threadpool_limits

from helfem_tpu.cli import atomic as jax_atomic_cli
from helfem_tpu.cli import diatomic as jax_dia_cli
from helfem_tpu.cli import gensap as jax_gensap_cli
from helfem_tpu.models import diatomic_tools as jtools
from helfem_tpu.models import sadatom as jsad
from helfem_tpu.models.atomic import AtomicBasis as JaxBasis
from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiaBasis
from helfem_tpu.scf import atomic_scf as jax_scf
from helfem_tpu.scf import diatomic_scf as jax_dia_scf
from helfem_tpu.utils import linalg as jlinalg
from helfem_tpu_torch.cli import atomic as atomic_cli
from helfem_tpu_torch.cli import diatomic as dia_cli
from helfem_tpu_torch.cli import gensap as gensap_cli
from helfem_tpu_torch.models import diatomic_tools as tools
from helfem_tpu_torch.models import sadatom
from helfem_tpu_torch.models.atomic import AtomicBasis
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf import atomic_scf, diatomic_scf
from helfem_tpu_torch.utils import linalg

TOL = 1e-12
EIG_TOL = 1e-10
SCF_TOL = 1e-9
ANA_TOL = 1e-10


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """The atomic CLI writes its checkpoint (helfem.npz by default) into the
    working directory: each test runs in its own."""
    monkeypatch.chdir(tmp_path)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread and one BLAS thread for this module: the SCFs are
    streams of small ops, and the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _close_values(got: dict, ref: dict, scale: float, tol=ANA_TOL):
    """Each value within tol relative, or within tol x scale where the
    reference vanishes by symmetry."""
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= tol * max(abs(ref[k]), scale), (k, got[k], ref[k])


# --- the eigensolvers (tests/test_eigensolvers.py's cases) -------------------


def _gsym_problem(n=120, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    F = (A + A.T) / 2 + np.diag(np.linspace(0.0, 50.0, n))
    B = rng.standard_normal((n, n))
    return F, B @ B.T / n + np.eye(n)


def test_cholesky_whitening_matches_jax():
    """form_sinvh_chol is helfem_tpu's L^-T (Sinvh^T S Sinvh = I, not
    symmetric), and build_blocks(chol=True) pads its blocks as helfem_tpu's."""
    _, S = _gsym_problem(40)
    X = linalg.form_sinvh_chol(S)
    _close(X, jlinalg.form_sinvh_chol(S))
    assert np.abs(X.T @ S @ X - np.eye(40)).max() < 1e-12
    assert np.abs(X - X.T).max() > 1e-3
    blocks = [np.arange(0, 15), np.arange(15, 40, 2), np.arange(16, 40, 2)]
    got, ref = linalg.build_blocks(S, blocks, chol=True), jlinalg.build_blocks(S, blocks, chol=True)
    assert np.array_equal(got[0], ref[0])
    _close(got[1], ref[1])


def test_eig_gsym_sub_rayleigh_ritz():
    """Rayleigh-Ritz in an S-orthonormal subspace: exact in the span of the
    eigenvectors, an upper bound in a perturbed one."""
    F, S = _gsym_problem(seed=2)
    Eref, Cref = sla.eigh(F, S)
    E, _ = linalg.eig_gsym_sub(torch.tensor(F), torch.tensor(Cref[:, :10]))
    assert np.abs(E.numpy() - Eref[:10]).max() < 1e-9
    C0 = Cref[:, :10] + 0.01 * np.random.default_rng(3).standard_normal((F.shape[0], 10))
    C0 = C0 @ np.linalg.inv(np.linalg.cholesky(C0.T @ S @ C0).T)
    E2, _ = linalg.eig_gsym_sub(torch.tensor(F), torch.tensor(C0))
    Ej, _ = jlinalg.eig_gsym_sub(jnp.asarray(F), jnp.asarray(C0))
    assert np.all(E2.numpy() - Eref[:10] > -1e-10)
    assert np.abs(E2.numpy() - np.asarray(Ej)).max() < EIG_TOL


def test_eig_iter_gsym_lowest():
    """LOBPCG on -F (torch.lobpcg) finds the lowest eigenpairs of a
    generalized problem, as helfem_tpu's LOBPCG does."""
    F, S = _gsym_problem()
    Sinvh = linalg.form_sinvh(S)
    Eref = sla.eigh(F, S, eigvals_only=True)
    E, C = linalg.eig_iter_gsym(torch.tensor(F), torch.tensor(Sinvh), neig=6, maxit=300,
                                tol=1e-10)
    E, C = E.numpy(), C.numpy()
    assert np.abs(E - Eref[:6]).max() < 1e-8
    assert np.abs(F @ C - S @ C @ np.diag(E)).max() < 1e-6


@pytest.fixture(scope="module")
def fock_blocks():
    """The blocks of a converged O UHF alpha Fock (lmax 1) and their
    whitening, symmetric and Cholesky."""
    basis = AtomicBasis(Z=8, lmax=1, mmax=1, rmax=30.0, nelem=5, nnodes=8)
    res = atomic_scf.scf_atom(basis, 5, 3, convthr=1e-8, device="cpu")
    ops = basis.build_operators("cpu")
    fock = atomic_scf.make_fock((), 1.0, basis.nrad)
    P = [linalg.density_blocks(torch.tensor(C), torch.tensor(o), torch.tensor(
        linalg.build_blocks(ops.S.numpy(), basis.sym_blocks(2))[0]), ops.S)
        for C, o in ((res.orbs_a, res.occ_a), (res.orbs_b, res.occ_b))]
    Fa = fock(ops, None, None, *P)[0].numpy()
    return basis, ops, Fa


@pytest.mark.parametrize("chol", [False, True], ids=["symmetric", "cholesky"])
def test_eig_blocks_iter_matches_dense(fock_blocks, chol):
    """Shift-invert ARPACK per block (--eigiter) gives the dense blocked
    eigensolve's lowest eigenvalues and helfem_tpu's, with _BIG in the
    slots it does not compute; blocks of 3 neig or fewer run dense."""
    basis, ops, Fa = fock_blocks
    bi, bs = linalg.build_blocks(ops.S.numpy(), basis.sym_blocks(2), chol=chol)
    E, C = linalg.eig_blocks_iter(Fa, bi, bs, 4, -0.6 * 64 - 10.0)
    Ed, _ = linalg.eig_blocks(torch.tensor(Fa), torch.tensor(bi), torch.tensor(bs))
    Ej, _ = jlinalg.eig_blocks_iter(Fa, bi, bs, 4, -0.6 * 64 - 10.0)
    assert np.abs(E[:, :4] - Ed.numpy()[:, :4]).max() < EIG_TOL * np.abs(Ed.numpy()[:, :4]).max()
    assert np.abs(E[:, :4] - np.asarray(Ej)[:, :4]).max() < EIG_TOL * 100
    assert (E[:, 4:] == linalg._BIG).all()
    S = ops.S.numpy()
    for b in range(bi.shape[0]):  # S-orthonormal columns
        Cb = C[b][:, :4]
        Sb = S[np.ix_(bi[b], bi[b])]
        assert np.abs(Cb.T @ Sb @ Cb - np.eye(4)).max() < 1e-10


def test_eig_gsym_lm_and_m_match_jax(fock_blocks):
    """The (l,m)-block and m-block solves of helfem_tpu, on tensors."""
    basis, ops, Fa = fock_blocks
    E, C = linalg.eig_gsym_lm(torch.tensor(Fa), ops.Sinvh_rad)
    Ej, _ = jlinalg.eig_gsym_lm(jnp.asarray(Fa), jnp.asarray(ops.Sinvh_rad.numpy()))
    _close(E.numpy(), np.asarray(Ej), EIG_TOL)
    groups = [np.nonzero(basis.mval == m)[0] for m in np.unique(basis.mval)]
    for (idx, E, C), (jidx, Ej, _) in zip(
            linalg.eig_gsym_m(torch.tensor(Fa), ops.Sinvh_rad, groups, basis.nrad),
            jlinalg.eig_gsym_m(jnp.asarray(Fa), jnp.asarray(ops.Sinvh_rad.numpy()), groups,
                               basis.nrad)):
        assert np.array_equal(idx, jidx)
        _close(E.numpy(), np.asarray(Ej), EIG_TOL)


# --- the atomic SCF options (tests/test_scf_atoms.py:47-140's cases) ----------

# one radial grid and angular basis for every case but zeroder's: helfem_tpu
# compiles its SCF once per shape and method, and Z is data
O_P = dict(Z=8, lmax=1, mmax=1, rmax=30.0, nelem=5, nnodes=8)
BE = dict(O_P, Z=4)
SCF_CASES = {
    "Be diag 0": (BE, (2, 2), dict(convthr=1e-8, diag=False)),
    "Be eigiter": (BE, (2, 2), dict(convthr=1e-8, eigiter=4, maxit=60)),
    "Be occs perturbed": (BE, (2, 2), dict(convthr=1e-8, occs={(0, 0): (2, 2)}, perturb=0.01)),
    "Be 1s2 2p2": (BE, (2, 2), dict(convthr=1e-7, occs={(0, 0): (1, 1), (1, 0): (1, 1)},
                                    maxit=80)),
    "Ne maverage": (dict(O_P, Z=10), (5, 5), dict(convthr=1e-8, maverage=True)),
    "O UHF maverage": (O_P, (5, 3), dict(convthr=1e-8, maverage=True)),
    "O UHF perturbed": (O_P, (5, 3), dict(convthr=1e-8, perturb=0.01, seed=2)),
    "O UHF p0 occs eigiter": (O_P, (5, 3), dict(
        convthr=1e-8, eigiter=6, occs={(0, 0): (2, 2), (1, 0): (1, 1), (1, 1): (1, 0),
                                       (1, -1): (1, 0)})),
    "He zeroder": (dict(O_P, Z=2, primbas=5, zeroder=True), (1, 1), dict(convthr=1e-8)),
    "H analysis": (dict(O_P, Z=1), (1, 0), dict(convthr=1e-9)),
}


@pytest.fixture(scope="module")
def jax_refs():
    """helfem_tpu's SCF and analysis of each case, solved once."""
    out = {}
    for label, (cfg, nel, kw) in SCF_CASES.items():
        basis = JaxBasis(**cfg)
        res = jax_scf.scf_atom(basis, *nel, **kw)
        out[label] = (res, jax_scf.atomic_analysis(basis, res, res.symm_used))
    return out


@pytest.mark.parametrize("label", list(SCF_CASES))
def test_scf_controls_match_jax(jax_refs, label):
    cfg, nel, kw = SCF_CASES[label]
    ref, ref_ana = jax_refs[label]
    basis = AtomicBasis(**cfg)
    got = atomic_scf.scf_atom(basis, *nel, device="cpu", **kw)
    assert ref.converged and got.converged
    assert got.niter == ref.niter
    assert abs(got.E - ref.E) < SCF_TOL
    ana = atomic_scf.atomic_analysis(basis, got, got.symm_used)
    _close_values(ana, ref_ana, ref_ana["<r^2>"])
    if "occs" in kw:
        assert np.array_equal(got.occ_a, ref.occ_a)
    if label == "H analysis":  # near the exact <r> = 3/2, n(0) = 1/pi, cusp 1
        assert abs(ana["<r^1>"] - 1.5) < 1e-6
        assert abs(ana["density_at_nucleus"] - 1 / np.pi) < 1e-6
        assert abs(ana["cusp"] - 1.0) < 1e-6
    if label == "He zeroder":
        assert basis.nrad == AtomicBasis(**{**cfg, "zeroder": False}).nrad - 1


def test_rohf_takes_the_symmetric_whitening_under_diag_0():
    """ROHF's natural orbitals need S^-1/2: under --diag 0 the port's ROHF
    settles where the symmetric whitening does (helfem_tpu's diag=True
    value within 1e-9 Eh), while helfem_tpu's, which hands rohf_update its
    Cholesky factor, lands elsewhere (a deliberate difference)."""
    basis, jbasis = AtomicBasis(**O_P), JaxBasis(**O_P)
    got = atomic_scf.scf_atom(basis, 5, 3, convthr=1e-8, restricted=1, diag=False, device="cpu")
    ref = jax_scf.scf_atom(jbasis, 5, 3, convthr=1e-8, restricted=1)
    ref_chol = jax_scf.scf_atom(jbasis, 5, 3, convthr=1e-8, restricted=1, diag=False)
    assert got.converged and ref.converged and ref_chol.converged
    assert abs(got.E - ref.E) < SCF_TOL
    print(f"O ROHF: diag 1 {ref.E:.12f}; diag 0: the port {got.E:.12f}, helfem_tpu "
          f"{ref_chol.E:.12f}")
    assert ref_chol.E - ref.E > 1e-6


def test_occs_need_lm_blocks():
    with pytest.raises(ValueError, match="fixed occupations"):
        atomic_scf.scf_atom(AtomicBasis(**BE), 2, 2, device="cpu", symmetry=1,
                            occs={(0, 0): (2, 2)})


def test_warm_start_from_a_cross_channel_density():
    """P0a from a symmetry-1 run in a field (s-p0 blocks) into a symmetry-2
    run: one Fock on all channel-pair windows, then the blocked path; also
    P0a/P0b of an unrestricted start. helfem_tpu's iteration counts and
    energies within 1e-9 Eh."""
    cfg = dict(Z=10, lmax=1, mmax=1, rmax=30.0, nelem=5, nnodes=8)
    basis, jbasis = AtomicBasis(**cfg), JaxBasis(**cfg)
    res0 = atomic_scf.scf_atom(basis, 5, 5, convthr=1e-9, Ez=0.01, device="cpu")
    bi = linalg.build_blocks(basis.overlap(), basis.sym_blocks(1))[0]
    P = linalg.density_blocks(torch.tensor(res0.orbs_a), torch.tensor(res0.occ_a),
                              torch.tensor(bi), torch.tensor(basis.overlap())).numpy()
    assert not atomic_scf._channel_bd(P, basis.nang, basis.nrad)
    for kw in (dict(P0a=P), dict(P0a=P, P0b=0.9 * P, restricted=0)):
        got = atomic_scf.scf_atom(basis, 5, 5, convthr=1e-9, device="cpu", **kw)
        ref = jax_scf.scf_atom(jbasis, 5, 5, convthr=1e-9, **kw)
        assert got.converged and ref.converged and got.symm_used == 2
        assert got.niter == ref.niter and abs(got.E - ref.E) < SCF_TOL


def test_ne_hollow_nucleus_takes_jax_iterations():
    """The device DIIS solves B with eigh_refined, as helfem_tpu's does: Ne HF
    with a hollow nucleus (Rrms 1e-3 on a 2-element sub-grid) takes
    helfem_tpu's 12 iterations at convthr 1e-9."""
    cfg = dict(Z=10, lmax=1, mmax=0, rmax=20.0, nelem=5, nnodes=8, finitenuc="hollow",
               Rrms=1e-3, nelem0=2)
    kw = dict(convthr=1e-9, finitenuc="hollow", Rrms=1e-3)
    got = atomic_scf.scf_atom(AtomicBasis(**cfg), 5, 5, device="cpu", **kw)
    ref = jax_scf.scf_atom(JaxBasis(**cfg), 5, 5, **kw)
    assert got.converged and ref.converged
    assert got.niter == ref.niter == 12
    assert abs(got.E - ref.E) < SCF_TOL


# --- the diatomic options (tests/test_diatomic.py:153-180's knobs; its
# restricted=0, perturb and diisthr cases are tests/test_torch_dia_open.py's
# and tests/test_torch_lapl.py's) ----------------------------------------------

H2 = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(4,), rmax=15.0, nelem=3, nnodes=6)
N2 = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(2, 2), rmax=15.0, nelem=3, nnodes=5)
H2_OCCS = np.array([[1.0, 1.0], [0.0, 0.0]])  # both electrons in sigma g
DIA_CASES = {
    "H2 reference": (H2, (1, 1), "HF", dict()),
    "H2 occs": (H2, (1, 1), "HF", dict(occs=H2_OCCS, readocc_until=-1, maxit=60)),
    "H2 occs until 5": (H2, (1, 1), "HF", dict(occs=H2_OCCS, readocc_until=5, maxit=60)),
    "N2 PBE maverage": (N2, (7, 7), "PBE", dict(maverage=True)),
    "N2 PBE diag 0": (N2, (7, 7), "PBE", dict(diag=False)),
    "N2+ UHF maverage diag 0": (N2, (7, 6), "HF", dict(maverage=True, diag=False)),
}


@pytest.fixture(scope="module")
def jax_dia_refs():
    out = {}
    for label, (cfg, nel, method, kw) in DIA_CASES.items():
        out[label] = jax_dia_scf.scf_diatomic(JaxDiaBasis(**cfg), *nel, method=method,
                                              convthr=1e-8, **kw)
    return out


@pytest.mark.parametrize("label", list(DIA_CASES))
def test_dia_controls_match_jax(jax_dia_refs, label):
    cfg, nel, method, kw = DIA_CASES[label]
    ref = jax_dia_refs[label]
    got = diatomic_scf.scf_diatomic(DiatomicBasis(**cfg), *nel, method=method, convthr=1e-8,
                                    device="cpu", **kw)
    assert ref.converged and got.converged
    assert got.niter == ref.niter
    assert abs(got.E - ref.E) < SCF_TOL
    if label.startswith("H2"):  # every knob reaches the same H2 ground state
        assert abs(got.E - jax_dia_refs["H2 reference"].E) < 1e-7


def test_dia_warm_start_and_tools_match_jax():
    """A warm start from N2's converged alpha density (its exchange from the
    density) and from distinct alpha/beta densities, and the post-SCF tools:
    the moments, the nuclear densities and the occupied orbitals' radial
    moments, against helfem_tpu's."""
    basis, jbasis = DiatomicBasis(**N2), JaxDiaBasis(**N2)
    ops = basis.build_operators("cpu")
    res = diatomic_scf.scf_diatomic(basis, 7, 7, convthr=1e-9, ops=ops)
    Pa = diatomic_scf.density_dia(ops, res.orbs_a, res.occ_a)
    for kw in (dict(P0a=Pa), dict(P0a=Pa, P0b=0.95 * Pa, restricted=0)):
        got = diatomic_scf.scf_diatomic(basis, 7, 7, convthr=1e-9, ops=ops, **kw)
        ref = jax_dia_scf.scf_diatomic(jbasis, 7, 7, convthr=1e-9, **kw)
        assert got.niter == ref.niter and abs(got.E - ref.E) < SCF_TOL
    P = 2.0 * Pa
    scale = float(np.abs(P).max())
    assert all(abs(g - r) <= ANA_TOL * max(abs(r), scale) for g, r in zip(
        tools.nuclear_densities_dia(basis, P), jtools.nuclear_densities_dia(jbasis, P)))
    got = tools.occupied_orbital_vectors_dia(basis, res.orbs_a, res.occ_a, res.orbE_blocks_a)
    ref = jtools.occupied_orbital_vectors_dia(jbasis, res.orbs_a, res.occ_a,
                                              res.orbE_blocks_a)
    assert [(e, o) for e, o, _ in got] == [(e, o) for e, o, _ in ref]
    for (_, _, c), (_, _, cj) in zip(got, ref):
        assert np.array_equal(c, cj)
        m, mj = tools.orbital_moments_dia(basis, c), jtools.orbital_moments_dia(jbasis, cj)
        for side in mj:
            _close_values(m[side], mj[side], 1.0)


# --- the CLIs ----------------------------------------------------------------


def _numbers(text: str, start: str) -> dict:
    """label -> value of the 'label : value' lines from the one that starts
    with `start` to the end of the block."""
    lines = text[text.index(start):].split("\n\n")[0].splitlines()
    return {line.split(":")[0].strip(): float(line.rsplit(":", 1)[1]) for line in lines}


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv)
    return res, buf.getvalue()


O_CLI = ["--Z", "O", "--M", "3", "--lmax", "1", "--mmax", "1", "--Rmax", "30", "--nelem", "5",
         "--nnodes", "8", "--iguess", "3", "--convthr", "1e-8"]


@pytest.mark.parametrize("extra", [
    ["--maverage", "--diag", "0", "--nquad", "45", "--taylor_order", "4"],
    ["--readocc", "OCCS", "--perturb", "0.01", "--seed", "2", "--eigiter", "6"],
    ["--primbas", "5", "--zeroder", "--restricted", "1"],
], ids=["maverage_diag", "readocc_perturb_eigiter", "zeroder_rohf"])
def test_atomic_cli_flags_and_analysis(tmp_path, extra):
    """The atomic CLI's SCF-control flags reach scf_atom, and the analysis
    block has helfem_tpu's lines and values; --trace writes a Chrome trace
    of the SCF."""
    occs = tmp_path / "occs.txt"
    occs.write_text("0 0 2 2\n1 0 1 1  # p0 doubly occupied\n1 1 1 0\n1 -1 1 0\n")
    extra = [str(occs) if a == "OCCS" else a for a in extra]
    trace = tmp_path / "scf.json"
    got, out = _run(atomic_cli.main, O_CLI + extra + ["--save", "", "--device", "cpu",
                                                      "--trace", str(trace)])
    ref, jout = _run(jax_atomic_cli.main, O_CLI + extra + ["--save", ""])
    assert got.converged and ref.converged and got.niter == ref.niter
    assert abs(got.E - ref.E) < SCF_TOL
    block, jblock = _numbers(out, "Virial ratio -E/T"), _numbers(jout, "Virial ratio -E/T")
    _close_values(block, jblock, jblock["<r^+2>"], 1e-9)
    assert list(block) == list(jblock)
    assert f"profiler trace written to {trace}" in out
    assert json.loads(trace.read_text())["traceEvents"]


def test_diatomic_cli_flags_and_analysis(tmp_path, monkeypatch):
    """--symmetry, --maverage, --diag, --lpad and --readocc (occs.dat in the
    working directory) reach scf_diatomic; the moments, nuclear densities
    and occupied-orbital table have helfem_tpu's lines and values."""
    monkeypatch.chdir(tmp_path)
    # the blocks: pi-g, pi-u (m = -1), sigma-g, sigma-u, pi-g, pi-u (m = +1)
    (tmp_path / "occs.dat").write_text("0 0\n1 1\n3 3\n2 2\n0 0\n1 1\n")
    argv = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "2,2", "--nelem", "3",
            "--nnodes", "5", "--Rmax", "15", "--convthr", "1e-8", "--symmetry", "2",
            "--maverage", "--diag", "0", "--lpad", "5", "--readocc", "3"]
    got, out = _run(dia_cli.main, argv + ["--device", "cpu", "--trace", "n2.json"])
    ref, jout = _run(jax_dia_cli.main, argv)
    assert got.converged and got.niter == ref.niter and abs(got.E - ref.E) < SCF_TOL
    for start in ("Electronic dipole", "Nuclear electron densities"):
        a, b = out[out.index(start):].split("\n\n")[0], jout[jout.index(start):].split("\n\n")[0]
        assert [line[:28] for line in a.splitlines()] == [line[:28] for line in b.splitlines()]
        ga = [float(x) for line in a.splitlines()[1:] for x in line.split()[-1:]]
        ra = [float(x) for line in b.splitlines()[1:] for x in line.split()[-1:]]
        assert np.allclose(ga, ra, rtol=1e-9, atol=1e-9 * max(map(abs, ra)))
    table = out[out.index("Occupied orbital analysis"):].split("\n\n")[0].splitlines()
    jtable = jout[jout.index("Occupied orbital analysis"):].split("\n\n")[0].splitlines()
    assert table[:2] == jtable[:2] and len(table) == len(jtable) == 9
    rows = np.array([[float(x) for x in line.split()] for line in table[2:]])
    jrows = np.array([[float(x) for x in line.split()] for line in jtable[2:]])
    assert np.allclose(rows, jrows, rtol=1e-6)  # six printed digits
    assert json.loads((tmp_path / "n2.json").read_text())["traceEvents"]


def _sad_kwargs(argv: list[str]) -> dict:
    """SadAtomBasis keywords of gensap's nuclear-model and confinement flags."""
    a = dict(zip(argv, argv[1:]))
    kw = {}
    if "--finitenuc" in a:
        kw.update(finitenuc=a["--finitenuc"], Rrms=float(a["--Rrms"]), nelem0=int(a["--nelem0"]))
    if "--iconf" in a:
        kw.update(iconf=int(a["--iconf"]), conf_N=int(a["--conf_N"]), conf_R=float(a["--conf_R"]),
                  shift_conf=float(a["--shift_conf"]), conf_boundary=float(a["--shift_conf"]))
    if "--zeroder" in argv:
        kw.update(primbas=int(a["--primbas"]), nnodes=int(a["--nnodes"]), zeroder=True)
    return kw


@pytest.mark.parametrize("extra", [
    ["--finitenuc", "gaussian", "--Rrms", "1e-2", "--nelem0", "2", "--taylor_order", "3"],
    ["--iconf", "2", "--conf_N", "3", "--conf_R", "3", "--shift_conf", "1", "--add_conf"],
    ["--primbas", "5", "--nnodes", "6", "--zeroder"],
], ids=["finite_nucleus", "confinement", "zeroder"])
def test_gensap_cli_nuclear_models(tmp_path, extra):
    """gensap's finite-nucleus (on its sub-grid), confinement (an element
    boundary at its onset) and zeroder flags (tests/test_sadatom.py's
    nuclear-model cases through the CLI): helfem_tpu's energy within 1e-9
    Eh, its Eenuc and Econf lines, and its SAP table of the port's
    density."""
    argv = ["--Z", "He", "--lmax", "0", "--nelem", "8", "--nnodes", "10", "--Rmax", "20",
            "--method", "HF", "--convthr", "1e-9", "--nosearch", *extra]
    got, out = _run(gensap_cli.main, argv + ["--device", "cpu", "--output",
                                             str(tmp_path / "p.dat")])
    ref, jout = _run(jax_gensap_cli.main, argv + ["--output", str(tmp_path / "j.dat")])
    assert got.converged and abs(got.E - ref.E) < SCF_TOL
    econf = [line for line in out.splitlines() if line.startswith(("Econf", "Eenuc"))]
    assert econf == [line for line in jout.splitlines() if line.startswith(("Econf", "Eenuc"))]
    assert ("Econf" in out) == ("--iconf" in extra)
    # the written table is helfem_tpu's table of the port's density (near
    # the nucleus the laplacian's 2 n'/r and the sub-grid's steep b' magnify
    # the two SCFs' last bits, so the packages' tables of their own
    # densities differ there beyond 1e-9)
    tab = np.loadtxt(tmp_path / "p.dat")
    jb = jsad.SadAtomBasis(**{**dict(Z=2, lmax=0, nelem=8, nnodes=10, rmax=20.0),
                              **_sad_kwargs(extra)})
    Prad = got.Pl.sum(axis=0)
    r, n, dn, ln, wt = jsad.radial_density(jb, Prad)
    vcoul, vxc = jsad.coulomb_screening(jb, Prad), jsad.xc_screening(jb, Prad, [])
    want = np.column_stack([r, n, dn, ln, jsad.kinetic_energy_density(jb, got.Pl), vcoul, vxc,
                            wt, 2 - (vcoul + vxc)])[np.argsort(r)]
    assert tab.shape == want.shape
    assert (np.abs(tab - want).max(0) <= 1e-12 * np.abs(want).max(0)).all()
