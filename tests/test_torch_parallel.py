"""The port's multi-device layer (helfem_tpu_torch/parallel/) against
helfem_tpu's parallel/mesh.py on the CPU.

helfem_tpu's functions run here, in the pytest process, on the conftest's
virtual CPU devices (make_mesh(4)); the port's run on four gloo ranks
spawned once for the module (tests/torch_parallel_cases.py, which imports
no JAX), on the same operator arrays (from_jax_operators and the grid
carriers) and inputs made with numpy from tests/test_parallel.py's seeds.
Tolerances: every sharded function within 1e-12 x max-abs of helfem_tpu's
(eigenvectors through C diag(E) C^T, which neither their signs nor
rotations within degenerate levels change); the SCFs within 1e-9 Eh of
helfem_tpu's ndev=4 runs in the same iteration counts, and of the port's
own ndev=0 runs. Then ndev=1 in the pytest process, and the refusals."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from threadpoolctl import threadpool_limits

import torch_parallel_cases
from helfem_tpu.models.atomic import AtomicBasis as JaxAtomicBasis
from helfem_tpu.models.atomic_dft import build_dft_grid
from helfem_tpu.models.diatomic import DiatomicBasis as JaxDiatomicBasis
from helfem_tpu.models.diatomic_dft import build_dia_grid
from helfem_tpu.models.sadatom import SadAtomBasis as JaxSadAtomBasis
from helfem_tpu.ops.xc import parse_method as jax_parse_method
from helfem_tpu.parallel import mesh as jm
from helfem_tpu.scf.atomic_scf import scf_atom as jax_scf_atom
from helfem_tpu.scf.diatomic_scf import scf_diatomic as jax_scf_diatomic
from helfem_tpu.utils.linalg import build_blocks
from helfem_tpu_torch.models import atomic, atomic_dft, diatomic
from helfem_tpu_torch.parallel import launch
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

TOL = 1e-12
SCF_TOL = 1e-9
NDEV = 4
BE2 = dict(Z=4, lmax=2, mmax=1, rmax=15.0, nelem=4, nnodes=6, nquad=40)
BE1 = dict(Z=4, lmax=1, mmax=1, rmax=15.0, nelem=5, nnodes=6, nquad=40)
H2 = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(3,), rmax=15.0, nelem=3, nnodes=6)
H2S = dict(Z1=1, Z2=1, Rbond=1.4, lmax=(2,), rmax=10.0, nelem=2, nnodes=5, nquad=25)
SAD = dict(Z=6, lmax=1, rmax=12.0, nelem=3, nnodes=5)
# tests/test_parallel.py:158-207's SCFs
ATOM_SCF = {"be_hf": (dict(Z=4, lmax=1, mmax=1, rmax=15.0, nelem=4, nnodes=6, nquad=40), "HF"),
            "be_pbe": (dict(Z=4, lmax=0, mmax=0, rmax=15.0, nelem=4, nnodes=6, nquad=40), "PBE")}
RS_REASON = "--ndev does not support range-separated exchange yet (erfc/yukawa tables)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread and one BLAS thread for this module's own SCFs:
    the test workers (and here the spawned ranks) share the machine's
    cores (threadpoolctl)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _arrays(nt) -> dict:
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _block_density(nang: int, nrad: int, seed: int) -> np.ndarray:
    """tests/test_parallel.py's physical-ish density: block-diagonal, PSD."""
    rng = np.random.default_rng(seed)
    P = np.zeros((nang * nrad, nang * nrad))
    for a in range(nang):
        X = rng.standard_normal((nrad, 2)) * 0.1
        P[a * nrad:(a + 1) * nrad, a * nrad:(a + 1) * nrad] = X @ X.T
    return P


def _host(x):
    return [np.asarray(v) for v in x] if isinstance(x, (tuple, list)) else np.asarray(x)


@pytest.fixture(scope="module")
def cases():
    """(helfem_tpu's results, the port's from one spawn of four gloo ranks,
    the inputs)."""
    mesh = jm.make_mesh(NDEV)
    funcs = tuple(jax_parse_method("PBE")[0])
    funcs0 = tuple(jax_parse_method("PBE0")[0])
    inp, ref = {}, {}

    b = JaxAtomicBasis(**BE2)
    ops = b.build_operators()
    inp["be2_ops"] = _arrays(ops)
    P = jnp.asarray(_block_density(b.nang, b.nrad, 0))
    inp["be2_P"] = np.asarray(P)
    for bd in (False, True):
        step, _ = jm.sharded_scf_step(mesh, ops, kfrac=1.0, bd=bd)
        ref[f"step_bd{int(bd)}"] = _host(step(P, P))
    blk = build_blocks(np.asarray(ops.S), b.sym_blocks(2))
    inp["be2_blk"] = blk
    inp["be2_F"] = ref["step_bd0"][0]
    ref["eig_blocks"] = _host(jm.sharded_eig_blocks(mesh, *blk, b.nbf)(
        jnp.asarray(inp["be2_F"])))

    b1 = JaxAtomicBasis(**BE1)
    ops1 = b1.build_operators()
    g1 = build_dft_grid(b1)
    inp["be1_ops"], inp["be1_grid"] = _arrays(ops1), _arrays(g1)
    P1 = jnp.asarray(_block_density(b1.nang, b1.nrad, 1))
    V = np.random.default_rng(3).standard_normal((b1.nbf, b1.nbf)) * 1e-3
    inp["be1_P"], inp["be1_V"] = np.asarray(P1), V + V.T
    fock, _, _ = jm.sharded_atomic_fock(mesh, ops1, kfrac=1.0, nrad=b1.nrad, Bz=0.1)
    ref["fock_hf"] = _host(fock(jnp.asarray(inp["be1_V"]), P1, 0.5 * P1))
    fock, _, _ = jm.sharded_atomic_fock(mesh, ops1, funcs0, g1, kfrac=0.25, nrad=b1.nrad,
                                        restricted=True)
    ref["fock_pbe0"] = _host(fock(jnp.zeros((b1.nbf, b1.nbf)), P1, P1))
    ref["xc"] = _host(jm.sharded_xc_fock(mesh, g1, funcs, b1.nrad)[0](P1, P1))

    hb = JaxDiatomicBasis(**H2)
    dops = hb.build_operators()
    gd = build_dia_grid(hb)
    inp["h2_ops"], inp["h2_grid"], inp["h2_cfg"] = _arrays(dops), _arrays(gd), H2
    X = np.random.default_rng(0).standard_normal((hb.nbf, hb.nbf)) * 0.05
    inp["h2_P"] = X @ X.T
    Pd = jnp.asarray(inp["h2_P"])
    ref["dia_fock"] = _host(jm.sharded_dia_fock(mesh, dops, kfrac=1.0)[0](Pd, Pd))
    m2 = np.asarray(dops.shellmask).reshape(-1)
    Co = np.random.default_rng(1).standard_normal((hb.nbf, 4)) * 0.2 * m2[:, None]
    inp["h2_Co"] = Co
    ref["dia_kocc"] = _host(jm.sharded_dia_exchange_occ(mesh, dops, 4)(jnp.asarray(Co)))
    fock, _, _ = jm.sharded_dia_scf_fock(mesh, dops, funcs0, gd, kfrac=0.25)
    Coa, Cob = jnp.asarray(Co[:, :2]), jnp.asarray(Co[:, 2:])
    ref["dia_scf_occ"] = _host(fock(Coa @ Coa.T, Cob @ Cob.T, Coa, Cob))
    ref["dia_scf_dense"] = _host(fock(Coa @ Coa.T, Cob @ Cob.T))

    sb = JaxDiatomicBasis(**H2S)
    sops = sb.build_operators()
    gs = build_dia_grid(sb)
    inp["h2s_ops"], inp["h2s_grid"] = _arrays(sops), _arrays(gs)
    ref["dia_eig"] = _host(jm.sharded_dia_eig(mesh, sops)(sops.H0))
    Pd = jnp.asarray(0.01 * np.eye(sb.nbf))
    ref["dia_xc"] = _host(jm.sharded_dia_xc(mesh, gs, funcs, sops)[0](Pd, Pd))

    sad = JaxSadAtomBasis(**SAD).build_ops()
    inp["sad_ops"] = {"at": _arrays(sad.at),
                      **{k: np.asarray(v) for k, v in sad._asdict().items() if k != "at"}}
    Pang = 0.1 * np.random.default_rng(2).standard_normal((SAD["lmax"] + 1,) + sad.Tl.shape)
    inp["sad_P"] = 0.5 * (Pang + Pang.transpose(0, 2, 1))
    ref["sad_k"] = _host(jm.sharded_sad_exchange(mesh, sad)(jnp.asarray(inp["sad_P"])))

    inp["atom_scf"] = ATOM_SCF
    for label, (cfg, method) in ATOM_SCF.items():
        jb = JaxAtomicBasis(**cfg)
        aops = jb.build_operators()
        inp[f"{label}_ops"] = _arrays(aops)
        if method != "HF":
            inp[f"{label}_grid"] = _arrays(build_dft_grid(jb))
        r = jax_scf_atom(jb, 2, 2, method=method, convthr=1e-9, maxit=40, ops=aops, ndev=NDEV)
        ref[label] = (r.E, r.niter, r.converged)
    r = jax_scf_diatomic(hb, 1, 1, convthr=1e-9, maxit=40, ops=dops, ndev=NDEV)
    ref["h2_hf"] = (r.E, r.niter, r.converged)

    got = launch.spawn(torch_parallel_cases.run_cases, NDEV, inp)
    return ref, got, inp


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-300)


def _spectral(E, C):
    """C diag(E) C^T per block (padded _BIG slots have zero columns)."""
    return np.einsum("...pk,...k,...qk->...pq", C, E, C)


# name -> the positions of (eigenvalues, eigenvectors) pairs in the outputs
EIGEN = {"step_bd0": ((2, 3), (4, 5)), "step_bd1": ((2, 3), (4, 5)), "eig_blocks": ((0, 1),),
         "dia_eig": ((0, 1),)}
FUNCTIONS = ["step_bd0", "step_bd1", "eig_blocks", "fock_hf", "fock_pbe0", "xc", "dia_fock",
             "dia_kocc", "dia_eig", "dia_xc", "dia_scf_occ", "dia_scf_dense", "sad_k"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_sharded_matches_helfem_tpu(cases, name):
    """Each sharded function of the port on four ranks against helfem_tpu's
    of the same name on four devices, within 1e-12 x max-abs."""
    ref, got, _ = cases
    r, g = ref[name], got[name]
    if not isinstance(r, list):
        r, g = [r], [g]
    assert len(g) == len(r)
    pairs = EIGEN.get(name, ())
    vectors = {c for _, c in pairs}
    for i, (x, y) in enumerate(zip(g, r)):
        if i not in vectors:
            _close(x, y)
    for e, c in pairs:
        _close(_spectral(g[e], g[c]), _spectral(r[e], r[c]))


def test_fock_bits_equal_on_every_rank(cases):
    """After the all_reduce every rank holds the same Fock bits."""
    _, got, _ = cases
    assert len(got["fock_bits"]) == NDEV and len(set(got["fock_bits"])) == 1


@pytest.mark.parametrize("label", ["be_hf", "be_pbe", "h2_hf"])
def test_scf_ndev4_matches(cases, label):
    """scf_atom/scf_diatomic(ndev=4) inside the group: helfem_tpu's ndev=4
    energy within 1e-9 Eh in its iteration count, and the port's own ndev=0
    energy within 1e-9 Eh."""
    ref, got, inp = cases
    E, niter, conv = got[label]
    assert conv and abs(E - ref[label][0]) < SCF_TOL and niter == ref[label][1]
    if label == "h2_hf":
        own = scf_diatomic(diatomic.DiatomicBasis(**H2), 1, 1, convthr=1e-9, maxit=40,
                           ops=diatomic.from_jax_operators(inp["h2_ops"], "cpu"))
    else:
        cfg, method = ATOM_SCF[label]
        ops = atomic.from_jax_operators(inp[f"{label}_ops"], "cpu")
        grid = inp.get(f"{label}_grid")
        grid = None if grid is None else atomic_dft.from_jax_atomic_grid(
            grid, ops.Sinvh_rad.shape[0], "cpu")
        own = scf_atom(atomic.AtomicBasis(**cfg), 2, 2, method=method, convthr=1e-9,
                       maxit=40, ops=ops, grid=grid)
    assert own.converged and abs(E - own.E) < SCF_TOL


def test_mesh_of_another_size_raises(cases):
    _, got, _ = cases
    assert got["size_refusal"] == "make_mesh: need 2 ranks, the process group has 4"


def test_ndev1_in_process():
    """ndev=1 outside a group runs over a one-rank group made here and gone
    after the call; an ndev=0 call after it runs, to the same energy."""
    basis = atomic.AtomicBasis(Z=2, lmax=0, mmax=0, rmax=20.0, nelem=3, nnodes=6)
    one = scf_atom(basis, 1, 1, convthr=1e-9, device="cpu", ndev=1)
    assert not dist.is_initialized()
    zero = scf_atom(basis, 1, 1, convthr=1e-9, device="cpu")
    assert one.converged and zero.converged and abs(one.E - zero.E) < SCF_TOL


def test_nccl_needs_a_card_per_rank():
    """NCCL with fewer cards than ranks raises before anything starts,
    naming both counts; gloo shares one card; nothing plans NCCL on the
    CPU."""
    with pytest.raises(RuntimeError, match="--ndev 2 with NCCL needs 2 CUDA devices, one per "
                                           "rank; 1 is visible"):
        launch.plan_backend(2, "cuda", ncuda=1)
    assert launch.plan_backend(2, "cuda", "gloo", ncuda=1) == "gloo"
    assert launch.plan_backend(4, "cuda", ncuda=4) == "nccl"
    assert launch.plan_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        launch.plan_backend(1, "cpu", "nccl")


def test_range_separation_and_closures_refused():
    """Range separation under ndev raises helfem_tpu's reason; a save_cb
    that cannot pickle raises before ranks are spawned for it."""
    basis = atomic.AtomicBasis(Z=2, lmax=0, mmax=0, rmax=20.0, nelem=2, nnodes=4)
    with pytest.raises(NotImplementedError, match=RS_REASON.replace("(", r"\(").replace(
            ")", r"\)")):
        scf_atom(basis, 1, 1, method="LC-LDA", device="cpu", ndev=2)
    with pytest.raises(TypeError, match="must pickle"):
        scf_atom(basis, 1, 1, device="cpu", ndev=2, save_cb=lambda *a: None)


def test_failing_rank_raises_in_the_caller():
    """A rank that raises makes launch.spawn raise its exception, long
    before the group's timeout, while the other rank waits in a collective."""
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="rank 1 fails on purpose") as info:
        launch.spawn(torch_parallel_cases.fail_on_rank1, 2, None)
    assert time.perf_counter() - t0 < launch.TIMEOUT_S
    assert any("rank 1 of 2" in note for note in info.value.__notes__)
