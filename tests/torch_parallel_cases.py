"""The rank functions of tests/test_torch_parallel.py. The ranks are new
processes that must not import JAX, so they live here, in a module that
imports none of it: run_cases computes every case of the port's side on
every rank of a gloo group, fail_on_rank1 makes a rank raise."""

import hashlib

import numpy as np
import torch

from helfem_tpu_torch.models import atomic, atomic_dft, diatomic, diatomic_dft, sadatom
from helfem_tpu_torch.ops.xc import parse_method
from helfem_tpu_torch.parallel import mesh as pm
from helfem_tpu_torch.scf.atomic_scf import scf_atom
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

CPU = torch.device("cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _bits(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def run_cases(mesh, inp: dict) -> dict:
    """Every sharded function of the port on the inputs of
    test_torch_parallel.py (numpy, from its seeds), the SCFs over the
    group, and the refusal of a mesh of another size; on rank 0 the
    results as numpy, with the hash of one Fock matrix from every rank."""
    out = {}
    funcs = tuple(parse_method("PBE")[0])
    funcs0 = tuple(parse_method("PBE0")[0])

    # the atomic step, both exchange forms (Be lmax 2, mmax 1)
    ops = atomic.from_jax_operators(inp["be2_ops"], CPU)
    Pa = _t(inp["be2_P"])
    for bd in (False, True):
        step, _ = pm.sharded_scf_step(mesh, ops, kfrac=1.0, bd=bd)
        out[f"step_bd{int(bd)}"] = [_np(x) for x in step(Pa, Pa)]
    eig = pm.sharded_eig_blocks(mesh, *inp["be2_blk"], ops.S.shape[0])
    out["eig_blocks"] = [_np(x) for x in eig(_t(inp["be2_F"]))]

    # the atomic Fock build: HF with Bz and extras, PBE0 restricted (Be lmax 1)
    ops1 = atomic.from_jax_operators(inp["be1_ops"], CPU)
    g1 = atomic_dft.from_jax_atomic_grid(inp["be1_grid"], ops1.Sinvh_rad.shape[0], CPU)
    P1 = _t(inp["be1_P"])
    fock, _, _ = pm.sharded_atomic_fock(mesh, ops1, kfrac=1.0, Bz=0.1)
    res = fock(_t(inp["be1_V"]), P1, 0.5 * P1)
    out["fock_hf"] = [_np(x) for x in res]
    out["fock_bits"] = mesh.gather_objects(_bits(res[0]))
    fock, _, _ = pm.sharded_atomic_fock(mesh, ops1, funcs0, g1, kfrac=0.25, restricted=True)
    out["fock_pbe0"] = [_np(x) for x in fock(None, P1, P1)]
    xc, _ = pm.sharded_xc_fock(mesh, g1, funcs)
    out["xc"] = [_np(x) for x in xc(P1, P1)]

    # the diatomic functions (H2 lmax 3; lmax 2 for the eigensolve and XC)
    dops = diatomic.from_jax_operators(inp["h2_ops"], CPU)
    X = _t(inp["h2_P"])
    fock, _ = pm.sharded_dia_fock(mesh, dops, kfrac=1.0)
    out["dia_fock"] = [_np(x) for x in fock(X, X)]
    Co = _t(inp["h2_Co"])
    out["dia_kocc"] = _np(pm.sharded_dia_exchange_occ(mesh, dops)(Co))
    sops = diatomic.from_jax_operators(inp["h2s_ops"], CPU)
    gs = diatomic_dft.from_jax_grid(inp["h2s_grid"], sops.shellmask.shape[1], CPU)
    out["dia_eig"] = [_np(x) for x in pm.sharded_dia_eig(mesh, sops)(sops.H0)]
    Pd = 0.01 * torch.eye(sops.S.shape[0], dtype=torch.float64)
    xc, _ = pm.sharded_dia_xc(mesh, gs, funcs, sops)
    out["dia_xc"] = [_np(x) for x in xc(Pd, Pd)]
    gd = diatomic_dft.from_jax_grid(inp["h2_grid"], dops.shellmask.shape[1], CPU)
    fock, _, _ = pm.sharded_dia_scf_fock(mesh, dops, funcs0, gd, kfrac=0.25)
    Coa, Cob = Co[:, :2], Co[:, 2:]
    Pa_, Pb_ = Coa @ Coa.T, Cob @ Cob.T
    out["dia_scf_occ"] = [_np(x) for x in fock(Pa_, Pb_, Coa, Cob)]
    out["dia_scf_dense"] = [_np(x) for x in fock(Pa_, Pb_)]

    # the SAD atom's exchange (C, lmax 1)
    sad = sadatom.from_jax_sad_ops(inp["sad_ops"], CPU)
    out["sad_k"] = _np(pm.sharded_sad_exchange(mesh, sad)(_t(inp["sad_P"])))

    # end to end inside the group, on the operators and grids of helfem_tpu
    for label, (cfg, method) in inp["atom_scf"].items():
        aops = atomic.from_jax_operators(inp[f"{label}_ops"], CPU)
        grid = inp.get(f"{label}_grid")
        if grid is not None:
            grid = atomic_dft.from_jax_atomic_grid(grid, aops.Sinvh_rad.shape[0], CPU)
        res = scf_atom(atomic.AtomicBasis(**cfg), 2, 2, method=method, convthr=1e-9,
                       maxit=40, ops=aops, grid=grid, ndev=mesh.size)
        out[label] = (res.E, res.niter, res.converged)
    dbasis = diatomic.DiatomicBasis(**inp["h2_cfg"])
    res = scf_diatomic(dbasis, 1, 1, convthr=1e-9, maxit=40, ops=dops, ndev=mesh.size)
    out["h2_hf"] = (res.E, res.niter, res.converged)

    try:
        pm.make_mesh(mesh.size - 2)
    except RuntimeError as exc:
        out["size_refusal"] = str(exc)
    return out


def fail_on_rank1(mesh, payload):
    """Rank 1 raises; rank 0 waits in an all_reduce that rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.psum(torch.ones(3, dtype=torch.float64))[0]
