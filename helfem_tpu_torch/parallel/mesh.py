"""The multi-device layer of the port (helfem_tpu's parallel/mesh.py on
torch.distributed): one process per rank, each holding the whole operators
and the whole density, each running the kernels on its share of one axis,
and the partial Fock matrices and energies summed by all_reduce.

| helfem_tpu (shard_map over 'ch')       | here, on rank r of n                     |
|----------------------------------------|------------------------------------------|
| atomic J/K: L axis of G, Lfac, tei,    | L range r of those tensors: K2 and K1 on |
| disjL, disjm1L                         | it (shard_atomic_ops)                    |
| diatomic J: signed (L,M) channel rows  | channel range r of GmLM, GpLM, LM_ilm: K3|
| diatomic K: (L,|M|) step rows          | step range r of step_*: K6 (or K7)       |
| XC: element axis of the grid           | element range r of the element tables,   |
|                                        | owners and band rebuilt: K4 and K5       |
| eigensolve: symmetry-block axis        | block range r: eig_blocks_b              |
| psum                                   | one all_reduce(SUM) of a packed buffer   |
| all_gather of the eigenpairs           | zero-filled full buffer, all_reduce(SUM) |

The ranges are torch.tensor_split's, uneven, with no zero padding: helfem_tpu
pads its axes (pad_ops_for_mesh, pad_grid_for_mesh, pad_dia_grid_for_mesh)
only because shard_map needs equal shapes. A rank whose range is empty
launches no kernel and contributes zeros. Adding zeros is exact, so every
rank holds the same bits after each all_reduce, and the host loops of the
SCF drivers take the same decisions on every rank (rank 0 broadcasts them
besides, Mesh.bcast).

The collectives run on the rank's device under NCCL. gloo's collectives on
CUDA tensors depend on how gloo was built (and copy through host memory
anyway): Mesh stages them through host memory explicitly, so ranks that
share one card run the same code whatever the build.
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from helfem_tpu_torch.kernels import band_table, owner_table
from helfem_tpu_torch.models.atomic import (
    AtomicOperators, channel_diag, coulomb, exchange, exchange_bd,
)
from helfem_tpu_torch.models.atomic_dft import eval_fxc
from helfem_tpu_torch.models.diatomic import coulomb_dia, exchange_dia, exchange_dia_occ
from helfem_tpu_torch.models.diatomic_dft import eval_fxc_dia
from helfem_tpu_torch.models.sadatom import sad_exchange
from helfem_tpu_torch.scf.common import vdot
from helfem_tpu_torch.utils.linalg import eig_blocks_b, eigh_refined, gather_blocks

__all__ = ["Mesh", "make_mesh", "shard_atomic_ops", "shard_grid", "sharded_atomic_fock",
           "sharded_dia_eig", "sharded_dia_exchange_occ", "sharded_dia_fock",
           "sharded_dia_scf_fock", "sharded_dia_xc", "sharded_eig_blocks",
           "sharded_sad_exchange", "sharded_scf_step", "sharded_xc_fock", "split_range"]


def split_range(n: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of part `rank` of torch.tensor_split(range(n), size): the
    first n % size parts one longer."""
    q, r = divmod(n, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


class Mesh:
    """One rank's view of a 1D mesh of `size` ranks: its process group's
    backend, its rank and its device, and the collectives of the sharded
    functions. stats counts the all_reduce calls, their bytes and (with
    `timed`, which synchronises the device around each) their wall."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str):
        self.rank, self.size, self.device, self.backend = rank, size, device, backend
        self.timed = False
        self.stats = {"all_reduce": 0, "all_reduce_bytes": 0, "all_reduce_s": 0.0}

    def range(self, n: int) -> tuple[int, int]:
        """This rank's [lo, hi) of an axis of length n."""
        return split_range(n, self.size, self.rank)

    def _on_host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _all_reduce(self, flat: torch.Tensor) -> None:
        t0 = time.perf_counter()
        if self.timed and flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        if self._on_host(flat):
            host = flat.cpu()
            dist.all_reduce(host)
            flat.copy_(host)
        else:
            dist.all_reduce(flat)
        if self.timed and flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        self.stats["all_reduce"] += 1
        self.stats["all_reduce_bytes"] += flat.numel() * flat.element_size()
        self.stats["all_reduce_s"] += time.perf_counter() - t0

    def psum(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """The sums over the ranks of the float64 tensors xs (scalars too),
        packed into one all_reduce."""
        flat = torch.cat([x.reshape(-1) for x in xs])
        self._all_reduce(flat)
        out, k = [], 0
        for x in xs:
            out.append(flat[k:k + x.numel()].view(x.shape))
            k += x.numel()
        return out

    def bcast(self, *arrays) -> list[np.ndarray]:
        """Rank 0's host arrays (float64) on every rank, in one broadcast."""
        arrs = [np.asarray(a, dtype=np.float64) for a in arrays]
        flat = torch.as_tensor(np.concatenate([a.ravel() for a in arrs]))
        if self.backend == "nccl":
            flat = flat.to(self.device)
        dist.broadcast(flat, src=0)
        flat = flat.cpu().numpy()
        out, k = [], 0
        for a in arrs:
            out.append(flat[k:k + a.size].reshape(a.shape))
            k += a.size
        return out

    def gather_objects(self, obj) -> list:
        """Every rank's picklable obj, in rank order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


_MESH: list = [None, None]  # the process group of the last mesh made, and the mesh


def make_mesh(n_devices: int, backend: str | None = None, device=None) -> Mesh:
    """This rank's Mesh of the initialized process group, which must hold
    exactly n_devices ranks: it never shrinks to fewer (helfem_tpu's
    make_mesh, mesh.py:39-54). backend, when named, must be the group's.
    device: this rank's (default, and for "cuda" without an index,
    cuda:<rank % cards> under NCCL; the CPU under gloo, and for "cuda" the
    current card: ranks that share a card under gloo name it). The same
    group and device give the same Mesh, so its stats add up over calls."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh: need a process group of {n_devices} ranks and none is initialized: "
            "run through helfem_tpu_torch.parallel.launch (run, spawn) or call "
            f"torch.distributed.init_process_group with world_size={n_devices}")
    size = dist.get_world_size()
    if size != n_devices:
        raise RuntimeError(f"make_mesh: need {n_devices} ranks, the process group has {size}")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise RuntimeError(f"make_mesh: backend {backend!r} asked for, the group runs {have!r}")
    rank = dist.get_rank()
    device = torch.device("cuda" if have == "nccl" else "cpu") if device is None else \
        torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count() if have == "nccl"
                              else torch.cuda.current_device())
    if have == "nccl" and device.type != "cuda":
        raise RuntimeError(f"make_mesh: an NCCL group runs on CUDA devices, not {device}")
    group = dist.group.WORLD
    mesh = _MESH[1]
    if _MESH[0] is not group or mesh.device != device:
        mesh = Mesh(rank, size, device, have)
        _MESH[:] = [group, mesh]
    return mesh


# ----------------------------------------------------------------------------
# shards
# ----------------------------------------------------------------------------

_L_AXIS = ("G", "Lfac", "tei", "disjL", "disjm1L")
# the grids' tables over elements: axis 0, or axis 1 behind a factor axis
_ELEMENT_AXIS = ("Bg", "dBg", "d2Bg", "w", "invh", "invhphi2", "r", "gidx", "BBs", "SSs", "DDs",
                 "S2s")
_ELEMENT_AXIS1 = ("tfac", "lfac")


def shard_atomic_ops(ops: AtomicOperators, lo: int, hi: int) -> AtomicOperators:
    """The operators with the L range [lo, hi) of G, Lfac, tei, disjL and
    disjm1L (views, contiguous: the L axis leads)."""
    return ops._replace(**{k: getattr(ops, k)[lo:hi] for k in _L_AXIS})


def shard_grid(g, lo: int, hi: int):
    """An XC grid (AtomGridOps or DiaGridOps) on its elements [lo, hi), with
    the owner and band tables rebuilt from the shard's own gidx rows: the
    full grid's owner slots e * nprim + i name other elements there, and
    K5's owner-computes assembly would read another rank's windows. Radial
    functions no element of the shard covers have no owners and an empty
    band (kernels/_common.py:band_table)."""
    nrad = g.owners.shape[0]
    out = {}
    for name in _ELEMENT_AXIS + _ELEMENT_AXIS1:
        t = getattr(g, name, None)
        if t is not None:
            out[name] = t[lo:hi] if name in _ELEMENT_AXIS else t[:, lo:hi].contiguous()
    gi = out["gidx"].cpu().numpy()
    own = owner_table(gi, nrad)
    for name, table in (("owners", own), ("band", band_table(gi, own, nrad))):
        out[name] = torch.as_tensor(table, dtype=torch.int32, device=g.gidx.device)
    return g._replace(**out)


def _zeros(like: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(like.shape if shape is None else shape, dtype=torch.float64,
                       device=like.device)


def _eig_rows(mesh: Mesh, nrow: int, solve, blen: int, like: torch.Tensor):
    """Rows [lo, hi) of nrow eigenproblems solved here (solve(lo, hi) -> (E,
    C)), every row on every rank through zero-filled full buffers."""
    lo, hi = mesh.range(nrow)
    E = _zeros(like, (nrow, blen))
    C = _zeros(like, (nrow, blen, blen))
    if hi > lo:
        E[lo:hi], C[lo:hi] = solve(lo, hi)
    return mesh.psum(E, C)


# ----------------------------------------------------------------------------
# atoms
# ----------------------------------------------------------------------------


def sharded_scf_step(mesh: Mesh, ops: AtomicOperators, kfrac: float = 1.0, bd: bool = False):
    """(step, ops_l): step(Pa, Pb) -> (Fa, Fb, Ea, Ca, Eb, Cb, E) runs one
    SCF iteration over the mesh (mesh.py:74-174): J and kfrac K of the
    rank's L range (K on the channel diagonals with bd, exchange_bd; else on
    all channel pairs), summed, then the whitened eigensolve of the (l,m)
    blocks (eig_gsym_lm) on the rank's block range, gathered. E = Ekin +
    Enuc + Ecoul + Exx. ops_l is the rank's L shard."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    ops_l = shard_atomic_ops(ops, *mesh.range(ops.G.shape[0]))
    live = ops_l.G.shape[0] > 0
    X = ops.Sinvh_rad

    def K_of(P):
        return exchange_bd(ops_l, channel_diag(P, nang, nrad)) if bd else exchange(ops_l, P)

    def eig(F):
        a = torch.arange(nang, device=F.device)
        Fb = F.reshape(nang, nrad, nang, nrad)[a, :, a, :]

        def solve(lo, hi):
            E, V = eigh_refined(X.T @ Fb[lo:hi] @ X)
            return E, torch.einsum("pi,aij->apj", X, V)

        return _eig_rows(mesh, nang, solve, nrad, F)

    def step(Pa, Pb):
        P = Pa + Pb
        J = coulomb(ops_l, P) if live else _zeros(P)
        Ka = kfrac * K_of(Pa) if live else _zeros(P)
        Kb = kfrac * K_of(Pb) if live else _zeros(P)
        J, Ka, Kb = mesh.psum(J, Ka, Kb)
        Fa, Fb = ops.H0 + J + Ka, ops.H0 + J + Kb
        Ea, Ca = eig(Fa)
        Eb, Cb = eig(Fb)
        E = vdot(P, ops.T) + vdot(P, ops.Vnuc) + 0.5 * vdot(P, J) + 0.5 * (
            vdot(Pa, Ka) + vdot(Pb, Kb))
        return Fa, Fb, Ea, Ca, Eb, Cb, E

    return step, ops_l


def sharded_eig_blocks(mesh: Mesh, blk_idx, blk_sinvh, nbf: int):
    """eig(F) -> (E [nblk, blen], C [nblk, blen, blen]), the blocked whitened
    eigensolve (utils/linalg.py:eig_blocks, its _BIG padded slots) with the
    symmetry blocks split over the ranks and the eigenpairs gathered
    (mesh.py:177-214). F may stack ns spins [ns, nbf, nbf]: their ns * nblk
    blocks are split in one solve and one gather, and E, C gain the spin
    axis."""
    blk_idx = torch.as_tensor(blk_idx)
    blk_sinvh = torch.as_tensor(blk_sinvh, dtype=torch.float64)

    def eig(F):
        Fs = F if F.dim() == 3 else F[None]
        ns = Fs.shape[0]
        idx = blk_idx.to(F.device).repeat(ns, 1)
        sinvh = blk_sinvh.to(F.device).repeat(ns, 1, 1)
        Fb = torch.cat([gather_blocks(f, blk_idx.to(F.device)) for f in Fs])

        def solve(lo, hi):
            return eig_blocks_b(Fb[lo:hi], idx[lo:hi], sinvh[lo:hi], nbf)

        E, C = _eig_rows(mesh, idx.shape[0], solve, idx.shape[1], F)
        if F.dim() == 3:
            return E.view(ns, -1, E.shape[-1]), C.view(ns, -1, *C.shape[-2:])
        return E, C

    return eig


def _finish(mesh: Mesh, parts: list, scalars: list):
    """The summed partial Fock matrices and scalars of every rank."""
    out = mesh.psum(*parts, torch.stack(scalars))
    return out[:-1], out[-1]


def sharded_atomic_fock(mesh: Mesh, ops: AtomicOperators, funcs=(), g=None, kfrac: float = 0.0,
                        bd: bool = True, Bz: float = 0.0, dftthr: float = 1e-12,
                        restricted: bool = False, pairs=None):
    """(fock_fn, ops_l, g_l): the atomic Fock build over the mesh
    (mesh.py:217-293), fock_fn(Vextra, Pa, Pb) -> (Fa, Fb, Ekin, Enuc,
    Ecoul, Exx, Exc, Nel, Efield), helfem_tpu's 9-tuple and the contract of
    scf/atomic_scf.py:make_fock's fock (Vextra None: no extras). The rank
    runs K2 and kfrac K1 (on the channel diagonals with bd, else on the
    windows of `pairs`, all channel pairs when None) on its L range ops_l,
    and K4/K5 on its element range g_l of the grid of funcs; each spin's
    J + K + XC and the scalars <P, J>, <Pa, Ka> + <Pb, Kb>, Exc and Nel are
    summed in one all_reduce. Bz adds the spin Zeeman term -+ Bz/2 S after
    the energies."""
    nang = ops.G.shape[-1]
    nrad = ops.Sinvh_rad.shape[0]
    ops_l = shard_atomic_ops(ops, *mesh.range(ops.G.shape[0]))
    g_l = shard_grid(g, *mesh.range(g.gidx.shape[0])) if funcs else None
    live_l = ops_l.G.shape[0] > 0
    live_e = bool(funcs) and g_l.gidx.shape[0] > 0

    def K_of(Ps):
        if not bd:
            return exchange(ops_l, Ps, pairs)
        if Ps.dim() == 2:
            return exchange_bd(ops_l, channel_diag(Ps, nang, nrad))
        return exchange_bd(ops_l, torch.stack([channel_diag(P, nang, nrad) for P in Ps]))

    def fock_fn(Vextra, Pa, Pb):
        P = Pa + Pb
        ns = 1 if restricted else 2
        parts = [_zeros(P) for _ in range(ns)]
        zero = _zeros(P, ())
        eJ = eK = Exc = Nel = zero
        if live_l:
            J = coulomb(ops_l, P)
            parts = [x + J for x in parts]
            eJ = vdot(P, J)
            if kfrac != 0.0:
                K = kfrac * K_of(Pa if restricted else torch.stack((Pa, Pb)))
                Ka, Kb = (K, K) if restricted else K
                parts = [x + k for x, k in zip(parts, (Ka, Kb))]
                eK = vdot(Pa, Ka) + vdot(Pb, Kb)
        if live_e:
            XCa, XCb, Exc, Nel = eval_fxc(funcs, g_l, Pa, Pa if restricted else Pb, dftthr)
            parts = [x + v for x, v in zip(parts, (XCa, XCb))]
        parts, (eJ, eK, Exc, Nel) = _finish(mesh, parts, [eJ, eK, Exc, Nel])
        H = ops.H0 if Vextra is None else ops.H0 + Vextra
        Fa = H + parts[0]
        Fb = H + parts[-1]
        if Bz != 0.0:
            Fa, Fb = Fa - 0.5 * Bz * ops.S, Fb + 0.5 * Bz * ops.S
        Efield = zero if Vextra is None else vdot(P, Vextra)
        return (Fa, Fb, vdot(P, ops.T), vdot(P, ops.Vnuc), 0.5 * eJ, 0.5 * eK, Exc, Nel,
                Efield)

    return fock_fn, ops_l, g_l


def _sharded_xc(mesh: Mesh, g, evaluate):
    """(xc_fn, g_l) with xc_fn(Pa, Pb) -> (Fxca, Fxcb, Exc, Nel): evaluate(g_l,
    Pa, Pb) on the rank's element range, summed."""
    g_l = shard_grid(g, *mesh.range(g.gidx.shape[0]))

    def xc_fn(Pa, Pb):
        if g_l.gidx.shape[0] > 0:
            Fa, Fb, Exc, Nel = evaluate(g_l, Pa, Pb)
        else:
            Fa, Fb, Exc, Nel = _zeros(Pa), _zeros(Pa), _zeros(Pa, ()), _zeros(Pa, ())
        Fa, Fb, s = mesh.psum(Fa, Fb, torch.stack((Exc, Nel)))
        return Fa, Fb, s[0], s[1]

    return xc_fn, g_l


def sharded_xc_fock(mesh: Mesh, g, funcs, thr: float = 1e-12):
    """(xc_fn, g_l): the atomic XC Fock build (models/atomic_dft.py:eval_fxc,
    K4 and K5) on the rank's element range g_l of the grid, the partial
    Fxca, Fxcb, Exc and Nel summed (mesh.py:322-358): xc_fn(Pa, Pb) ->
    (Fxca, Fxcb, Exc, Nel)."""
    return _sharded_xc(mesh, g, lambda g_l, Pa, Pb: eval_fxc(funcs, g_l, Pa, Pb, thr))


def sharded_sad_exchange(mesh: Mesh, ops):
    """K(Pang): the SAD atom's l-resolved exchange (models/sadatom.py:
    sad_exchange, one K1 launch) on the rank's L range of at.tei, at.disjL,
    at.disjm1L, at.Lfac and totcoup, summed (mesh.py:746-786)."""
    lo, hi = mesh.range(ops.at.tei.shape[0])
    ops_l = ops._replace(at=shard_atomic_ops(ops.at, lo, hi), totcoup=ops.totcoup[lo:hi])

    def K(Pang):
        part = sad_exchange(ops_l, Pang) if hi > lo else _zeros(Pang)
        return mesh.psum(part)[0]

    return K


# ----------------------------------------------------------------------------
# diatomic molecules
# ----------------------------------------------------------------------------

_STEPS = ("step_ilm", "step_sp", "step_sm", "step_wm")


def _channel_shard(mesh: Mesh, ops, njbd: int | None):
    """The operators with the rank's range of the signed (L,M) channels
    (the first njbd, every one when None) for K3."""
    n = ops.GmLM.shape[0] if njbd is None else njbd
    lo, hi = mesh.range(n)
    return ops._replace(GmLM=ops.GmLM[lo:hi], GpLM=ops.GpLM[lo:hi], LM_ilm=ops.LM_ilm[lo:hi])


def _step_shard(mesh: Mesh, ops):
    """The operators with the rank's range of the (L,|M|) exchange steps for
    K6/K7. GmLM and GpLM stay whole: step_sp/step_sm index them."""
    lo, hi = mesh.range(ops.step_ilm.shape[0])
    return ops._replace(**{k: getattr(ops, k)[lo:hi] for k in _STEPS})


def sharded_dia_fock(mesh: Mesh, ops, kfrac: float = 1.0):
    """(fock_fn, ops): fock_fn(Pa, Pb) -> (Fa, Fb, Ecoul, Exx), F = H0 + J +
    kfrac K (mesh.py:361-446): K3 on the rank's range of every signed
    (L,M) channel, the dense exchange (K7, exchange_dia: symmetric
    densities) on its range of the exchange steps, summed."""
    ops_j = _channel_shard(mesh, ops, None)
    ops_k = _step_shard(mesh, ops)

    def fock_fn(Pa, Pb):
        P = Pa + Pb
        J = coulomb_dia(ops_j, P) if ops_j.LM_ilm.shape[0] else _zeros(P)
        live = ops_k.step_ilm.shape[0] > 0
        Ka = kfrac * exchange_dia(ops_k, Pa) if live else _zeros(P)
        Kb = kfrac * exchange_dia(ops_k, Pb) if live else _zeros(P)
        J, Ka, Kb = mesh.psum(J, Ka, Kb)
        return (ops.H0 + J + Ka, ops.H0 + J + Kb, 0.5 * vdot(P, J),
                0.5 * (vdot(Pa, Ka) + vdot(Pb, Kb)))

    return fock_fn, ops


def sharded_dia_exchange_occ(mesh: Mesh, ops):
    """K(Co): the occupied-orbital exchange (exchange_dia_occ, K6) of
    sqrt(f)-weighted columns Co [nbf, no] on the rank's range of the
    exchange steps, summed (mesh.py:449-501; every step's contribution adds
    linearly). helfem_tpu's padded width `no` has no counterpart: the
    width is Co's."""
    ops_k = _step_shard(mesh, ops)

    def K(Co):
        part = (exchange_dia_occ(ops_k, Co) if ops_k.step_ilm.shape[0]
                else _zeros(Co, (Co.shape[0], Co.shape[0])))
        return mesh.psum(part)[0]

    return K


def sharded_dia_eig(mesh: Mesh, ops):
    """eig(F) -> (E, C): sharded_eig_blocks on the operators' symmetry
    blocks (mesh.py:504-538)."""
    return sharded_eig_blocks(mesh, ops.blk_idx, ops.blk_sinvh, ops.S.shape[0])


def sharded_dia_xc(mesh: Mesh, g, funcs, ops, thr: float = 1e-12):
    """(xc_fn, g_l): the diatomic XC Fock build (eval_fxc_dia, K4 and K5) on
    the rank's range of the mu elements, summed (mesh.py:566-599):
    xc_fn(Pa, Pb) -> (Fxca, Fxcb, Exc, Nel)."""
    return _sharded_xc(mesh, g, lambda g_l, Pa, Pb: eval_fxc_dia(funcs, g_l, ops, Pa, Pb, thr))


def sharded_dia_scf_fock(mesh: Mesh, ops, funcs=(), g=None, kfrac: float = 0.0,
                         dftthr: float = 1e-12, restricted: bool = False,
                         njbd: int | None = None):
    """(fock_fn, ops, g_l): the diatomic SCF's Fock build over the mesh
    (mesh.py:602-743) with scf/diatomic_scf.py:make_dia_fock's contract:
    fock_fn(Pa, Pb, Coa=None, Cob=None) -> (Fa, Fb, Ekin, Enuc, Ecoul, Exx,
    Exc, Nel). The rank runs K3 on its range of the signed (L,M) channels
    (the first njbd, the M = 0 ones the SCF's block-diagonal densities
    need; every channel when None, as helfem_tpu's), kfrac K on its range
    of the exchange steps (K6 from the occupied columns when given, K7 from
    the density otherwise) and K4/K5 on its range g_l of the grid's mu
    elements; each spin's J + K + XC and the scalars are summed in one
    all_reduce. restricted (Pb = Pa, Cob unused) builds K and XC once."""
    ops_j = _channel_shard(mesh, ops, njbd)
    ops_k = _step_shard(mesh, ops)
    g_l = shard_grid(g, *mesh.range(g.gidx.shape[0])) if funcs else None
    live_j = ops_j.LM_ilm.shape[0] > 0
    live_k = kfrac != 0.0 and ops_k.step_ilm.shape[0] > 0
    live_e = bool(funcs) and g_l.gidx.shape[0] > 0

    def K_of(P, Co):
        return kfrac * (exchange_dia_occ(ops_k, Co) if Co is not None else exchange_dia(ops_k, P))

    def fock_fn(Pa, Pb, Coa=None, Cob=None):
        P = Pa + Pb
        ns = 1 if restricted else 2
        parts = [_zeros(P) for _ in range(ns)]
        zero = _zeros(P, ())
        eJ = eK = Exc = Nel = zero
        if live_j:
            J = coulomb_dia(ops_j, P)
            parts = [x + J for x in parts]
            eJ = vdot(P, J)
        if live_k:
            Ka = K_of(Pa, Coa)
            Kb = Ka if restricted else K_of(Pb, Cob)
            parts = [x + k for x, k in zip(parts, (Ka, Kb))]
            eK = vdot(Pa, Ka) + vdot(Pb, Kb)
        if live_e:
            XCa, XCb, Exc, Nel = eval_fxc_dia(funcs, g_l, ops, Pa, Pa if restricted else Pb,
                                              dftthr)
            parts = [x + v for x, v in zip(parts, (XCa, XCb))]
        parts, (eJ, eK, Exc, Nel) = _finish(mesh, parts, [eJ, eK, Exc, Nel])
        Fa = ops.H0 + parts[0]
        Fb = ops.H0 + parts[-1]
        return (Fa, Fb, vdot(P, ops.T), vdot(P, ops.Vnuc), 0.5 * eJ, 0.5 * eK, Exc, Nel)

    return fock_fn, ops, g_l
