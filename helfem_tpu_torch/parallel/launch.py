"""Process launch of the port's multi-device runs (torch.distributed).

helfem_tpu runs its mesh in one process (shard_map over a jax Mesh);
PyTorch's idiom is one process per rank. run() picks how a call over ndev
ranks runs:

* inside an initialized process group (the caller started the ranks, e.g.
  with torchrun): on this rank, over that group, which must hold exactly
  ndev ranks (mesh.make_mesh raises otherwise);
* outside any group with ndev == 1: over a one-rank group made in this
  process for the call and destroyed after it (local_group);
* outside any group with ndev > 1: spawn() starts ndev processes (the
  'spawn' start method: CUDA cannot be forked), joined by a FileStore in a
  temporary directory, and returns rank 0's result.

Backends (plan_backend): NCCL for CUDA devices, one card per rank
(cuda:<rank>), and gloo for the CPU. NCCL refuses two ranks on one card, so
on CUDA with fewer cards than ranks plan_backend raises before anything
starts. gloo on CUDA tensors runs only when the caller names
backend="gloo": the ranks then share the named card. NCCL is never
replaced by gloo, nor a run by fewer ranks.
"""

import contextlib
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

from helfem_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["TIMEOUT_S", "call", "in_group", "is_rank0", "local_group", "plan_backend", "run",
           "spawn", "to_device"]

# the process group's timeout: a rank that stops makes the others' next
# collective fail after this long instead of hanging the run
TIMEOUT_S = 120
# the thread counts a CPU rank runs with (one torch and one BLAS thread)
_ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def in_group() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def is_rank0() -> bool:
    """False on the ranks other than 0 of an initialized process group: they
    neither print nor write files."""
    return not in_group() or dist.get_rank() == 0


def plan_backend(ndev: int, device, backend: str | None = None, ncuda: int | None = None) -> str:
    """The backend of a run over ndev ranks on `device`: NCCL for CUDA, one
    card per rank, unless backend="gloo" is named (the ranks then share the
    card); gloo for the CPU. ncuda (default: the cards this process sees)
    is the number of CUDA devices. Raises for NCCL with fewer cards than
    ranks, before anything starts, and for NCCL on the CPU."""
    if ndev < 1:
        raise ValueError(f"ndev={ndev}: a run needs at least one rank")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' (CUDA) or 'gloo'")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, not {device}")
        have = torch.cuda.device_count() if ncuda is None else ncuda
        if have < ndev:
            raise RuntimeError(
                f"--ndev {ndev} with NCCL needs {ndev} CUDA devices, one per rank; "
                f"{have} {'is' if have == 1 else 'are'} visible. NCCL does not run two ranks "
                "on one card: name backend='gloo' to share one")
    return backend


def _rank_device(device, backend: str, rank: int) -> torch.device:
    """cuda:<rank> for NCCL, else the named device (CUDA without an index:
    the current card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", torch.cuda.current_device() if device.index is None
                        else device.index)


def to_device(obj, device):
    """obj with every tensor in it (also inside tuples, NamedTuples such as
    the operators and grids, lists and dicts) moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def _init(backend: str, store_path: str, rank: int, size: int, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store_path, size), rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=TIMEOUT_S))


@contextlib.contextmanager
def local_group(device, backend: str | None = None):
    """A one-rank process group in this process (NCCL on CUDA, gloo on the
    CPU), as its Mesh, destroyed on exit."""
    backend = plan_backend(1, device, backend)
    dev = _rank_device(device, "gloo", 0)  # the named card, not cuda:0
    work = tempfile.mkdtemp(prefix="helfem_mesh_")
    previous = torch.cuda.current_device() if dev.type == "cuda" else None
    try:
        _init(backend, os.path.join(work, "store"), 0, 1, dev)
        try:
            yield make_mesh(1, backend, dev)
        finally:
            dist.destroy_process_group()
    finally:
        if previous is not None:
            torch.cuda.set_device(previous)
        shutil.rmtree(work, ignore_errors=True)


@contextlib.contextmanager
def _one_thread_env(on: bool):
    """One OpenMP/BLAS thread in the processes started inside (their BLAS
    reads the variables when it loads)."""
    saved = {k: os.environ.get(k) for k in _ONE_THREAD}
    if on:
        os.environ.update(dict.fromkeys(_ONE_THREAD, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _rank_main(rank, size, backend, device, store_path, fn, payload, results):
    """One spawned rank: join the group, run fn(mesh, payload), report."""
    try:
        dev = _rank_device(device, backend, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        _init(backend, store_path, rank, size, dev)
        try:
            out = fn(make_mesh(size, backend, dev), payload)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        sys.stdout.flush()
        # pickled here: the queue's feeder thread would drop what fails
        report = pickle.dumps((rank, None, to_device(out, "cpu") if rank == 0 else None))
    except BaseException as exc:  # reported to the caller, which re-raises it
        sys.stdout.flush()
        tb = traceback.format_exc()
        try:
            report = pickle.dumps((rank, (exc, tb), None))
        except Exception:  # an exception that does not pickle
            report = pickle.dumps((rank, (RuntimeError(repr(exc)), tb), None))
    results.put(report)


def _check_pickles(payload, ndev: int) -> None:
    from multiprocessing.reduction import ForkingPickler

    import torch.multiprocessing  # noqa: F401 -- registers its tensor reductions there

    try:
        ForkingPickler.dumps(payload)
    except Exception as exc:
        raise TypeError(
            f"the arguments of a run over {ndev} ranks started here must pickle (each rank is "
            f"a new process): {exc}. A save_cb closure does not: build it inside the rank, "
            "as the CLIs do, or call from inside a process group") from exc


def _collect(procs, results, ndev: int):
    """Rank 0's result once every rank has reported; the first rank's
    exception, re-raised, as soon as one reports one or dies."""
    done = {}
    while len(done) < ndev:
        try:
            report = results.get(timeout=0.5)
        except queue_mod.Empty:
            gone = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if not gone:
                continue
            try:  # its own report may still be in the pipe
                report = results.get(timeout=2.0)
            except queue_mod.Empty:
                r, code = gone[0]
                raise RuntimeError(f"rank {r} of {ndev} exited with code {code} without a "
                                   "report") from None
        rank, err, out = pickle.loads(report)
        if err is not None:
            exc, tb = err
            exc.add_note(f"(raised on rank {rank} of {ndev}; its traceback:)\n{tb}")
            raise exc
        done[rank] = out
    return done[0]


def spawn(fn, ndev: int, payload, backend: str | None = None, device="cpu"):
    """fn(mesh, payload) on ndev new processes, one rank each; returns rank
    0's result (its tensors on the CPU). fn must be a module-level function
    and payload must pickle; its tensors go to the ranks as CPU copies
    (mesh.device is each rank's device: cuda:<rank> under NCCL, `device`
    under gloo). An exception in any rank is re-raised here, and the other
    ranks are stopped. The CUDA kernels are built here first, so that the
    ranks load one build instead of racing into one build directory; CPU
    ranks run one torch and one BLAS thread each."""
    device = torch.device(device)
    backend = plan_backend(ndev, device, backend)
    payload = to_device(payload, "cpu")
    _check_pickles(payload, ndev)
    if device.type == "cuda":
        from helfem_tpu_torch.kernels import _build

        _build.lib()
    sys.stdout.flush()  # before the ranks write to the same stream
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    work = tempfile.mkdtemp(prefix="helfem_ranks_")
    store = os.path.join(work, "store")
    procs = [ctx.Process(target=_rank_main, name=f"helfem-rank-{r}",
                         args=(r, ndev, backend, str(device), store, fn, payload, results))
             for r in range(ndev)]
    started = []
    try:
        with _one_thread_env(device.type == "cpu"):
            for p in procs:
                p.start()
                started.append(p)
        return _collect(procs, results, ndev)
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join()
        results.close()
        shutil.rmtree(work, ignore_errors=True)


def run(fn, ndev: int, payload, device, backend: str | None = None):
    """fn(mesh, payload) over ndev ranks: on this rank of the initialized
    process group, over a one-rank group here (ndev 1), or on ndev spawned
    processes (rank 0's result)."""
    if in_group():
        return fn(make_mesh(ndev, backend, device), payload)
    if ndev == 1:
        with local_group(device, backend) as mesh:
            return fn(mesh, payload)
    return spawn(fn, ndev, payload, backend, device)


def _call_rank(mesh: Mesh, payload):
    fn, args, kwargs = payload
    kwargs = {**to_device(kwargs, mesh.device), "device": mesh.device}
    return to_device(fn(*to_device(args, mesh.device), **kwargs), "cpu")


def call(fn, ndev: int, args: tuple, kwargs: dict, device, backend: str | None = None):
    """fn(*args, **kwargs, device=<the rank's device>) over ndev ranks (run),
    the tensors in args and kwargs moved to each rank's device: the SCF
    drivers' own route for ndev outside a process group."""
    return run(_call_rank, ndev, (fn, args, kwargs), device, backend)
