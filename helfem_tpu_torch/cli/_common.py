"""Helpers shared by the port's CLIs: electron counts, functional parameter
files, the device, the checkpoint formats and crash-recovery hook of
--save, and the SCF of --ndev over its ranks."""

import contextlib
import io
import time
from types import SimpleNamespace

import numpy as np

__all__ = ["H5_SUFFIXES", "add_xc_flags", "apply_pars_files", "crash_hook", "is_hdf5",
           "open_device", "parse_nela_nelb", "rank0_only", "scf_on_ranks"]

# a checkpoint path with one of these suffixes is a reference-schema HDF5
# file (utils/checkpoint_h5.py), any other an npz one (utils/checkpoint.py)
H5_SUFFIXES = (".chk", ".h5", ".hdf5")


def is_hdf5(path: str) -> bool:
    return path.endswith(H5_SUFFIXES)


def parse_nela_nelb(Z: int, Q: int, M: int, nela: int, nelb: int):
    """(reference: scf::parse_nela_nelb)."""
    if nela or nelb:
        return nela, nelb
    nel = Z - Q
    if M == 0:
        M = 1 if nel % 2 == 0 else 2
    na = (nel + M - 1) // 2
    return na, nel - na


def add_xc_flags(p, mdft: bool = True) -> None:
    """--x_pars and --c_pars, and with mdft --mdft, as helfem_tpu's CLIs
    define them."""
    if mdft:
        p.add_argument("--mdft", type=int, default=0,
                       help="accepted for reference parity; the phi integral is evaluated "
                            "analytically here, so it has no effect")
    p.add_argument("--x_pars", default="", help="file of 'key=value' parameter overrides for "
                   "the exchange functional")
    p.add_argument("--c_pars", default="", help="same for the correlation functional")


def apply_pars_files(method: str, x_pars: str, c_pars: str) -> str:
    """Fold --x_pars/--c_pars parameter files into the method string, as
    helfem_tpu's _apply_pars_files does (helfem_tpu/cli/atomic.py:12-37;
    reference: libxc ext_params files, src/atomic/main.cpp:107-108): the
    files hold 'key=value' lines ('#' starts a comment) matched against the
    functional's named parameters. Only an 'x_func,c_func' pair (or a
    single functional with --x_pars) takes parameter files. The method is
    returned unchanged when neither file is given."""
    if not (x_pars or c_pars):
        return method
    parts = method.split(",")
    if len(parts) > 2 or "[" in method:
        raise SystemExit("--x_pars/--c_pars need a plain 'x_func,c_func' method")

    def read(path):
        kv = []
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if line:
                    kv.append(line.replace(" ", ""))
        return ",".join(kv)

    if x_pars:
        parts[0] = f"{parts[0]}[{read(x_pars)}]"
    if c_pars:
        if len(parts) < 2:
            raise SystemExit("--c_pars given but the method has no correlation part")
        parts[1] = f"{parts[1]}[{read(c_pars)}]"
    return ",".join(parts)


def open_device(name: str):
    """The torch device of --device; raises for cuda when no card is
    present (nothing falls back to the CPU)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return device


def crash_hook(save_path: str, basis, save):
    """The crash-recovery hook of the atomic and diatomic CLIs (helfem_tpu
    cli/atomic.py:257-281, cli/diatomic.py:205-225): each call's state
    written by save(path, basis, state) as an npz checkpoint at save_path,
    or beside it as <save_path>.crash.npz when save_path names an HDF5
    file (the HDF5 file is written once, at the end). Returns (save_cb,
    writes), writes the list of (iteration, seconds) of its calls."""
    path = save_path + ".crash.npz" if is_hdf5(save_path) else save_path
    writes = []

    def save_cb(it, Etot, Ea, Ca, occa, Eb, Cb, occb):
        t0 = time.perf_counter()
        state = SimpleNamespace(
            converged=False, E=Etot, orbE_a=np.sort(np.asarray(Ea).ravel()), orbs_a=Ca,
            occ_a=occa, orbE_b=None if Eb is None else np.sort(np.asarray(Eb).ravel()),
            orbs_b=Cb, occ_b=occb)
        save(path, basis, state)
        writes.append((it, time.perf_counter() - t0))

    return save_cb, writes


def rank0_only(main, argv):
    """main(argv, writes): writes is False, and the output is dropped, on the
    ranks other than 0 of an initialized process group (a CLI started on
    every rank, e.g. by torchrun), where main must write no file: rank 0
    alone prints and writes."""
    from helfem_tpu_torch.parallel.launch import is_rank0

    if is_rank0():
        return main(argv, True)
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv, False)


def scf_on_ranks(scf, ndev: int, basis, nela: int, nelb: int, kwargs: dict, save_path: str,
                 save, device):
    """scf(basis, nela, nelb, **kwargs) over ndev ranks (parallel/launch.py:
    run; spawned ranks get copies of the arguments), the crash-recovery hook
    of save_path (crash_hook with save) built on rank 0 alone: the ranks
    other than 0 neither print nor write. Returns rank 0's (result, the
    hook's writes)."""
    from helfem_tpu_torch.parallel import launch

    return launch.run(_scf_rank, ndev, (scf, basis, nela, nelb, kwargs, save_path, save),
                      device)


def _scf_rank(mesh, payload):
    from helfem_tpu_torch.parallel.launch import to_device

    scf, basis, nela, nelb, kwargs, save_path, save = payload
    save_cb, writes = None, []
    if save_path and mesh.rank == 0:
        save_cb, writes = crash_hook(save_path, basis, save)
    res = scf(basis, nela, nelb, **to_device(kwargs, mesh.device), save_cb=save_cb,
              ndev=mesh.size)
    return res, writes
