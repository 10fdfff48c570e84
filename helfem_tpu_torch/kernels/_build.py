"""Build and load the port's CUDA kernels.

The sources in helfem_tpu_torch/csrc/ have a plain C interface. Each is
compiled by its own nvcc process for sm_90a, all started together, and the
objects are linked into one shared library under helfem_tpu_torch/_build/
at first use, and again whenever a source is newer than the library, then
loaded with ctypes. Nothing here runs at import time, so importing the
kernels needs neither nvcc nor a GPU.
"""

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "lib"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libhelfem_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# entry point -> argument types (pointers and the stream as c_void_p: a plain
# int would be cut to 32 bits)
_SIGNATURES = {
    "radial_exchange_launch": [_P],
    "radial_exchange_smem": [_P],
    "radial_erfc_exchange_launch": [_P],
    "radial_erfc_exchange_smem": [_P],
    "radial_coulomb_launch": [_P],
    "radial_coulomb_smem": [_P],
    "radial_coulomb_dia_launch": [_P],
    "radial_coulomb_dia_smem": [_P],
    "radial_coulomb_dia_grid": [_P],
    "dia_xc_fields_launch": [_P],
    "dia_xc_fock_launch": [_P],
    "radial_exchange_dia_occ_launch": [_P] * 14 + [_I] * 10 + [_P],
    "radial_exchange_dia_launch": [_P] * 11 + [_I] * 8 + [_P],
    "matmul_probe_launch": [_P] * 5 + [_I] * 5 + [_P],
    "matmul_probe_smem": [_I] * 2,
    "refine_eig_launch": [_P] * 6 + [_I] * 5 + [_D, _P],
}

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of helfem_tpu_torch cannot be built")


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(s.stat().st_mtime > built for s in CSRC.iterdir())


def build(ptxas_verbose: bool = False) -> tuple[float, str]:
    """Compile every csrc/*.cu (one nvcc each, in parallel) and link the
    shared library; returns (seconds, compiler messages). ptxas_verbose adds
    each kernel's register, shared memory and spill counts to the
    messages."""
    global _lib
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(obj), str(src)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{out}")
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = BUILD_DIR / f"{LIBRARY.stem}.{tag}.so"
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, LIBRARY)  # atomic: a concurrent loader sees old or new
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    _lib = None
    return time.perf_counter() - t0, "".join(log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    if _lib is None:
        if _stale():
            build()
        handle = ctypes.CDLL(str(LIBRARY))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib
