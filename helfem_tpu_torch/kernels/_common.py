"""Launch counters and input checks shared by the kernel wrappers."""

import numpy as np
import torch

# kernel launches per wrapper; a wrapper adds one where it launches its
# kernel and nowhere else (its plain CPU version does not count)
launches = {"radial_exchange": 0, "radial_coulomb": 0, "radial_coulomb_dia": 0,
            "dia_xc_fields": 0, "dia_xc_fock": 0, "radial_exchange_dia_occ": 0,
            "radial_exchange_dia": 0, "matmul_f32": 0, "matmul_dd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_gidx(gidx: np.ndarray, nrad: int) -> None:
    """The kernels index with gidx unchecked: every value must lie in
    [0, nrad] (nrad = trash slot), and their owner-computes assembly
    (csrc/fem_owners.cuh) reads at most two element slots per global radial
    index. Raise if a layout breaks either."""
    gidx = np.asarray(gidx)
    if gidx.size and (gidx.min() < 0 or gidx.max() > nrad):
        raise ValueError(f"gidx values must lie in [0, {nrad}] (nrad = trash slot)")
    counts = np.bincount(gidx[gidx < nrad].ravel(), minlength=nrad)
    if counts.max(initial=0) > 2:
        raise ValueError("a global radial function is covered by more than "
                         "two element slots; the CUDA kernels assume two")


def grid_template(cache: dict, g, ns: int, build):
    """build() once per (grid, spin count): a wrapper's launch arguments that
    depend only on the grid (a DiaGridOps, immutable), cached under the
    grid's id with the grid itself held, so that the id stays its own; at
    most 8 entries."""
    key = (id(g), ns)
    hit = cache.get(key)
    if hit is not None and hit[0] is g:
        return hit[1]
    value = build()
    if len(cache) >= 8:
        cache.clear()
    cache[key] = (g, value)
    return value


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every input lies on the CPU (the plain version runs), False
    when every input lies on one CUDA device (the kernel runs); raises on a
    mix or on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def check_kernel_inputs(name: str, f64: dict, i32: dict) -> None:
    """dtype and contiguity checks before a launch."""
    for arg, t in f64.items():
        if t.dtype != torch.float64:
            raise TypeError(f"{name}: {arg} must be float64, got {t.dtype}")
    for arg, t in i32.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    for arg, t in {**f64, **i32}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def expect_shape(name: str, arg: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")
