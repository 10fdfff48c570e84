"""Launch counters and input checks shared by the kernel wrappers."""

import numpy as np
import torch

# kernel launches per wrapper; a wrapper adds one where it launches its
# kernel and nowhere else (its plain CPU version does not count)
launches = {"radial_exchange": 0, "radial_erfc_exchange": 0, "radial_coulomb": 0,
            "radial_coulomb_dia": 0, "dia_xc_fields": 0, "dia_xc_fock": 0,
            "radial_exchange_dia_occ": 0, "radial_exchange_dia": 0, "matmul_f32": 0,
            "matmul_dd": 0, "refine_eig": 0}


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


def owner_table(gidx: np.ndarray, nrad: int) -> np.ndarray:
    """[nrad, 2] int32: owners[n] = the element slots e * nprim + i with
    gidx[e, i] = n, in element order, -1 where fewer than two. Built once per
    operator set or grid on the host; the kernels assemble "owner computes"
    from it (each output entry sums the element windows covering its row and
    column in a fixed order), so no block scans gidx. Raises where
    check_gidx does."""
    gidx = np.asarray(gidx)
    check_gidx(gidx, nrad)
    owners = np.full((nrad, 2), -1, dtype=np.int32)
    for slot, n in enumerate(gidx.ravel()):  # element order
        if n < nrad:
            owners[n, int(owners[n, 0] >= 0)] = slot
    return owners


def band_table(gidx: np.ndarray, owners: np.ndarray, nrad: int) -> np.ndarray:
    """[nrad, 2] int32: the first and last radial index of the elements that
    cover n (owner_table's), the columns an element window can reach from
    row n; the empty run (n, n - 1) where no element covers n, as on the
    element shard of a grid (parallel/mesh.py:shard_grid). Raises unless
    they form one run of at most 2 nprim - 1 indices, which holds for every
    FEMBasis layout."""
    gidx = np.asarray(gidx)
    nprim = gidx.shape[1]
    band = np.zeros((nrad, 2), dtype=np.int32)
    for n in range(nrad):
        if owners[n][0] < 0:
            band[n] = n, n - 1
            continue
        cover = np.unique(gidx[owners[n][owners[n] >= 0] // nprim])
        cover = cover[cover < nrad]
        band[n] = cover.min(), cover.max()
        if len(cover) != cover.max() - cover.min() + 1 or len(cover) > 2 * nprim - 1:
            raise ValueError("the elements covering a radial function do not span one "
                             "run of at most 2 nprim - 1 radial indices")
    return band


def launch_template(cache: dict, held: tuple, extra, build, views: tuple = ()):
    """build() once per (held, views, extra): a wrapper's launch arguments
    that depend only on the objects in `held` and the tensors in `views`
    (operator tensors or a grid, which the port never modifies in place)
    and on `extra` (hashable sizes).

    Looked up first by the ids of `held`, then by their memory (a tensor's
    address, dtype, shape and strides; other objects by id), so that a fresh
    view of a cached tensor (ops.tei[L]) finds its entry too. `views` are
    tensors that callers pass as a fresh view on every call
    (ops.LM_ilm[:njbd]): they are keyed by their memory alone, which costs
    less than a miss on the ids of all. An entry holds the objects it was
    built from, so neither their ids nor their memory can be reused while it
    lives; at most 16 entries."""
    vmem = tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride()) for t in views)
    key = (tuple(map(id, held)), vmem, extra)
    hit = cache.get(key)
    if hit is not None:
        return hit[1]
    mem = (tuple((t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
                 if isinstance(t, torch.Tensor) else id(t) for t in held), vmem, extra)
    hit = cache.get(mem)
    if hit is None:
        value = build()
        if len(cache) >= 16:
            cache.clear()
        hit = (held + views, value)
        cache[mem] = hit
        cache[key] = hit  # the ids of the objects the entry holds
    return hit[1]


def stream_scratch(cache: dict, stream: int, n: int, device) -> int:
    """The address of n doubles of kernel scratch kept for `stream`: made by
    PyTorch's caching allocator on first use and reused by every later call
    on that stream, whose launches the stream orders after each other.
    `cache` belongs to one launch template and lives as long as it does."""
    buf = cache.get(stream)
    if buf is None:
        buf = cache[stream] = torch.empty(n, dtype=torch.float64, device=device)
    return buf.data_ptr()


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every input lies on the CPU (the plain version runs), False
    when every input lies on one CUDA device (the kernel runs); raises on a
    mix or on any other device."""
    if all(t.is_cuda for t in tensors) and len({t.get_device() for t in tensors}) == 1:
        return False
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
