"""K8 matmul_f32 and K9 matmul_dd: the f64-ablation matmul probes, as
hand-written CUDA kernels (csrc/matmul_probe.cu) and their plain PyTorch
versions.

They replace the JAX package's four Pallas kernels:
scripts/pallas_f64_ablation.py:pallas_matmul_f32 and pallas_matmul_dd
(precision "full": true-f32 passes) and scripts/perf_campaign.py:stage_pallas
pmm32 and pmmdd (precision "reduced": the chip's default reduced-precision
pass, which on this card is TF32 on the tensor cores where the TPU's was
bf16). matmul_dd multiplies double-word operands x = hi + lo (split_dd) as
ah bh + ah bl + al bh with one f32 accumulator, the cheapest "more than f32"
scheme; tools/f64_ablation.py measures how far that is from an f64 product.
The probes are off the SCF path.
"""

import torch

from helfem_tpu_torch.kernels import _build
from helfem_tpu_torch.kernels._common import expect_shape, launches, on_cpu

__all__ = ["matmul_f32", "matmul_f32_plain", "matmul_dd", "matmul_dd_plain", "split_dd",
           "round_tf32", "TILE"]

TILE = (128, 128, 16)  # (m, n, k) must be multiples of these
_PRECISIONS = ("full", "reduced")
_TILE_BYTES = 128 * 32 * 4  # one TF32 operand tile


def _plan(m: int, n: int, k: int, precision: str, dd: bool) -> dict:
    """The launch csrc/matmul_probe.cu makes for these shapes: threads, ring
    stages, k-tile depth, dynamic shared memory (bytes) and grid; raises
    ValueError where the kernel would refuse to launch. "full": 256 threads,
    k-tiles of 16 through a cp.async ring of 4 stages (3 for matmul_dd) of
    transposed-A rows padded to 132 floats and B rows; "reduced": 384
    threads, k-tiles of 32 (the last one may be ragged) through a TMA ring
    of 192 KB, 6 stages of two 16 KB tiles or 3 of four, three mbarriers a
    stage and 1024 bytes of alignment slack."""
    if min(m, n, k) <= 0 or m % TILE[0] or n % TILE[1] or k % TILE[2]:
        raise ValueError(f"(m, n, k) = ({m}, {n}, {k}) must be positive multiples of {TILE}")
    if m // TILE[0] > 65535:
        raise ValueError(f"m = {m}: more than 65535 row tiles of {TILE[0]}")
    if precision == "full":
        stages = 3 if dd else 4
        plan = dict(threads=256, stages=stages, ktile=16,
                    smem=stages * (2 if dd else 1) * 16 * (132 + 128) * 4)
    else:
        stages = 3 if dd else 6
        plan = dict(threads=384, stages=stages, ktile=32,
                    smem=stages * (4 if dd else 2) * _TILE_BYTES + 3 * 8 * stages + 1024)
    return {**plan, "grid": (n // TILE[1], m // TILE[0])}


def split_dd(x64: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) f32 words of an f64 tensor: hi = f32(x), lo = f32(x - hi)."""
    hi = x64.to(torch.float32)
    lo = (x64 - hi.to(torch.float64)).to(torch.float32)
    return hi, lo


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as the kernel's cvt.rna.tf32.f32 rounds them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _check(name: str, precision: str, *mats: torch.Tensor) -> tuple[int, int, int]:
    if precision not in _PRECISIONS:
        raise ValueError(f"{name}: precision must be one of {_PRECISIONS}, got {precision!r}")
    a, b = mats[0], mats[len(mats) // 2]
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} x {tuple(b.shape)} do not multiply")
    (m, k), n = a.shape, b.shape[1]
    for arg, t in zip(("a", "al", "b", "bl") if len(mats) == 4 else ("a", "b"), mats):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        expect_shape(name, arg, t, (m, k) if arg.startswith("a") else (k, n))
    try:
        _plan(m, n, k, precision, len(mats) == 4)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return m, n, k


def _launch(name, ah, al, bh, bl, m, n, k, precision):
    dev = ah.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = _build.lib().matmul_probe_launch(
        ah.data_ptr(), al.data_ptr() if al is not None else None, bh.data_ptr(),
        bl.data_ptr() if bl is not None else None, out.data_ptr(), m, n, k,
        int(precision == "reduced"), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {err}")
    launches[name] += 1
    return out


def matmul_f32(a: torch.Tensor, b: torch.Tensor, precision: str = "full") -> torch.Tensor:
    """a @ b for f32 a [m, k], b [k, n] with m, n, k multiples of TILE.
    precision "full": f32 FFMA; "reduced": TF32 inputs, f32 accumulate. CPU
    inputs run the plain version; CUDA inputs launch the kernel."""
    name = "matmul_f32"
    if on_cpu(name, a, b):
        _check(name, precision, a, b)
        return matmul_f32_plain(a, b, precision)
    m, n, k = _check(name, precision, a, b)
    return _launch(name, a, None, b, None, m, n, k, precision)


def matmul_dd(ah: torch.Tensor, al: torch.Tensor, bh: torch.Tensor, bl: torch.Tensor,
              precision: str = "full") -> torch.Tensor:
    """ah bh + ah bl + al bh in one f32 accumulator, for the hi and lo f32
    words of two double-word matrices (split_dd); shapes, precisions and
    routing as matmul_f32."""
    name = "matmul_dd"
    if on_cpu(name, ah, al, bh, bl):
        _check(name, precision, ah, al, bh, bl)
        return matmul_dd_plain(ah, al, bh, bl, precision)
    m, n, k = _check(name, precision, ah, al, bh, bl)
    return _launch(name, ah, al, bh, bl, m, n, k, precision)


def _true_f32_matmul(terms) -> torch.Tensor:
    """Sum of x @ y over (x, y) in terms with
    torch.backends.cuda.matmul.allow_tf32 set False for the products (its
    default; a caller may have changed it), restored afterwards."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = None
        for x, y in terms:
            out = x @ y if out is None else out + x @ y
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def matmul_f32_plain(a, b, precision: str = "full") -> torch.Tensor:
    """Plain PyTorch version of matmul_f32: a @ b in true f32, the inputs
    first rounded to TF32 for precision "reduced"."""
    if precision == "reduced":
        a, b = round_tf32(a), round_tf32(b)
    return _true_f32_matmul([(a, b)])


def matmul_dd_plain(ah, al, bh, bl, precision: str = "full") -> torch.Tensor:
    """Plain PyTorch version of matmul_dd: three true-f32 products, summed
    in f32."""
    if precision == "reduced":
        ah, al, bh, bl = (round_tf32(x) for x in (ah, al, bh, bl))
    return _true_f32_matmul([(ah, bh), (ah, bl), (al, bh)])
