"""`python -m helfem_tpu_torch.tools.f64_ablation [N] [--device cuda]`: can
f64 emulated from f32 words beat the card's own f64 matrix product?

The counterpart of the JAX package's scripts/pallas_f64_ablation.py:main
and scripts/perf_campaign.py:stage_pallas. On one n x n product (n = 2048 by
default, standard-normal operands from a numpy seed) it measures

  1. torch.matmul in f64, the product the whole port rides on;
  2. matmul_f32 (kernels/matmul_probe.py), an f32 product written by hand,
     at precision "full" (f32 FFMA) and "reduced" (TF32 tensor cores);
  3. matmul_dd, the double-word product ah bh + ah bl + al bh of hi + lo f32
     splits, at both precisions, its rate counted as logical f64 flops
     (2 n^3), and its accuracy against the f64 product: one f32 accumulator
     loses about sqrt(K) 2^-24 relative, far from the 1e-12 the SCF needs,

and prints one JSON line. Times are CUDA-event means on the card; on the
CPU (where the plain versions run) they are host-clock means and say
nothing about the card.
"""

import argparse
import json
import time

import numpy as np
import torch

from helfem_tpu_torch.cli._common import open_device
from helfem_tpu_torch.kernels.matmul_probe import TILE, matmul_dd, matmul_f32, split_dd

F64_TARGET_REL_ERR = 1e-12


def _seconds(fn, device: torch.device, warmup: int = 3, reps: int = 10) -> float:
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e-3 / reps


def run(n: int, device: torch.device, seed: int = 0) -> dict:
    if n % max(TILE):
        raise SystemExit(f"N must be a multiple of {max(TILE)}, got {n}")
    rng = np.random.default_rng(seed)
    a64 = torch.tensor(rng.standard_normal((n, n)), device=device)
    b64 = torch.tensor(rng.standard_normal((n, n)), device=device)
    a32, b32 = a64.to(torch.float32), b64.to(torch.float32)
    ah, al = split_dd(a64)
    bh, bl = split_dd(b64)
    flops = 2.0 * n**3
    ref = a64 @ b64
    scale = float(ref.abs().max())

    def tflops(fn) -> float:
        return flops / _seconds(fn, device) / 1e12

    def rel_err(x: torch.Tensor) -> float:
        return float((x.to(torch.float64) - ref).abs().max()) / scale

    out = {
        "n": n,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu (plain versions; not a card measurement)"),
        "torch_f64_tflops": tflops(lambda: a64 @ b64),
    }
    for prec in ("full", "reduced"):
        out[f"matmul_f32_{prec}_tflops"] = tflops(lambda: matmul_f32(a32, b32, prec))
        out[f"matmul_dd_{prec}_tflops_logical"] = tflops(
            lambda: matmul_dd(ah, al, bh, bl, prec))
        out[f"matmul_f32_{prec}_max_rel_err"] = rel_err(matmul_f32(a32, b32, prec))
        out[f"matmul_dd_{prec}_max_rel_err"] = rel_err(matmul_dd(ah, al, bh, bl, prec))
    out["f64_target_rel_err"] = F64_TARGET_REL_ERR
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.tools.f64_ablation",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=2048, help="matrix size (default 2048)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA kernels, cpu their plain "
                        "PyTorch versions")
    args = p.parse_args(argv)
    out = run(args.n, open_device(args.device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
