"""`python -m helfem_tpu_torch.tools.radial_split`: where the atomic radial
kernels K1 (radial_exchange) and K2 (radial_coulomb) spend their time on the
card.

Builds variants of csrc/radial_exchange.cu and csrc/radial_coulomb.cu into
helfem_tpu_torch/_build/ by setting work counts to 0 or dropping calls:
"full" (the kernels as they are), "phase1_only" (no assembly), "in_element"
(K1's in-element band tasks alone; K2's phase 1), "cross_only" (K1's cross
tasks alone; K2 empty), "cross_staging" (K1's cross tasks staging their
windows and factors, without their products), "cross_T" (with their first
products T = W Y^T, without Kp = X T and its stores), "staging_only" (the band tasks' shared-memory
staging without their tiles), "tiles_only" (the band tiles on stale shared
memory, without staging), "assembly_only" (phase 2 on stale scratch) and
"empty" (the cooperative launch and the barrier alone). Times both kernels
at the Ar and Xe bench shapes, one process per library: the call time
(CUDA events over back-to-back wrapper calls), the device time per call
(torch.profiler) and the host's enqueue time per call (wall clock of 200
calls without a synchronise: the wrapper's Python and the launch API). The
variants' results are wrong by design; only their times mean something.
"""

import argparse
import ctypes
import json
import subprocess
import sys


def _zero(line: str) -> tuple[str, str]:
    """Replace the work count on `line` (`... = <count>;`) by 0."""
    return line, line[:line.index("=") + 1] + " 0;\n"


K2_P1 = _zero("  const int ntask = a.NL * nelem * nband * ngrp;\n")
K2_P2 = _zero("  const int nrows = nLM * nrun;\n")
K1_IN = _zero("  const int nin = a.NL * nelem * nband * ngrp;\n")
K1_CROSS = _zero("  const int ncross = nelem * (nelem - 1) * nag * ngg;\n")
K1_P2 = _zero("  const int nrows = a.NL * nang * a.nb * 2;\n")
_MMA = "      band_chunk(As, Bs, ld, rb_ceil(nu * np, 4), a.R, nr, ntn, acc);\n"
NO_MMA = (_MMA, "\n")
NO_ITEMS = ("  for (int item = warp; item < na * ng; item += RB_WARPS) {\n",
            "  for (int item = warp; item < 0; item += RB_WARPS) {\n")
NO_KP = ("      for (int t0 = 0; t0 < ntile; t0 += RB_NT) {  // Kp[i][j] = sum_p X[i][p] T[p][j]\n",
         "      for (int t0 = 0; t0 < 0; t0 += RB_NT) {\n")
NO_STAGE = [("      stage_rows(", "      if (0) stage_rows("),
            ("      stage_window(", "      if (0) stage_window(")]
VARIANTS = {  # name -> replacements in (radial_exchange.cu, radial_coulomb.cu)
    "full": ([], []),
    "phase1_only": ([K1_P2], [K2_P2]),
    "in_element": ([K1_CROSS, K1_P2], [K2_P2]),
    "cross_only": ([K1_IN, K1_P2], [K2_P1, K2_P2]),
    "cross_staging": ([K1_IN, K1_P2, NO_ITEMS], [K2_P1, K2_P2]),
    "cross_T": ([K1_IN, K1_P2, NO_KP], [K2_P1, K2_P2]),
    "staging_only": ([NO_MMA, K1_CROSS, K1_P2], [NO_MMA, K2_P2]),
    "tiles_only": ([*NO_STAGE, K1_CROSS, K1_P2], [*NO_STAGE, K2_P2]),
    "assembly_only": ([K1_IN, K1_CROSS], [K2_P1]),
    "empty": ([K1_IN, K1_CROSS, K1_P2], [K2_P1, K2_P2]),
}
SOURCES = ("radial_exchange.cu", "radial_coulomb.cu")
ENTRIES = ("radial_exchange_launch", "radial_coulomb_launch")


def build_variant(name: str) -> str:
    from helfem_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    cus = []
    for source, edits in zip(SOURCES, VARIANTS[name]):
        src = (_build.CSRC / source).read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"radial_split: {name}: {source} no longer has {old!r}")
            src = src.replace(old, new)
        cu = _build.BUILD_DIR / f"radial_{name}_{source}"
        cu.write_text(src)
        cus.append(str(cu))
    lib = _build.BUILD_DIR / f"libradial_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o",
                    str(lib), *cus],
                   check=True, capture_output=True, timeout=600)
    return str(lib)


def time_library(lib: str) -> list[dict]:
    import torch

    import chip_smoke as cs
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels import _build
    from helfem_tpu_torch.tools.radial_timing import host_enqueue_us
    from helfem_tpu_torch.utils.profiling import device_ms

    handle = ctypes.CDLL(lib)
    for fn in ENTRIES:
        getattr(handle, fn).argtypes = _build._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    _build._lib = handle
    dev = torch.device("cuda", 0)
    out = []
    for shape in ("ar", "xe"):
        for name, (args, _, _) in cs.kernel_inputs(cs.SHAPES[shape], dev).items():
            kern = getattr(kernels, name)
            out.append({"shape": shape, "name": name, "ms": cs.cuda_ms(lambda: kern(*args)),
                        "device_ms": device_ms(lambda: kern(*args), 50),
                        "host_enqueue_us": host_enqueue_us(lambda: kern(*args))})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--library", help="time this one library (a child process does)")
    p.add_argument("--variants", nargs="*", default=list(VARIANTS))
    args = p.parse_args(argv)
    if args.library:
        print(json.dumps(time_library(args.library)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for name in args.variants:
        lib = build_variant(name)
        res = subprocess.run([sys.executable, "-m", "helfem_tpu_torch.tools.radial_split",
                              "--library", lib], capture_output=True, text=True, timeout=900,
                             check=True).stdout
        for r in json.loads(res.strip().splitlines()[-1]):
            print(json.dumps({"variant": name, **r}), flush=True)


if __name__ == "__main__":
    main()
