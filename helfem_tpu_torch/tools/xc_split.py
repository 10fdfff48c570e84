"""`python -m helfem_tpu_torch.tools.xc_split`: where the diatomic XC kernels
K4 (dia_xc_fields) and K5 (dia_xc_fock) spend their time on the card.

Builds variants of csrc/dia_xc_fields.cu and csrc/dia_xc_fock.cu into
helfem_tpu_torch/_build/ by setting work counts to 0: "full" (the kernels
as they are), "pairs_only" (K4's pair stage, K5's pair potentials and
element blocks), "grid_only" (K4's grid contraction, K5's zero fill and
window assembly, on stale scratch), "no_fill" (K5 without zeroing F),
"staging_only" (K4's phase-1 staging without its tiles; K5's phase A),
"fill_only" (K5's zero fill alone; K4 empty) and "empty" (the cooperative
launch and the barriers alone). Times both kernels at the N2
(6,6) bench shapes for two spins and at the N2 lmax=12 shapes for one, one
process per library: the call time (CUDA events over back-to-back
wrapper calls), the device time per call (torch.profiler) and the host's
enqueue time per call (wall clock of 200 calls without a synchronise, the
wrapper's Python and the launch API). The variants' results are wrong by
design; only their times mean something.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time


def _zero(line: str) -> tuple[str, str]:
    """Replace the work count on `line` (`... = <count>;`) by 0."""
    return line, line[:line.index("=") + 1] + " 0;\n"


K4_P1 = _zero("  const int n1 = g.ns * g.nelem * g.npc * g.nqc;\n")
K4_P2 = _zero("  const int n2 = g.ns * g.nelem * nqt * ntt;\n")
K4_TILES = ("    for (int task = warp; task < npx * ntile; task += XCF_WARPS) {\n",
            "    for (int task = warp; task < 0; task += XCF_WARPS) {\n")
K5_A = _zero("  const int nA = g.ns * g.nelem * nqt * npt;\n")
K5_FILL = _zero("  const size_t nF2 = (size_t)g.ns * nbf * nbf / 2;  // double2 stores\n")
K5_B = _zero("  const int nB = g.ns * g.nelem * npt * njt;\n")
K5_C = _zero("  const int nC = g.ns * g.npl * 2 * g.nrad;\n")
VARIANTS = {  # name -> replacements in (dia_xc_fields.cu, dia_xc_fock.cu)
    "full": ([], []),
    "pairs_only": ([K4_P2], [K5_FILL, K5_C]),  # K4 phase 1; K5 phases A and B
    "grid_only": ([K4_P1], [K5_A, K5_B]),  # K4 phase 2; K5 zero fill and phase C
    "staging_only": ([K4_P2, K4_TILES], [K5_FILL, K5_B, K5_C]),  # K4 phase-1 staging; K5 A
    "no_fill": ([], [K5_FILL]),
    "fill_only": ([K4_P1, K4_P2], [K5_A, K5_B, K5_C]),
    "empty": ([K4_P1, K4_P2], [K5_A, K5_FILL, K5_B, K5_C]),
}
SOURCES = ("dia_xc_fields.cu", "dia_xc_fock.cu")


def build_variant(name: str) -> str:
    from helfem_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    cus = []
    for source, edits in zip(SOURCES, VARIANTS[name]):
        src = (_build.CSRC / source).read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"xc_split: {name}: {source} no longer has {old!r}")
            src = src.replace(old, new)
        cu = _build.BUILD_DIR / f"xc_{name}_{source}"
        cu.write_text(src)
        cus.append(str(cu))
    lib = _build.BUILD_DIR / f"libxc_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o",
                    str(lib), *cus],
                   check=True, capture_output=True, timeout=600)
    return str(lib)


def time_library(lib: str) -> list[dict]:
    import torch

    import chip_smoke as cs
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels import _build
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.utils.profiling import device_ms

    handle = ctypes.CDLL(lib)
    for fn in ("dia_xc_fields_launch", "dia_xc_fock_launch"):
        getattr(handle, fn).argtypes = _build._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    _build._lib = handle
    dev = torch.device("cuda", 0)
    out = []
    for shape, cfg, ns, reps in (("n2", cs.DIA_SHAPES["n2"], 2, 50),
                                 ("lmax12", cs.N2_L12_SHAPE, 1, 10)):
        inputs = cs.xc_kernel_inputs(DiatomicBasis(**cfg), dev, ns)
        for name, (args, _, _) in inputs.items():
            kern = getattr(kernels, name)
            ms = cs.cuda_ms(lambda: kern(*args), 3, reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                kern(*args)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            out.append({"shape": shape, "spins": ns, "name": name, "ms": ms,
                        "device_ms": device_ms(lambda: kern(*args), reps),
                        "host_enqueue_us": host_us})
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
        res = subprocess.run([sys.executable, "-m", "helfem_tpu_torch.tools.xc_split",
                              "--library", lib], capture_output=True, text=True, timeout=900,
                             check=True).stdout
        for r in json.loads(res.strip().splitlines()[-1]):
            print(json.dumps({"variant": name, **r}), flush=True)


if __name__ == "__main__":
    main()
