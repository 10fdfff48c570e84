"""`python -m helfem_tpu_torch.tools.coulomb_dia_split`: where the diatomic
Coulomb kernel K3 (radial_coulomb_dia) spends its time on the card.

Builds variants of csrc/radial_coulomb_dia.cu into helfem_tpu_torch/_build/
by setting work counts to 0 or dropping steps: "full" (the kernel as it
is), "phase1_only" (no assembly), "no_traces" (phase 1 without its trace
tasks), "no_shuffles" (the row sums left unreduced across lanes),
"rows_only" (the table rows streamed through the rings and summed, without
the trace tasks, the window gathers or the assembly), "tasks_only" (the row
tasks' gathers, barriers and column partials, without a table row),
"assembly_only" (phase 2 on stale scratch) and "empty" (the cooperative
launch, the table staging and the barrier alone). --rows R forces the row
band of the host plan. Times K3 at the N2 (6,6) bench and the N2 lmax=12
bases (coulomb_dia_timing.py's inputs), one process per library: the call
time (CUDA events over back-to-back wrapper calls), the device time per
call (torch.profiler) and the host's enqueue time per call. The variants'
results are wrong by design; only their times mean something.
"""

import argparse
import ctypes
import json
import subprocess
import sys


def _zero(line: str) -> tuple[str, str]:
    """Replace the work count on `line` (`... = <count>;`) by 0."""
    return line, line[:line.index("=") + 1] + " 0;\n"


P1 = _zero("  const int ntask = a.G * nelem * nrb * ncb;\n")
P2 = _zero("  const int nrows = a.S * nrun;\n")
TRACES = ("  for (int g = gridDim.x - 1 - blockIdx.x; g < a.G; g += gridDim.x) {\n",
          "  for (int g = gridDim.x - 1 - blockIdx.x; g < 0; g += gridDim.x) {\n")
SHUFFLES = [("        out[2 * ch] = warp_sum(s0);\n", "        out[2 * ch] = s0;\n"),
            ("        out[2 * ch + 1] = warp_sum(s2);\n", "        out[2 * ch + 1] = s2;\n")]
GATHER = ("    for (int idx = tid; idx < ngather; idx += RB_THREADS) {\n",
          "    for (int idx = tid; idx < 0; idx += RB_THREADS) {\n")
ROWS = ("    const int nw = warp < t.nr ? (t.nr - warp + 7) / 8 : 0;\n",
        "    const int nw = 0;\n")
STREAM = ("inw = warp < it.nr ? (it.nr - warp + 7) / 8 : 0;", "inw = 0;")  # twice
VARIANTS = {  # name -> replacements in radial_coulomb_dia.cu
    "full": [],
    "phase1_only": [P2],
    "no_traces": [TRACES],
    "no_shuffles": SHUFFLES,
    "rows_only": [TRACES, GATHER, P2],
    "tasks_only": [ROWS, STREAM, P2],
    "assembly_only": [P1],
    "empty": [P1, P2],
}
SOURCE = "radial_coulomb_dia.cu"
ENTRIES = ("radial_coulomb_dia_launch", "radial_coulomb_dia_grid")


def build_variant(name: str) -> str:
    from helfem_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = (_build.CSRC / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"coulomb_dia_split: {name}: {SOURCE} no longer has {old!r}")
        src = src.replace(old, new)
    cu = _build.BUILD_DIR / f"coulomb_dia_{name}.cu"
    cu.write_text(src)
    lib = _build.BUILD_DIR / f"libcoulomb_dia_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o",
                    str(lib), str(cu)], check=True, capture_output=True, timeout=600)
    return str(lib)


def time_library(lib: str, rows: int | None) -> list[dict]:
    import importlib
    import math

    import torch

    import chip_smoke as cs
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels import _build
    from helfem_tpu_torch.tools.coulomb_dia_timing import SHAPES, k3_inputs
    from helfem_tpu_torch.tools.radial_timing import host_enqueue_us
    from helfem_tpu_torch.utils.profiling import device_ms

    handle = ctypes.CDLL(lib)
    for fn in ENTRIES:
        getattr(handle, fn).argtypes = _build._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    _build._lib = handle
    if rows:  # the host plan with its row band forced to `rows`
        mod = importlib.import_module("helfem_tpu_torch.kernels.radial_coulomb_dia")
        plan = mod.plan

        def forced(S, G, CH, nelem, nprim, nrad, nblocks):
            p = plan(S, G, CH, nelem, nprim, nrad, nblocks)
            nrb = math.ceil(nprim * nprim / rows)
            return p._replace(R=rows, nrb=nrb, tasks=G * nelem * nrb * p.ncb)

        mod.plan = forced
    dev = torch.device("cuda", 0)
    out = []
    for shape, cfg in SHAPES.items():
        args = k3_inputs(cfg, dev)[0]
        kern = kernels.radial_coulomb_dia
        out.append({"shape": shape, "ms": cs.cuda_ms(lambda: kern(*args)),
                    "device_ms": device_ms(lambda: kern(*args), 50),
                    "host_enqueue_us": host_enqueue_us(lambda: kern(*args))})
        del args
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--library", help="time this one library (a child process does)")
    p.add_argument("--variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--rows", type=int, help="force the host plan's row band")
    args = p.parse_args(argv)
    if args.library:
        print(json.dumps(time_library(args.library, args.rows)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for name in args.variants:
        lib = build_variant(name)
        res = subprocess.run([sys.executable, "-m", "helfem_tpu_torch.tools.coulomb_dia_split",
                              "--library", lib, *(["--rows", str(args.rows)] if args.rows
                                                  else [])],
                             capture_output=True, text=True, timeout=900, check=True).stdout
        for r in json.loads(res.strip().splitlines()[-1]):
            print(json.dumps({"variant": name, "rows": args.rows, **r}), flush=True)


if __name__ == "__main__":
    main()
