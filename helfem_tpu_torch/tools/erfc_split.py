"""`python -m helfem_tpu_torch.tools.erfc_split [--variants ...]`: where the
erfc exchange kernel K10 (radial_erfc_exchange) spends its time on the
card.

Builds variants of csrc/radial_erfc_exchange.cu into helfem_tpu_torch/_build/
by dropping work: "full" (the kernel as it is), "no_products" (no DMMA
items: the ring and the windows still move, the outputs are written from
stale shared memory), "no_windows" (the window gathers skipped), "no_output"
(no stores of the slab's results), "no_table" (the ring's stages handed to
the consumers without their bulk copies), "phase1_only" (no boundary
assembly), "fma_for_mma" (each tensor-core product replaced by one FMA),
"no_operand_loads" (the products on register values, no shared-memory
operand loads) and "empty" (no tasks, no assembly: the cooperative launch, the
setup of the shared tables and the grid barrier). Times each at the Ar and
Xe bench bases (one spin) and on the 17 and 49 channel-pair windows of Ne
lmax=2, mmax=1, one process per library: the call time (CUDA events over
back-to-back calls) and the device time per call (torch.profiler). The
variants' results are wrong by design; only their times mean something.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SOURCE = "radial_erfc_exchange.cu"
ENTRIES = ("radial_erfc_exchange_launch", "radial_erfc_exchange_smem")
NO_ITEMS = ("nitem = t.ncg * per;", "nitem = 0;")
NO_WINDOWS = ("x < nil * G;", "x < 0;")
NO_OUTPUT = ("x < nch * npart;", "x < 0;")
NO_TABLE = ("re_bulk_load(ring + (size_t)s * a.STG, ch.src, ch.bytes, full + s);",
            "re_bar_arrive(full + s);")
NO_ASSEMBLY = ("  assemble_boundaries(a, tab, a.NL * a.nang);", "")
FMA_MMA = [("          re_mma16(c, av[0][ks], av[MT - 1][ks], bv[ks][nt]);",
            "          c[0] += av[0][ks] * bv[ks][nt];"),
           ("          dmma884(acc.c[0][slot][0], acc.c[0][slot][1], av[0][ks], bv[ks][nt]);",
            "          acc.c[0][slot][0] += av[0][ks] * bv[ks][nt];")]
NO_LOADS = [("          av[mt][ks] = P[s];", "          av[mt][ks] = (double)s;"),
            ("      for (int nt = 0; nt < NT; ++nt) bv[ks][nt] = b[nt * 8 * z.ldw + 4 * ks];",
             "      for (int nt = 0; nt < NT; ++nt) bv[ks][nt] = (double)(nt + ks + i);")]
NO_TASKS = ("  z.ntask = (z.ngrp + a.CPP - 1) / a.CPP * z.nrp * a.NL * z.npairs;",
            "  z.ntask = 0;")
VARIANTS = {
    "full": [],
    "no_products": [NO_ITEMS],
    "no_windows": [NO_WINDOWS],
    "no_output": [NO_OUTPUT],
    "no_table": [NO_TABLE],
    "phase1_only": [NO_ASSEMBLY],
    "fma_for_mma": FMA_MMA,
    "no_operand_loads": NO_LOADS,
    "empty": [NO_TASKS, NO_ASSEMBLY],
}


def build_variant(name: str) -> str:
    from helfem_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(exist_ok=True)
    src = (_build.CSRC / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"erfc_split: {name}: {SOURCE} no longer has {old!r}")
        src = src.replace(old, new)
    cu = _build.BUILD_DIR / f"erfc_{name}_{SOURCE}"
    cu.write_text(src)
    lib = _build.BUILD_DIR / f"liberfc_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o",
                    str(lib), str(cu)], check=True, capture_output=True, timeout=600)
    return str(lib)


def time_library(lib: str) -> list[dict]:
    import torch

    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels import _build
    from helfem_tpu_torch.tools.erfc_timing import shapes
    from helfem_tpu_torch.utils.profiling import device_ms

    import chip_smoke as cs

    handle = ctypes.CDLL(lib)
    for fn in ENTRIES:
        getattr(handle, fn).argtypes = _build._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    _build._lib = handle
    out = []
    for label, tei, gidx, Pd in shapes(cs, torch.device("cuda", 0)):
        if "ns=2" in label:
            continue

        def kern():
            return kernels.radial_erfc_exchange(tei, gidx, Pd)

        out.append({"shape": label, "ms": cs.cuda_ms(kern), "device_ms": device_ms(kern, 50)})
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
    with ThreadPoolExecutor(len(args.variants)) as pool:  # one nvcc per variant, together
        libs = dict(zip(args.variants, pool.map(build_variant, args.variants)))
    for name, lib in libs.items():
        res = subprocess.run([sys.executable, "-m", "helfem_tpu_torch.tools.erfc_split",
                              "--library", lib], capture_output=True, text=True, timeout=900,
                             check=True).stdout
        for r in json.loads(res.strip().splitlines()[-1]):
            print(json.dumps({"variant": name, **r}), flush=True)


if __name__ == "__main__":
    main()
