"""`python -m helfem_tpu_torch.tools.exchange_split`: where K6's in-element
kernel spends its time on the card, split between its producer and DMMA
warps.

Builds two variants of csrc/radial_exchange_dia.cu into helfem_tpu_torch/
_build/ beside the full kernel: "no_dmma", whose DMMA warps skip their
products (the producers alone: bulk copies, R formation, barriers), and
"no_copy", whose producers issue no copy and form no R (the DMMA warps
alone). Times radial_exchange_dia_occ with each at the N2 lmax=12 shapes of
chip_smoke.py, one process per library. The variants' results are wrong by
design; only their times mean something.
"""

import argparse
import ctypes
import json
import subprocess
import sys

_FULL = []
_NO_DMMA = [
    ("    for (int kk = 0; kk < q.kpad / 8; ++kk) {", "    for (int kk = 0; kk < 0; ++kk) {"),
]
_NO_COPY = [
    ("          bulk_load(As + st * q.astage, src - o,",
     "          asm volatile(\"mbarrier.arrive.shared::cta.b64 _, [%0];\\n\" ::"
     "\"r\"(smem_addr(mbar + st)) : \"memory\");\n          if (false) bulk_load(As + st * "
     "q.astage, src - o,"),
    ("      exdia_form_r(Rs + st * rsz,", "      if (false) exdia_form_r(Rs + st * rsz,"),
]
VARIANTS = {"full": _FULL, "no_dmma": _NO_DMMA, "no_copy": _NO_COPY}


def build_variant(name: str) -> str:
    from helfem_tpu_torch.kernels import _build

    src = (_build.CSRC / "radial_exchange_dia.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"exchange_split: {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    cu = _build.BUILD_DIR / f"exdia_{name}.cu"
    cu.write_text(src)
    lib = _build.BUILD_DIR / f"libexdia_{name}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                    "-o", str(lib), str(cu)], check=True, capture_output=True, timeout=600)
    return str(lib)


def time_library(lib: str, reps: int) -> dict:
    import torch

    import chip_smoke as cs
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels import _build

    handle = ctypes.CDLL(lib)
    for fn in ("radial_exchange_dia_occ_launch", "radial_exchange_dia_launch"):
        getattr(handle, fn).argtypes = _build._SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    _build._lib = handle
    dev = torch.device("cuda", 0)
    args, _, flops = cs.lmax12_exchange_inputs(dev)["radial_exchange_dia_occ"]
    ms = cs.cuda_ms(lambda: kernels.radial_exchange_dia_occ(*args), 1, reps)
    return {"library": lib, "ms": ms, "tflop_s": flops / ms / 1e9}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--library", help="time this one library (a child process does)")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if args.library:
        print(json.dumps(time_library(args.library, args.reps)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for name in VARIANTS:
        lib = build_variant(name)
        out = subprocess.run([sys.executable, "-m", "helfem_tpu_torch.tools.exchange_split",
                              "--library", lib, "--reps", str(args.reps)],
                             capture_output=True, text=True, timeout=900, check=True).stdout
        print(json.dumps({"variant": name, **json.loads(out.strip().splitlines()[-1])}),
              flush=True)


if __name__ == "__main__":
    main()
