"""`python -m helfem_tpu_torch.tools.probe_split [--kblk 1 2 4 8 16]`: where the
TF32 ("reduced") matmul probes K8/K9 spend their time on the card, and how
deep a k-block their wgmma accumulator can carry.

Builds variants of csrc/matmul_probe.cu into helfem_tpu_torch/_build/:
"full" (the kernel as it is), "no_wgmma", whose consumer warpgroups issue
no wgmma (the TMA loads, the producer's B transform, the consumers' A
fragments and the barriers alone), "no_transform", whose producer warpgroup
skips the B transform (TMA and the consumers alone), "tma_only" (the TMA
ring and its barriers, with no transform, fragment or wgmma), and one build
per TF32_KBLK value (k-tiles of 32 per accumulator before it is added into the
running f32 sum). Times matmul_f32 and matmul_dd at precision "reduced" at
n = 2048 and 4096 with each, one process per library, and reports each
one's max-abs error against the plain version over the max-abs of the
result (the gate is 1e-5). The split variants' results are wrong by design;
only their times mean something.
"""

import argparse
import ctypes
import json
import subprocess
import sys

SOURCE = "matmul_probe.cu"
_CONSUMER_LOOP = "      for (int j = 0; j < 4; ++j) {\n        const uint64_t bh"
_TRANSFORM = "      tf32_transform_b(reinterpret_cast<float*>(st + BOFF), t);\n"
_TRANSFORM_DD = ("      if (DD) tf32_transform_b(reinterpret_cast<float*>(st + BOFF + TILE_BYTES), "
                 "t);\n")
_A_FRAGS = ("        a_frag(st, 64 * wg + 16 * warp, lane, j, ah[j]);\n"
            "        if (DD) a_frag(st + TILE_BYTES, 64 * wg + 16 * warp, lane, j, al[j]);\n")
_NO_WGMMA = [(_CONSUMER_LOOP, _CONSUMER_LOOP.replace("j < 4", "j < 0"))]
_NO_TRANSFORM = [(_TRANSFORM, ""), (_TRANSFORM_DD, "")]
VARIANTS = {
    "full": [],
    "no_wgmma": _NO_WGMMA,
    "no_transform": _NO_TRANSFORM,
    "tma_only": _NO_WGMMA + _NO_TRANSFORM + [(_A_FRAGS, "")],
}


def build_variant(name: str, kblk: int | None = None) -> str:
    from helfem_tpu_torch.kernels import _build

    src = (_build.CSRC / SOURCE).read_text()
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            raise RuntimeError(f"probe_split: {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    cu = _build.BUILD_DIR / f"probe_{name}.cu"
    cu.write_text(src)
    lib = _build.BUILD_DIR / f"libprobe_{name}.so"
    flags = [f"-DTF32_KBLK={kblk}"] if kblk else []
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-shared", "-o", str(lib),
                    str(cu)], check=True, capture_output=True, timeout=600)
    return str(lib)


def time_library(lib: str, reps: int) -> list[dict]:
    import numpy as np
    import torch

    import chip_smoke as cs
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels import _build
    from helfem_tpu_torch.kernels.matmul_probe import split_dd

    handle = ctypes.CDLL(lib)
    handle.matmul_probe_launch.argtypes = _build._SIGNATURES["matmul_probe_launch"]
    handle.matmul_probe_launch.restype = ctypes.c_int
    _build._lib = handle
    dev = torch.device("cuda", 0)
    out = []
    for n in (2048, 4096):
        rng = np.random.default_rng(0)
        a64 = torch.tensor(rng.standard_normal((n, n)), device=dev)
        b64 = torch.tensor(rng.standard_normal((n, n)), device=dev)
        for name, args in (("matmul_f32", (a64.float(), b64.float())),
                           ("matmul_dd", (*split_dd(a64), *split_dd(b64)))):
            kern, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
            got = kern(*args, "reduced")
            ref = plain(*args, "reduced")
            rel = float((got - ref).abs().max()) / float(ref.abs().max())
            ms = cs.cuda_ms(lambda: kern(*args, "reduced"), 3, reps)
            flops = (3 if name == "matmul_dd" else 1) * 2 * n**3
            out.append({"name": name, "n": n, "ms": ms, "tflop_s": flops / ms / 1e9,
                        "rel_err": rel})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--library", help="time this one library (a child process does)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--kblk", type=int, nargs="*", default=[1, 2, 4, 8, 16],
                   help="TF32_KBLK values to build and time")
    args = p.parse_args(argv)
    if args.library:
        print(json.dumps(time_library(args.library, args.reps)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    builds = [(name, None) for name in VARIANTS] + [(f"kblk{k}", k) for k in args.kblk]
    for name, kblk in builds:
        lib = build_variant(name, kblk)
        res = subprocess.run([sys.executable, "-m", "helfem_tpu_torch.tools.probe_split",
                              "--library", lib, "--reps", str(args.reps)],
                             capture_output=True, text=True, timeout=900, check=True).stdout
        for r in json.loads(res.strip().splitlines()[-1]):
            print(json.dumps({"variant": name, **r}), flush=True)


if __name__ == "__main__":
    main()
