"""`python3 helfem_tpu_torch/tools/erfc_timing.py [--root DIR] [--reps N]`:
the erfc exchange kernel K10 (radial_erfc_exchange) of a checkout, timed on
the card.

Imports chip_smoke.py and helfem_tpu_torch from the checkout at DIR (by
default the one holding this file), so that two commits can be timed in one
run on the card: one process per checkout, since a process keeps the first
kernel library it loads. Shapes: the erfc tables (omega 0.5) of the Ar and
Xe bench bases with one and two spins' random symmetric channels, and the
Ne lmax=2, mmax=1 basis's channel-pair windows at symmetry 1 (17) and 0
(49). At each shape the kernel is held to the plain version (1e-12 x
max-abs) and timed: the call time (CUDA events
over back-to-back calls, host dispatch included; the table stays in L2 when
it fits), the device time per call from torch.profiler, the queued time
behind a sleeping kernel, and the time of a call that finds L2 cold (a
128 MB buffer written before each call). Beside them: the bounds on the
table's unique entries and on the dense table (both with Pd read and KK
written once; chip_smoke.py:erfc_exchange_work of this file's checkout, for
every checkout timed), and where the checkout packs the table, the bytes
the kernel's bulk copies requested and the table's pack wall and bytes;
and torch.matmul of the contraction alone on pre-gathered windows
([NL nelem^2, np^2, np^2] @ [., np^2, nang]: no gather, no assembly) as a
yardstick of what cuBLAS streams from the dense table. All times and
bounds use this file's own checkout's code. Prints the card and one JSON
line per shape.
"""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

def _own(path: Path):
    """A module of this file's checkout (by its path), whatever checkout is
    timed."""
    spec = importlib.util.spec_from_file_location(f"_erfc_timing_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cold_ms(fn, reps: int) -> float:
    """CUDA-event ms per call of fn() when each call follows a 128 MB write
    that evicts the 50 MB L2."""
    import torch

    flush = torch.empty(16 * 2**20, dtype=torch.float64, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1.0)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def shapes(cs, dev):
    """(label, tei, gidx, Pd) of every shape timed."""
    from helfem_tpu_torch.models.atomic import AtomicBasis

    for shape in ("ar", "xe"):
        rs = None
        for ns in (1, 2):
            work, rs = cs.erfc_inputs(shape, dev, ns, rs=rs)
            yield f"{shape} ns={ns}", *work["radial_erfc_exchange"][0]
        del rs, work
    ne = AtomicBasis(**cs.FIELD_SHAPES["ne_l2"])
    ops = ne.build_operators(dev)
    rs = ne.build_erfc(cs.RS_OMEGA, dev)
    for symm in (1, 0):
        Pw = cs.pair_window_inputs(ne, ops, symm, 223 + symm)
        yield f"ne_l2 symmetry {symm} ({Pw.shape[0]} windows)", rs.tei, ops.gidx, Pw


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], allow_abbrev=False)
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                   help="checkout whose kernel is timed")
    p.add_argument("--reps", type=int, default=20, help="calls per timing")
    args = p.parse_args(argv)
    root = str(Path(args.root).resolve())
    here = Path(__file__).resolve().parents[2]
    prof = _own(here / "helfem_tpu_torch" / "utils" / "profiling.py")
    work = _own(here / "chip_smoke.py")  # erfc_exchange_work and the card's rates
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("erfc_timing: needs an NVIDIA GPU")
    kernels = importlib.import_module("helfem_tpu_torch.kernels")
    mod = importlib.import_module("helfem_tpu_torch.kernels.radial_erfc_exchange")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; checkout {root}", flush=True)
    dev = torch.device("cuda", 0)
    reps = args.reps
    for label, tei, gidx, Pd in shapes(cs, dev):
        NL, nelem, npr = tei.shape[0], tei.shape[1], tei.shape[3]
        nch = Pd.shape[0]
        _, unique, flops = work.erfc_exchange_work(tei, gidx, Pd)["radial_erfc_exchange"]
        dense = work.erfc_exchange_work(tei, gidx, Pd, dense=True)["radial_erfc_exchange"][1]
        t_ops = flops / work.FP64_FLOP_S * 1e3
        ref = kernels.radial_erfc_exchange_plain(tei, gidx, Pd)
        scale = float(ref.abs().max())
        A = tei.reshape(NL * nelem * nelem, npr * npr, npr * npr)
        B = torch.randn((A.shape[0], npr * npr, nch), dtype=torch.float64, device=dev)
        matmul_ms = cs.cuda_ms(lambda: torch.matmul(A, B), 3, reps)
        del B

        def kern():
            return kernels.radial_erfc_exchange(tei, gidx, Pd)

        pack_s = packed = issued = None
        if hasattr(mod, "pack_erfc_table"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            packed = 8 * mod.pack_erfc_table(tei).numel()
            mod.check_symmetric("radial_erfc_exchange", tei)
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t0
            issued = mod.issued_bytes(tei, gidx, Pd)
        first = kern().clone()
        err = float((kern() - ref).abs().max())
        same = bool(torch.equal(kern(), first))
        ms = 0.5 * (cs.cuda_ms(kern, 3, reps) + cs.cuda_ms(kern, 3, reps))
        rec = {
            "root": root, "shape": label, "max_abs_err": err, "rel_err": err / scale,
            "same_bits": same, "ms": ms, "device_ms": prof.device_ms(kern, reps),
            "queued_ms": prof.queued_ms(kern, reps), "cold_ms": cold_ms(kern, reps),
            "bound_ms": max(unique / work.HBM_BYTES_S * 1e3, t_ops),
            "dense_bound_ms": max(dense / work.HBM_BYTES_S * 1e3, t_ops),
            "packed_bytes": packed, "issued_bytes": issued, "pack_s": pack_s,
            "matmul_ms": matmul_ms, "flops": flops,
        }
        print(json.dumps(rec), flush=True)
        del A, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
