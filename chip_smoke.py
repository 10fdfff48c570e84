#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (helfem_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, any failure raises and exits non-zero:
  1. device facts (name, power limit, torch/CUDA/nvcc versions); no card
     -> exit non-zero with no result;
  2. build the CUDA kernels from helfem_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, in parallel), timed against one nvcc call for all
     sources;
  3. each kernel against its plain PyTorch version on the card, on random
     symmetric block-diagonal densities (numpy seed): the atomic kernels at
     the Ar and Xe bench shapes, the diatomic ones at the N2 bench shapes
     and a heteronuclear CO shape (random grid potentials for the XC Fock):
     max-abs error <= 1e-12 x max-abs of the result; CUDA-event times of
     both, in turns;
  4. Ar HF (the bench config) through the port's atomic CLI on the card:
     within 1e-6 Eh of the numerical HF limit, and both atomic kernels'
     launch counters must rise during the SCF;
  5. three warm Ar HF SCF walls and a torch.profiler breakdown of the device
     time of one more SCF, by kernel;
  6. N2 PBE (the bench config) through the port's diatomic CLI on the card:
     within 1e-6 Eh of the JAX package's f64 value, and the three diatomic
     kernels' launch counters must rise during the SCF;
  7. three warm N2 PBE SCF walls and the profiler breakdown of one more.
The last two lines are the kernels' JSON record and {"ok": true, ...}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

AR_HF_LIMIT = -526.8175128  # numerical HF limit (Saito 2009), bench.py gate
AR_CLI = ["--Z", "Ar", "--lmax", "1", "--mmax", "1", "--nelem", "10",
          "--nnodes", "15", "--Rmax", "40", "--iguess", "3", "--convthr", "1e-9"]
N2_PBE_REF = -108.978708437276  # helfem_tpu on the CPU in f64, bench.py gate
N2_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "6,6", "--nelem", "5",
          "--nnodes", "8", "--Rmax", "25", "--method", "PBE", "--convthr", "1e-7"]
SHAPES = {  # AtomicBasis arguments of the Ar and Xe bench configs
    "ar": dict(Z=18, lmax=1, mmax=1, rmax=40.0, nelem=10, nnodes=15),
    "xe": dict(Z=54, lmax=3, mmax=3, rmax=40.0, nelem=8, nnodes=12, zexp=2.5),
}
DIA_SHAPES = {  # DiatomicBasis arguments: the N2 bench config, and CO
    "n2": dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8),
    "co": dict(Z1=6, Z2=8, Rbond=2.132, lmax=(4, 4), rmax=25.0, nelem=4, nnodes=8),
}
REL_TOL = 1e-12
# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; FP64 on the tensor
# cores 67 TFLOP/s, the most any f64 kernel could reach
HBM_BYTES_S = 3.35e12
FP64_FLOP_S = 67e12
KERNELS = {  # name -> (source, replaces, shape of its record)
    "radial_exchange": ("helfem_tpu_torch/csrc/radial_exchange.cu",
                        "helfem_tpu/models/atomic.py:499", "ar"),
    "radial_coulomb": ("helfem_tpu_torch/csrc/radial_coulomb.cu",
                       "helfem_tpu/models/atomic.py:436", "ar"),
    "radial_coulomb_dia": ("helfem_tpu_torch/csrc/radial_coulomb_dia.cu",
                           "helfem_tpu/models/diatomic.py:709", "n2"),
    "dia_xc_fields": ("helfem_tpu_torch/csrc/dia_xc_fields.cu",
                      "helfem_tpu/models/diatomic_dft.py:95", "n2"),
    "dia_xc_fock": ("helfem_tpu_torch/csrc/dia_xc_fock.cu",
                    "helfem_tpu/models/diatomic_dft.py:155", "n2"),
}


def phase(title: str) -> None:
    print(f"\n== {title}", flush=True)


def device_facts() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from helfem_tpu_torch.kernels._build import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    return smi


def cuda_ms(fn, warmup: int = 5, reps: int = 50) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def window_entries(gidx: torch.Tensor, nrad: int) -> int:
    """Entries of an [nrad, nrad] matrix that some element window covers:
    all that a kernel reading the matrix through gidx needs of it."""
    cover = torch.zeros((nrad + 1, nrad + 1), dtype=torch.bool)
    for g in gidx.long().cpu():
        cover[g[:, None], g[None, :]] = True
    return int(cover[:nrad, :nrad].sum())


def kernel_inputs(cfg: dict, dev, seed: int = 7):
    """Operators of an atomic bench basis, and per kernel (its inputs, the
    bytes it must move, the operations it does) for a random symmetric
    channel-block-diagonal density. The bytes count each input entry the
    function needs once (of a matrix read through gidx, the entries its
    element windows cover) and each output once."""
    from helfem_tpu_torch.models.atomic import AtomicBasis

    basis = AtomicBasis(**cfg)
    ops = basis.build_operators(dev)
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((basis.nang, basis.nrad, basis.nrad))
    Pd = torch.tensor(X + X.transpose(0, 2, 1), device=dev)
    P4 = torch.zeros((basis.nang,) * 2 + (basis.nrad,) * 2, dtype=torch.float64, device=dev)
    a = torch.arange(basis.nang, device=dev)
    P4[a, a] = Pd
    Paux = torch.einsum("LMab,abIJ->LMIJ", ops.G, P4).contiguous()
    NL, NM = Paux.shape[:2]
    nelem, npr = ops.gidx.shape
    nang, nrad = basis.nang, basis.nrad
    # exchange: in-element np^4 contraction per element, two np^3 products per
    # element pair, per (L, channel); Coulomb: np^4 per element plus traces
    xflops = NL * nang * (2 * nelem * npr**4 + 4 * npr**3 * nelem * (nelem - 1))
    cflops = NL * NM * nelem * (2 * npr**4 + 8 * npr**2)
    return {
        "radial_exchange": ((ops.tei, ops.disjL, ops.disjm1L, ops.gidx, Pd),
                            nbytes(ops.tei, ops.disjL, ops.disjm1L, ops.gidx, Pd)
                            + 8 * NL * nang * nrad * nrad, xflops),
        "radial_coulomb": ((Paux, ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, ops.gidx),
                           8 * NL * NM * window_entries(ops.gidx, nrad)
                           + nbytes(ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, ops.gidx)
                           + nbytes(Paux), cflops),
    }


def dia_kernel_inputs(cfg: dict, dev, seed: int = 11):
    """Operators and grid of a diatomic basis, and per kernel (its inputs,
    bytes, operations) for a random symmetric symmetry-block-diagonal
    density and random grid potentials; bytes counted as kernel_inputs
    counts them."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis, _to4
    from helfem_tpu_torch.models.diatomic_dft import build_dia_grid

    basis = DiatomicBasis(**cfg)
    ops = basis.build_operators(dev)
    g = build_dia_grid(basis, dev)
    rng = np.random.default_rng(seed)
    P = np.zeros((basis.nbf, basis.nbf))
    for idx in basis.sym_blocks():
        X = rng.standard_normal((len(idx), len(idx)))
        P[np.ix_(idx, idx)] = X + X.T
    P = torch.tensor(P, device=dev)
    nang, nrad, njbd = basis.nang, basis.nrad, basis.njbd
    P4 = _to4(P, nang, nrad)
    Paux0 = torch.einsum("sab,abIJ->sIJ", ops.GmLM[:njbd], P4).contiguous()
    Paux2 = torch.einsum("sab,abIJ->sIJ", ops.GpLM[:njbd], P4).contiguous()
    ilm = ops.LM_ilm[:njbd]
    nelem, npr = ops.gidx.shape
    nq, nt = g.w.shape[1:]
    shape = g.w.shape
    wvr, wgu, wgv = (torch.tensor(rng.standard_normal(shape), device=dev) for _ in range(3))
    # the rows of the channel tables this call reads, the shell pairs whose
    # angular tables do not vanish (the only ones K4 and K5 need), and the
    # entries of an [nrad, nrad] block that the element windows cover
    rows = len(set(ilm.tolist()))
    live = int(((g.TT != 0) | (g.dTT != 0)).any(dim=-1).sum())
    win = window_entries(ops.gidx, nrad)
    np2 = npr * npr
    # inputs: the windows of Paux0 and Paux2, ilm, gidx, the table rows;
    # outputs Jr0, Jr2
    k3_bytes = (8 * 2 * njbd * win + nbytes(Paux0, Paux2) + nbytes(ilm, ops.gidx)
                + 8 * rows * (3 * nelem * np2 * np2 + 4 * nelem * np2 + 1))
    # inputs: the live pairs' windows of P and rows of TT and dTT, the rest
    # whole; outputs rho, drho_u, drho_v
    k4_bytes = (8 * live * (win + 2 * nt) + nbytes(g.gidx, g.Bg, g.dBg, g.invh, g.sqeta)
                + 3 * nbytes(g.w))
    # inputs: the three potentials, the live rows of TT and dTT, the rest
    # whole; output F [nbf, nbf]
    k5_bytes = (nbytes(wvr, wgu, wgv, g.gidx, g.Bg, g.dBg) + 8 * live * 2 * nt
                + 8 * (nang * nrad) ** 2)
    k3 = (Paux0, Paux2, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.LMfac, ilm,
          ops.gidx)
    k4 = (P, g.gidx, g.Bg, g.dBg, g.TT, g.dTT, g.invh, g.sqeta)
    k5 = (wvr, wgu, wgv, g.gidx, g.Bg, g.dBg, g.TT, g.dTT, nrad)
    return {
        "radial_coulomb_dia": (k3, k3_bytes, njbd * nelem * (8 * np2 * np2 + 16 * np2)),
        "dia_xc_fields": (k4, k4_bytes, live * nelem * nq * (2 * np2 + 4 * npr + 6 * nt)),
        "dia_xc_fock": (k5, k5_bytes, live * nelem * (8 * nq * nt + 10 * np2 * nq)),
    }


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def compare(name: str, args, bytes_moved: int, flops: int) -> dict:
    """The kernel against its plain version on the same card inputs: gate
    each output at 1e-12 x its max-abs; CUDA-event times in turns (plain,
    kernel, kernel, plain), and the least time the card could take."""
    from helfem_tpu_torch import kernels

    kern, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    out = _outputs(kern(*args))
    torch.cuda.synchronize()
    ref = _outputs(plain(*args))
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    scales = [float(r.abs().max()) for r in ref]
    for err, scale in zip(errs, scales):
        if not np.isfinite(err) or err > REL_TOL * scale:
            raise RuntimeError(f"{name}: kernel disagrees with plain: max-abs err "
                               f"{err:.3e} > {REL_TOL:g} x {scale:.3e}")
    p1 = cuda_ms(lambda: plain(*args))
    k1 = cuda_ms(lambda: kern(*args))
    k2 = cuda_ms(lambda: kern(*args))
    p2 = cuda_ms(lambda: plain(*args))
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / FP64_FLOP_S
    return {"max_abs_err": max(errs), "scale": min(scales), "ms": 0.5 * (k1 + k2),
            "plain_ms": 0.5 * (p1 + p2), "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def profile_scf(label: str, run, rows: int = 20) -> None:
    """Warm SCF walls (min of three) of run() -> result, and the device time
    of one more SCF by kernel, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if not res.converged:
        raise RuntimeError(f"warm {label} SCF did not converge")
    print(f"warm {label} SCF walls: {[round(w, 4) for w in walls]} s, {res.niter} "
          f"iterations, min {min(walls) / res.niter * 1e3:.2f} ms per iteration")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    key = "self_device_time_total"
    # device kernels only: operator rows repeat the time of their kernels
    busy = sum(getattr(e, key) for e in events if e.device_type == DeviceType.CUDA) * 1e-6
    print(f"profiled {label} SCF: wall {wall:.4f} s (profiler on), device busy "
          f"{busy:.4f} s = {100 * busy / wall:.1f} % of the wall")
    print(events.table(sort_by=key, row_limit=rows))


def run_cli(main, argv, label: str, names: list[str], check) -> dict:
    """Drive one CLI on the card with every launch counter at 0 before it;
    returns the counts read right after. check(res) -> error text or ''."""
    from helfem_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    print(f"{label}: E = {res.E:.12f}, {res.niter} iterations, converged {res.converged}; "
          f"walls: basis {res.walls['basis']:.3f} s, operators {res.walls['operators']:.3f} s, "
          f"SCF {res.walls['scf']:.3f} s, whole CLI {wall:.3f} s; kernel launches {counts}")
    problem = check(res)
    if problem:
        raise RuntimeError(f"{label}: {problem}")
    missing = [name for name in names if counts[name] == 0]
    if missing:
        raise RuntimeError(f"{label}: the SCF never launched {missing}")
    return {name: counts[name] for name in names}


def main() -> None:
    phase("1. device")
    smi = device_facts()
    dev = torch.device("cuda", 0)

    phase("2. build")
    from helfem_tpu_torch.kernels import _build

    seconds, log = _build.build(ptxas_verbose=True)
    # the same sources through one nvcc call, after the parallel build (so
    # with warm file caches), into a scratch library that is then removed
    srcs = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    single = _build.BUILD_DIR / "single_nvcc_check.so"
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(single),
                    *srcs], check=True, capture_output=True, timeout=600)
    serial = time.perf_counter() - t0
    single.unlink()
    print(f"built {_build.LIBRARY.name} from {[p.rsplit('/', 1)[-1] for p in srcs]} in "
          f"{seconds:.2f} s, one nvcc per source in parallel (one nvcc for all sources, "
          f"for comparison: {serial:.2f} s)")
    print("\n".join(line for line in log.splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line))
    _build.lib()

    phase("3. kernels vs plain PyTorch on the card")
    results = {}
    shapes = [(s, kernel_inputs, cfg) for s, cfg in SHAPES.items()]
    shapes += [(s, dia_kernel_inputs, cfg) for s, cfg in DIA_SHAPES.items()]
    for shape, make, cfg in shapes:
        t0 = time.perf_counter()
        inputs = make(cfg, dev)
        print(f"{shape}: operators built in {time.perf_counter() - t0:.2f} s")
        for name, (args, moved, flops) in inputs.items():
            r = compare(name, args, moved, flops)
            results[(name, shape)] = r
            print(f"{shape} {name}: max-abs err {r['max_abs_err']:.3e} (scale "
                  f"{r['scale']:.3e}), kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} B, "
                  f"{r['flops']} flop)")

    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main

    phase("4. Ar HF through the port's atomic CLI on the card")

    def ar_check(res):
        dE = res.E - AR_HF_LIMIT
        print(f"Ar HF: E - HF limit = {dE:+.3e}")
        ok = res.converged and abs(dE) < 1e-6 and np.isfinite(res.E)
        return "" if ok else "did not converge to the HF limit within 1e-6 Eh"

    counts = run_cli(atomic_main, AR_CLI, "Ar HF", ["radial_exchange", "radial_coulomb"],
                     ar_check)

    phase("5. warm Ar HF SCF walls and profile")
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.scf.atomic_scf import scf_atom

    ar_basis = AtomicBasis(**SHAPES["ar"])
    ar_ops = ar_basis.build_operators(dev)
    profile_scf("Ar HF", lambda: scf_atom(ar_basis, 9, 9, convthr=1e-9, guess="TF",
                                          ops=ar_ops))

    phase("6. N2 PBE through the port's diatomic CLI on the card")

    def n2_check(res):
        dE = res.E - N2_PBE_REF
        print(f"N2 PBE: E - reference = {dE:+.3e}, Nel on the grid {res.Nelgrid:.12f}")
        ok = res.converged and abs(dE) < 1e-6 and np.isfinite(res.E)
        return "" if ok else "did not converge to the reference within 1e-6 Eh"

    counts.update(run_cli(diatomic_main, N2_CLI, "N2 PBE",
                          ["radial_coulomb_dia", "dia_xc_fields", "dia_xc_fock"], n2_check))

    phase("7. warm N2 PBE SCF walls and profile")
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

    n2_basis = DiatomicBasis(**DIA_SHAPES["n2"])
    n2_ops = n2_basis.build_operators(dev)
    profile_scf("N2 PBE", lambda: scf_diatomic(n2_basis, 7, 7, method="PBE", convthr=1e-7,
                                               maxit=50, ops=n2_ops))

    record = []
    for name, (source, replaces, shape) in KERNELS.items():
        r = results[(name, shape)]
        other = results[(name, {"ar": "xe", "n2": "co"}[shape])]
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": shape, "other_shape_max_abs_err": other["max_abs_err"],
            "other_shape_ms": other["ms"], "other_shape_plain_ms": other["plain_ms"],
            "other_shape_bound_ms": other["bound_ms"],
        })
    print()
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
