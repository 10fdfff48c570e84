"""`python -m helfem_tpu_torch.tools.profile_dia_scf --Z1 N --Z2 N --Rbond
2.068 --lmax 12,12,12 --Rmax 40 --nelem 5 --nnodes 15 --method HF`: where a
diatomic SCF spends its time on the card.

Builds the basis and the operators (host walls printed), runs the SCF once
cold (first-call costs of the libraries and the kernel build inside), then
three warm SCFs and one more under torch.profiler, whose device time is
printed by kernel; with --host one more under cProfile, whose host time is
printed by function (the profiler table shows device kernels only). Closed shells from the core guess, the basis flags of
cli/diatomic.py. Needs a card: there is no CPU mode, a profile of the plain
versions says nothing about the kernels.
"""

import argparse
import subprocess
import time

import torch

from helfem_tpu_torch.cli._common import open_device, parse_nela_nelb
from helfem_tpu_torch.models.diatomic import DiatomicBasis
from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
from helfem_tpu_torch.utils.elements import get_Z
from helfem_tpu_torch.utils.profiling import profile_scf


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.tools.profile_dia_scf",
                                description=__doc__.split("\n\n")[1], allow_abbrev=False)
    p.add_argument("--Z1", required=True)
    p.add_argument("--Z2", required=True)
    p.add_argument("--Rbond", type=float, required=True)
    p.add_argument("--lmax", required=True, help="comma list per |m|")
    p.add_argument("--Rmax", type=float, default=40.0)
    p.add_argument("--nelem", type=int, required=True)
    p.add_argument("--nnodes", type=int, default=15)
    p.add_argument("--method", default="HF")
    p.add_argument("--convthr", type=float, default=1e-7)
    p.add_argument("--maxit", type=int, default=50)
    p.add_argument("--rows", type=int, default=25, help="rows of the profiler table")
    p.add_argument("--host", action="store_true",
                   help="also print a cProfile of one warm SCF, by cumulative time")
    args = p.parse_args(argv)
    device = open_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    Z1, Z2 = get_Z(args.Z1), get_Z(args.Z2)
    nela, nelb = parse_nela_nelb(Z1 + Z2, 0, 0, 0, 0)
    t0 = time.perf_counter()
    basis = DiatomicBasis(Z1=Z1, Z2=Z2, Rbond=args.Rbond,
                          lmax=tuple(int(x) for x in args.lmax.split(",")), rmax=args.Rmax,
                          nelem=args.nelem, nnodes=args.nnodes)
    t1 = time.perf_counter()
    ops = basis.build_operators(device)
    torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    print(f"basis {t1 - t0:.3f} s, operators {t2 - t1:.3f} s; {basis.nang} angular x "
          f"{basis.nrad} radial = {basis.nbf} functions, {len(basis.lm_map)} (L,|M|) "
          f"channels, symmetry blocks {tuple(ops.blk_idx.shape)}")

    def run():
        return scf_diatomic(basis, nela, nelb, method=args.method, convthr=args.convthr,
                            maxit=args.maxit, ops=ops)

    res = run()
    torch.cuda.synchronize(device)
    print(f"cold SCF {time.perf_counter() - t2:.3f} s: E = {res.E:.12f}, Exx = {res.Exx:.10f}, "
          f"{res.niter} iterations, converged {res.converged}; peak device memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    label = f"{args.Z1}{args.Z2} {args.method} lmax={args.lmax}"
    profile_scf(label, run, rows=args.rows)
    if args.host:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(run)
        torch.cuda.synchronize(device)
        print(f"host profile of one warm SCF (wall {time.perf_counter() - t0:.3f} s with "
              "cProfile on):")
        pstats.Stats(prof).sort_stats("cumulative").print_stats(args.rows + 10)
    return res


if __name__ == "__main__":
    main()
