"""`python -m helfem_tpu_torch.cli.diatomic_cpl`: completeness/importance
scan of a diatomic FEM basis with GTO/STO probes at the nuclei and the bond
midpoint, in the PyTorch/CUDA port (helfem_tpu.cli.diatomic_cpl; flags
mirror src/diatomic/completeness.cpp:31-38). Reads an npz checkpoint of
the diatomic CLI (--save) and writes, per (m, l, center),

    cpl_<probe>_m<m>_l<l>_<center>.dat:  exponent  Y(alpha)  I_alpha  [I_beta]

helfem_tpu's flags, plus --device: the overlap's pseudo-inverse and the
profiles' contractions run there; the probe overlaps are made on the host.
"""

import argparse
from types import SimpleNamespace

import numpy as np

from helfem_tpu_torch.cli._common import open_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="helfem_tpu_torch.cli.diatomic_cpl", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("--load", required=True, help="npz checkpoint from the diatomic CLI")
    p.add_argument("--completeness", type=int, default=2, help="max probe l")
    p.add_argument("--minexp", type=float, default=1e-3)
    p.add_argument("--maxexp", type=float, default=1e6)
    p.add_argument("--nexp", type=int, default=101)
    p.add_argument("--iprobe", type=int, default=0, help="0 = GTO, 1 = STO")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pseudo-inverse and the contractions")
    args = p.parse_args(argv)

    import torch

    from helfem_tpu_torch.models.diatomic_cpl import (
        completeness_dia,
        full_orbitals,
        importance_dia,
    )
    from helfem_tpu_torch.utils.checkpoint import load_diatomic
    from helfem_tpu_torch.utils.linalg import build_blocks

    device = open_device(args.device)
    basis, d = load_diatomic(args.load)
    kind = "GTO" if args.iprobe == 0 else "STO"
    expn = 10.0 ** np.linspace(np.log10(args.minexp), np.log10(args.maxexp), args.nexp)
    # the operators' masked overlap and its blocks (DiatomicBasis.host_operators)
    S = basis.overlap()
    mv = basis.shell_mask().reshape(-1)
    blocks = next(b for b in (basis.sym_blocks(True), basis.sym_blocks(False))
                  if len(b) == d["orbs_a"].shape[0])
    blk_idx = torch.as_tensor(build_blocks(S, blocks)[0])
    S = torch.as_tensor(S * mv[:, None] * mv[None, :], device=device)
    ops = SimpleNamespace(blk_idx=blk_idx, S=S)
    Ca = full_orbitals(ops, d["orbs_a"], d["occ_a"])
    Cb = full_orbitals(ops, d["orbs_b"], d["occ_b"]) if d["orbs_b"].size else None

    for m in sorted(set(int(x) for x in basis.mval)):
        for l in range(abs(m), args.completeness + 1):
            for center in ("left", "mid", "right"):
                Y = completeness_dia(basis, S, l, m, expn, center, kind)
                Ia = importance_dia(basis, Ca, l, m, expn, center, kind, device)
                cols = [expn, Y, Ia]
                if Cb is not None:
                    cols.append(importance_dia(basis, Cb, l, m, expn, center, kind, device))
                path = f"cpl_{kind.lower()}_m{m}_l{l}_{center}.dat"
                np.savetxt(path, np.column_stack(cols))
                print(f"m={m:+d} l={l} {center:>5s}: max Y = {Y.max():.6f}, "
                      f"max I_a = {Ia.max():.6f} -> {path}")
    return 0


if __name__ == "__main__":
    main()
