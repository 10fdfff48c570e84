#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (helfem_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, any failure raises and exits non-zero:
  1. device facts (name, power limit, torch/CUDA/nvcc versions); no card
     -> exit non-zero with no result;
  2. build the CUDA kernels from helfem_tpu_torch/csrc/ (nvcc, sm_90a, one
     process per source, in parallel), timed, with each kernel's registers
     and spills from ptxas (the two
     atomic radial kernels and every instance of the diatomic Coulomb
     kernel K3 must not spill); cuobjdump's SASS must show DMMA
     in both atomic radial kernels, in every diatomic exchange in-element
     instance and in both XC kernels, HGMMA with TF32 operands in every
     "reduced" matmul probe instance, and FFMA with no HMMA or HGMMA in
     every "full" one;
  3. each kernel against its plain PyTorch version on the card, on random
     symmetric block-diagonal densities (numpy seed): the atomic kernels at
     the Ar and Xe bench shapes and on random tables at nprim 33 and 40, at
     NM 29 with nprim 32 (past one block's shared memory for all M at once;
     64 angular channels for the exchange) and in a Hermite element layout,
     each twice with the same bits and one launch per call, the diatomic
     ones at the N2 bench shapes and a heteronuclear CO shape (random grid
     potentials for the XC Fock, random occupied columns for the exchange;
     both spins for the XC kernels), K3 also past the old nprim 32 (LiH at
     nprim 33 and 40) and with every signed channel at the N2 bench (njbd
     None), each K3 call twice with the same bits and one launch per call,
     the two exchange kernels also at a LiH shape, at the N2 lmax=12 shapes
     and at nprim 33 and 40 on random tables, the XC kernels at the N2
     lmax=12 basis for one spin, and the XC kernels on the atomic grids
     of the Ar and Xe bench bases and on the SAD grid of gensap Kr (one
     angular shell and point) for one spin (the restricted path's), each
     twice with the same bits and one launch per call: max-abs
     error <= 1e-12 x max-abs of the result;
     beside each call time the kernel's device time (torch.profiler); the
     matmul probes at n = 2048 and 4096, both precisions, within 1e-5 x
     max-abs of their plain versions (f32 sums in another order);
     CUDA-event times of both, in turns, achieved TFLOP/s, and beside the
     probes their one-call library counterpart, torch.matmul in true f32
     for "full" and in TF32 for "reduced" (three calls for matmul_dd);
  4. Ar HF (the bench config) through the port's atomic CLI on the card:
     within 1e-6 Eh of the numerical HF limit and 1e-10 Eh of the port's
     pinned value, both atomic kernels launched once per iteration; then
     again with the CLI's default guess (SAP, its Ar atom solved on the
     card through K2, K4 and K5, each once per Fock build), within 1e-10
     Eh of the same pinned value;
  5. three warm Ar HF SCF walls and a torch.profiler breakdown of the device
     time of one more SCF, by kernel, each SCF with the atomic kernels once
     per iteration; their device time per SCF;
  6. N2 PBE (the bench config) through the port's diatomic CLI on the card:
     within 1e-6 Eh of the JAX package's f64 value and 1e-10 Eh of the
     port's own value (−108.978708437278 on every run), the three diatomic
     kernels' launch counters must rise during the SCF, K3's and the XC
     kernels' once per iteration;
  7. three warm N2 PBE SCF walls and the profiler breakdown of one more,
     each SCF with K3 and the XC kernels once per iteration; K3's device
     time per SCF beside K4 + K5's;
  8. N2 HF through the diatomic CLI on the card: within 1e-6 Eh of the JAX
     package's pinned value, with K3 once per iteration, the occupied-orbital
     exchange kernel launched and the dense exchange kernel not; then the
     dense exchange_dia on the converged density, which must agree with
     exchange_dia_occ on the converged orbitals;
  9. three warm N2 HF SCF walls and the profiler breakdown of one more (K3
     once per iteration, its device time per SCF), then N2 PBE0 once
     through the CLI: converged, with the XC and the exchange kernels
     launched, K3 and the XC kernels once per iteration;
 10. the f64-ablation tool's JSON line at n = 2048 through its main;
 11. K3 at the N2 lmax=12 basis (tools/profile_dia_scf.py's) on a random
     density (equal bits twice, 1e-12 x max-abs, its record's lmax12
     fields), then N2 HF there from the core guess, cold then warm: within
     2e-5 Eh of the bench reference and 1e-8 Eh of the value the exchange
     kernels' first, CUDA-core version gave, with the occupied-orbital
     exchange kernel launched and K3 once per iteration; the warm wall and
     tr(P S) - 14 beside the whitening's defect of the overlap blocks (a
     closed-shell witness for phase 16's spin counts) and one profiled warm
     SCF; then the same SCF from the SAP guess (the bench's own start), cold and
     warm, within 2e-5 Eh of the bench reference (N's SAD atom, solved in
     the cold run, with K2, K4 and K5 once per Fock build), beside the core-guess
     iterations and walls. Then N2 PBE at the same basis and the PBE bench geometry, cold
     (converged, Nel on the grid within 1e-6 of 14, within 1e-8 Eh of the
     pinned value, K3 and the XC kernels once per iteration), then warm with
     its profile and K3's device time per SCF;
 12. Xe HF (the bench's heavier atomic point, lmax=3) through the port's
     atomic CLI: converged to convthr 1e-9, within 3e-6 Eh of the Xe HF limit,
     the atomic kernels once per iteration;
 13. gensap Kr (bench.py's bench_gensap basis, SVWN, --nosearch) through the
     port's gensap CLI, cold and warm: converged within 1e-5 Eh of the bench
     value and 1e-8 Eh of the port's own, a finite Z_eff table, K2, K4 and
     K5 once per Fock build and K1
     never; K1 and K2 at the Kr SAD shapes against their plain versions;
     the warm solve's device time for K1, K2, K4, K5, eigh and the rest;
 14. SAD-HF Ar at the Ar bench basis: K1 (NL 3 on two channels) and K2 (the
     L=0 tables) at its shapes against their plain versions, sad_exchange
     and sad_coulomb against their CPU versions (1e-12 x max-abs, the same
     bits twice), then the solve: within 1e-6 Eh of the Ar HF limit, K1 and
     K2 once per Fock build (K4 and K5 never), and its warm device time
     like phase 13's;
 15. atomic DFT and open shells through the port's atomic CLI (TF guess):
     Ar SVWN at the Ar bench basis within 1e-6 Eh of the NIST LSD value and
     Nel on the grid within 1e-6 of 18; Ar PBE0, Xe PBE (the Xe bench
     basis), and the quartet N (5 alpha, 2 beta, Ar bench radial basis)
     UHF, UKS-PBE and ROHF within 1e-8 Eh of helfem_tpu's f64 values; K2
     once per iteration, K1 once per iteration for HF and PBE0 (both spins
     in one launch), K4 once per iteration and K5 once per iteration plus
     twice for the grid self-check (overlap, and kinetic through its tau
     contraction) for a functional; then warm walls and a
     profile of Ar PBE0 and Xe PBE (device-busy share, eigh share, K4/K5
     device time per call);
 16. open shells through the port's diatomic and gensap CLIs: triplet O2
     (9 alpha, 7 beta, SAP guess) at the N2 bench basis, UHF, UKS-PBE and
     ROHF, within 1e-8 Eh of helfem_tpu's f64 values and their iteration
     counts +-1, ROHF >= UHF - 1e-8, the triplet's occupations (alpha one
     electron above beta in each of the two blocks of one pi pair, all
     integer), per iteration K3 once, K6 twice (UHF, ROHF), K4 and K5 once
     with two spins (UKS); K6 at O2's alpha and beta widths against its
     plain version and the host's ROHF update timed; O2 UHF at the lmax=12
     basis from SAP, cold and warm (converged at 1e-7 within 1e-8 Eh of the
     port's pinned value, occupations summing to 9 and 7, tr(Pa S) = 9 and
     tr(Pb S) = 7 within 1e-8: the basis whitens its overlap only to 5.5e-7,
     K3 once and K6 twice per iteration) with its warm profile, then K6 on
     each spin's converged occupied columns against its plain version and
     timed; H2+ (nelb = 0) at lmax=10 within 1e-8 Eh of the
     exact -0.6026342144949, its exchange cancelling the Coulomb
     self-interaction, K6 once per iteration (none for beta); gensap Cr
     --unrestricted (lda_x, the bench's gensap basis): 3d5 4s1, M = 7,
     within 1e-8 Eh of helfem_tpu's value, K2, K4 and K5 once per Fock
     build (two spins in the unrestricted search), K1 never, and K4/K5 on
     the SAD Cr grid at two spins against their plain versions (equal bits
     twice); then SAD-UHF
     Cr (M = 7) with K1 once per Fock build for both spins' stacked cubes
     (checked against its plain version at that shape), within 1e-8 Eh of
     helfem_tpu's value, and its warm profile;
 17. meta-GGAs (tau) and the new GGA catalog: K4 and K5 in tau mode
     against their plain versions on the N2 bench and lmax=12 grids, the
     Ar and Xe atomic grids and the SAD Kr grid's two-shell meta-GGA form,
     at one and two spins (1e-12 x max-abs, the same bits twice, one
     launch per call, CUDA-event and profiler times beside the bound);
     sum w tau = tr(P T) within 1e-10 at the N2 bench basis and the grid
     kinetic matrix within 1e-9 of the analytic T at the Ar bench basis,
     both on the card; Ar TPSS, TPSSh, rSCAN and B3LYP5 at the Ar bench
     basis, N2 TPSS and B3LYP5 at the N2 bench basis from SAP, quartet N
     UKS-TPSS and gensap Kr TPSS (--pot SVWN) through the port's CLIs,
     each within 1e-9 Eh of helfem_tpu's f64 value at the same arguments,
     K4 and K5 once per Fock build (the atomic CLI's K5 twice more for its
     grid self-check), K1 or K6 launched for the hybrids; then each cell's
     warm wall (one run beside the profiled one) and device-time shares of
     eigh, K4, K5 and xc_eval's autograd ops;
 18. range-separated exchange: K10 (radial_erfc_exchange) against its plain
     version on the erfc tables (omega 0.5) of the Ar and Xe bench bases at
     one and two spins, and K1 on the Yukawa tables of the Ar bench basis
     at lambda 0.5 and 5 against the pairwise plain version (1e-12 x
     max-abs, the same bits twice, one launch per call, CUDA-event,
     profiler and queued times beside the bound), the tables' setup walls;
     beside each K10 check the bound on the dense table (the count before
     the table was packed), the packed table's bytes against those the
     kernel's bulk copies request (within 10 %: each slab read once), the
     pack's setup wall, the call time with L2 cold and torch.matmul of the
     contraction alone on pre-gathered windows as a yardstick;
     Ar LC-LDA, SR-PBE0 and LCY-LDA, quartet N UKS LC-LDA and Xe LC-LDA
     through the port's atomic CLI (TF guess, convthr 1e-8), each within
     1e-9 Eh of helfem_tpu's f64 value, per Fock build K2 once, K10 once
     for the erfc methods (both spins in one launch), K1 once for kfull !=
     0 and once more for the Yukawa kernel, never for SR-PBE0, K4 once and
     K5 once (twice more for the grid self-check); then the warm wall (one
     run) and device shares (eigh, K1, K2, K10, K4, K5, xc_eval) of Ar and
     Xe LC-LDA;
 19. the laplacian-level BR89: K4 and K5 in laplacian mode against their
     plain versions on the N2 bench, N2 lmax=12 (one spin), Ar and Xe
     atomic grids at one and two spins (1e-12 x max-abs, the same bits
     twice, one launch per call, CUDA-event, profiler and queued times
     beside the bound); one BR89 Fock build (K4 and K5 once each) on the
     converged Ar HF and N2 PBE densities at the bench bases, Exc within
     1e-10 and tr(Fxc P), ||Fxc|| within 1e-9 (relative) of helfem_tpu's,
     and the first five BR89 iterations there within 1e-9 Eh of
     helfem_tpu's (its BR89 does not converge at the bench bases); one BR89
     xc_eval's launches; H's BR89 exchange on its converged HF density
     within 1e-7 of the exact -5/16; Ar, Ne, Ne BR89-LYP, quartet N UKS,
     N2 and H2 BR89, Ne BR89 with Fock damping, N2 BR89 with diisthr and
     gensap Ne with diisthr through the port's CLIs and N2 BR89 with the
     level shift 1.0 through scf_diatomic, each within 1e-9 Eh of
     helfem_tpu's f64 value in its iteration count, K4 and K5 once per Fock
     build (the atomic CLI's K5 twice more); then the warm walls and device
     shares (eigh, K4, K5, xc_eval) of Ar and N UKS BR89;
 20. fields, finite nuclei, confinement, off-centre nuclei and symmetry
     0/1: K1 on the non-symmetric channel-pair windows of the Ar lmax=3
     field basis (symmetry 1: the same-m pairs; symmetry 0: all of them;
     the Coulomb and the Yukawa tables), K10 on the Ne LC-LDA basis's
     windows (symmetry 1: 17; symmetry 0: 49), K4/K5 on the Ar lmax=3 grid
     with same-m cross-l densities (one and two spins), K3 and K6 on N2's
     merged g/u blocks, each against
     its plain version (1e-12 x max-abs, the same bits twice, one launch per
     call); then 24 cells through the port's CLIs (Ar HF at Ez = 0 and
     +-0.001, Ne PBE and Ne LC-LDA in Ez, Ar HF at symmetry 0, C UHF in Bz
     at symmetry 1, He in Bz, Xe HF with a Gaussian nucleus, Ar HF with
     the spherical, hollow and regularized nucleus and confined by iconf 1
     and 3, H2 as a single-centre expansion, N2 HF and PBE at Ez = 0 and
     +-0.001, N2 HF in Qzz and with Gaussian nuclei, H2+ in Bz), each
     within 1e-8 Eh of helfem_tpu's f64 value in its iteration count with
     K1/K2/K10 or K3/K6 and K4/K5 once per Fock build, its warm wall and
     device-busy share; Ar's E(+F) and E(-F) within 1e-10 Eh, and the Ar
     HF, N2 HF and N2 PBE finite-field polarizabilities.
 21. SCF controls, the SAD atom's nuclear models and the post-SCF
     analysis: K1/K2 on a --zeroder Hermite basis (trash slots in the last
     element), K1/K2 and K4/K5 on gensap Kr's finite-nucleus sub-grid, K1
     on all channel-pair windows of the Ar bench basis, each against its
     plain version; then 15 cells through the port's CLIs (Ar HF with
     --diag 0, --eigiter 12, --perturb/--seed, --zeroder on HIP, O UHF with
     --maverage and --readocc, Xe HF, N2 PBE with --diag 0, --symmetry 1,
     --maverage and --readocc 5, N2 HF, gensap Kr with a Gaussian nucleus
     and confined), each within 1e-9 Eh of helfem_tpu's f64 value in its
     iteration count with the kernels once per Fock build, the atomic and
     diatomic analysis within 1e-9 relative, gensap's Econf and SAP table;
     the Ar warm start from its density in Ez (one more K1/K2 launch for
     the guess's Fock on all pair windows); each cell's warm wall and
     device-busy share; N2 PBE in Ez at convthr 1e-8 with the card's DIIS
     errors beside helfem_tpu's.
 22. persistence and the programs: Ar HF (the bench config) through the
     atomic CLI with --save (the crash-recovery hook at helfem_tpu's
     iterations, its wall per call and the file's bytes, within 1e-10 Eh of
     phase 4's pin), then --load on the same basis and on nelem 12 (the
     cross-basis projection); N2 PBE (the bench config) with --save, then
     --load; each warm start within 1e-9 Eh of helfem_tpu's CPU energy in
     its iteration count, the atomic (K1/K2) or diatomic (K3, K4, K5)
     kernels once per iteration and once more for the guess's Fock;
     diatomic_dline, diatomic_dgrid and diatomic_cpl on the card's N2
     checkpoint, pinned values within 1e-8 relative of helfem_tpu's output
     on its own; the hook on N2 HF at the lmax=12 basis (its wall per call
     and bytes); atomic_1e (hydrogenic within 1e-10 Eh), diatomic_1e,
     harmonic and softcoulomb within 1e-10 relative of helfem_tpu's,
     diatomic_cbasis's lmax list as helfem_tpu's and gensap Kr
     --completeness's profiles; without h5py, --save x.chk raises its
     ImportError (HDF5 is checked on the CPU).
 23. multi-device (helfem_tpu_torch/parallel/): K1/K2 on the L ranges of
     two ranks at the Ar bench basis, K3 on two ranges of the M = 0
     channels, K6 on two ranges of the exchange steps and K4/K5 on two
     element ranges (owners and band rebuilt) at the N2 bench basis, each
     against its plain version; Ar HF and N2 PBE (the bench configs)
     through the CLIs with --ndev 1 (one NCCL rank), within 1e-9 Eh of
     helfem_tpu's --ndev 1 values in their iteration counts; Ar HF, N2 PBE
     and N2 HF at the lmax=12 basis on two gloo ranks sharing the card,
     each within 1e-9 Eh of this script's single-device run (phases 4, 6,
     11) and of helfem_tpu's ndev=2 value where the CPU ran it, both ranks'
     Fock bits equal, the path's kernels once per iteration on each rank;
     per rank the launches, each kernel's ms per call on its shard (the
     ranks in turns), the all_reduce wall per iteration and the SCF wall.
 3b. (run right after phase 3) K11, the warm eigensolve's sweeps, against
     its plain version at the block shapes of Ar (one and two spins), N2
     PBE, Xe, gensap Kr's channels and N2 at lmax=12, each from a near seed
     (accepted) and a rotated one (rejected), two spins also from one of
     each, Ar also from the identity (the SCF's first seed, rejected; its
     sweeps diverge, so only the decisions compare): the same certificate
     decisions, E and V within 1e-12 x max-abs, the residuals within 1e-12
     x max|E|, the same bits twice; its call,
     device and plain times, its bound, and torch.linalg.eigh on the same
     batch beside it as a yardstick (not the same arithmetic). Then on
     recorded data: the inputs of every warm eigensolve of one Ar HF and
     one N2 PBE SCF at the bench bases (padded slots included), the same
     decisions against each SCF's gate, E and the residuals within 1e-12 x
     the unpadded max|E|, and K11's V as good an eigenbasis as the plain
     version's. Every warm
     SCF profile (phases 5, 7, 9, 11-21) splits the eigensolve: the warm
     acceptances and cold fallbacks per SCF, the residuals per K11 call, K11's and
     aten::_linalg_eigh's device time and their share of the busy time.
The script runs in a temporary working directory, where the CLIs write
their checkpoints. The last two lines are the kernels' JSON record and
{"ok": true, ...}.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

AR_HF_LIMIT = -526.8175128  # numerical HF limit (Saito 2009), bench.py gate
AR_BASIS_CLI = ["--Z", "Ar", "--lmax", "1", "--mmax", "1", "--nelem", "10", "--nnodes", "15",
                "--Rmax", "40", "--convthr", "1e-9"]
AR_CLI = AR_BASIS_CLI + ["--iguess", "3"]
AR_CLI_SAP = AR_BASIS_CLI  # the CLI's default --iguess 2, SAP
AR_HF_PORT = -526.817512802713  # the port's converged value, the same on every run
XE_HF_LIMIT = -7232.1383638  # Cinal 2020, J. Math. Chem. 58, 1571; bench.py gate
XE_CLI = ["--Z", "Xe", "--lmax", "3", "--mmax", "3", "--nelem", "8", "--nnodes", "12",
          "--Rmax", "40", "--zexp", "2.5", "--iguess", "3", "--convthr", "1e-9"]
ATOMIC = ("radial_exchange", "radial_coulomb")  # one launch each per SCF iteration
# gensap Kr at bench.py's bench_gensap basis through the port's gensap CLI
# (TF guess, aufbau without the search), and bench.py's gate
KR_GENSAP_CLI = ["--Z", "Kr", "--lmax", "2", "--Rmax", "40", "--nelem", "8", "--nnodes", "12",
                 "--method", "SVWN", "--convthr", "1e-7", "--nosearch"]
KR_GENSAP_REF = -2750.147940
KR_GENSAP_PORT = -2750.147940403  # the port's value since its first run, a 1e-8 regression gate
SAD_SHAPES = {  # SadAtomBasis arguments: gensap Kr, and SAD-HF Ar at the Ar bench basis
    "sad_kr": dict(Z=36, lmax=2, rmax=40.0, nelem=8, nnodes=12),
    "sad_ar": dict(Z=18, lmax=1, rmax=40.0, nelem=10, nnodes=15),
}
# phase 15: atomic DFT and open shells through the port's atomic CLI (TF
# guess): label -> (CLI arguments, reference energy, gate in Eh). Ar SVWN
# against the NIST LSD value (tests/test_xc.py's gate at this basis), the
# rest against helfem_tpu's scf_atom in f64 on the CPU at the same options
# (guess TF, maxit 100), -527.388222513552 for Ar PBE0 and so on
AR_LSD_NIST = -525.946195
N_CLI = ["--Z", "N", "--M", "4", "--lmax", "1", "--mmax", "1", "--nelem", "10", "--nnodes",
         "15", "--Rmax", "40", "--iguess", "3", "--convthr", "1e-9"]  # 5 alpha, 2 beta
DFT_CELLS = {
    "Ar SVWN": ([a if a != "1e-9" else "1e-8" for a in AR_CLI] + ["--method", "SVWN"],
                AR_LSD_NIST, 1e-6),
    "Ar PBE0": (AR_CLI + ["--method", "PBE0"], -527.388222513552, 1e-8),
    "Xe PBE": (XE_CLI + ["--method", "PBE"], -7234.233235137333, 1e-8),
    "N UHF": (N_CLI, -54.404548303402, 1e-8),
    "N UKS PBE": (N_CLI + ["--method", "PBE"], -54.535756774118, 1e-8),
    "N ROHF": (N_CLI + ["--restricted", "1"], -54.400934208516, 1e-8),
}
# the XC kernels on the atomic grids (phase 3), at the one spin of the
# restricted main path
ATOMIC_XC_SHAPES = ("ar", "xe", "sad_kr")
EIGH_OP = "aten::_linalg_eigh"  # its self device time: the cuSOLVER kernels it launches
# the atomic kernels on random tables: (NL, NM, nang, nelem, nnodes, primbas)
WIDE_SHAPES = {
    "np33": (3, 5, 4, 2, 33, 4),
    "np40": (3, 5, 4, 2, 40, 4),
    # NM nprim^2 doubles past one block's 227 KB; 64 channels = two groups
    "nm29_np32": (2, 29, 64, 2, 32, 4),
    # Hermite elements with two continuous derivatives: neighbours share 3 slots
    "hermite": (3, 5, 4, 4, 5, 8),
}
N2_PBE_REF = -108.978708437276  # helfem_tpu on the CPU in f64, bench.py gate
N2_PBE_PORT = -108.978708437278  # the port's value on every run since its first, gate 1e-10
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
N2_HF_REF = -108.5312159188  # helfem_tpu's pinned HF value at this basis
N2_HF_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.068", "--lmax", "6,6", "--Rmax", "25",
             "--nelem", "5", "--nnodes", "8", "--method", "HF", "--convthr", "1e-7",
             "--guess", "core"]
N2_HF_SHAPE = dict(Z1=7, Z2=7, Rbond=2.068, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8)
# the N2 HF lmax=12 bench basis of tools/profile_dia_scf.py (README); the
# JAX package's bench gate, and the value converged from the core guess by
# the exchange kernels' first, CUDA-core version (the tensor-core version
# changes only the order of the sums)
N2_L12_SHAPE = dict(Z1=7, Z2=7, Rbond=2.068, lmax=(12, 12, 12), rmax=40.0, nelem=5, nnodes=15)
N2_L12_REF = -108.9938255
N2_L12_CUDA_CORES = -108.9938178652
# N2 PBE at the same basis and the PBE bench geometry, from the core guess
N2_PBE_L12_SHAPE = dict(N2_L12_SHAPE, Rbond=2.0743)
# the port's converged value on an H100 (the first run of this phase), a
# regression gate: no f64 value of the JAX package is pinned at this size
N2_PBE_L12_REF = -109.460234908363
# the N2 HF lmax=12 bench basis (lmax (12,12,12), rmax 40, nelem 5, nnodes 15)
# by its sizes alone: the exchange kernels run on random tables of its shapes
LMAX12 = dict(nang=59, nprim=15, nelem=5, nlm=125, no=9)
REL_TOL = 1e-12
MATMUL_TOL = 1e-5  # probes against plain: both are f32 sums, in different orders
# H100 SXM peaks (NVIDIA data sheet): HBM3 3.35 TB/s; FP64 on the tensor
# cores 67 TFLOP/s, the most any f64 kernel could reach
HBM_BYTES_S = 3.35e12
FP64_FLOP_S = 67e12
# same data sheet: 67 TFLOP/s f32 outside the tensor cores, 495 TFLOP/s TF32
PROBE_FLOP_S = {"full": 67e12, "reduced": 495e12}
LIBRARY_LABEL = {"full": "true f32", "reduced": "TF32 (allow_tf32 True)"}
KERNELS = {  # name -> (source, replaces, shape of its record)
    "radial_exchange": ("helfem_tpu_torch/csrc/radial_exchange.cu",
                        "helfem_tpu/models/atomic.py:499", "ar"),
    "radial_coulomb": ("helfem_tpu_torch/csrc/radial_coulomb.cu",
                       "helfem_tpu/models/atomic.py:436", "ar"),
    "radial_erfc_exchange": ("helfem_tpu_torch/csrc/radial_erfc_exchange.cu",
                             "helfem_tpu/models/atomic.py:729", "ar"),
    "radial_coulomb_dia": ("helfem_tpu_torch/csrc/radial_coulomb_dia.cu",
                           "helfem_tpu/models/diatomic.py:709", "n2"),
    "dia_xc_fields": ("helfem_tpu_torch/csrc/dia_xc_fields.cu",
                      "helfem_tpu/models/diatomic_dft.py:95", "n2"),
    "dia_xc_fock": ("helfem_tpu_torch/csrc/dia_xc_fock.cu",
                    "helfem_tpu/models/diatomic_dft.py:155", "n2"),
    "radial_exchange_dia_occ": ("helfem_tpu_torch/csrc/radial_exchange_dia.cu",
                                "helfem_tpu/models/diatomic.py:944", "n2"),
    "radial_exchange_dia": ("helfem_tpu_torch/csrc/radial_exchange_dia.cu",
                            "helfem_tpu/models/diatomic.py:799", "n2"),
    # no Pallas kernel: the lax.scan of _refine_passes under eigh_warm_with
    "refine_eig": ("helfem_tpu_torch/csrc/refine_eig.cu", "helfem_tpu/utils/linalg.py:21",
                   "ar"),
}
# K11's shapes: label -> (blocks, block size, groups). The whitened blocks
# of Ar (one and two spins), N2 PBE, Xe and N2 at lmax=12 (10 blocks of 490)
# in their bench bases, and gensap Kr's three l channels
REFINE_SHAPES = {"ar": (4, 139, 1), "ar_2": (8, 139, 2), "n2": (6, 140, 1), "xe": (16, 87, 1),
                 "sad_kr": (3, 87, 1), "lmax12": (10, 490, 1)}
REFINE_GATE = 1e-9  # the fused chunks' widest certificate gate, min(0.1 convthr, 1e-9)
# phase 3b's recorded inputs: the warm eigensolves of one SCF each at the Ar HF
# and N2 PBE bench bases, chip_smoke's settings: cell -> (kind, basis, (nela,
# nelb), SCF keywords)
REFINE_REAL = {
    "ar_scf": ("atomic", SHAPES["ar"], (9, 9), dict(convthr=1e-9, guess="TF")),
    "n2_scf": ("diatomic", DIA_SHAPES["n2"], (7, 7), dict(method="PBE", convthr=1e-7, maxit=50)),
}
# K11's V on recorded data: its defects (eigenbasis_defects) no larger than
# this many times the plain version's, or than eps n (x the scale for the
# off-diagonal), whichever is larger
REFINE_V_SLACK = 4.0
EPS = 2.0 ** -52
XC = ("dia_xc_fields", "dia_xc_fock")  # one launch each per SCF iteration
K3 = ("radial_coulomb_dia",)  # one launch per diatomic SCF iteration
XC_K3 = (*XC, *K3)
INELEM = "exdia_inelem_kernel"  # the in-element GEMM core of K6 and K7
RADIAL_SASS = ("radial_exchange_kernel", "radial_coulomb_kernel")  # K1, K2 on DMMA
K10_SASS = "radial_erfc_exchange_kernel"  # K10 on DMMA
K3_SASS = "radial_coulomb_dia_kernel"  # K3's instances (columns per lane, channels)
NO_SPILLS = (*RADIAL_SASS, K10_SASS, K3_SASS)  # ptxas must report no spills for these
# K3 past the old nprim 32 (the LiH XC shapes of tests/test_torch_kernels.py)
# and at the N2 bench with every signed channel (njbd None: +-M share a row)
K3_SHAPES = {
    "np33": (dict(Z1=3, Z2=1, Rbond=3.015, lmax=(2, 1), rmax=20.0, nelem=2, nnodes=33), True),
    "np40": (dict(Z1=3, Z2=1, Rbond=3.015, lmax=(2, 1), rmax=20.0, nelem=2, nnodes=40), True),
    "n2_all": (dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8),
               False),
}
# K6/K7 past the old nprim 32 on random tables: (nang, nprim, nelem, nlm, no)
EXCHANGE_WIDE = {"np33": (3, 33, 2, 1, 2), "np40": (3, 40, 2, 1, 2)}
XC_SASS = ("xc_fields_kernel", "xc_fock_kernel")  # K4 and K5, both on DMMA
PROBE_TF32, PROBE_FULL = "matmul_tf32_kernel", "matmul_full_kernel"  # K8/K9 instances
K6_SASS = "exdia_"  # the device kernels of K6 (and K7)
# phase 16: triplet O2 X3Sigma_g- at the N2 bench basis through the port's
# diatomic CLI, from the SAP guess: label -> (CLI arguments, helfem_tpu's
# scf_diatomic in f64 on the CPU at the same options (maxit 50), and its
# iteration count)
O2_SHAPE = dict(Z1=8, Z2=8, Rbond=2.282, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8)
O2_CLI = ["--Z1", "O", "--Z2", "O", "--Rbond", "2.282", "--lmax", "6,6", "--Rmax", "25",
          "--nelem", "5", "--nnodes", "8", "--M", "3", "--iguess", "2"]
O2_CELLS = {
    "O2 UHF": (O2_CLI + ["--restricted", "0", "--convthr", "1e-8"], -147.85336509135217, 12),
    "O2 UKS-PBE": (O2_CLI + ["--method", "PBE", "--convthr", "1e-7"], -148.40897278531432, 9),
    "O2 ROHF": (O2_CLI + ["--restricted", "1", "--convthr", "1e-8"], -147.82949099699513, 10),
}
# O2 UHF at the bench's profile-point basis (nbf 4130); no f64 value of
# helfem_tpu at this size, so the port's own from its first run on an H100,
# a 1e-8 regression gate
O2_L12_SHAPE = dict(O2_SHAPE, lmax=(12, 12, 12), rmax=40.0, nnodes=15)
O2_L12_PORT = -149.691060621579
# the spin counts tr(P S) of that basis: its overlap blocks reach a condition
# number of 7.6e11, so S^-1/2 whitens them only to 5.5e-7 (max |Sinvh^T S
# Sinvh - I|) and the occupied orbitals' S-norms carry ~1e-10 per electron
# (tr(Pa S) - 9 = -7.06e-10 on the first run). Witnesses that this is the
# basis: phase 11 prints tr(P S) - 14 of closed-shell N2 HF at the same
# sizes, and tests/test_torch_dia_open.py::test_lmax12_whitening_matches_jax
# holds helfem_tpu's own host S^-1/2 to the same defect on these blocks
SPIN_COUNT_TOL = 1e-8
# H2+ (one electron, nelb = 0): the exact electronic energy
# -1.1026342144949 (tests/test_diatomic.py:150) plus 1/R
H2P_CLI = ["--Z1", "H", "--Z2", "H", "--Rbond", "2.0", "--lmax", "10", "--Rmax", "20",
           "--nelem", "3", "--nnodes", "14", "--Q", "1", "--convthr", "1e-9"]
H2P_EXACT = -0.6026342144949
# gensap Cr --unrestricted at bench.py's bench_gensap basis (lda_x, TF guess,
# convthr 1e-7; the restricted leg without its search), and helfem_tpu's
# search_sadatom_unrestricted there in f64 on the CPU (3d5 4s1, M = 7)
CR_GENSAP_CLI = ["--Z", "Cr", "--lmax", "2", "--Rmax", "40", "--nelem", "8", "--nnodes", "12",
                 "--unrestricted", "--nosearch"]
CR_SHAPE = dict(Z=24, lmax=2, rmax=40.0, nelem=8, nnodes=12)
CR_U_REF = -1040.2732201950523
# SAD-UHF Cr at M = 7 (15 alpha, 9 beta, aufbau, convthr 1e-8): helfem_tpu's
# solve_sadatom_unrestricted in f64 on the CPU, occupations (4,6,5)/(3,6,0)
CR_UHF_REF = -1043.3567816060308
# phase 17: meta-GGAs and the new GGA catalog. The XC kernels in tau mode on
# these grids (one and two spins), and full-width SCFs through the port's
# CLIs: label -> (CLI module, arguments, helfem_tpu's energy, its iteration
# count). Each energy is helfem_tpu's CLI in f64 on the CPU with the same
# arguments, e.g. `python -m helfem_tpu.cli.atomic --Z Ar --lmax 1 --mmax 1
# --nelem 10 --nnodes 15 --Rmax 40 --convthr 1e-8 --iguess 3 --method TPSS`,
# `python -m helfem_tpu.cli.diatomic --Z1 N --Z2 N --Rbond 2.0743 --lmax 6,6
# --nelem 5 --nnodes 8 --Rmax 25 --iguess 2 --convthr 1e-7 --method TPSS` and
# `python -m helfem_tpu.cli.gensap --Z Kr --lmax 2 --Rmax 40 --nelem 8
# --nnodes 12 --method TPSS --pot SVWN --convthr 1e-7 --nosearch` (gensap's
# result has no iteration count)
TAU_GRIDS = ("n2", "lmax12", "ar", "xe", "sad_kr")
AR_MGGA_CLI = [a if a != "1e-9" else "1e-8" for a in AR_CLI]
N2_MGGA_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "6,6", "--nelem", "5",
               "--nnodes", "8", "--Rmax", "25", "--iguess", "2", "--convthr", "1e-7"]
KR_TPSS_CLI = [a if a != "SVWN" else "TPSS" for a in KR_GENSAP_CLI] + ["--pot", "SVWN"]
MGGA_CELLS = {
    "Ar TPSS": ("atomic", AR_MGGA_CLI + ["--method", "TPSS"], -527.5694249429183, 10),
    "Ar TPSSh": ("atomic", AR_MGGA_CLI + ["--method", "TPSSh"], -527.5645163672733, 10),
    "Ar rSCAN": ("atomic", AR_MGGA_CLI + ["--method", "rSCAN"], -527.6283489665886, 10),
    "Ar B3LYP5": ("atomic", AR_MGGA_CLI + ["--method", "B3LYP5"], -527.4982727594287, 9),
    "N2 TPSS": ("diatomic", N2_MGGA_CLI + ["--method", "TPSS"], -109.12524381118806, 9),
    "N2 B3LYP5": ("diatomic", N2_MGGA_CLI + ["--method", "B3LYP5"], -109.04793816048158, 8),
    "N UKS-TPSS": ("atomic", N_CLI + ["--method", "TPSS"], -54.616175639654855, 12),
    "gensap Kr TPSS": ("gensap", KR_TPSS_CLI, -2753.7109945860525, None),
}
MGGA_GATE = 1e-9
# phase 18: range-separated exchange. K10 on the erfc tables of the Ar and
# Xe bench bases at omega 0.5 (LC-LDA's), one and two spins; K1 on the
# Yukawa tables of the Ar bench basis against the pairwise plain version;
# and SCFs through the port's atomic CLI (TF guess, convthr 1e-8): label ->
# (arguments, helfem_tpu's energy, its iteration count). Each energy is
# helfem_tpu's CLI in f64 on the CPU with the same arguments, e.g.
# `python -m helfem_tpu.cli.atomic --Z Ar --lmax 1 --mmax 1 --nelem 10
# --nnodes 15 --Rmax 40 --convthr 1e-8 --iguess 3 --method LC-LDA` and
# `python -m helfem_tpu.cli.atomic --Z Xe --lmax 3 --mmax 3 --nelem 8
# --nnodes 12 --Rmax 40 --zexp 2.5 --convthr 1e-8 --iguess 3 --method LC-LDA`
RS_OMEGA = 0.5
YUKAWA_LAMBDAS = (0.5, 5.0)
N_RS_CLI = [a if a != "1e-9" else "1e-8" for a in N_CLI]
XE_RS_CLI = [a if a != "1e-9" else "1e-8" for a in XE_CLI]
RS_CELLS = {
    "Ar LC-LDA": (AR_MGGA_CLI + ["--method", "LC-LDA"], -526.2549934771708, 10),
    "Ar SR-PBE0": (AR_MGGA_CLI + ["--method", "SR-PBE0"], -527.1116876584628, 9),
    "Ar LCY-LDA": (AR_MGGA_CLI + ["--method", "LCY-LDA"], -525.3580205557585, 10),
    "N UKS LC-LDA": (N_RS_CLI + ["--method", "LC-LDA"], -54.302778574768233, 10),
    "Xe LC-LDA": (XE_RS_CLI + ["--method", "LC-LDA"], -7229.3531863185544, 11),
}
RS_GATE = 1e-9
# phase 19: the laplacian-level BR89. K4/K5 in laplacian mode on these grids
# (the lmax=12 one at one spin)
LAPL_GRIDS = ("n2", "lmax12", "ar", "xe")
# helfem_tpu's BR89 does not converge at the bench bases (its DIIS error
# stays at 0.3-1.4 at Ar, near 5e-3 at N2), so the full-width checks are one
# BR89 Fock build on the converged Ar HF (bench Ar, TF, convthr 1e-9) and N2
# PBE (bench N2, core guess, convthr 1e-7) densities -- Exc, tr(Fxc P) and
# ||Fxc|| of helfem_tpu's eval_fxc / eval_fxc_dia (mgga_x_br89) in f64 on
# the CPU from its own SCF at the same settings -- and the energies of the
# first five BR89 iterations at both bench bases (scf_atom TF guess,
# scf_diatomic core guess, maxit 5), helfem_tpu's verbose lines.
LAPL_FOCK_REFS = {
    "ar": {"Exc": -30.546668267754296, "trFP": -20.56157514527068, "Fnorm": 38.156320333904006},
    "n2": {"Exc": -13.294799188800758, "trFP": -8.851908285187628, "Fnorm": 94.53318056823409},
}
LAPL_FIVE_REFS = {
    "ar": (-526.082300718588, -523.86009660598, -526.966909220955, -527.516676850013,
           -527.520908829374),
    "n2": (-92.221153388574, -89.747615702539, -108.79648311108, -108.947663984426,
           -108.985609809719),
}
LAPL_FOCK_TOL = 1e-10  # Exc, relative; tr(Fxc P) and ||Fxc|| 1e-9 relative
LAPL_FIVE_TOL = 1e-9  # Eh
# converged BR89 cells and the three SCF controls, through the port's CLIs
# (TF guess for atoms, core guess for diatomics, convthr 1e-8): label ->
# (CLI module, arguments, helfem_tpu's energy, its iteration count). Each is
# helfem_tpu's CLI in f64 on the CPU with the same arguments, e.g.
# `python -m helfem_tpu.cli.atomic --Z Ar --lmax 1 --mmax 1 --Rmax 30
# --nelem 6 --nnodes 8 --iguess 3 --convthr 1e-8 --method mgga_x_br89`,
# `python -m helfem_tpu.cli.diatomic --Z1 N --Z2 N --Rbond 2.0743 --lmax
# 4,4 --Rmax 15 --nelem 3 --nnodes 6 --convthr 1e-8 --method mgga_x_br89`
# and `python -m helfem_tpu.cli.gensap --Z Ne --lmax 1 --Rmax 30 --nelem 6
# --nnodes 8 --method SVWN --nosearch --convthr 1e-8 --diisthr 0.01`
# (gensap's result has no iteration count); "N2 BR89 shift" is helfem_tpu's
# scf_diatomic(..., method="mgga_x_br89", convthr=1e-8, shift=1.0) on the
# same basis (the level shift has no CLI flag there either)
BR_ATOM = ["--lmax", "1", "--mmax", "1", "--Rmax", "30", "--nelem", "6", "--nnodes", "8",
           "--iguess", "3", "--convthr", "1e-8", "--method", "mgga_x_br89"]
BR_N2 = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "4,4", "--Rmax", "15",
         "--nelem", "3", "--nnodes", "6", "--convthr", "1e-8", "--method", "mgga_x_br89"]
BR_N2_BASIS = dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(4, 4), rmax=15.0, nelem=3, nnodes=6)
LAPL_CELLS = {
    "Ar BR89": ("atomic", ["--Z", "Ar"] + BR_ATOM, -527.3893273557395, 16),
    "Ne BR89": ("atomic", ["--Z", "Ne"] + BR_ATOM, -128.92297825020395, 16),
    "Ne BR89-LYP": ("atomic", ["--Z", "Ne"] + BR_ATOM[:-1] + ["mgga_x_br89,gga_c_lyp"],
                    -129.30565920773984, 16),
    "N UKS BR89": ("atomic", ["--Z", "N", "--M", "4"] + BR_ATOM, -54.588885492651755, 18),
    "N2 BR89": ("diatomic", BR_N2, -103.34609096274556, 17),
    "H2 BR89": ("diatomic", ["--Z1", "H", "--Z2", "H", "--Rbond", "1.4", "--lmax", "4"]
                + BR_N2[8:] + ["--maxit", "100"], -1.160565012388095, 50),
    "Ne BR89 dampfock": ("atomic", ["--Z", "Ne"] + BR_ATOM + ["--dampfock", "0.5",
                                                              "--dampthr", "0.01"],
                         -128.92297825020466, 17),
    "N2 BR89 diisthr": ("diatomic", BR_N2 + ["--diiseps", "5", "--diisthr", "0.01"],
                        -103.34609096274448, 18),
    "gensap Ne diisthr": ("gensap", ["--Z", "Ne", "--lmax", "1", "--Rmax", "30", "--nelem", "6",
                                     "--nnodes", "8", "--method", "SVWN", "--nosearch",
                                     "--convthr", "1e-8", "--diisthr", "0.01"],
                          -128.23347675484135, None),
}
N2_SHIFT_REF = (-103.34609096274545, 33)
LAPL_GATE = 1e-9
H_BR89_EXC = -5.0 / 16.0  # BR89 is exact for a one-electron density
H_EXC_TOL = 1e-7
TAU_TRACE_TOL = 1e-10  # sum w tau against tr(P T), relative
KINETIC_GRID_TOL = 1e-9  # the grid kinetic matrix against the analytic T
# phase 20: external fields, finite nuclei, confinement and off-centre
# nuclei. The kernels on this slice's new inputs: K1 on the non-symmetric
# channel-pair windows of the Ar lmax=3 field basis (symmetry 1: the same-m
# pairs; symmetry 0: all of them; the Coulomb and the Yukawa tables), K10
# on the windows of the Ne LC-LDA field basis, K4/K5 on the Ar field grid
# with same-m cross-l blocks, K3 and K6 on N2's merged g/u blocks (Ez).
FIELD_SHAPES = {  # AtomicBasis arguments
    "ar_l3": dict(Z=18, lmax=3, mmax=1, rmax=40.0, nelem=10, nnodes=15),
    "ne_l2": dict(Z=10, lmax=2, mmax=1, rmax=30.0, nelem=6, nnodes=8),
}
FIELD_LAMBDA = 0.5  # the Yukawa tables of the K1 check
# full-width cells through the port's CLIs (TF guess for atoms, core guess
# for diatomics): label -> (CLI module, arguments, helfem_tpu's energy, its
# iteration count). Each energy is helfem_tpu's CLI in f64 on the CPU with
# the same arguments and --save "", e.g. `python -m helfem_tpu.cli.atomic
# --Z Ar --lmax 3 --mmax 1 --nelem 10 --nnodes 15 --Rmax 40 --iguess 3
# --convthr 1e-10 --Ez 0.001 --save ""` and `python -m helfem_tpu.cli.diatomic
# --Z1 N --Z2 N --Rbond 2.068 --lmax 6,6 --Rmax 25 --nelem 5 --nnodes 8
# --method HF --convthr 8e-8 --guess core --Ez 0.001 --save ""`; "H2
# single-centre" is helfem_tpu's scf_atom with the CLI's arguments (its CLI
# stops after the SCF, in the cusp analysis, at Z = 0). Each convergence
# threshold lies between the DIIS errors of helfem_tpu's last two
# iterations, at least twice the one and half the other: near the
# threshold the DIIS solve's ill-conditioned history amplifies the last
# bits (N2 PBE at Ez=+0.001 and convthr 1e-8 took one iteration more on the
# card than on the CPU, DIIS error 2.16e-8 against 5.32e-9 at iteration
# 12, the same energy within 1e-12).
F_AR = ["--Z", "Ar", "--lmax", "3", "--mmax", "1", "--nelem", "10", "--nnodes", "15",
        "--Rmax", "40", "--iguess", "3"]
F_SMALL = ["--Rmax", "30", "--nelem", "6", "--nnodes", "8", "--iguess", "3"]


def convthr(argv: list[str], thr: str) -> list[str]:
    """argv with its --convthr set to thr (added where it has none)."""
    if "--convthr" not in argv:
        return argv + ["--convthr", thr]
    i = argv.index("--convthr") + 1
    return argv[:i] + [thr] + argv[i + 1:]


F_N2_PBE = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--lmax", "6,6", "--nelem", "5",
            "--nnodes", "8", "--Rmax", "25", "--method", "PBE"]
F_H2P = ["--Z1", "H", "--Z2", "H", "--Rbond", "2.0", "--lmax", "10", "--Rmax", "20", "--nelem",
         "3", "--nnodes", "14", "--Q", "1"]
FIELD_CELLS = {
    "Ar HF Ez=0": ("atomic", convthr(F_AR, "1e-10"), -526.8175128027102, 11),
    "Ar HF Ez=+0.001": ("atomic", convthr(F_AR, "1e-10") + ["--Ez", "0.001"],
                        -526.8175181817528, 12),
    "Ar HF Ez=-0.001": ("atomic", convthr(F_AR, "1e-10") + ["--Ez", "-0.001"],
                        -526.8175181817528, 12),
    "Ne PBE Ez=0.001": ("atomic", convthr(["--Z", "Ne"] + F_AR[2:], "4e-9")
                        + ["--method", "PBE", "--Ez", "0.001"], -128.8664317849206, 10),
    "Ne LC-LDA Ez=0.001": ("atomic", convthr(["--Z", "Ne", "--lmax", "2", "--mmax", "1"]
                                             + F_SMALL, "3e-9")
                           + ["--method", "LC-LDA", "--Ez", "0.001"], -128.454483990331, 10),
    "Ar HF symmetry 0 Ez=0.001": ("atomic", convthr(["--Z", "Ar", "--lmax", "3", "--mmax", "1"]
                                                    + F_SMALL, "1.5e-8")
                                  + ["--Ez", "0.001", "--symmetry", "0"],
                                  -526.8170548253172, 10),
    "C UHF Bz=0.1": ("atomic", convthr(["--Z", "C", "--M", "3", "--lmax", "4", "--mmax", "2"]
                                       + F_SMALL, "2e-8") + ["--Bz", "0.1", "--symmetry", "1"],
                     -37.83014604372427, 11),
    "He Bz=0.5": ("atomic", convthr(["--Z", "He", "--lmax", "2", "--mmax", "1"] + F_SMALL, "1e-8")
                  + ["--Bz", "0.5"], -2.814088696367728, 7),
    "Xe HF gaussian": ("atomic", convthr(XE_CLI, "1e-7") + ["--finitenuc", "2", "--Rrms", "1e-4",
                                                           "--nelem0", "2"],
                       -7232.013765253448, 10),
    "Ar HF spherical": ("atomic", convthr(AR_CLI, "2e-7") + ["--finitenuc", "3", "--Rrms", "1e-4",
                                                            "--nelem0", "2"],
                        -526.816069525503, 8),
    "Ar HF hollow": ("atomic", convthr(AR_CLI, "2e-7") + ["--finitenuc", "4", "--Rrms", "1e-4",
                                                         "--nelem0", "2"],
                     -526.816069423491, 8),
    "Ar HF regularized": ("atomic", convthr(AR_CLI, "1.5e-9") + ["--finitenuc", "5", "--Rrms",
                                                                "3"],
                          -526.8130061082214, 10),
    "Ar HF iconf 1": ("atomic", AR_CLI + ["--iconf", "1", "--conf_N", "10", "--conf_R", "5",
                                          "--shift_conf", "1"], -526.8141021753888, 10),
    "Ar HF iconf 3": ("atomic", convthr(AR_CLI, "2e-10") + ["--iconf", "3", "--conf_R", "4",
                                                           "--conf_barrier", "1", "--shift_conf",
                                                           "4"], -526.7878766432044, 10),
    "H2 single-centre": ("atomic", convthr(["--Z", "0", "--Zl", "1", "--Zr", "1", "--Rmid",
                                            "0.7", "--lmax", "8", "--mmax", "0", "--nelem0",
                                            "3"] + F_SMALL, "5e-8"),
                         -1.8468642861623992, 7),
    "N2 HF Ez=0": ("diatomic", convthr(N2_HF_CLI, "4e-8"), -108.5312159188064, 11),
    "N2 HF Ez=+0.001": ("diatomic", convthr(N2_HF_CLI, "8e-8") + ["--Ez", "0.001"],
                        -108.5312233837794, 12),
    "N2 HF Ez=-0.001": ("diatomic", convthr(N2_HF_CLI, "8e-8") + ["--Ez", "-0.001"],
                        -108.53122338378031, 12),
    "N2 PBE Ez=0": ("diatomic", convthr(F_N2_PBE, "3e-8"), -108.97870843727404, 10),
    "N2 PBE Ez=+0.001": ("diatomic", convthr(F_N2_PBE, "5e-8") + ["--Ez", "0.001"],
                         -108.9787161292133, 12),
    "N2 PBE Ez=-0.001": ("diatomic", convthr(F_N2_PBE, "5e-8") + ["--Ez", "-0.001"],
                         -108.97871612921239, 12),
    "N2 HF Qzz=0.001": ("diatomic", convthr(N2_HF_CLI, "4e-8") + ["--Qzz", "0.001"],
                        -108.5259197338141, 11),
    "N2 HF gaussian": ("diatomic", convthr(N2_HF_CLI, "4e-8")
                       + ["--finitenuc", "gaussian", "--Rrms1", "0.01", "--Rrms2", "0.01"],
                       -108.07705147029037, 11),
    "H2+ Bz=0.1": ("diatomic", convthr(F_H2P, "1e-9") + ["--Bz", "0.1"], -0.6510350658619463, 2),
}
FIELD_GATE = 1e-8
# the records of phase 20's kernel checks, by kernel (field_kernels)
FIELD_KEYS = {"radial_exchange": ("field_s1", "field_s0", "field_yukawa"),
              "radial_erfc_exchange": ("field_ne", "field_ne_s0"),
              **dict.fromkeys(("dia_xc_fields", "dia_xc_fock"), ("field_ar_l3_1", "field_ar_l3_2")),
              **dict.fromkeys(("radial_coulomb_dia", "radial_exchange_dia_occ"),
                              ("field_n2_merged",))}
FIELD_F = 0.001  # the finite field of the polarizabilities
FIELD_PM_TOL = 1e-10  # E(+F) against E(-F) of an atom
# the polarizability triples (E(0), E(+F), E(-F)) among FIELD_CELLS
ALPHA_CELLS = {"Ar HF alpha": ("Ar HF Ez=0", "Ar HF Ez=+0.001", "Ar HF Ez=-0.001"),
               "N2 HF alpha_zz": ("N2 HF Ez=0", "N2 HF Ez=+0.001", "N2 HF Ez=-0.001"),
               "N2 PBE alpha_zz": ("N2 PBE Ez=0", "N2 PBE Ez=+0.001", "N2 PBE Ez=-0.001")}
# phase 21: the SCF controls (--diag 0, --eigiter, --perturb/--seed,
# --maverage, --readocc, a warm-start density), --zeroder on a Hermite
# basis, the SAD atom's finite nucleus and confinement through gensap, the
# diatomic --symmetry and the post-SCF analysis. The kernels first: K1/K2 on
# the zeroder Hermite basis (trash slots in the last element) and on the
# finite-nucleus sub-grid of gensap Kr (whose K4/K5 grid runs too), K1 on
# the Ar bench basis's windows of all channel pairs (the warm start's one
# Fock of a density with cross-channel blocks).
KR_RRMS = "7.9149e-5"  # Kr-84's rms charge radius, 4.1884 fm, in bohr
CONTROL_SHAPES = {  # AtomicBasis arguments
    "ar_zeroder": dict(Z=18, lmax=1, mmax=1, rmax=40.0, nelem=10, nnodes=8, primbas=5,
                       zeroder=True),
}
CONTROL_SAD_SHAPES = {  # SadAtomBasis arguments
    "sad_kr_gauss": dict(Z=36, lmax=2, rmax=40.0, nelem=8, nnodes=12, finitenuc="gaussian",
                         Rrms=float(KR_RRMS), nelem0=2),
}
CONTROL_KEYS = {"radial_exchange": ("ctrl_ar_zeroder", "ctrl_sad_kr_gauss", "ctrl_ar_pairs"),
                "radial_coulomb": ("ctrl_ar_zeroder", "ctrl_sad_kr_gauss"),
                **dict.fromkeys(("dia_xc_fields", "dia_xc_fock"), ("ctrl_sad_kr_gauss",))}
# Cells through the port's CLIs: label -> (CLI module, arguments, helfem_tpu's
# energy, its iteration count; None for gensap, whose result has none).
# Each is helfem_tpu's CLI in f64 on the CPU with the same arguments and
# --save "" (the atomic and diatomic CLIs; gensap with --output), e.g.
# `python -m helfem_tpu.cli.atomic --Z Ar --lmax 1 --mmax 1 --nelem 10
# --nnodes 15 --Rmax 40 --convthr 1.6e-9 --iguess 3 --diag 0 --save ""` and
# `python -m helfem_tpu.cli.gensap --Z Kr --lmax 2 --Rmax 40 --nelem 8
# --nnodes 12 --method SVWN --convthr 1e-7 --nosearch --iconf 1 --conf_N 2
# --conf_R 8 --add_conf --output result_Kr.dat`. Each threshold lies
# between helfem_tpu's last two DIIS errors, at least twice the one and
# half the other (the warm start's 1e-9 sits 1.8x from both: its errors run
# 4.6e-9, 1.9e-9, 5.6e-10).
C_AR = ["--Z", "Ar", "--lmax", "1", "--mmax", "1", "--nelem", "10", "--nnodes", "15", "--Rmax",
        "40", "--iguess", "3"]
C_O = ["--Z", "O", "--M", "3"] + C_AR[2:]  # 5 alpha, 3 beta on the Ar bench radial grid
O_READOCC = "0 0 2 2\n1 0 1 1\n1 1 1 0\n1 -1 1 0\n"  # l m na nb: the beta p in p0
# per-block na nb of N2 (6,6) with g/u: pi-g pi-u sigma-g sigma-u pi-g pi-u
N2_READOCC = "0 0\n1 1\n3 3\n2 2\n0 0\n1 1\n"
CONTROL_CELLS = {
    "Ar HF": ("atomic", convthr(C_AR, "1.6e-9"), -526.8175128027411, 10),
    "Ar HF diag 0": ("atomic", convthr(C_AR, "1.6e-9") + ["--diag", "0"],
                     -526.8175128027245, 10),
    "Ar HF eigiter 12": ("atomic", convthr(C_AR, "1e-9") + ["--eigiter", "12"],
                         -526.817512802721, 10),
    "Ar HF perturb": ("atomic", convthr(C_AR, "4e-9") + ["--perturb", "0.01", "--seed", "3"],
                      -526.817512802716, 10),
    "Ar HF zeroder": ("atomic", convthr([a if a != "15" else "8" for a in C_AR], "3.5e-7")
                      + ["--primbas", "5", "--zeroder"], -526.8175128013844, 8),
    "O UHF maverage": ("atomic", convthr(C_O, "1.3e-9") + ["--maverage"], -74.62239855080149,
                       11),
    "O UHF readocc": ("atomic", convthr(C_O, "2.3e-9") + ["--readocc", "OCCS"],
                      -74.81405024292772, 12),
    "Xe HF": ("atomic", convthr(XE_CLI, "2.2e-9"), -7232.138363862154, 11),
    "N2 PBE diag 0": ("diatomic", convthr(N2_CLI, "5.4e-7") + ["--diag", "0"],
                      -108.9787084364371, 9),
    "N2 PBE symmetry 1": ("diatomic", convthr(N2_CLI, "5.4e-7") + ["--symmetry", "1"],
                          -108.97870843884107, 9),
    "N2 PBE maverage": ("diatomic", convthr(N2_CLI, "3.6e-7") + ["--maverage"],
                        -108.97870843727725, 10),
    "N2 PBE readocc 5": ("diatomic", N2_CLI + ["--readocc", "5"], -108.9787084372787, 11),
    "N2 HF": ("diatomic", convthr(N2_HF_CLI, "4e-8"), -108.53121591880677, 11),
    "gensap Kr gaussian": ("gensap", KR_GENSAP_CLI + ["--finitenuc", "gaussian", "--Rrms",
                                                      KR_RRMS, "--nelem0", "2"],
                           -2750.132832139385, None),
    "gensap Kr iconf 1": ("gensap", KR_GENSAP_CLI + ["--iconf", "1", "--conf_N", "2",
                                                     "--conf_R", "8", "--add_conf"],
                          -2749.554392903532, None),
}
CONTROL_GATE = 1e-9
# N2 PBE on the merged g/u blocks stops at iteration 9 still 4e-10 Eh from
# its floor (DIIS error 5.3e-9 from iteration 12 on), and there helfem_tpu's
# own energy moves in the ninth digit with the CPU's thread count: 1e-8
CONTROL_GATES = {"N2 PBE symmetry 1": FIELD_GATE}
ANALYSIS_TOL = 1e-9  # relative; a multipole that vanishes by symmetry: of <r^2>
# helfem_tpu's atomic_analysis of those cells (its CLI prints them to ten
# digits after the SCF; here the f64 values of the same call)
CONTROL_ANALYSIS = {
    "Ar HF": {"<r^-1>": 69.72544037802683, "<r^1>": 16.07084519196442,
              "<r^2>": 26.03438972299237, "<r^3>": 55.9879043242741,
              "density_at_nucleus": 3839.781829694959,
              "density_gradient_at_nucleus": -138232.14586473227, "cusp": 0.9999999999689925,
              "dipole_z": -0.0, "quadrupole_zz": -3.241851231905457e-14,
              "virial_ratio": 0.9999999998762462},
    "O UHF readocc": {"<r^-1>": 22.25828691549478, "<r^1>": 7.619873320362915,
                      "<r^2>": 11.227381327748267, "<r^3>": 21.31937898048495,
                      "density_at_nucleus": 311.61174311266365,
                      "density_gradient_at_nucleus": -4985.787889508837,
                      "cusp": 0.9999999999410762, "dipole_z": -0.0,
                      "quadrupole_zz": -0.9765653806465453, "virial_ratio": 1.0000000003415357},
    "Xe HF": {"<r^-1>": 317.8740851999029, "<r^1>": 39.060807751390826,
              "<r^2>": 62.65138527545317, "<r^3>": 152.44809584988147,
              "density_at_nucleus": 111219.43787462653,
              "density_gradient_at_nucleus": -12011699.380143275, "cusp": 1.000000007466355,
              "dipole_z": -0.0, "quadrupole_zz": 7.105427357601002e-15,
              "virial_ratio": 1.0000000000019065},
}
# N2 HF's diatomic analysis: the electronic dipole and quadrupole, the
# densities at the nuclei, and per occupied alpha orbital (E, 1/<r_l^-1>,
# <r_l>, sqrt(<r_c^2>), <r_r>). Within DIA_ANALYSIS_TOL: N2 HF's DIIS error
# floors at 1.06e-9 from iteration 12 on, and a moment is first order in
# the density's error, so it is settled to about 1e-9 only: helfem_tpu's
# CLI prints the electronic quadrupole as -1.5904149114e+01 at convthr 4e-8
# (11 iterations) and -1.5904149075e+01 after 20 iterations at 1e-11
DIA_ANALYSIS_TOL = 1e-8
N2_HF_ANALYSIS = {
    "eldip": -0.0, "elquad": -15.904149113698873,
    "nucdens": (182.27212989705993, 182.27212989705993),
    "orbitals": ((-15.654497811193368, 0.2823010798750203, 1.153531892235175,
                  1.066474909747613, 1.153531892235175),
                 (-15.506738972234569, 0.2877935916313874, 1.1534139909310959,
                  1.0644550956408867, 1.1534139909310959),
                 (-1.4709388780063268, 1.1178996983463636, 1.494353164051198,
                  1.2497955898950546, 1.494353164051198),
                 (-0.7781903081313253, 1.4075854632422269, 2.14604375982452,
                  2.1493197862264073, 2.1460437598245194),
                 (-0.6370115240500729, 1.418120721869841, 2.107505195216315,
                  2.1515167762491605, 2.107505195216315),
                 (-0.6146664024470374, 1.4473098553816566, 1.8930920048606101,
                  1.7940385034709188, 1.8930920048606101),
                 (-0.6146664024470354, 1.4473098553816572, 1.893092004860611,
                  1.7940385034709199, 1.8930920048606112)),
}
# gensap: Econf as its CLI prints it, and the SAP table's column sums over
# the rows at r >= 1e-3 bohr of n, dn/dr, r V_coul, r V_xc and Z_eff (nearer
# the nucleus the laplacian's 2 n'/r and the sub-grid's steep b' magnify
# the SCF's last bits); within TABLE_TOL x the sum of |column|
GENSAP_TABLES = {
    "gensap Kr gaussian": (None, (376274.3503551722, -25100617.80919921, 13335.350251637266,
                                  -263.5845389514818, 3812.2342873142143)),
    "gensap Kr iconf 1": (0.574197454, (358016.73929286277, -23799060.20884043,
                                        13344.841436901897, -256.5152109356969,
                                        3759.6737740338003)),
}
TABLE_COLUMNS = (1, 2, 5, 6, 8)
TABLE_TOL = 1e-8  # the table's density is the SCF's at convthr 1e-7
# the warm start: helfem_tpu's scf_atom at the Ar bench basis (TF guess) in
# Ez = 0.001 (symmetry 1, convthr 1e-9), then from its alpha density with
# symmetry 2 (convthr 1e-9): (E, iterations) of each
WARM_START_REFS = ((-526.8175140450015, 11), (-526.8175128027198, 5))
WARM_START_ANALYSIS = {
    "<r^-1>": 69.72544037853449, "<r^1>": 16.070845190816918, "<r^2>": 26.034389718227082,
    "<r^3>": 55.98790430873708, "density_at_nucleus": 3839.781829685074,
    "density_gradient_at_nucleus": -138232.14586464988, "cusp": 0.9999999999709708,
    "dipole_z": -0.0, "quadrupole_zz": 1.2150458417181653e-10,
    "virial_ratio": 0.9999999998592946}
# the DIIS B solve's repair, held at phase 20's first threshold: N2 PBE in
# Ez = +0.001 at convthr 1e-8, and helfem_tpu's DIIS errors per iteration
# (`python -m helfem_tpu.cli.diatomic --Z1 N --Z2 N --Rbond 2.0743 --lmax
# 6,6 --nelem 5 --nnodes 8 --Rmax 25 --method PBE --convthr 1e-8 --Ez 0.001
# --save ""`)
DIIS_CELL = ("diatomic", F_N2_PBE + ["--convthr", "1e-8", "--Ez", "0.001"], -108.97871612726448,
             12)
DIIS_TRACE_REF = (0.4494, 0.3812, 0.05439, 0.04061, 0.0801, 0.001937, 0.0005586, 0.0002955,
                  2.347e-05, 1.366e-06, 9.903e-08, 3.493e-09)
# phase 22: persistence and the programs. The helfem_tpu values below come
# from its CLIs on the CPU in f64 at the same arguments, in one working
# directory: `python -m helfem_tpu.cli.atomic <AR_CLI> --save ar.npz`, then
# `<AR_CLI> --load ar.npz --save ""` and the same with `--nelem 12`;
# `python -m helfem_tpu.cli.diatomic <N2_CLI> --save n2.npz`, then
# `<N2_CLI> --load n2.npz`; on that n2.npz `python -m helfem_tpu.cli.
# diatomic_dline --load n2.npz --npts 101`, `diatomic_dgrid --load n2.npz
# --nz 60 --nrho 30` and `diatomic_cpl --load n2.npz --nexp 7
# --completeness 1`; the hook's iterations from helfem_tpu's scf_atom(...,
# guess="TF", convthr=1e-9, save_cb=...) at the Ar bench basis
AR_HOOK_ITS = [1, 2, 6, 10]  # two host iterations, then the chunks' reported ones
AR_FINE_CLI = [a if a != "10" else "12" for a in AR_CLI]  # nelem 12: the cross-basis start
PERSIST_WARM = {  # label -> (helfem_tpu's energy, its iterations)
    "Ar HF warm, same basis": (-526.8175128027068, 2),
    "Ar HF warm, nelem 12": (-526.8175128026938, 2),
    "N2 PBE warm, same basis": (-108.97870843727705, 2),
}
PERSIST_GATE = 1e-9
# helfem_tpu's output on its own n2.npz: dline's n at rows 25, 50 and 67
# (the maximum), dgrid's sum of n and its rows 915 and 1234, and diatomic_cpl's
# (Y, I_a) at exponent rows 1 and 3 of two files
DLINE_PINS = {25: 0.8401944253118356, 50: 0.7203559362922043, 67: 136.7733295154452}
DGRID_PINS = {"sum": 1461.7597467234013, 915: 0.19808566006099693, 1234: 2.5712751571459598}
CPL_PINS = {"cpl_gto_m0_l0_left.dat": {1: (0.9999407031388204, 0.28913607246079065),
                                       3: (0.9782333150065775, 0.7757863611715836)},
            "cpl_gto_m1_l1_mid.dat": {1: (0.9997097170300667, 0.06390522217946377),
                                      3: (0.781057676189357, 0.0008088841994267884)}}
PROGRAM_TOL = 1e-8  # relative: a card checkpoint differs in its last bits from a CPU one
# the one-electron programs and gensap Kr --completeness through helfem_tpu's
# CLIs at the same arguments: `python -m helfem_tpu.cli.atomic_1e --Z 1
# --nelem 6 --nnodes 15 --lmax 2 --save h1e.npz`, `diatomic_1e --Z1 H --Z2 H
# --Rbond 2`, `harmonic`, `softcoulomb` (their defaults), `diatomic_cbasis
# --Z1 N --Z2 N --Rbond 2.0743 --thresh 5` and `gensap <KR_GENSAP_CLI>
# --completeness`
ONE_E = {
    "atomic_1e": (["--Z", "1", "--nelem", "6", "--nnodes", "15", "--lmax", "2", "--save",
                   "h1e.npz"], [-0.5000000000003149, -0.12499999999949149, -0.05555423472918148,
                                -0.12499999999977475, -0.05555476995386505]),
    "diatomic_1e": (["--Z1", "H", "--Z2", "H", "--Rbond", "2"],
                    [-1.1026342143043504, -0.6675343902989366, -0.36086483827891036,
                     -0.2554131394914318, -0.23577761941836342, -0.17768097581882716,
                     -0.13731242664168763, -0.13079168065856195]),
    "harmonic": ([], [0.4999999999999716, 1.4999999999999698, 2.5000000000000613,
                      3.5000000000000493, 4.5000000000031255, 5.500000000003088,
                      6.500000000047753, 7.500000000102192, 8.500000000389502,
                      9.500000001349965]),
    "softcoulomb": ([], [-0.6697771351208427, -0.2748913486686634, -0.15145466475683228,
                         -0.09267932430299994, -0.06352651172491583, -0.045471316168964646,
                         -0.034299143301493376, -0.024918167018710448]),
}
ONE_E_TOL = 1e-10  # relative; the hydrogenic 1s, 2s and 2p within 1e-10 Eh too
CBASIS_CLI = ["--Z1", "N", "--Z2", "N", "--Rbond", "2.0743", "--thresh", "5"]
CBASIS_REF = [(0.1, (7, 5)), (0.01, (9, 7)), (0.001, (11, 7)), (0.0001, (11, 9)),
              (1e-05, (13, 9))]
# gensap Kr's profiles at exponent rows 250 and 400 (l = 0, 1, 2): the
# completeness is the basis's alone; the importance reads the SCF's
# orbitals (convthr 1e-7), held to 1e-6 relative
KR_COMPLETENESS = {"completeness_GTO_Kr.dat": {400: (0.029589368377933533, 0.04652551777084762,
                                                     0.061464706815894686)},
                   "importance_STO_Kr.dat": {250: (0.05338539982370654,
                                                   0.00027034526510405396)}}
KR_IMPORTANCE_TOL = 1e-6
PROBES = {  # name -> (source, {precision: replaces})
    "matmul_f32": ("helfem_tpu_torch/csrc/matmul_probe.cu",
                   {"full": "scripts/pallas_f64_ablation.py:50",
                    "reduced": "scripts/perf_campaign.py:101"}),
    "matmul_dd": ("helfem_tpu_torch/csrc/matmul_probe.cu",
                  {"full": "scripts/pallas_f64_ablation.py:82",
                   "reduced": "scripts/perf_campaign.py:130"}),
}


def sass_check(build) -> str:
    """cuobjdump's SASS of the built library, instance by instance: the
    atomic radial kernels (K1, K2, K10), the diatomic exchange in-element
    kernel and the two XC kernels must issue DMMA (FP64 tensor-core)
    instructions; every
    "reduced" probe kernel HGMMA (wgmma) with TF32 operands; every "full"
    probe kernel FFMA and no HMMA or HGMMA, since a "full" kernel gone to
    TF32 would pass the 1e-5 gate at small K and be another function."""
    from pathlib import Path

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(build.LIBRARY)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, bad = {}, []
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        lines = section.splitlines()

        def n_op(op, also=""):
            return sum(op in line and also in line for line in lines)

        if INELEM in name or any(k in name for k in (*XC_SASS, *RADIAL_SASS, K10_SASS)):
            counts[name] = {"DMMA": n_op("DMMA")}
            bad += [name] if not counts[name]["DMMA"] else []
        elif PROBE_TF32 in name:
            counts[name] = {"HGMMA": n_op("HGMMA"), "HGMMA TF32": n_op("HGMMA", "TF32")}
            bad += [name] if not counts[name]["HGMMA TF32"] else []
        elif PROBE_FULL in name:
            counts[name] = {"FFMA": n_op("FFMA"), "HMMA": n_op("HMMA"), "HGMMA": n_op("HGMMA")}
            c = counts[name]
            bad += [name] if not c["FFMA"] or c["HMMA"] or c["HGMMA"] else []
    missing = [k for k in (INELEM, *XC_SASS, *RADIAL_SASS, K10_SASS, PROBE_TF32, PROBE_FULL)
               if not any(k in n for n in counts)]
    if bad or missing:
        raise RuntimeError(f"SASS check failed for {bad or missing}: {counts}")
    return "SASS instructions per instance:\n" + "\n".join(f"  {k}: {v}"
                                                         for k, v in counts.items())


def radial_spills(log: str) -> str:
    """The spill bytes (stores + loads) ptxas reports for each instance of
    the atomic radial kernels (K1, K2, K10) and of K3; raises if one spills
    or a kernel is missing from the log."""
    lines = log.splitlines()
    spills = {}
    for line, props in zip(lines, lines[1:]):
        if "Function properties" in line and any(k in line for k in NO_SPILLS):
            spills[line.split()[-1]] = sum(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                                       props))
    if any(not any(k in n for n in spills) for k in NO_SPILLS) or any(spills.values()):
        raise RuntimeError(f"the radial kernels spill or are missing: {spills}")
    return f"radial kernels' spill bytes: {spills}"


PHASE_START = [time.perf_counter(), None]  # the script's start, the phase's


def phase_wall() -> None:
    """Print the current phase's wall and the script's so far."""
    now = time.perf_counter()
    if PHASE_START[1] is not None:
        print(f"(the phase took {now - PHASE_START[1]:.1f} s; {now - PHASE_START[0]:.1f} s in all)")
    PHASE_START[1] = now


def phase(title: str) -> None:
    """Print a phase's title, after the previous phase's wall."""
    phase_wall()
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


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
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


def atomic_kernel_work(tei, U, V, Lfac, gidx, Paux, Pd) -> dict:
    """Per atomic kernel (its inputs, the bytes it must move, the operations
    it does) for operators tei, U = disjL, V = disjm1L, Lfac, gidx and the
    densities Paux (Coulomb) and Pd (exchange). The bytes count each input
    entry the function needs once (of a matrix read through gidx, the
    entries its element windows cover) and each output once."""
    NL = tei.shape[0]
    NM, nrad = Paux.shape[1:3]
    nang = Pd.shape[0]
    nelem, npr = gidx.shape
    # exchange: in-element np^4 contraction per element, two np^3 products per
    # element pair, per (L, channel); Coulomb: np^4 per element plus traces
    xflops = NL * nang * (2 * nelem * npr**4 + 4 * npr**3 * nelem * (nelem - 1))
    cflops = NL * NM * nelem * (2 * npr**4 + 8 * npr**2)
    return {
        "radial_exchange": ((tei, U, V, gidx, Pd),
                            nbytes(tei, U, V, gidx, Pd) + 8 * NL * nang * nrad * nrad, xflops),
        "radial_coulomb": ((Paux, tei, U, V, Lfac, gidx),
                           8 * NL * NM * window_entries(gidx, nrad)
                           + nbytes(tei, U, V, Lfac, gidx) + nbytes(Paux), cflops),
    }


def kernel_inputs(cfg: dict, dev, seed: int = 7):
    """Operators of an atomic bench basis, and atomic_kernel_work for a
    random symmetric channel-block-diagonal density."""
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
    return atomic_kernel_work(ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, ops.gidx, Paux, Pd)


def sad_kernel_inputs(basis, ops, seed: int = 53) -> dict:
    """atomic_kernel_work of the spherically averaged atom's two calls for a
    random positive semidefinite m-averaged cube Pang [nl, nrad, nrad]: K1
    on every (L, channel) of the full tables (sad_exchange), K2 on the L=0
    tables with the L=0 helper of Pang's sum (sad_coulomb)."""
    X = np.random.default_rng(seed).standard_normal((basis.lmax + 1, basis.nrad, 4))
    Pang = torch.tensor(np.einsum("lik,ljk->lij", X, X), device=ops.device)
    at, at0 = ops.at, ops.at0
    Paux = (at0.G[0, 0, 0, 0] * Pang.sum(0))[None, None].contiguous()
    x = atomic_kernel_work(at.tei, at.disjL, at.disjm1L, at.Lfac, at.gidx, Paux, Pang)
    c = atomic_kernel_work(at0.tei, at0.disjL, at0.disjm1L, at0.Lfac, at0.gidx, Paux, Pang)
    return {"radial_exchange": x["radial_exchange"], "radial_coulomb": c["radial_coulomb"]}


def erfc_unique_entries(tei) -> int:
    """The entries of the erfc tables tei [NL, nelem, nelem, np^4] that
    their symmetries (i <-> j, k <-> l, the pair swap) leave unique: e <= f,
    i <= j, k <= l and (ij) <= (kl) on e = f."""
    NL, nelem, npr = tei.shape[0], tei.shape[1], tei.shape[3]
    npk = npr * (npr + 1) // 2
    return NL * (nelem * (nelem - 1) // 2 * npk**2 + nelem * npk * (npk + 1) // 2)


def erfc_exchange_work(tei, gidx, Pd, dense: bool = False) -> dict:
    """K10's (inputs, bytes it must move, operations) for the erfc tables tei
    [NL, nelem, nelem, np^4], gidx and the stacked channels Pd [nch, nrad,
    nrad]: it reads each unique entry of the table once (erfc_unique_entries;
    dense: every entry, the count before the table was packed) and Pd once
    (every entry of Pd lies in some element pair's window) and writes KK
    [NL, nch, nrad, nrad]; 2 np^4 flops per slice and channel."""
    NL, nelem = tei.shape[:2]
    npr = gidx.shape[1]
    nch, nrad = Pd.shape[:2]
    table = nbytes(tei) if dense else 8 * erfc_unique_entries(tei)
    return {"radial_erfc_exchange": ((tei, gidx, Pd), table + nbytes(gidx, Pd)
                                     + 8 * NL * nch * nrad * nrad,
                                     2 * NL * nch * nelem * nelem * npr**4)}


def erfc_details(label: str, args, r: dict) -> dict:
    """Beside K10's comparison r at one shape: the bound on the dense table,
    the packed table's bytes against the bytes the kernel's bulk copies
    request (within 10 %: each slab is read once; raises otherwise), the
    pack's setup wall on the card (the symmetry check and the pack), the
    call time when L2 is cold, and torch.matmul of the contraction alone
    on pre-gathered windows ([NL nelem^2, np^2, np^2] @ [., np^2, nch]: no
    gather, no assembly), a yardstick of what cuBLAS streams from the
    dense table; printed and returned."""
    import importlib

    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.tools.erfc_timing import cold_ms

    mod = importlib.import_module("helfem_tpu_torch.kernels.radial_erfc_exchange")
    tei, gidx, Pd = args
    dense = erfc_exchange_work(tei, gidx, Pd, dense=True)["radial_erfc_exchange"][1]
    dense_ms = 1e3 * max(dense / HBM_BYTES_S, r["flops"] / FP64_FLOP_S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.check_symmetric("radial_erfc_exchange", tei)
    packed = 8 * mod.pack_erfc_table(tei).numel()
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    issued = mod.issued_bytes(tei, gidx, Pd)
    if abs(issued - packed) > 0.1 * packed:
        raise RuntimeError(f"radial_erfc_exchange: {label}: the bulk copies requested {issued} "
                           f"bytes of a {packed}-byte packed table")
    cold = cold_ms(lambda: kernels.radial_erfc_exchange(*args), 20)
    NL, nelem, npr = tei.shape[0], tei.shape[1], tei.shape[3]
    A = tei.reshape(NL * nelem * nelem, npr * npr, npr * npr)
    B = torch.randn((A.shape[0], npr * npr, Pd.shape[0]), dtype=torch.float64, device=tei.device)
    mm = cuda_ms(lambda: torch.matmul(A, B))
    d = {"dense_bound_ms": dense_ms, "packed_bytes": packed, "issued_bytes": issued,
         "pack_s": pack_s, "cold_ms": cold, "matmul_yardstick_ms": mm}
    print(f"{label} K10: packed table {packed} B ({packed / nbytes(tei):.3f} of the dense "
          f"{nbytes(tei)} B), bulk copies {issued} B; bound {r['bound_ms']:.5f} ms on the unique "
          f"entries, {dense_ms:.5f} ms on the dense table ({100 * r['bound_ms'] / r['ms']:.1f} "
          f"and {100 * dense_ms / r['ms']:.1f} % of the call); pack {pack_s:.4f} s; L2 cold "
          f"{cold:.4f} ms; torch.matmul of the contraction alone {mm:.4f} ms")
    return d


def random_channels(n: int, nrad: int, dev, seed: int) -> torch.Tensor:
    X = np.random.default_rng(seed).standard_normal((n, nrad, nrad))
    return torch.tensor(X + X.transpose(0, 2, 1), device=dev)


def erfc_inputs(shape: str, dev, ns: int, seed: int = 101, rs=None):
    """erfc_exchange_work at an atomic bench basis (SHAPES) for ns spins'
    random symmetric channels, on its erfc tables at RS_OMEGA (built here
    unless given); returns (work, tables)."""
    from helfem_tpu_torch.models.atomic import AtomicBasis

    basis = AtomicBasis(**SHAPES[shape])
    rs = rs or basis.build_erfc(RS_OMEGA, dev)
    gidx = torch.tensor(basis.rb.fem.gidx, dtype=torch.int32, device=dev)
    Pd = random_channels(ns * basis.nang, basis.nrad, dev, seed)
    return erfc_exchange_work(rs.tei, gidx, Pd), rs


def yukawa_inputs(lam: float, dev, seed: int = 103) -> tuple:
    """K1's (inputs, bytes, operations) on the Yukawa tables of the Ar bench
    basis at lam (counted as atomic_kernel_work counts K1's)."""
    from helfem_tpu_torch.models.atomic import AtomicBasis

    basis = AtomicBasis(**SHAPES["ar"])
    rs = basis.build_yukawa(lam, dev)
    gidx = torch.tensor(basis.rb.fem.gidx, dtype=torch.int32, device=dev)
    Pd = random_channels(basis.nang, basis.nrad, dev, seed)
    Paux = torch.zeros((rs.tei.shape[0], 1, basis.nrad, basis.nrad), dtype=torch.float64,
                       device=dev)
    return atomic_kernel_work(rs.tei, rs.iL, rs.kL, rs.Lfac, gidx, Paux, Pd)["radial_exchange"]


def random_atomic_inputs(dev, NL: int, NM: int, nang: int, nelem: int, nnodes: int,
                         primbas: int = 4, seed: int = 19):
    """atomic_kernel_work on random tables: the element layout (gidx) of an
    FEMBasis of nelem elements of primbas's polynomials on nnodes nodes
    (4 LIP; 5-11 Hermite, whose neighbours share nder + 1 slots), random
    tei, disjL, disjm1L and symmetric densities Paux [NL, NM] and Pd [nang].
    The kernels compute their functions for any tables."""
    from helfem_tpu_torch.ops.fem import FEMBasis
    from helfem_tpu_torch.ops.polynomials import get_basis

    fem = FEMBasis(get_basis(primbas, nnodes), np.linspace(0.0, 10.0, nelem + 1))
    npr, nrad = fem.nprim, fem.nbf
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.tensor(rng.standard_normal(shape), device=dev)

    def symmetric(*lead):
        X = normal(*lead, nrad, nrad)
        return (X + X.transpose(-1, -2)).contiguous()

    tei = normal(NL, nelem, npr, npr, npr, npr)
    U, V = normal(NL, nelem, npr, npr), normal(NL, nelem, npr, npr)
    Lfac = 4.0 * np.pi / (2.0 * torch.arange(NL, dtype=torch.float64, device=dev) + 1.0)
    gidx = torch.tensor(fem.gidx, dtype=torch.int32, device=dev)
    return atomic_kernel_work(tei, U, V, Lfac, gidx, symmetric(NL, NM), symmetric(nang))


def xc_work(g, P, pots, mask, nrad: int, tau: bool = False, lapl: bool = False) -> dict:
    """Per XC kernel (its inputs, the bytes it must move, the operations it
    does) on the grid g for the densities P [ns, nbf, nbf] (K4) and the
    weighted grid potentials pots = (wvr, wgu, wgv[, wvt[, wvl]]) with the
    shell mask (None: no mask) (K5), in tau mode when tau, in laplacian mode
    when lapl: per spin, K4 reads the windows of the live ordered shell
    pairs (the only ones it needs) and writes three fields (four in tau
    mode, five in laplacian mode), K5 reads the element functions Bg and
    dBg (not the product tables the kernel streams, which are built from
    them) and writes the dense F; tau mode also reads the pair rows of dTT2
    and TTm2 and the tau factors, and K5 wvt; laplacian mode also d2Bg, the
    pair rows of LLTT and TTmm and the laplacian factors, and K5 wvl; the
    operations are the folded ones the kernels do (one window or element
    block per unordered live pair)."""
    tau = tau or lapl
    wvr, wgu, wgv = pots[:3]
    ns, nbf = P.shape[:2]
    nelem, nq, npr = g.Bg.shape
    nt, npl = g.sqeta.shape[0], g.pairs.shape[0]
    ordered = 2 * npl - int((g.pairs[:, 0] == g.pairs[:, 1]).sum())
    win = window_entries(g.gidx, nrad)
    pair_rows = nbytes(g.pairs, g.TTp, g.dTTp) + (nbytes(g.dTT2p, g.TTm2p, g.tfac) if tau else 0)
    if lapl:
        pair_rows += nbytes(g.LLTTp, g.TTmmp, g.lfac, g.d2Bg)
    k4_bytes = (8 * ns * ordered * win + pair_rows + nbytes(g.gidx, g.Bg, g.dBg, g.invh, g.sqeta)
                + (5 if lapl else 4 if tau else 3) * nbytes(wvr))
    masks = () if mask is None else (mask,)
    k5_bytes = (nbytes(*pots, *masks, g.owners, g.band, g.ijs, g.Bg, g.dBg)
                + pair_rows + 8 * ns * nbf ** 2)
    nij = npr * (npr + 1) // 2
    if lapl:
        k4_ops = 4 * npr * npr + 8 * npr + 18 * nt
        k5_ops, k5_args = 18 * nt + 8 * nij, (wvr, wgu, wgv, g, mask, pots[3], pots[4])
        k4_args = (P, g, True, True)
    elif tau:
        k4_ops = 4 * npr * npr + 6 * npr + 12 * nt
        k5_ops, k5_args = 12 * nt + 6 * nij, (wvr, wgu, wgv, g, mask, pots[3])
        k4_args = (P, g, True)
    else:
        k4_ops = 2 * npr * npr + 4 * npr + 6 * nt
        k5_ops, k5_args = 6 * nt + 4 * nij, (wvr, wgu, wgv, g, *masks)
        k4_args = (P, g)
    return {
        "dia_xc_fields": (k4_args, k4_bytes, ns * npl * nelem * nq * k4_ops),
        "dia_xc_fock": (k5_args, k5_bytes, ns * npl * nelem * nq * k5_ops),
    }


def random_potentials(g, ns: int, rng, tau: bool = False, lapl: bool = False):
    """Random weighted grid potentials (wvr, wgu, wgv[, wvt[, wvl]]) [ns,
    nelem, nq, nt] for the XC Fock kernel on the grid g."""
    shape = (ns, *g.w.shape)
    return tuple(torch.tensor(rng.standard_normal(shape), device=g.w.device)
                 for _ in range(5 if lapl else 4 if tau else 3))


def xc_kernel_inputs(basis, dev, ns: int = 2, seed: int = 11, tau: bool = False,
                     lapl: bool = False):
    """xc_work at a diatomic basis: ns random symmetric
    symmetry-block-diagonal densities for K4, random grid potentials and
    the basis's shell mask for K5 (with lapl on a grid with the laplacian
    tables)."""
    from helfem_tpu_torch.models.diatomic_dft import build_dia_grid

    g = build_dia_grid(basis, dev, lapl=lapl)
    rng = np.random.default_rng(seed)
    P = np.zeros((ns, basis.nbf, basis.nbf))
    for s in range(ns):
        for idx in basis.sym_blocks():
            X = rng.standard_normal((len(idx), len(idx)))
            P[s][np.ix_(idx, idx)] = X + X.T
    P = torch.tensor(P, device=dev)
    pots = random_potentials(g, ns, rng, tau, lapl)
    mask = torch.tensor(basis.shell_mask().reshape(-1), device=dev)
    return xc_work(g, P, pots, mask, basis.nrad, tau, lapl)


def atomic_xc_inputs(shape: str, dev, ns: int = 2, seed: int = 59, tau: bool = False,
                     lapl: bool = False):
    """xc_work on an atomic grid: the atomic grid of SHAPES[shape] (Ar or
    Xe bench basis) or FIELD_SHAPES[shape] with random symmetric densities dense over the same-m
    shell pairs (every live pair carries data), or the SAD grid of
    SAD_SHAPES[shape] or, for "sad_cr", of CR_SHAPE (one shell, one angular
    point; with tau its two-shell meta-GGA form, sadatom.sad_tau_grid) with
    random symmetric radial densities; random grid potentials, no mask.
    lapl (atomic grids only): the grid with its laplacian tables."""
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.atomic_dft import build_atomic_grid

    rng = np.random.default_rng(seed)
    sad = {**SAD_SHAPES, "sad_cr": CR_SHAPE, **CONTROL_SAD_SHAPES}
    if shape in sad:
        basis = sadatom.SadAtomBasis(**sad[shape])
        ops = basis.build_ops(dev)
        g = ops.tgrid if tau else ops.grid
        mval = np.zeros(g.TT.shape[0], dtype=int)
        same_m = np.eye(len(mval), dtype=bool)  # the shells' block-diagonal density
    else:
        basis = AtomicBasis(**{**SHAPES, **FIELD_SHAPES}[shape])
        g = build_atomic_grid(basis, dev, lapl=lapl)
        mval = basis.mval
        same_m = mval[:, None] == mval[None, :]
    nang, nrad = len(mval), basis.nrad
    same_m = same_m[:, None, :, None]
    P = np.zeros((ns, nang, nrad, nang, nrad))
    for s in range(ns):
        X = rng.standard_normal((nang, nrad, nang, nrad))
        P[s] = (X + X.transpose(2, 3, 0, 1)) * same_m
    P = torch.tensor(P.reshape(ns, nang * nrad, nang * nrad), device=dev)
    return xc_work(g, P, random_potentials(g, ns, rng, tau, lapl), None, nrad, tau, lapl)


def block_density(basis, dev, seed: int, parity: bool = True) -> torch.Tensor:
    """A random symmetric symmetry-block-diagonal density of a diatomic
    basis (numpy seed); parity False: over the merged g/u blocks."""
    rng = np.random.default_rng(seed)
    P = np.zeros((basis.nbf, basis.nbf))
    for idx in basis.sym_blocks(parity):
        X = rng.standard_normal((len(idx), len(idx)))
        P[np.ix_(idx, idx)] = X + X.T
    return torch.tensor(P, device=dev)


def coulomb_dia_inputs(basis, ops, P: torch.Tensor, njbd: int | None):
    """K3's inputs (its arguments, bytes, operations) for density P, as
    coulomb_dia(ops, P, njbd) forms them (njbd None: every signed channel).
    The bytes count the windows of Paux0 and Paux2 (the entries their
    element windows cover), ilm, gidx and each table row read once, and the
    outputs Jr0, Jr2."""
    from helfem_tpu_torch.models.diatomic import _to4

    sl = slice(None) if njbd is None else slice(0, njbd)
    nrad = basis.nrad
    P4 = _to4(P, basis.nang, nrad)
    Paux0 = torch.einsum("sab,abIJ->sIJ", ops.GmLM[sl], P4).contiguous()
    Paux2 = torch.einsum("sab,abIJ->sIJ", ops.GpLM[sl], P4).contiguous()
    ilm = ops.LM_ilm[sl]
    S = ilm.shape[0]
    nelem, npr = ops.gidx.shape
    # the rows of the channel tables this call reads, and the entries of an
    # [nrad, nrad] block that the element windows cover
    rows = len(set(ilm.tolist()))
    win = window_entries(ops.gidx, nrad)
    np2 = npr * npr
    moved = (8 * 2 * S * win + nbytes(Paux0, Paux2) + nbytes(ilm, ops.gidx)
             + 8 * rows * (3 * nelem * np2 * np2 + 4 * nelem * np2 + 1))
    args = (Paux0, Paux2, ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.LMfac, ilm,
            ops.gidx)
    return args, moved, S * nelem * (8 * np2 * np2 + 16 * np2)


def dia_kernel_inputs(cfg: dict, dev, seed: int = 11, ns: int = 2):
    """Operators and grid of a diatomic basis, and per kernel (its inputs,
    bytes, operations) for a random symmetric symmetry-block-diagonal
    density (the Coulomb kernel, at the SCF's njbd channels), and
    xc_kernel_inputs's inputs for the XC kernels at ns spins; bytes counted
    as kernel_inputs counts them."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    basis = DiatomicBasis(**cfg)
    ops = basis.build_operators(dev)
    P = block_density(basis, dev, seed)
    return {
        "radial_coulomb_dia": coulomb_dia_inputs(basis, ops, P, basis.njbd),
        **xc_kernel_inputs(basis, dev, ns, seed + 1),
    }


def exchange_work(S, kdepth, nang, nelem, npr, nrad, gidx):
    """(K6 flop, K7 flop, table bytes, K4 bytes, window entries of one [nrad,
    nrad] block of R that K7 needs) of one exchange call over S channels
    whose rank factors hold kdepth = sum over channels of (live t slots x
    no) columns in all: the in-element term on the b <= c shell pairs, the
    cross term on every pair and the (e > f) element pairs."""
    np2, npair, epairs = npr * npr, nang * (nang + 1) // 2, nelem * (nelem - 1) // 2
    tei = S * nelem * npair * 4 * 2 * np2 * np2
    k6 = (tei + kdepth * nelem * npair * 4 * 2 * np2  # window rank products
          + 2 * kdepth * 2 * nelem * nang * 2 * np2  # ud and vd
          + epairs * (nang * npr) ** 2 * 2 * kdepth)  # X = ud^T vd
    k7 = tei + S * nang * nang * epairs * 4 * 4 * npr**3
    tables = 8 * S * (3 * nelem * np2 * np2 + 4 * nelem * np2)
    return k6, k7, tables, 8 * nang * nang * nrad * nrad, \
        window_entries(gidx, nrad) + epairs * np2


def dense_R(Uw, V):
    """The dense R families [S, 4, nang, nang, nrad, nrad] of rank factors
    (for the random tables, which have no Gaunt tables to transform a P)."""
    sign = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=Uw.dtype, device=Uw.device)
    R = torch.einsum("qr,sqtbno,srtcmo->sqrbcnm", sign, Uw[:, :, :, :, :-1], V[:, :, :, :, :-1])
    return R.reshape(R.shape[0], 4, *R.shape[3:]).contiguous()


def exchange_inputs(basis, ops, Co: torch.Tensor, dense: bool = True) -> dict:
    """The exchange kernels' inputs at a diatomic basis for the occupied
    columns Co [nbf, no] (K6) and, when `dense`, the dense R of the same
    density (K7), with bytes and operations counted as kernel_inputs counts
    them."""
    from helfem_tpu_torch.models.diatomic import exchange_factors, exchange_weights

    nang, nrad = basis.nang, basis.nrad
    nelem, npr = ops.gidx.shape
    Uw, V = exchange_factors(ops, Co)
    S = Uw.shape[0]
    kdepth = Co.shape[1] * int((1 + ops.step_wm).sum())
    k6f, k7f, tables, out, win = exchange_work(S, kdepth, nang, nelem, npr, nrad, ops.gidx)
    small = nbytes(ops.step_ilm, ops.gidx)
    tabs = (ops.teiJ3, ops.dP0, ops.dP2, ops.dQ0, ops.dQ2, ops.step_ilm, ops.gidx)
    inputs = {"radial_exchange_dia_occ": ((Uw, V, *tabs),
                                          nbytes(Uw, V) + tables + small + out, k6f)}
    if dense:
        inputs["radial_exchange_dia"] = ((exchange_weights(ops, Co @ Co.T), *tabs),
                                         8 * S * 4 * nang * nang * win + tables + small + out,
                                         k7f)
    return inputs


def dia_exchange_inputs(cfg: dict, dev, no: int = 7, seed: int = 13):
    """exchange_inputs at a diatomic basis for `no` random occupied
    columns."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    basis = DiatomicBasis(**cfg)
    ops = basis.build_operators(dev)
    Co = torch.tensor(np.random.default_rng(seed).standard_normal((basis.nbf, no)), device=dev)
    return exchange_inputs(basis, ops, Co)


def random_exchange_inputs(dev, nang: int, nprim: int, nelem: int, nlm: int, no: int,
                           dense_channels: int, seed: int = 17):
    """The exchange kernels' inputs at the given sizes on random tables with
    the symmetries of the real ones: the TEI blocks under i<->j, k<->l and,
    for families (0,0) and (2,2), (ij)<->(kl); symmetric moment blocks, the
    P moments growing and the Q moments falling by two orders per element;
    V = U and Uw = w U, one channel per table row. The dense kernel gets the
    first `dense_channels` channels."""
    npr = nprim
    nrad = nelem * (npr - 1)
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.tensor(rng.standard_normal(shape), device=dev)

    T = normal(nlm, 3, nelem, npr, npr, npr, npr)
    T = T + T.transpose(3, 4)
    T = T + T.transpose(5, 6)
    T[:, 0] = T[:, 0] + T[:, 0].permute(0, 1, 4, 5, 2, 3)
    T[:, 2] = T[:, 2] + T[:, 2].permute(0, 1, 4, 5, 2, 3)
    teiJ3 = T.reshape(nlm, 3, nelem, npr * npr, npr * npr)
    del T
    grow = 100.0 ** torch.arange(nelem, dtype=torch.float64, device=dev)[None, :, None, None]

    def moments(scale):
        d = normal(nlm, nelem, npr, npr)
        return ((d + d.transpose(2, 3)) * scale).contiguous()

    dP0, dP2, dQ0, dQ2 = moments(grow), moments(grow), moments(1 / grow), moments(1 / grow)
    gidx = torch.arange(nelem, device=dev)[:, None] * (npr - 1) + torch.arange(npr, device=dev)
    gidx = gidx.to(torch.int32).contiguous()  # last slot of the last element = nrad
    ilm = torch.arange(nlm, dtype=torch.int32, device=dev)
    U = normal(nlm, 2, 2, nang, nrad + 1, no)
    U[:, :, :, :, nrad] = 0.0
    w = torch.tensor(rng.uniform(0.5, 1.5, (nlm, 2)), device=dev)
    Uw = (w[:, None, :, None, None, None] * U).contiguous()
    Sd = dense_channels
    R = dense_R(Uw[:Sd], U[:Sd])
    k6f, _, tables, out, _ = exchange_work(nlm, 2 * no * nlm, nang, nelem, npr, nrad, gidx)
    _, k7f, tables7, _, win = exchange_work(Sd, 2 * no * Sd, nang, nelem, npr, nrad, gidx)
    small = nbytes(ilm, gidx)
    tabs = (teiJ3, dP0, dP2, dQ0, dQ2)
    return {
        "radial_exchange_dia_occ": ((Uw, U, *tabs, ilm, gidx),
                                    nbytes(Uw, U) + tables + small + out, k6f),
        "radial_exchange_dia": ((R, *tabs, ilm[:Sd].contiguous(), gidx),
                                8 * Sd * 4 * nang * nang * win + tables7 + small + out, k7f),
    }


def lmax12_exchange_inputs(dev, seed: int = 17, dense_channels: int = 3):
    """random_exchange_inputs at the N2 lmax=12 shapes (LMAX12); the dense
    kernel gets a batch of the size exchange_dia gives it."""
    return random_exchange_inputs(dev, dense_channels=dense_channels, seed=seed, **LMAX12)


def refine_inputs(nblk: int, n: int, dev, seed: int, seeds: tuple) -> tuple:
    """K11's inputs (A, V0) [nblk, n, n]: A = U diag(w) U^T with U a random
    orthogonal matrix per block and w evenly spread from -50 to 1e3 (the
    span of a whitened Fock block's, kept apart by at least 1050 / n, so
    that eps ||A|| turns no eigenvector by more than about 1e-13 and E and
    V compare entrywise at 1e-12; near-degenerate pairs would make V as
    ill-conditioned in both versions); V0 per group of blocks (len(seeds) groups): "near", U
    rotated by about 1e-6, which the sweeps take below REFINE_GATE;
    "rotated", U with its columns 2m and 2m+1 turned by 0.5 rad in their
    plane, a large step that the clipped sweeps cut by at most 0.1 each, so
    the certificate fails while V stays orthonormal (each plane's diagonal
    stays between its two eigenvalues, so no two planes come near a
    degeneracy whose rotation would amplify rounding); "identity", the SCF's
    first seed, whose sweeps diverge on a dense A (rejected, values not
    comparable)."""
    rng = np.random.default_rng(seed)
    w = -50.0 + 1050.0 * (np.arange(n) + 0.25 * rng.random((nblk, n))) / n
    U, _ = torch.linalg.qr(torch.tensor(rng.standard_normal((nblk, n, n)), device=dev))
    A = (U * torch.tensor(w, device=dev)[:, None, :]) @ U.mT
    A = (0.5 * (A + A.mT)).contiguous()
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    R, _ = torch.linalg.qr(eye + 1e-6 * torch.tensor(rng.standard_normal((nblk, n, n)),
                                                     device=dev))
    G = eye.clone()
    c, s = np.cos(0.5), np.sin(0.5)
    for k in range(0, n - 1, 2):
        j = k + 1
        G[k, k], G[j, j], G[k, j], G[j, k] = c, c, -s, s
    kinds = {"near": lambda: U @ R, "rotated": lambda: U @ G,
             "identity": lambda: eye.expand(nblk, n, n)}
    per = nblk // len(seeds)
    V0 = torch.cat([kinds[kind]()[g * per:(g + 1) * per] for g, kind in enumerate(seeds)])
    return A, V0.contiguous()


def refine_compare(label: str, args, values: bool = True) -> dict:
    """K11 against refine_eig_plain on the same card inputs: the same
    decisions against REFINE_GATE and (values) E and V within REL_TOL x
    max-abs and the residuals within REL_TOL x max|E|; call times in turns,
    device and queued times, the bound (8 n^3 flops per block and sweep:
    2 n^3 each for A V, V C and W P, n^3 each for the symmetric V^T (A V)
    and W^T W, against the FP64 tensor cores' peak; A and V0 read, V, E and
    off written once) and torch.linalg.eigh on the same batch (a yardstick, not
    the same arithmetic)."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.utils.profiling import device_ms, queued_ms

    A, V0, npass, tau, groups = args
    out = kernels.refine_eig(*args)
    torch.cuda.synchronize()
    ref = kernels.refine_eig_plain(*args)
    errs = [float((o - r).abs().max()) for o, r in zip(out[:2], ref[:2])]
    scales = [float(r.abs().max()) for r in ref[:2]]
    off_err = float((out[2] - ref[2]).abs().max())
    good, good_plain = (out[2] < REFINE_GATE).tolist(), (ref[2] < REFINE_GATE).tolist()
    if good != good_plain or values and any(
            not np.isfinite(e) or e > REL_TOL * s
            for e, s in zip(errs + [off_err], scales + [scales[0]])):
        raise RuntimeError(f"{label} refine_eig: kernel disagrees with plain: decisions {good} "
                           f"against {good_plain}, E/V err {errs} (scales {scales}), off err "
                           f"{off_err:.3e}")
    same_bits_twice("refine_eig", args)
    p1 = cuda_ms(lambda: kernels.refine_eig_plain(*args))
    k1 = cuda_ms(lambda: kernels.refine_eig(*args))
    k2 = cuda_ms(lambda: kernels.refine_eig(*args))
    p2 = cuda_ms(lambda: kernels.refine_eig_plain(*args))
    eigh = cuda_ms(lambda: torch.linalg.eigh(A))
    dev_ms = None
    for _ in range(3):  # the profiler now and then returns no kernel time
        dev_ms = device_ms(lambda: kernels.refine_eig(*args)) or None
        if dev_ms:
            break
    B, n = A.shape[0], A.shape[1]
    flops = 8 * (npass + 1) * B * n ** 3
    moved = 8 * (3 * B * n * n + B * n + groups)
    t_bytes, t_ops = moved / HBM_BYTES_S, flops / FP64_FLOP_S
    r = {"max_abs_err": max(errs), "scale": min(scales),
         "rel_err": max(e / s for e, s in zip(errs, scales)), "off_err": off_err,
         "off": ref[2].tolist(), "good": good, "ms": 0.5 * (k1 + k2), "device_ms": dev_ms,
         "queued_ms": queued_ms(lambda: kernels.refine_eig(*args)),
         "plain_ms": 0.5 * (p1 + p2), "bound_ms": 1e3 * max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": moved,
         "flops": flops, "eigh_ms": eigh}
    report(label, "refine_eig", r)
    print(f"    decisions {good}, residuals {[f'{x:.2e}' for x in r['off']]} (gate "
          f"{REFINE_GATE:g}), off err {off_err:.2e}{'' if values else ' (not compared)'}; "
          f"torch.linalg.eigh on the same batch {eigh:.4f} ms (a yardstick, not the same "
          f"arithmetic)")
    return r


def refine_phase(dev, results: dict) -> None:
    """Phase 3b: K11 against its plain version at REFINE_SHAPES from a near
    seed (accepted) and a rotated one (rejected), two spins also from one
    of each, Ar also from the identity (decisions only), into results:
    (refine_eig, shape) from the near seed, (refine_eig, shape_kind)."""
    phase("3b. K11 refine_eig against its plain version at the SCF block shapes")
    for shape, (nblk, n, groups) in REFINE_SHAPES.items():
        kinds = (["near", "rotated"] + (["mixed"] if groups == 2 else [])
                 + (["identity"] if shape == "ar" else []))
        for kind in kinds:
            seeds = ("near", "rotated") if kind == "mixed" else (kind,) * groups
            A, V0 = refine_inputs(nblk, n, dev, 61, seeds)
            key = shape if kind == "near" else f"{shape}_{kind}"
            r = refine_compare(f"{key} ({nblk} x {n}, {groups} groups)",
                               (A, V0, 3, 1e-9, groups), values=kind != "identity")
            want = [s == "near" for s in seeds]
            if r["good"] != want:
                raise RuntimeError(f"{key} refine_eig: decisions {r['good']}, expected {want}")
            results[("refine_eig", key)] = r
        del A, V0
        torch.cuda.empty_cache()


def refine_real_phase(dev, results: dict) -> None:
    """Phase 3b on recorded data: K11 against its plain version on the
    inputs of every warm eigensolve of one Ar HF and one N2 PBE SCF at the
    bench bases (REFINE_REAL; the whitened blocks with their padded slots
    at eigenvalue 1e6, recorded by utils/profiling.py:capture_warm). Every
    call: the same decisions against the SCF's own gate. Every call after
    the first (whose identity seed diverges, as in refine_phase): E and the
    residuals within REL_TOL x the largest |eigenvalue| of the unpadded
    slots, the scale of their rounding; V as good an eigenbasis as the
    plain version's (REFINE_V_SLACK), its entrywise difference printed.
    Into results: (refine_eig, cell)."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.scf.common import warm_gate
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.tools.warm_floor import unpadded_scale
    from helfem_tpu_torch.utils.profiling import capture_warm

    for cell, (kind, cfg, nel, kw) in REFINE_REAL.items():
        basis = (AtomicBasis if kind == "atomic" else DiatomicBasis)(**cfg)
        ops = basis.build_operators(dev)
        with capture_warm(keep_inputs=True) as calls:
            res = (scf_atom if kind == "atomic" else scf_diatomic)(basis, *nel, ops=ops, **kw)
        gate = warm_gate(kw["convthr"])
        worst = {"max_abs_err": 0.0, "rel_err": 0.0, "off_err": 0.0, "v_err": 0.0,
                 "good": [], "off": []}
        for i, call in enumerate(calls):
            A, V0, npass, tau, groups = args = call["args"]
            out = kernels.refine_eig(*args)
            ref = kernels.refine_eig_plain(*args)
            good, good_plain = (out[2] < gate).tolist(), (ref[2] < gate).tolist()
            worst["good"].append(good)
            worst["off"].append(ref[2].tolist())
            if good != good_plain:
                raise RuntimeError(f"{cell} step {i} refine_eig: decisions {good} against the "
                                   f"plain version's {good_plain} (residuals {out[2].tolist()} "
                                   f"and {ref[2].tolist()}, gate {gate:g})")
            if i == 0:
                continue
            scale = unpadded_scale(ref[0])
            e_err = float((out[0] - ref[0]).abs().max())
            off_err = float((out[2] - ref[2]).abs().max())
            v_err = float((out[1] - ref[1]).abs().max())
            quality = [eigenbasis_defects(A, V) for V in (out[1], ref[1])]
            v_ok = all(k <= REFINE_V_SLACK * max(p, EPS * A.shape[-1] * sc)
                       for k, p, sc in zip(quality[0], quality[1], (1.0, scale)))
            print(f"    {cell} step {i}: decisions {good}, residuals K11 "
                  f"{[f'{x:.3e}' for x in out[2].tolist()]} plain "
                  f"{[f'{x:.3e}' for x in ref[2].tolist()]} (gate {gate:g}, scale {scale:.4e}); "
                  f"E err {e_err:.2e}, off err {off_err:.2e}, V err {v_err:.2e}; |V^T V - I| "
                  f"and the off-diagonal of V^T A V, K11 {[f'{x:.2e}' for x in quality[0]]}, "
                  f"plain {[f'{x:.2e}' for x in quality[1]]}")
            if not (e_err <= REL_TOL * scale and off_err <= REL_TOL * scale and v_ok):
                raise RuntimeError(f"{cell} step {i} refine_eig: kernel disagrees with plain "
                                   f"on recorded data: E err {e_err:.3e}, off err {off_err:.3e} "
                                   f"(scale {scale:.4e}), eigenbasis defects {quality}")
            worst["max_abs_err"] = max(worst["max_abs_err"], e_err)
            worst["rel_err"] = max(worst["rel_err"], e_err / scale)
            worst["off_err"] = max(worst["off_err"], off_err)
            worst["v_err"] = max(worst["v_err"], v_err)
        print(f"{cell} refine_eig on recorded data ({basis.__class__.__name__}, E = {res.E:.12f} "
              f"in {res.niter} iterations, {len(calls)} warm attempts of "
              f"{list(calls[0]['args'][0].shape)}): the same decisions {worst['good']} as the "
              f"plain version; largest E err {worst['max_abs_err']:.2e}, off err "
              f"{worst['off_err']:.2e}, V err {worst['v_err']:.2e}")
        results[("refine_eig", cell)] = worst
        del calls, ops
        torch.cuda.empty_cache()


def eigenbasis_defects(A: torch.Tensor, V: torch.Tensor) -> tuple[float, float]:
    """(max |V^T V - I|, max off-diagonal |V^T A V|) of an eigenbasis V of
    the symmetric A [B, n, n], in plain torch arithmetic."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    M = V.mT @ A @ V
    return (float((V.mT @ V - eye).abs().max()),
            float((M - torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))).abs().max()))


def report(shape: str, name: str, r: dict) -> dict:
    device = "" if "device_ms" not in r else (" (device not measured)" if r["device_ms"] is None
                                              else f" (device {r['device_ms']:.4f})")
    if "queued_ms" in r:
        device += (", queued not measured" if r["queued_ms"] is None
                   else f", queued {r['queued_ms']:.4f} ms")
    rel = f", the largest of each output's err / its max-abs {r['rel_err']:.2e}" \
        if "rel_err" in r else ""
    print(f"{shape} {name}: max-abs err {r['max_abs_err']:.3e} (scale "
          f"{r['scale']:.3e}{rel}), kernel {r['ms']:.4f} ms{device}, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bytes']} B, "
          f"{r['flops']} flop); achieved {r['flops'] / r['ms'] / 1e9:.3f} TFLOP/s")
    return r


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def same_bits_twice(name: str, args) -> None:
    """Two calls of the kernel: one launch each and the same bits."""
    from helfem_tpu_torch import kernels

    kern = getattr(kernels, name)
    before = kernels.launches[name]
    first, second = _outputs(kern(*args)), _outputs(kern(*args))
    torch.cuda.synchronize()
    if kernels.launches[name] != before + 2:
        raise RuntimeError(f"{name}: {kernels.launches[name] - before} launches in two calls")
    if not all(torch.equal(x, y) for x, y in zip(first, second)):
        raise RuntimeError(f"{name}: two calls on the same inputs gave different bits")


def compare(name: str, args, bytes_moved: int, flops: int, warmup: int = 3,
            reps: int = 20, plain=None) -> dict:
    """The kernel against its plain version on the same card inputs: gate
    each output at 1e-12 x its max-abs; CUDA-event times in turns (plain,
    kernel, kernel, plain), the kernel's device time per call from
    torch.profiler (the call time less the host's dispatch) and from CUDA
    events around calls queued behind a sleeping kernel (the launches' own
    gaps included, utils/profiling.py:queued_ms), and the least time the
    card could take. plain: the plain version to hold the kernel to (the
    wrapper's <name>_plain by default)."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.utils.profiling import device_ms, queued_ms

    kern, plain = getattr(kernels, name), plain or getattr(kernels, name + "_plain")
    out = _outputs(kern(*args))
    torch.cuda.synchronize()
    ref = _outputs(plain(*args))
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    scales = [float(r.abs().max()) for r in ref]
    for err, scale in zip(errs, scales):
        if not np.isfinite(err) or err > REL_TOL * scale:
            raise RuntimeError(f"{name}: kernel disagrees with plain: max-abs err "
                               f"{err:.3e} > {REL_TOL:g} x {scale:.3e}")
    p1 = cuda_ms(lambda: plain(*args), warmup, reps)
    k1 = cuda_ms(lambda: kern(*args), warmup, reps)
    k2 = cuda_ms(lambda: kern(*args), warmup, reps)
    p2 = cuda_ms(lambda: plain(*args), warmup, reps)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / FP64_FLOP_S
    # the profiler now and then returns no kernel time at all: ask again,
    # twice, then not measured
    dev_ms = None
    for _ in range(3):
        dev_ms = device_ms(lambda: kern(*args), min(reps, 20)) or None
        if dev_ms:
            break
    rel = max(err / scale if scale else (0.0 if err == 0.0 else float("inf"))
              for err, scale in zip(errs, scales))
    return {"max_abs_err": max(errs), "scale": min(scales), "rel_err": rel,
            "ms": 0.5 * (k1 + k2), "device_ms": dev_ms,
            "queued_ms": queued_ms(lambda: kern(*args), min(reps, 20)),
            "plain_ms": 0.5 * (p1 + p2), "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def library_ms(fn, precision: str) -> float:
    """CUDA-event ms of the one-call PyTorch counterpart of a probe:
    torch.matmul in true f32 for "full" and with TF32 allowed for "reduced"
    (torch.backends.cuda.matmul.allow_tf32 set only around these calls, then
    restored)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "reduced"
    try:
        return cuda_ms(fn, 3, 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def compare_probes(n: int, dev, seed: int = 0) -> dict:
    """Both matmul probes at n x n and both precisions against their plain
    versions (true-f32 torch.matmul, torch.backends.cuda.matmul.allow_tf32
    False; inputs rounded to TF32 for "reduced"): gate at 1e-5 x max-abs;
    times in turns, and as the library's time torch.matmul (one call, three
    for the double-word product) in true f32 for "full" and in TF32 for
    "reduced"."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.kernels.matmul_probe import split_dd

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    a64 = torch.tensor(rng.standard_normal((n, n)), device=dev)
    b64 = torch.tensor(rng.standard_normal((n, n)), device=dev)
    args = {"matmul_f32": (a64.float(), b64.float()),
            "matmul_dd": (*split_dd(a64), *split_dd(b64))}
    a32, b32 = args["matmul_f32"]
    ah, al, bh, bl = args["matmul_dd"]
    library = {"matmul_f32": lambda: a32 @ b32,
               "matmul_dd": lambda: (ah @ bh, ah @ bl, al @ bh)}
    out = {}
    for name, xs in args.items():
        kern, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
        terms = 3 if name == "matmul_dd" else 1
        for prec in ("full", "reduced"):
            got = kern(*xs, prec)
            torch.cuda.synchronize()
            ref = plain(*xs, prec)
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            if not np.isfinite(err) or err > MATMUL_TOL * scale:
                raise RuntimeError(f"{name} {prec} n={n}: kernel disagrees with plain: "
                                   f"max-abs err {err:.3e} > {MATMUL_TOL:g} x {scale:.3e}")
            p1 = cuda_ms(lambda: plain(*xs, prec), 3, 10)
            k1 = cuda_ms(lambda: kern(*xs, prec), 3, 10)
            k2 = cuda_ms(lambda: kern(*xs, prec), 3, 10)
            p2 = cuda_ms(lambda: plain(*xs, prec), 3, 10)
            flops, moved = terms * 2 * n**3, 4 * n * n * (len(xs) + 1)
            t_bytes, t_ops = moved / HBM_BYTES_S, flops / PROBE_FLOP_S[prec]
            out[(name, prec)] = {
                "max_abs_err": err, "scale": scale, "ms": 0.5 * (k1 + k2),
                "plain_ms": 0.5 * (p1 + p2), "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms(library[name], prec), "bytes": moved, "flops": flops}
    return out


def check_per_iteration(label: str, res, counts: dict, names) -> None:
    """Each kernel in names launched once per SCF iteration."""
    wrong = {name: counts[name] for name in names if counts[name] != res.niter}
    if wrong:
        raise RuntimeError(f"{label}: launches {wrong}, not one per each of the "
                           f"{res.niter} iterations")


def run_cli(main, argv, label: str, names: list[str], check, per_iter=()) -> dict:
    """Drive one CLI on the card with every launch counter at 0 before it;
    returns the counts read right after. check(res) -> error text or '';
    the kernels in per_iter must launch once per iteration."""
    from helfem_tpu_torch import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    print(f"{label}: E = {res.E:.12f}, {res.niter} iterations, converged {res.converged}; "
          f"walls: basis {res.walls['basis']:.3f} s, operators {res.walls['operators']:.3f} s, "
          f"SCF {res.walls.get('scf', res.walls.get('solve')):.3f} s, whole CLI {wall:.3f} s; "
          f"kernel launches {counts}")
    problem = check(res)
    if problem:
        raise RuntimeError(f"{label}: {problem}")
    missing = [name for name in names if counts[name] == 0]
    if missing:
        raise RuntimeError(f"{label}: the SCF never launched {missing}")
    check_per_iteration(label, res, counts, per_iter)
    return {name: counts[name] for name in names}


def sad_launches(label: str, res, hf: bool) -> dict:
    """K2 once per Fock build of a SAD solve, K1 as often for HF and never
    for a functional, K4 and K5 as often for a functional and never for HF;
    returns the counts."""
    from helfem_tpu_torch import kernels

    got = {name: kernels.launches[name] for name in (*ATOMIC, *XC)}
    want = {"radial_exchange": res.nfock if hf else 0, "radial_coulomb": res.nfock,
            **{name: 0 if hf else res.nfock for name in XC}}
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want} for {res.nfock} "
                           "Fock builds")
    return got


def sad_kernels(shape: str, ops, results: dict) -> None:
    """K1 and K2 at a SAD shape against their plain versions (the same bits
    twice, one launch per call), into results."""
    from helfem_tpu_torch.models import sadatom

    basis = sadatom.SadAtomBasis(**SAD_SHAPES[shape])
    for name, (args, moved, flops) in sad_kernel_inputs(basis, ops).items():
        same_bits_twice(name, args)
        results[(name, shape)] = report(shape, name, compare(name, args, moved, flops))


def sad_profile(label: str, solve, hf: bool) -> None:
    """Warm solve walls and the device time per solve of K1, K2, K4, K5,
    the eigensolves (torch.linalg.eigh; the refinement passes' matmuls are
    in the rest) and the rest."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.utils.profiling import profile_scf

    def run():
        kernels.reset_launches()
        res = solve()
        sad_launches(f"warm {label}", res, hf)
        return res

    per = profile_scf(label, run, kernels=RADIAL_SASS + XC_SASS, ops=(EIGH_OP,))
    k1, k2, k4, k5 = (per[k][0] for k in RADIAL_SASS + XC_SASS)
    eigh, busy = per[EIGH_OP][0], per["busy"][0]
    print(f"{label}: device time per solve {busy:.4f} ms: K1 {k1:.4f} ms, K2 {k2:.4f} ms, "
          f"K4 {k4:.4f} ms, K5 {k5:.4f} ms, eigh {eigh:.4f} ms, the rest "
          f"{busy - k1 - k2 - k4 - k5 - eigh:.4f} ms")
    return per


def sad_phases(dev, results: dict) -> dict:
    """Phases 13 and 14: gensap Kr through the gensap CLI and SAD-HF Ar;
    returns each path's K1/K2 launch counts."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.gensap import main as gensap_main
    from helfem_tpu_torch.models import sadatom

    phase("13. gensap Kr through the port's gensap CLI on the card, cold and warm; K1/K2 at "
          "the Kr SAD shapes; the warm solve's profile")
    sad_counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label in ("cold", "warm"):
            out = f"{tmp}/result_Kr_{label}.dat"
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = gensap_main(KR_GENSAP_CLI + ["--output", out, "--device", "cuda"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sad_counts["sad_kr"] = sad_launches(f"gensap Kr {label}", res, hf=False)
            table = np.loadtxt(out)
            dE = res.E - KR_GENSAP_REF
            print(f"gensap Kr {label}: E = {res.E:.9f} (E - bench value {dE:+.3e}), converged "
                  f"{res.converged}, configuration {res.occs.tolist()}, {res.niter} iterations, "
                  f"{res.nfock} Fock builds; walls: basis {res.walls['basis']:.3f} s, operators "
                  f"{res.walls['operators']:.3f} s, solve {res.walls['solve']:.3f} s, whole CLI "
                  f"{wall:.3f} s; Z_eff from {table[0, 8]:.6f} to {table[-1, 8]:.3e} over "
                  f"{len(table)} points; kernel launches {sad_counts['sad_kr']}")
            if not (res.converged and abs(dE) < 1e-5 and abs(res.E - KR_GENSAP_PORT) < 1e-8
                    and table.shape == (480, 9) and np.isfinite(table).all()):
                raise RuntimeError(f"gensap Kr {label}: not converged within 1e-5 Eh of the "
                                   "bench value and 1e-8 Eh of the port's value, or the SAP "
                                   "table is not finite")
    kr_basis = sadatom.SadAtomBasis(**SAD_SHAPES["sad_kr"])
    kr_ops = kr_basis.build_ops(dev)
    sad_kernels("sad_kr", kr_ops, results)
    sad_profile("gensap Kr", lambda: sadatom.solve_sadatom(
        kr_basis, method="SVWN", convthr=1e-7, search=False, ops=kr_ops), hf=False)
    del kr_ops

    phase("14. SAD-HF Ar at the Ar bench basis on the card: K1/K2 at its shapes, the solve, "
          "its profile")
    ar_basis = sadatom.SadAtomBasis(**SAD_SHAPES["sad_ar"])
    ar_ops = ar_basis.build_ops(dev)
    sad_kernels("sad_ar", ar_ops, results)
    # the Fock pieces themselves against the same functions on CPU tensors
    cpu_ops = ar_ops.to("cpu")
    Pang = sad_kernel_inputs(ar_basis, ar_ops)["radial_exchange"][0][-1]
    for fn, P in ((sadatom.sad_exchange, Pang), (sadatom.sad_coulomb, Pang.sum(0))):
        first, second = fn(ar_ops, P), fn(ar_ops, P)
        torch.cuda.synchronize()
        ref = fn(cpu_ops, P.cpu())
        err, scale = float((first.cpu() - ref).abs().max()), float(ref.abs().max())
        print(f"SAD-HF Ar: {fn.__name__} on the card vs on the CPU: max-abs err {err:.3e} "
              f"(scale {scale:.3e}), the same bits twice {torch.equal(first, second)}")
        if not (torch.equal(first, second) and err <= REL_TOL * scale):
            raise RuntimeError(f"SAD-HF Ar: {fn.__name__} disagrees with its CPU version or "
                               "gives other bits on a second call")
    del cpu_ops
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = sadatom.solve_sadatom(ar_basis, method="HF", convthr=1e-9, search=False, ops=ar_ops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sad_counts["sad_ar"] = sad_launches("SAD-HF Ar", res, hf=True)
    dE, dpin = res.E - AR_HF_LIMIT, res.E - AR_HF_PORT
    print(f"SAD-HF Ar: E = {res.E:.12f}, converged {res.converged}, configuration "
          f"{res.occs.tolist()}, {res.niter} iterations, {res.nfock} Fock builds, cold solve "
          f"{wall:.3f} s; E - HF limit {dE:+.3e}, E - the atomic CLI's pinned value "
          f"{dpin:+.3e}; kernel launches {sad_counts['sad_ar']}")
    if not (res.converged and abs(dE) < 1e-6):
        raise RuntimeError("SAD-HF Ar: not converged within 1e-6 Eh of the Ar HF limit")
    sad_profile("SAD-HF Ar", lambda: sadatom.solve_sadatom(
        ar_basis, method="HF", convthr=1e-9, search=False, ops=ar_ops), hf=True)
    del ar_ops
    return sad_counts


def dft_phase(dev) -> dict:
    """Phase 15: the DFT_CELLS through the port's atomic CLI, each with K2
    once per iteration, K1 once per iteration for HF and hybrids (both
    spins in one launch) and never otherwise, K4 once per iteration and K5
    once per iteration plus twice for the CLI's grid self-check (overlap,
    kinetic) for a functional and never otherwise; then warm walls and a profile of Ar
    PBE0 and Xe PBE. Returns each cell's launch counts."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.ops.xc import parse_method_rs
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.utils.profiling import profile_scf

    phase("15. atomic DFT and open shells through the port's atomic CLI: Ar SVWN, Ar PBE0, "
          "Xe PBE, N UHF, UKS-PBE and ROHF; warm walls and profiles of Ar PBE0 and Xe PBE")
    dft_counts = {}
    for label, (argv, ref, gate) in DFT_CELLS.items():
        spec = parse_method_rs(argv[argv.index("--method") + 1] if "--method" in argv
                               else "HF")
        funcs, kfrac = spec.funcs, spec.kfull
        nel = {"Ar": 18, "Xe": 54, "N": 7}[label.split()[0]]

        def check(res, label=label, ref=ref, gate=gate, funcs=funcs, kfrac=kfrac, nel=nel):
            n = res.niter
            want = {"radial_coulomb": n, "radial_exchange": n if kfrac else 0,
                    "dia_xc_fields": n if funcs else 0, "dia_xc_fock": n + 2 if funcs else 0}
            got = {name: kernels.launches[name] for name in want}
            dE = res.E - ref
            print(f"{label}: E - reference = {dE:+.3e} (gate {gate:g}), Exc {res.Exc:.10f}, "
                  f"Exx {res.Exx:.10f}, Nel on the grid {res.Nelgrid:.12f}, "
                  f"{'restricted' if res.orbE_b is None else 'unrestricted'}")
            if got != want:
                return f"launches {got}, expected {want}"
            ok = (res.converged and abs(dE) < gate
                  and (not funcs or abs(res.Nelgrid - nel) < 1e-6))
            return "" if ok else "did not converge within the gate, or Nel is off"

        names = ["radial_coulomb"] + (["radial_exchange"] if kfrac else []) + \
            (list(XC) if funcs else [])
        dft_counts[label] = run_cli(atomic_main, argv, label, names, check)

    def profile(label, cfg, nel, method, names):
        basis = AtomicBasis(**cfg)
        ops = basis.build_operators(dev)

        def run():
            kernels.reset_launches()
            res = scf_atom(basis, nel, nel, method=method, convthr=1e-9, guess="TF", ops=ops)
            check_per_iteration(f"warm {label}", res, kernels.launches, names)
            return res

        per = profile_scf(label, run, kernels=RADIAL_SASS + XC_SASS, ops=(EIGH_OP,))
        busy = per["busy"][0]
        (k1, n1), (k2, n2), (k4, n4), (k5, n5) = (per[k] for k in RADIAL_SASS + XC_SASS)
        eigh = per[EIGH_OP][0]
        print(f"{label}: device time per warm SCF {busy:.4f} ms: eigh {eigh:.4f} ms "
              f"({100 * eigh / busy:.1f} %), K1 {k1:.4f} ms in {n1}, K2 {k2:.4f} ms in {n2}, "
              f"K4 {k4:.4f} ms in {n4} ({k4 / max(n4, 1):.4f} a call), K5 {k5:.4f} ms in {n5} "
              f"({k5 / max(n5, 1):.4f} a call), the rest "
              f"{busy - k1 - k2 - k4 - k5 - eigh:.4f} ms")

    profile("Ar PBE0", SHAPES["ar"], 9, "PBE0", (*ATOMIC, *XC))
    profile("Xe PBE", SHAPES["xe"], 27, "PBE", ("radial_coulomb", *XC))
    return dft_counts


class SpinSpy:
    """Inside `with`: the spins of every dia_xc_fields launch (the leading
    axis of its density), seen through the models' own references to the
    wrapper, which it wraps and afterwards restores."""

    def __enter__(self):
        from helfem_tpu_torch.models import atomic_dft, diatomic_dft

        self.modules, self.spins = (atomic_dft, diatomic_dft), []
        self.wrapped = atomic_dft.dia_xc_fields

        def spy(P, *args):
            self.spins.append(P.shape[0])
            return self.wrapped(P, *args)

        for module in self.modules:
            module.dia_xc_fields = spy
        return self

    def __exit__(self, *exc):
        for module in self.modules:
            module.dia_xc_fields = self.wrapped


def whitening_defect(ops) -> float:
    """max |Sinvh_b^T S_b Sinvh_b - I| over the symmetry blocks."""
    from helfem_tpu_torch.utils.linalg import gather_blocks

    M = torch.einsum("bpi,bpq,bqj->bij", ops.blk_sinvh, gather_blocks(ops.S, ops.blk_idx),
                     ops.blk_sinvh)
    valid = (ops.blk_idx < ops.S.shape[0]).to(M.dtype)
    return float((M - torch.diag_embed(valid)).abs().max())


def spin_traces(ops, res) -> tuple[float, ...]:
    """tr(Pa S) and tr(Pb S) of a diatomic result; tr(Pa S) alone when it
    is restricted (Pb = Pa)."""
    from helfem_tpu_torch.utils.linalg import density_blocks

    dev = ops.S.device
    spins = [(res.orbs_a, res.occ_a)] + ([] if res.orbs_b is None else
                                         [(res.orbs_b, res.occ_b)])
    return tuple(float(torch.trace(density_blocks(torch.tensor(C, device=dev),
                                                  torch.tensor(o, device=dev),
                                                  ops.blk_idx, ops.S) @ ops.S))
                 for C, o in spins)


def triplet_occupations(basis, res) -> str:
    """Error text unless every occupation is 0 or 1 and alpha has exactly
    one electron more than beta in each of the two blocks of one pi pair
    (m = +1 and -1, one parity label): the triplet Sigma of O2's two pi*
    electrons."""
    labels = basis.sym_labels(True)
    occ = np.concatenate((res.occ_a, res.occ_b))
    if not np.all((np.abs(occ) < 1e-12) | (np.abs(occ - 1.0) < 1e-12)):
        return "fractional occupations"
    diff = res.occ_a.sum(1) - res.occ_b.sum(1)
    open_ = np.nonzero(np.abs(diff) > 1e-12)[0]
    names = [labels[b] for b in open_]
    print(f"open-shell blocks {names} (alpha - beta {diff[open_].tolist()}); alpha, beta per "
          f"block {list(zip(labels, res.occ_a.sum(1).tolist(), res.occ_b.sum(1).tolist()))}")
    ok = (len(open_) == 2 and np.allclose(diff[open_], 1.0) and names[0] == names[1]
          and names[0].startswith("pi"))
    return "" if ok else f"not the triplet: open blocks {names}"


def open_shell_phase(dev, results: dict) -> dict:
    """Phase 16: open-shell diatomics and the unrestricted SAD atom (the
    module docstring); returns each run's launch counts."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.cli.gensap import VARIANTS
    from helfem_tpu_torch.cli.gensap import main as gensap_main
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.scf.common import full_sinvh
    from helfem_tpu_torch.scf.diatomic_scf import occ_select, occupied_dia, scf_diatomic
    from helfem_tpu_torch.utils.linalg import form_sh, rohf_update
    from helfem_tpu_torch.utils.profiling import profile_scf

    phase("16. open shells: O2 UHF, UKS-PBE and ROHF, O2 UHF at lmax=12, H2+, gensap Cr "
          "--unrestricted and SAD-UHF Cr")
    o2 = DiatomicBasis(**O2_SHAPE)
    counts, energies = {}, {}
    for label, (argv, ref, niter) in O2_CELLS.items():
        dft = "--method" in argv
        names = ["radial_coulomb_dia", *(XC if dft else ["radial_exchange_dia_occ"])]

        def check(res, label=label, ref=ref, niter=niter, dft=dft):
            n = res.niter
            want = {"radial_coulomb_dia": n, "radial_exchange_dia_occ": 0 if dft else 2 * n}
            if dft:  # the O SAD atom of the SAP guess was solved by the first cell
                want.update({name: n for name in XC})
            got = {name: kernels.launches[name] for name in want}
            dE = res.E - ref
            energies[label] = res.E
            print(f"{label}: E - helfem_tpu = {dE:+.3e}, {n} iterations (helfem_tpu {niter}), "
                  f"Exx {res.Exx:.10f}, Exc {res.Exc:.10f}; XC launches by spins "
                  f"{spy.spins}")
            if got != want:
                return f"launches {got}, expected {want}"
            if dft and spy.spins != [2] * n:
                return f"dia_xc_fields ran {spy.spins} spins, expected two in each of {n}"
            problem = triplet_occupations(o2, res)
            if problem:
                return problem
            ok = res.converged and abs(dE) < 1e-8 and abs(n - niter) <= 1
            return "" if ok else "not converged within 1e-8 Eh and +-1 iteration of helfem_tpu"

        with SpinSpy() as spy:
            counts[label] = run_cli(diatomic_main, argv, label, names, check)
    gap = energies["O2 ROHF"] - energies["O2 UHF"]
    print(f"O2: E(ROHF) - E(UHF) = {gap:+.6e} Eh")
    if gap < -1e-8:
        raise RuntimeError("O2: ROHF below UHF")
    # K6 at O2's occupied widths, and the host's ROHF update at nbf 665
    for no, shape in ((9, "o2_alpha"), (7, "o2_beta")):
        args, moved, flops = dia_exchange_inputs(O2_SHAPE, dev, no=no)["radial_exchange_dia_occ"]
        results[("radial_exchange_dia_occ", shape)] = report(
            shape, "radial_exchange_dia_occ", compare("radial_exchange_dia_occ", args, moved,
                                                      flops))
    ops = o2.build_operators(dev)
    S = ops.S.cpu().numpy()
    rng = np.random.default_rng(83)
    Fa, Fb, P = (X + X.T for X in rng.standard_normal((3, o2.nbf, o2.nbf)))
    t0 = time.perf_counter()
    Sh = form_sh(S)
    t1 = time.perf_counter()
    Sinvh = full_sinvh(ops.blk_idx.cpu().numpy(), ops.blk_sinvh.cpu().numpy(), o2.nbf)
    for _ in range(3):
        rohf_update(Fa, Fb, P, Sh, Sinvh, 9, 7)
    t2 = time.perf_counter()
    print(f"O2 ROHF host work at nbf {o2.nbf}: form_sh once {1e3 * (t1 - t0):.2f} ms, "
          f"rohf_update {1e3 * (t2 - t1) / 3:.2f} ms per iteration")
    del ops

    t0 = time.perf_counter()
    big = DiatomicBasis(**O2_L12_SHAPE)
    big_ops = big.build_operators(dev)
    torch.cuda.synchronize()
    print(f"O2 UHF lmax=12: nbf {big.nbf}, basis and operators {time.perf_counter() - t0:.3f} s")

    def run_big():
        kernels.reset_launches()
        res = scf_diatomic(big, 9, 7, method="HF", convthr=1e-7, maxit=50, ops=big_ops,
                           guess="SAP")
        n = res.niter
        got = {name: kernels.launches[name] for name in (*K3, "radial_exchange_dia_occ")}
        if got != {"radial_coulomb_dia": n, "radial_exchange_dia_occ": 2 * n}:
            raise RuntimeError(f"O2 UHF lmax=12: launches {got}, expected K3 {n} and K6 "
                               f"{2 * n}")
        return res

    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        res = run_big()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        na, nb = spin_traces(big_ops, res)
        pin = "" if O2_L12_PORT is None else f", E - pinned value {res.E - O2_L12_PORT:+.3e}"
        print(f"O2 UHF lmax=12 {label} SCF: E = {res.E:.12f} in {res.niter} iterations, "
              f"converged {res.converged}; wall {wall:.3f} s; tr(Pa S) - 9 = {na - 9:+.3e}, "
              f"tr(Pb S) - 7 = {nb - 7:+.3e} (the whitening's defect "
              f"{whitening_defect(big_ops):.2e}){pin}")
        occ_ok = (np.allclose(res.occ_a.sum(), 9, rtol=0, atol=1e-12)
                  and np.allclose(res.occ_b.sum(), 7, rtol=0, atol=1e-12))
        if not (res.converged and occ_ok and abs(na - 9) < SPIN_COUNT_TOL
                and abs(nb - 7) < SPIN_COUNT_TOL
                and (O2_L12_PORT is None or abs(res.E - O2_L12_PORT) < 1e-8)):
            raise RuntimeError(f"O2 UHF lmax=12 {label}: not converged, a spin count off by "
                               f"{SPIN_COUNT_TOL:g}, or E off the pinned value by 1e-8 Eh")
    per = profile_scf("O2 UHF lmax=12", run_big, kernels=(K3_SASS, K6_SASS), ops=(EIGH_OP,),
                      walls=1)
    busy, eigh, k3, k6 = (per[k][0] for k in ("busy", EIGH_OP, K3_SASS, K6_SASS))
    n6 = 2 * res.niter
    results[("radial_exchange_dia_occ", "o2_l12_scf")] = {"device_ms": k6 / n6, "launches": n6}
    print(f"O2 UHF lmax=12: device time per warm SCF {busy:.4f} ms: eigh {eigh:.4f} ms "
          f"({100 * eigh / busy:.1f} %), K6 {k6:.4f} ms in {n6} launches ({k6 / n6:.4f} a "
          f"launch, both spins' mean), K3 {k3:.4f} ms, the rest {busy - eigh - k6 - k3:.4f} ms")
    # K6 on each spin's converged occupied columns, against its plain version
    for spin, C, occ in (("alpha", res.orbs_a, res.occ_a), ("beta", res.orbs_b, res.occ_b)):
        Co = occupied_dia(big_ops, torch.tensor(C, device=dev), occ_select(occ, dev))
        args, moved, flops = exchange_inputs(big, big_ops, Co, dense=False)[
            "radial_exchange_dia_occ"]
        results[("radial_exchange_dia_occ", f"o2_l12_{spin}")] = report(
            f"o2_l12_{spin} ({Co.shape[1]} columns)", "radial_exchange_dia_occ",
            compare("radial_exchange_dia_occ", args, moved, flops, warmup=1, reps=3))
    del args, Co
    del big_ops
    torch.cuda.empty_cache()

    def h2p_check(res):
        dE = res.E - H2P_EXACT
        print(f"H2+: E - exact = {dE:+.3e}, Exx + Ecoul = {res.Exx + res.Ecoul:+.3e}, "
              f"beta occupied {res.occ_b.sum()}")
        ok = (res.converged and abs(dE) < 1e-8 and res.occ_b.sum() == 0
              and abs(res.Exx + res.Ecoul) < 1e-12 * res.Ecoul)
        return "" if ok else "not within 1e-8 Eh of the exact energy, or Exx != -Ecoul"

    k36 = ["radial_coulomb_dia", "radial_exchange_dia_occ"]
    counts["H2+"] = run_cli(diatomic_main, H2P_CLI, "H2+", k36, h2p_check, per_iter=k36)

    sad_names = (*ATOMIC, *XC)
    with tempfile.TemporaryDirectory() as tmp, SpinSpy() as spy:
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = gensap_main(CR_GENSAP_CLI + ["--output", f"{tmp}/result_Cr.dat",
                                           "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r_u = res.spin_polarised
        got = {name: kernels.launches[name] for name in sad_names}
        nf = res.nfock + r_u.nfock
        want = {"radial_exchange": 0, **{name: nf for name in ("radial_coulomb", *XC)}}
        total = (np.asarray(r_u.occs) + np.asarray(r_u.occs_b)).tolist()
        M = int(sum(r_u.occs) - sum(r_u.occs_b) + 1)
        dE = r_u.E - CR_U_REF
        tables = [np.loadtxt(f"{tmp}/result{tag}_Cr.dat") for tag in VARIANTS]
        print(f"gensap Cr --unrestricted: E = {r_u.E:.10f} (E - helfem_tpu {dE:+.3e}), "
              f"configuration {total}, M = {M}, {len(r_u.conf_list)} configurations, "
              f"{r_u.nfock} Fock builds (restricted leg {res.nfock}); walls: solve "
              f"{res.walls['solve']:.3f} s, unrestricted {res.walls['unrestricted']:.3f} s, "
              f"whole CLI {wall:.3f} s; kernel launches {got}")
        if got != want or spy.spins != [1] * res.nfock + [2] * r_u.nfock:
            raise RuntimeError(f"gensap Cr: launches {got}, expected {want}, or K4 spins not "
                               "one per restricted and two per unrestricted Fock build")
        if not (r_u.converged and abs(dE) < 1e-8 and total == [7, 12, 5] and M == 7
                and all(t.shape[1] == 9 and np.isfinite(t).all() for t in tables)):
            raise RuntimeError("gensap Cr: not 3d5 4s1 with M = 7 within 1e-8 Eh of "
                               "helfem_tpu, or a potential table is not finite")
    counts["gensap Cr"] = got
    for name, (args, moved, flops) in atomic_xc_inputs("sad_cr", dev, ns=2).items():
        same_bits_twice(name, args)
        results[(name, "sad_cr2")] = report("sad_cr2 (two spins) atomic grid", name,
                                            compare(name, args, moved, flops))
    del args

    cr = sadatom.SadAtomBasis(**CR_SHAPE)
    cr_ops = cr.build_ops(dev)
    X = np.random.default_rng(89).standard_normal((2 * (cr.lmax + 1), cr.nrad, 4))
    Pang = torch.tensor(np.einsum("lik,ljk->lij", X, X), device=dev)
    at = cr_ops.at
    args, moved, flops = atomic_kernel_work(at.tei, at.disjL, at.disjm1L, at.Lfac, at.gidx,
                                            Pang[None, None, 0].contiguous(),
                                            Pang)["radial_exchange"]
    same_bits_twice("radial_exchange", args)
    results[("radial_exchange", "sad_cr2")] = report(
        "sad_cr2 (two spins)", "radial_exchange", compare("radial_exchange", args, moved, flops))

    def solve_cr():
        return sadatom.solve_sadatom_unrestricted(cr, 15, 9, method="HF", convthr=1e-8,
                                                  ops=cr_ops)

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = solve_cr()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["SAD-UHF Cr"] = sad_launches("SAD-UHF Cr", res, hf=True)
    dE = res.E - CR_UHF_REF
    print(f"SAD-UHF Cr: E = {res.E:.10f} (E - helfem_tpu {dE:+.3e}), occupations "
          f"{res.occs.tolist()} / {res.occs_b.tolist()}, {res.nfock} Fock builds, cold solve "
          f"{wall:.3f} s; kernel launches {counts['SAD-UHF Cr']}")
    if not (res.converged and abs(dE) < 1e-8):
        raise RuntimeError("SAD-UHF Cr: not converged within 1e-8 Eh of helfem_tpu")
    per = sad_profile("SAD-UHF Cr", solve_cr, hf=True)
    k1, n1 = per[RADIAL_SASS[0]]
    results[("radial_exchange", "sad_cr2_scf")] = {"device_ms": k1 / max(n1, 1),
                                                   "launches": n1}
    print(f"SAD-UHF Cr: K1 {k1 / max(n1, 1):.4f} ms device a launch (both spins)")
    del cr_ops
    return counts


def tau_kernels(dev, results: dict) -> None:
    """K4 and K5 in tau mode against their plain versions on the TAU_GRIDS
    at one and two spins (1e-12 x each output's max-abs, the same bits
    twice, one launch per call), into results[(name, "tau_<grid>_<ns>")]."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    for grid in TAU_GRIDS:
        for ns in (1, 2):
            t0 = time.perf_counter()
            if grid in ("n2", "lmax12"):
                cfg = DIA_SHAPES["n2"] if grid == "n2" else N2_L12_SHAPE
                inputs = xc_kernel_inputs(DiatomicBasis(**cfg), dev, ns, 83, tau=True)
            else:
                inputs = atomic_xc_inputs(grid, dev, ns, 89, tau=True)
            torch.cuda.synchronize()
            print(f"tau {grid}, {ns} spin(s): grid and inputs made in "
                  f"{time.perf_counter() - t0:.2f} s")
            reps = (2, 10) if grid == "lmax12" else (5, 50)
            for name, (args, moved, flops) in inputs.items():
                same_bits_twice(name, args)
                results[(name, f"tau_{grid}_{ns}")] = report(
                    f"tau {grid} ns={ns}", name, compare(name, args, moved, flops, *reps))
            del inputs, args
            torch.cuda.empty_cache()
    print(f"XC kernels in tau mode on {list(TAU_GRIDS)}, one and two spins: one launch per "
          "call, the same bits twice")


def lapl_kernels(dev, results: dict) -> None:
    """K4 and K5 in laplacian mode against their plain versions on the
    LAPL_GRIDS at one and two spins (the lmax=12 grid at one), 1e-12 x each
    output's max-abs, the same bits twice, one launch per call, into
    results[(name, "lapl_<grid>_<ns>")]."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    for grid in LAPL_GRIDS:
        for ns in (1,) if grid == "lmax12" else (1, 2):
            t0 = time.perf_counter()
            if grid in ("n2", "lmax12"):
                cfg = DIA_SHAPES["n2"] if grid == "n2" else N2_L12_SHAPE
                inputs = xc_kernel_inputs(DiatomicBasis(**cfg), dev, ns, 113, lapl=True)
            else:
                inputs = atomic_xc_inputs(grid, dev, ns, 127, lapl=True)
            torch.cuda.synchronize()
            print(f"laplacian {grid}, {ns} spin(s): grid and inputs made in "
                  f"{time.perf_counter() - t0:.2f} s")
            reps = (2, 10) if grid == "lmax12" else (5, 50)
            for name, (args, moved, flops) in inputs.items():
                same_bits_twice(name, args)
                results[(name, f"lapl_{grid}_{ns}")] = report(
                    f"laplacian {grid} ns={ns}", name, compare(name, args, moved, flops, *reps))
            del inputs, args
            torch.cuda.empty_cache()
    print(f"XC kernels in laplacian mode on {list(LAPL_GRIDS)}: one launch per call, the same "
          "bits twice")


def tau_identities(dev) -> None:
    """On the card: sum w tau = tr(P T) at the N2 bench basis (a physical
    two-orbital-per-block density through K4's tau mode), and the grid
    kinetic matrix (K5's tau contraction) against the analytic T at the Ar
    bench basis."""
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.atomic_dft import build_atomic_grid, eval_kinetic_grid
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.models.diatomic_dft import _fields_dia, build_dia_grid

    basis = DiatomicBasis(**DIA_SHAPES["n2"])
    ops = basis.build_operators(dev)
    g = build_dia_grid(basis, dev)
    rng = np.random.default_rng(97)
    P = np.zeros((basis.nbf, basis.nbf))
    for idx in basis.sym_blocks():
        X = rng.standard_normal((len(idx), 2)) * 0.3
        P[np.ix_(idx, idx)] = X @ X.T
    m = ops.shellmask.reshape(-1).cpu().numpy()
    P = torch.tensor(P * np.outer(m, m), device=dev)
    tau = _fields_dia(g, P, True)[3]
    t_grid, t_ref = float(torch.sum(g.w * tau)), float(torch.sum(P * ops.T))
    rel = abs(t_grid - t_ref) / abs(t_ref)
    print(f"N2 bench basis: sum w tau = {t_grid:.15f}, tr(P T) = {t_ref:.15f}, relative "
          f"difference {rel:.3e} (gate {TAU_TRACE_TOL:g})")
    if not rel < TAU_TRACE_TOL:
        raise RuntimeError("sum w tau disagrees with tr(P T) on the card")
    del ops, g
    ar = AtomicBasis(**SHAPES["ar"])
    g = build_atomic_grid(ar, dev)
    T = eval_kinetic_grid(g, ar.nrad).cpu().numpy()
    Tref = ar.kinetic()
    err = float((np.abs(T - Tref) / (1.0 + np.abs(Tref))).max())
    print(f"Ar bench basis: grid kinetic matrix through K5's tau contraction against the "
          f"analytic T: max |dT| / (1 + |T|) = {err:.3e} (gate {KINETIC_GRID_TOL:g})")
    if not err < KINETIC_GRID_TOL:
        raise RuntimeError("the grid kinetic matrix disagrees with the analytic T on the card")


def mgga_phase(dev, results: dict) -> dict:
    """Phase 17: the XC kernels' tau mode against their plain versions, the
    two tau identities, and the MGGA_CELLS through the port's CLIs, each
    within MGGA_GATE of helfem_tpu's energy with K4 and K5 once per Fock
    build (the atomic CLI's K5 twice more, for the grid self-check's
    overlap and kinetic matrices); then each cell's warm wall (one run)
    and the device-time shares of eigh, K4, K5 and xc_eval (its forward
    range and autograd's backward nodes). Returns each cell's launches."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.cli.gensap import main as gensap_main
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.atomic_dft import build_atomic_grid
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.ops.xc import parse_method_rs
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.utils.profiling import profile_scf

    phase("17. meta-GGAs: K4/K5 in tau mode against plain on five grids, the tau identities, "
          "Ar TPSS/TPSSh/rSCAN/B3LYP5, N2 TPSS/B3LYP5, quartet N UKS-TPSS and SAD TPSS Kr "
          "through the port's CLIs, their warm walls and device shares")
    tau_kernels(dev, results)
    tau_identities(dev)
    mains = {"atomic": atomic_main, "diatomic": diatomic_main, "gensap": gensap_main}
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (prog, argv, ref, ref_niter) in MGGA_CELLS.items():
            method = argv[argv.index("--method") + 1]
            hybrid = parse_method_rs(method).kfull != 0.0
            extra = ["--output", f"{tmp}/result_Kr.dat"] if prog == "gensap" else []

            def check(res, label=label, prog=prog, ref=ref, ref_niter=ref_niter):
                nfock = res.nfock if prog == "gensap" else res.niter
                got = {name: kernels.launches[name] for name in XC}
                want = {"dia_xc_fields": nfock,
                        "dia_xc_fock": nfock + (2 if prog == "atomic" else 0)}
                dE = res.E - ref
                k5 = got["dia_xc_fock"] - (2 if prog == "atomic" else 0)
                print(f"{label}: E - helfem_tpu = {dE:+.3e} (gate {MGGA_GATE:g}), {res.niter} "
                      f"iterations (helfem_tpu {ref_niter}), {nfock} Fock builds; launches per "
                      f"Fock build K4 {got['dia_xc_fields'] / nfock:.3f}, K5 {k5 / nfock:.3f}")
                if got != want:
                    return f"launches {got}, expected {want}"
                return "" if res.converged and abs(dE) < MGGA_GATE else \
                    "did not converge within the gate"

            names = list(XC) + (["radial_exchange" if prog == "atomic" else
                                 "radial_exchange_dia_occ"] if hybrid else [])
            counts[label] = run_cli(mains[prog], argv + extra, label, names, check)

    def warm(label, run):
        per = profile_scf(label, run, kernels=XC_SASS + RADIAL_SASS + (K3_SASS, K6_SASS),
                          ops=(EIGH_OP,), walls=1,
                          ranges={"xc_eval": ("xc_eval", "autograd::engine::evaluate")})
        busy = per["busy"][0]
        shares = {name: per[key][0] for name, key in
                  (("eigh", EIGH_OP), ("K4", XC_SASS[0]), ("K5", XC_SASS[1]),
                   ("xc_eval", "xc_eval"))}
        other = busy - sum(shares.values())
        print(f"{label}: device time per warm SCF {busy:.4f} ms; "
              + ", ".join(f"{k} {v:.4f} ms ({100 * v / busy:.1f} %)" for k, v in shares.items())
              + f", the rest {other:.4f} ms ({100 * other / busy:.1f} %); K4/K5 launches "
              f"{per[XC_SASS[0]][1]}/{per[XC_SASS[1]][1]}")
        results[("mgga_scf", label)] = {"busy_ms": busy, **{f"{k}_ms": v for k, v in
                                                            shares.items()}}

    for label, (prog, argv, _, _) in MGGA_CELLS.items():
        method = argv[argv.index("--method") + 1]
        if prog == "atomic":
            cfg = SHAPES["ar"] if label.startswith("Ar") else dict(SHAPES["ar"], Z=7)
            nel = (9, 9) if label.startswith("Ar") else (5, 2)
            basis = AtomicBasis(**cfg)
            ops, grid = basis.build_operators(dev), build_atomic_grid(basis, dev)
            convthr = float(argv[argv.index("--convthr") + 1])
            warm(label, lambda: scf_atom(basis, *nel, method=method, convthr=convthr,
                                         guess="TF", ops=ops, grid=grid))
        elif prog == "diatomic":
            basis = DiatomicBasis(**DIA_SHAPES["n2"])
            ops = basis.build_operators(dev)
            warm(label, lambda: scf_diatomic(basis, 7, 7, method=method, convthr=1e-7,
                                             guess="SAP", ops=ops))
        else:
            basis = sadatom.SadAtomBasis(**SAD_SHAPES["sad_kr"])
            ops = basis.build_ops(dev)
            warm(label, lambda: sadatom.solve_sadatom(basis, method="TPSS", convthr=1e-7,
                                                      search=False, ops=ops))
        del ops
        torch.cuda.empty_cache()
    return counts


def rs_kernels(dev, results: dict) -> dict:
    """K10 against its plain version at the Ar and Xe bench bases on the erfc
    tables at RS_OMEGA, one and two spins, and K1 on the Yukawa tables of
    the Ar bench basis at YUKAWA_LAMBDAS against the pairwise plain version
    (1e-12 x max-abs, the same bits twice, one launch per call), into
    results[(name, key)]; returns each basis's erfc table setup wall."""
    from helfem_tpu_torch import kernels

    setup = {}
    for shape in ("ar", "xe"):
        t0 = time.perf_counter()
        rs = None
        for ns in (1, 2):
            work, rs = erfc_inputs(shape, dev, ns, rs=rs)
            if ns == 1:
                torch.cuda.synchronize()
                setup[shape] = time.perf_counter() - t0
                print(f"{shape}: erfc tables {tuple(rs.tei.shape)} "
                      f"({nbytes(rs.tei) / 2**20:.1f} MiB) built in {setup[shape]:.2f} s")
            for name, (args, moved, flops) in work.items():
                same_bits_twice(name, args)
                key = shape if ns == 1 else f"{shape}_2"
                results[(name, key)] = report(f"{shape} ns={ns}", name,
                                              compare(name, args, moved, flops))
                results[("erfc_details", key)] = erfc_details(f"{shape} ns={ns}", args,
                                                              results[(name, key)])
        del rs, work, args
        torch.cuda.empty_cache()
    for lam in YUKAWA_LAMBDAS:
        args, moved, flops = yukawa_inputs(lam, dev)
        iL, kL = args[1], args[2]
        print(f"Yukawa tables at lam {lam:g}: max |iL| {float(iL.abs().max()):.3e}, "
              f"max |kL| {float(kL.abs().max()):.3e}")
        same_bits_twice("radial_exchange", args)
        results[("radial_exchange", f"yukawa_{lam:g}")] = report(
            f"ar Yukawa lam={lam:g}", "radial_exchange",
            compare("radial_exchange", args, moved, flops,
                    plain=kernels.radial_exchange_pairwise_plain))
    print("K10 at the Ar and Xe bench bases, one and two spins, and K1 on the Yukawa tables: "
          "one launch per call, the same bits twice")
    return setup


def rs_phase(dev, results: dict) -> dict:
    """Phase 18: rs_kernels, then the RS_CELLS through the port's atomic CLI,
    each within RS_GATE of helfem_tpu's energy with, per Fock build, K2
    once, K10 once for an erfc method, K1 once for a method with kfull != 0
    and once more for the Yukawa kernel (the Coulomb and the Yukawa tables
    in two launches), K4 once and K5 once (twice more for the CLI's grid
    self-check); then the warm wall (one run) and device shares of Ar and
    Xe LC-LDA with their tables prebuilt. Returns each cell's launches."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.atomic_dft import build_atomic_grid
    from helfem_tpu_torch.ops.xc import parse_method_rs
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.utils.profiling import profile_scf

    phase("18. range separation: K10 against plain at the Ar and Xe bench bases, K1 on the "
          "Yukawa tables, Ar LC-LDA/SR-PBE0/LCY-LDA, quartet N UKS LC-LDA and Xe LC-LDA "
          "through the port's atomic CLI, warm walls and device shares")
    setup = rs_kernels(dev, results)
    counts = {}
    for label, (argv, ref, ref_niter) in RS_CELLS.items():
        spec = parse_method_rs(argv[argv.index("--method") + 1])
        erfc = spec.kernel == "erfc"

        def check(res, label=label, ref=ref, ref_niter=ref_niter, spec=spec, erfc=erfc):
            n = res.niter
            want = {"radial_coulomb": n,
                    "radial_exchange": n * (bool(spec.kfull) + (not erfc)),
                    "radial_erfc_exchange": n if erfc else 0,
                    "dia_xc_fields": n, "dia_xc_fock": n + 2}
            got = {name: kernels.launches[name] for name in want}
            dE = res.E - ref
            print(f"{label}: E - helfem_tpu = {dE:+.3e} (gate {RS_GATE:g}), {n} iterations "
                  f"(helfem_tpu {ref_niter}), Exx {res.Exx:.10f}, Exc {res.Exc:.10f}; "
                  f"launches per Fock build {({k: v / n for k, v in got.items()})}")
            if got != want:
                return f"launches {got}, expected {want}"
            return "" if res.converged and abs(dE) < RS_GATE else \
                "did not converge within the gate"

        names = ["radial_coulomb", *XC] + (["radial_erfc_exchange"] if erfc else []) + \
            (["radial_exchange"] if spec.kfull or not erfc else [])
        counts[label] = run_cli(atomic_main, argv, label, names, check)

    for label, shape, nel in (("Ar LC-LDA", "ar", 9), ("Xe LC-LDA", "xe", 27)):
        basis = AtomicBasis(**SHAPES[shape])
        ops, grid = basis.build_operators(dev), build_atomic_grid(basis, dev)
        t0 = time.perf_counter()
        rs = basis.build_erfc(RS_OMEGA, dev)
        torch.cuda.synchronize()
        print(f"{label}: erfc tables built in {time.perf_counter() - t0:.3f} s (setup, outside "
              "the warm walls)")

        def run(label=label, basis=basis, ops=ops, grid=grid, rs=rs, nel=nel):
            kernels.reset_launches()
            res = scf_atom(basis, nel, nel, method="LC-LDA", convthr=1e-8, guess="TF", ops=ops,
                           grid=grid, rs=rs)
            check_per_iteration(f"warm {label}", res, kernels.launches,
                                ("radial_coulomb", "radial_exchange", "radial_erfc_exchange"))
            return res

        per = profile_scf(label, run, kernels=(*RADIAL_SASS, K10_SASS, *XC_SASS), ops=(EIGH_OP,),
                          ranges={"xc_eval": ("xc_eval", "autograd::engine::evaluate")},
                          walls=1)
        busy = per["busy"][0]
        shares = {name: per[key][0] for name, key in
                  (("eigh", EIGH_OP), ("K1", RADIAL_SASS[0]), ("K2", RADIAL_SASS[1]),
                   ("K10", K10_SASS), ("K4", XC_SASS[0]), ("K5", XC_SASS[1]),
                   ("xc_eval", "xc_eval"))}
        other = busy - sum(shares.values())
        print(f"{label}: device time per warm SCF {busy:.4f} ms; "
              + ", ".join(f"{k} {v:.4f} ms ({100 * v / busy:.1f} %)" for k, v in shares.items())
              + f", the rest {other:.4f} ms ({100 * other / busy:.1f} %); K10 launches "
              f"{per[K10_SASS][1]}, {per[K10_SASS][0] / max(per[K10_SASS][1], 1):.4f} ms a call")
        results[("rs_scf", label)] = {"busy_ms": busy, **{f"{k}_ms": v for k, v in shares.items()}}
        del ops, grid, rs
        torch.cuda.empty_cache()
    results[("rs_setup", "erfc_tables_s")] = setup
    return counts


def iteration_energies(text: str) -> list[float]:
    """The energies of an SCF's verbose "iter k  E = ..." lines."""
    return [float(m) for m in re.findall(r"iter +\d+ +E = ([-+0-9.]+)", text)]


def lapl_full_width(dev, results: dict) -> None:
    """At the Ar and N2 bench bases: one BR89 Fock build (K4 and K5 once
    each, laplacian mode) on the converged Ar HF and N2 PBE densities
    against helfem_tpu's LAPL_FOCK_REFS, and the first five BR89 SCF
    iterations against LAPL_FIVE_REFS; then the launches of one BR89
    xc_eval (device kernels and aten operators) at the Ar bench grid."""
    import contextlib
    import io

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.atomic_dft import build_atomic_grid, eval_fxc
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.models.diatomic_dft import build_dia_grid, eval_fxc_dia
    from helfem_tpu_torch.ops.xc import parse_method
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.utils.linalg import build_blocks, density_blocks

    funcs = tuple(parse_method("mgga_x_br89")[0])
    ar = AtomicBasis(**SHAPES["ar"])
    ar_ops = ar.build_operators(dev)
    ar_grid = build_atomic_grid(ar, dev, lapl=True)
    n2 = DiatomicBasis(**DIA_SHAPES["n2"])
    n2_ops = n2.build_operators(dev)
    n2_grid = build_dia_grid(n2, dev, lapl=True)
    res = scf_atom(ar, 9, 9, convthr=1e-9, guess="TF", ops=ar_ops)
    blk = torch.as_tensor(build_blocks(ar_ops.S.cpu().numpy(), ar.sym_blocks(2))[0], device=dev)
    P_ar = density_blocks(torch.as_tensor(res.orbs_a, device=dev),
                          torch.as_tensor(res.occ_a, device=dev), blk, ar_ops.S)
    res = scf_diatomic(n2, 7, 7, method="PBE", convthr=1e-7, ops=n2_ops)
    P_n2 = density_blocks(torch.as_tensor(res.orbs_a, device=dev),
                          torch.as_tensor(res.occ_a, device=dev), n2_ops.blk_idx, n2_ops.S)
    builds = {"ar": lambda: eval_fxc(funcs, ar_grid, P_ar, P_ar),
              "n2": lambda: eval_fxc_dia(funcs, n2_grid, n2_ops, P_n2, P_n2)}
    for shape, build in builds.items():
        P = P_ar if shape == "ar" else P_n2
        kernels.reset_launches()
        t0 = time.perf_counter()
        Fa, _, Exc, Nel = build()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"Exc": float(Exc), "trFP": float(torch.sum(Fa * P)), "Fnorm": float(Fa.norm())}
        launches = {name: kernels.launches[name] for name in XC}
        ref = LAPL_FOCK_REFS[shape]
        rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ref}
        print(f"{shape} bench basis, BR89 Fock build on the converged density: Exc "
              f"{got['Exc']:.12f} (helfem_tpu {ref['Exc']:.12f}), relative differences {rel}, "
              f"Nel {float(Nel):.12f}, {wall * 1e3:.2f} ms, launches {launches}")
        if launches != {name: 1 for name in XC}:
            raise RuntimeError(f"{shape} BR89 Fock build: launches {launches}, not one each")
        if not (rel["Exc"] < LAPL_FOCK_TOL and rel["trFP"] < 1e-9 and rel["Fnorm"] < 1e-9):
            raise RuntimeError(f"{shape} BR89 Fock build disagrees with helfem_tpu")
        results[("lapl_fock", shape)] = {**got, "ms": wall * 1e3}
    five = {"ar": lambda: scf_atom(ar, 9, 9, method="mgga_x_br89", convthr=1e-8, guess="TF",
                                   maxit=5, verbose=True, ops=ar_ops, grid=ar_grid),
            "n2": lambda: scf_diatomic(n2, 7, 7, method="mgga_x_br89", convthr=1e-8, maxit=5,
                                       verbose=True, ops=n2_ops)}
    for shape, run in five.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run()
        got = iteration_energies(buf.getvalue())
        diffs = [g - r for g, r in zip(got, LAPL_FIVE_REFS[shape])]
        print(f"{shape} bench basis, first five BR89 iterations: {got}; E - helfem_tpu "
              + ", ".join(f"{d:+.2e}" for d in diffs))
        if len(got) != 5 or not all(abs(d) < LAPL_FIVE_TOL for d in diffs):
            raise RuntimeError(f"{shape}: the first five BR89 iterations part from helfem_tpu's")
    # the autograd functional's launches: one xc_eval of BR89 on the Ar
    # bench grid's fields of the converged HF density
    from helfem_tpu_torch.ops.xc import xc_eval

    fields = kernels.dia_xc_fields(P_ar.contiguous()[None], ar_grid, True, True)
    rho, du, dv, tau, lap = (f[0] for f in fields)
    r = ar_grid.r[:, :, None]
    sig = du * du + (dv / r) ** 2
    xc_eval(funcs, rho, rho, sig, sig, sig, 1e-12, tau, tau, lap, lap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        xc_eval(funcs, rho, rho, sig, sig, sig, 1e-12, tau, tau, lap, lap)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    n_kernels = sum(e.count for e in device)
    n_aten = sum(e.count for e in events if e.device_type != DeviceType.CUDA
                 and e.key.startswith("aten::"))
    t0 = time.perf_counter()
    for _ in range(5):
        xc_eval(funcs, rho, rho, sig, sig, sig, 1e-12, tau, tau, lap, lap)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"one BR89 xc_eval at the Ar bench grid ({rho.numel()} points): {n_kernels} device "
          f"kernels, {n_aten} aten operator calls (nested ones included), {ms:.2f} ms a call")
    results[("lapl_xc_eval", "ar")] = {"kernels": n_kernels, "aten": n_aten, "ms": ms}


def lapl_phase(dev, results: dict) -> dict:
    """Phase 19: lapl_kernels, lapl_full_width, H's BR89 exchange on its
    converged HF density (-5/16), the LAPL_CELLS through the port's CLIs
    and N2 BR89 with shift 1.0 through scf_diatomic, each within LAPL_GATE
    of helfem_tpu's energy in its iteration count, with K4 and K5 once per
    Fock build (the atomic CLI's K5 twice more, for its grid self-check);
    then the warm walls and device shares of Ar and N UKS BR89. Returns each
    cell's launches."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.cli.gensap import main as gensap_main
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.atomic_dft import build_atomic_grid, eval_fxc
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.ops.xc import parse_method
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.utils.linalg import density_blocks
    from helfem_tpu_torch.utils.profiling import profile_scf

    phase("19. laplacian level: K4/K5 in laplacian mode against plain on four grids, BR89 Fock "
          "builds and first iterations at the Ar and N2 bench bases, H's BR89 exchange, Ar, "
          "Ne, Ne BR89-LYP, N UKS, N2 and H2 BR89 through the CLIs, N2 BR89 with a level "
          "shift, Fock damping and diisthr, warm walls and device shares")
    lapl_kernels(dev, results)
    lapl_full_width(dev, results)

    h = AtomicBasis(Z=1, lmax=0, mmax=0, rmax=30.0, nelem=8, nnodes=12)
    h_ops = h.build_operators(dev)
    res = scf_atom(h, 1, 0, convthr=1e-10, ops=h_ops)
    blk = torch.arange(h.nrad, dtype=torch.int32, device=dev)[None]
    Pa = density_blocks(torch.as_tensor(res.orbs_a, device=dev),
                        torch.as_tensor(res.occ_a, device=dev), blk, h_ops.S)
    _, _, Exc, Nel = eval_fxc(tuple(parse_method("mgga_x_br89")[0]),
                              build_atomic_grid(h, dev, lapl=True), Pa, torch.zeros_like(Pa))
    print(f"H: BR89 exchange on the converged HF density {float(Exc):.10f} (exact -5/16, "
          f"difference {float(Exc) - H_BR89_EXC:+.2e}), Nel {float(Nel):.12f}")
    if not abs(float(Exc) - H_BR89_EXC) < H_EXC_TOL:
        raise RuntimeError("H: BR89 exchange is not -5/16 on the card")

    mains = {"atomic": atomic_main, "diatomic": diatomic_main, "gensap": gensap_main}
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (prog, argv, ref, ref_niter) in LAPL_CELLS.items():
            extra = ["--output", f"{tmp}/result_Ne.dat"] if prog == "gensap" else []

            def check(res, label=label, prog=prog, ref=ref, ref_niter=ref_niter):
                nfock = res.nfock if prog == "gensap" else res.niter
                selfcheck = 2 if prog == "atomic" else 0
                got = {name: kernels.launches[name] for name in XC}
                want = {"dia_xc_fields": nfock, "dia_xc_fock": nfock + selfcheck}
                dE = res.E - ref
                print(f"{label}: E - helfem_tpu = {dE:+.3e} (gate {LAPL_GATE:g}), {res.niter} "
                      f"iterations (helfem_tpu {ref_niter}), {nfock} Fock builds; launches per "
                      f"Fock build K4 {got['dia_xc_fields'] / nfock:.3f}, K5 "
                      f"{(got['dia_xc_fock'] - selfcheck) / nfock:.3f}")
                if got != want:
                    return f"launches {got}, expected {want}"
                if ref_niter is not None and res.niter != ref_niter:
                    return f"{res.niter} iterations, helfem_tpu {ref_niter}"
                return "" if res.converged and abs(dE) < LAPL_GATE else \
                    "did not converge within the gate"

            counts[label] = run_cli(mains[prog], argv + extra, label, list(XC), check)

    n2 = DiatomicBasis(**BR_N2_BASIS)
    n2_ops = n2.build_operators(dev)
    kernels.reset_launches()
    res = scf_diatomic(n2, 7, 7, method="mgga_x_br89", convthr=1e-8, shift=1.0, ops=n2_ops)
    torch.cuda.synchronize()
    got = {name: kernels.launches[name] for name in XC}
    dE = res.E - N2_SHIFT_REF[0]
    print(f"N2 BR89 shift 1.0: E {res.E:.12f}, E - helfem_tpu = {dE:+.3e}, {res.niter} "
          f"iterations (helfem_tpu {N2_SHIFT_REF[1]}), launches {got}")
    if not (res.converged and abs(dE) < LAPL_GATE and res.niter == N2_SHIFT_REF[1]
            and got == {name: res.niter for name in XC}):
        raise RuntimeError("N2 BR89 with the level shift disagrees with helfem_tpu")
    counts["N2 BR89 shift"] = got

    for label, Z, nel in (("Ar BR89", 18, (9, 9)), ("N UKS BR89", 7, (5, 2))):
        basis = AtomicBasis(Z=Z, lmax=1, mmax=1, rmax=30.0, nelem=6, nnodes=8)
        ops, grid = basis.build_operators(dev), build_atomic_grid(basis, dev, lapl=True)

        def run(basis=basis, ops=ops, grid=grid, nel=nel):
            return scf_atom(basis, *nel, method="mgga_x_br89", convthr=1e-8, guess="TF",
                            ops=ops, grid=grid)

        per = profile_scf(label, run, kernels=XC_SASS + RADIAL_SASS, ops=(EIGH_OP,),
                          ranges={"xc_eval": ("xc_eval", "autograd::engine::evaluate")},
                          walls=1)
        busy = per["busy"][0]
        shares = {name: per[key][0] for name, key in
                  (("eigh", EIGH_OP), ("K4", XC_SASS[0]), ("K5", XC_SASS[1]),
                   ("xc_eval", "xc_eval"))}
        other = busy - sum(shares.values())
        print(f"{label}: device time per warm SCF {busy:.4f} ms; "
              + ", ".join(f"{k} {v:.4f} ms ({100 * v / busy:.1f} %)" for k, v in shares.items())
              + f", the rest {other:.4f} ms ({100 * other / busy:.1f} %); K4/K5 launches "
              f"{per[XC_SASS[0]][1]}/{per[XC_SASS[1]][1]}")
        results[("lapl_scf", label)] = {"busy_ms": busy, **{f"{k}_ms": v for k, v in
                                                            shares.items()}}
        del ops, grid
        torch.cuda.empty_cache()
    return counts


def pair_window_inputs(basis, ops, symm: int, seed: int) -> torch.Tensor:
    """The channel-pair windows [npairs, nrad, nrad] that the exchange of
    symmetry `symm` (0 or 1) hands its kernel, of a random symmetric
    density over the symmetry's blocks (numpy seed); the off-diagonal
    pairs' windows are not symmetric."""
    from helfem_tpu_torch.models.atomic import _pair_windows, channel_pairs

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((basis.nbf, basis.nbf))
    P = np.zeros_like(X)
    for idx in basis.sym_blocks(symm):
        P[np.ix_(idx, idx)] = (X + X.T)[np.ix_(idx, idx)]
    pairs = channel_pairs(basis.mval, symm)
    Pw = _pair_windows(torch.tensor(P, device=ops.device), basis.nang, basis.nrad, pairs)
    Pw = Pw.reshape(-1, basis.nrad, basis.nrad).contiguous()
    if not float((Pw - Pw.transpose(1, 2)).abs().max()) > 0.0:
        raise RuntimeError("pair_window_inputs: the channel-pair windows came out symmetric")
    return Pw


def field_kernels(dev, results: dict) -> None:
    """The kernels on phase 20's new inputs against their plain versions
    (1e-12 x max-abs, the same bits twice, one launch per call), into
    results[(name, key)]: K1 on the channel-pair windows of the Ar lmax=3
    field basis at symmetry 1 (the same-m pairs) and 0 (all nang^2), on
    the Coulomb tables and (symmetry 1) on the Yukawa tables at
    FIELD_LAMBDA against the pairwise plain version; K10 on the symmetry-1
    windows of the Ne LC-LDA field basis at RS_OMEGA; K4/K5 on the Ar field
    grid with same-m cross-l densities, one and two spins; K3 and K6 on
    N2's merged g/u blocks (the bench basis under Ez)."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    def check(key, name, args, moved, flops, plain=None):
        same_bits_twice(name, args)
        results[(name, key)] = report(key, name, compare(name, args, moved, flops, plain=plain))

    t0 = time.perf_counter()
    ar = AtomicBasis(**FIELD_SHAPES["ar_l3"])
    ops = ar.build_operators(dev)
    yuk = ar.build_yukawa(FIELD_LAMBDA, dev)
    torch.cuda.synchronize()
    print(f"ar_l3: nang {ar.nang}, nrad {ar.nrad}, NL {ar.NL}; operators and Yukawa tables "
          f"built in {time.perf_counter() - t0:.2f} s")
    zero = torch.zeros((ar.NL, 1, ar.nrad, ar.nrad), dtype=torch.float64, device=dev)
    for symm in (1, 0):
        Pw = pair_window_inputs(ar, ops, symm, 211 + symm)
        print(f"ar_l3 symmetry {symm}: {Pw.shape[0]} channel-pair windows")
        args, moved, flops = atomic_kernel_work(ops.tei, ops.disjL, ops.disjm1L, ops.Lfac,
                                                ops.gidx, zero, Pw)["radial_exchange"]
        check(f"field_s{symm}", "radial_exchange", args, moved, flops)
        if symm == 1:
            args, moved, flops = atomic_kernel_work(yuk.tei, yuk.iL, yuk.kL, yuk.Lfac, ops.gidx,
                                                    zero, Pw)["radial_exchange"]
            check("field_yukawa", "radial_exchange", args, moved, flops,
                  plain=kernels.radial_exchange_pairwise_plain)
    del ops, yuk, args
    ne = AtomicBasis(**FIELD_SHAPES["ne_l2"])
    ops = ne.build_operators(dev)
    rs = ne.build_erfc(RS_OMEGA, dev)
    for symm, key in ((1, "field_ne"), (0, "field_ne_s0")):
        Pw = pair_window_inputs(ne, ops, symm, 223 + 2 * (1 - symm))
        print(f"ne_l2 symmetry {symm}: {Pw.shape[0]} channel-pair windows")
        args, moved, flops = erfc_exchange_work(rs.tei, ops.gidx, Pw)["radial_erfc_exchange"]
        check(key, "radial_erfc_exchange", args, moved, flops)
        results[("erfc_details", key)] = erfc_details(
            key, args, results[("radial_erfc_exchange", key)])
    del ops, rs, args
    for ns in (1, 2):
        for name, (args, moved, flops) in atomic_xc_inputs("ar_l3", dev, ns).items():
            check(f"field_ar_l3_{ns}", name, args, moved, flops)
    n2 = DiatomicBasis(**DIA_SHAPES["n2"])
    ops = n2.build_operators(dev, parity=False)
    args, moved, flops = coulomb_dia_inputs(n2, ops, block_density(n2, dev, 227, parity=False),
                                            n2.njbd)
    check("field_n2_merged", "radial_coulomb_dia", args, moved, flops)
    rng = np.random.default_rng(229)
    Co = np.zeros((n2.nbf, 7))
    for k, idx in enumerate(n2.sym_blocks(False)[:3]):  # columns of one merged block each
        Co[idx, 2 * k:2 * k + 2 + (k == 2)] = rng.standard_normal((len(idx), 2 + (k == 2)))
    Co = torch.tensor(Co, device=dev)
    for name, (args, moved, flops) in exchange_inputs(n2, ops, Co, dense=False).items():
        results[(name, "field_n2_merged")] = report(
            "field_n2_merged", name, compare(name, args, moved, flops))
    del ops, args
    torch.cuda.empty_cache()
    print("phase 20 kernels: one launch per call, the same bits twice")


def field_launches(prog: str, argv: list[str], n: int, spins: int = 1) -> dict:
    """The launches a field cell's SCF of n iterations must make: K2 (atoms)
    or K3 (diatomics) once per iteration; an atom's K1 once per Fock build
    for kfull != 0 and once more for the Yukawa kernel, K10 once for an
    erfc method (both spins in one launch); a diatomic's K6 once per spin
    with electrons (`spins`; once when restricted) for HF; K4 and K5 once
    for a functional (the atomic CLI's K5 twice more, for its grid
    self-check)."""
    from helfem_tpu_torch.ops.xc import parse_method_rs

    spec = parse_method_rs(argv[argv.index("--method") + 1] if "--method" in argv else "HF")
    xc = {"dia_xc_fields": n, "dia_xc_fock": n + (2 if prog == "atomic" else 0)} \
        if spec.funcs else {}
    if prog == "atomic":
        erfc = spec.kshort != 0.0 and spec.kernel == "erfc"
        yukawa = spec.kshort != 0.0 and not erfc
        return {"radial_coulomb": n, "radial_exchange": n * (bool(spec.kfull) + yukawa),
                "radial_erfc_exchange": n if erfc else 0, **xc}
    return {"radial_coulomb_dia": n, "radial_exchange_dia_occ": n * spins if spec.kfull else 0,
            **xc}


def diatomic_spins(res) -> int:
    """The spins with electrons a diatomic SCF builds an exchange for (one
    when restricted)."""
    return 1 if res.orbs_b is None else 1 + int(np.sum(res.occ_b) > 0)


class ScfCapture:
    """Records the last call of an SCF entry point that a CLI looks up in its
    module at call time (scf_atom, scf_diatomic), so that the same call can
    run again warm on the CLI's own operators, grid and tables."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.call = None

    def __enter__(self):
        def record(*args, **kwargs):
            self.call = (args, kwargs)
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)

    def run(self):
        args, kwargs = self.call
        return self.fn(*args, **{**kwargs, "verbose": False})


def field_phase(dev, results: dict) -> dict:
    """Phase 20: field_kernels, then the FIELD_CELLS through the port's
    atomic and diatomic CLIs, each within FIELD_GATE of helfem_tpu's energy
    in its iteration count with field_launches' launches, each cell's warm
    wall (the same SCF call again on the CLI's operators) and its
    device-busy share (one more SCF under torch.profiler); E(+F) and E(-F)
    of Ar within FIELD_PM_TOL, and the finite-field polarizabilities of
    ALPHA_CELLS beside helfem_tpu's. Returns each cell's launches."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.scf import atomic_scf, diatomic_scf

    phase("20. fields, finite nuclei, confinement and off-centre nuclei: K1 and K10 on "
          "channel-pair windows, K4/K5 on cross-l densities, K3/K6 on merged g/u blocks, then "
          "atoms and diatomics in Ez/Qzz/Bz, with finite nuclei, confined and off-centre "
          "through the CLIs")
    t_phase = time.perf_counter()
    field_kernels(dev, results)
    mains = {"atomic": (atomic_main, atomic_scf, "scf_atom"),
             "diatomic": (diatomic_main, diatomic_scf, "scf_diatomic")}
    counts, energies, warm = {}, {}, {}
    for label, (prog, argv, ref, ref_niter) in FIELD_CELLS.items():
        main, module, entry = mains[prog]

        def check(res, label=label, prog=prog, argv=argv, ref=ref, ref_niter=ref_niter):
            want = field_launches(prog, argv, res.niter,
                                  diatomic_spins(res) if prog == "diatomic" else 1)
            got = {name: kernels.launches[name] for name in want}
            dE = res.E - ref
            print(f"{label}: E - helfem_tpu = {dE:+.3e} (gate {FIELD_GATE:g}), {res.niter} "
                  f"iterations (helfem_tpu {ref_niter}), Efield {res.Efield:+.10e}; launches "
                  f"per iteration {({k: v / res.niter for k, v in got.items()})}")
            energies[label] = res.E
            if got != want:
                return f"launches {got}, expected {want}"
            if res.niter != ref_niter:
                return f"{res.niter} iterations, helfem_tpu {ref_niter}"
            return "" if res.converged and abs(dE) < FIELD_GATE else \
                "did not converge within the gate"

        names = [k for k, v in field_launches(prog, argv, 1).items() if v]
        with ScfCapture(module, entry) as cap:
            counts[label] = run_cli(main, argv, label, names, check)
        warm[label] = warm_wall(label, cap, energies[label], FIELD_GATE)
    dpm = energies["Ar HF Ez=+0.001"] - energies["Ar HF Ez=-0.001"]
    print(f"Ar HF: E(+F) - E(-F) = {dpm:+.3e} (gate {FIELD_PM_TOL:g})")
    if not abs(dpm) < FIELD_PM_TOL:
        raise RuntimeError("Ar HF: E(+F) and E(-F) disagree")
    for name, (zero, plus, minus) in ALPHA_CELLS.items():
        alpha = -(energies[plus] + energies[minus] - 2.0 * energies[zero]) / FIELD_F**2
        ref = -(FIELD_CELLS[plus][2] + FIELD_CELLS[minus][2] - 2.0 * FIELD_CELLS[zero][2]) \
            / FIELD_F**2
        print(f"{name} = {alpha:.6f} au (helfem_tpu {ref:.6f}; F = {FIELD_F:g}); "
              f"E(+F) - E(-F) = {energies[plus] - energies[minus]:+.3e}")
        results[("field_alpha", name)] = alpha
    results[("field_warm", "cells")] = warm
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return counts


class Tee(io.TextIOBase):
    """A stdout that also keeps what passes through it."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text: str) -> int:
        self.out.write(text)
        return self.buf.write(text)

    def flush(self) -> None:
        self.out.flush()


def diis_errors(text: str) -> list[float]:
    """The DIIS errors of an SCF's verbose "iter k ... diis = x" lines."""
    return [float(m) for m in re.findall(r"iter +\d+ +E = .* diis = ([0-9.e+-]+)", text)]


def close_values(label: str, got: dict, ref: dict, scale: float, tol: float = ANALYSIS_TOL) -> str:
    """'' when every value lies within tol of its pin, relative, or of
    `scale` where the pin vanishes by symmetry; else the first miss."""
    for key, want in ref.items():
        if not abs(got[key] - want) <= tol * max(abs(want), scale):
            return f"{label} {key}: {got[key]!r}, helfem_tpu {want!r}"
    return ""


def dia_analysis_miss(got: dict) -> str:
    """'' when N2 HF's diatomic analysis matches N2_HF_ANALYSIS."""
    ref = N2_HF_ANALYSIS
    scale = abs(ref["elquad"])
    flat = {"eldip": (got["eldip"], ref["eldip"]), "elquad": (got["elquad"], ref["elquad"])}
    flat.update({f"nucdens {i}": (g, r) for i, (g, r) in
                 enumerate(zip(got["nucdens"], ref["nucdens"]))})
    if len(got["orbitals"]) != len(ref["orbitals"]):
        return f"{len(got['orbitals'])} occupied orbitals, helfem_tpu {len(ref['orbitals'])}"
    flat.update({f"orbital {i} column {j}": (g, r) for i, (grow, rrow) in
                 enumerate(zip(got["orbitals"], ref["orbitals"]))
                 for j, (g, r) in enumerate(zip(grow, rrow))})
    return close_values("N2 HF", {k: g for k, (g, _) in flat.items()},
                        {k: r for k, (_, r) in flat.items()}, scale, DIA_ANALYSIS_TOL)


def control_kernels(dev, results: dict) -> None:
    """The kernels on phase 21's new inputs against their plain versions
    (1e-12 x max-abs, the same bits twice, one launch per call), into
    results[(name, key)]: K1/K2 on the zeroder Hermite basis of Ar (its
    last element holds trash slots), K1/K2 and K4/K5 (one spin) on the
    finite-nucleus sub-grid of gensap Kr, K1 on all channel-pair windows of
    the Ar bench basis (symmetry 0)."""
    from helfem_tpu_torch.kernels import owner_table
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.models.atomic import AtomicBasis

    def check(key, name, args, moved, flops):
        same_bits_twice(name, args)
        results[(name, key)] = report(key, name, compare(name, args, moved, flops))

    zd = AtomicBasis(**CONTROL_SHAPES["ar_zeroder"])
    gidx = zd.rb.fem.gidx
    print(f"ar_zeroder: nprim {gidx.shape[1]}, nrad {zd.nrad}, trash slots in the last element "
          f"{int((gidx[-1] == zd.nrad).sum())}; owners of the last radial index "
          f"{owner_table(gidx, zd.nrad)[-1].tolist()}")
    for name, (args, moved, flops) in kernel_inputs(CONTROL_SHAPES["ar_zeroder"], dev).items():
        check("ctrl_ar_zeroder", name, args, moved, flops)
    kr = sadatom.SadAtomBasis(**CONTROL_SAD_SHAPES["sad_kr_gauss"])
    ops = kr.build_ops(dev)
    print(f"sad_kr_gauss: nrad {kr.nrad}, {kr.rb.fem.nelem} elements, the smallest "
          f"{kr.rb.fem.lengths.min():.3e} bohr wide")
    for name, (args, moved, flops) in sad_kernel_inputs(kr, ops).items():
        check("ctrl_sad_kr_gauss", name, args, moved, flops)
    for name, (args, moved, flops) in atomic_xc_inputs("sad_kr_gauss", dev, ns=1).items():
        check("ctrl_sad_kr_gauss", name, args, moved, flops)
    del ops
    ar = AtomicBasis(**SHAPES["ar"])
    ops = ar.build_operators(dev)
    Pw = pair_window_inputs(ar, ops, 0, 233)
    zero = torch.zeros((ar.NL, 1, ar.nrad, ar.nrad), dtype=torch.float64, device=dev)
    args, moved, flops = atomic_kernel_work(ops.tei, ops.disjL, ops.disjm1L, ops.Lfac, ops.gidx,
                                            zero, Pw)["radial_exchange"]
    print(f"ar_pairs: {Pw.shape[0]} channel-pair windows")
    check("ctrl_ar_pairs", "radial_exchange", args, moved, flops)
    del ops, args
    torch.cuda.empty_cache()
    print("phase 21 kernels: one launch per call, the same bits twice")


def warm_wall(label: str, cap, energy: float, gate: float = CONTROL_GATE) -> dict:
    """The warm wall of a captured SCF call, and its device-busy share (one
    more run under torch.profiler); raises when its energy lies more than
    gate from `energy`."""
    from helfem_tpu_torch.utils.profiling import busy_wall

    t0 = time.perf_counter()
    res = cap.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pwall, busy = busy_wall(cap.run)
    n = getattr(res, "niter", 0) or 1
    print(f"{label}: warm SCF wall {wall:.4f} s in {res.niter} iterations "
          f"({1e3 * wall / n:.2f} ms each); device busy {busy:.4f} s of the profiled "
          f"{pwall:.4f} s ({100 * busy / pwall:.1f} %)")
    if abs(res.E - energy) > gate:
        raise RuntimeError(f"{label}: the warm SCF's energy is {res.E - energy:+.3e} off")
    return {"wall_s": wall, "niter": res.niter, "busy_share": busy / pwall}


def control_phase(dev, results: dict) -> dict:
    """Phase 21: control_kernels, then CONTROL_CELLS through the port's CLIs
    (within CONTROL_GATE of helfem_tpu's energy in its iteration count, with
    field_launches' launches or sad_launches'; the analysis values within
    ANALYSIS_TOL of CONTROL_ANALYSIS and N2_HF_ANALYSIS, gensap's Econf and
    table sums of GENSAP_TABLES), the warm start from a density with
    cross-channel blocks (one more K1 and K2 launch, for the guess's
    Fock), each cell's warm wall and device-busy share, and the DIIS
    repair's cell with its DIIS errors beside helfem_tpu's. Returns each
    cell's launches."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.cli.gensap import main as gensap_main
    from helfem_tpu_torch.models import sadatom
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.scf import atomic_scf, diatomic_scf
    from helfem_tpu_torch.utils.linalg import build_blocks

    phase("21. SCF controls: K1/K2 on a zeroder Hermite basis and on the SAD finite-nucleus "
          "sub-grid with K4/K5, K1 on all channel-pair windows, then --diag 0, --eigiter, "
          "--perturb, --maverage, --readocc, --symmetry, --zeroder, a warm start, gensap's "
          "finite nucleus and confinement and the post-SCF analysis through the CLIs")
    t_phase = time.perf_counter()
    control_kernels(dev, results)
    mains = {"atomic": (atomic_main, atomic_scf, "scf_atom"),
             "diatomic": (diatomic_main, diatomic_scf, "scf_diatomic"),
             "gensap": (gensap_main, sadatom, "solve_sadatom")}
    counts, warm = {}, {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with open("occs_O.txt", "w") as f:
                f.write(O_READOCC)
            with open("occs.dat", "w") as f:
                f.write(N2_READOCC)
            for label, (prog, argv, ref, ref_niter) in CONTROL_CELLS.items():
                main, module, entry = mains[prog]
                argv = ["occs_O.txt" if a == "OCCS" else a for a in argv]
                if prog == "gensap":
                    argv = argv + ["--output", f"{tmp}/result_Kr.dat"]

                def check(res, label=label, prog=prog, argv=argv, ref=ref, ref_niter=ref_niter):
                    dE = res.E - ref
                    gate = CONTROL_GATES.get(label, CONTROL_GATE)
                    if prog == "gensap":
                        sad_launches(label, res, hf=False)
                        Econf, sums = GENSAP_TABLES[label]
                        table = np.loadtxt(f"{tmp}/result_Kr.dat")
                        far = table[:, 0] >= 1e-3
                        got = table[far][:, TABLE_COLUMNS]
                        miss = np.abs(got.sum(0) - np.array(sums)) / np.abs(got).sum(0)
                        print(f"{label}: E - helfem_tpu = {dE:+.3e} (gate {CONTROL_GATE:g}), "
                              f"{res.niter} iterations, {res.nfock} Fock builds; Econf "
                              f"{res.Econf:.9f}; the table's column sums against helfem_tpu's, "
                              f"relative {miss.max():.2e} (gate {TABLE_TOL:g})")
                        if Econf is not None and abs(res.Econf - Econf) > CONTROL_GATE:
                            return f"Econf {res.Econf!r}, helfem_tpu {Econf!r}"
                        if not miss.max() < TABLE_TOL:
                            return "the SAP table's sums disagree with helfem_tpu's"
                        return "" if res.converged and abs(dE) < CONTROL_GATE else \
                            "did not converge within the gate"
                    want = field_launches(prog, argv, res.niter,
                                          diatomic_spins(res) if prog == "diatomic" else 1)
                    got = {name: kernels.launches[name] for name in want}
                    print(f"{label}: E - helfem_tpu = {dE:+.3e} (gate {gate:g}), "
                          f"{res.niter} iterations (helfem_tpu {ref_niter}); launches per "
                          f"iteration {({k: v / res.niter for k, v in got.items()})}")
                    if got != want:
                        return f"launches {got}, expected {want}"
                    if res.niter != ref_niter:
                        return f"{res.niter} iterations, helfem_tpu {ref_niter}"
                    if label in CONTROL_ANALYSIS:
                        ref_ana = CONTROL_ANALYSIS[label]
                        miss = close_values(label, res.analysis, ref_ana, ref_ana["<r^2>"])
                        if miss:
                            return miss
                        print(f"{label}: the analysis within {ANALYSIS_TOL:g} of helfem_tpu's "
                              f"(cusp {res.analysis['cusp']:.10f})")
                    if label == "N2 HF":
                        miss = dia_analysis_miss(res.analysis)
                        if miss:
                            return miss
                        print(f"{label}: the moments, nuclear densities and occupied orbitals "
                              f"within {DIA_ANALYSIS_TOL:g} of helfem_tpu's")
                    return "" if res.converged and abs(dE) < gate else \
                        "did not converge within the gate"

                names = (["radial_coulomb", *XC] if prog == "gensap" else
                         [k for k, v in field_launches(prog, argv, 1).items() if v])
                with ScfCapture(module, entry) as cap:
                    counts[label] = run_cli(main, argv, label, names, check)
                warm[label] = warm_wall(label, cap, ref, CONTROL_GATES.get(label, CONTROL_GATE))
        finally:
            os.chdir(cwd)

    # the warm start: the Ar density in a field (symmetry 1, s-p0 blocks)
    # into a symmetry-2 run, whose guess Fock runs K1 on all pair windows
    basis = AtomicBasis(**SHAPES["ar"])
    ops = basis.build_operators(dev)
    (E0, n0), (E1, n1) = WARM_START_REFS
    res0 = atomic_scf.scf_atom(basis, 9, 9, convthr=1e-9, guess="TF", Ez=0.001, ops=ops)
    bi = build_blocks(basis.overlap(), basis.sym_blocks(1))[0]
    Pb = np.einsum("bpk,bk,bqk->bpq", res0.orbs_a, res0.occ_a, res0.orbs_a)
    P = np.zeros((basis.nbf + 1, basis.nbf + 1))
    for b in range(bi.shape[0]):
        P[np.ix_(bi[b], bi[b])] += Pb[b]
    P = P[:basis.nbf, :basis.nbf]
    cross = float(np.abs(P.reshape(basis.nang, basis.nrad, basis.nang, basis.nrad)[0, :, 1]).max())
    kernels.reset_launches()
    with ScfCapture(atomic_scf, "scf_atom") as cap:
        res = atomic_scf.scf_atom(basis, 9, 9, convthr=1e-9, guess="TF", P0a=P, ops=ops)
    torch.cuda.synchronize()
    got = {name: kernels.launches[name] for name in ATOMIC}
    ana = atomic_scf.atomic_analysis(basis, res, res.symm_used)
    print(f"Ar HF in Ez = 0.001: E - helfem_tpu = {res0.E - E0:+.3e} in {res0.niter} iterations "
          f"(helfem_tpu {n0}); its density's s-p0 block up to {cross:.3e}; the warm start: E - "
          f"helfem_tpu = {res.E - E1:+.3e} in {res.niter} iterations (helfem_tpu {n1}), "
          f"launches {got}")
    miss = close_values("warm start", ana, WARM_START_ANALYSIS, WARM_START_ANALYSIS["<r^2>"])
    if not (res0.converged and abs(res0.E - E0) < CONTROL_GATE and res0.niter == n0
            and res.converged and abs(res.E - E1) < CONTROL_GATE and res.niter == n1
            and cross > 1e-6 and not miss
            and got == {name: res.niter + 1 for name in ATOMIC}):
        raise RuntimeError(f"Ar HF warm start disagrees with helfem_tpu, or its launches are "
                           f"not one per iteration and one for the guess's Fock {miss}")
    counts["Ar HF warm start"] = got
    warm["Ar HF warm start"] = warm_wall("Ar HF warm start", cap, E1)
    del ops
    torch.cuda.empty_cache()

    # the DIIS B solve's repair at phase 20's first threshold for N2 PBE in Ez
    from helfem_tpu_torch.utils.linalg import reset_warm_counts, warm_counts

    prog, argv, ref, ref_niter = DIIS_CELL
    tee = Tee(sys.stdout)
    reset_warm_counts()
    with contextlib.redirect_stdout(tee):
        res = diatomic_main(argv + ["--device", "cuda"])
    errs = diis_errors(tee.buf.getvalue())
    print(f"N2 PBE Ez=+0.001 at convthr 1e-8: E - helfem_tpu = {res.E - ref:+.3e}, "
          f"{res.niter} iterations (helfem_tpu {ref_niter}); the warm eigensolve "
          f"{warm_counts['warm']} warm, {warm_counts['cold']} cold fallbacks; DIIS errors per "
          f"iteration, the card's then helfem_tpu's:")
    for i in range(max(len(errs), len(DIIS_TRACE_REF))):
        card = f"{errs[i]:.3e}" if i < len(errs) else "-"
        cpu = f"{DIIS_TRACE_REF[i]:.3e}" if i < len(DIIS_TRACE_REF) else "-"
        print(f"    iteration {i + 1:2d}: {card:>10s} {cpu:>10s}")
    if not (res.converged and abs(res.E - ref) < FIELD_GATE):
        raise RuntimeError("N2 PBE Ez=+0.001 at 1e-8 did not converge within 1e-8 Eh")
    results[("control_diis", "n2_pbe_ez")] = {"niter": res.niter, "ref_niter": ref_niter,
                                               "diis": errs}
    results[("control_warm", "cells")] = warm
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return counts


def near(got, ref, tol: float) -> bool:
    """Every value of got within tol relative of ref's."""
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    return got.shape == ref.shape and bool((np.abs(got - ref) <= tol * np.abs(ref)).all())


def hook_report(label: str, res, path: str) -> dict:
    """The crash-recovery hook's calls of a CLI run: their iterations, wall
    per call and the checkpoint's bytes."""
    its = [it for it, _ in res.checkpoint_writes]
    walls = [w for _, w in res.checkpoint_writes]
    size = os.path.getsize(path)
    print(f"{label}: the hook wrote {path} at iterations {its}, {1e3 * np.mean(walls):.3f} ms "
          f"a call (max {1e3 * max(walls):.3f} ms), {size} bytes; the final save "
          f"{1e3 * res.walls['save']:.3f} ms; SCF {res.walls['scf']:.3f} s")
    return {"its": its, "ms_per_call": 1e3 * float(np.mean(walls)), "bytes": size,
            "scf_s": res.walls["scf"]}


def persistence_phase(dev, results: dict, l12) -> dict:
    """Phase 22: Ar HF and N2 PBE saved, reloaded and warm-started through the
    port's CLIs at the bench bases (the Ar warm start also onto nelem 12),
    within PERSIST_GATE of helfem_tpu's energies in its iteration counts,
    the hook at helfem_tpu's iterations, K1/K2 and K3-K5 once per iteration
    and once more for the warm guess's Fock; diatomic_dline, diatomic_dgrid
    and diatomic_cpl on the card's N2 checkpoint against helfem_tpu's
    output on its own (PROGRAM_TOL); the hook's cost on N2 HF at the
    lmax=12 basis (l12: phase 11's basis and operators); the one-electron
    programs, diatomic_cbasis and gensap Kr --completeness against
    helfem_tpu's values; and the HDF5 checkpoints' ImportError without
    h5py. Returns each run's launches."""
    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli import (
        atomic_1e,
        diatomic_1e,
        diatomic_cbasis,
        diatomic_cpl,
        diatomic_dgrid,
        diatomic_dline,
        harmonic,
        softcoulomb,
    )
    from helfem_tpu_torch.cli._common import crash_hook
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.cli.gensap import main as gensap_main
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic
    from helfem_tpu_torch.utils.checkpoint import save_diatomic

    phase("22. persistence and the programs: Ar HF and N2 PBE saved, reloaded and warm-started "
          "through the CLIs, the post-processing programs on the card's N2 checkpoint, the "
          "hook's cost at lmax=12, the one-electron programs and gensap --completeness")
    t_phase = time.perf_counter()
    counts, report = {}, {}
    per_iter = {"atomic": ATOMIC, "diatomic": XC_K3}
    mains = {"atomic": atomic_main, "diatomic": diatomic_main}
    cold = {}

    def saved(kind, label, argv, path, pin):
        """A cold run that writes its checkpoint at every hook call."""
        def check(res):
            print(f"{label}: E - the port's pin {res.E - pin:+.3e}")
            return "" if res.converged and abs(res.E - pin) < 1e-10 else \
                "did not converge within 1e-10 Eh of the port's pinned value"

        kept = {}

        def main(a):
            kept["res"] = mains[kind](a)
            return kept["res"]

        counts[label] = run_cli(main, argv + ["--save", path], label, list(per_iter[kind]),
                                check, per_iter=per_iter[kind])
        cold[kind] = kept["res"]
        report[label] = hook_report(label, kept["res"], path)
        return kept["res"]

    def warm(kind, label, argv):
        """A warm start: helfem_tpu's energy and iteration count, the kernels
        once per iteration and once more for the guess's Fock."""
        E, niter = PERSIST_WARM[label]
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = mains[kind](argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: kernels.launches[name] for name in per_iter[kind]}
        base = cold[kind]
        print(f"{label}: E - helfem_tpu = {res.E - E:+.3e} (gate {PERSIST_GATE:g}) in "
              f"{res.niter} iterations (helfem_tpu {niter}; the cold run {base.niter}); load and "
              f"projection {res.walls['load']:.3f} s, SCF {res.walls['scf']:.3f} s (cold "
              f"{base.walls['scf']:.3f} s), whole CLI {wall:.3f} s; launches in this warm SCF "
              f"{got}")
        if not (res.converged and abs(res.E - E) < PERSIST_GATE and res.niter == niter):
            raise RuntimeError(f"{label}: not within {PERSIST_GATE:g} Eh of helfem_tpu in its "
                               "iteration count")
        if got != {name: res.niter + 1 for name in per_iter[kind]}:
            raise RuntimeError(f"{label}: launches {got}, not once per iteration and once for "
                               "the guess's Fock")
        counts[label] = got
        report[label] = {"niter": res.niter, "scf_s": res.walls["scf"],
                         "load_s": res.walls["load"], "cli_s": wall}

    saved("atomic", "Ar HF saved", AR_CLI, "ar.npz", AR_HF_PORT)
    if report["Ar HF saved"]["its"] != AR_HOOK_ITS:
        raise RuntimeError(f"Ar HF: the hook ran at {report['Ar HF saved']['its']}, helfem_tpu's "
                           f"at {AR_HOOK_ITS}")
    warm("atomic", "Ar HF warm, same basis", AR_CLI + ["--load", "ar.npz", "--save", ""])
    warm("atomic", "Ar HF warm, nelem 12", AR_FINE_CLI + ["--load", "ar.npz", "--save", ""])
    saved("diatomic", "N2 PBE saved", N2_CLI, "n2.npz", N2_PBE_PORT)
    warm("diatomic", "N2 PBE warm, same basis", N2_CLI + ["--load", "n2.npz"])

    # the post-processing programs on the card's checkpoint
    t0 = time.perf_counter()
    z, n = diatomic_dline.main(["--load", "n2.npz", "--npts", "101", "--device", "cuda"])
    _, _, ng = diatomic_dgrid.main(["--load", "n2.npz", "--nz", "60", "--nrho", "30",
                                    "--device", "cuda"])
    diatomic_cpl.main(["--load", "n2.npz", "--nexp", "7", "--completeness", "1",
                       "--device", "cuda"])
    ng = ng.ravel()
    got = [n[i] for i in DLINE_PINS] + [ng.sum()] + [ng[i] for i in list(DGRID_PINS)[1:]]
    ref = list(DLINE_PINS.values()) + list(DGRID_PINS.values())
    cpl_got, cpl_ref = [], []
    for name, rows in CPL_PINS.items():
        table = np.loadtxt(name)
        for row, vals in rows.items():
            cpl_got += list(table[row, 1:3])
            cpl_ref += list(vals)
    miss = max(np.abs(np.array(got + cpl_got) / np.array(ref + cpl_ref) - 1.0))
    print(f"dline, dgrid and cpl on the card's n2.npz: {time.perf_counter() - t0:.3f} s; the "
          f"pinned values within {miss:.2e} relative of helfem_tpu's on its own checkpoint "
          f"(gate {PROGRAM_TOL:g})")
    if not (near(got, ref, PROGRAM_TOL) and near(cpl_got, cpl_ref, PROGRAM_TOL)):
        raise RuntimeError("the post-processing programs disagree with helfem_tpu's output")

    # the hook at the largest supported width: N2 HF lmax=12 from the core guess
    big, big_ops = l12
    save_cb, writes = crash_hook("l12.npz", big, save_diatomic)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = scf_diatomic(big, 7, 7, method="HF", convthr=1e-7, maxit=50, ops=big_ops,
                       save_cb=save_cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_per_iteration("N2 HF lmax=12 with the hook", res, kernels.launches, K3)
    hook = [w for _, w in writes]
    size = os.path.getsize("l12.npz")
    print(f"N2 HF lmax=12 with the hook: E - CUDA-core value {res.E - N2_L12_CUDA_CORES:+.3e} "
          f"in {res.niter} iterations, SCF wall {wall:.3f} s; the hook at "
          f"{[it for it, _ in writes]}, {1e3 * np.mean(hook):.1f} ms a call (max "
          f"{1e3 * max(hook):.1f} ms, {100 * sum(hook) / wall:.1f} % of the wall), {size} "
          "bytes a file")
    if not (res.converged and abs(res.E - N2_L12_CUDA_CORES) < 1e-8):
        raise RuntimeError("N2 HF lmax=12 with the hook: not within 1e-8 Eh of its pin")
    report["N2 HF lmax=12 hook"] = {"its": [it for it, _ in writes], "bytes": size,
                                    "ms_per_call": 1e3 * float(np.mean(hook)), "scf_s": wall}
    counts["N2 HF lmax=12 hook"] = {name: kernels.launches[name]
                                    for name in (*K3, "radial_exchange_dia_occ")}

    # the one-electron programs, diatomic_cbasis and gensap Kr --completeness
    t0 = time.perf_counter()
    mains_1e = {"atomic_1e": atomic_1e.main, "diatomic_1e": diatomic_1e.main,
                "harmonic": harmonic.main, "softcoulomb": softcoulomb.main}
    for name, (argv, ref) in ONE_E.items():
        out = mains_1e[name](argv + ["--device", "cuda"])
        got = (list(out["E_0"][:3]) + list(out["E_1"][:2]) if name == "atomic_1e"
               else list(out))
        if not near(got, ref, ONE_E_TOL):
            raise RuntimeError(f"{name}: {got}, helfem_tpu's {ref}")
        if name == "atomic_1e" and max(abs(got[0] + 0.5), abs(got[1] + 0.125),
                                       abs(got[3] + 0.125)) > 1e-10:
            raise RuntimeError("atomic_1e: the hydrogenic 1s, 2s, 2p not within 1e-10 Eh")
    scan = diatomic_cbasis.main(CBASIS_CLI + ["--device", "cuda"])
    if scan != CBASIS_REF:
        raise RuntimeError(f"diatomic_cbasis: {scan}, helfem_tpu's {CBASIS_REF}")
    res = gensap_main(KR_GENSAP_CLI + ["--completeness", "--output", "result_Kr.dat",
                                       "--device", "cuda"])
    for name, rows in KR_COMPLETENESS.items():
        table = np.loadtxt(name)
        tol = KR_IMPORTANCE_TOL if name.startswith("importance") else PROGRAM_TOL
        for row, vals in rows.items():
            if not near(table[row, 1:1 + len(vals)], vals, tol):
                raise RuntimeError(f"gensap Kr {name} row {row}: {table[row]}, helfem_tpu's "
                                   f"{vals}")
    if abs(res.E - KR_GENSAP_PORT) > 1e-8:
        raise RuntimeError("gensap Kr --completeness: E off the port's pin")
    print(f"atomic_1e, diatomic_1e, harmonic, softcoulomb within {ONE_E_TOL:g} relative, "
          f"diatomic_cbasis's lmax list {scan[-1]} at 1e-5 as helfem_tpu's, gensap Kr's "
          f"profiles as helfem_tpu's: {time.perf_counter() - t0:.3f} s")

    # HDF5 checkpoints need h5py, which the card machine lacks
    try:
        import h5py  # noqa: F401
        print("h5py is installed here: the HDF5 checkpoints are checked on the CPU "
              "(tests/test_torch_checkpoint.py)")
    except ImportError:
        try:
            atomic_main(["--Z", "He", "--lmax", "0", "--mmax", "0", "--nelem", "3", "--nnodes",
                         "5", "--save", "he.chk", "--device", "cuda"])
        except ImportError as exc:
            if "h5py" not in str(exc) or os.path.exists("he.chk.crash.npz"):
                raise
            print(f"--save he.chk without h5py: ImportError ({exc}); HDF5 is checked on the "
                  "CPU only (tests/test_torch_checkpoint.py)")
        else:
            raise RuntimeError("--save he.chk ran without h5py")
    results[("persistence", "report")] = report
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return counts


# phase 23: helfem_tpu's --ndev values on the CPU in f64, (energy, iterations),
# made from the repository root with JAX_PLATFORMS=cpu and
# XLA_FLAGS=--xla_force_host_platform_device_count=2 by
#   python -m helfem_tpu.cli.atomic --Z Ar --lmax 1 --mmax 1 --nelem 10 --nnodes 15 \
#       --Rmax 40 --convthr 1e-9 --iguess 3 --ndev N
#   python -m helfem_tpu.cli.diatomic --Z1 N --Z2 N --Rbond 2.0743 --lmax 6,6 --nelem 5 \
#       --nnodes 8 --Rmax 25 --method PBE --convthr 1e-7 --ndev N
# (AR_CLI and N2_CLI) with N = 1 and N = 2. N2 HF at the lmax=12 basis is not
# run there: its operators alone take 3.59 GiB per device.
NDEV1_PINS = {"Ar HF": (-526.8175128027123719, 10), "N2 PBE": (-108.9787084372783852, 10)}
NDEV2_PINS = {"Ar HF": (-526.8175128026996390, 10), "N2 PBE": (-108.9787084372777031, 10)}
NDEV_GATE = 1e-9
# two gloo ranks sharing the card: label -> (kind, basis, electrons per spin,
# SCF keywords), the settings of this script's single-device runs of them
# (phases 4, 6 and 11)
GLOO_CELLS = {
    "Ar HF": ("atomic", SHAPES["ar"], 9, dict(convthr=1e-9, guess="TF")),
    "N2 PBE": ("diatomic", DIA_SHAPES["n2"], 7, dict(method="PBE", convthr=1e-7, maxit=50)),
    "N2 HF lmax=12": ("diatomic", N2_L12_SHAPE, 7, dict(method="HF", convthr=1e-7, maxit=50)),
}
GLOO_KERNELS = {"Ar HF": ATOMIC, "N2 PBE": (*K3, *XC),
                "N2 HF lmax=12": (*K3, "radial_exchange_dia_occ")}
SINGLE = {}  # label -> this script's single-device energy of the same config


def shard_inputs(mesh, kind: str, basis, ops, res, method: str) -> tuple:
    """(the bits of one Fock build over the mesh of the converged density,
    per kernel of the path its (arguments, bytes, operations) on this
    rank's shard, and the whole-operator K6 inputs of the diatomic HF path):
    the density of res's orbitals, its occupied columns for K6, random
    potentials for K5."""
    import hashlib

    from helfem_tpu_torch.models.diatomic_dft import build_dia_grid
    from helfem_tpu_torch.ops.xc import parse_method
    from helfem_tpu_torch.parallel import mesh as pm
    from helfem_tpu_torch.scf.diatomic_scf import density_dia, occ_select, occupied_dia
    from helfem_tpu_torch.utils.linalg import build_blocks, density_blocks

    dev = mesh.device
    funcs, kfrac = parse_method(method)
    funcs = tuple(funcs)
    whole = None
    if kind == "atomic":
        blk = torch.as_tensor(build_blocks(ops.S.cpu().numpy(), basis.sym_blocks(2))[0],
                              device=dev)
        P = density_blocks(torch.as_tensor(res.orbs_a, device=dev),
                           torch.as_tensor(res.occ_a, device=dev), blk, ops.S)
        fock, ol, _ = pm.sharded_atomic_fock(mesh, ops, kfrac=kfrac, restricted=True)
        F = fock(None, P, P)[0]
        nang, nrad = basis.nang, basis.nrad
        P4 = P.reshape(nang, nrad, nang, nrad).permute(0, 2, 1, 3)
        a = torch.arange(nang, device=dev)
        Paux = torch.einsum("LMab,abIJ->LMIJ", ol.G, P4).contiguous()
        inputs = atomic_kernel_work(ol.tei, ol.disjL, ol.disjm1L, ol.Lfac, ol.gidx, Paux,
                                    P4[a, a].contiguous())
    else:
        P = torch.as_tensor(density_dia(ops, res.orbs_a, res.occ_a), device=dev)
        Co = occupied_dia(ops, torch.as_tensor(res.orbs_a, device=dev),
                          occ_select(res.occ_a, dev))
        g = build_dia_grid(basis, dev) if funcs else None
        fock, _, gl = pm.sharded_dia_scf_fock(mesh, ops, funcs, g, kfrac, restricted=True,
                                              njbd=basis.njbd)
        F = fock(P, P, Co if kfrac else None)[0]
        lo, hi = mesh.range(basis.njbd)
        oj = ops._replace(GmLM=ops.GmLM[lo:hi], GpLM=ops.GpLM[lo:hi], LM_ilm=ops.LM_ilm[lo:hi])
        inputs = {"radial_coulomb_dia": coulomb_dia_inputs(basis, oj, P, None)}
        if kfrac:
            lo, hi = mesh.range(ops.step_ilm.shape[0])
            ok = ops._replace(**{k: getattr(ops, k)[lo:hi]
                                 for k in ("step_ilm", "step_sp", "step_sm", "step_wm")})
            inputs.update(exchange_inputs(basis, ok, Co, dense=False))
            if mesh.rank == 0:
                whole = exchange_inputs(basis, ops, Co, dense=False)["radial_exchange_dia_occ"]
        if funcs:
            pots = random_potentials(gl, 1, np.random.default_rng(23))
            mask = torch.tensor(basis.shell_mask().reshape(-1), device=dev)
            inputs.update(xc_work(gl, P[None].contiguous(), pots, mask, basis.nrad))
    torch.cuda.synchronize()
    return hashlib.sha256(F.cpu().numpy().tobytes()).hexdigest()[:16], inputs, whole


def phase23_rank(mesh, cells: dict) -> list:
    """One rank of phase 23: each cell's SCF over the mesh (every rank
    building the operators on its device), then its record: energy,
    iterations, the SCF wall, each kernel's launches in the SCF, the
    all_reduce calls, bytes and wall (synchronised around each), the bits
    of one Fock build, and each kernel's CUDA-event ms per call on this
    rank's shard, the ranks in turns so that each has the card alone (rank
    0 also times K6 on all the exchange steps). Every rank's records, in
    rank order."""
    import torch.distributed as dist

    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

    out = {}
    for label, (kind, cfg, nel, kw) in cells.items():
        atom = kind == "atomic"
        t0 = time.perf_counter()
        basis = (AtomicBasis if atom else DiatomicBasis)(**cfg)
        ops = basis.build_operators(mesh.device)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        mesh.timed = True
        mesh.stats.update(all_reduce=0, all_reduce_bytes=0, all_reduce_s=0.0)
        kernels.reset_launches()
        dist.barrier()
        t0 = time.perf_counter()
        res = (scf_atom if atom else scf_diatomic)(basis, nel, nel, ops=ops, ndev=mesh.size,
                                                    **kw)
        torch.cuda.synchronize()
        rec = dict(E=res.E, niter=res.niter, converged=res.converged, setup_s=setup,
                   scf_s=time.perf_counter() - t0,
                   launches={k: v for k, v in kernels.launches.items() if v}, **mesh.stats)
        mesh.timed = False
        rec["bits"], inputs, whole = shard_inputs(mesh, kind, basis, ops, res,
                                                  kw.get("method", "HF"))
        rec["ms"], rec["bound_ms"] = {}, {}
        for turn in range(mesh.size):
            dist.barrier()
            if turn != mesh.rank:
                continue
            for name, (args, moved, flops) in inputs.items():
                kern = getattr(kernels, name)
                rec["ms"][name] = cuda_ms(lambda: kern(*args), 2, 5)
                rec["bound_ms"][name] = 1e3 * max(moved / HBM_BYTES_S, flops / FP64_FLOP_S)
            if whole is not None:
                args = whole[0]
                rec["whole_k6_ms"] = cuda_ms(lambda: kernels.radial_exchange_dia_occ(*args), 2, 5)
        dist.barrier()
        out[label] = rec
        del ops, inputs, whole
        torch.cuda.empty_cache()
    return mesh.gather_objects(out)


def shard_kernels(dev, results: dict) -> None:
    """K1/K2 on the L ranges of two ranks at the Ar bench basis, K3 on two
    ranges of the M = 0 channels, K6 on two ranges of the exchange steps
    and K4/K5 on two element ranges of the grid at the N2 bench basis (the
    owners and band rebuilt from each range's rows), each against its plain
    version (compare: 1e-12 x max-abs) with the same bits twice."""
    from helfem_tpu_torch.models.diatomic import DiatomicBasis
    from helfem_tpu_torch.models.diatomic_dft import build_dia_grid
    from helfem_tpu_torch.parallel.mesh import shard_grid, split_range

    def check(name, shape, args, moved, flops):
        same_bits_twice(name, args)
        results[(name, shape)] = report(shape, name, compare(name, args, moved, flops, 2, 5))

    ar = kernel_inputs(SHAPES["ar"], dev)
    (tei, U, V, gidx, Pd) = ar["radial_exchange"][0]
    Paux, Lfac = ar["radial_coulomb"][0][0], ar["radial_coulomb"][0][4]
    for r in range(2):
        lo, hi = split_range(tei.shape[0], 2, r)
        work = atomic_kernel_work(tei[lo:hi], U[lo:hi], V[lo:hi], Lfac[lo:hi], gidx,
                                  Paux[lo:hi].contiguous(), Pd)
        for name in ATOMIC:
            check(name, f"ar_shard{r}", *work[name])
    basis = DiatomicBasis(**DIA_SHAPES["n2"])
    ops = basis.build_operators(dev)
    P = block_density(basis, dev, 41)
    g = build_dia_grid(basis, dev)
    rng = np.random.default_rng(43)
    m2 = torch.tensor(basis.shell_mask().reshape(-1), device=dev)
    Co = torch.tensor(rng.standard_normal((basis.nbf, 7)), device=dev) * 0.2 * m2[:, None]
    Ps = torch.stack((P, block_density(basis, dev, 42)))
    for r in range(2):
        lo, hi = split_range(basis.njbd, 2, r)
        oj = ops._replace(GmLM=ops.GmLM[lo:hi], GpLM=ops.GpLM[lo:hi], LM_ilm=ops.LM_ilm[lo:hi])
        check("radial_coulomb_dia", f"n2_shard{r}", *coulomb_dia_inputs(basis, oj, P, None))
        lo, hi = split_range(ops.step_ilm.shape[0], 2, r)
        ok = ops._replace(**{k: getattr(ops, k)[lo:hi]
                             for k in ("step_ilm", "step_sp", "step_sm", "step_wm")})
        check("radial_exchange_dia_occ", f"n2_shard{r}",
              *exchange_inputs(basis, ok, Co, dense=False)["radial_exchange_dia_occ"])
        gl = shard_grid(g, *split_range(g.gidx.shape[0], 2, r))
        for name, work in xc_work(gl, Ps, random_potentials(gl, 2, rng), m2,
                                  basis.nrad).items():
            check(name, f"n2_shard{r}", *work)


def parallel_phase(dev, results: dict) -> dict:
    """Phase 23: the kernels on shard shapes (shard_kernels); Ar HF and N2
    PBE (the bench configs) through the CLIs with --ndev 1 (one NCCL rank),
    within NDEV_GATE of helfem_tpu's --ndev 1 values in their iteration
    counts with their kernels once per iteration; then the GLOO_CELLS on two
    gloo ranks sharing the card (launch.spawn, phase23_rank), each within
    NDEV_GATE of this script's single-device run and of helfem_tpu's ndev=2
    value where there is one, both ranks' Fock bits equal and the path's
    kernels once per iteration on each rank; per rank the launches, the
    kernels' ms per call on its shard, the all_reduce wall per iteration
    and the SCF wall. Returns the launches by run."""
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main
    from helfem_tpu_torch.parallel import launch

    phase("23. multi-device: K1-K6 on shard shapes against plain; Ar HF and N2 PBE through the "
          "CLIs with --ndev 1 (NCCL); Ar HF, N2 PBE and N2 HF lmax=12 on two gloo ranks "
          "sharing the card")
    t_phase = time.perf_counter()
    shard_kernels(dev, results)
    counts = {}

    def pinned(label):
        def check(res):
            E, niter = NDEV1_PINS[label]
            print(f"{label} --ndev 1: E - helfem_tpu's --ndev 1 value {res.E - E:+.3e}, "
                  f"{res.niter} iterations against its {niter}")
            ok = res.converged and abs(res.E - E) < NDEV_GATE and res.niter == niter
            return "" if ok else f"not within {NDEV_GATE:g} Eh of helfem_tpu in its iterations"
        return check

    counts["Ar HF --ndev 1"] = run_cli(atomic_main, AR_CLI + ["--ndev", "1", "--save", ""],
                                       "Ar HF --ndev 1", list(ATOMIC), pinned("Ar HF"),
                                       per_iter=ATOMIC)
    counts["N2 PBE --ndev 1"] = run_cli(diatomic_main, N2_CLI + ["--ndev", "1"],
                                        "N2 PBE --ndev 1", list(XC_K3), pinned("N2 PBE"),
                                        per_iter=XC_K3)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records = launch.spawn(phase23_rank, 2, GLOO_CELLS, backend="gloo", device=dev)
    print(f"two gloo ranks: {time.perf_counter() - t0:.1f} s for the three cells, the ranks' "
          "start and the kernels' load included")
    for label in GLOO_CELLS:
        recs = [rank[label] for rank in records]
        for r, rec in enumerate(recs):
            n = rec["niter"]
            print(f"{label}, gloo rank {r} of 2: E = {rec['E']:.12f} in {n} iterations, "
                  f"converged {rec['converged']}; operators {rec['setup_s']:.3f} s, SCF "
                  f"{rec['scf_s']:.3f} s; launches {rec['launches']}; all_reduce "
                  f"{rec['all_reduce']} calls, {rec['all_reduce_bytes'] / max(n, 1) / 1e6:.1f} MB "
                  f"and {1e3 * rec['all_reduce_s'] / max(n, 1):.1f} ms per iteration; Fock bits "
                  f"{rec['bits']}; ms per call on its shard {rec['ms']} (bounds "
                  f"{ {k: round(v, 5) for k, v in rec['bound_ms'].items()} })")
            counts[f"{label} gloo rank {r}"] = dict(rec["launches"])
            wrong = {k: rec["launches"].get(k, 0) for k in GLOO_KERNELS[label]
                     if rec["launches"].get(k, 0) != n}
            if wrong:
                raise RuntimeError(f"{label} rank {r}: launches {wrong}, not one per each of "
                                   f"the {n} iterations")
        if "whole_k6_ms" in recs[0]:
            dev_ms = results[("radial_exchange_dia_occ", "lmax12")]["device_ms"]
            print(f"{label}: K6 ms per call on each rank's half of the steps "
                  f"{[rec['ms']['radial_exchange_dia_occ'] for rec in recs]}, on all the steps "
                  f"{recs[0]['whole_k6_ms']:.4f} (rank 0 alone; phase 3's device ms at the "
                  f"lmax=12 shapes {dev_ms})")
        E, single = recs[0]["E"], SINGLE[label]
        pin = NDEV2_PINS.get(label)
        print(f"{label} on two gloo ranks: E - single-device run {E - single:+.3e}; E - "
              f"helfem_tpu's ndev=2 value "
              f"{'not run on the CPU' if pin is None else f'{E - pin[0]:+.3e}'}")
        if not (all(rec["converged"] for rec in recs) and abs(E - single) < NDEV_GATE
                and (pin is None or abs(E - pin[0]) < NDEV_GATE)
                and len({rec["bits"] for rec in recs}) == 1
                and len({rec["E"] for rec in recs}) == 1):
            raise RuntimeError(f"{label} on two gloo ranks: not converged, not within "
                               f"{NDEV_GATE:g} Eh of the single-device run or of helfem_tpu, "
                               "or the ranks' Fock bits or energies differ")
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> None:
    phase("1. device")
    smi = device_facts()
    dev = torch.device("cuda", 0)

    phase("2. build")
    from helfem_tpu_torch.kernels import _build

    seconds, log = _build.build(ptxas_verbose=True)
    srcs = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    print(f"built {_build.LIBRARY.name} from {srcs} in {seconds:.2f} s, one nvcc per source "
          f"in parallel")
    print("\n".join(line for line in log.splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line))
    print(radial_spills(log))
    _build.lib()
    print(sass_check(_build))

    phase("3. kernels vs plain PyTorch on the card")
    results = {}
    shapes = [(s, kernel_inputs, cfg) for s, cfg in SHAPES.items()]
    shapes += [(s, dia_kernel_inputs, cfg) for s, cfg in DIA_SHAPES.items()]
    for shape, make, cfg in shapes:
        t0 = time.perf_counter()
        inputs = make(cfg, dev)
        print(f"{shape}: operators built in {time.perf_counter() - t0:.2f} s")
        for name, (args, moved, flops) in inputs.items():
            if name in ATOMIC or name == "radial_coulomb_dia":
                same_bits_twice(name, args)
            results[(name, shape)] = report(shape, name, compare(name, args, moved, flops))
    from helfem_tpu_torch.models.diatomic import DiatomicBasis

    for shape, (cfg, prefix) in K3_SHAPES.items():
        t0 = time.perf_counter()
        basis = DiatomicBasis(**cfg)
        ops = basis.build_operators(dev)
        args, moved, flops = coulomb_dia_inputs(basis, ops, block_density(basis, dev, 29),
                                                basis.njbd if prefix else None)
        print(f"{shape}: nprim {ops.gidx.shape[1]}, {args[0].shape[0]} channels, operators "
              f"built in {time.perf_counter() - t0:.2f} s")
        same_bits_twice("radial_coulomb_dia", args)
        results[("radial_coulomb_dia", shape)] = report(
            shape, "radial_coulomb_dia", compare("radial_coulomb_dia", args, moved, flops, 2, 10))
        del ops, args
        torch.cuda.empty_cache()
    print(f"K3 at {list(K3_SHAPES)}: one launch per call, the same bits twice")
    for shape, sizes in WIDE_SHAPES.items():
        for name, (args, moved, flops) in random_atomic_inputs(dev, *sizes).items():
            same_bits_twice(name, args)
            results[(name, shape)] = report(shape, name, compare(name, args, moved, flops, 2, 10))
        torch.cuda.empty_cache()
    print(f"atomic kernels on random tables {WIDE_SHAPES}: one launch per call, the same bits "
          "twice")
    from helfem_tpu_torch.tools.exchange_timing import LIH

    for shape, cfg in {**DIA_SHAPES, "lih": LIH}.items():
        for name, (args, moved, flops) in dia_exchange_inputs(cfg, dev).items():
            results[(name, shape)] = report(shape, name, compare(name, args, moved, flops))
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    inputs = lmax12_exchange_inputs(dev)
    torch.cuda.synchronize()
    print(f"lmax12: random tables of {LMAX12} made in {time.perf_counter() - t0:.2f} s")
    for name, (args, moved, flops) in inputs.items():
        results[(name, "lmax12")] = report("lmax12", name,
                                           compare(name, args, moved, flops, warmup=1, reps=3))
    del inputs, args
    torch.cuda.empty_cache()
    for shape, (nang, npr, nelem, nlm, no) in EXCHANGE_WIDE.items():
        inputs = random_exchange_inputs(dev, nang, npr, nelem, nlm, no, dense_channels=nlm)
        for name, (args, moved, flops) in inputs.items():
            results[(name, shape)] = report(shape, name, compare(name, args, moved, flops, 1, 3))
        del inputs, args
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    inputs = xc_kernel_inputs(DiatomicBasis(**N2_L12_SHAPE), dev, ns=1)
    torch.cuda.synchronize()
    print(f"lmax12: the N2 lmax=12 basis, grid and XC inputs (one spin) made in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (args, moved, flops) in inputs.items():
        results[(name, "lmax12")] = report("lmax12", name,
                                           compare(name, args, moved, flops, warmup=2, reps=10))
    del inputs, args
    torch.cuda.empty_cache()
    for shape in ATOMIC_XC_SHAPES:
        t0 = time.perf_counter()
        inputs = atomic_xc_inputs(shape, dev, ns=1)
        torch.cuda.synchronize()
        print(f"{shape}: the atomic XC grid and its inputs made in "
              f"{time.perf_counter() - t0:.2f} s")
        for name, (args, moved, flops) in inputs.items():
            same_bits_twice(name, args)
            results[(name, shape)] = report(f"{shape} atomic grid", name,
                                            compare(name, args, moved, flops))
    print(f"XC kernels on the atomic grids {list(ATOMIC_XC_SHAPES)}: one launch per call, the "
          "same bits twice")
    del inputs, args
    torch.cuda.empty_cache()
    refine_phase(dev, results)
    refine_real_phase(dev, results)
    probes = {}
    for n in (2048, 4096):
        for (name, prec), r in compare_probes(n, dev).items():
            probes[(name, prec, n)] = report(f"n={n} {prec}", name, r)
            print(f"    library, torch.matmul {LIBRARY_LABEL[prec]}"
                  f"{' (three calls)' if name == 'matmul_dd' else ''}: {r['library_ms']:.4f} ms")

    from helfem_tpu_torch import kernels
    from helfem_tpu_torch.cli.atomic import main as atomic_main
    from helfem_tpu_torch.cli.diatomic import main as diatomic_main

    phase("4. Ar HF through the port's atomic CLI on the card")

    def ar_check(res, label="Ar HF"):
        SINGLE.setdefault(label, res.E)
        dE, dpin = res.E - AR_HF_LIMIT, res.E - AR_HF_PORT
        print(f"{label}: E - HF limit = {dE:+.3e}, E - pinned value = {dpin:+.3e}")
        ok = res.converged and abs(dE) < 1e-6 and abs(dpin) < 1e-10 and np.isfinite(res.E)
        return "" if ok else "did not converge within 1e-6 Eh of the HF limit and 1e-10 Eh " \
            "of the pinned value"

    counts = run_cli(atomic_main, AR_CLI, "Ar HF", [*ATOMIC, "refine_eig"], ar_check,
                     per_iter=ATOMIC)
    sap_kept = {}

    def ar_sap_main(argv):
        sap_kept["res"] = atomic_main(argv)
        return sap_kept["res"]

    # the SAD solve of Ar's SAP table runs inside the CLI (lda_x: K2 only)
    sap = run_cli(ar_sap_main, AR_CLI_SAP, "Ar HF from SAP", list(ATOMIC),
                  lambda res: ar_check(res, "Ar HF from SAP"), per_iter=("radial_exchange",))
    sad_builds = sap["radial_coulomb"] - sap_kept["res"].niter
    xc_sad = {name: kernels.launches[name] for name in XC}
    print(f"Ar HF from SAP: {sad_builds} K2 launches in the SAD solve of Ar's SAP table, "
          f"beside one K1 and one K2 per SCF iteration; K4/K5 there {xc_sad}")
    if sad_builds <= 0 or set(xc_sad.values()) != {sad_builds}:
        raise RuntimeError("Ar HF from SAP: the SAP table's SAD solve did not launch K2, K4 "
                           "and K5 once per Fock build")

    phase("5. warm Ar HF SCF walls and profile")
    from helfem_tpu_torch.models.atomic import AtomicBasis
    from helfem_tpu_torch.scf.atomic_scf import scf_atom
    from helfem_tpu_torch.utils.profiling import profile_scf

    def counted(label, scf, names=XC):
        """scf() with the launch counters reset before it and the kernels
        in names held to one launch per iteration after it."""
        def run():
            kernels.reset_launches()
            res = scf()
            check_per_iteration(label, res, kernels.launches, names)
            return res
        return run

    def k3_per_scf(label, per_kernel):
        """K3's device time per warm SCF, beside K4 + K5's where they ran."""
        ms, n = per_kernel[K3_SASS]
        xc = sum(per_kernel[k][0] for k in XC_SASS if k in per_kernel)
        print(f"{label}: K3 device time per warm SCF {ms:.4f} ms in {n} launches "
              f"({ms / max(n, 1):.4f} ms each); K4 + K5 {xc:.4f} ms")

    def atomic_profile(label, cfg, scf_args):
        basis = AtomicBasis(**cfg)
        ops = basis.build_operators(dev)
        per_kernel = profile_scf(label, counted(f"warm {label}", lambda: scf_atom(
            basis, *scf_args, convthr=1e-9, guess="TF", ops=ops), ATOMIC), kernels=RADIAL_SASS)
        total = sum(per_kernel[k][0] for k in RADIAL_SASS)
        print(f"{label}: K1 + K2 device time per warm SCF {total:.4f} ms, launches "
              f"{[per_kernel[k][1] for k in RADIAL_SASS]}")

    atomic_profile("Ar HF", SHAPES["ar"], (9, 9))

    phase("6. N2 PBE through the port's diatomic CLI on the card")

    def n2_check(res):
        SINGLE.setdefault("N2 PBE", res.E)
        dE = res.E - N2_PBE_REF
        print(f"N2 PBE: E - reference = {dE:+.3e}, E - the port's value "
              f"{res.E - N2_PBE_PORT:+.3e}, Nel on the grid {res.Nelgrid:.12f}")
        ok = (res.converged and abs(dE) < 1e-6 and abs(res.E - N2_PBE_PORT) < 1e-10
              and np.isfinite(res.E))
        return "" if ok else "did not converge to the reference within 1e-6 Eh and to the " \
            "port's value within 1e-10 Eh"

    counts.update(run_cli(diatomic_main, N2_CLI, "N2 PBE",
                          ["radial_coulomb_dia", "dia_xc_fields", "dia_xc_fock"], n2_check,
                          per_iter=XC_K3))
    print(f"N2 PBE: K11 launched {kernels.launches['refine_eig']} times")

    phase("7. warm N2 PBE SCF walls and profile")
    from helfem_tpu_torch.scf.diatomic_scf import scf_diatomic

    n2_basis = DiatomicBasis(**DIA_SHAPES["n2"])
    n2_ops = n2_basis.build_operators(dev)
    k3_per_scf("N2 PBE", profile_scf("N2 PBE", counted("warm N2 PBE", lambda: scf_diatomic(
        n2_basis, 7, 7, method="PBE", convthr=1e-7, maxit=50, ops=n2_ops), XC_K3),
        kernels=(*XC_SASS, K3_SASS)))

    phase("8. N2 HF through the port's diatomic CLI on the card")
    from helfem_tpu_torch.models.diatomic import exchange_dia, exchange_dia_occ
    from helfem_tpu_torch.scf.diatomic_scf import occ_select, occupied_dia
    from helfem_tpu_torch.utils.linalg import density_blocks

    def hf_check(res):
        dE = res.E - N2_HF_REF
        print(f"N2 HF: E - reference = {dE:+.3e}, Exx = {res.Exx:.10f}")
        ok = res.converged and abs(dE) < 1e-6 and np.isfinite(res.E)
        if kernels.launches["radial_exchange_dia"]:
            return "the SCF launched the dense exchange kernel"
        return "" if ok else "did not converge to the reference within 1e-6 Eh"

    kept = {}

    def hf_main(argv):
        kept["res"] = diatomic_main(argv)
        return kept["res"]

    counts.update(run_cli(hf_main, N2_HF_CLI, "N2 HF",
                          ["radial_coulomb_dia", "radial_exchange_dia_occ"], hf_check,
                          per_iter=K3))
    # the P-only entry point on the converged density against the occupied-
    # orbital one on the converged orbitals
    hf_basis = DiatomicBasis(**N2_HF_SHAPE)
    hf_ops = hf_basis.build_operators(dev)
    res = kept["res"]
    Ca = torch.tensor(res.orbs_a, device=dev)
    occ = torch.tensor(res.occ_a, device=dev)
    Pa = density_blocks(Ca, occ, hf_ops.blk_idx, hf_ops.S)
    Co = occupied_dia(hf_ops, Ca, occ_select(res.occ_a, dev))
    kernels.reset_launches()
    Kd = exchange_dia(hf_ops, Pa)
    torch.cuda.synchronize()
    counts["radial_exchange_dia"] = kernels.launches["radial_exchange_dia"]
    Ko = exchange_dia_occ(hf_ops, Co)
    err, scale = float((Kd - Ko).abs().max()), float(Ko.abs().max())
    print(f"exchange_dia(P) vs exchange_dia_occ(Co) on the converged N2 HF state: max-abs "
          f"diff {err:.3e} (scale {scale:.3e}); dense-kernel launches "
          f"{counts['radial_exchange_dia']}")
    if counts["radial_exchange_dia"] == 0 or not err <= REL_TOL * scale:
        raise RuntimeError("exchange_dia disagrees with exchange_dia_occ or never launched")

    phase("9. warm N2 HF SCF walls and profile; N2 PBE0 once")
    k3_per_scf("N2 HF", profile_scf("N2 HF", counted("warm N2 HF", lambda: scf_diatomic(
        hf_basis, 7, 7, method="HF", convthr=1e-7, maxit=50, ops=hf_ops), K3),
        kernels=(K3_SASS,)))

    def pbe0_check(res):
        print(f"N2 PBE0: E = {res.E:.12f}, Exx = {res.Exx:.10f}, Exc = {res.Exc:.10f}, "
              f"Nel on the grid {res.Nelgrid:.12f}")
        ok = res.converged and np.isfinite(res.E) and abs(res.Nelgrid - 14.0) < 1e-5
        return "" if ok else "did not converge"

    pbe0_cli = [a if a != "PBE" else "PBE0" for a in N2_CLI]
    run_cli(diatomic_main, pbe0_cli, "N2 PBE0",
            ["radial_coulomb_dia", "dia_xc_fields", "dia_xc_fock", "radial_exchange_dia_occ"],
            pbe0_check, per_iter=XC_K3)

    phase("10. the f64-ablation tool at n = 2048")
    from helfem_tpu_torch.tools.f64_ablation import main as ablation_main

    kernels.reset_launches()
    ablation = ablation_main(["2048", "--device", "cuda"])
    torch.cuda.synchronize()
    for name in PROBES:
        counts[name] = kernels.launches[name]
        if counts[name] == 0:
            raise RuntimeError(f"the ablation tool never launched {name}")
    if not all(np.isfinite(v) for v in ablation.values() if isinstance(v, float)):
        raise RuntimeError("the ablation tool printed a non-finite number")

    phase("11. N2 HF (cold and warm, from the core and the SAP guess) and N2 PBE (cold, then "
          "warm with a profile) at the lmax=12 basis")
    t0 = time.perf_counter()
    big = DiatomicBasis(**N2_L12_SHAPE)
    big_ops = big.build_operators(dev)
    torch.cuda.synchronize()
    print(f"N2 HF lmax=12: nbf {big.nbf}, basis and operators {time.perf_counter() - t0:.3f} s")
    args, moved, flops = coulomb_dia_inputs(big, big_ops, block_density(big, dev, 31), big.njbd)
    same_bits_twice("radial_coulomb_dia", args)
    results[("radial_coulomb_dia", "lmax12")] = report(
        "lmax12", "radial_coulomb_dia", compare("radial_coulomb_dia", args, moved, flops, 2, 10))
    del args
    from helfem_tpu_torch.utils.linalg import reset_warm_counts, warm_counts

    core = {}
    for label in ("cold", "warm"):
        kernels.reset_launches()
        reset_warm_counts()
        t0 = time.perf_counter()
        res = scf_diatomic(big, 7, 7, method="HF", convthr=1e-7, maxit=50, ops=big_ops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        core[label] = (res.niter, wall)
        SINGLE["N2 HF lmax=12"] = res.E
        k6 = kernels.launches["radial_exchange_dia_occ"]
        check_per_iteration(f"N2 HF lmax=12 {label}", res, kernels.launches, K3)
        dE, dcc = res.E - N2_L12_REF, res.E - N2_L12_CUDA_CORES
        na, = spin_traces(big_ops, res)
        print(f"N2 HF lmax=12 {label} SCF: E = {res.E:.12f} in {res.niter} iterations, "
              f"converged {res.converged}; wall {wall:.3f} s; radial_exchange_dia_occ "
              f"launches {k6}; E - reference {dE:+.3e}, E - CUDA-core value {dcc:+.3e}; "
              f"tr(P S) - 14 = {2 * na - 14:+.3e} (the whitening's defect "
              f"{whitening_defect(big_ops):.2e}); eigensolve: {warm_counts['warm']} warm, "
              f"{warm_counts['cold']} cold fallbacks, K11 launches "
              f"{kernels.launches['refine_eig']}")
        if not (res.converged and abs(dE) < 2e-5 and abs(dcc) < 1e-8 and k6 > 0):
            raise RuntimeError(f"N2 HF lmax=12 {label}: not converged to the reference "
                               "(2e-5) and the CUDA-core value (1e-8), or K6 never launched")
    # one profiled warm SCF: its eigensolve split into K11, eigh and the rest
    profile_scf("N2 HF lmax=12", counted("N2 HF lmax=12", lambda: scf_diatomic(
        big, 7, 7, method="HF", convthr=1e-7, maxit=50, ops=big_ops), K3),
        kernels=(K3_SASS, K6_SASS), walls=1)
    # from the SAP guess, the bench's start: the cold SCF also solves N's
    # SAD atom on the card and builds the guess Hamiltonian on the host
    from helfem_tpu_torch.models.diatomic_tools import guess_hamiltonian_dia

    for label in ("cold", "warm"):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = scf_diatomic(big, 7, 7, method="HF", convthr=1e-7, maxit=50, ops=big_ops,
                           guess="SAP")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k6 = kernels.launches["radial_exchange_dia_occ"]
        check_per_iteration(f"N2 HF lmax=12 from SAP {label}", res, kernels.launches, K3)
        dE = res.E - N2_L12_REF
        if label == "warm":  # N's table is cached: the host's guess Hamiltonian alone
            t1 = time.perf_counter()
            guess_hamiltonian_dia(big, "SAP", dev)
            print(f"N2 lmax=12: the SAP guess Hamiltonian (host numpy, N's table cached) "
                  f"{time.perf_counter() - t1:.3f} s")
        sad = {name: kernels.launches[name] for name in ("radial_coulomb", *XC)}
        print(f"N2 HF lmax=12 from SAP {label} SCF: E = {res.E:.12f} in {res.niter} "
              f"iterations, converged {res.converged}; wall {wall:.3f} s (core guess: "
              f"{core[label][0]} iterations, {core[label][1]:.3f} s); E - reference "
              f"{dE:+.3e}; K2, K4, K5 launches (N's SAD solve) {sad}")
        if not (res.converged and abs(dE) < 2e-5 and k6 > 0):
            raise RuntimeError(f"N2 HF lmax=12 from SAP {label}: not converged within 2e-5 "
                               "Eh of the reference, or K6 never launched")
        if len(set(sad.values())) != 1 or (label == "cold") != (sad["radial_coulomb"] > 0):
            raise RuntimeError(f"N2 HF lmax=12 from SAP {label}: N's SAD solve did not launch "
                               "K2, K4 and K5 once per Fock build (cold) or never (warm)")
    t0 = time.perf_counter()
    pbe = DiatomicBasis(**N2_PBE_L12_SHAPE)
    pbe_ops = pbe.build_operators(dev)
    torch.cuda.synchronize()
    print(f"N2 PBE lmax=12: basis and operators {time.perf_counter() - t0:.3f} s")
    run_pbe = counted("N2 PBE lmax=12", lambda: scf_diatomic(
        pbe, 7, 7, method="PBE", convthr=1e-7, maxit=50, ops=pbe_ops), XC_K3)
    t0 = time.perf_counter()
    res = run_pbe()
    torch.cuda.synchronize()
    dE = res.E - N2_PBE_L12_REF
    print(f"N2 PBE lmax=12 cold SCF: E = {res.E:.12f} in {res.niter} iterations, converged "
          f"{res.converged}; wall {time.perf_counter() - t0:.3f} s; Nel on the grid "
          f"{res.Nelgrid:.12f}; E - pinned value {dE:+.3e}; XC launches "
          f"{[kernels.launches[n] for n in XC]}")
    if not (res.converged and abs(res.Nelgrid - 14.0) < 1e-6 and abs(dE) < 1e-8):
        raise RuntimeError("N2 PBE lmax=12: not converged, Nel off 14 by 1e-6, or E off the "
                           "pinned value by 1e-8 Eh")
    k3_per_scf("N2 PBE lmax=12", profile_scf("N2 PBE lmax=12", run_pbe,
                                             kernels=(*XC_SASS, K3_SASS), walls=1))
    del pbe_ops
    torch.cuda.empty_cache()
    l12 = (big, big_ops)  # phase 22 runs the crash-recovery hook on them

    phase("12. Xe HF through the port's atomic CLI on the card, then its warm profile")

    def xe_check(res):
        dE = res.E - XE_HF_LIMIT
        print(f"Xe HF: E - HF limit = {dE:+.3e}")
        ok = res.converged and abs(dE) < 3e-6 and np.isfinite(res.E)
        return "" if ok else "did not converge within 3e-6 Eh of the Xe HF limit"

    run_cli(atomic_main, XE_CLI, "Xe HF", [*ATOMIC, "refine_eig"], xe_check, per_iter=ATOMIC)
    atomic_profile("Xe HF", SHAPES["xe"], (27, 27))

    sad_counts = sad_phases(dev, results)
    dft_counts = dft_phase(dev)
    open_counts = open_shell_phase(dev, results)
    mgga_counts = mgga_phase(dev, results)
    rs_counts = rs_phase(dev, results)
    lapl_counts = lapl_phase(dev, results)
    field_counts = field_phase(dev, results)
    control_counts = control_phase(dev, results)
    persist_counts = persistence_phase(dev, results, l12)
    del l12
    parallel_counts = parallel_phase(dev, results)
    counts["radial_erfc_exchange"] = rs_counts["Ar LC-LDA"]["radial_erfc_exchange"]

    record = []
    for name, (source, replaces, shape) in KERNELS.items():
        r = results[(name, shape)]
        other = results[(name, {"ar": "xe", "n2": "co"}[shape])]
        big = results.get((name, "lmax12"))
        extra = {} if big is None else {
            "lmax12_max_abs_err": big["max_abs_err"], "lmax12_ms": big["ms"],
            "lmax12_device_ms": big["device_ms"], "lmax12_plain_ms": big["plain_ms"],
            "lmax12_bound_ms": big["bound_ms"]}
        if name in XC:
            extra.update(spins=2, other_shape_spins=2, lmax12_spins=1)
            for grid in ATOMIC_XC_SHAPES:
                o = results[(name, grid)]
                extra.update({f"atomic_{grid}_{k}": o[k] for k in
                              ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")})
                extra[f"atomic_{grid}_spins"] = 1
            extra["sad_kr_launches"] = sad_counts["sad_kr"][name]
        if name in (*ATOMIC, *XC):
            extra["phase15_launches"] = {label: c.get(name, 0) for label, c in dft_counts.items()}
        extra["phase16_launches"] = {label: c.get(name, 0) for label, c in open_counts.items()}
        extra["phase18_launches"] = {label: c.get(name, 0) for label, c in rs_counts.items()}
        for more in {"radial_erfc_exchange": ("ar_2", "xe_2"),
                     "radial_exchange": tuple(f"yukawa_{lam:g}" for lam in YUKAWA_LAMBDAS)
                     }.get(name, ()):
            o = results[(name, more)]
            extra.update({f"{more}_{k}": o[k] for k in
                          ("max_abs_err", "rel_err", "ms", "device_ms", "queued_ms", "plain_ms",
                           "bound_ms")})
        if name == "radial_erfc_exchange":
            extra["erfc_tables_setup_s"] = results[("rs_setup", "erfc_tables_s")]
            for key in ("ar", "ar_2", "xe", "xe_2", "field_ne", "field_ne_s0"):
                extra.update({f"{key}_{k}": v for k, v in results[("erfc_details", key)].items()})
        for more in {"radial_exchange_dia_occ": ("o2_alpha", "o2_beta", "o2_l12_alpha",
                                                 "o2_l12_beta"),
                     "radial_exchange": ("sad_cr2",), **dict.fromkeys(XC, ("sad_cr2",))
                     }.get(name, ()):
            o = results[(name, more)]
            extra.update({f"{more}_{k}": o[k] for k in
                          ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")})
        if name in XC:
            extra["sad_cr2_spins"] = 2
            for grid in TAU_GRIDS:
                for ns in (1, 2):
                    o = results[(name, f"tau_{grid}_{ns}")]
                    extra.update({f"tau_{grid}_{ns}_{k}": o[k] for k in
                                  ("max_abs_err", "rel_err", "ms", "device_ms", "queued_ms",
                                   "plain_ms", "bound_ms")})
            extra["phase17_launches"] = {label: c.get(name, 0) for label, c in mgga_counts.items()}
            for grid in LAPL_GRIDS:
                for ns in (1,) if grid == "lmax12" else (1, 2):
                    o = results[(name, f"lapl_{grid}_{ns}")]
                    extra.update({f"lapl_{grid}_{ns}_{k}": o[k] for k in
                                  ("max_abs_err", "rel_err", "ms", "device_ms", "queued_ms",
                                   "plain_ms", "bound_ms")})
            extra["phase19_launches"] = {label: c.get(name, 0) for label, c in lapl_counts.items()}
        for key in FIELD_KEYS.get(name, ()):
            o = results[(name, key)]
            extra.update({f"{key}_{k}": o[k] for k in
                          ("max_abs_err", "rel_err", "ms", "device_ms", "queued_ms", "plain_ms",
                           "bound_ms")})
        extra["phase20_launches"] = {label: c.get(name, 0) for label, c in field_counts.items()}
        for key in CONTROL_KEYS.get(name, ()):
            o = results[(name, key)]
            extra.update({f"{key}_{k}": o[k] for k in
                          ("max_abs_err", "rel_err", "ms", "device_ms", "queued_ms", "plain_ms",
                           "bound_ms")})
        extra["phase21_launches"] = {label: c.get(name, 0) for label, c in control_counts.items()}
        extra["phase22_launches"] = {label: c.get(name, 0) for label, c in persist_counts.items()}
        extra["phase23_launches"] = {label: c.get(name, 0)
                                     for label, c in parallel_counts.items()}
        for rank in range(2):
            o = results.get((name, f"{shape}_shard{rank}"))
            if o is not None:
                extra.update({f"shard{rank}_{k}": o[k] for k in
                              ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")})
        scf = results.get((name, {"radial_exchange_dia_occ": "o2_l12_scf",
                                  "radial_exchange": "sad_cr2_scf"}.get(name)))
        if scf is not None:
            extra["open_shell_scf_device_ms_per_launch"] = scf["device_ms"]
        if name == "refine_eig":
            # the phases' launch tables count their own kernels, not K11
            extra = {k: v for k, v in extra.items() if not k.startswith("phase")}
            extra["eigh_ms"] = r["eigh_ms"]  # torch.linalg.eigh on the same batch: a yardstick
            for (kname, key), o in results.items():
                if kname == name and key != shape:
                    extra.update({f"{key}_{k}": o[k] for k in
                                  ("max_abs_err", "rel_err", "off_err", "v_err", "good", "ms",
                                   "device_ms", "queued_ms", "plain_ms", "bound_ms",
                                   "eigh_ms") if k in o})
        for sad in SAD_SHAPES if name in ATOMIC else ():
            o = results[(name, sad)]
            extra.update({f"{sad}_{k}": o[k] for k in
                          ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms")})
            extra[f"{sad}_launches"] = sad_counts[sad][name]
        record.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"], "queued_ms": r["queued_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "shape": shape,
            "other_shape_max_abs_err": other["max_abs_err"], "other_shape_ms": other["ms"],
            "other_shape_device_ms": other["device_ms"], "other_shape_plain_ms": other["plain_ms"],
            "other_shape_bound_ms": other["bound_ms"], **extra,
        })
    for name, (source, replaces) in PROBES.items():
        r = probes[(name, "full", 2048)]
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces["full"],
               "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "shape": "n=2048 full",
               "reduced_replaces": replaces["reduced"]}
        for prec, n in (("reduced", 2048), ("full", 4096), ("reduced", 4096)):
            o = probes[(name, prec, n)]
            rec.update({f"n{n}_{prec}_{k}": o[k] for k in
                        ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")})
        record.append(rec)
    phase_wall()
    print()
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    # the CLIs write their checkpoints (helfem.npz by default) into the
    # working directory: a temporary one, not the checkout
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            main()
        finally:
            os.chdir(home)
