// Short-range (erfc) exchange kernel K10: KK[g, a] for every multipole
// channel g and density channel a, in f64, on the dense element-pair tables
// of the erfc kernel, which does not factorise:
//
//   Kp[g,a,e,f][j,k] = sum_{i,l} tei[g,e,f,i,j,k,l] W_a[e,f][i,l],
//   W_a[e,f][i,l]    = Pd[a][gidx[e,i], gidx[f,l]]   (trash slot read as 0),
//   KK[g,a][n,m]     = sum of Kp[g,a,e,f][j,k] over the (e,j) covering n and
//                      the (f,k) covering m.
//
// Replaces helfem_tpu/models/atomic.py:erfc_exchange_bd's contraction
// ("efijkl,aefil->aefjk" and its one-hot assembly, an XLA-fused einsum
// program in a scan over L). It is K1's in-element band term widened from
// the nelem diagonal slices to all NL * nelem^2 element-pair slices, with no
// cross-element factors: the same building blocks (radial_band.cuh,
// pair_assembly.cuh).
//
// One cooperative launch, grid = every block the SMs hold, two phases joined
// by a grid-wide barrier:
//   1. band tasks on the FP64 tensor cores (dmma.cuh): one row band of one
//      tei[g, e, f] slice as the product rows (j,k) x depth (i,l), the slab
//      tei[g,e,f,i,:,:,:] contiguous for each i, times the windows W[e,f] of
//      every channel a at once (both spins' channels, stacked), so each
//      slice is read once per call for all channels (up to 32); the entries
//      with one owner go straight into KK, the element-boundary rows and
//      columns into the scratch Kpair;
//   2. the owner-computes assembly of those boundary rows and columns.
// No atomics: two calls give the same bits.
//
// Bound on the H100: the table is the whole of the traffic. At the Ar bench
// basis (NL 3, nelem 10, nprim 15) a call reads its 116 MiB once and writes
// the 1.9 MB KK: 0.037 ms at 3.35 TB/s; its 0.12 GFLOP per spin take 0.002
// ms on the FP64 tensor cores. The design streams each slice once, on all
// SMs, coalesced; the FLOPs are negligible beside the bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_assembly.cuh"

namespace cg = cooperative_groups;

// The launch's arguments, as kernels/radial_erfc_exchange.py:_Launch lays
// them out: the pointers, then the sizes and the band plan (rows R,
// channels per group CG, depth units per chunk NU). nang counts the density
// channels a (ns * nang for ns spins).
struct ReLaunch {
  const double *tei, *Pd;
  const int *gidx, *owners, *bounds;  // bounds: the nb functions two slots share
  double *Kpair, *KK;
  void* stream;
  int NL, nelem, nprim, nang, nrad, nb, R, CG, NU, device;
};

// Dynamic shared memory: the band buffers, then the shared tables.
__host__ __device__ inline int re_smem(const ReLaunch& a) {
  return 8 * band_doubles(a.R, a.CG, a.NU, a.nprim) +
         pair_tables_bytes(a.nrad, a.nelem, a.nprim);
}

// A[(j,k), (i, l)] of a (g, e, f) slice: row (j,k) of unit i is at
// tei[g, e, f, i, j, k, :], so the rows of one unit are contiguous.
struct PairRows {
  static constexpr bool kUnitMajor = true;
  const double* slab;  // tei[g, e, f]
  int np, np3;
  __device__ const double* operator()(int row, int u) const {
    return slab + (size_t)u * np3 + row * np;
  }
};

__global__ void __launch_bounds__(RB_THREADS, 2) radial_erfc_exchange_kernel(const ReLaunch a) {
  extern __shared__ double smem[];
  const int np = a.nprim, np2 = np * np, nrad = a.nrad, nelem = a.nelem, nang = a.nang;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int ld = band_ld(a.NU, np);
  const PairTables tab = stage_pair_tables(a, smem + band_doubles(a.R, a.CG, a.NU, np));
  __syncthreads();

  // ---- phase 1: band tasks over every (g, e, f) slice ----
  const int nband = (np2 + a.R - 1) / a.R, ngrp = (nang + a.CG - 1) / a.CG;
  const int nchunk = (np + a.NU - 1) / a.NU;
  const int ntask = a.NL * nelem * nelem * nband * ngrp;
  double* As = smem;
  double* Bs = As + a.R * ld;
  for (int task = blockIdx.x; task < ntask; task += gridDim.x) {
    const int grp = task % ngrp, band = task / ngrp % nband, s = task / (ngrp * nband);
    const int g = s / (nelem * nelem), ef = s - g * nelem * nelem;
    const int e = ef / nelem, f = ef - e * nelem;
    const int r0 = band * a.R, nr = min(a.R, np2 - r0);
    const int c0 = grp * a.CG, nc = min(a.CG, nang - c0), ntn = (nc + 7) / 8;
    const PairRows src{a.tei + (size_t)s * np2 * np2, np, np2 * np};
    double acc[2][RB_NT][2] = {};
    for (int ch = 0; ch < nchunk; ++ch) {
      const int u0 = ch * a.NU, nu = min(a.NU, np - u0);
      stage_rows(As, ld, src, r0, nr, u0, nu, np);
      stage_window(Bs, ld, a.Pd + (size_t)c0 * nrad * nrad, (size_t)nrad * nrad, nc, ntn * 8,
                   tab.gs + e * np, tab.gs + f * np, u0, nu, np, nrad);
      cp_async_wait_all();
      __syncthreads();
      band_chunk(As, Bs, ld, rb_ceil(nu * np, 4), a.R, nr, ntn, acc);
      __syncthreads();
    }
    const int row = r0 + 8 * (warp % (a.R / 8)) + gq;  // (j, k)
    if (band_reduce(As, a.R, nr, ntn, acc) && row < r0 + nr) {
      const int j = row / np, k = row - j * np;
      const KpDest to = kp_dest(a, tab.sl, e, j, f, k);
#pragma unroll
      for (int nt = 0; nt < RB_NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + nt * 8 + 2 * tq + h;
          if (nt < ntn && c < c0 + nc) put_kp(a, to, g * nang + c, acc[0][nt][h]);
        }
    }
  }
  cg::this_grid().sync();

  // ---- phase 2: the boundary rows and columns (pair_assembly.cuh) ----
  assemble_boundaries(a, tab, a.NL * nang);
}

static CoopOccupancy re_occupancy = {(const void*)radial_erfc_exchange_kernel, {}, {-1, -1, -1,
                                     -1, -1, -1, -1, -1}, {}, {}, 0};

// The kernel's dynamic shared memory for these sizes and plan (the wrapper's
// plan must agree).
extern "C" int radial_erfc_exchange_smem(const ReLaunch* a) { return re_smem(*a); }

// Kpair [NL, nang, nelem, nprim, nelem, nprim]: scratch (only the entries in
// boundary rows and columns are written and read); KK: output [NL, nang,
// nrad, nrad]. Returns a cudaError_t.
extern "C" int radial_erfc_exchange_launch(const ReLaunch* a) {
  if (a->R < 8 || a->R % 8 || a->R > 8 * RB_WARPS || a->CG < 1 || a->CG > 8 * RB_NT ||
      a->NU < 1 || a->NU > a->nprim)
    return (int)cudaErrorInvalidValue;
  return coop_launch(re_occupancy, a, re_smem(*a));
}
