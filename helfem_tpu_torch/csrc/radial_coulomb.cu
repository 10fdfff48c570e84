// Radial Coulomb kernel K2: Jaux[L, M] from the Gaunt-contracted density
// helpers Paux[L, M], in f64.
//
// Replaces the radial core of helfem_tpu/models/atomic.py:coulomb
// (atomic.py:447-462), an XLA-fused einsum/cumsum program that gathers and
// scatters the element windows through one-hot matmuls (_assembler) only
// because TPU gather/scatter serialises. Here the windows are indexed with
// gidx directly. Per (L, M):
//
//   Pg[e][i,j] = Paux[gidx[e,i], gidx[e,j]]                 (trash read as 0)
//   ts[e] = <disjL[L,e], Pg[e]>,  tb[e] = <disjm1L[L,e], Pg[e]>
//   pre[e] = sum_{f<e} ts[f],     suf[e] = sum_{f>e} tb[f]
//   Jel[e] = Lfac[L] (disjm1L[L,e] pre[e] + disjL[L,e] suf[e]
//                     + sum_kl tei[L,e,:,:,k,l] Pg[e][k,l])
//   Jaux[n,m] = sum of Jel[e][i,j] over the elements e covering both n, m
//
// One cooperative launch, grid = every block the SMs hold (about two per
// SM), two phases joined by a grid-wide barrier:
//   1. the in-element product on the FP64 tensor cores (radial_band.cuh):
//      the rows of tei[L, e] (nprim^2 x nprim^2, row (i,j), depth (k,l)),
//      with disjL[L, e] and disjm1L[L, e] appended as two more rows (the
//      traces ts, tb), times the windows Pg of every M at once. A task is
//      one row band of one (L, e) slice and one group of at most 32 M: each
//      slice is read once per call for all M (NM <= 32), in bands sized
//      to fill the card (30 slices at Ar, 56 at Xe). Outputs Jin [NL, NM,
//      nelem, nprim^2] and the traces [NL, NM, 2, nelem], both in L2.
//   2. owner-computes assembly, one warp per run of output rows of one
//      (L, M), as many rows as spread the rows over all warps: the
//      prefix/suffix trace sums once per run by warp scans (fixed order),
//      then each entry of the row's element band the sum of its (at most 2)
//      element contributions in element order, zeros elsewhere, each entry
//      written once. The owner table (owners[n] = the element slots
//      e * nprim + i covering n, -1 if none) and the bands (the first and
//      last column sharing an element with n) are built once per operator
//      set on the host (kernels/_common.py).
// No atomics: two calls give the same bits.
//
// Bound on the H100: at the Ar bench shapes (NL=3, NM=5, nelem=10,
// nprim=15, nrad=139) a call reads the 12 MB tei table once and writes the
// 2.3 MB Jaux: 0.0044 ms at 3.35 TB/s; its 15 MFLOP are nothing on the
// tensor cores. The design reads each slice once, coalesced, on all SMs,
// and keeps the scratch round trip in L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "radial_band.cuh"

namespace cg = cooperative_groups;

// The launch's arguments, as kernels/radial_coulomb.py:_Launch lays them
// out: the pointers, then the sizes and the tile plan (band rows R, M per
// group CG, depth units per chunk NU).
struct RcLaunch {
  const double *Paux, *tei, *U, *V, *Lfac;
  const int *gidx, *owners, *band;  // band[n]: the columns sharing an element with n
  double *Jin, *tr, *Jaux;
  void* stream;
  int NL, NM, nelem, nprim, nrad, R, CG, NU, device;
};

// Dynamic shared memory: the band buffers, each warp's prefix and suffix
// sums [2][nelem], the owner table (int4 per radial index), the column
// bands (int2 per radial index), gidx.
__host__ __device__ inline int rc_smem(const RcLaunch& a) {
  return 8 * (band_doubles(a.R, a.CG, a.NU, a.nprim) + 2 * RB_WARPS * a.nelem) +
         4 * (6 * a.nrad + a.nelem * a.nprim);
}

// A[row, (u, l)] of a (L, e) slice: tei rows, then disjL, disjm1L.
struct CoulombRows {
  static constexpr bool kUnitMajor = false;
  const double *tei, *U, *V;
  size_t s;  // slice L * nelem + e
  int np, np2;
  __device__ const double* operator()(int row, int u) const {
    if (row < np2) return tei + (s * np2 + row) * np2 + u * np;
    return (row == np2 ? U : V) + s * np2 + u * np;
  }
};

__global__ void __launch_bounds__(RB_THREADS, 2) radial_coulomb_kernel(const RcLaunch a) {
  extern __shared__ double smem[];
  const int np = a.nprim, np2 = np * np, nrad = a.nrad, nelem = a.nelem, NM = a.NM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ld = band_ld(a.NU, np);
  double* As = smem;
  double* Bs = As + a.R * ld;
  double* wsum = As + band_doubles(a.R, a.CG, a.NU, np) + 2 * warp * nelem;  // this warp's
  int4* own = (int4*)(As + band_doubles(a.R, a.CG, a.NU, np) + 2 * RB_WARPS * nelem);
  int2* bands = (int2*)(own + nrad);
  int* gs = (int*)(bands + nrad);
  for (int k = tid; k < nelem * np; k += RB_THREADS) gs[k] = a.gidx[k];
  for (int k = tid; k < nrad; k += RB_THREADS)
    bands[k] = make_int2(a.band[2 * k], a.band[2 * k + 1]);
  stage_owners(own, a.owners, nrad, np);
  __syncthreads();

  // ---- phase 1: Jin and the traces, one (slice, band, M group) per task ----
  const int rows = np2 + 2;
  const int nband = (rows + a.R - 1) / a.R, ngrp = (NM + a.CG - 1) / a.CG;
  const int nchunk = (np + a.NU - 1) / a.NU;
  const int ntask = a.NL * nelem * nband * ngrp;
  for (int task = blockIdx.x; task < ntask; task += gridDim.x) {
    const int grp = task % ngrp, band = task / ngrp % nband, s = task / (ngrp * nband);
    const int L = s / nelem, e = s - L * nelem;
    const int r0 = band * a.R, nr = min(a.R, rows - r0);
    const int c0 = grp * a.CG, nc = min(a.CG, NM - c0), ntn = (nc + 7) / 8;
    const CoulombRows src{a.tei, a.U, a.V, (size_t)s, np, np2};
    double acc[2][RB_NT][2] = {};
    for (int ch = 0; ch < nchunk; ++ch) {
      const int u0 = ch * a.NU, nu = min(a.NU, np - u0);
      stage_rows(As, ld, src, r0, nr, u0, nu, np);
      stage_window(Bs, ld, a.Paux + ((size_t)L * NM + c0) * nrad * nrad, (size_t)nrad * nrad,
                   nc, ntn * 8, gs + e * np, u0, nu, np, nrad);
      cp_async_wait_all();
      __syncthreads();
      band_chunk(As, Bs, ld, rb_ceil(nu * np, 4), a.R, nr, ntn, acc);
      __syncthreads();
    }
    const int row = r0 + 8 * (warp % (a.R / 8)) + gq;
    if (band_reduce(As, a.R, nr, ntn, acc) && row < r0 + nr) {
#pragma unroll
      for (int nt = 0; nt < RB_NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int M = c0 + nt * 8 + 2 * tq + h;
          if (nt >= ntn || M >= c0 + nc) continue;
          const double v = acc[0][nt][h];
          const size_t LM = (size_t)L * NM + M;
          if (row < np2)
            a.Jin[(LM * nelem + e) * np2 + row] = v;
          else
            a.tr[(LM * 2 + (row - np2)) * nelem + e] = v;
        }
    }
  }
  cg::this_grid().sync();

  // ---- phase 2: owner-computes assembly, one warp per run of rows of one
  // (L, M) ----
  const int nwarps = gridDim.x * RB_WARPS;
  const int nLM = a.NL * NM;
  const int run = max(1, (nLM * nrad + nwarps - 1) / nwarps), nrun = (nrad + run - 1) / run;
  const int nrows = nLM * nrun;
  const double* pre = wsum;
  const double* suf = wsum + nelem;
  for (int t = blockIdx.x + gridDim.x * warp; t < nrows; t += nwarps) {  // blocks first
    const int LM = t / nrun, n0 = (t - LM * nrun) * run, L = LM / NM;
    const double lf = __ldg(a.Lfac + L);
    const double* J = a.Jin + (size_t)LM * nelem * np2;
    const double* Ul = a.U + (size_t)L * nelem * np2;
    const double* Vl = a.V + (size_t)L * nelem * np2;
    __syncwarp();  // the last run's reads of the sums are done
    bool scanned = false;
    for (int n = n0; n < min(n0 + run, nrad); ++n) {
      const int4 on = own[n];
      const int2 bd = bands[n];
      double* out = a.Jaux + ((size_t)LM * nrad + n) * nrad;
      // the columns that share an element with n: per owner element e of n,
      // the slot of m in e (if any). Every load unconditional (a missing
      // pair reads entry 0 and adds 0) and issued before the prefix sums of
      // the run are formed, so that they all overlap
      for (int m0 = bd.x; m0 <= bd.y; m0 += 32) {
        const int m = min(m0 + lane, bd.y);
        const int4 om = own[m];
        double vv[2], uu[2], jj[2];
        int el[2];
        bool live[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int u = x ? on.y : on.x, e = x ? on.w : on.z;
          const int w = om.z == e ? om.x : (om.w == e ? om.y : -1);
          live[x] = u >= 0 && w >= 0;
          el[x] = live[x] ? e : 0;
          const size_t lw = live[x] ? (size_t)e * np2 + (u - e * np) * np + (w - e * np) : 0;
          vv[x] = __ldg(Vl + lw);
          uu[x] = __ldg(Ul + lw);
          jj[x] = __ldcg(J + lw);
        }
        if (!scanned) {  // warp-uniform: the run's first pass
          const double* ts = a.tr + (size_t)LM * 2 * nelem;  // written by other blocks:
          const double* tb = ts + nelem;                      // read through L2
          warp_exclusive_scan([=](int e) { return __ldcg(ts + e); }, nelem, false, wsum);
          warp_exclusive_scan([=](int e) { return __ldcg(tb + e); }, nelem, true, wsum + nelem);
          __syncwarp();
          scanned = true;
        }
        double acc = 0.0;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const double v = lf * (vv[x] * pre[el[x]] + uu[x] * suf[el[x]] + jj[x]);
          acc += live[x] ? v : 0.0;
        }
        if (m0 + lane <= bd.y) out[m] = acc;
      }
      for (int m = lane; m < nrad; m += 32)
        if (m < bd.x || m > bd.y) out[m] = 0.0;
    }
  }
}

static CoopOccupancy rc_occupancy = {(const void*)radial_coulomb_kernel, {}, {-1, -1, -1, -1,
                                     -1, -1, -1, -1}, {}, {}, 0};

// The kernel's dynamic shared memory for these sizes and plan (the wrapper's
// plan must agree).
extern "C" int radial_coulomb_smem(const RcLaunch* a) { return rc_smem(*a); }

// Jin [NL, NM, nelem, nprim^2] and tr [NL, NM, 2, nelem]: scratch; Jaux:
// output [NL, NM, nrad, nrad]. Returns a cudaError_t.
extern "C" int radial_coulomb_launch(const RcLaunch* a) {
  if (a->R < 8 || a->R % 8 || a->R > 8 * RB_WARPS || a->CG < 1 || a->CG > 8 * RB_NT ||
      a->NU < 1 || a->NU > a->nprim)
    return (int)cudaErrorInvalidValue;
  return coop_launch(rc_occupancy, a, rc_smem(*a));
}
