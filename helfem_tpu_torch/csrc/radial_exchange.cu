// Radial exchange kernel K1: KK[g, a] = kernel_L(Pd[a]) for every multipole
// channel g and angular channel a, in f64.
//
// Replaces helfem_tpu/models/atomic.py:exchange_kernel_L (vmapped over
// (L, channel) by exchange_general_bd), an XLA-fused einsum/cumsum program.
// That program runs the cross-element triangles as prefix sums in global
// coordinates and gathers/scatters through one-hot matmuls, both only because
// TPU gather/scatter serialises. This kernel uses the PAIRWISE WINDOW form
// (atomic.py:exchange_kernel_L_pairwise) and indexes with gidx directly:
//
//   in-element, e == f:  Kp[e,e][j,k] = sum_il tei[g,e,i,j,k,l] W[e,e][i,l]
//   lower, e > f:        Kp[e,f]      = V[g,e] W[e,f] U[g,f]^T
//   upper, e < f:        Kp[e,f]      = U[g,e] W[e,f] V[g,f]^T
//
// with W[e,f][p,q] = Pd[a][gidx[e,p], gidx[f,q]] (trash slot read as 0), then
// KK[g,a][n,m] = sum of Kp[e,f][i,j] over the (e,i) covering n and the (f,j)
// covering m.
//
// One cooperative launch, grid = every block the SMs hold (about two per
// SM), two phases joined by a grid-wide barrier:
//   1. element-pair products on the FP64 tensor cores (dmma.cuh). An entry
//      Kp[e,f][i,j] whose row n = gidx[e,i] and column m = gidx[f,j] each
//      have one owner slot is the whole of KK[n,m] and is written there; the
//      others, in the rows and columns of the radial functions that two
//      elements share (the element boundaries), go to the scratch Kpair
//      [NL, nang, nelem, nprim, nelem, nprim] (in L2) for phase 2.
//      - in-element tasks (radial_band.cuh): one row band of one tei[g, e]
//        slice as the product rows (j,k) x depth (i,l), the slab
//        tei[g,e,i,:,:,:] contiguous for each i, times the windows W[e,e] of
//        every channel a at once: each slice is read once per call for all
//        channels (nang <= 32), in bands sized to fill the card (30 slices
//        at Ar, 56 at Xe);
//      - cross tasks, one per element pair e != f, group of channels and
//        group of g: the windows W[e,f] of the channels and the factors
//        V, U of the g are staged once; then each warp takes (a, g) items,
//        per pair of 8-column tiles j: T = W Y^T on them into its own
//        buffer, then Kp = X T, the tiles of each product independent DMMA
//        chains.
//   2. owner-computes assembly of the boundary rows and columns only: one
//      warp per (g, a, boundary function n) and direction, its lanes over
//      the row n or the column n, each entry the sum of its (at most 2 x 2)
//      element-pair contributions in a fixed order. The owner table (owners[n]
//      = the element slots e * nprim + i covering n, -1 if none) and the list
//      of the functions two slots share are built once per operator set on
//      the host (kernels/_common.py).
// No atomics: two calls give the same bits.
//
// Bound on the H100: at the Ar bench shapes (NL=3, nang=4, nelem=10,
// nprim=15, nrad=139) a call reads the 12 MB tei table once and writes the
// 1.9 MB KK: 0.0044 ms at 3.35 TB/s; its 30 MFLOP take 0.0005 ms on the
// tensor cores. The design reads each slice once, coalesced, on all SMs,
// and keeps the Kpair round trip in L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_assembly.cuh"

namespace cg = cooperative_groups;

// The launch's arguments, as kernels/radial_exchange.py:_Launch lays them
// out: the pointers, then the sizes and the tile plan (band rows R,
// channels per band group CG, depth units per chunk NU; channels AG and g
// GG per cross task).
struct RxLaunch {
  const double *tei, *U, *V, *Pd;
  const int *gidx, *owners, *bounds;  // bounds: the nb functions two slots share
  double *Kpair, *KK;
  void* stream;
  int NL, nelem, nprim, nang, nrad, nb, R, CG, NU, AG, GG, device;
};

#define RX_LDT 20  // row stride of a warp's T tile (two 8-column tiles, 4 mod 16)

// Cross tasks: W [AG][np8][ldw], X and Y [GG][2][np8][ldw], and each warp's
// T tile [np8][RX_LDT] (np8, np4: nprim rounded up to 8 and 4).
__host__ __device__ inline int cross_doubles(int AG, int GG, int np) {
  const int np8 = rb_ceil(np, 8), ldw = dmma_ld(rb_ceil(np, 4));
  return (AG + 2 * GG) * np8 * ldw + RB_WARPS * np8 * RX_LDT;
}

// Dynamic shared memory: the larger task's buffers, the owner table (int4
// per radial index), gidx, the slot table (kp_dest), the shared functions
// (at most nrad).
__host__ __device__ inline int rx_smem(const RxLaunch& a) {
  const int band = band_doubles(a.R, a.CG, a.NU, a.nprim);
  const int cross = cross_doubles(a.AG, a.GG, a.nprim);
  return 8 * (band > cross ? band : cross) + pair_tables_bytes(a.nrad, a.nelem, a.nprim);
}

// G independent 8 x 8 DMMA chains: tile u multiplies the 8 rows at A[u]
// (row stride lda, depth contiguous) by the 8 columns of B[u] (B(k, n) at
// B[u][k * bk + n * bn]) over depth nk (a multiple of 4) into acc[u][0..1]
// (the C fragment: rows g, columns 2t, 2t + 1). G is a template parameter
// and no DMMA is predicated: a predicated mma.sync makes the compiler put a
// warp barrier in front of it, which serialises the chains.
template <int G>
__device__ __forceinline__ void mma_tiles(const double* const (&A)[RB_NT], int lda,
                                          const double* const (&B)[RB_NT], int bk, int bn,
                                          int nk, double (&acc)[RB_NT][2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const double* a[G];
  const double* b[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    a[u] = A[u] + gq * lda + tq;
    b[u] = B[u] + tq * bk + gq * bn;
  }
#pragma unroll 2
  for (int k = 0; k < nk; k += 4) {
    double av[G], bv[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      av[u] = a[u][k];
      bv[u] = b[u][k * bk];
    }
#pragma unroll
    for (int u = 0; u < G; ++u) dmma884(acc[u][0], acc[u][1], av[u], bv[u]);
  }
}

// mma_tiles for g = 1..RB_NT tiles (a warp-uniform count).
__device__ __forceinline__ void mma_tiles_n(int g, const double* const (&A)[RB_NT], int lda,
                                            const double* const (&B)[RB_NT], int bk, int bn,
                                            int nk, double (&acc)[RB_NT][2]) {
  switch (g) {
    case 1: mma_tiles<1>(A, lda, B, bk, bn, nk, acc); break;
    case 2: mma_tiles<2>(A, lda, B, bk, bn, nk, acc); break;
    case 3: mma_tiles<3>(A, lda, B, bk, bn, nk, acc); break;
    default: mma_tiles<4>(A, lda, B, bk, bn, nk, acc); break;
  }
}

// A[(j,k), (i, l)] of a (g, e) slice: row (j,k) of unit i is at
// tei[g, e, i, j, k, :], so the rows of one unit are contiguous.
struct ExchangeRows {
  static constexpr bool kUnitMajor = true;
  const double* slab;  // tei[g, e]
  int np, np3;
  __device__ const double* operator()(int row, int u) const {
    return slab + (size_t)u * np3 + row * np;
  }
};

// One cross task: Kp[e, f] for the channels [a0, a0 + na) and the g in
// [g0, g0 + ng); buffers as cross_doubles lays them out.
__device__ void cross_task(const RxLaunch& a, double* sm, const int* gs, const int* sl, int e,
                           int f, int a0, int na, int g0, int ng) {
  const int np = a.nprim, np2 = np * np, nrad = a.nrad, nelem = a.nelem;
  const int np8 = rb_ceil(np, 8), np4 = rb_ceil(np, 4), nrt = np8 / 8;
  const int ldw = dmma_ld(np4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  double* W = sm;                     // [AG][np8][ldw]
  double* XY = W + a.AG * np8 * ldw;  // [GG][2][np8][ldw]: X, Y
  double* Tw = XY + 2 * a.GG * np8 * ldw + warp * np8 * RX_LDT;  // this warp's [np8][16]
  const int* ge = gs + e * np;
  const int* gf = gs + f * np;
  // the zero-padded windows W[a][p][q] = Pd[a0 + a][gidx[e,p], gidx[f,q]], then
  // the factors X = (e > f ? V : U)[g, e], Y = (e > f ? U : V)[g, f]: 16
  // loads in flight per thread, then their stores
  const double* Xs = e > f ? a.V : a.U;
  const double* Ys = e > f ? a.U : a.V;
  const FastDiv by_np4(np4), by_np8(np8);
  const int nel = (na + 2 * ng) * np8 * np4;
  for (int base = tid; base < nel; base += 16 * RB_THREADS) {
    double v[16];
    int at[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int idx = base + u * RB_THREADS;
      const int row = by_np4(idx), q = idx - row * np4, blk = by_np8(row), p = row - blk * np8;
      at[u] = idx < nel ? (blk < na ? row : (a.AG - na) * np8 + row) * ldw + q : -1;
      v[u] = 0.0;
      if (idx < nel && p < np && q < np) {
        if (blk < na) {
          const int gi = ge[p], gj = gf[q];
          if (gi < nrad && gj < nrad)
            v[u] = __ldg(a.Pd + ((size_t)(a0 + blk) * nrad + gi) * nrad + gj);
        } else {
          const int gl = (blk - na) >> 1, y = (blk - na) & 1;
          const size_t fac = (size_t)(g0 + gl) * nelem + (y ? f : e);
          v[u] = __ldg((y ? Ys : Xs) + fac * np2 + p * np + q);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (at[u] >= 0) W[at[u]] = v[u];
  }
  __syncthreads();
  // items (a, g), one per warp at a time, two 8-column tiles jt at a time:
  // T = W[a] Y[jt]^T into Tw, then Kp[:, jt] = X T; the tiles of each product
  // are independent DMMA chains, RB_NT at a time
  for (int item = warp; item < na * ng; item += RB_WARPS) {
    const int gl = item % ng, c = item / ng;
    const double* X = XY + gl * 2 * np8 * ldw;
    const double* Y = X + np8 * ldw;
    const double* Wa = W + c * np8 * ldw;
    const int ga = (g0 + gl) * a.nang + a0 + c;
    for (int jt0 = 0; jt0 < nrt; jt0 += 2) {
      const int nj = min(2, nrt - jt0), ntile = nrt * nj;
      for (int t0 = 0; t0 < ntile; t0 += RB_NT) {  // T[p][j] = sum_q W[a][p][q] Y[j][q]
        const double* Ap[RB_NT];
        const double* Bp[RB_NT];
#pragma unroll
        for (int u = 0; u < RB_NT; ++u) {
          const int tt = min(t0 + u, ntile - 1), pt = nj == 2 ? tt >> 1 : tt, jl = tt - pt * nj;
          Ap[u] = Wa + 8 * pt * ldw;
          Bp[u] = Y + 8 * (jt0 + jl) * ldw;
        }
        double acc[RB_NT][2] = {};
        mma_tiles_n(min(RB_NT, ntile - t0), Ap, ldw, Bp, 1, ldw, np4, acc);
#pragma unroll
        for (int u = 0; u < RB_NT; ++u) {
          const int tt = t0 + u, pt = nj == 2 ? tt >> 1 : tt, jl = tt - pt * nj;
          if (tt < ntile) {
            double* to = Tw + (8 * pt + gq) * RX_LDT + 8 * jl + 2 * tq;
            to[0] = acc[u][0];
            to[1] = acc[u][1];
          }
        }
      }
      __syncwarp();
      for (int t0 = 0; t0 < ntile; t0 += RB_NT) {  // Kp[i][j] = sum_p X[i][p] T[p][j]
        const double* Ap[RB_NT];
        const double* Bp[RB_NT];
        KpDest to[RB_NT][2];
#pragma unroll
        for (int u = 0; u < RB_NT; ++u) {
          const int tt = min(t0 + u, ntile - 1), it = nj == 2 ? tt >> 1 : tt, jl = tt - it * nj;
          Ap[u] = X + 8 * it * ldw;
          Bp[u] = Tw + 8 * jl;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 8 * it + gq, j = 8 * (jt0 + jl) + 2 * tq + h;
            to[u][h] = kp_dest(a, sl, e, min(i, np - 1), f, min(j, np - 1));
            to[u][h].live &= t0 + u < ntile && i < np && j < np;
          }
        }
        double acc[RB_NT][2] = {};
        mma_tiles_n(min(RB_NT, ntile - t0), Ap, ldw, Bp, RX_LDT, 1, np4, acc);
#pragma unroll
        for (int u = 0; u < RB_NT; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h) put_kp(a, to[u][h], ga, acc[u][h]);
      }
      __syncwarp();  // the next column tiles overwrite Tw
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(RB_THREADS, 2) radial_exchange_kernel(const RxLaunch a) {
  extern __shared__ double smem[];
  const int np = a.nprim, np2 = np * np, nrad = a.nrad, nelem = a.nelem, nang = a.nang;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ld = band_ld(a.NU, np);
  const int nbuf = max(band_doubles(a.R, a.CG, a.NU, np), cross_doubles(a.AG, a.GG, np));
  const PairTables tab = stage_pair_tables(a, smem + nbuf);
  const int *gs = tab.gs, *sl = tab.sl;
  __syncthreads();

  // ---- phase 1: in-element band tasks, then cross tasks ----
  const int nband = (np2 + a.R - 1) / a.R, ngrp = (nang + a.CG - 1) / a.CG;
  const int nchunk = (np + a.NU - 1) / a.NU;
  const int nin = a.NL * nelem * nband * ngrp;
  const int nag = (nang + a.AG - 1) / a.AG, ngg = (a.NL + a.GG - 1) / a.GG;
  const int ncross = nelem * (nelem - 1) * nag * ngg;
  double* As = smem;
  double* Bs = As + a.R * ld;
  for (int task = blockIdx.x; task < nin + ncross; task += gridDim.x) {
    if (task >= nin) {
      const int t = task - nin;
      const int agp = t % nag, ggp = t / nag % ngg, pair = t / (nag * ngg);
      const int e = pair / (nelem - 1), fo = pair % (nelem - 1), f = fo < e ? fo : fo + 1;
      const int a0 = agp * a.AG, g0 = ggp * a.GG;
      cross_task(a, smem, gs, sl, e, f, a0, min(a.AG, nang - a0), g0, min(a.GG, a.NL - g0));
      continue;
    }
    const int grp = task % ngrp, band = task / ngrp % nband, s = task / (ngrp * nband);
    const int g = s / nelem, e = s - g * nelem;
    const int r0 = band * a.R, nr = min(a.R, np2 - r0);
    const int c0 = grp * a.CG, nc = min(a.CG, nang - c0), ntn = (nc + 7) / 8;
    const ExchangeRows src{a.tei + (size_t)s * np2 * np2, np, np2 * np};
    double acc[2][RB_NT][2] = {};
    for (int ch = 0; ch < nchunk; ++ch) {
      const int u0 = ch * a.NU, nu = min(a.NU, np - u0);
      stage_rows(As, ld, src, r0, nr, u0, nu, np);
      stage_window(Bs, ld, a.Pd + (size_t)c0 * nrad * nrad, (size_t)nrad * nrad, nc, ntn * 8,
                   gs + e * np, u0, nu, np, nrad);
      cp_async_wait_all();
      __syncthreads();
      band_chunk(As, Bs, ld, rb_ceil(nu * np, 4), a.R, nr, ntn, acc);
      __syncthreads();
    }
    const int row = r0 + 8 * (warp % (a.R / 8)) + gq;  // (j, k)
    if (band_reduce(As, a.R, nr, ntn, acc) && row < r0 + nr) {
      const int j = row / np, k = row - j * np;
      const KpDest to = kp_dest(a, sl, e, j, e, k);
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

static CoopOccupancy rx_occupancy = {(const void*)radial_exchange_kernel, {}, {-1, -1, -1, -1,
                                     -1, -1, -1, -1}, {}, {}, 0};

// The kernel's dynamic shared memory for these sizes and plan (the wrapper's
// plan must agree).
extern "C" int radial_exchange_smem(const RxLaunch* a) { return rx_smem(*a); }

// Kpair [NL, nang, nelem, nprim, nelem, nprim]: scratch (only the entries in
// boundary rows and columns are written and read); KK: output [NL, nang,
// nrad, nrad]. Returns a cudaError_t.
extern "C" int radial_exchange_launch(const RxLaunch* a) {
  if (a->R < 8 || a->R % 8 || a->R > 8 * RB_WARPS || a->CG < 1 || a->CG > 8 * RB_NT ||
      a->NU < 1 || a->NU > a->nprim || a->AG < 1 || a->GG < 1)
    return (int)cudaErrorInvalidValue;
  return coop_launch(rx_occupancy, a, rx_smem(*a));
}
