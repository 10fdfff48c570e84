// Element-pair products and their owner-computes assembly, shared by the
// atomic exchange kernels K1 (radial_exchange.cu) and K10
// (radial_erfc_exchange.cu).
//
// Both produce, for every channel pair ga = g * nchan + a and element pair
// (e, f), a product Kp[e,f][i,j] that belongs to KK[ga][n, m] with
// n = gidx[e,i] and m = gidx[f,j]. An entry whose row and column each have
// one owner slot is the whole of KK[n, m] and is written there; the others,
// in the rows and columns of the radial functions that two elements share
// (the element boundaries), go to the scratch Kpair [NL, nchan, nelem,
// nprim, nelem, nprim] (in L2), which the boundary assembly reads after a
// grid-wide barrier. No atomics: two calls give the same bits.
//
// A launch struct L has the fields gidx, owners, bounds, Kpair, KK, nelem,
// nprim, nang (the channels a), nrad and nb (the functions two slots share).
#pragma once

#include "radial_band.cuh"

#define RX_SINGLE (1 << 30)  // slot table: the radial function has this one slot

__device__ __forceinline__ size_t kpair_at(int ga, int e, int i, int f, int j, int nelem,
                                           int np) {
  return ((((size_t)ga * nelem + e) * np + i) * nelem + f) * np + j;
}

// Where Kp[e,f][i,j] goes: straight into KK where its row n = gidx[e,i]
// and its column m = gidx[f,j] each have one owner slot (the only
// contribution there), else into the scratch for the boundary assembly;
// nowhere on the trash slot. sl[e * nprim + i] = n | RX_SINGLE where n has
// one slot, n where two, -1 on the trash slot. The lookups are made before a
// tile's products and its stores after them (a store may alias the shared
// tables, so the compiler would not move a later lookup above it).
struct KpDest {
  size_t at;  // element offset, in KK if direct, else in Kpair, for channel pair 0
  bool direct, live;
};

template <class L>
__device__ __forceinline__ KpDest kp_dest(const L& a, const int* sl, int e, int i, int f, int j) {
  const int ci = sl[e * a.nprim + i], cj = sl[f * a.nprim + j];
  const int n = ci & (RX_SINGLE - 1), m = cj & (RX_SINGLE - 1);
  const bool direct = ci & cj & RX_SINGLE;
  return {direct ? (size_t)n * a.nrad + m : kpair_at(0, e, i, f, j, a.nelem, a.nprim), direct,
          ci >= 0 && cj >= 0};
}

// Store Kp of channel pair ga at d.
template <class L>
__device__ __forceinline__ void put_kp(const L& a, const KpDest& d, int ga, double v) {
  const size_t np1 = (size_t)a.nelem * a.nprim;
  if (d.live) (d.direct ? a.KK + ((size_t)ga * a.nrad * a.nrad + d.at)
                        : a.Kpair + ((size_t)ga * np1 * np1 + d.at))[0] = v;
}

// The shared tables after a kernel's nbuf doubles of task buffers: the owner
// table (an int4 per radial index), gidx, the slot table and the shared
// functions; pair_tables_bytes of them.
__host__ __device__ inline int pair_tables_bytes(int nrad, int nelem, int np) {
  return 4 * (5 * nrad + 2 * nelem * np);
}

struct PairTables {
  int4* own;
  int *gs, *sl, *bounds;
};

template <class L>
__device__ __forceinline__ PairTables stage_pair_tables(const L& a, double* after) {
  const int np = a.nprim, nrad = a.nrad;
  PairTables t;
  t.own = (int4*)after;
  t.gs = (int*)(t.own + nrad);
  t.sl = t.gs + a.nelem * np;
  t.bounds = t.sl + a.nelem * np;
  for (int k = threadIdx.x; k < a.nelem * np; k += RB_THREADS) {
    const int n = a.gidx[k];
    t.gs[k] = n;
    t.sl[k] = n < nrad ? n | (a.owners[2 * n + 1] < 0 ? RX_SINGLE : 0) : -1;
  }
  for (int k = threadIdx.x; k < a.nb; k += RB_THREADS) t.bounds[k] = a.bounds[k];
  stage_owners(t.own, a.owners, nrad, np);
  return t;
}

// The boundary rows and columns of nga channel pairs, after the grid-wide
// barrier: one warp per (channel pair, boundary function, direction), spread
// over the blocks first, its lanes over the row n or the column n, each entry
// the sum of its (at most 2 x 2) element-pair contributions in a fixed order.
template <class L>
__device__ __forceinline__ void assemble_boundaries(const L& a, const PairTables& t, int nga) {
  const int np = a.nprim, nrad = a.nrad, nelem = a.nelem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = nga * a.nb * 2;
  for (int r = blockIdx.x + gridDim.x * warp; r < nrows; r += gridDim.x * RB_WARPS) {
    const int col = r & 1, b = (r >> 1) % a.nb, ga = (r >> 1) / a.nb;
    const int bn = t.bounds[b];  // the boundary function: row or column bn
    const int4 ob = t.own[bn];
    const double* Kp = a.Kpair + (size_t)ga * nelem * np * nelem * np;
    double* out = a.KK + (size_t)ga * nrad * nrad;
    for (int m0 = lane; m0 < nrad; m0 += 32 * RB_BATCH) {
      // every load unconditional (a masked pair reads entry 0 and adds 0),
      // so that a lane's loads all issue before the first sum
      double v[RB_BATCH];
#pragma unroll
      for (int q = 0; q < RB_BATCH; ++q) {
        const int4 om = t.own[min(m0 + 32 * q, nrad - 1)];
        const int4 ru = col ? om : ob, cw = col ? ob : om;  // row and column owners
        const int u[2] = {ru.x, ru.y}, w[2] = {cw.x, cw.y};
        double acc = 0.0;
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 2; ++y) {  // slots e*np+i, f*np+j: row (e,i), column (f,j)
            const bool live = u[x] >= 0 && w[y] >= 0;
            const double k = __ldcg(Kp + (live ? (size_t)u[x] * nelem * np + w[y] : 0));
            acc += live ? k : 0.0;
          }
        v[q] = acc;
      }
#pragma unroll
      for (int q = 0; q < RB_BATCH; ++q) {
        const int m = m0 + 32 * q;
        if (m < nrad) out[col ? (size_t)m * nrad + bn : (size_t)bn * nrad + m] = v[q];
      }
    }
  }
}
