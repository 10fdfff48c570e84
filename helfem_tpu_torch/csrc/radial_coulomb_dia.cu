// Diatomic radial Coulomb kernel K3: Jr0, Jr2 [S, nrad, nrad] from the
// Gaunt-contracted density helpers Paux0 (modified Gaunt, cos^2 slot) and
// Paux2 (plain Gaunt) of S signed (L, M) channels, in f64.
//
// Replaces the radial core of helfem_tpu/models/diatomic.py:coulomb_dia
// (diatomic.py:759-786), an XLA scan over channel chunks whose window
// gathers and assembly go through one-hot matmuls (_assembler) only because
// TPU gather/scatter serialises. Here the windows are indexed with gidx.
// Per channel s (radial tables row c = ilm[s]) and element e:
//
//   Pg0[e], Pg2[e] = windows of Paux0[s], Paux2[s]         (trash read as 0)
//   ts[e] = <dP0[c,e], Pg0[e]> - <dP2[c,e], Pg2[e]>
//   tb[e] = <dQ0[c,e], Pg0[e]> - <dQ2[c,e], Pg2[e]>
//   sA[e] = sum_{f<e} ts[f],   sB[e] = sum_{f>e} tb[f]
//   J0[e] = dP0 sB + dQ0 sA + T00 vec(Pg0) - T02 vec(Pg2)
//   J2[e] = -dP2 sB - dQ2 sA - T02^T vec(Pg0) + T22 vec(Pg2)
//   Jr0/2[n, m] = LMfac[c] * sum of J0/2[e][i, j] over the elements e
//                 covering both n, m
//
// with T00, T02, T22 the [np^2, np^2] blocks of the reduced 3-family table
// teiJ3[c, :, e]. The JAX package's fourth family (2,0) is exactly the
// per-block transpose of (0,2), so the kernel reads T02 transposed.
//
// Bound on the H100: bytes. Per (c, e) slice the three blocks meet only two
// right-hand vectors, one FMA per 8 bytes of table read, so tensor cores buy
// nothing. At the N2 lmax=12 shapes (27 channels, nelem 5, nprim 15) a call
// reads 164 MB of table rows: 0.049 ms at 3.35 TB/s. At the N2 (6,6) bench
// (15 channels, nprim 8) it reads 7.4 MB, 0.0022 ms, so there the launch and
// the latency of the two phases bound it.
//
// One cooperative launch, grid = every block the SMs hold, two phases
// joined by a grid-wide barrier, no atomics (the same bits on every call):
//   1. every teiJ3[c, :, e] slice streamed once per call for all the
//      channels that use row c (a group: one channel on the SCF path, the
//      +-M pair of a row when every signed channel runs). A row task is one
//      group, element, row band and column band (the host plan,
//      kernels/radial_coulomb_dia.py:plan, sizes them to fill the card).
//      The block gathers the two windows' entries of its columns and the
//      Pg0 entries of its rows into shared memory. Each warp streams its
//      rows through a ring of rcd_depth(K) rows in shared memory, each row's
//      three segments one bulk copy each (TMA, cp.async.bulk, from the
//      16-byte boundary below them: at odd nprim the rows are not 16-byte
//      aligned) completing on the slot's mbarrier, running on into the
//      block's next task while a task's barriers and column partials are
//      done. Lanes take consecutive columns (K per lane) and reduce each
//      row's products by a fixed xor-shuffle tree: the row products of
//      T00 and T02 (J0) and of T22 (J2) per column band. The same T02 values
//      give the column partials of -T02^T Pg0 (J2), summed over the warp's
//      rows in registers, over the block's warps in warp order, and written
//      once per row band: no transposed copy of the table. A trace task per
//      group (on the blocks with the fewest row tasks) forms the traces of
//      every element, one warp per element, and their exclusive prefix and
//      suffix sums by warp scans (fixed order).
//   2. owner-computes assembly, one warp per run of output rows of one
//      channel: each entry of the row's element band the sum of its (at
//      most 2) element contributions in element order, each contribution
//      adding its column-band row partials and row-band column partials in
//      band order; zeros outside the band. The owner table, the column
//      bands and each channel's slot, table row and LMfac are built once
//      per operator set on the host (kernels/_common.py), so no block
//      rebuilds the owner map from gidx.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "radial_band.cuh"

namespace cg = cooperative_groups;

#define RCD_MAX_K 8    // columns per lane in a column band (<= 256 columns)
#define RCD_MAX_R 256  // rows per row band

// rows in flight per warp: four, three for the widest bands, so that the
// rings of the eight warps stay within one block's shared memory
__host__ __device__ constexpr int rcd_depth(int K) { return K <= 4 ? 4 : 3; }

// The launch's arguments, as kernels/radial_coulomb_dia.py:_Launch lays
// them out: the pointers, then the sizes and the plan. groups[g] = (row c,
// then CH channels, -1 where the group has fewer); chan[s] = (g * CH + the
// channel's place in its group, its row c), cfac[s] = LMfac[c]. W columns
// per column band (ncb bands, K = ceil(W / 32) per lane), R rows per row
// band.
struct RcdLaunch {
  const double *P0, *P2, *tei, *dP0, *dP2, *dQ0, *dQ2, *cfac;
  const int *gidx, *owners, *band, *groups, *chan;
  double *rowpart, *colpart, *sab, *J0, *J2;
  void* stream;
  int S, G, CH, nelem, nprim, nrad, R, K, W, ncb, device;
};

// doubles before the integer tables: the rings' mbarriers (one 8-byte word
// each), each warp's ring of rcd_depth(K) rows (3 segments of 32 K + 2: the
// alignment slack of a bulk copy), per channel of a group the W band
// entries of Pg0 and Pg2 and the R row entries of Pg0, each warp's column
// partials (32 K per channel), a trace task's traces [CH][2][nelem], each
// channel's LMfac; even, so that the int4 owner table is 16-byte aligned
__host__ __device__ inline int rcd_doubles(const RcdLaunch& a) {
  const int n = RB_WARPS * rcd_depth(a.K) * (1 + 3 * (32 * a.K + 2)) + a.CH * (2 * a.W + a.R) +
                RB_WARPS * a.CH * 32 * a.K + 2 * a.CH * a.nelem + a.S;
  return (n + 1) / 2 * 2;
}

// Dynamic shared memory: the doubles above, the owner table (int4 per
// radial index), the column bands (int2 per radial index), gidx, each
// channel's slot and table row.
__host__ __device__ inline int rcd_smem(const RcdLaunch& a) {
  return 8 * rcd_doubles(a) + 4 * (6 * a.nrad + a.nelem * a.nprim + 2 * a.S);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the bulk copy engine (TMA): arm the mbarrier for `bytes`, then each copy
// of a 16-byte-aligned range into shared memory completes part of them
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// (the table is read once per call: its lines go first when L2 needs room,
// so that the partial sums written beside the stream stay for phase 2)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], "
      "[%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void mbar_wait_parity(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n .reg .pred P1;\nRCD_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra RCD_DONE;\n bra RCD_WAIT;\nRCD_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A row task: group g, element e, rows [r0, r0 + nr) and columns [c0, c0 +
// nc) of the slice of table row c (task order: column band fastest, then
// row band, then (g, e)).
struct RcdTask {
  int g, e, rb, c, r0, nr, c0, nc;
  const double* T00;
};

template <int CH>
__device__ __forceinline__ RcdTask rcd_task(const RcdLaunch& a, int task, int nrb, int np2) {
  RcdTask t;
  const int cb = task % a.ncb, ge = task / (a.ncb * nrb);
  t.rb = task / a.ncb % nrb;
  t.g = ge / a.nelem;
  t.e = ge - t.g * a.nelem;
  t.c = a.groups[t.g * (1 + CH)];
  t.r0 = t.rb * a.R;
  t.nr = min(a.R, np2 - t.r0);
  t.c0 = cb * a.W;
  t.nc = min(a.W, np2 - t.c0);
  t.T00 = a.tei + ((size_t)t.c * 3 * a.nelem + t.e) * np2 * np2;
  return t;
}

// K columns per lane, CH channels per group.
template <int K, int CH>
__global__ void __launch_bounds__(RB_THREADS, CH == 1 && K <= 4 ? 2 : 1)
    radial_coulomb_dia_kernel(const RcdLaunch a) {
  constexpr int SD = 32 * K + 2;  // doubles of a segment's place: 16-byte slack
  constexpr int SL = 3 * SD;      // of one ring slot: a row's three segments
  extern __shared__ __align__(16) double smem[];
  // each ring slot's mbarrier [WARPS][DEPTH] (dynamic: the occupancy query
  // allows the kernel the card's whole 227 KB of it)
  constexpr int RCD_DEPTH = rcd_depth(K);  // rows in flight per warp
  auto rbar = (unsigned long long(*)[RCD_DEPTH])smem;
  const int np = a.nprim, np2 = np * np, nrad = a.nrad, nelem = a.nelem;
  const int W = a.W, R = a.R, ncb = a.ncb, nrb = (np2 + R - 1) / R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  double* ring = smem + RB_WARPS * RCD_DEPTH + warp * RCD_DEPTH * SL;  // this warp's
  double* Pc = smem + RB_WARPS * RCD_DEPTH * (1 + SL);  // [CH][2][W]: Pg0, Pg2 at the columns
  double* Pr = Pc + CH * 2 * W;                     // [CH][R]: Pg0 at the rows
  double* red = Pr + CH * R;                        // [WARPS][CH][32 K]: column partials
  double* tr = red + RB_WARPS * CH * 32 * K;        // [CH][2][nelem]: a trace task's traces
  double* cfac = tr + 2 * CH * nelem;               // [S]
  int4* own = (int4*)(smem + rcd_doubles(a));
  int2* bands = (int2*)(own + nrad);
  int* gs = (int*)(bands + nrad);
  int* cslot = gs + nelem * np;  // [S]: the channel's slot g * CH + place
  int* crow = cslot + a.S;       // [S]: its table row c
  for (int k = tid; k < nelem * np; k += RB_THREADS) gs[k] = a.gidx[k];
  for (int k = tid; k < nrad; k += RB_THREADS)
    bands[k] = make_int2(a.band[2 * k], a.band[2 * k + 1]);
  stage_owners(own, a.owners, nrad, np);
  for (int s = tid; s < a.S; s += RB_THREADS) {
    cslot[s] = a.chan[2 * s];
    crow[s] = a.chan[2 * s + 1];
    cfac[s] = a.cfac[s];
  }
  const FastDiv by_np(np);
  const size_t blk = (size_t)np2 * np2;
  const int ntask = a.G * nelem * nrb * ncb;
  if (lane < RCD_DEPTH)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&rbar[warp][lane])));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  // ---- phase 1 ----
  // this warp's stream of rows: rows warp + 8 q of each of the block's row
  // tasks blockIdx.x + j gridDim.x, RCD_DEPTH of them in flight; item n
  // lands in ring slot n % RCD_DEPTH, whose mbarrier completes its phase
  // (n / RCD_DEPTH) & 1 when the row's three copies have landed
  int itask = blockIdx.x, iq = 0, inw = 0;  // the next row to issue
  RcdTask it;
  bool ilive = itask < ntask;
  if (ilive) {
    it = rcd_task<CH>(a, itask, nrb, np2);
    inw = warp < it.nr ? (it.nr - warp + 7) / 8 : 0;
  }
  int issued = 0;
  const unsigned long long stream_policy = evict_first_policy();
  auto issue = [&]() {
    while (ilive && iq >= inw) {  // on to the next task holding rows of this warp
      itask += gridDim.x;
      iq = 0;
      ilive = itask < ntask;
      if (ilive) {
        it = rcd_task<CH>(a, itask, nrb, np2);
        inw = warp < it.nr ? (it.nr - warp + 7) / 8 : 0;
      }
    }
    if (ilive && lane == 0) {
      const size_t x = it.r0 + warp + 8 * iq;
      double* slot = ring + (issued % RCD_DEPTH) * SL;
      unsigned long long* bar = &rbar[warp][issued % RCD_DEPTH];
      const double* src[3];
      unsigned bytes[3], total = 0;
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        src[f] = it.T00 + (size_t)f * a.nelem * blk + x * np2 + it.c0;
        const int o = (int)(((size_t)src[f] >> 3) & 1);
        src[f] -= o;
        bytes[f] = (unsigned)(o + it.nc + 1) / 2 * 16;
        total += bytes[f];
      }
      mbar_expect(bar, total);
#pragma unroll
      for (int f = 0; f < 3; ++f) bulk_copy(slot + f * SD, src[f], bytes[f], bar, stream_policy);
    }
    iq += ilive;
    ++issued;
  };
  for (int d = 0; d < RCD_DEPTH; ++d) issue();  // in flight during the gathers below

  // trace tasks, one per group, on the blocks with the fewest row tasks
  for (int g = gridDim.x - 1 - blockIdx.x; g < a.G; g += gridDim.x) {
    const int* grp = a.groups + g * (1 + CH);
    const int c = grp[0];
    __syncthreads();  // the last trace task's scans are done with tr
    for (int e = warp; e < nelem; e += RB_WARPS) {
      const size_t lw = ((size_t)c * nelem + e) * np2;
      double acc[CH][2] = {};
      for (int y = lane; y < np2; y += 32) {
        const double p0 = __ldg(a.dP0 + lw + y), p2 = __ldg(a.dP2 + lw + y);
        const double q0 = __ldg(a.dQ0 + lw + y), q2 = __ldg(a.dQ2 + lw + y);
        const int k = by_np(y), l = y - k * np;
        const int gi = gs[e * np + k], gj = gs[e * np + l];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const int s = grp[1 + ch];
          if (s < 0 || gi >= nrad || gj >= nrad) continue;
          const size_t off = ((size_t)s * nrad + gi) * nrad + gj;
          const double w0 = __ldcg(a.P0 + off), w2 = __ldcg(a.P2 + off);
          acc[ch][0] += p0 * w0 - p2 * w2;
          acc[ch][1] += q0 * w0 - q2 * w2;
        }
      }
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const double ts = warp_sum(acc[ch][0]), tb = warp_sum(acc[ch][1]);
        if (lane == 0) {
          tr[(ch * 2) * nelem + e] = ts;
          tr[(ch * 2 + 1) * nelem + e] = tb;
        }
      }
    }
    __syncthreads();
    if (warp < CH && grp[1 + warp] >= 0) {  // sA, sB of the group's channel
      double* out = a.sab + (size_t)grp[1 + warp] * 2 * nelem;
      const double* ts = tr + (warp * 2) * nelem;
      const double* tb = ts + nelem;
      warp_exclusive_scan([=](int e) { return ts[e]; }, nelem, false, out);
      warp_exclusive_scan([=](int e) { return tb[e]; }, nelem, true, out + nelem);
    }
  }

  // row tasks
  for (int task = blockIdx.x; task < ntask; task += gridDim.x) {
    const RcdTask t = rcd_task<CH>(a, task, nrb, np2);
    const int* grp = a.groups + t.g * (1 + CH);
    __syncthreads();  // the last task's reads of Pc, Pr and red are done
    const int ngather = CH * (2 * W + R);
    for (int idx = tid; idx < ngather; idx += RB_THREADS) {
      int ch, y, which;
      bool live;
      if (idx < CH * 2 * W) {
        ch = idx / (2 * W);
        const int rest = idx - ch * 2 * W;
        which = rest >= W;
        const int col = rest - which * W;
        y = t.c0 + col;
        live = col < t.nc;
      } else {
        ch = (idx - CH * 2 * W) / R;
        const int r = idx - CH * 2 * W - ch * R;
        which = 0;
        y = t.r0 + r;
        live = r < t.nr;
      }
      const int s = grp[1 + ch];
      double v = 0.0;
      if (live && s >= 0) {
        const int k = by_np(y), l = y - k * np;
        const int gi = gs[t.e * np + k], gj = gs[t.e * np + l];
        if (gi < nrad && gj < nrad)
          v = __ldcg((which ? a.P2 : a.P0) + ((size_t)s * nrad + gi) * nrad + gj);
      }
      Pc[idx] = v;  // Pc then Pr, in this order
    }
    __syncthreads();
    double p0[CH][K], p2[CH][K], colacc[CH][K];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int col = lane + 32 * k;
        p0[ch][k] = col < W ? Pc[(ch * 2) * W + col] : 0.0;
        p2[ch][k] = col < W ? Pc[(ch * 2 + 1) * W + col] : 0.0;
        colacc[ch][k] = 0.0;
      }
    // rowpart [G][nelem][ncb][np2][2][CH]
    double* rp = a.rowpart +
                 ((((size_t)t.g * nelem + t.e) * ncb + t.c0 / W) * np2 + t.r0) * 2 * CH;
    const int nw = warp < t.nr ? (t.nr - warp + 7) / 8 : 0;
    for (int q = 0; q < nw; ++q) {
      const int r = warp + 8 * q;
      const int item = issued - RCD_DEPTH;  // this row's, issued RCD_DEPTH items ago
      mbar_wait_parity(&rbar[warp][item % RCD_DEPTH], (item / RCD_DEPTH) & 1);
      const double* row = t.T00 + (size_t)(t.r0 + r) * np2 + t.c0;
      const double* slot = ring + (item % RCD_DEPTH) * SL;
      double v[3][K];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        // a segment starts 8 bytes into its place where its address is odd
        const int o = (int)(((size_t)(row + (size_t)f * nelem * blk) >> 3) & 1);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int col = lane + 32 * k;
          v[f][k] = col < t.nc ? slot[f * SD + o + col] : 0.0;
        }
      }
      __syncwarp();  // every lane's reads of the slot are done
      issue();       // into the slot just read: the next row in flight
      double out[2 * CH];
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const double w = Pr[ch * R + r];
        double s0 = 0.0, s2 = 0.0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          s0 += v[0][k] * p0[ch][k] - v[1][k] * p2[ch][k];
          s2 += v[2][k] * p2[ch][k];
          colacc[ch][k] += v[1][k] * w;
        }
        out[2 * ch] = warp_sum(s0);
        out[2 * ch + 1] = warp_sum(s2);
      }
#pragma unroll
      for (int u = 0; u < 2 * CH; ++u)  // rowpart[.., x, (0: J0, 1: J2), ch]
        if (lane == u) rp[(size_t)r * 2 * CH + (u & 1) * CH + (u >> 1)] = out[u];
    }
    // the block's column partials: the warps' in warp order
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
#pragma unroll
      for (int k = 0; k < K; ++k) red[(warp * CH + ch) * 32 * K + lane + 32 * k] = colacc[ch][k];
    __syncthreads();
    // colpart [G][nelem][nrb][np2][CH]
    double* cp = a.colpart + (((size_t)t.g * nelem + t.e) * nrb + t.rb) * np2 * CH;
    for (int idx = tid; idx < CH * t.nc; idx += RB_THREADS) {
      const int ch = idx / t.nc, col = idx - ch * t.nc;
      double v = 0.0;
#pragma unroll
      for (int w = 0; w < RB_WARPS; ++w) v += red[(w * CH + ch) * 32 * K + col];
      cp[(size_t)(t.c0 + col) * CH + ch] = v;
    }
  }
  cg::this_grid().sync();
  __syncthreads();  // the staged tables, for the blocks without phase-1 tasks

  // ---- phase 2: owner-computes assembly, one warp per run of rows of one
  // channel ----
  const int nwarps = gridDim.x * RB_WARPS;
  const int run = max(1, (a.S * nrad + nwarps - 1) / nwarps), nrun = (nrad + run - 1) / run;
  const int nrows = a.S * nrun;
  for (int t = blockIdx.x + gridDim.x * warp; t < nrows; t += nwarps) {  // blocks first
    const int s = t / nrun, n0 = (t - s * nrun) * run;
    const int sl = cslot[s], g = sl / CH, ch = sl - g * CH;
    const double fac = cfac[s];
    const double* rp = a.rowpart + (size_t)g * nelem * ncb * np2 * 2 * CH + ch;
    const double* cp = a.colpart + (size_t)g * nelem * nrb * np2 * CH + ch;
    const double* sA = a.sab + (size_t)s * 2 * nelem;
    const double* sB = sA + nelem;
    const size_t cl = (size_t)crow[s] * nelem * np2;
    for (int n = n0; n < min(n0 + run, nrad); ++n) {
      const int4 on = own[n];
      const int2 bd = bands[n];
      double* out0 = a.J0 + ((size_t)s * nrad + n) * nrad;
      double* out2 = a.J2 + ((size_t)s * nrad + n) * nrad;
      for (int m0 = bd.x; m0 <= bd.y; m0 += 32) {
        const int m = min(m0 + lane, bd.y);
        const int4 om = own[m];
        double acc0 = 0.0, acc2 = 0.0;
        // every load unconditional (a missing pair reads entry 0 and adds
        // 0), all issued before any sum
        double r0v[2], r2v[2], cpv[2], tp0[2], tq0[2], tp2[2], tq2[2], a0[2], b0[2];
        bool live[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int u = x ? on.y : on.x, e = x ? on.w : on.z;
          const int w = om.z == e ? om.x : (om.w == e ? om.y : -1);
          live[x] = u >= 0 && w >= 0;
          const int el = live[x] ? e : 0;
          const int ww = live[x] ? (u - e * np) * np + (w - e * np) : 0;
          const size_t ew = (size_t)el * np2 + ww;
          tp0[x] = __ldg(a.dP0 + cl + ew);
          tq0[x] = __ldg(a.dQ0 + cl + ew);
          tp2[x] = __ldg(a.dP2 + cl + ew);
          tq2[x] = __ldg(a.dQ2 + cl + ew);
          a0[x] = __ldcg(sA + el);
          b0[x] = __ldcg(sB + el);
          double s0 = 0.0, s2 = 0.0, sc = 0.0;
          for (int b = 0; b < ncb; ++b) {
            const double* p = rp + (((size_t)el * ncb + b) * np2 + ww) * 2 * CH;
            s0 += __ldcg(p);
            s2 += __ldcg(p + CH);
          }
          for (int b = 0; b < nrb; ++b)
            sc += __ldcg(cp + (((size_t)el * nrb + b) * np2 + ww) * CH);
          r0v[x] = s0;
          r2v[x] = s2;
          cpv[x] = sc;
        }
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const double v0 = fac * (tp0[x] * b0[x] + tq0[x] * a0[x] + r0v[x]);
          const double v2 = fac * (r2v[x] - cpv[x] - tp2[x] * b0[x] - tq2[x] * a0[x]);
          acc0 += live[x] ? v0 : 0.0;
          acc2 += live[x] ? v2 : 0.0;
        }
        if (m0 + lane <= bd.y) {
          out0[m] = acc0;
          out2[m] = acc2;
        }
      }
      for (int m = lane; m < nrad; m += 32)
        if (m < bd.x || m > bd.y) {
          out0[m] = 0.0;
          out2[m] = 0.0;
        }
    }
  }
}

// one occupancy cache per instance, indexed (K - 1) * 2 + CH - 1
#define RCD_INSTANCE(K, CH)                                                               \
  {(const void*)radial_coulomb_dia_kernel<K, CH>, {}, {-1, -1, -1, -1, -1, -1, -1, -1}, {}, \
   {}, 0}
static CoopOccupancy rcd_occupancy[2 * RCD_MAX_K] = {
    RCD_INSTANCE(1, 1), RCD_INSTANCE(1, 2), RCD_INSTANCE(2, 1), RCD_INSTANCE(2, 2),
    RCD_INSTANCE(3, 1), RCD_INSTANCE(3, 2), RCD_INSTANCE(4, 1), RCD_INSTANCE(4, 2),
    RCD_INSTANCE(5, 1), RCD_INSTANCE(5, 2), RCD_INSTANCE(6, 1), RCD_INSTANCE(6, 2),
    RCD_INSTANCE(7, 1), RCD_INSTANCE(7, 2), RCD_INSTANCE(8, 1), RCD_INSTANCE(8, 2)};

static bool rcd_valid(const RcdLaunch& a) {
  return a.CH >= 1 && a.CH <= 2 && a.K >= 1 && a.K <= RCD_MAX_K && a.W >= 1 &&
         a.W <= 32 * a.K && a.W > 32 * (a.K - 1) && a.ncb >= 1 &&
         (long long)a.ncb * a.W >= (long long)a.nprim * a.nprim && a.R >= 1 &&
         a.R <= RCD_MAX_R && a.device >= 0 && a.device < 8;
}

// The kernel's dynamic shared memory for these sizes and plan (the wrapper's
// plan must agree).
extern "C" int radial_coulomb_dia_smem(const RcdLaunch* a) { return rcd_smem(*a); }

// The cooperative grid the launch will use for these sizes (every block
// the SMs hold), or 0 on failure: the host plan sizes its tasks by it.
extern "C" int radial_coulomb_dia_grid(const RcdLaunch* a) {
  if (!rcd_valid(*a) || cudaSetDevice(a->device) != cudaSuccess) return 0;
  CoopOccupancy& occ = rcd_occupancy[(a->K - 1) * 2 + a->CH - 1];
  return coop_blocks_per_sm(occ, a->device, rcd_smem(*a)) * sm_count(a->device);
}

// rowpart [G, nelem, ncb, nprim^2, 2, CH], colpart [G, nelem, nrb, nprim^2,
// CH] and sab [S, 2, nelem]: scratch; J0, J2: outputs [S, nrad, nrad].
// Returns a cudaError_t.
extern "C" int radial_coulomb_dia_launch(const RcdLaunch* a) {
  if (!rcd_valid(*a)) return (int)cudaErrorInvalidValue;
  return coop_launch(rcd_occupancy[(a->K - 1) * 2 + a->CH - 1], a, rcd_smem(*a));
}
