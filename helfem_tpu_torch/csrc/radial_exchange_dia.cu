// Diatomic radial exchange kernels K6 (radial_exchange_dia_occ) and K7
// (radial_exchange_dia): K4 [nang, nang, nrad, nrad] from the per-channel
// R families of S (L,|M|) exchange channels, in f64. One device core with
// two sources of R:
//
//   K7 reads dense R [S, 4, nang, nang, nrad, nrad], families F = (q, r) in
//      the order (0,0), (0,2), (2,0), (2,2), signs included;
//   K6 forms R_qr[b,c,n,m] = s_q s_r sum_{t,o} Uw[s,q,t,b,n,o] V[s,r,t,c,m,o]
//      (s = +1, -1) from the rank factors Uw, V [S, 2, 2, nang, nrad+1, no]
//      (row nrad is the zero trash row), so the dense R never exists in
//      device memory.
//
// They replace the radial cores of helfem_tpu/models/diatomic.py:
// exchange_dia_occ (diatomic.py:1061-1113) and exchange_dia (:912-928), XLA
// scans over channel chunks whose window gathers and assembly are one-hot
// matmuls and whose cross-element sums are prefix sums in global
// coordinates. Per channel s (table row c = ilm[s]), with e, f elements:
//
//   in-element   Kd[b,c',e,j,k] += sum_{F,i,l} T_F[c,e][(i j),(k l)]
//                                  R_F[b,c',g(e,i),g(e,l)]
//   cross, e>f   X[e,f][b,i; c',x] += sum_{F,p,m} dQ_q[c,e,i,p]
//                                  R_F[b,c',g(e,p),g(f,m)] dP_r[c,f,x,m]
//   K4[b,c',n,m] = sum of Kd and X over the element slots covering n, m,
//                  the e<f half being the (b<->c', n<->m) transpose of X
//
// T_F are the [np^2, np^2] blocks of the reduced table teiJ3 (families
// (0,0), (0,2), (2,2); (2,0) is read from (0,2)), indexed in the exchange
// order (ij|kl) -> rows (jk), columns (il): helfem_tpu's teiK, a permuted
// copy of the table, is not needed. Like the b <= c' trick below, the
// kernels rely on the tables' symmetries under i<->j and k<->l.
//
// Design. The cross-element terms are formed pairwise, one (e>f) window
// pair at a time, so there is no prefix sum over elements and none of its
// cancellation. K6's cross term factors completely, X = ud^T vd with
// ud = sum_q s_q dQ_q U_q and vd = sum_r s_r dP_r V_r (one transform
// launch, then one tiled GEMM per element pair); K7's contracts each R
// window with its two moment blocks. The assembly is owner-computes
// (fem_owners.cuh): no atomics, the same bits on every run.
//
// The in-element term is one GEMM per element and shell-pair tile:
// M = (jk) rows, N = an 8 x 8 tile of shell pairs (only tiles holding some
// b <= c' are computed; Kd[b,c',j,k] = Kd[c',b,k,j]), depth (channel, F,
// and the two inner indices) in chunks of one table slab: for fixed i,
// A[jk][l] = T_F[(i j),(k l)] is the contiguous slab T[i np^3 + jk np + l]
// of np^3 doubles; family (2,0) runs as a second pass over l, on slab l of
// the (0,2) table, T_20[(i j),(k l)] = T_02[(l k),(j i)] = rows (k j),
// columns i, and its rows are written back as (j k).
//
// Bound on the H100: operations. At the N2 lmax=12 shapes (nang 59, np 15,
// 125 channels, no 9) K6 does 0.52 TFLOP per call against 1.2 GB of tables;
// at the N2 (6,6) bench shapes 1.8 GFLOP in four launches. The FP64 tensor
// cores (67 TFLOP/s) are twice the CUDA cores' FP64 rate, so a DFMA kernel
// can come no closer than 2x to that bound. What the design does about the
// four limits of the first, DFMA version:
//  1. FP64 tensor cores: the GEMM is mma.sync m16n8k8 f64 (DMMA), fragments
//     read with 64-bit LDS (ldmatrix has no 64-bit form, wgmma no f64 one).
//     Products stay IEEE f64; only the order of the sums changes.
//  2. Staging: warp-specialized. A producer thread moves each chunk's slab
//     with one bulk copy (TMA, cp.async.bulk) from the 16-byte boundary
//     below it, since at odd np the slabs are not 16-byte aligned, and the
//     759 MB table is not padded; the slab keeps its row stride np, and an
//     m16 tile takes every 4th row (odd np), so its fragment loads still
//     hit 16 distinct bank pairs. Up to three stages; the producers run two
//     chunks ahead of the eight DMMA warps.
//  3. R once per tile: one block holds all np^2 rows of the element (a row
//     loop over blocks only for np > 16), and the producer warps form each
//     chunk's R tile [kpad x 64] once, as an [8 kpad x 2no] x [2no x 8]
//     product on DMMA (m16n8k4), from the tile's U/V windows.
//  4. Blocks and determinism: channel groups (grid z) write partial sums,
//     two per group (one per pass), that the assembly adds in a fixed
//     order; the wrapper picks the group count that fills the card's block
//     slots in the fewest waves.
// The 8 x 8 shell-pair tiles stay: at nang 59 they compute 2304 columns
// for 1770 pairs b <= c'.

#include <cuda_runtime.h>

#include "fem_owners.cuh"

#define XT 8           // shell-pair tile edge: 8 x 8 pairs = 64 GEMM columns
#define XBN 64         // GEMM columns per block
#define XBK 16         // GEMM depth per step of the cross GEMM
#define XCS (XBN + 4)  // row stride of an R stage: 68 = 4 mod 16 doubles
// in-element GEMM: 8 DMMA warps (4 along M x 2 along N) and 4 producer
// warps; named barriers 1-3 "stage full", 4-6 "stage empty", 7 among the
// producers
#define EX_MMA_THREADS 256
#define EX_PRODUCER_WARPS 4
#define EX_PRODUCERS (32 * EX_PRODUCER_WARPS)
#define EX_THREADS (EX_MMA_THREADS + EX_PRODUCERS)
#define EX_MAX_STAGES 3
#define EX_BAR_FULL 1
#define EX_BAR_EMPTY 4
#define EX_BAR_PRODUCERS 7
#define EX_MAX_NPRIM 72  // the largest nprim the in-element plan admits
#define EX_CROSS_U ((EX_MAX_NPRIM * EX_MAX_NPRIM + 255) / 256)  // K7 cross outputs a thread

// Shared-memory geometry of the in-element GEMM (kernels/radial_exchange_dia.py
// mirrors it): kpad depth columns per chunk; ns stages of the A slab
// (astage doubles: rows of np, as the table stores them, plus the 16-byte
// alignment slack of the bulk copy) and of R (kpad rows of XCS); wbuf
// buffers of the U/V windows, kpad rows of xp doubles (xk = 2 no padded to
// 4, xp = 4 mod 8), ws apart; then the element's nprim gidx slots (ints,
// padded to whole doubles).
struct ExdiaGeom {
  int kpad, astage, xk, xp, ws;
};

__host__ __device__ inline int exdia_tm(int nprim) {
  const int np2 = nprim * nprim;
  return np2 <= 64 ? 1 : (np2 <= 128 || nprim > 16 ? 2 : 4);
}

__host__ __device__ inline ExdiaGeom exdia_geom(int nprim, int no, int bm) {
  ExdiaGeom q;
  q.kpad = (nprim + 7) / 8 * 8;
  const int rows = (nprim * nprim + 63) / 64 * 64;
  q.astage = ((rows < bm ? rows : bm) * nprim + q.kpad + 3) / 2 * 2;
  q.xk = (2 * no + 3) / 4 * 4;
  q.xp = q.xk % 8 ? q.xk : q.xk + 4;
  q.ws = q.kpad * q.xp + 4;  // 4 mod 16
  return q;
}

__host__ __device__ inline size_t exdia_smem_doubles(const ExdiaGeom& q, bool occ, int ns,
                                                     int wbuf) {
  return (size_t)ns * (q.astage + (size_t)q.kpad * XCS) +
         (occ ? (size_t)wbuf * 2 * XT * q.ws : 0);
}
__host__ __device__ inline size_t exdia_gs_doubles(int nprim) { return (nprim + 1) / 2; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all groups but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// the bulk copy engine (TMA): one thread moves a 16-byte-aligned range
// into shared memory and the transaction count completes an mbarrier phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n .reg .pred P1;\nLAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// c[16x8] += a[16x8] b[8x8]: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4);
// b0 (t, g), b1 (t+4, g); c0,c1 (g, 2t+h), c2,c3 (g+8, 2t+h); g = lane/4, t = lane%4
__device__ __forceinline__ void dmma16x8x8(double* c, const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
// c[16x8] += a[16x4] b[4x8]: a0 (g, t), a1 (g+8, t); b (t, g); c as above
__device__ __forceinline__ void dmma16x8x4(double* c, double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Chunk ch of a channel group: pass 0 runs families (0,0), (0,2), (2,2) at
// depth index i (slab i of the family's table, rows (j k), columns l);
// pass 1 runs family (2,0) at depth index l on slab l of the (0,2) table,
// T_20[(i j),(k l)] = T_02[(l k),(j i)] (rows (k j), columns i).
struct ExdiaChunk {
  int s, F, fam, idx, p;
};
__device__ __forceinline__ ExdiaChunk exdia_chunk(int ch, int np, int nchan, int s0) {
  ExdiaChunk c;
  const int na = 3 * np * nchan;
  if (ch < na) {
    const int p = ch / np, f = p % 3;
    c = {s0 + p / 3, f == 2 ? 3 : f, f, ch - p * np, p};
  } else {
    const int q = (ch - na) / np;
    c = {s0 + q, 2, 1, ch - na - q * np, 3 * nchan + q};
  }
  return c;
}

// K6: the U_q windows of the tile's eight b shells and the V_r windows of
// its eight c' shells for channel s, W[w][shell][n][x] with x = (t, o);
// shells past nang, rows past np and x past 2 no stay zero.
__device__ __forceinline__ void exdia_stage_windows(double* W, const double* Uw,
                                                    const double* V, const int* gs, int s,
                                                    int q, int r, int bt, int ct, int np,
                                                    int nang, int nrad1, int no,
                                                    const ExdiaGeom& g, int pt) {
  const int no2 = 2 * no;
  for (int x = pt; x < 2 * XT * np * no2; x += EX_PRODUCERS) {
    const int o2 = x % no2, rest = x / no2;
    const int i = rest % np, sl = (rest / np) % XT, w = rest / (np * XT);
    const int b = (w ? ct : bt) * XT + sl;
    if (b < nang) {
      const int t = o2 / no, o = o2 - t * no;
      const size_t row = (((size_t)s * 2 + (w ? r : q)) * 2 + t) * nang + b;
      cp_async8(W + (w * XT + sl) * g.ws + i * g.xp + o2,
                (w ? V : Uw) + (row * nrad1 + gs[i]) * no + o);
    }
  }
}

// K6: one chunk's R tile Rst[k][b*8 + c'] = sign sum_x M[shell][k][x]
// N[n][idx][x] on DMMA m16n8k4, as the transposed product (shell, k) x n;
// pass 0: M = the V windows (shell c', k = l), N = the U rows (n = b) at i
// = idx; pass 1: M = the U windows (shell b, k = i), N = the V rows (n =
// c') at l = idx. Producer warp pw takes m16 tiles pw, pw + 4, ...; rows
// past kpad read row kpad - 1 and are dropped.
__device__ __forceinline__ void exdia_form_r(double* Rst, const double* W, int pass, int idx,
                                             double sign, int kpad, const ExdiaGeom& g,
                                             int pt) {
  const int lane = pt & 31, pw = pt >> 5, lg = lane >> 2, lt = lane & 3;
  const double* Wm = W + (pass ? 0 : XT) * g.ws;
  const double* np_ = W + (pass ? XT : 0) * g.ws + lg * g.ws + idx * g.xp + lt;
  for (int tile = pw; tile < XT * ((kpad + 15) / 16); tile += EX_PRODUCER_WARPS) {
    const int sh = tile % XT, k0 = tile / XT * 16;
    const double* v0 = Wm + sh * g.ws + min(k0 + lg, kpad - 1) * g.xp + lt;
    const double* v1 = Wm + sh * g.ws + min(k0 + lg + 8, kpad - 1) * g.xp + lt;
    double c[4] = {0.0, 0.0, 0.0, 0.0};
    for (int x = 0; x < g.xk; x += 4) dmma16x8x4(c, v0[x], v1[x], np_[x]);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = k0 + lg + 8 * (h >> 1), n = 2 * lt + (h & 1);
      if (k < kpad) Rst[k * XCS + (pass ? sh * XT + n : n * XT + sh)] = sign * c[h];
    }
  }
}

// K7: one chunk's R tile from the dense R, Rst[k][b*8 + c'] =
// R[s,F,b,c',g(i),g(l)] with (i, l) = (idx, k) in pass 0 and (k, idx) in
// pass 1, zero at the trash slot; entries outside the tile or past np stay
// zero from the start.
__device__ __forceinline__ void exdia_stage_dense_r(double* Rst, const double* R,
                                                    const int* gs, int s, int F, int pass,
                                                    int idx, int bt, int ct, int np, int nang,
                                                    int nrad, int pt) {
  const int fixed = gs[idx];
  for (int x = pt; x < XBN * np; x += EX_PRODUCERS) {
    const int col = x / np, k = x - col * np, moving = gs[k];
    const int b = bt * XT + col / XT, cc = ct * XT + col % XT;
    if (b >= nang || cc >= nang || moving >= nrad) continue;
    double* dst = Rst + k * XCS + col;
    if (fixed < nrad) {
      const size_t n = pass ? moving : fixed, m = pass ? fixed : moving;
      cp_async8(dst, R + ((((size_t)s * 4 + F) * nang + b) * nang + cc) * nrad * nrad +
                         n * nrad + m);
    } else {
      *dst = 0.0;
    }
  }
}

// In-element GEMM. grid (mtiles * ntile (ntile + 1) / 2, nelem, G): the
// row block, the shell-pair tile (bt <= ct), the element, the channel
// group; it writes the partial sums 2 grp (pass 0) and 2 grp + 1 (pass 1).
// Per chunk one producer thread issues the bulk copy of the A slab (rows
// of this block, from the 16-byte boundary below them) into one of ns
// stages; the producer warps copy K7's R tile with cp.async or form K6's
// from the windows, and arrive on the stage's "full" barrier once the next
// chunk's copies are issued and this one's have landed. The eight DMMA
// warps, each a TM x 4 grid of m16n8 tiles (BM = 64 TM rows by 64 columns),
// wait on that barrier and the stage's mbarrier, multiply, and arrive on
// the stage's "empty" barrier. The slab keeps the table's row stride np;
// an m16 tile takes every d-th row (d = 4 at odd np, 2 at np = 2 mod 4),
// so that its fragment loads hit 16 distinct bank pairs. K6's U/V windows
// of the next (channel, F) load while the current one's chunks are formed
// (wbuf = 2, np >= 2), or in place where they change (wbuf = 1).
template <bool OCC, int TM>
__global__ void __launch_bounds__(EX_THREADS, TM == 1 ? 2 : 1) exdia_inelem_kernel(
    const double* __restrict__ A, const double* __restrict__ B,
    const double* __restrict__ teiJ3, const int* __restrict__ ilm,
    const int* __restrict__ gidx, double* __restrict__ part, int S, int nelem,
    int nprim, int nang, int nrad, int no, int cpg, int ns, int wbuf) {
  constexpr int BM = 64 * TM;
  extern __shared__ __align__(16) double sm[];
  __shared__ int aoff[EX_MAX_STAGES];
  __shared__ unsigned long long mbar[EX_MAX_STAGES];
  const ExdiaGeom q = exdia_geom(nprim, no, BM);
  const int np = nprim, np2 = np * np, np3 = np2 * np;
  const int rsz = q.kpad * XCS;
  double* As = sm;
  double* Rs = As + ns * q.astage;
  double* Ws = Rs + ns * rsz;
  const size_t nsm = exdia_smem_doubles(q, OCC, ns, wbuf);
  int* gs = (int*)(sm + nsm);  // the element's gidx slots

  const int mtiles = (np2 + BM - 1) / BM;
  const int mb = blockIdx.x % mtiles;
  int ct = 0, bt = blockIdx.x / mtiles;  // upper-triangle tile index -> (bt <= ct)
  while (bt > ct) bt -= ++ct;
  const int e = blockIdx.y, grp = blockIdx.z, tid = threadIdx.x;
  const int row0 = mb * BM, nrows = min(BM, np2 - row0);
  for (int k = tid; k < np; k += EX_THREADS) gs[k] = gidx[e * np + k];
  if (tid < ns)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(mbar + tid)));
  for (size_t x = tid; x < nsm; x += EX_THREADS) sm[x] = 0.0;  // every pad reads as 0
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // zeros before bulk copies
  __syncthreads();
  const int nchan = max(0, min(S, (grp + 1) * cpg) - grp * cpg), s0 = grp * cpg;
  const int nch = 4 * np * nchan, na = 3 * np * nchan;

  if (tid >= EX_MMA_THREADS) {  // producers: chunk ch's copies fly while ch-1's land
    const int pt = tid - EX_MMA_THREADS;
    const size_t blk = (size_t)np2 * np2;
    const int nrad1 = nrad + 1;
    for (int ch = 0; ch <= nch; ++ch) {
      const int st = ch % ns;
      const ExdiaChunk c = exdia_chunk(ch, np, nchan, s0);  // past the end at ch = nch
      const int pass = c.F == 2;
      if (ch < nch) {
        if (ch >= ns) bar_sync(EX_BAR_EMPTY + st, EX_THREADS);  // the DMMA warps freed it
        if (pt == 0) {
          const double* src = teiJ3 + ((size_t)(ilm[c.s] * 3 + c.fam) * nelem + e) * blk +
                              (size_t)c.idx * np3 + (size_t)row0 * np;
          const int o = (int)(((size_t)src >> 3) & 1);
          aoff[st] = o;
          bulk_load(As + st * q.astage, src - o, (unsigned)((o + nrows * np + 1) / 2 * 16),
                    mbar + st);
        }
        if (!OCC)
          exdia_stage_dense_r(Rs + st * rsz, A, gs, c.s, c.F, pass, c.idx, bt, ct, np, nang,
                              nrad, pt);
      }
      cp_async_commit();
      if (ch > 0) {
        cp_async_wait_prior();
        bar_sync(EX_BAR_PRODUCERS, EX_PRODUCERS);  // every producer's part of ch-1 is in
        bar_arrive(EX_BAR_FULL + (ch - 1) % ns, EX_THREADS);
      }
      if (ch == nch || !OCC) continue;
      const int i = c.idx;
      const int wb = wbuf == 2 ? (c.p & 1) : 0;
      if (i == 0 && (wbuf == 1 || ch == 0)) {  // this (channel, F)'s windows, now
        exdia_stage_windows(Ws + wb * 2 * XT * q.ws, A, B, gs, c.s, c.F >> 1, c.F & 1, bt, ct,
                            np, nang, nrad1, no, q, pt);
        cp_async_commit();
        cp_async_wait_all();
        bar_sync(EX_BAR_PRODUCERS, EX_PRODUCERS);
      }
      exdia_form_r(Rs + st * rsz, Ws + wb * 2 * XT * q.ws, pass, i,
                   (c.F == 1 || c.F == 2) ? -1.0 : 1.0, q.kpad, q, pt);
      if (wbuf == 2 && i == 0 && ch + np < nch) {  // the next (channel, F)'s, in chunk
        const ExdiaChunk n = exdia_chunk(ch + np, np, nchan, s0);  // ch+1's copy group
        exdia_stage_windows(Ws + (n.p & 1) * 2 * XT * q.ws, A, B, gs, n.s, n.F >> 1, n.F & 1,
                            bt, ct, np, nang, nrad1, no, q, pt);
      }
    }
    return;
  }

  const int lane = tid & 31, warp = tid >> 5;
  const int lg = lane >> 2, lt = lane & 3, wm = warp >> 1, wn = warp & 1;
  const int d = np & 1 ? 4 : (np & 2 ? 2 : 1);  // row interleave of an m16 tile
  double acc[TM][4][4];
  auto first_row = [&](int u) {
    const int m = wm * TM + u;
    return 16 * d * (m / d) + m % d;
  };
  auto clear = [&]() {
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[u][v][h] = 0.0;
  };
  auto write = [&](int pass) {  // pass 1 rows are (k j): write them at (j k)
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int rho = row0 + first_row(u) + d * (lg + 8 * (h >> 1));
          const int col = (wn * 4 + v) * 8 + 2 * lt + (h & 1);
          const int b = bt * XT + col / XT, cc = ct * XT + col % XT;
          const int jk = pass ? (rho % np) * np + rho / np : rho;
          if (rho < np2 && b < nang && cc < nang)
            part[((((size_t)(2 * grp + pass) * nelem + e) * nang + b) * nang + cc) * np2 + jk] =
                acc[u][v][h];
        }
  };
  clear();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch % ns;
    if (ch == na) {
      write(0);
      clear();
    }
    bar_sync(EX_BAR_FULL + st, EX_THREADS);
    mbar_wait(mbar + st, (ch / ns) & 1);
    const double* Ast = As + st * q.astage + aoff[st];
    const double* Rst = Rs + st * rsz;
    for (int kk = 0; kk < q.kpad / 8; ++kk) {  // all fragments of a step, then its DMMA
      double a[TM][4], b[4][2];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const double* bp = Rst + (kk * 8 + lt) * XCS + (wn * 4 + v) * 8 + lg;
        b[v][0] = bp[0];
        b[v][1] = bp[4 * XCS];
      }
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const double* ap = Ast + (first_row(u) + d * lg) * np + kk * 8 + lt;
        a[u][0] = ap[0];
        a[u][1] = ap[8 * d * np];
        a[u][2] = ap[4];
        a[u][3] = ap[8 * d * np + 4];
      }
#pragma unroll
      for (int u = 0; u < TM; ++u)
        if (first_row(u) < nrows)
#pragma unroll
          for (int v = 0; v < 4; ++v) dmma16x8x8(acc[u][v], a[u], b[v]);
    }
    if (ch + ns < nch) bar_arrive(EX_BAR_EMPTY + st, EX_THREADS);
  }
  if (nchan == 0) write(0);  // an empty group still writes its zero slices
  write(1);
}

// K6 cross factors. grid (nang, nelem, S), 128 threads; dynamic shared
// memory: the element's nprim gidx slots.
//   ud[e][(s,t,o)][(b,i)]  = sum_p (dQ0[c,e,i,p] Uw[s,0,t,b,g(e,p),o]
//                                   - dQ2[c,e,i,p] Uw[s,1,t,b,g(e,p),o])
//   vd[e][(s,t,o)][(b,i)]  = the same with dP0, dP2 and V
__global__ void exdia_transform_kernel(
    const double* __restrict__ Uw, const double* __restrict__ V,
    const double* __restrict__ dP0, const double* __restrict__ dP2,
    const double* __restrict__ dQ0, const double* __restrict__ dQ2,
    const int* __restrict__ ilm, const int* __restrict__ gidx,
    double* __restrict__ ud, double* __restrict__ vd, int S, int nelem,
    int nprim, int nang, int nrad, int no) {
  extern __shared__ int gs[];
  const int b = blockIdx.x, e = blockIdx.y, s = blockIdx.z, c = ilm[s];
  for (int k = threadIdx.x; k < nprim; k += blockDim.x) gs[k] = gidx[e * nprim + k];
  __syncthreads();
  const int nrad1 = nrad + 1;
  const size_t Ktot = (size_t)S * 2 * no, Mdim = (size_t)nang * nprim;
  const size_t tab = ((size_t)c * nelem + e) * nprim * nprim;
  const int total = 2 * 2 * no * nprim;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int i = idx % nprim, o = (idx / nprim) % no;
    const int t = (idx / (nprim * no)) % 2, w = idx / (nprim * no * 2);
    const double* src = w ? V : Uw;
    const double* d0 = (w ? dP0 : dQ0) + tab + (size_t)i * nprim;
    const double* d2 = (w ? dP2 : dQ2) + tab + (size_t)i * nprim;
    const size_t r0 = ((((size_t)s * 2 + 0) * 2 + t) * nang + b) * nrad1;
    const size_t r1 = ((((size_t)s * 2 + 1) * 2 + t) * nang + b) * nrad1;
    double acc = 0.0;
    for (int p = 0; p < nprim; ++p) {
      const int n = gs[p];
      acc += d0[p] * src[(r0 + n) * no + o] - d2[p] * src[(r1 + n) * no + o];
    }
    const size_t kidx = ((size_t)s * 2 + t) * no + o;
    (w ? vd : ud)[((size_t)e * Ktot + kidx) * Mdim + (size_t)b * nprim + i] = acc;
  }
}

// K6 cross GEMM: X[pair(e>f)][m][n] = sum_k ud[e][k][m] vd[f][k][n].
// grid (tiles_m * tiles_n, npairs), 256 threads, 64 x 64 x 16 tiles, columns
// interleaved over the threads as in the in-element GEMM.
__global__ void __launch_bounds__(256) exdia_cross_gemm_kernel(
    const double* __restrict__ ud, const double* __restrict__ vd,
    double* __restrict__ X, int Ktot, int Mdim) {
  __shared__ double As[XBK][64];
  __shared__ double Bs[XBK][64];
  const int tiles = (Mdim + 63) / 64;
  const int tm = blockIdx.x / tiles, tn = blockIdx.x % tiles;
  int e = 1, pr = blockIdx.y;  // pair index -> (e, f), e > f
  while (pr >= e) {
    pr -= e;
    ++e;
  }
  const int f = pr;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const double* Ag = ud + (size_t)e * Ktot * Mdim;
  const double* Bg = vd + (size_t)f * Ktot * Mdim;
  double acc[4][4] = {};
  for (int k0 = 0; k0 < Ktot; k0 += XBK) {
    for (int idx = tid; idx < XBK * 64; idx += 256) {
      const int kk = idx / 64, x = idx % 64, k = k0 + kk;
      const int m = tm * 64 + x, n = tn * 64 + x;
      As[kk][x] = (k < Ktot && m < Mdim) ? Ag[(size_t)k * Mdim + m] : 0.0;
      Bs[kk][x] = (k < Ktot && n < Mdim) ? Bg[(size_t)k * Mdim + n] : 0.0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < XBK; ++kk) {
      double a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[kk][ty * 4 + u];
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = Bs[kk][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
    }
    __syncthreads();
  }
  double* out = X + (size_t)blockIdx.y * Mdim * Mdim;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = tm * 64 + ty * 4 + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = tn * 64 + tx + 16 * v;
      if (m < Mdim && n < Mdim) out[(size_t)m * Mdim + n] = acc[u][v];
    }
  }
}

// K7 cross term from the dense R windows. grid (nang * nang, npairs), 256
// threads; each thread owns up to U (i, x) outputs: U = 4 for nprim <= 32,
// EX_CROSS_U up to EX_MAX_NPRIM. Dynamic shared memory: 6 np^2 doubles
// (dQ0, dQ2, dP0, dP2, R window, Y).
template <int U>
__global__ void __launch_bounds__(256) exdia_cross_dense_kernel(
    const double* __restrict__ R, const double* __restrict__ dP0,
    const double* __restrict__ dP2, const double* __restrict__ dQ0,
    const double* __restrict__ dQ2, const int* __restrict__ ilm,
    const int* __restrict__ gidx, double* __restrict__ X, int S, int nelem,
    int nprim, int nang, int nrad) {
  extern __shared__ double sm[];
  __shared__ int ge[EX_MAX_NPRIM], gf[EX_MAX_NPRIM];
  const int np2 = nprim * nprim;
  double* Dq0 = sm;
  double* Dq2 = Dq0 + np2;
  double* Dp0 = Dq2 + np2;
  double* Dp2 = Dp0 + np2;
  double* Rw = Dp2 + np2;
  double* Y = Rw + np2;
  const int b = blockIdx.x / nang, cc = blockIdx.x % nang;
  int e = 1, pr = blockIdx.y;
  while (pr >= e) {
    pr -= e;
    ++e;
  }
  const int f = pr, tid = threadIdx.x;
  if (tid < nprim) {
    ge[tid] = gidx[e * nprim + tid];
    gf[tid] = gidx[f * nprim + tid];
  }
  double acc[U] = {};
  for (int s = 0; s < S; ++s) {
    const int c = ilm[s];
    __syncthreads();
    for (int idx = tid; idx < np2; idx += 256) {
      const size_t te = ((size_t)c * nelem + e) * np2 + idx;
      const size_t tf = ((size_t)c * nelem + f) * np2 + idx;
      Dq0[idx] = dQ0[te];
      Dq2[idx] = dQ2[te];
      Dp0[idx] = dP0[tf];
      Dp2[idx] = dP2[tf];
    }
    for (int F = 0; F < 4; ++F) {
      const double* Dq = (F >> 1) ? Dq2 : Dq0;
      const double* Dp = (F & 1) ? Dp2 : Dp0;
      const double* Rs =
          R + ((((size_t)s * 4 + F) * nang + b) * nang + cc) * nrad * nrad;
      __syncthreads();  // tables loaded; last F's Y and Rw consumed
      for (int idx = tid; idx < np2; idx += 256) {
        const int n = ge[idx / nprim], m = gf[idx % nprim];
        Rw[idx] = (n < nrad && m < nrad) ? Rs[(size_t)n * nrad + m] : 0.0;
      }
      __syncthreads();
      for (int idx = tid; idx < np2; idx += 256) {
        const int i = idx / nprim, m = idx % nprim;
        double y = 0.0;
        for (int p = 0; p < nprim; ++p) y += Dq[i * nprim + p] * Rw[p * nprim + m];
        Y[idx] = y;
      }
      __syncthreads();
      for (int u = 0, idx = tid; idx < np2; idx += 256, ++u) {
        const int i = idx / nprim, x = idx % nprim;
        double z = 0.0;
        for (int m = 0; m < nprim; ++m) z += Y[i * nprim + m] * Dp[x * nprim + m];
        acc[u] += z;
      }
    }
  }
  const size_t Mdim = (size_t)nang * nprim;
  double* out = X + (size_t)blockIdx.y * Mdim * Mdim;
  for (int u = 0, idx = tid; idx < np2; idx += 256, ++u) {
    const int i = idx / nprim, x = idx % nprim;
    out[((size_t)b * nprim + i) * Mdim + (size_t)cc * nprim + x] = acc[u];
  }
}

// Owner-computes assembly. grid (tiles, nang * nang), 256 threads. Dynamic
// shared memory: nelem * nprim + 2 * nrad ints.
__global__ void exdia_assemble_kernel(const double* __restrict__ part,
                                      const double* __restrict__ X,
                                      const int* __restrict__ gidx,
                                      double* __restrict__ K4, int G, int nelem,
                                      int nprim, int nang, int nrad) {
  extern __shared__ int ism[];
  int* gs = ism;
  int* own = gs + nelem * nprim;
  for (int t = threadIdx.x; t < nelem * nprim; t += blockDim.x) gs[t] = gidx[t];
  __syncthreads();
  build_owners(gs, nelem, nprim, nrad, own);
  __syncthreads();
  const int b = blockIdx.y / nang, cc = blockIdx.y % nang;
  const int np2 = nprim * nprim;
  const size_t Mdim = (size_t)nang * nprim, xsz = Mdim * Mdim;
  const bool direct = b / XT <= cc / XT;  // else the pair lives at (c', b), transposed
  const int pb = direct ? b : cc, pc = direct ? cc : b;
  const size_t gstride = (size_t)nelem * nang * nang * np2;
  double* out = K4 + ((size_t)b * nang + cc) * nrad * nrad;
  const size_t total = (size_t)nrad * nrad;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(idx / nrad), m = (int)(idx % nrad);
    double acc = 0.0;
    for (int u = 0; u < HELFEM_MAX_OWNERS; ++u) {
      const int sn = own[2 * n + u];
      if (sn < 0) break;
      const int e = sn / nprim, j = sn % nprim;
      for (int v = 0; v < HELFEM_MAX_OWNERS; ++v) {
        const int sv = own[2 * m + v];
        if (sv < 0) break;
        const int f = sv / nprim, k = sv % nprim;
        if (e == f) {
          const double* p = part + (((size_t)e * nang + pb) * nang + pc) * np2 +
                            (direct ? j * nprim + k : k * nprim + j);
          for (int g = 0; g < G; ++g) acc += p[g * gstride];
        } else if (e > f) {
          acc += X[(size_t)(e * (e - 1) / 2 + f) * xsz +
                   ((size_t)b * nprim + j) * Mdim + (size_t)cc * nprim + k];
        } else {
          acc += X[(size_t)(f * (f - 1) / 2 + e) * xsz +
                   ((size_t)cc * nprim + k) * Mdim + (size_t)b * nprim + j];
        }
      }
    }
    out[idx] = acc;
  }
}

template <bool OCC, int TM>
static cudaError_t launch_inelem_tm(const double* A, const double* B, const double* teiJ3,
                                    const int* ilm, const int* gidx, double* part, int S,
                                    int nelem, int nprim, int nang, int nrad, int no, int G,
                                    int ns, int wbuf, cudaStream_t st) {
  const ExdiaGeom q = exdia_geom(nprim, no, 64 * TM);
  const size_t smem =
      (exdia_smem_doubles(q, OCC, ns, wbuf) + exdia_gs_doubles(nprim)) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(exdia_inelem_kernel<OCC, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int mtiles = (nprim * nprim + 64 * TM - 1) / (64 * TM), ntile = (nang + XT - 1) / XT;
  const int cpg = (S + G - 1) / G;
  exdia_inelem_kernel<OCC, TM>
      <<<dim3(mtiles * ntile * (ntile + 1) / 2, nelem, G), EX_THREADS, smem, st>>>(
          A, B, teiJ3, ilm, gidx, part, S, nelem, nprim, nang, nrad, no, cpg, ns, wbuf);
  return cudaGetLastError();
}

template <bool OCC>
static cudaError_t launch_inelem(const double* A, const double* B, const double* teiJ3,
                                 const int* ilm, const int* gidx, double* part, int S,
                                 int nelem, int nprim, int nang, int nrad, int no, int G,
                                 int ns, int wbuf, cudaStream_t st) {
  switch (exdia_tm(nprim)) {
    case 1:
      return launch_inelem_tm<OCC, 1>(A, B, teiJ3, ilm, gidx, part, S, nelem, nprim, nang,
                                      nrad, no, G, ns, wbuf, st);
    case 2:
      return launch_inelem_tm<OCC, 2>(A, B, teiJ3, ilm, gidx, part, S, nelem, nprim, nang,
                                      nrad, no, G, ns, wbuf, st);
    default:
      return launch_inelem_tm<OCC, 4>(A, B, teiJ3, ilm, gidx, part, S, nelem, nprim, nang,
                                      nrad, no, G, ns, wbuf, st);
  }
}

static cudaError_t launch_assemble(const double* part, const double* X,
                                   const int* gidx, double* K4, int G, int nelem,
                                   int nprim, int nang, int nrad, cudaStream_t st) {
  const size_t smem = (size_t)(nelem * nprim + 2 * nrad) * sizeof(int);
  int tiles = (int)(((size_t)nrad * nrad + 255) / 256);
  if (tiles > 8) tiles = 8;
  exdia_assemble_kernel<<<dim3(tiles, nang * nang), 256, smem, st>>>(
      part, X, gidx, K4, G, nelem, nprim, nang, nrad);
  return cudaGetLastError();
}

// Caller-allocated scratch: part [2 G, nelem, nang, nang, np^2] (G = channel
// groups of the in-element GEMM, two passes each; ns stages and wbuf
// window buffers, as the wrapper sized the shared memory), ud and vd [nelem, S*2*no, nang*np], X [nelem*(nelem-1)/2,
// nang*np, nang*np]. Output K4 [nang, nang, nrad, nrad]. Returns a
// cudaError_t.
extern "C" int radial_exchange_dia_occ_launch(
    const double* Uw, const double* V, const double* teiJ3, const double* dP0,
    const double* dP2, const double* dQ0, const double* dQ2, const int* ilm,
    const int* gidx, double* part, double* ud, double* vd, double* X, double* K4,
    int S, int nelem, int nprim, int nang, int nrad, int no, int G, int ns, int wbuf,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = launch_inelem<true>(Uw, V, teiJ3, ilm, gidx, part, S, nelem, nprim, nang, nrad, no, G,
                            ns, wbuf, st);
  if (err != cudaSuccess) return (int)err;
  const int npairs = nelem * (nelem - 1) / 2;
  if (npairs > 0) {
    exdia_transform_kernel<<<dim3(nang, nelem, S), 128, nprim * sizeof(int), st>>>(
        Uw, V, dP0, dP2, dQ0, dQ2, ilm, gidx, ud, vd, S, nelem, nprim, nang, nrad, no);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int Mdim = nang * nprim, tiles = (Mdim + 63) / 64;
    exdia_cross_gemm_kernel<<<dim3(tiles * tiles, npairs), 256, 0, st>>>(
        ud, vd, X, S * 2 * no, Mdim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_assemble(part, X, gidx, K4, 2 * G, nelem, nprim, nang, nrad, st);
}

// Scratch part and X as above; R [S, 4, nang, nang, nrad, nrad].
extern "C" int radial_exchange_dia_launch(
    const double* R, const double* teiJ3, const double* dP0, const double* dP2,
    const double* dQ0, const double* dQ2, const int* ilm, const int* gidx,
    double* part, double* X, double* K4, int S, int nelem, int nprim, int nang,
    int nrad, int G, int ns, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = launch_inelem<false>(R, nullptr, teiJ3, ilm, gidx, part, S, nelem, nprim, nang, nrad,
                             0, G, ns, 0, st);
  if (err != cudaSuccess) return (int)err;
  const int npairs = nelem * (nelem - 1) / 2;
  if (npairs > 0) {
    if (nprim > EX_MAX_NPRIM) return (int)cudaErrorInvalidValue;
    const size_t smem = 6 * (size_t)nprim * nprim * sizeof(double);
    auto kernel = nprim <= 32 ? exdia_cross_dense_kernel<4> : exdia_cross_dense_kernel<EX_CROSS_U>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(nang * nang, npairs), 256, smem, st>>>(R, dP0, dP2, dQ0, dQ2, ilm, gidx, X, S,
                                                         nelem, nprim, nang, nrad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_assemble(part, X, gidx, K4, 2 * G, nelem, nprim, nang, nrad, st);
}
