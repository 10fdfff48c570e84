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
// (0,0), (0,2), (2,2); (2,0) is read as (0,2) transposed), indexed in the
// exchange order (ij|kl) -> rows (jk), columns (il): helfem_tpu's teiK, a
// permuted copy of the table, is not needed.
//
// Design. The cross-element terms are formed pairwise, one (e>f) window
// pair at a time, so there is no prefix sum over elements and none of its
// cancellation. The in-element term is a tiled GEMM per element, M = (jk),
// N = shell pairs in 8x8 tiles with only the tiles that hold some b <= c'
// computed (Kd[b,c',j,k] = Kd[c',b,k,j]), K = (channel, F, il); the R tile
// is gathered (K7) or formed from U/V windows staged in shared memory (K6)
// on the fly. Channel groups run in parallel blocks into partial sums that
// the assembly adds in a fixed order. K6's cross term factors completely,
// X = ud^T vd with ud = sum_q s_q dQ_q U_q and vd = sum_r s_r dP_r V_r (one
// transform launch, then one tiled GEMM per element pair); K7's contracts
// each R window with its two moment blocks. The assembly is owner-computes
// (fem_owners.cuh): no atomics, the same bits on every run.
//
// Bound on the H100: operations. At the N2 lmax=12 shapes (nang 59, np 15,
// 125 channels, no 9) K6 does 0.52 TFLOP per call against 1.2 GB of tables;
// at the N2 (6,6) bench shapes 1.8 GFLOP in four launches. Plain DFMA
// tiles with single-buffered loads, no tensor cores: DMMA, TMA staging and
// a register-blocked R formation are later work (PERF.md has the times).

#include <cuda_runtime.h>

#include "fem_owners.cuh"

#define XT 8    // shell-pair tile edge: 8 x 8 pairs = 64 GEMM columns
#define XBN 64  // GEMM columns per block
#define XBK 16  // GEMM depth per step
#define XRS 65  // row stride of the R tile in shared memory
// resident blocks per multiprocessor asked of ptxas for the in-element GEMM
// (128 registers a thread; unconstrained it takes 166-174 and one block)
#define EXDIA_MIN_BLOCKS 2

// In-element GEMM. grid (mtiles * ntile^2, nelem, G), 256 threads as 16 x 16
// with a TM x 4 register tile each: rows ty TM .. ty TM + TM - 1 and the
// interleaved columns tx, tx + 16, tx + 32, tx + 48, so that a half-warp
// reads 16 neighbouring doubles of the R tile (no bank conflict); BM = 16 TM
// rows (jk). Dynamic shared
// memory: T tile, R tile, and for K6 the U and V windows of the block's
// shells.
template <bool OCC, int TM>
__global__ void __launch_bounds__(256, EXDIA_MIN_BLOCKS) exdia_inelem_kernel(
    const double* __restrict__ A, const double* __restrict__ B,
    const double* __restrict__ teiJ3, const int* __restrict__ ilm,
    const int* __restrict__ gidx, double* __restrict__ part, int S, int nelem,
    int nprim, int nang, int nrad, int no, int cpg) {
  constexpr int BM = 16 * TM;
  constexpr int TS = BM + 1;
  extern __shared__ double sm[];
  __shared__ int gs[32];
  double* Tsh = sm;
  double* Rsh = Tsh + XBK * TS;
  double* Ush = Rsh + XBK * XRS;
  const int no2 = 2 * no;
  // one shell's window [nprim][2 no], padded to an odd count of doubles so
  // that the eight shells of a tile start in different banks
  const int wst = (nprim * no2) | 1;
  const int wsz = 2 * XT * wst;  // U (or V) windows of one block
  double* Vsh = Ush + wsz;

  const int np2 = nprim * nprim;
  const int mtiles = (np2 + BM - 1) / BM;
  const int ntile = (nang + XT - 1) / XT;
  const int mt = blockIdx.x % mtiles;
  const int bt = (blockIdx.x / mtiles) / ntile, ct = (blockIdx.x / mtiles) % ntile;
  if (bt > ct) return;  // no b <= c' in this tile
  const int e = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid < nprim) gs[tid] = gidx[e * nprim + tid];
  __syncthreads();

  double acc[TM][4];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0;

  const int s_end = min(S, (g + 1) * cpg);
  const size_t blk = (size_t)np2 * np2;
  const int nrad1 = nrad + 1;
  for (int s = g * cpg; s < s_end; ++s) {
    const int c = ilm[s];
    if (OCC) {
      for (int idx = tid; idx < 2 * XT * nprim * no2; idx += 256) {
        const int o2 = idx % no2, i = (idx / no2) % nprim;
        const int sl = (idx / (no2 * nprim)) % XT, q = idx / (no2 * nprim * XT);
        const int t = o2 / no, o = o2 % no, n = gs[i];
        const int b = bt * XT + sl, cc = ct * XT + sl;
        const size_t qt = ((size_t)s * 2 + q) * 2 + t;
        const int dst = (q * XT + sl) * wst + i * no2 + o2;
        Ush[dst] = b < nang ? A[((qt * nang + b) * nrad1 + n) * no + o] : 0.0;
        Vsh[dst] = cc < nang ? B[((qt * nang + cc) * nrad1 + n) * no + o] : 0.0;
      }
      __syncthreads();
    }
    for (int F = 0; F < 4; ++F) {
      const int q = F >> 1, r = F & 1;
      const int fam = F == 3 ? 2 : (F == 0 ? 0 : 1);
      const bool tr = F == 2;  // (2,0) = (0,2) transposed
      const double* T = teiJ3 + ((size_t)(c * 3 + fam) * nelem + e) * blk;
      const double sign = (OCC && q != r) ? -1.0 : 1.0;
      for (int k0 = 0; k0 < np2; k0 += XBK) {
        for (int idx = tid; idx < XBK * BM; idx += 256) {
          const int kk = idx % XBK, row = idx / XBK;
          const int jk = mt * BM + row, il = k0 + kk;
          double v = 0.0;
          if (jk < np2 && il < np2) {
            const int j = jk / nprim, k = jk % nprim, i = il / nprim, l = il % nprim;
            const size_t ij = i * nprim + j, kl = k * nprim + l;
            v = tr ? T[kl * np2 + ij] : T[ij * np2 + kl];
          }
          Tsh[kk * TS + row] = v;
        }
        for (int idx = tid; idx < XBK * XBN; idx += 256) {
          double v = 0.0;
          if (OCC) {
            const int kk = idx / XBN, col = idx % XBN, il = k0 + kk;
            if (il < np2) {
              const int i = il / nprim, l = il % nprim;
              const double* up = Ush + (q * XT + col / XT) * wst + i * no2;
              const double* vp = Vsh + (r * XT + col % XT) * wst + l * no2;
              for (int x = 0; x < no2; ++x) v += up[x] * vp[x];
              v *= sign;
            }
            Rsh[kk * XRS + col] = v;
          } else {
            const int kk = idx % XBK, col = idx / XBK, il = k0 + kk;
            const int b = bt * XT + col / XT, cc = ct * XT + col % XT;
            if (il < np2 && b < nang && cc < nang) {
              const int n = gs[il / nprim], m = gs[il % nprim];
              if (n < nrad && m < nrad)
                v = A[((((size_t)s * 4 + F) * nang + b) * nang + cc) * nrad * nrad +
                      (size_t)n * nrad + m];
            }
            Rsh[kk * XRS + col] = v;
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < XBK; ++kk) {
          double a[TM], b[4];
#pragma unroll
          for (int u = 0; u < TM; ++u) a[u] = Tsh[kk * TS + ty * TM + u];
#pragma unroll
          for (int v = 0; v < 4; ++v) b[v] = Rsh[kk * XRS + tx + 16 * v];
#pragma unroll
          for (int u = 0; u < TM; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] += a[u] * b[v];
        }
        __syncthreads();
      }
    }
  }
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int jk = mt * BM + ty * TM + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int col = tx + 16 * v;
      const int b = bt * XT + col / XT, cc = ct * XT + col % XT;
      if (jk < np2 && b < nang && cc < nang)
        part[((((size_t)g * nelem + e) * nang + b) * nang + cc) * np2 + jk] = acc[u][v];
    }
  }
}

// K6 cross factors. grid (nang, nelem, S), 128 threads.
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
  __shared__ int gs[32];
  const int b = blockIdx.x, e = blockIdx.y, s = blockIdx.z, c = ilm[s];
  if (threadIdx.x < nprim) gs[threadIdx.x] = gidx[e * nprim + threadIdx.x];
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
// threads; each thread owns up to four (i, x) outputs (nprim <= 32).
// Dynamic shared memory: 6 np^2 doubles (dQ0, dQ2, dP0, dP2, R window, Y).
__global__ void __launch_bounds__(256) exdia_cross_dense_kernel(
    const double* __restrict__ R, const double* __restrict__ dP0,
    const double* __restrict__ dP2, const double* __restrict__ dQ0,
    const double* __restrict__ dQ2, const int* __restrict__ ilm,
    const int* __restrict__ gidx, double* __restrict__ X, int S, int nelem,
    int nprim, int nang, int nrad) {
  extern __shared__ double sm[];
  __shared__ int ge[32], gf[32];
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
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
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
static cudaError_t launch_inelem(const double* A, const double* B,
                                 const double* teiJ3, const int* ilm,
                                 const int* gidx, double* part, int S, int nelem,
                                 int nprim, int nang, int nrad, int no, int G,
                                 cudaStream_t st) {
  constexpr int BM = 16 * TM;
  const int np2 = nprim * nprim;
  size_t smem = (size_t)(XBK * (BM + 1) + XBK * XRS) * sizeof(double);
  if (OCC) smem += 2 * (size_t)(2 * XT * ((nprim * 2 * no) | 1)) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(exdia_inelem_kernel<OCC, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int mtiles = (np2 + BM - 1) / BM, ntile = (nang + XT - 1) / XT;
  const int cpg = (S + G - 1) / G;
  exdia_inelem_kernel<OCC, TM><<<dim3(mtiles * ntile * ntile, nelem, G), 256, smem, st>>>(
      A, B, teiJ3, ilm, gidx, part, S, nelem, nprim, nang, nrad, no, cpg);
  return cudaGetLastError();
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

// Caller-allocated scratch: part [G, nelem, nang, nang, np^2] (G = channel
// groups of the in-element GEMM), ud and vd [nelem, S*2*no, nang*np], X [nelem*(nelem-1)/2,
// nang*np, nang*np]. Output K4 [nang, nang, nrad, nrad]. Returns a
// cudaError_t.
extern "C" int radial_exchange_dia_occ_launch(
    const double* Uw, const double* V, const double* teiJ3, const double* dP0,
    const double* dP2, const double* dQ0, const double* dQ2, const int* ilm,
    const int* gidx, double* part, double* ud, double* vd, double* X, double* K4,
    int S, int nelem, int nprim, int nang, int nrad, int no, int G, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = nprim * nprim <= 64
            ? launch_inelem<true, 4>(Uw, V, teiJ3, ilm, gidx, part, S, nelem, nprim,
                                     nang, nrad, no, G, st)
            : launch_inelem<true, 8>(Uw, V, teiJ3, ilm, gidx, part, S, nelem, nprim,
                                     nang, nrad, no, G, st);
  if (err != cudaSuccess) return (int)err;
  const int npairs = nelem * (nelem - 1) / 2;
  if (npairs > 0) {
    exdia_transform_kernel<<<dim3(nang, nelem, S), 128, 0, st>>>(
        Uw, V, dP0, dP2, dQ0, dQ2, ilm, gidx, ud, vd, S, nelem, nprim, nang, nrad, no);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int Mdim = nang * nprim, tiles = (Mdim + 63) / 64;
    exdia_cross_gemm_kernel<<<dim3(tiles * tiles, npairs), 256, 0, st>>>(
        ud, vd, X, S * 2 * no, Mdim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_assemble(part, X, gidx, K4, G, nelem, nprim, nang, nrad, st);
}

// Scratch part and X as above; R [S, 4, nang, nang, nrad, nrad].
extern "C" int radial_exchange_dia_launch(
    const double* R, const double* teiJ3, const double* dP0, const double* dP2,
    const double* dQ0, const double* dQ2, const int* ilm, const int* gidx,
    double* part, double* X, double* K4, int S, int nelem, int nprim, int nang,
    int nrad, int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = nprim * nprim <= 64
            ? launch_inelem<false, 4>(R, nullptr, teiJ3, ilm, gidx, part, S, nelem,
                                      nprim, nang, nrad, 0, G, st)
            : launch_inelem<false, 8>(R, nullptr, teiJ3, ilm, gidx, part, S, nelem,
                                      nprim, nang, nrad, 0, G, st);
  if (err != cudaSuccess) return (int)err;
  const int npairs = nelem * (nelem - 1) / 2;
  if (npairs > 0) {
    const size_t smem = 6 * (size_t)nprim * nprim * sizeof(double);
    err = cudaFuncSetAttribute(exdia_cross_dense_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    exdia_cross_dense_kernel<<<dim3(nang * nang, npairs), 256, smem, st>>>(
        R, dP0, dP2, dQ0, dQ2, ilm, gidx, X, S, nelem, nprim, nang, nrad);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_assemble(part, X, gidx, K4, G, nelem, nprim, nang, nrad, st);
}
