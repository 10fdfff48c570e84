// Diatomic XC field kernel K4: the density and its two gradient components
// rho, drho_u, drho_v [ns, nelem, nq, nt] on the prolate-spheroidal grid,
// from ns = 1 or 2 spin densities P [ns, nbf, nbf] (bf = a * nrad + n), in
// f64.
//
// Replaces the LDA/GGA part of helfem_tpu/models/diatomic_dft.py:_fields_dia
// (diatomic_dft.py:97-103), XLA einsums over a padded 4-index copy
// P4p[a, b, nrad+1, nrad+1] of the density:
//
//   D1[a,b,e,q]  = sum_ij P[a gidx[e,i], b gidx[e,j]] B[e,q,i] B[e,q,j]
//   Dmu[a,b,e,q] = 2 sum_ij P[..] dB[e,q,i] B[e,q,j]
//   rho[e,q,t]    = sum_ab TT[a,b,t] D1[a,b,e,q]
//   drho_u[e,q,t] = invh[e,q,t] sum_ab TT[a,b,t] Dmu[a,b,e,q]
//   drho_v[e,q,t] = sqeta[t] invh[e,q,t] sum_ab dTT[a,b,t] D1[a,b,e,q]
//
// and in tau mode (meta-GGAs; diatomic_dft.py:104-110, the atomic grid's
// atomic_dft.py:109-114 and the SAD atom's sadatom.py:220-230) a fourth
// field from a third folded product Ddd = sum_ij P[..] dB[e,q,i] dB[e,q,j]:
//
//   tau[e,q,t] = 1/2 (f1 sum_ab TT Ddd + f2 sum_ab dTT2 D1 + f3 sum_ab TTm2 D1)
//
// with the grid's per-point factors f1, f2, f3 = tfac[0..2, e, q, t]
// (models/xc_grid.py).
//
// In laplacian mode (laplacian-level meta-GGAs, BR89; diatomic_dft.py:
// 112-123, atomic_dft.py:116-123) a fifth field from a fourth folded
// product D2 = 2 sum_ij P[..] d2B[e,q,i] B[e,q,j], with the grid's factors
// g1..g4 = lfac[0..3, e, q, t] and its tables LLTT, TTmm:
//
//   lapl = g1 sum_ab TT D2 + g2 sum_ab TT Dmu - g3 sum_ab LLTT D1
//          - g4 sum_ab TTmm D1 + 4 tau
//
// one form for the diatomic and the atomic grid (models/xc_grid.py).
//
// Work: only the live shell pairs count (TT or dTT not identically zero:
// m_a = m_b), and TT, dTT are symmetric in (a, b) (both checked once when
// the grid is built, models/diatomic_dft.py:pair_tables). So (a, b) and
// (b, a) fold into one unordered pair p with the window S_p = W_ab + W_ba
// (W_ab[i,j] = P[a gidx[e,i], b gidx[e,j]], trash slot read as 0; S_p = W_aa
// for a = b): D1[a,b] + D1[b,a] = B^T S_p B and Dmu[a,b] + Dmu[b,a] =
// 2 dB^T S_p B, exact for any P. That halves both stages, and dead pairs
// cost nothing.
//
// One cooperative launch for all spins, two phases joined by a grid-wide
// barrier, both on the FP64 tensor cores (mma.sync m8n8k4, csrc/dmma.cuh):
//   1. items (spin, element, 8 pairs, up to 128 radial points): the pairs'
//      windows and the element's B, dB (transposed, zero-padded, strides 4
//      mod 16 so that fragment loads are conflict-free) are staged in shared
//      memory, four loads in flight per thread; per pair and 8 points a warp
//      forms U = B S_p (depth nprim), then D1f = sum_j U B and Dmuf =
//      2 sum_j U dB, summed over its lanes by shuffles; in tau mode also
//      U' = dB S_p and Dddf = sum_j U' dB, in laplacian mode also D2f =
//      2 sum_j U d2B (d2B staged beside B and dB). The result [ns, nelem,
//      nD, npl, nq] (nD 2, 3 in tau mode, 4 in laplacian mode) stays in L2
//      (0.2 MB at N2, 2.3 MB at lmax=12, for nD 2).
//   2. items (spin, element, 8 points, 8 eta points): rho = D1f TT, u =
//      Dmuf TT, v = D1f dTT over the live pairs (depth npl: 70 at N2, 379 at
//      lmax=12), the pairs split over the block's eight warps and their
//      partial tiles added in warp order through shared memory; invh and
//      sqeta in the epilogue. Tau mode adds Dddf TT, D1f dTT2 and D1f TTm2
//      to each tile and tfac in the epilogue; laplacian mode D2f TT, D1f
//      LLTT and D1f TTmm, and lfac in the epilogue.
// Every sum runs in a fixed order whatever block takes an item: two calls
// give the same bits, and a spin's fields do not depend on ns.
//
// Bound on the H100 (chip_smoke.py:xc_kernel_inputs): a call must read the
// live pairs' windows of P (6.3 MB per spin at lmax=12, 0.45 MB at N2) and
// does 0.1 GFLOP per spin at lmax=12, so it is bound by bytes: about 2 us
// at lmax=12, under 0.3 us at N2, where it is bound by the launch and the
// barrier. The window reads are scattered rows of nprim doubles, which the
// staging takes at a fraction of the card's bandwidth.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace cg = cooperative_groups;

#define XCF_THREADS 256
#define XCF_WARPS (XCF_THREADS / 32)
#define XCF_U 4  // staged entries per thread with their loads in flight together

struct XcfGeom {
  // nD: folded products per pair (2, 3 in tau mode, 4 in laplacian mode);
  // nb: staged element tables (B, dB, and d2B in laplacian mode)
  int ns, nang, nelem, nq, nprim, nrad, nt, npl;
  int pc, qc;        // phase 1: pairs and radial points (a multiple of 8) per item
  int mp, lda, ldq;  // nprim rounded up to 8; row strides of the staged S and B
  int npc, nqc, nD, nb;
};

// MODE 0: rho, drho_u, drho_v; 1 (tau) adds tau; 2 (laplacian) adds tau and
// the density laplacian.
template <int MODE>
__global__ void __launch_bounds__(XCF_THREADS, 2)
    xc_fields_kernel(const double* __restrict__ P, const int* __restrict__ pairs,
                     const int* __restrict__ gidx, const double* __restrict__ Bg,
                     const double* __restrict__ dBg, const double* __restrict__ TTp,
                     const double* __restrict__ dTTp, const double* __restrict__ dTT2p,
                     const double* __restrict__ TTm2p, const double* __restrict__ invh,
                     const double* __restrict__ sqeta, const double* __restrict__ tfac,
                     const double* __restrict__ d2Bg, const double* __restrict__ LLTTp,
                     const double* __restrict__ TTmmp, const double* __restrict__ lfac,
                     double* D, double* __restrict__ out, XcfGeom g) {
  constexpr bool TAU = MODE >= 1, LAPL = MODE == 2;
  extern __shared__ __align__(16) double sm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // DMMA fragment row / column group
  const int np = g.nprim, mp = g.mp, qc = g.qc;
  const size_t nbf = (size_t)g.nang * g.nrad;

  // ---- phase 1: folded pair stage. Per pair p and 8 radial points,
  // U = B S_p on DMMA (m8n8k4: rows q, columns j, depth i), then
  // D1f[p,q] = sum_j U[q,j] B[q,j], Dmuf = 2 sum_j U[q,j] dB[q,j], the sum
  // over the lanes' column groups by a butterfly of shuffles; in tau mode
  // also U' = dB S_p and Dddf = sum_j U'[q,j] dB[q,j]; in laplacian mode
  // also D2f = 2 sum_j U[q,j] d2B[q,j].
  // D: [ns, nelem, nD, npl, nq] ----
  const int n1 = g.ns * g.nelem * g.npc * g.nqc;
  double* S = sm;                      // [pc][mp][lda] windows S_p = W_ab + W_ba, zero-padded
  double* Bt = S + g.pc * mp * g.lda;  // [mp][ldq] B[q, j] transposed, zero-padded
  double* dBt = Bt + mp * g.ldq;       // [mp][ldq]
  double* d2Bt = dBt + mp * g.ldq;     // [mp][ldq], laplacian mode only
  int* rowoff = reinterpret_cast<int*>(Bt + g.nb * mp * g.ldq);  // [pc][2]: a nrad, b nrad
  int* gs = rowoff + 2 * g.pc;                             // [np]: gidx[e, :]
  const int nS = g.pc * mp * g.lda, nB = mp * g.ldq;
  for (int item = blockIdx.x; item < n1; item += gridDim.x) {
    int r = item;
    const int qx = r % g.nqc;
    r /= g.nqc;
    const int px = r % g.npc;
    r /= g.npc;
    const int e = r % g.nelem, s = r / g.nelem;
    const int p0 = px * g.pc, q0 = qx * qc;
    const int npx = min(g.pc, g.npl - p0), nqx = min(qc, g.nq - q0);
    const double* Ps = P + (size_t)s * nbf * nbf;
    __syncthreads();  // the previous item is consumed
    for (int k = tid; k < 2 * npx; k += blockDim.x) rowoff[k] = pairs[2 * p0 + k] * g.nrad;
    for (int k = tid; k < np; k += blockDim.x) gs[k] = gidx[e * np + k];
    __syncthreads();
    // the windows, XCF_U entries per thread with their loads in flight together
    for (int base = tid; base < nS; base += XCF_U * blockDim.x) {
      double v[XCF_U];
#pragma unroll
      for (int u = 0; u < XCF_U; ++u) {
        const int idx = base + u * blockDim.x;
        const int pl = idx / (mp * g.lda), rem = idx - pl * mp * g.lda;
        const int i = rem / g.lda, j = rem - i * g.lda;
        v[u] = 0.0;
        if (idx < nS && pl < npx && i < np && j < np) {
          const int gi = gs[i], gj = gs[j];
          if (gi < g.nrad && gj < g.nrad) {
            const int a = rowoff[2 * pl], b = rowoff[2 * pl + 1];
            v[u] = Ps[(size_t)(a + gi) * nbf + b + gj];
            if (a != b) v[u] += Ps[(size_t)(b + gi) * nbf + a + gj];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < XCF_U; ++u)
        if (base + u * blockDim.x < nS) S[base + u * blockDim.x] = v[u];
    }
    for (int base = tid; base < nB; base += XCF_U * blockDim.x) {
      double v[XCF_U], dv[XCF_U], d2v[XCF_U];
#pragma unroll
      for (int u = 0; u < XCF_U; ++u) {
        const int idx = base + u * blockDim.x;
        const int j = idx / g.ldq, ql = idx - j * g.ldq;
        const bool in = idx < nB && j < np && ql < nqx;
        const size_t src = in ? ((size_t)e * g.nq + q0 + ql) * np + j : 0;
        v[u] = in ? Bg[src] : 0.0;
        dv[u] = in ? dBg[src] : 0.0;
        if constexpr (LAPL) d2v[u] = in ? d2Bg[src] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < XCF_U; ++u) {
        if (base + u * blockDim.x < nB) {
          Bt[base + u * blockDim.x] = v[u];
          dBt[base + u * blockDim.x] = dv[u];
          if constexpr (LAPL) d2Bt[base + u * blockDim.x] = d2v[u];
        }
      }
    }
    __syncthreads();
    const int ntile = (nqx + 7) / 8;
    for (int task = warp; task < npx * ntile; task += XCF_WARPS) {
      const int pl = task / ntile, qt = 8 * (task - pl * ntile);
      const double* Sp = S + pl * mp * g.lda;
      const int q = qt + gq;  // this lane's radial point (row of U)
      double v1 = 0.0, vm = 0.0, vd = 0.0, v2 = 0.0;
      for (int n0 = 0; n0 < mp; n0 += 8) {  // U[q, j] = sum_i B[q, i] S_p[i, j]
        double c0 = 0.0, c1 = 0.0, d0 = 0.0, d1 = 0.0;
        for (int k = 0; k < np; k += 4) {
          const double sv = Sp[(k + tq) * g.lda + n0 + gq];
          dmma884(c0, c1, Bt[(k + tq) * g.ldq + q], sv);
          if constexpr (TAU) dmma884(d0, d1, dBt[(k + tq) * g.ldq + q], sv);  // U' = dB S_p
        }
        const int j = n0 + 2 * tq;  // this lane's columns j, j + 1 of U
        v1 = fma(c0, Bt[j * g.ldq + q], v1);
        v1 = fma(c1, Bt[(j + 1) * g.ldq + q], v1);
        vm = fma(c0, dBt[j * g.ldq + q], vm);
        vm = fma(c1, dBt[(j + 1) * g.ldq + q], vm);
        if constexpr (TAU) {
          vd = fma(d0, dBt[j * g.ldq + q], vd);
          vd = fma(d1, dBt[(j + 1) * g.ldq + q], vd);
        }
        if constexpr (LAPL) {
          v2 = fma(c0, d2Bt[j * g.ldq + q], v2);
          v2 = fma(c1, d2Bt[(j + 1) * g.ldq + q], v2);
        }
      }
#pragma unroll
      for (int k = 1; k < 4; k *= 2) {  // sum over the four column groups tq
        v1 += __shfl_xor_sync(0xffffffffu, v1, k);
        vm += __shfl_xor_sync(0xffffffffu, vm, k);
        if constexpr (TAU) vd += __shfl_xor_sync(0xffffffffu, vd, k);
        if constexpr (LAPL) v2 += __shfl_xor_sync(0xffffffffu, v2, k);
      }
      if (tq == 0 && q < nqx) {
        double* d1o = D + (((size_t)s * g.nelem + e) * g.nD * g.npl + p0 + pl) * g.nq + q0 + q;
        d1o[0] = v1;
        d1o[(size_t)g.npl * g.nq] = 2.0 * vm;
        if constexpr (TAU) d1o[(size_t)2 * g.npl * g.nq] = vd;
        if constexpr (LAPL) d1o[(size_t)3 * g.npl * g.nq] = 2.0 * v2;
      }
    }
  }

  cg::this_grid().sync();

  // ---- phase 2: grid contraction rho = D1f TT, u = Dmuf TT, v = D1f dTT
  // (and in tau mode T1 = Dddf TT, T2 = D1f dTT2, T3 = D1f TTm2; in
  // laplacian mode also L1 = D2f TT, L3 = D1f LLTT, L4 = D1f TTmm) over the
  // live pairs on DMMA: one 8 x 8 (q, t) tile per block, its eight warps
  // each a share of the pairs, their partial tiles added in warp order
  // through shared memory ----
  constexpr int NACC = LAPL ? 9 : TAU ? 6 : 3;  // partial tiles per warp
  constexpr int NOUT = 3 + MODE;                // output fields
  const int nqt = (g.nq + 7) / 8, ntt = (g.nt + 7) / 8, nks = (g.npl + 3) / 4;
  const int n2 = g.ns * g.nelem * nqt * ntt;
  const size_t nfield = (size_t)g.ns * g.nelem * g.nq * g.nt;
  const size_t nplane = (size_t)g.nelem * g.nq * g.nt;  // one tfac factor
  double* red = sm;  // [warps][NACC][64]
  for (int item = blockIdx.x; item < n2; item += gridDim.x) {
    const int tt = 8 * (item % ntt), qt = 8 * (item / ntt % nqt), es = item / (ntt * nqt);
    const double* D1 = D + (size_t)es * g.nD * g.npl * g.nq;
    const double* Dm = D1 + (size_t)g.npl * g.nq;
    const double* Dd = Dm + (size_t)g.npl * g.nq;  // tau mode only
    const double* D2 = Dd + (size_t)g.npl * g.nq;  // laplacian mode only
    const int q = qt + gq, t = tt + gq;
    double acc[NACC][2];
#pragma unroll
    for (int f = 0; f < NACC; ++f) acc[f][0] = acc[f][1] = 0.0;
#pragma unroll 4
    for (int kk = warp; kk < nks; kk += XCF_WARPS) {
      const int p = 4 * kk + tq;
      const bool pa = p < g.npl, qa = pa && q < g.nq, ta = pa && t < g.nt;
      const double a1 = qa ? __ldcg(D1 + (size_t)p * g.nq + q) : 0.0;
      const double am = qa ? __ldcg(Dm + (size_t)p * g.nq + q) : 0.0;
      const double bt = ta ? __ldg(TTp + (size_t)p * g.nt + t) : 0.0;
      const double bd = ta ? __ldg(dTTp + (size_t)p * g.nt + t) : 0.0;
      dmma884(acc[0][0], acc[0][1], a1, bt);
      dmma884(acc[1][0], acc[1][1], am, bt);
      dmma884(acc[2][0], acc[2][1], a1, bd);
      if constexpr (TAU) {
        const double ad = qa ? __ldcg(Dd + (size_t)p * g.nq + q) : 0.0;
        const double b2 = ta ? __ldg(dTT2p + (size_t)p * g.nt + t) : 0.0;
        const double b3 = ta ? __ldg(TTm2p + (size_t)p * g.nt + t) : 0.0;
        dmma884(acc[3][0], acc[3][1], ad, bt);
        dmma884(acc[4][0], acc[4][1], a1, b2);
        dmma884(acc[5][0], acc[5][1], a1, b3);
      }
      if constexpr (LAPL) {
        const double a2 = qa ? __ldcg(D2 + (size_t)p * g.nq + q) : 0.0;
        const double bl = ta ? __ldg(LLTTp + (size_t)p * g.nt + t) : 0.0;
        const double bm = ta ? __ldg(TTmmp + (size_t)p * g.nt + t) : 0.0;
        dmma884(acc[6][0], acc[6][1], a2, bt);
        dmma884(acc[7][0], acc[7][1], a1, bl);
        dmma884(acc[8][0], acc[8][1], a1, bm);
      }
    }
    __syncthreads();  // the previous item's partial tiles are consumed
    double* rw = red + warp * NACC * 64 + gq * 8 + 2 * tq;
#pragma unroll
    for (int f = 0; f < NACC; ++f) {
      rw[f * 64] = acc[f][0];
      rw[f * 64 + 1] = acc[f][1];
    }
    __syncthreads();
    // one (field, q, t) slot per thread, a second round for the laplacian
    for (int slot = tid; slot < NOUT * 64; slot += XCF_THREADS) {
      const int f = slot / 64, qq = qt + (slot % 64) / 8, t2 = tt + slot % 8;
      const int c = slot % 64;
      if (qq < g.nq && t2 < g.nt) {
        const int e = es % g.nelem;
        const size_t o = ((size_t)es * g.nq + qq) * g.nt + t2;
        const size_t pt = ((size_t)e * g.nq + qq) * g.nt + t2;
        double v;
        if (f < 3) {
          v = 0.0;
          for (int w = 0; w < XCF_WARPS; ++w) v += red[(w * NACC + f) * 64 + c];
          const double h = invh[pt];
          v = f == 0 ? v : (f == 1 ? v * h : v * (sqeta[t2] * h));
        } else {  // tau = 1/2 (f1 T1 + f2 T2 + f3 T3)
          double tk[3] = {0.0, 0.0, 0.0};
          for (int w = 0; w < XCF_WARPS; ++w)
#pragma unroll
            for (int k = 0; k < 3; ++k) tk[k] += red[(w * NACC + 3 + k) * 64 + c];
          v = 0.5 * (tfac[pt] * tk[0] + tfac[nplane + pt] * tk[1] + tfac[2 * nplane + pt] * tk[2]);
          if constexpr (LAPL) {
            if (f == 4) {  // lapl = g1 L1 + g2 (Dmuf TT) - g3 L3 - g4 L4 + 4 tau
              double lk[4] = {0.0, 0.0, 0.0, 0.0};
              for (int w = 0; w < XCF_WARPS; ++w) {
                lk[0] += red[(w * NACC + 6) * 64 + c];
                lk[1] += red[(w * NACC + 1) * 64 + c];
                lk[2] += red[(w * NACC + 7) * 64 + c];
                lk[3] += red[(w * NACC + 8) * 64 + c];
              }
              v = lfac[pt] * lk[0] + lfac[nplane + pt] * lk[1] - lfac[2 * nplane + pt] * lk[2] -
                  lfac[3 * nplane + pt] * lk[3] + 4.0 * v;
            }
          }
        }
        out[f * nfield + o] = v;
      }
    }
  }
}

// Blocks of the kernel instance `kern` (of mode `mode`) that one SM holds at
// `smem` bytes of dynamic shared memory, cached per instance, device and
// size. Each instance is first allowed the whole 227 KB and the largest
// shared-memory carveout, once per device, so that the occupancy computed
// here is the one a cooperative launch is held to.
static int xcf_blocks_per_sm(const void* kern, int mode, int device, int smem) {
  static bool ready[3][8] = {{false}};
  static int cached_dev[8] = {-1, -1, -1, -1, -1, -1, -1, -1}, cached_smem[8], cached_n[8],
             cached_mode[8];
  static int next = 0;
  for (int k = 0; k < 8; ++k)
    if (cached_dev[k] == device && cached_smem[k] == smem && cached_mode[k] == mode)
      return cached_n[k];
  if (!ready[mode][device]) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return 0;
    ready[mode][device] = true;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, XCF_THREADS, smem) != cudaSuccess)
    return 0;
  cached_dev[next] = device;
  cached_smem[next] = smem;
  cached_mode[next] = mode;
  cached_n[next] = n;
  next = (next + 1) % 8;
  return n;
}

// The launch's arguments, as kernels/dia_xc_fields.py:_Launch lays them out:
// the pointers first, then the sizes. D: scratch [ns, nelem, nD, npl, nq]
// (nD = 2 + mode); out: [3 + mode, ns, nelem, nq, nt] (rho, drho_u,
// drho_v[, tau[, lapl]]). pc, qc (a multiple of 8) and smem from the
// wrapper's plan (fields_plan); dTT2p, TTm2p and tfac are read in modes 1
// and 2, d2Bg, LLTTp, TTmmp and lfac in mode 2 (laplacian) only.
struct XcfLaunch {
  const double* P;
  const int *pairs, *gidx;
  const double *Bg, *dBg, *TTp, *dTTp, *dTT2p, *TTm2p, *invh, *sqeta, *tfac;
  const double *d2Bg, *LLTTp, *TTmmp, *lfac;
  double *D, *out;
  void* stream;
  int ns, nang, nelem, nq, nprim, nrad, nt, npl, pc, qc, smem, device, mode;
};

// Returns a cudaError_t.
extern "C" int dia_xc_fields_launch(const XcfLaunch* a) {
  const cudaError_t set = cudaSetDevice(a->device);
  if (set != cudaSuccess) return (int)set;
  if (a->pc < 1 || a->qc < 8 || a->qc % 8 || a->mode < 0 || a->mode > 2)
    return (int)cudaErrorInvalidValue;
  static int sm_count[8] = {0};
  if (a->device < 0 || a->device >= 8) return (int)cudaErrorInvalidDevice;
  if (!sm_count[a->device]) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sm_count[a->device], cudaDevAttrMultiProcessorCount, a->device);
    if (err != cudaSuccess) return (int)err;
  }
  const void* kern = a->mode == 2   ? (const void*)xc_fields_kernel<2>
                     : a->mode == 1 ? (const void*)xc_fields_kernel<1>
                                    : (const void*)xc_fields_kernel<0>;
  const int per_sm = xcf_blocks_per_sm(kern, a->mode, a->device, a->smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int mp = (a->nprim + 7) / 8 * 8;
  XcfGeom g{a->ns,  a->nang, a->nelem, a->nq, a->nprim, a->nrad, a->nt,
            a->npl, a->pc,   a->qc,    mp,    dmma_ld(mp), dmma_ld(a->qc),
            (a->npl + a->pc - 1) / a->pc, (a->nq + a->qc - 1) / a->qc, 2 + a->mode,
            a->mode == 2 ? 3 : 2};
  const long long n1 = (long long)g.ns * g.nelem * g.npc * g.nqc;
  const long long n2 = (long long)g.ns * g.nelem * ((g.nq + 7) / 8) * ((g.nt + 7) / 8);
  const long long want = n1 > n2 ? n1 : n2;
  int grid = per_sm * sm_count[a->device];
  if (want < grid) grid = (int)want;
  void* args[] = {(void*)&a->P,     (void*)&a->pairs, (void*)&a->gidx,  (void*)&a->Bg,
                  (void*)&a->dBg,   (void*)&a->TTp,   (void*)&a->dTTp,  (void*)&a->dTT2p,
                  (void*)&a->TTm2p, (void*)&a->invh,  (void*)&a->sqeta, (void*)&a->tfac,
                  (void*)&a->d2Bg,  (void*)&a->LLTTp, (void*)&a->TTmmp, (void*)&a->lfac,
                  (void*)&a->D,     (void*)&a->out,   &g};
  return (int)cudaLaunchCooperativeKernel(kern, grid, XCF_THREADS, args, (size_t)a->smem,
                                          (cudaStream_t)a->stream);
}
