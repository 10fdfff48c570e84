// Diatomic XC Fock kernel K5: the XC Fock matrices F [ns, nbf, nbf] (bf =
// a * nrad + n) of ns = 1 or 2 spins from their weighted potentials on the
// prolate-spheroidal grid, shell mask included, in f64.
//
// Replaces the LDA/GGA part of helfem_tpu/models/diatomic_dft.py:
// eval_fxc_dia.fock (diatomic_dft.py:156-165), its scatter-add into the
// padded 4-index square (:197-200) and the shell mask applied after it
// (:206-208). Inputs are wvr = w vr, wgu = w gu invh and wgv = w gv invh
// sqeta on the grid [ns, nelem, nq, nt]:
//
//   A1[a,b,e,q] = sum_t wvr TT[a,b,t],  B1 = sum_t wgu TT,  C1 = sum_t wgv dTT
//   Fel[a,b,e,i,j] = sum_q (A1 + C1)[a,b,e,q] B_i B_j + B1[a,b,e,q] dB_i B_j
//                          + B1[b,a,e,q] dB_j B_i        (B = B[e,q,:])
//   F[a nrad + n, b nrad + m] = mask[a nrad + n] mask[b nrad + m] x the sum
//       of Fel[a,b,e,i,j] over the elements e with gidx[e,i] = n, gidx[e,j] = m
//
// In tau mode (meta-GGAs; diatomic_dft.py:174-181, atomic_dft.py:170-176,
// sadatom.py:256-265) a fourth input wvt = w vt adds, with the grid's tau
// factors f1, f2, f3 = tfac[0..2, e, q, t] (models/xc_grid.py),
//
//   Z1 = sum_t 1/2 wvt f1 TT,   T2 = sum_t 1/2 wvt (f2 dTT2 + f3 TTm2)
//   Fel += sum_q Z1 dB_i dB_j + T2 B_i B_j.
//
// In laplacian mode (laplacian-level meta-GGAs, BR89; diatomic_dft.py:
// 182-203, atomic_dft.py:181-189) a fifth input wvl = w vlapl, with the
// grid's factors g1..g4 = lfac[0..3, e, q, t] and tables LLTT, TTmm
// (models/xc_grid.py): the tau terms take wvt + 4 wvl, B1 takes wgu + g2 wvl,
// and
//
//   V1 = sum_t wvl g1 TT,   L = sum_t wvl (g3 LLTT + g4 TTmm)
//   Fel += sum_q V1 (d2B_i B_j + B_i d2B_j) - L B_i B_j.
//
// Work: TT and dTT are symmetric in (a, b) (checked once when the grid is
// built, models/diatomic_dft.py:pair_tables), so A1, B1, C1 are, and
// Fel[b,a] = Fel[a,b], symmetric in (i, j): one element block per live
// unordered pair p, its i <= j half, X_p = A1 + C1 (+ T2 - L) and Y_p =
// B1 (and Z_p = Z1, V_p = V1):
//   Fel_p[i,j] = sum_q X_p[q] B_i B_j + Y_p[q] (dB_i B_j + B_i dB_j)
//                     (+ Z_p[q] dB_i dB_j + V_p[q] (d2B_i B_j + B_i d2B_j)).
// Dead pairs (m_a != m_b) get exact zeros and no work.
//
// One cooperative launch for all spins, three phases joined by grid-wide
// barriers:
//   A. X, Y [ns, nelem, 2, nq, npl] (X, Y, Z [.., 3, ..] in tau mode, X,
//      Y, Z, V [.., 4, ..] in laplacian mode) on
//      the FP64 tensor cores (mma.sync m8n8k4, csrc/dmma.cuh), one 8 x 8
//      (point, pair) tile per warp task, depth nt.
//   B. Fel [ns, nelem, npl, nprim^2] on the tensor cores against the
//      products B_i B_j, dB_i B_j + B_i dB_j, in tau mode dB_i dB_j and in
//      laplacian mode d2B_i B_j + B_i d2B_j,
//      tabulated with the grid (element_tables), one 8 x 8 (pair, ij) tile
//      per warp task, depth nq, written mirrored. Both scratches stay in L2.
//      Phases A and B each also zero half of F with 16-byte stores, which
//      overlap the warps still in their tiles.
//   C. owner-computes assembly of the live pairs' element windows over the
//      zeros: one warp per row segment (spin, pair, orientation (a, b) or
//      (b, a), row n), its lanes over the columns that share an element
//      with n (the grid's band table, at most 2 nprim - 1), each entry the
//      sum of its (at most 2 x 2) element contributions in element order
//      (the owner slots precomputed with the grid and staged in shared
//      memory), times the mask, written once.
// Fixed-order sums throughout: two calls give the same bits, and a spin's
// matrix does not depend on ns.
//
// Bound on the H100 (chip_smoke.py:xc_kernel_inputs): a call writes the
// dense F, 3.5 MB per spin at N2 and 136 MB at lmax=12 (about 41 us), far
// more bytes than it reads or operations it does: it is bound by its
// writes, and at N2 by the launch and the barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace cg = cooperative_groups;

#define XCK_THREADS 256

struct XckGeom {
  int ns, nang, nelem, nq, nprim, nrad, nt, npl, nij, nijp;
  int nXY;  // pair potentials per pair: 2 (X, Y), 3 (X, Y, Z) in tau mode, 4 (+ V) laplacian
};

// MODE 0: LDA/GGA terms; 1 (tau) adds the vtau terms; 2 (laplacian) adds the
// vtau and vlapl terms, at two blocks per SM (its phase A holds four pair
// potentials in registers).
template <int MODE>
__global__ void __launch_bounds__(XCK_THREADS, MODE == 2 ? 2 : 4)
    xc_fock_kernel(const double* __restrict__ wvr, const double* __restrict__ wgu,
                   const double* __restrict__ wgv, const double* __restrict__ wvt,
                   const double* __restrict__ wvl,
                   const int* __restrict__ pairs, const int* __restrict__ band,
                   const int* __restrict__ owners, const double* __restrict__ TTp,
                   const double* __restrict__ dTTp, const double* __restrict__ dTT2p,
                   const double* __restrict__ TTm2p, const double* __restrict__ tfac,
                   const int* __restrict__ ijs, const double* __restrict__ BBs,
                   const double* __restrict__ SSs, const double* __restrict__ DDs,
                   const double* __restrict__ LLTTp, const double* __restrict__ TTmmp,
                   const double* __restrict__ lfac, const double* __restrict__ S2s,
                   const double* __restrict__ mask, double* XY, double* Fel,
                   double* __restrict__ F, XckGeom g) {
  constexpr bool TAU = MODE >= 1, LAPL = MODE == 2;
  const int tid = threadIdx.x, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // DMMA fragment row / column group
  const int np = g.nprim, np2 = np * np, nt = g.nt;
  const size_t gtid = (size_t)blockIdx.x * blockDim.x + tid;
  const size_t nthr = (size_t)gridDim.x * blockDim.x;
  const int gwarp = (int)(gtid / 32), nwarps = (int)(nthr / 32);
  const size_t nbf = (size_t)g.nang * g.nrad;
  extern __shared__ int tabs[];  // band [nrad][2], owners [nrad][2], pairs [npl][2]
  int* sband = tabs;
  int* sown = sband + 2 * g.nrad;
  int* spair = sown + 2 * g.nrad;
  for (int k = tid; k < 2 * g.nrad; k += blockDim.x) {
    sband[k] = band[k];
    sown[k] = owners[k];
  }
  for (int k = tid; k < 2 * g.npl; k += blockDim.x) spair[k] = pairs[k];
  // (the grid-wide barriers below also order these shared stores)

  // the dense zero fill of F, half after each warp's phase-A tiles and half
  // after its phase-B tiles, so that its stores overlap the tiles still
  // running; phase C then writes the live pairs' element windows over it
  const size_t nF2 = (size_t)g.ns * nbf * nbf / 2;  // double2 stores
  double2* F2 = reinterpret_cast<double2*>(F);

  // ---- phase A: pair potentials X = A1 + C1, Y = B1 [ns, nelem, nXY, nq,
  // npl] on DMMA, one 8 x 8 (q, p) tile per warp task: X = wvr TT^T + wgv
  // dTT^T, Y = wgu TT^T (depth t); in tau mode X += (wvt f2 / 2) dTT2^T +
  // (wvt f3 / 2) TTm2^T and Z = (wvt f1 / 2) TT^T; in laplacian mode wvt
  // -> wvt + 4 wvl, wgu -> wgu + g2 wvl, X -= (g3 wvl) LLTT^T + (g4 wvl)
  // TTmm^T and V = (g1 wvl) TT^T ----
  const int nqt = (g.nq + 7) / 8, npt = (g.npl + 7) / 8;
  const int nA = g.ns * g.nelem * nqt * npt;
  const size_t nplane = (size_t)g.nelem * g.nq * nt;  // one tfac factor
  for (int task = gwarp; task < nA; task += nwarps) {
    const int pt = 8 * (task % npt), qt = 8 * (task / npt % nqt), es = task / (npt * nqt);
    const int q = qt + gq, p = pt + gq;
    const size_t w = ((size_t)es * g.nq + q) * nt;
    const size_t wf = ((size_t)(es % g.nelem) * g.nq + q) * nt;  // tfac's point
    double x0 = 0.0, x1 = 0.0, y0 = 0.0, y1 = 0.0, z0 = 0.0, z1 = 0.0, v0 = 0.0, v1 = 0.0;
#pragma unroll 3
    for (int k = 0; k < nt; k += 4) {
      const int t = k + tq;
      const bool wa = q < g.nq && t < nt, pa = p < g.npl && t < nt;
      const double av = wa ? wvr[w + t] : 0.0, ag = wa ? wgv[w + t] : 0.0;
      const double lv = LAPL && wa ? wvl[w + t] : 0.0;
      const double au = wa ? (LAPL ? fma(lv, lfac[nplane + wf + t], wgu[w + t]) : wgu[w + t])
                           : 0.0;
      const double bt = pa ? TTp[(size_t)p * nt + t] : 0.0;
      const double bd = pa ? dTTp[(size_t)p * nt + t] : 0.0;
      dmma884(x0, x1, av, bt);
      dmma884(x0, x1, ag, bd);
      dmma884(y0, y1, au, bt);
      if constexpr (LAPL) {
        const double l1 = wa ? lv * lfac[wf + t] : 0.0;
        const double l3 = wa ? -lv * lfac[2 * nplane + wf + t] : 0.0;
        const double l4 = wa ? -lv * lfac[3 * nplane + wf + t] : 0.0;
        const double bl = pa ? LLTTp[(size_t)p * nt + t] : 0.0;
        const double bm = pa ? TTmmp[(size_t)p * nt + t] : 0.0;
        dmma884(x0, x1, l3, bl);
        dmma884(x0, x1, l4, bm);
        dmma884(v0, v1, l1, bt);
      }
      if constexpr (TAU) {
        const double hv = wa ? 0.5 * (LAPL ? fma(4.0, lv, wvt[w + t]) : wvt[w + t]) : 0.0;
        const double a1 = wa ? hv * tfac[wf + t] : 0.0;
        const double a2 = wa ? hv * tfac[nplane + wf + t] : 0.0;
        const double a3 = wa ? hv * tfac[2 * nplane + wf + t] : 0.0;
        const double b2 = pa ? dTT2p[(size_t)p * nt + t] : 0.0;
        const double b3 = pa ? TTm2p[(size_t)p * nt + t] : 0.0;
        dmma884(x0, x1, a2, b2);
        dmma884(x0, x1, a3, b3);
        dmma884(z0, z1, a1, bt);
      }
    }
    const int pc = pt + 2 * tq;
    if (q < g.nq) {
      double* xo = XY + ((size_t)es * g.nXY * g.nq + q) * g.npl + pc;
      double* yo = xo + (size_t)g.nq * g.npl;
      double* zo = yo + (size_t)g.nq * g.npl;  // tau mode only
      double* vo = zo + (size_t)g.nq * g.npl;  // laplacian mode only
      if (pc < g.npl) {
        xo[0] = x0;
        yo[0] = y0;
        if constexpr (TAU) zo[0] = z0;
        if constexpr (LAPL) vo[0] = v0;
      }
      if (pc + 1 < g.npl) {
        xo[1] = x1;
        yo[1] = y1;
        if constexpr (TAU) zo[1] = z1;
        if constexpr (LAPL) vo[1] = v1;
      }
    }
  }
  for (size_t k = gtid; k < nF2 / 2; k += nthr) F2[k] = make_double2(0.0, 0.0);
  cg::this_grid().sync();

  // ---- phase B: element blocks Fel [ns, nelem, npl, np^2] of the live
  // pairs on DMMA, one 8 x 8 (p, ij) tile per warp task, ij over i <= j:
  // Fel = X^T BB + Y^T SS (+ Z^T DD in tau mode, + V^T S2 in laplacian
  // mode) (depth q); written mirrored ----
  const int njt = g.nijp / 8;
  const int nB = g.ns * g.nelem * npt * njt;
  for (int task = gwarp; task < nB; task += nwarps) {
    const int jt = 8 * (task % njt), pt = 8 * (task / njt % npt), es = task / (njt * npt);
    const int e = es % g.nelem, p = pt + gq;
    const double* X = XY + (size_t)es * g.nXY * g.nq * g.npl;
    const double* Y = X + (size_t)g.nq * g.npl;
    const double* Z = Y + (size_t)g.nq * g.npl;  // tau mode only
    const double* V = Z + (size_t)g.nq * g.npl;  // laplacian mode only
    const double* bb = BBs + (size_t)e * g.nq * g.nijp + jt + gq;
    const double* ss = SSs + (size_t)e * g.nq * g.nijp + jt + gq;
    const double* dd = DDs + (size_t)e * g.nq * g.nijp + jt + gq;
    const double* s2 = LAPL ? S2s + (size_t)e * g.nq * g.nijp + jt + gq : nullptr;
    double f0 = 0.0, f1 = 0.0;
#pragma unroll 8
    for (int k = 0; k < g.nq; k += 4) {
      const int q = k + tq;
      const bool qa = q < g.nq, xa = qa && p < g.npl;
      const double ax = xa ? __ldcg(X + (size_t)q * g.npl + p) : 0.0;
      const double ay = xa ? __ldcg(Y + (size_t)q * g.npl + p) : 0.0;
      const double b1 = qa ? __ldg(bb + (size_t)q * g.nijp) : 0.0;
      const double b2 = qa ? __ldg(ss + (size_t)q * g.nijp) : 0.0;
      dmma884(f0, f1, ax, b1);
      dmma884(f0, f1, ay, b2);
      if constexpr (TAU) {
        const double az = xa ? __ldcg(Z + (size_t)q * g.npl + p) : 0.0;
        const double b3 = qa ? __ldg(dd + (size_t)q * g.nijp) : 0.0;
        dmma884(f0, f1, az, b3);
      }
      if constexpr (LAPL) {
        const double a4 = xa ? __ldcg(V + (size_t)q * g.npl + p) : 0.0;
        const double b4 = qa ? __ldg(s2 + (size_t)q * g.nijp) : 0.0;
        dmma884(f0, f1, a4, b4);
      }
    }
    if (p < g.npl) {
      double* out = Fel + ((size_t)es * g.npl + p) * np2;
      const double v[2] = {f0, f1};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ij = jt + 2 * tq + u;
        if (ij >= g.nij) break;
        const int packed = __ldg(ijs + ij), i = packed >> 16, j = packed & 0xffff;
        out[i * np + j] = v[u];
        out[j * np + i] = v[u];
      }
    }
  }
  for (size_t k = nF2 / 2 + gtid; k < nF2; k += nthr) F2[k] = make_double2(0.0, 0.0);
  if (gtid == 0 && (size_t)g.ns * nbf * nbf % 2) F[(size_t)g.ns * nbf * nbf - 1] = 0.0;

  cg::this_grid().sync();

  // ---- phase C: owner-computes assembly of the element windows of the live
  // pairs, mask included: one warp per row segment (spin, live pair,
  // orientation (a, b) or (b, a), row n), its lanes over the columns
  // band[n] = the slots of the elements that cover n (at most 2 nprim - 1),
  // each entry the sum of its (at most 2 x 2) element contributions in
  // element order, written once ----
  const int nC = g.ns * g.npl * 2 * g.nrad;
  for (int task = gwarp; task < nC; task += nwarps) {
    int r = task;
    const int n = r % g.nrad;
    r /= g.nrad;
    const int flip = r % 2;
    r /= 2;
    const int p = r % g.npl, s = r / g.npl;
    const int pa = spair[2 * p], pb = spair[2 * p + 1];
    if (flip && pa == pb) continue;
    const int mlo = sband[2 * n], mhi = sband[2 * n + 1];
    const int own_u[2] = {sown[2 * n], sown[2 * n + 1]};
    const int a = flip ? pb : pa, b = flip ? pa : pb;
    const size_t row = (size_t)a * g.nrad + n;
    const double mr = mask ? __ldg(mask + row) : 1.0;
    const double* Fs = Fel + ((size_t)s * g.nelem * g.npl + p) * np2;
    const size_t estride = (size_t)g.npl * np2;  // one element further
    double* Frow = F + ((size_t)s * nbf + row) * nbf + (size_t)b * g.nrad;
    for (int m = mlo + lane; m <= mhi; m += 32) {
      const int own_w[2] = {sown[2 * m], sown[2 * m + 1]};
      double acc = 0.0;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int u = own_u[x];
        if (u < 0) break;
        const int e = u / np, i = u - e * np;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int w = own_w[y];
          if (w < 0) break;
          if (w / np != e) continue;
          acc += __ldcg(Fs + e * estride + i * np + (w - e * np));
        }
      }
      Frow[m] = mask ? acc * mr * __ldg(mask + (size_t)b * g.nrad + m) : acc;
    }
  }
}

// Blocks of the kernel instance `kern` (of mode `mode`) that one SM holds at
// `smem` bytes of dynamic shared memory, cached per instance, device and
// size. Each instance is first allowed the whole 227 KB and the largest
// shared-memory carveout, once per device, so that the occupancy computed
// here is the one a cooperative launch is held to.
static int xck_blocks_per_sm(const void* kern, int mode, int device, int smem) {
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
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, XCK_THREADS, smem) != cudaSuccess)
    return 0;
  cached_dev[next] = device;
  cached_smem[next] = smem;
  cached_mode[next] = mode;
  cached_n[next] = n;
  next = (next + 1) % 8;
  return n;
}

// The launch's arguments, as kernels/dia_xc_fock.py:_Launch lays them out:
// the pointers first, then the sizes. XY: scratch [ns, nelem, nXY, nq, npl]
// (nXY = 2 + mode); Fel: scratch [ns, nelem, npl, nprim^2]; F: output [ns,
// nbf, nbf]; mask [nbf] or null (no mask); wvt, dTT2p, TTm2p, tfac and DDs
// are read in modes 1 and 2, wvl, LLTTp, TTmmp, lfac and S2s in mode 2
// (laplacian) only. The grid tables come from models/xc_grid.py
// (pair_tables, element_tables).
struct XckLaunch {
  const double *wvr, *wgu, *wgv, *wvt, *wvl;
  const int *pairs, *band, *owners;
  const double *TTp, *dTTp, *dTT2p, *TTm2p, *tfac;
  const int* ijs;
  const double *BBs, *SSs, *DDs;
  const double *LLTTp, *TTmmp, *lfac, *S2s;
  const double* mask;
  double *XY, *Fel, *F;
  void* stream;
  int ns, nang, nelem, nq, nprim, nrad, nt, npl, device, mode;
};

// Returns a cudaError_t.
extern "C" int dia_xc_fock_launch(const XckLaunch* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  if (a->nprim > 0xffff || a->mode < 0 || a->mode > 2) return (int)cudaErrorInvalidValue;
  static int sm_count[8] = {0};
  if (a->device < 0 || a->device >= 8) return (int)cudaErrorInvalidDevice;
  if (!sm_count[a->device]) {
    err = cudaDeviceGetAttribute(&sm_count[a->device], cudaDevAttrMultiProcessorCount,
                                 a->device);
    if (err != cudaSuccess) return (int)err;
  }
  const void* kern = a->mode == 2   ? (const void*)xc_fock_kernel<2>
                     : a->mode == 1 ? (const void*)xc_fock_kernel<1>
                                    : (const void*)xc_fock_kernel<0>;
  const int smem = 4 * (4 * a->nrad + 2 * a->npl);
  const int per_sm = xck_blocks_per_sm(kern, a->mode, a->device, smem);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int nij = a->nprim * (a->nprim + 1) / 2;
  XckGeom g{a->ns,  a->nang, a->nelem, a->nq, a->nprim, a->nrad, a->nt,
            a->npl, nij,     (nij + 7) / 8 * 8, 2 + a->mode};
  void* args[] = {(void*)&a->wvr,   (void*)&a->wgu,   (void*)&a->wgv,   (void*)&a->wvt,
                  (void*)&a->wvl,   (void*)&a->pairs, (void*)&a->band,  (void*)&a->owners,
                  (void*)&a->TTp,   (void*)&a->dTTp,  (void*)&a->dTT2p, (void*)&a->TTm2p,
                  (void*)&a->tfac,  (void*)&a->ijs,   (void*)&a->BBs,   (void*)&a->SSs,
                  (void*)&a->DDs,   (void*)&a->LLTTp, (void*)&a->TTmmp, (void*)&a->lfac,
                  (void*)&a->S2s,   (void*)&a->mask,  (void*)&a->XY,    (void*)&a->Fel,
                  (void*)&a->F,     &g};
  return (int)cudaLaunchCooperativeKernel(kern, per_sm * sm_count[a->device], XCK_THREADS, args,
                                          (size_t)smem, (cudaStream_t)a->stream);
}
