// Warm-started eigensolve kernel K11: the first-order refinement sweeps of a
// batch of symmetric matrices A [B, n, n] from approximate eigenvectors V0
// [B, n, n], with the residual certificate, in f64.
//
// Replaces no Pallas kernel: helfem_tpu runs these sweeps as the lax.scan
// of matmuls and elementwise masks of helfem_tpu/utils/linalg.py:
// _refine_passes (:21-47) inside the XLA program of eigh_warm_with (:134-140),
// once per warm eigensolve of every fused SCF iteration. In plain PyTorch a
// call is about twenty dependent batched matmuls and forty elementwise
// launches; here it is one launch. Each of the nsweep sweeps does
//
//   M = V^T (A V);  E = diag(M);  off = max_{i != j} |M_ij|
//   C_ij = clip(M_ij / (E_j - E_i), -0.1, 0.1), 0 where |E_j - E_i| <=
//          tau (max(|E_i|, |E_j|) + 1)
//   W = V + V C;  P = 1.5 I - 0.5 W^T W;  V = W P
//
// and the outputs are the last sweep's E and off (taken before its update
// of V) and the updated V. off holds one value per group of B / groups
// consecutive blocks (one spin's blocks), the largest over the group.
//
// One cooperative launch, five stages per sweep joined by grid-wide
// barriers: (1) T = A V, (2) M = V^T T with E and, in the last sweep, off,
// (3) W = V + V C with C formed on the fly from M and E, (4) P, (5) V = W P.
// Every stage is a batched n x n x n product split into 8 x 8 output tiles,
// one warp task each, shared out over the grid's warps; a task runs the
// depth on the FP64 tensor cores (mma.sync m8n8k4, csrc/dmma.cuh) with its
// fragments read straight from device memory (A, V0 and the scratch stay in
// the 50 MB L2 at the SCF shapes). The scratch matrices are padded to a
// multiple of 8 with zeros, which the sweeps keep zero (C and W vanish on
// the padding and P is 1.5 there), so no tile needs a ragged edge; A and V0
// are read unpadded with bounds checks. off is an atomicMax on the bit
// pattern of a non-negative double (NaN orders above every number, so a NaN
// residual fails the certificate): a maximum does not depend on the order
// of the atomics, and every sum runs in a fixed order, so two calls give
// the same bits.
//
// Bound on the H100: of the five products of a sweep, A V, V C and W P take
// 2 n^3 flops each, and the symmetric V^T (A V) and W^T W need only one
// triangle, n^3 each: 8 n^3 per block and sweep, 32 n^3 at the fused chunks'
// four sweeps, against 67 TFLOP/s on the FP64 tensor cores: 5.1 us at Ar
// (4 blocks of 139), against 0.55 us for the bytes (A and V0 read, V and E
// written once). Bound by operations; this first design computes both
// triangles and is held back by its twenty grid barriers and by fragment
// loads from L2 instead.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dmma.cuh"

namespace cg = cooperative_groups;

#define RE_THREADS 256

struct ReGeom {
  int B, n, np, nb;  // blocks, size, padded size (a multiple of 8), blocks per group
  int nsweep;
  double tau;
};

// element (r, c) of a [lim x lim] matrix with row stride ld, zero outside
__device__ __forceinline__ double re_ld(const double* p, int ld, int lim, int r, int c) {
  return (r < lim && c < lim) ? p[(size_t)r * ld + c] : 0.0;
}

// a non-negative double's bits order as the double does (NaN above +inf)
__device__ __forceinline__ unsigned long long re_bits(double x) {
  return (unsigned long long)__double_as_longlong(fabs(x));
}

enum { RE_AV, RE_VTT, RE_VC, RE_WTW, RE_WP };

// One stage: for every block b and 8 x 8 tile (i0, j0) of the padded output,
// out = L R over the depth np, then the stage's epilogue. Lane l = 4 gq + tq
// holds L[i0 + gq][k + tq] and R[k + tq][j0 + gq] and the outputs (i0 + gq,
// j0 + 2 tq) and (i0 + gq, j0 + 2 tq + 1).
template <int KIND>
__device__ void re_stage(const ReGeom& g, const double* __restrict__ A, const double* Vc,
                         int vld, int vlim, double* T, double* M, double* W, double* Ep,
                         double* Vn, int vnld, int vnlim, double* Eout,
                         unsigned long long* off, bool last, int gwarp, int nwarps,
                         int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int np = g.np, nt = np / 8, per = nt * nt;
  const size_t sq = (size_t)np * np;
  const int ntask = g.B * per;
  for (int task = gwarp; task < ntask; task += nwarps) {
    const int b = task / per, r = task % per;
    const int i0 = (r / nt) * 8, j0 = (r % nt) * 8;
    const int i = i0 + gq, j = j0 + gq;  // this lane's L row and R column
    const double* Ab = A + (size_t)b * g.n * g.n;
    const double* Vb = Vc + (size_t)b * vld * vld;
    const double* Tb = T + b * sq;
    const double* Mb = M + b * sq;
    const double* Wb = W + b * sq;
    const double* Eb = Ep + (size_t)b * np;
    double c0 = 0.0, c1 = 0.0;
    double ej = 0.0;
    if (KIND == RE_VC) ej = Eb[j];
#pragma unroll 4
    for (int k0 = 0; k0 < np; k0 += 4) {
      const int k = k0 + tq;
      double a, bb;
      if (KIND == RE_AV) {  // T = A V
        a = re_ld(Ab, g.n, g.n, i, k);
        bb = re_ld(Vb, vld, vlim, k, j);
      } else if (KIND == RE_VTT) {  // M = V^T T
        a = re_ld(Vb, vld, vlim, k, i);
        bb = Tb[(size_t)k * np + j];
      } else if (KIND == RE_VC) {  // V C, C[k][j] from M and E
        a = re_ld(Vb, vld, vlim, i, k);
        const double ek = Eb[k], dE = ej - ek;
        const double scale = fmax(fabs(ej), fabs(ek)) + 1.0;
        const double cm = fabs(dE) > g.tau * scale ? Mb[(size_t)k * np + j] / dE : 0.0;
        bb = isnan(cm) ? cm : fmin(fmax(cm, -0.1), 0.1);  // NaN passes, as torch.clamp's
      } else if (KIND == RE_WTW) {  // W^T W
        a = Wb[(size_t)k * np + i];
        bb = Wb[(size_t)k * np + j];
      } else {  // W P (P in T)
        a = Wb[(size_t)i * np + k];
        bb = Tb[(size_t)k * np + j];
      }
      dmma884(c0, c1, a, bb);
    }
    const int ro = i0 + gq, co = j0 + 2 * tq;  // this lane's outputs (ro, co), (ro, co + 1)
    const double cc[2] = {c0, c1};
    if (KIND == RE_AV) {
      double* o = T + b * sq + (size_t)ro * np + co;
      o[0] = c0;
      o[1] = c1;
    } else if (KIND == RE_VTT) {
      double* o = M + b * sq + (size_t)ro * np + co;
      o[0] = c0;
      o[1] = c1;
      unsigned long long mx = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = co + h;
        if (c == ro) {
          Ep[(size_t)b * np + ro] = cc[h];
          if (last && ro < g.n) Eout[(size_t)b * g.n + ro] = cc[h];
        } else if (ro < g.n && c < g.n) {
          const unsigned long long v = re_bits(cc[h]);
          mx = v > mx ? v : mx;
        }
      }
      if (last) {
        for (int s = 16; s > 0; s >>= 1) {
          const unsigned long long o2 = __shfl_xor_sync(0xffffffffu, mx, s);
          mx = o2 > mx ? o2 : mx;
        }
        if (lane == 0 && mx) atomicMax(off + b / g.nb, mx);
      }
    } else if (KIND == RE_VC) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        W[b * sq + (size_t)ro * np + co + h] = re_ld(Vb, vld, vlim, ro, co + h) + cc[h];
    } else if (KIND == RE_WTW) {  // P = 1.5 I - 0.5 W^T W, into T
#pragma unroll
      for (int h = 0; h < 2; ++h)
        T[b * sq + (size_t)ro * np + co + h] = (ro == co + h ? 1.5 : 0.0) - 0.5 * cc[h];
    } else {
      double* Vo = Vn + (size_t)b * vnld * vnld;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ro < vnlim && co + h < vnlim) Vo[(size_t)ro * vnld + co + h] = cc[h];
    }
  }
}

__global__ void __launch_bounds__(RE_THREADS)
    refine_eig_kernel(const double* __restrict__ A, const double* __restrict__ V0, double* V,
                      double* E, double* offd, double* scratch, ReGeom g) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x % 32;
  const int gwarp = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int nwarps = (int)((size_t)gridDim.x * blockDim.x / 32);
  const size_t sq = (size_t)g.B * g.np * g.np;
  double* T = scratch;  // T, then P
  double* M = T + sq;
  double* W = M + sq;
  double* Vp = W + sq;   // V between sweeps, padded
  double* Ep = Vp + sq;  // E of the current sweep, padded [B, np]
  unsigned long long* off = reinterpret_cast<unsigned long long*>(offd);
  const int groups = g.B / g.nb;
  if (blockIdx.x == 0 && threadIdx.x < groups) off[threadIdx.x] = 0ull;  // +0.0
  for (int s = 0; s < g.nsweep; ++s) {
    const bool first = s == 0, last = s == g.nsweep - 1;
    // the current V: V0 unpadded in the first sweep, the padded copy after
    const double* Vc = first ? V0 : Vp;
    const int vld = first ? g.n : g.np, vlim = first ? g.n : g.np;
    re_stage<RE_AV>(g, A, Vc, vld, vlim, T, M, W, Ep, nullptr, 0, 0, E, off, last, gwarp,
                    nwarps, lane);
    grid.sync();
    re_stage<RE_VTT>(g, A, Vc, vld, vlim, T, M, W, Ep, nullptr, 0, 0, E, off, last, gwarp,
                     nwarps, lane);
    grid.sync();
    re_stage<RE_VC>(g, A, Vc, vld, vlim, T, M, W, Ep, nullptr, 0, 0, E, off, last, gwarp,
                    nwarps, lane);
    grid.sync();
    re_stage<RE_WTW>(g, A, Vc, vld, vlim, T, M, W, Ep, nullptr, 0, 0, E, off, last, gwarp,
                     nwarps, lane);
    grid.sync();
    // the last sweep writes the output V unpadded, the others the padded copy
    re_stage<RE_WP>(g, A, Vc, vld, vlim, T, M, W, Ep, last ? V : Vp, last ? g.n : g.np,
                    last ? g.n : g.np, E, off, last, gwarp, nwarps, lane);
    if (!last) grid.sync();
  }
}

static int re_blocks_per_sm(int device) {
  static int cached[8] = {0};
  if (!cached[device]) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, refine_eig_kernel, RE_THREADS, 0) !=
        cudaSuccess)
      return 0;
    cached[device] = n;
  }
  return cached[device];
}

// A, V0: inputs [B, n, n]; V [B, n, n], E [B, n], off [groups]: outputs;
// scratch: 4 B np^2 + B np doubles, np = n rounded up to a multiple of 8
// (four padded matrices and the padded E; kernels/refine_eig.py allocates
// it). Returns a cudaError_t.
extern "C" int refine_eig_launch(const double* A, const double* V0, double* V, double* E,
                                 double* off, double* scratch, int B, int n, int nsweep,
                                 int groups, int device, double tau, void* stream) {
  if (B < 1 || n < 1 || nsweep < 1 || groups < 1 || groups > RE_THREADS || B % groups)
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= 8) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static int sm_count[8] = {0};
  if (!sm_count[device]) {
    err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_sm = re_blocks_per_sm(device);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  ReGeom g{B, n, (n + 7) / 8 * 8, B / groups, nsweep, tau};
  const int tiles = B * (g.np / 8) * (g.np / 8);
  const int warps = RE_THREADS / 32;
  // no more blocks than tasks: the barriers cost more with every block
  int blocks = per_sm * sm_count[device];
  const int need = (tiles + warps - 1) / warps;
  if (need < blocks) blocks = need;
  void* args[] = {(void*)&A, (void*)&V0, (void*)&V, (void*)&E, (void*)&off, (void*)&scratch,
                  &g};
  return (int)cudaLaunchCooperativeKernel((const void*)refine_eig_kernel, blocks, RE_THREADS,
                                          args, 0, (cudaStream_t)stream);
}
