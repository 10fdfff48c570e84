// Diatomic XC field kernel K4: the density and its two gradient components
// rho, drho_u, drho_v [nelem, nq, nt] on the prolate-spheroidal grid, from
// the [nbf, nbf] density P (bf = a * nrad + n), in f64.
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
// Here the element windows are read straight from P through gidx (trash
// read as 0), with no padded copy. Shell pairs whose angular tables vanish
// (TT = dTT = 0 exactly for m_a != m_b) are skipped, which is exact for any
// P.
//
// Two launches: xc_fields_pair_kernel, one block per (shell pair, element),
// stages the pair's window in shared memory and writes D1, Dmu at every
// radial point; xc_fields_grid_kernel, one thread per grid point, contracts
// over the shell pairs in a fixed order. Deterministic, no atomics.
//
// Bound on the H100: at the N2 bench shapes (nang=19, nelem=5, nq=40,
// nprim=8, nt=24) a call needs 0.52 MB, of the density only the windows
// of the 121 live shell pairs (301 entries each), and does about 7 MFLOP,
// so it is latency-bound (two launches of small blocks).

#include <cuda_runtime.h>

// grid (nang*nang, nelem); block: max(np2, nq) rounded up to a warp;
// dynamic shared memory np2 doubles.
__global__ void xc_fields_pair_kernel(
    const double* __restrict__ P, const int* __restrict__ gidx,
    const double* __restrict__ Bg, const double* __restrict__ dBg,
    const double* __restrict__ TT, const double* __restrict__ dTT,
    double* __restrict__ D1, double* __restrict__ Dmu, int nang, int nelem,
    int nq, int nprim, int nrad, int nt) {
  extern __shared__ double W[];  // [i][j] window of the (a, b) block
  __shared__ int live;
  const int ab = blockIdx.x, e = blockIdx.y, t = threadIdx.x;
  const int a = ab / nang, b = ab % nang, np2 = nprim * nprim;
  const size_t nbf = (size_t)nang * nrad;
  if (t == 0) live = 0;
  __syncthreads();
  for (int k = t; k < nt; k += blockDim.x)
    if (TT[(size_t)ab * nt + k] != 0.0 || dTT[(size_t)ab * nt + k] != 0.0) live = 1;
  __syncthreads();
  double* d1 = D1 + ((size_t)ab * nelem + e) * nq;
  double* dm = Dmu + ((size_t)ab * nelem + e) * nq;
  if (!live) {
    for (int q = t; q < nq; q += blockDim.x) {
      d1[q] = 0.0;
      dm[q] = 0.0;
    }
    return;
  }
  for (int idx = t; idx < np2; idx += blockDim.x) {
    const int gi = gidx[e * nprim + idx / nprim];
    const int gj = gidx[e * nprim + idx % nprim];
    W[idx] = (gi < nrad && gj < nrad)
                 ? P[((size_t)a * nrad + gi) * nbf + (size_t)b * nrad + gj]
                 : 0.0;
  }
  __syncthreads();
  for (int q = t; q < nq; q += blockDim.x) {
    const double* Bq = Bg + ((size_t)e * nq + q) * nprim;
    const double* dBq = dBg + ((size_t)e * nq + q) * nprim;
    double s1 = 0.0, sm = 0.0;
    for (int i = 0; i < nprim; ++i) {
      double r = 0.0;
      for (int j = 0; j < nprim; ++j) r += W[i * nprim + j] * Bq[j];
      s1 += Bq[i] * r;
      sm += dBq[i] * r;
    }
    d1[q] = s1;
    dm[q] = 2.0 * sm;
  }
}

// one thread per grid point (e, q, t)
__global__ void xc_fields_grid_kernel(
    const double* __restrict__ D1, const double* __restrict__ Dmu,
    const double* __restrict__ TT, const double* __restrict__ dTT,
    const double* __restrict__ invh, const double* __restrict__ sqeta,
    double* __restrict__ rho, double* __restrict__ du,
    double* __restrict__ dv, int npair, int nelem, int nq, int nt) {
  const size_t total = (size_t)nelem * nq * nt;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int t = (int)(idx % nt);
    const size_t eq = idx / nt;
    double r = 0.0, u = 0.0, v = 0.0;
    for (int ab = 0; ab < npair; ++ab) {
      const double tt = TT[(size_t)ab * nt + t];
      const double dt = dTT[(size_t)ab * nt + t];
      const double d1 = D1[(size_t)ab * nelem * nq + eq];
      const double dm = Dmu[(size_t)ab * nelem * nq + eq];
      r += tt * d1;
      u += tt * dm;
      v += dt * d1;
    }
    const double h = invh[idx];
    rho[idx] = r;
    du[idx] = u * h;
    dv[idx] = v * (sqeta[t] * h);
  }
}

// D1, Dmu [nang*nang, nelem, nq]: caller-allocated scratch; rho, du, dv:
// outputs [nelem, nq, nt]. Returns a cudaError_t.
extern "C" int dia_xc_fields_launch(
    const double* P, const int* gidx, const double* Bg, const double* dBg,
    const double* TT, const double* dTT, const double* invh,
    const double* sqeta, double* D1, double* Dmu, double* rho, double* du,
    double* dv, int nang, int nelem, int nq, int nprim, int nrad, int nt,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int np2 = nprim * nprim;
  const int width = np2 > nq ? np2 : nq;
  const int block1 = ((width + 31) / 32) * 32 > 1024 ? 1024 : ((width + 31) / 32) * 32;
  xc_fields_pair_kernel<<<dim3(nang * nang, nelem), block1,
                          (size_t)np2 * sizeof(double), st>>>(
      P, gidx, Bg, dBg, TT, dTT, D1, Dmu, nang, nelem, nq, nprim, nrad, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int block2 = 128;
  const size_t total = (size_t)nelem * nq * nt;
  int grid2 = (int)((total + block2 - 1) / block2);
  if (grid2 > 4096) grid2 = 4096;
  xc_fields_grid_kernel<<<grid2, block2, 0, st>>>(
      D1, Dmu, TT, dTT, invh, sqeta, rho, du, dv, nang * nang, nelem, nq, nt);
  return (int)cudaGetLastError();
}
