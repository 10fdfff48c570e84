// Diatomic XC Fock kernel K5: the [nbf, nbf] XC Fock matrix (bf = a * nrad
// + n) from the weighted potentials on the prolate-spheroidal grid, in f64.
//
// Replaces the LDA/GGA part of helfem_tpu/models/diatomic_dft.py:
// eval_fxc_dia.fock (diatomic_dft.py:156-165) and its scatter-add into the
// padded 4-index square (:197-200). Inputs are wvr = w vr, wgu = w gu invh
// and wgv = w gv invh sqeta on the grid [nelem, nq, nt]:
//
//   A1[a,b,e,q] = sum_t wvr TT[a,b,t],  B1 = sum_t wgu TT,  C1 = sum_t wgv dTT
//   Fel[a,b,e,i,j] = sum_q (A1 + C1)[a,b,e,q] B_i B_j + B1[a,b,e,q] dB_i B_j
//                          + B1[b,a,e,q] dB_j B_i        (B = B[e,q,:])
//   F[a nrad + n, b nrad + m] = sum of Fel[a,b,e,i,j] over the elements e
//                               with gidx[e,i] = n and gidx[e,j] = m
//
// The shell mask stays outside, as in the JAX package. Shell pairs whose
// angular tables vanish (TT = dTT = 0 exactly for m_a != m_b) get exact
// zeros without work.
//
// Two launches: xc_fock_pair_kernel, one block per (shell pair, element),
// contracts the grid potentials with the pair's angular tables into shared
// memory and forms the element block Fel; xc_fock_assemble_kernel, one
// block row per shell pair, assembles owner-computes (fem_owners.cuh) and
// drops the trash slot: deterministic, no atomics.
//
// Bound on the H100: at the N2 bench shapes (nang=19, nelem=5, nq=40,
// nprim=8, nt=24) a call writes the 3.5 MB Fock matrix and does about
// 20 MFLOP, so it is bound by its writes and launch latency.

#include <cuda_runtime.h>

#include "fem_owners.cuh"

// grid (nang*nang, nelem); block: max(np2, nq) rounded up to a warp;
// dynamic shared memory 3*nq doubles.
__global__ void xc_fock_pair_kernel(
    const double* __restrict__ wvr, const double* __restrict__ wgu,
    const double* __restrict__ wgv, const double* __restrict__ Bg,
    const double* __restrict__ dBg, const double* __restrict__ TT,
    const double* __restrict__ dTT, double* __restrict__ Fel, int nang,
    int nelem, int nq, int nprim, int nt) {
  extern __shared__ double sh[];
  __shared__ int live;
  double* X = sh;        // A1 + C1
  double* Y = sh + nq;   // B1[a, b]
  double* Yt = Y + nq;   // B1[b, a]
  const int ab = blockIdx.x, e = blockIdx.y, t = threadIdx.x;
  const int a = ab / nang, b = ab % nang, ba = b * nang + a;
  const int np2 = nprim * nprim;
  const double* tab = TT + (size_t)ab * nt;
  const double* dtab = dTT + (size_t)ab * nt;
  const double* tba = TT + (size_t)ba * nt;
  if (t == 0) live = 0;
  __syncthreads();
  for (int k = t; k < nt; k += blockDim.x)
    if (tab[k] != 0.0 || dtab[k] != 0.0 || tba[k] != 0.0) live = 1;
  __syncthreads();
  double* out = Fel + ((size_t)ab * nelem + e) * np2;
  if (!live) {
    for (int ij = t; ij < np2; ij += blockDim.x) out[ij] = 0.0;
    return;
  }
  for (int q = t; q < nq; q += blockDim.x) {
    const size_t base = ((size_t)e * nq + q) * nt;
    double a1 = 0.0, c1 = 0.0, b1 = 0.0, b1t = 0.0;
    for (int k = 0; k < nt; ++k) {
      a1 += wvr[base + k] * tab[k];
      c1 += wgv[base + k] * dtab[k];
      b1 += wgu[base + k] * tab[k];
      b1t += wgu[base + k] * tba[k];
    }
    X[q] = a1 + c1;
    Y[q] = b1;
    Yt[q] = b1t;
  }
  __syncthreads();
  for (int ij = t; ij < np2; ij += blockDim.x) {
    const int i = ij / nprim, j = ij % nprim;
    double acc = 0.0;
    for (int q = 0; q < nq; ++q) {
      const size_t r = ((size_t)e * nq + q) * nprim;
      const double Bi = Bg[r + i], Bj = Bg[r + j];
      acc += X[q] * Bi * Bj + Y[q] * dBg[r + i] * Bj + Yt[q] * dBg[r + j] * Bi;
    }
    out[ij] = acc;
  }
}

// grid (tiles, nang*nang); dynamic shared memory (nelem*nprim + 2*nrad) ints.
__global__ void xc_fock_assemble_kernel(const double* __restrict__ Fel,
                                        const int* __restrict__ gidx,
                                        double* __restrict__ F, int nang,
                                        int nelem, int nprim, int nrad) {
  extern __shared__ int ism[];
  int* gs = ism;
  int* own = gs + nelem * nprim;
  const int ab = blockIdx.y, a = ab / nang, b = ab % nang;
  const int np2 = nprim * nprim;
  for (int t = threadIdx.x; t < nelem * nprim; t += blockDim.x) gs[t] = gidx[t];
  __syncthreads();
  build_owners(gs, nelem, nprim, nrad, own);
  __syncthreads();
  const double* Fe = Fel + (size_t)ab * nelem * np2;
  const size_t nbf = (size_t)nang * nrad;
  const size_t total = (size_t)nrad * nrad;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(idx / nrad), m = (int)(idx % nrad);
    double acc = 0.0;
    for (int u = 0; u < HELFEM_MAX_OWNERS; ++u) {
      const int ei = own[2 * n + u];
      if (ei < 0) break;
      for (int v = 0; v < HELFEM_MAX_OWNERS; ++v) {
        const int ej = own[2 * m + v];
        if (ej < 0) break;
        const int e = ei / nprim;
        if (ej / nprim != e) continue;
        acc += Fe[(size_t)e * np2 + (ei % nprim) * nprim + ej % nprim];
      }
    }
    F[((size_t)a * nrad + n) * nbf + (size_t)b * nrad + m] = acc;
  }
}

// Fel [nang*nang, nelem, nprim^2]: caller-allocated scratch; F: output
// [nang*nrad, nang*nrad]. Returns a cudaError_t.
extern "C" int dia_xc_fock_launch(const double* wvr, const double* wgu,
                                  const double* wgv, const int* gidx,
                                  const double* Bg, const double* dBg,
                                  const double* TT, const double* dTT,
                                  double* Fel, double* F, int nang, int nelem,
                                  int nq, int nprim, int nrad, int nt,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int np2 = nprim * nprim;
  const int width = np2 > nq ? np2 : nq;
  const int block1 = ((width + 31) / 32) * 32 > 1024 ? 1024 : ((width + 31) / 32) * 32;
  xc_fock_pair_kernel<<<dim3(nang * nang, nelem), block1,
                        3 * (size_t)nq * sizeof(double), st>>>(
      wvr, wgu, wgv, Bg, dBg, TT, dTT, Fel, nang, nelem, nq, nprim, nt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int block = 256;
  int tiles = (int)(((size_t)nrad * nrad + block - 1) / block);
  if (tiles > 16) tiles = 16;
  const size_t sm2 = (size_t)(nelem * nprim + 2 * nrad) * sizeof(int);
  xc_fock_assemble_kernel<<<dim3(tiles, nang * nang), block, sm2, st>>>(
      Fel, gidx, F, nang, nelem, nprim, nrad);
  return (int)cudaGetLastError();
}
