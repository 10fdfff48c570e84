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
// Two launches: dia_coulomb_elem_kernel, one block per (element, channel),
// gathers both windows into shared memory, writes both traces and the
// in-element contraction; dia_coulomb_assemble_kernel, one block row per
// channel, forms the prefix/suffix sums serially (fixed order) and
// assembles owner-computes (fem_owners.cuh): deterministic, no atomics.
//
// Bound on the H100: at the N2 bench shapes (S=15 M=0 channels, nelem=5,
// nprim=8, nrad=35) a call reads 7.4 MB of teiJ3 rows and does about
// 2.5 MFLOP, so it is latency-bound (launches, the serial per-thread row
// sums); staging the T blocks through shared memory and graphing the SCF
// step are later work.

#include <cuda_runtime.h>

#include "fem_owners.cuh"

// grid (nelem, S); block: np2 threads rounded up to a warp; dynamic shared
// memory 2*np2 doubles.
__global__ void dia_coulomb_elem_kernel(
    const double* __restrict__ Paux0, const double* __restrict__ Paux2,
    const double* __restrict__ teiJ3, const double* __restrict__ dP0,
    const double* __restrict__ dP2, const double* __restrict__ dQ0,
    const double* __restrict__ dQ2, const int* __restrict__ ilm,
    const int* __restrict__ gidx, double* __restrict__ Jin0,
    double* __restrict__ Jin2, double* __restrict__ ts,
    double* __restrict__ tb, int nelem, int nprim, int nrad) {
  extern __shared__ double Pg[];  // [2][np2]: Pg0, Pg2
  const int e = blockIdx.x, s = blockIdx.y, t = threadIdx.x;
  const int np2 = nprim * nprim;
  const int c = ilm[s];
  double* P0 = Pg;
  double* P2 = Pg + np2;
  const size_t win = (size_t)s * nrad * nrad;
  for (int idx = t; idx < np2; idx += blockDim.x) {
    const int gi = gidx[e * nprim + idx / nprim];
    const int gj = gidx[e * nprim + idx % nprim];
    const bool in = gi < nrad && gj < nrad;
    const size_t off = win + (size_t)gi * nrad + gj;
    P0[idx] = in ? Paux0[off] : 0.0;
    P2[idx] = in ? Paux2[off] : 0.0;
  }
  __syncthreads();
  const size_t ce = (size_t)c * nelem + e;
  const size_t se = (size_t)s * nelem + e;
  // the two traces: one thread each, serial fixed-order sums
  if (t < 2) {
    const double* D0 = (t == 0 ? dP0 : dQ0) + ce * np2;
    const double* D2 = (t == 0 ? dP2 : dQ2) + ce * np2;
    double a = 0.0, b = 0.0;
    for (int ij = 0; ij < np2; ++ij) {
      a += D0[ij] * P0[ij];
      b += D2[ij] * P2[ij];
    }
    (t == 0 ? ts : tb)[se] = a - b;
  }
  if (t < np2) {
    const size_t blk = (size_t)np2 * np2;
    const double* T00 = teiJ3 + ((size_t)c * 3 * nelem + e) * blk;
    const double* T02 = T00 + (size_t)nelem * blk;
    const double* T22 = T02 + (size_t)nelem * blk;
    const size_t row = (size_t)t * np2;
    double a0 = 0.0, a2 = 0.0;
    for (int kl = 0; kl < np2; ++kl) {
      a0 += T00[row + kl] * P0[kl] - T02[row + kl] * P2[kl];
      a2 += T22[row + kl] * P2[kl] - T02[(size_t)kl * np2 + t] * P0[kl];
    }
    Jin0[se * np2 + t] = a0;
    Jin2[se * np2 + t] = a2;
  }
}

// grid (tiles, S); dynamic shared memory: (nelem*nprim + 2*nrad) ints,
// padded to 8 bytes, then 2*nelem doubles.
__global__ void dia_coulomb_assemble_kernel(
    const double* __restrict__ Jin0, const double* __restrict__ Jin2,
    const double* __restrict__ ts, const double* __restrict__ tb,
    const double* __restrict__ dP0, const double* __restrict__ dP2,
    const double* __restrict__ dQ0, const double* __restrict__ dQ2,
    const double* __restrict__ LMfac, const int* __restrict__ ilm,
    const int* __restrict__ gidx, double* __restrict__ Jr0,
    double* __restrict__ Jr2, int nelem, int nprim, int nrad) {
  extern __shared__ double dsm[];
  const int nint = nelem * nprim + 2 * nrad;
  int* gs = (int*)dsm;
  int* own = gs + nelem * nprim;
  double* sA = dsm + (nint + 1) / 2;
  double* sB = sA + nelem;
  const int s = blockIdx.y, np2 = nprim * nprim;
  const int c = ilm[s];
  for (int t = threadIdx.x; t < nelem * nprim; t += blockDim.x) gs[t] = gidx[t];
  if (threadIdx.x == 0) {
    const double* tsm = ts + (size_t)s * nelem;
    const double* tbm = tb + (size_t)s * nelem;
    double acc = 0.0;
    for (int e = 0; e < nelem; ++e) {
      sA[e] = acc;
      acc += tsm[e];
    }
    acc = 0.0;
    for (int e = nelem - 1; e >= 0; --e) {
      sB[e] = acc;
      acc += tbm[e];
    }
  }
  __syncthreads();
  build_owners(gs, nelem, nprim, nrad, own);
  __syncthreads();

  const double fac = LMfac[c];
  const double* J0 = Jin0 + (size_t)s * nelem * np2;
  const double* J2 = Jin2 + (size_t)s * nelem * np2;
  double* out0 = Jr0 + (size_t)s * nrad * nrad;
  double* out2 = Jr2 + (size_t)s * nrad * nrad;
  const size_t total = (size_t)nrad * nrad;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(idx / nrad), m = (int)(idx % nrad);
    double acc0 = 0.0, acc2 = 0.0;
    for (int u = 0; u < HELFEM_MAX_OWNERS; ++u) {
      const int ei = own[2 * n + u];
      if (ei < 0) break;
      for (int v = 0; v < HELFEM_MAX_OWNERS; ++v) {
        const int ej = own[2 * m + v];
        if (ej < 0) break;
        const int e = ei / nprim;
        if (ej / nprim != e) continue;
        const int w = (ei % nprim) * nprim + ej % nprim;
        const size_t lw = ((size_t)c * nelem + e) * np2 + w;
        const size_t jw = (size_t)e * np2 + w;
        acc0 += dP0[lw] * sB[e] + dQ0[lw] * sA[e] + J0[jw];
        acc2 += J2[jw] - dP2[lw] * sB[e] - dQ2[lw] * sA[e];
      }
    }
    out0[idx] = fac * acc0;
    out2[idx] = fac * acc2;
  }
}

// Jin0, Jin2 [S, nelem, nprim^2], ts and tb [S, nelem]: caller-allocated
// scratch; Jr0, Jr2: outputs [S, nrad, nrad]. Returns a cudaError_t.
extern "C" int radial_coulomb_dia_launch(
    const double* Paux0, const double* Paux2, const double* teiJ3,
    const double* dP0, const double* dP2, const double* dQ0, const double* dQ2,
    const double* LMfac, const int* ilm, const int* gidx, double* Jin0,
    double* Jin2, double* ts, double* tb, double* Jr0, double* Jr2, int S,
    int nelem, int nprim, int nrad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int np2 = nprim * nprim;
  const size_t sm1 = 2 * (size_t)np2 * sizeof(double);
  dia_coulomb_elem_kernel<<<dim3(nelem, S), ((np2 + 31) / 32) * 32, sm1, st>>>(
      Paux0, Paux2, teiJ3, dP0, dP2, dQ0, dQ2, ilm, gidx, Jin0, Jin2, ts, tb,
      nelem, nprim, nrad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nint = nelem * nprim + 2 * nrad;
  const size_t sm2 = ((nint + 1) / 2 + 2 * nelem) * sizeof(double);
  const int block = 256;
  int tiles = (int)(((size_t)nrad * nrad + block - 1) / block);
  if (tiles > 16) tiles = 16;
  dia_coulomb_assemble_kernel<<<dim3(tiles, S), block, sm2, st>>>(
      Jin0, Jin2, ts, tb, dP0, dP2, dQ0, dQ2, LMfac, ilm, gidx, Jr0, Jr2,
      nelem, nprim, nrad);
  return (int)cudaGetLastError();
}
