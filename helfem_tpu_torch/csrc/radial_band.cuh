// Building blocks of the atomic radial kernels K1 (radial_exchange.cu), K2
// (radial_coulomb.cu) and K10 (radial_erfc_exchange.cu), which share their
// band stage: a row band of one tei slice (K1/K2: [L, e], K10 the element
// pair [g, e, f]) times the element window of every density channel,
//
//   C[row, c] = sum_(u, l) A[row, (u, l)] B[(u, l), c],   (u, l) < nprim^2,
//   B[(u, l), c] = D_c[gidx[e, u], gidx[f, l]]   (trash slot read as 0; f = e
//                                                 for K1 and K2),
//
// on the FP64 tensor cores (dmma.cuh). A block stages the band's rows and the
// windows of all its channels in shared memory with cp.async (8-byte copies:
// a tei row need not be 16-byte aligned when nprim is odd), rows padded to
// dmma_ld so that the m8n8k4 fragment loads do not conflict, then runs each
// 8-row tile against every 8-column tile, the k-steps of a tile shared by
// RB_WARPS / (R / 8) warps whose partial sums are added in a fixed order.
// The depth (u, l) is staged in chunks of NU units of nprim, so any nprim
// fits; the tile plan (kernels/_radial.py) picks the band rows R, the
// channels per group CG and NU from the shared memory a block may use.
#pragma once

#include <cuda_runtime.h>

#include "dmma.cuh"

#define RB_THREADS 256
#define RB_WARPS (RB_THREADS / 32)
#define RB_NT 4  // 8-column tiles per channel group (CG <= 32)
#define RB_BATCH 8  // assembly: the entries a lane loads before it stores any

__host__ __device__ inline int rb_ceil(int n, int m) { return (n + m - 1) / m * m; }
// row stride of a staged chunk of NU units (NU * nprim columns, padded to 4)
__host__ __device__ inline int band_ld(int NU, int nprim) {
  return dmma_ld(rb_ceil(NU * nprim, 4));
}


__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// n / d for 0 <= n, n * d < 2^32 without a division instruction:
// floor(n * ceil(2^32 / d) / 2^32) is exact there.
struct FastDiv {
  unsigned d, m;
  __device__ explicit FastDiv(int dd) : d((unsigned)dd), m(0xffffffffu / (unsigned)dd + 1u) {}
  __device__ int operator()(int n) const { return (int)__umulhi((unsigned)n, m); }
};

// Stage rows [r0, r0 + nr) x units [u0, u0 + nu) of A into As (row stride
// ld), and zero the depth padding up to a multiple of 4. rows(row, u)
// points at A[row, (u, 0)]. Rows::kUnitMajor says which run is contiguous:
// the rows of one unit (exchange: tei[g, e, i, (j, k), l], rows(r + 1, u) =
// rows(r, u) + nprim) or the units of one row (Coulomb: tei[L, e, (i, j),
// (k, l)]). Each warp copies whole runs, its lanes on consecutive
// addresses, 8 bytes each (a tei row need not be 16-byte aligned).
template <class Rows>
__device__ __forceinline__ void stage_rows(double* As, int ld, const Rows& rows, int r0, int nr,
                                           int u0, int nu, int np) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kc = nu * np, pad = rb_ceil(kc, 4) - kc;
  if (Rows::kUnitMajor) {
    const FastDiv by_np(np);
    for (int u = warp; u < nu; u += RB_WARPS) {
      const double* src = rows(r0, u0 + u);
      for (int idx = lane; idx < nr * np; idx += 32) {
        const int r = by_np(idx);
        cp_async8(As + r * ld + u * np + (idx - r * np), src + idx);
      }
    }
  } else {
    for (int r = warp; r < nr; r += RB_WARPS) {
      const double* src = rows(r0 + r, u0);
      for (int kk = lane; kk < kc; kk += 32) cp_async8(As + r * ld + kk, src + kk);
    }
  }
  for (int r = warp; r < nr; r += RB_WARPS)
    if (lane < pad) As[r * ld + kc + lane] = 0.0;
}

// Stage B^T for channels [0, ncpad): Bs[c, (u, l)] = D[c][gidx_e[u0 + u],
// gidx_f[l]] for c < nc (channel stride cstride), 0 for the trash slot, for
// c >= nc and for the depth padding: the window of the element pair (e, f).
// One warp per channel row.
__device__ __forceinline__ void stage_window(double* Bs, int ld, const double* D, size_t cstride,
                                             int nc, int ncpad, const int* gidx_e,
                                             const int* gidx_f, int u0, int nu, int np,
                                             int nrad) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kc = nu * np, kc4 = rb_ceil(kc, 4);
  const FastDiv by_np(np);
  for (int c = warp; c < ncpad; c += RB_WARPS) {
    const double* Dc = D + c * cstride;
    for (int kk = lane; kk < kc4; kk += 32) {
      double* dst = Bs + c * ld + kk;
      if (c < nc && kk < kc) {
        const int u = by_np(kk), l = kk - u * np;
        const int gi = gidx_e[u0 + u], gj = gidx_f[l];
        if (gi < nrad && gj < nrad) {
          cp_async8(dst, Dc + (size_t)gi * nrad + gj);
          continue;
        }
      }
      *dst = 0.0;
    }
  }
}

// The in-element window of element e (f == e).
__device__ __forceinline__ void stage_window(double* Bs, int ld, const double* D, size_t cstride,
                                             int nc, int ncpad, const int* gidx_e, int u0,
                                             int nu, int np, int nrad) {
  stage_window(Bs, ld, D, cstride, nc, ncpad, gidx_e, gidx_e, u0, nu, np, nrad);
}

// One warp's share of an 8-row tile Arow (stride ld) against NT 8-column
// tiles of Bs: the k-steps (4 deep) s0, s0 + stride, ... below ns,
// acc[chain][tile][0..1] += the C fragment (rows g, columns 2t, 2t + 1).
// Consecutive k-steps of the share go to independent DMMA chains: the two
// parities h, and for NT <= 2 also the unused tile slots NT..2 NT - 1, four
// chains; a missing last step multiplies zeros. band_reduce adds the
// chains, and the shares, in a fixed order.
template <int NT>
__device__ __forceinline__ void band_mma(const double* Arow, const double* Bs, int ld, int ns,
                                         int s0, int stride, double (&acc)[2][RB_NT][2]) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const double* a = Arow + gq * ld + tq;
  const double* b = Bs + gq * ld + tq;
#pragma unroll 2
  for (int s = s0; s < ns; s += 2 * stride) {
    const int k0 = 4 * s, k1 = 4 * (s + stride);
    const bool two = s + stride < ns;
    double av[2], bv[2][NT];
    av[0] = a[k0];
    av[1] = two ? a[k1] : 0.0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bv[0][nt] = b[nt * 8 * ld + k0];
      bv[1][nt] = two ? b[nt * 8 * ld + k1] : 0.0;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) dmma884(acc[h][nt][0], acc[h][nt][1], av[h], bv[h][nt]);
  }
}

// The band's warps: with R / 8 = ntb tiles, parts = RB_WARPS / ntb warps
// share a tile (warp w: tile w % ntb, share w / ntb of the k-steps), their
// partial sums added in share order through shared memory (band_red).
__host__ __device__ inline int band_parts(int R) { return RB_WARPS / (R / 8); }
__host__ __device__ inline int band_red_doubles(int R) {
  return (band_parts(R) - 1) * (R / 8) * RB_NT * 64;
}
// doubles of a band task's buffers: R rows of A and CG channel rows of B,
// or, after the products, the partial sums of the shared tiles
__host__ __device__ inline int band_doubles(int R, int CG, int NU, int nprim) {
  const int ab = (R + CG) * band_ld(NU, nprim), red = band_red_doubles(R);
  return ab > red ? ab : red;
}

// The band task's products: warp w runs its share of tile w % ntb over the
// staged chunk (see band_parts); no-op for warps past the live rows nr.
__device__ __forceinline__ void band_chunk(const double* As, const double* Bs, int ld, int kc4,
                                           int R, int nr, int ntn, double (&acc)[2][RB_NT][2]) {
  const int warp = threadIdx.x >> 5, ntb = R / 8, parts = band_parts(R);
  const int tile = warp % ntb, part = warp / ntb;
  if (part >= parts || 8 * tile >= nr) return;
  const double* Arow = As + 8 * tile * ld;
  switch (ntn) {
    case 1: band_mma<1>(Arow, Bs, ld, kc4 / 4, part, parts, acc); break;
    case 2: band_mma<2>(Arow, Bs, ld, kc4 / 4, part, parts, acc); break;
    case 3: band_mma<3>(Arow, Bs, ld, kc4 / 4, part, parts, acc); break;
    default: band_mma<4>(Arow, Bs, ld, kc4 / 4, part, parts, acc); break;
  }
}

// After the last chunk (and a barrier): fold the shares of each tile into
// the share-0 warp in share order, through the task buffers. Returns true
// on the warps that then hold a finished tile (rows 8 * (warp % ntb) + g).
__device__ __forceinline__ bool band_reduce(double* red, int R, int nr, int ntn,
                                            double (&acc)[2][RB_NT][2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntb = R / 8, parts = band_parts(R), tile = warp % ntb, part = warp / ntb;
  const bool live = part < parts && 8 * tile < nr;
  // the chains of band_mma, in chain order: for ntn <= RB_NT / 2, tile nt
  // holds chains 0, 1 in slot nt and chains 2, 3 in slot nt + ntn
#pragma unroll
  for (int nt = 0; nt < RB_NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[0][nt][h] += acc[1][nt][h];
    }
  if (parts > 1) {
    if (live && part > 0) {
      double* to = red + (((part - 1) * ntb + tile) * RB_NT * 32 + lane) * 2;
#pragma unroll
      for (int nt = 0; nt < RB_NT; ++nt)
        if (nt < ntn) {
          to[nt * 64] = acc[0][nt][0];
          to[nt * 64 + 1] = acc[0][nt][1];
        }
    }
    __syncthreads();
    if (live && part == 0)
      for (int p = 1; p < parts; ++p) {
        const double* from = red + (((p - 1) * ntb + tile) * RB_NT * 32 + lane) * 2;
#pragma unroll
        for (int nt = 0; nt < RB_NT; ++nt)
          if (nt < ntn) {
            acc[0][nt][0] += from[nt * 64];
            acc[0][nt][1] += from[nt * 64 + 1];
          }
      }
    __syncthreads();  // the buffers are staged again after this
  }
  return live && part == 0;
}

// Warp-wide exclusive prefix sums of x(0), ..., x(n - 1) into out[0..n):
// out[e] = the sum of x(f) over f < e, or over f > e when reverse; chunks
// of 32 in scan order, a fixed tree order within each chunk, so every call
// sums in the same order.
template <class X>
__device__ inline void warp_exclusive_scan(const X& x, int n, bool reverse, double* out) {
  const int lane = threadIdx.x & 31;
  double carry = 0.0;
  for (int base = 0; base < n; base += 32) {
    const int pos = base + lane;                // position in scan order
    const int e = reverse ? n - 1 - pos : pos;  // element index
    double v = pos < n ? x(e) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    const double below = __shfl_up_sync(0xffffffffu, v, 1);
    if (pos < n) out[e] = (lane ? below : 0.0) + carry;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// The owner table in shared memory: own[n] = {the slots e * nprim + i
// covering n (element order), then their elements e}, -1 where none.
__device__ __forceinline__ void stage_owners(int4* own, const int* __restrict__ owners, int nrad,
                                             int np) {
  for (int n = threadIdx.x; n < nrad; n += RB_THREADS) {
    const int s0 = owners[2 * n], s1 = owners[2 * n + 1];
    own[n] = make_int4(s0, s1, s0 < 0 ? -1 : s0 / np, s1 < 0 ? -1 : s1 / np);
  }
}

// Blocks of a kernel that one SM holds at `smem` bytes of dynamic shared
// memory, for a cooperative launch. The kernel is first allowed the card's
// whole 227 KB and the largest shared-memory carveout (once per device), so
// that the count is the one the launch is held to: without the carveout a
// cooperative launch can fail with error 720. Cached per device and size.
struct CoopOccupancy {
  const void* fn;
  bool ready[8];
  int dev[8], smem[8], blocks[8], next;
};

static int coop_blocks_per_sm(CoopOccupancy& c, int device, int smem) {
  for (int k = 0; k < 8; ++k)
    if (c.dev[k] == device && c.smem[k] == smem) return c.blocks[k];
  if (!c.ready[device]) {
    if (cudaFuncSetAttribute(c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448) !=
            cudaSuccess ||
        cudaFuncSetAttribute(c.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return 0;
    c.ready[device] = true;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, c.fn, RB_THREADS, (size_t)smem) !=
      cudaSuccess)
    return 0;
  c.dev[c.next] = device;
  c.smem[c.next] = smem;
  c.blocks[c.next] = n;
  c.next = (c.next + 1) % 8;
  return n;
}

static int sm_count(int device) {
  static int count[8] = {0};
  if (!count[device] &&
      cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return count[device];
}

// Set the device, size the cooperative grid (every block resident) and
// launch kernel(*a) with `smem` bytes; returns a cudaError_t.
template <class Launch>
static int coop_launch(CoopOccupancy& occ, const Launch* a, int smem) {
  if (a->device < 0 || a->device >= 8) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const int per_sm = coop_blocks_per_sm(occ, a->device, smem);
  const int nsm = sm_count(a->device);
  if (per_sm < 1 || nsm < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)a};
  return (int)cudaLaunchCooperativeKernel(occ.fn, per_sm * nsm, RB_THREADS, args, (size_t)smem,
                                          (cudaStream_t)a->stream);
}
