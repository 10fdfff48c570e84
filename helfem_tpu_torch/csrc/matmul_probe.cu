// Matmul probes K8 (matmul_f32) and K9 (matmul_dd): C = A B for row-major
// f32 A [M, K], B [K, N], C [M, N], each at two precisions.
//
// They replace the four Pallas kernels of the JAX package's f64-ablation
// probes: scripts/pallas_f64_ablation.py:pallas_matmul_f32 and
// pallas_matmul_dd (true-f32 passes, Precision.HIGHEST) and
// scripts/perf_campaign.py:stage_pallas pmm32 and pmmdd (the chip's default
// reduced-precision pass). The probes ask whether f64 emulated from f32
// words could beat the backend's own f64 product:
//
//   matmul_f32  C = A B
//   matmul_dd   C = Ah Bh + Ah Bl + Al Bh  for double-word operands
//               x = xh + xl (hi and lo f32 words), the three products
//               summed into ONE f32 accumulator per output, as the Pallas
//               kernel sums its three dots per tile
//
//   full     f32 FFMA on the CUDA cores: shared-memory tiles 128 x 128 x 16,
//            256 threads, an 8 x 8 register tile each.
//   reduced  this card's reduced-precision tensor-core pass, TF32 (inputs
//            rounded to 10 mantissa bits, f32 accumulate) through
//            nvcuda::wmma m16n16k8, where the TPU's default pass was bf16;
//            8 warps, each a 64 x 32 sub-tile of the 128 x 128 block tile.
//
// M and N must be multiples of 128 and K of 16 (the Pallas grids divide the
// same way); the wrapper checks. Bound on the H100: operations (2 M N K
// flop, three times that for matmul_dd, against 67 TFLOP/s f32 or 495
// TFLOP/s TF32). No TMA, no wgmma, single-buffered tiles: the probes answer
// an accuracy question first, and their rates are recorded as they are.

#include <cuda_runtime.h>
#include <mma.h>

#define PBM 128
#define PBN 128
#define PBK 16

// Stage one 128 x 16 tile of row-major A, transposed, and one 16 x 128 tile
// of B. 256 threads, two float4 each per operand.
__device__ inline void stage_a_t(const float* __restrict__ A, int lda, int m0, int k0,
                                 float (*As)[PBM]) {
  for (int idx = threadIdx.x; idx < PBM * PBK / 4; idx += 256) {
    const int row = idx / (PBK / 4), c4 = idx % (PBK / 4);
    const float4 v =
        *reinterpret_cast<const float4*>(A + (size_t)(m0 + row) * lda + k0 + 4 * c4);
    As[4 * c4 + 0][row] = v.x;
    As[4 * c4 + 1][row] = v.y;
    As[4 * c4 + 2][row] = v.z;
    As[4 * c4 + 3][row] = v.w;
  }
}

__device__ inline void stage_b(const float* __restrict__ B, int ldb, int k0, int n0,
                               float (*Bs)[PBN]) {
  for (int idx = threadIdx.x; idx < PBK * PBN / 4; idx += 256) {
    const int row = idx / (PBN / 4), c4 = idx % (PBN / 4);
    *reinterpret_cast<float4*>(&Bs[row][4 * c4]) =
        *reinterpret_cast<const float4*>(B + (size_t)(k0 + row) * ldb + n0 + 4 * c4);
  }
}

// grid (N / 128, M / 128), 256 threads as 16 x 16.
template <bool DD>
__global__ void __launch_bounds__(256) matmul_full_kernel(
    const float* __restrict__ Ah, const float* __restrict__ Al,
    const float* __restrict__ Bh, const float* __restrict__ Bl,
    float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float Ahs[PBK][PBM];
  __shared__ __align__(16) float Bhs[PBK][PBN];
  __shared__ __align__(16) float Als[DD ? PBK : 1][PBM];
  __shared__ __align__(16) float Bls[DD ? PBK : 1][PBN];
  const int m0 = blockIdx.y * PBM, n0 = blockIdx.x * PBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  for (int k0 = 0; k0 < K; k0 += PBK) {
    stage_a_t(Ah, K, m0, k0, Ahs);
    stage_b(Bh, N, k0, n0, Bhs);
    if (DD) {
      stage_a_t(Al, K, m0, k0, Als);
      stage_b(Bl, N, k0, n0, Bls);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < PBK; ++kk) {
      float a[8], b[8], al[8], bl[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = Ahs[kk][ty * 8 + u];
#pragma unroll
      for (int v = 0; v < 8; ++v) b[v] = Bhs[kk][tx * 8 + v];
      if (DD) {
#pragma unroll
        for (int u = 0; u < 8; ++u) al[u] = Als[kk][ty * 8 + u];
#pragma unroll
        for (int v = 0; v < 8; ++v) bl[v] = Bls[kk][tx * 8 + v];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          acc[u][v] += a[u] * b[v];
          if (DD) {
            acc[u][v] += a[u] * bl[v];
            acc[u][v] += al[u] * b[v];
          }
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float* out = C + (size_t)(m0 + ty * 8 + u) * N + n0 + tx * 8;
    *reinterpret_cast<float4*>(out) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    *reinterpret_cast<float4*>(out + 4) =
        make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
  }
}

#define PLDA (PBK + 4)  // row strides in shared memory, in floats: multiples
#define PLDB (PBN + 4)  // of 4, and 16-row / 8-row steps stay 32-byte aligned

__device__ inline void stage_rows(const float* __restrict__ src, int ld, int r0, int c0,
                                  int rows, int cols, float* dst, int ldd) {
  const int c4n = cols / 4;
  for (int idx = threadIdx.x; idx < rows * c4n; idx += 256) {
    const int row = idx / c4n, c4 = idx % c4n;
    *reinterpret_cast<float4*>(dst + row * ldd + 4 * c4) =
        *reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * ld + c0 + 4 * c4);
  }
}

// grid (N / 128, M / 128), 256 threads = 8 warps as 2 (rows) x 4 (columns);
// warp tile 64 x 32 = 4 x 2 wmma accumulators.
template <bool DD>
__global__ void __launch_bounds__(256) matmul_tf32_kernel(
    const float* __restrict__ Ah, const float* __restrict__ Al,
    const float* __restrict__ Bh, const float* __restrict__ Bl,
    float* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) float Ahs[PBM * PLDA];
  __shared__ __align__(32) float Bhs[PBK * PLDB];
  __shared__ __align__(32) float Als[DD ? PBM * PLDA : 8];
  __shared__ __align__(32) float Bls[DD ? PBK * PLDB : 8];
  const int m0 = blockIdx.y * PBM, n0 = blockIdx.x * PBN;
  const int warp = threadIdx.x / 32, wr = warp / 4, wc = warp % 4;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>
      FragA;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>
      FragB;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v) wmma::fill_fragment(acc[u][v], 0.f);
  for (int k0 = 0; k0 < K; k0 += PBK) {
    stage_rows(Ah, K, m0, k0, PBM, PBK, Ahs, PLDA);
    stage_rows(Bh, N, k0, n0, PBK, PBN, Bhs, PLDB);
    if (DD) {
      stage_rows(Al, K, m0, k0, PBM, PBK, Als, PLDA);
      stage_rows(Bl, N, k0, n0, PBK, PBN, Bls, PLDB);
    }
    __syncthreads();
    // The tensor cores align and truncate every addend to the accumulator's
    // exponent, a one-sided error that grows with K when one fragment
    // carries the whole sum (measured 2e-5 x max-abs at K = 4096). Each
    // 16-deep step is therefore summed from zero and added to the running
    // sum with a rounded f32 add.
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wmma::fragment<wmma::accumulator, 16, 16, 8, float> part[2];
      wmma::fill_fragment(part[0], 0.f);
      wmma::fill_fragment(part[1], 0.f);
#pragma unroll
      for (int ks = 0; ks < PBK; ks += 8) {
        FragA ah, al;
        const int offa = (wr * 64 + u * 16) * PLDA + ks;
        wmma::load_matrix_sync(ah, Ahs + offa, PLDA);
#pragma unroll
        for (int t = 0; t < ah.num_elements; ++t) ah.x[t] = wmma::__float_to_tf32(ah.x[t]);
        if (DD) {
          wmma::load_matrix_sync(al, Als + offa, PLDA);
#pragma unroll
          for (int t = 0; t < al.num_elements; ++t)
            al.x[t] = wmma::__float_to_tf32(al.x[t]);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          FragB bh, bl;
          const int offb = ks * PLDB + wc * 32 + v * 16;
          wmma::load_matrix_sync(bh, Bhs + offb, PLDB);
#pragma unroll
          for (int t = 0; t < bh.num_elements; ++t)
            bh.x[t] = wmma::__float_to_tf32(bh.x[t]);
          wmma::mma_sync(part[v], ah, bh, part[v]);
          if (DD) {
            wmma::mma_sync(part[v], al, bh, part[v]);
            wmma::load_matrix_sync(bl, Bls + offb, PLDB);
#pragma unroll
            for (int t = 0; t < bl.num_elements; ++t)
              bl.x[t] = wmma::__float_to_tf32(bl.x[t]);
            wmma::mma_sync(part[v], ah, bl, part[v]);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int t = 0; t < part[v].num_elements; ++t) acc[u][v].x[t] += part[v].x[t];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 2; ++v)
      wmma::store_matrix_sync(
          C + (size_t)(m0 + wr * 64 + u * 16) * N + n0 + wc * 32 + v * 16, acc[u][v], N,
          wmma::mem_row_major);
}

// reduced = 0: f32 FFMA; 1: TF32 tensor cores. Al = Bl = nullptr selects
// matmul_f32, else matmul_dd. Returns a cudaError_t.
extern "C" int matmul_probe_launch(const float* Ah, const float* Al, const float* Bh,
                                   const float* Bl, float* C, int M, int N, int K,
                                   int reduced, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(N / PBN, M / PBM);
  const bool dd = Al != nullptr;
  if (reduced) {
    if (dd)
      matmul_tf32_kernel<true><<<grid, 256, 0, st>>>(Ah, Al, Bh, Bl, C, M, N, K);
    else
      matmul_tf32_kernel<false><<<grid, 256, 0, st>>>(Ah, Al, Bh, Bl, C, M, N, K);
  } else {
    if (dd)
      matmul_full_kernel<true><<<grid, 256, 0, st>>>(Ah, Al, Bh, Bl, C, M, N, K);
    else
      matmul_full_kernel<false><<<grid, 256, 0, st>>>(Ah, Al, Bh, Bl, C, M, N, K);
  }
  return (int)cudaGetLastError();
}
