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
// M and N must be multiples of 128 and K of 16 (the Pallas grids divide the
// same way); the wrapper checks, and so does matmul_probe_launch. Bound on
// the H100: operations (2 M N K flop, three times that for matmul_dd,
// against 67 TFLOP/s f32 on the CUDA cores or 495 TFLOP/s TF32).
//
// full: an f32 FFMA SGEMM (Hopper has no tensor-core mode for true f32).
//   Block tile 128 x 128 x 16, 256 threads, two blocks per SM (the 256
//   tiles of n = 2048 run in one wave on 132 SMs). Each thread owns an 8 x 8
//   output tile as 2 x 2 sub-tiles of 4 x 4 spaced 64 apart, so a warp's
//   fragment reads are LDS.128 over 128 contiguous bytes (B) or broadcasts
//   (A): no bank conflicts. A ring of 4 stages (3 for matmul_dd, whose
//   stages are twice as large) is filled by cp.async while the stage before
//   is multiplied, one __syncthreads per k-tile. A is transposed on the way
//   in (4-byte cp.async into rows padded to 132 floats); a warp's 32 copies
//   cover 4 rows x 8 k, which lands them in 32 distinct banks. matmul_dd
//   keeps its four operand tiles in the same ring and issues three FFMAs per
//   output pair into the one accumulator (ah bh, then ah bl, then al bh, in
//   k order): a second accumulator for the cross terms would cost 64
//   registers against the 128 that two blocks per SM allow.
//
// reduced: this card's reduced-precision tensor-core pass, TF32 (inputs
//   rounded to 10 mantissa bits, f32 accumulate), where the TPU's was bf16.
//   Warp-specialised: block tile 128 x 128, k-tiles of 32 (one 128-byte
//   swizzle row of f32), 384 threads = two consumer warpgroups (64 rows
//   each, wgmma.mma_async m64n128k8 .tf32, A from registers, B from shared
//   memory) and one producer warpgroup. One producer thread keeps TMA loads
//   (cp.async.bulk.tensor) in flight into a ring of 192 KB (6 stages of A
//   and B, or 3 of A, Al, B and Bl), each completing an mbarrier; the
//   producer warpgroup transforms B and publishes the stage on a second
//   mbarrier; the consumers release it on a third, and the producer refills
//   the stage of tile kt - 1 after publishing tile kt. Four traps, and how
//   each is handled:
//   1. TF32 wgmma reads K-major operands only (the transpose immediates are
//      for f16/bf16). A [M, K] row-major is K-major and lands by TMA with
//      the 128-byte swizzle. B [K, N] is not: TMA lands its [32, 128] tile
//      row-major, and the producer warpgroup rewrites it in place (all 128
//      threads read their 4 x 4 blocks into registers, a named barrier,
//      then the writes) into the K-major 128-byte-swizzled [128, 32] layout
//      that the B descriptor names. The block-to-lane map keeps both the
//      LDS.128 reads and the STS.128 writes free of bank conflicts.
//   2. Rounding. The tensor cores read an f32 word as TF32 by dropping its
//      low 13 bits, where round_tf32 (kernels/matmul_probe.py) rounds to
//      nearest, ties away (cvt.rna.tf32.f32). Every operand is rounded
//      exactly once: A (and Al) as the consumers load their wgmma A
//      fragments into registers (one ldmatrix per k-step, then cvt), B (and
//      Bl) in the producer's transform.
//   3. Accumulator truncation. The tensor cores align each addend to the
//      accumulator's exponent and truncate it, a one-sided error that grows
//      with the depth one accumulator carries (2e-5 x max-abs at K = 4096
//      when one fragment carried the whole sum). The wgmma accumulator is
//      therefore restarted (scale-d = 0) every TF32_KBLK k-tiles (128 deep)
//      and added into a running f32 sum in registers with rounded f32 adds:
//      64 + 64 registers a consumer thread, within the 168 that 384 threads
//      leave. TF32_KBLK was chosen by measurement at K = 4096
//      (tools/probe_split.py, PERF.md): 1 to 16 k-tiles all stay within
//      3.4e-6 x max-abs of the plain version, and 4 or more are the fastest.
//   4. TMA descriptors without -lcuda: cuTensorMapEncodeTiled is reached
//      through cudaGetDriverEntryPoint, and the 192 KB of dynamic shared
//      memory is granted by cudaFuncSetAttribute before each launch.
//   A ragged last k-tile (K = 16 mod 32) is read past K by TMA, which fills
//   the missing rows and columns with zeros.
//
// No atomics and a fixed order of every sum: two calls give the same bits.

#include <cuda.h>  // CUtensorMap and its enums only: nothing from libcuda is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ float to_tf32(float x) {  // as round_tf32: nearest, ties away
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// ---------------------------------------------------------------- full ----

constexpr int FBM = 128, FBN = 128, FBK = 16;
constexpr int FLDA = FBM + 4;  // transposed A rows, padded (see the note above)
constexpr int FULL_STAGES_F32 = 4, FULL_STAGES_DD = 3;
__host__ __device__ constexpr int full_stage_floats(bool dd) {
  return (dd ? 2 : 1) * FBK * (FLDA + FBN);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One k-tile of one operand pair into a stage: A [128 rows, 16 k] transposed
// into At[k][row] (thread: k = tid % 8 + 8 h, rows tid / 8 + 32 q), B [16 k,
// 128 n] row by row, 16 bytes a copy.
__device__ __forceinline__ void full_load(const float* __restrict__ A,
                                          const float* __restrict__ B, int N, int K, int m0,
                                          int n0, int k0, float* At, float* Bs) {
  const int tid = threadIdx.x, kl = tid & 7, rl = tid >> 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int row = rl + 32 * (j >> 1), k = kl + 8 * (j & 1);
    cp_async4(At + k * FLDA + row, A + (size_t)(m0 + row) * K + k0 + k);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = tid + 256 * j, row = idx >> 5, c4 = idx & 31;
    cp_async16(Bs + row * FBN + 4 * c4, B + (size_t)(k0 + row) * N + n0 + 4 * c4);
  }
}

__device__ __forceinline__ void frag8(const float* p, float* x) {  // p[0..3], p[64..67]
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 64);
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

// grid (N / 128, M / 128), 256 threads; warp w, lane l own tx = 8 (w % 2) +
// l % 8 and ty = 4 (w / 2) + l / 8 of a 16 x 16 thread grid.
template <bool DD, int S>
__global__ void __launch_bounds__(256, 2) matmul_full_kernel(
    const float* __restrict__ Ah, const float* __restrict__ Al,
    const float* __restrict__ Bh, const float* __restrict__ Bl,
    float* __restrict__ C, int N, int K) {
  extern __shared__ __align__(16) float fsm[];
  constexpr int AT = FBK * FLDA, BS = FBK * FBN, STG = full_stage_floats(DD);
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = 8 * (warp & 1) + (lane & 7), ty = 4 * (warp >> 1) + (lane >> 3);
  const int KT = K / FBK;
  auto load = [&](int kt) {
    float* st = fsm + (kt % S) * STG;
    full_load(Ah, Bh, N, K, m0, n0, kt * FBK, st, st + AT);
    if (DD) full_load(Al, Bl, N, K, m0, n0, kt * FBK, st + AT + BS, st + 2 * AT + BS);
  };
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();         // everyone's, and tile kt - 1 is no longer read
    if (kt + S - 1 < KT) load(kt + S - 1);  // into the stage of tile kt - 1
    cp_async_commit();
    const float* At = fsm + (kt % S) * STG;
    const float* Bs = At + AT;
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[8], b[8], al[8], bl[8];
      frag8(At + kk * FLDA + 4 * ty, a);
      frag8(Bs + kk * FBN + 4 * tx, b);
      if (DD) {
        frag8(At + AT + BS + kk * FLDA + 4 * ty, al);
        frag8(Bs + AT + BS + kk * FBN + 4 * tx, bl);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
          if (DD) {
            acc[u][v] = fmaf(a[u], bl[v], acc[u][v]);
            acc[u][v] = fmaf(al[u], b[v], acc[u][v]);
          }
        }
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    float* out = C + (size_t)(m0 + 64 * (u >> 2) + 4 * ty + (u & 3)) * N + n0 + 4 * tx;
    *reinterpret_cast<float4*>(out) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    *reinterpret_cast<float4*>(out + 64) =
        make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
  }
}

// ------------------------------------------------------------- reduced ----

#ifndef TF32_KBLK
#define TF32_KBLK 4  // k-tiles of 32 per wgmma accumulator (trap 3)
#endif
constexpr int TBM = 128, TBN = 128, TBK = 32;
constexpr int TILE_BYTES = TBM * TBK * 4;  // every operand tile: 16 KB
constexpr int TF32_STAGES = 3 * 2;         // 192 KB: 6 stages of 2 tiles or 3 of 4
__host__ __device__ constexpr int tf32_tiles(bool dd) { return dd ? 4 : 2; }
__host__ __device__ constexpr int tf32_stages(bool dd) { return TF32_STAGES / (dd ? 2 : 1); }
// the ring, three mbarriers a stage and 1024 bytes of alignment slack
__host__ __device__ constexpr int tf32_smem_bytes(bool dd) {
  return tf32_stages(dd) * tf32_tiles(dd) * TILE_BYTES + 3 * 8 * tf32_stages(dd) + 1024;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred P1;\nLAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// TMA: the box of `map` at (c0 inner, c1 outer) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A tile [32 k, 128 n] as TMA landed it (row-major) becomes, in place, the
// K-major [128 n, 32 k] tile with the 128-byte swizzle (16-byte chunk c of
// row n at chunk c ^ (n % 8)), every value rounded to TF32. The 128 threads
// each move two 4 x 4 blocks (kb, nb); the 8 lanes of a quarter-warp take nb
// = 8 g + l and kb = 4 kh + ((l / 2 + s) % 4), which spreads both their
// reads (bank group nb % 8) and their writes (kb ^ (n % 8)) over all 8 bank
// groups.
__device__ __forceinline__ void tf32_transform_b(float* tile, int t) {
  float4 v[2][4];
  int kb[2], nb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int P = (t >> 3) + 16 * r, l = t & 7;
    kb[r] = 4 * (P & 1) + (((l >> 1) + (P >> 3)) & 3);
    nb[r] = 8 * ((P >> 1) & 3) + l;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[r][j] = *reinterpret_cast<const float4*>(tile + (4 * kb[r] + j) * TBN + 4 * nb[r]);
  }
  bar_sync(1, 128);  // every read of the tile before any write
  char* base = reinterpret_cast<char*>(tile);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = 4 * nb[r];
    *reinterpret_cast<float4*>(base + (n + 0) * 128 + ((kb[r] ^ ((n + 0) & 7)) << 4)) =
        make_float4(to_tf32(v[r][0].x), to_tf32(v[r][1].x), to_tf32(v[r][2].x),
                    to_tf32(v[r][3].x));
    *reinterpret_cast<float4*>(base + (n + 1) * 128 + ((kb[r] ^ ((n + 1) & 7)) << 4)) =
        make_float4(to_tf32(v[r][0].y), to_tf32(v[r][1].y), to_tf32(v[r][2].y),
                    to_tf32(v[r][3].y));
    *reinterpret_cast<float4*>(base + (n + 2) * 128 + ((kb[r] ^ ((n + 2) & 7)) << 4)) =
        make_float4(to_tf32(v[r][0].z), to_tf32(v[r][1].z), to_tf32(v[r][2].z),
                    to_tf32(v[r][3].z));
    *reinterpret_cast<float4*>(base + (n + 3) * 128 + ((kb[r] ^ ((n + 3) & 7)) << 4)) =
        make_float4(to_tf32(v[r][0].w), to_tf32(v[r][1].w), to_tf32(v[r][2].w),
                    to_tf32(v[r][3].w));
  }
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address / 16, stride between 8-row groups 1024 B, layout 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x 128] (+)= a[64 x 8] b[8 x 128], a from registers: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows; d[i] at
// row 16 warp + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2; g =
// lane / 4, t = lane % 4. scale_d = 0 drops d's old value.
__device__ __forceinline__ void wgmma_tf32(float* d, const unsigned* a, uint64_t bdesc,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(scale_d));
}

// The warp's A fragment of k-step j from a 128-byte-swizzled [128, 32]
// tile, rounded to TF32, by one ldmatrix: its four 8 x 8 b16 matrices are
// the 8 x 4 f32 blocks a0..a3 (rows +0 / +8, columns +0 / +4), lane l
// addressing row l % 8 of block l / 8; `row0` = the warp's first row. The 8
// rows of a block lie in 8 distinct bank groups.
__device__ __forceinline__ void a_frag(const char* tile, int row0, int lane, int j, unsigned* a) {
  const int q = lane >> 3, r = row0 + (lane & 7) + 8 * (q & 1), c = 2 * j + (q >> 1);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(tile + r * 128 + (((c ^ r) & 7) << 4))));
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(to_tf32(__uint_as_float(a[i])));
}

// grid (N / 128, M / 128), 384 threads: warpgroups 0 and 1 consume rows
// 64 wg .. 64 wg + 63 of the block tile, warpgroup 2 produces. A stage
// holds the A tile, [Al,] the B tile [and Bl], 16 KB each, 1024-aligned.
template <bool DD>
__global__ void __launch_bounds__(384, 1) matmul_tf32_kernel(
    const __grid_constant__ CUtensorMap tA, const __grid_constant__ CUtensorMap tAl,
    const __grid_constant__ CUtensorMap tB, const __grid_constant__ CUtensorMap tBl,
    float* __restrict__ C, int N, int K) {
  constexpr int S = tf32_stages(DD), NT = tf32_tiles(DD), STG = NT * TILE_BYTES;
  constexpr int BOFF = (DD ? 2 : 1) * TILE_BYTES;  // the B tile within a stage
  extern __shared__ uint8_t tsm_raw[];
  char* sm = reinterpret_cast<char*>(((uintptr_t)tsm_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S * STG);  // TMA landed
  uint64_t* ready = full + S;                                  // B transformed
  uint64_t* empty = ready + S;                                 // consumers done
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int KT = (K + TBK - 1) / TBK;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 1);
      mbar_init(empty + s, 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // producer: TMA (thread 0) and the B transform (all 128)
    auto issue = [&](int kt) {
      const int s = kt % S;
      char* st = sm + s * STG;
      mbar_expect_tx(full + s, STG);
      tma_load(st, &tA, kt * TBK, m0, full + s);
      if (DD) tma_load(st + TILE_BYTES, &tAl, kt * TBK, m0, full + s);
      tma_load(st + BOFF, &tB, n0, kt * TBK, full + s);
      if (DD) tma_load(st + BOFF + TILE_BYTES, &tBl, n0, kt * TBK, full + s);
    };
    if (t == 0)
      for (int kt = 0; kt < S && kt < KT; ++kt) issue(kt);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % S;
      mbar_wait(full + s, (kt / S) & 1);
      char* st = sm + s * STG;
      tf32_transform_b(reinterpret_cast<float*>(st + BOFF), t);
      if (DD) tf32_transform_b(reinterpret_cast<float*>(st + BOFF + TILE_BYTES), t);
      // generic-proxy writes made visible to wgmma (async proxy), then one
      // thread publishes the stage once all 128 have written
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 128);
      if (t == 0) {
        mbar_arrive(ready + s);
        // refill the stage of tile kt - 1 once both consumers released it
        const int done = kt - 1;
        if (done >= 0 && done + S < KT) {
          mbar_wait(empty + done % S, (done / S) & 1);
          issue(done + S);
        }
      }
    }
  } else {  // consumers
    const int warp = t >> 5, lane = t & 31;
    const int row = 64 * wg + 16 * warp + (lane >> 2), tq = lane & 3;  // of the block tile
    float acc[64], run[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = run[i] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % S, ph = (kt / S) & 1;
      mbar_wait(full + s, ph);   // A (and Al) landed
      mbar_wait(ready + s, ph);  // B (and Bl) transformed
      const char* st = sm + s * STG;
      unsigned ah[4][4], al[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_frag(st, 64 * wg + 16 * warp, lane, j, ah[j]);
        if (DD) a_frag(st + TILE_BYTES, 64 * wg + 16 * warp, lane, j, al[j]);
      }
      const bool fresh = kt % TF32_KBLK == 0;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t bh = sw128_desc(st + BOFF + 32 * j);
        wgmma_tf32(acc, ah[j], bh, !(fresh && j == 0));
        if (DD) {
          wgmma_tf32(acc, ah[j], sw128_desc(st + BOFF + TILE_BYTES + 32 * j), 1);
          wgmma_tf32(acc, al[j], bh, 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty + s);
      if (kt % TF32_KBLK == TF32_KBLK - 1 || kt == KT - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) run[i] = __fadd_rn(run[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = m0 + row + 8 * ((i >> 1) & 1), c = n0 + 8 * (i >> 2) + 2 * tq;
      *reinterpret_cast<float2*>(C + (size_t)r * N + c) = make_float2(run[i], run[i + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// row-major f32 [rows, cols] in boxes of [box_rows, box_cols]
bool make_map(CUtensorMap* map, const float* p, int rows, int cols, int box_rows, int box_cols,
              bool swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dim, stride, box,
             estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool DD>
cudaError_t launch_tf32(const float* Ah, const float* Al, const float* Bh, const float* Bl,
                        float* C, int M, int N, int K, cudaStream_t st) {
  CUtensorMap tA, tAl, tB, tBl;
  if (!make_map(&tA, Ah, M, K, TBM, TBK, true) || !make_map(&tB, Bh, K, N, TBK, TBN, false))
    return cudaErrorInvalidValue;
  if (DD) {
    if (!make_map(&tAl, Al, M, K, TBM, TBK, true) || !make_map(&tBl, Bl, K, N, TBK, TBN, false))
      return cudaErrorInvalidValue;
  } else {
    tAl = tA, tBl = tB;
  }
  constexpr int smem = tf32_smem_bytes(DD);
  cudaError_t err = cudaFuncSetAttribute(matmul_tf32_kernel<DD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  matmul_tf32_kernel<DD><<<dim3(N / TBN, M / TBM), 384, smem, st>>>(tA, tAl, tB, tBl, C, N, K);
  return cudaGetLastError();
}

template <bool DD>
cudaError_t launch_full(const float* Ah, const float* Al, const float* Bh, const float* Bl,
                        float* C, int M, int N, int K, cudaStream_t st) {
  constexpr int S = DD ? FULL_STAGES_DD : FULL_STAGES_F32;
  constexpr int smem = S * full_stage_floats(DD) * 4;
  cudaError_t err = cudaFuncSetAttribute(matmul_full_kernel<DD, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  matmul_full_kernel<DD, S><<<dim3(N / FBN, M / FBM), 256, smem, st>>>(Ah, Al, Bh, Bl, C, N, K);
  return cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) of one block: kernels/matmul_probe.py:_plan mirrors it.
extern "C" int matmul_probe_smem(int reduced, int dd) {
  if (reduced) return dd ? tf32_smem_bytes(true) : tf32_smem_bytes(false);
  return (dd ? FULL_STAGES_DD * full_stage_floats(true)
             : FULL_STAGES_F32 * full_stage_floats(false)) * 4;
}

// reduced = 0: f32 FFMA; 1: TF32 tensor cores. Al = Bl = nullptr selects
// matmul_f32, else matmul_dd. Returns a cudaError_t.
extern "C" int matmul_probe_launch(const float* Ah, const float* Al, const float* Bh,
                                   const float* Bl, float* C, int M, int N, int K,
                                   int reduced, int device, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 128 || N % 128 || K % 16 || M / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const bool dd = Al != nullptr;
  if (reduced)
    err = dd ? launch_tf32<true>(Ah, Al, Bh, Bl, C, M, N, K, st)
             : launch_tf32<false>(Ah, Al, Bh, Bl, C, M, N, K, st);
  else
    err = dd ? launch_full<true>(Ah, Al, Bh, Bl, C, M, N, K, st)
             : launch_full<false>(Ah, Al, Bh, Bl, C, M, N, K, st);
  return (int)err;
}
