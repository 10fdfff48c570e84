// FP64 tensor-core (DMMA) helpers shared by the diatomic XC kernels.
//
// mma.sync m8n8k4 f64: a warp multiplies an 8 x 4 tile A (row-major) by a
// 4 x 8 tile B into an 8 x 8 accumulator C. Lane l = 4 g + t (g = l >> 2,
// t = l & 3) holds a = A[g][t], b = B[t][g], and c0, c1 = C[g][2t],
// C[g][2t + 1]. The hardware sums in a fixed order: the same inputs give the
// same bits on every call.
#pragma once

__device__ __forceinline__ void dmma884(double& c0, double& c1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
               "{%0, %1};\n"
               : "+d"(c0), "+d"(c1)
               : "d"(a), "d"(b));
}

// A row stride (in doubles) of at least n, congruent to 4 mod 16: the
// fragment loads of a half-warp (rows g = 0..3, columns t = 0..3, or the
// transpose) then fall in 16 distinct 8-byte bank pairs.
__host__ __device__ inline int dmma_ld(int n) { return n + (20 - n % 16) % 16; }
