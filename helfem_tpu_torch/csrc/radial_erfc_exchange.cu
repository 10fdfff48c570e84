// Short-range (erfc) exchange kernel K10: KK[g, a] for every multipole
// channel g and density channel a, in f64, on the element-pair tables of
// the erfc kernel, which does not factorise:
//
//   Kp[g,a,e,f][j,k] = sum_{i,l} tei[g,e,f,i,j,k,l] W_a[e,f][i,l],
//   W_a[e,f][i,l]    = Pd[a][gidx[e,i], gidx[f,l]]   (trash slot read as 0),
//   KK[g,a][n,m]     = sum of Kp[g,a,e,f][j,k] over the (e,j) covering n and
//                      the (f,k) covering m.
//
// Replaces helfem_tpu/models/atomic.py:erfc_exchange_bd's contraction
// ("efijkl,aefil->aefjk" and its one-hot assembly, an XLA-fused einsum
// program in a scan over L), and the same contraction of erfc_exchange on
// the channel-pair windows (atomic.py:650-680).
//
// The table's symmetries. tei[g,e,f,i,j,k,l] is symmetric under i <-> j,
// under k <-> l and under the pair swap (e,i,j) <-> (f,k,l). The wrapper
// packs it once per table set (kernels/radial_erfc_exchange.py:
// pack_erfc_table) into one copy of each unique entry: per g, the slabs
// M_ef[r, s] = tei[g,e,f,i,j,k,l] of the pairs e < f over the symmetric
// index pairs r = (i <= j), s = (k <= l) (npk = np (np + 1) / 2 rows of npk),
// then the slabs e = f as their upper triangles s >= r. With
//
//   C_M(W)[j,k] = sum_{i,l} M[(ij), (kl)] W[i,l],
//   What_a[e,f][i,l] = Pd[a][gidx[f,l], gidx[e,i]]   (the window of Pd^T),
//
// the symmetries give Kp[f,e] = C_M(What)^T for e < f, and for e = f, with
// M the upper triangle and its diagonal halved, Kp[e,e] = C_M(W) +
// C_M(What)^T. So every slab is read once per call for both orders and
// every channel: 2 nang columns, W_a and What_a interleaved (column 2a, 2a +
// 1).
//
// One cooperative launch of a persistent grid (a block per SM), two phases
// joined by a grid-wide barrier:
//   1. slab tasks (g, element pair, column part) in a fixed round-robin over
//      the blocks. Each task's slab streams through a ring of NS stages in
//      shared memory, one TMA bulk copy (cp.async.bulk) per chunk of RC
//      consecutive rows completing on the stage's mbarrier; lane 0 of warp
//      7 keeps the copies in flight, running ahead into the block's next
//      task, and each stage is refilled once all eight warps have released
//      it (a second mbarrier). The eight warps all compute: they gather the
//      task's windows (cp.async over gidx, into one of two buffers while the
//      task before runs), then, for every chunk, each warp runs its items
//      (one output row j of the slab, MT 8-row tiles of k, a group of NG
//      8-column tiles) over the chunk's rows (i, j) on the FP64 tensor
//      cores (m16n8k4 for two tiles of k, m8n8k4 for one): a lane reads its
//      A entries of the row through its (k, l) -> s, the B fragments from
//      the windows; an item of fewer tiles than NG spreads its depth steps
//      over the free accumulators. The sums stay in registers across the
//      chunks and, after the last, go through shared memory (over the
//      windows) to KK where an entry has one owner, else to the scratch
//      Kpair (pair_assembly.cuh). A part holds CPP column groups and the
//      output rows j0 .. j0 + JP - 1; only channel counts or nprim beyond
//      what the registers hold take more than one part, and only they read
//      a slab more than once. A diagonal slab split in rows (cross) adds
//      the items of every other row at the m-tiles of the part's rows, whose
//      What sums are the second term of Kp[e,e][j, k], j in the part.
//   2. the owner-computes assembly of the boundary rows and columns.
// No atomics: two calls give the same bits.
//
// Bound on the H100: the packed table, Pd once and KK once. At the Ar bench
// basis (NL 3, nelem 10, nprim 15) the table holds 16.5 MiB of the dense
// 115.9: about 0.006 ms at 3.35 TB/s; its 0.12 GFLOP per spin take 0.002 ms
// on the FP64 tensor cores. The table then fits in the 50 MB L2, so a call
// that follows another reads it from there. What bounds the kernel instead
// is the latency of each warp's chain of rows (a row's loads, then its
// products on the item's accumulators) and the fixed cost of the launch,
// the barrier and the assembly (PERF.md, tools/erfc_split.py).
//
// Instances: KS = ceil(nprim / 4) depth steps unrolled up to nprim 20; past
// that one instance of MT 1 runs the depth steps in blocks of four (KS = 0
// in the template) with NG 4 or 1, and the plan splits the rows into parts
// where an output row's items outgrow the registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pair_assembly.cuh"

namespace cg = cooperative_groups;

#define RE_WARPS 8      // warps of a block (RB_THREADS threads), all consumers
#define RE_PRODUCER 7   // the warp whose lane 0 also keeps the ring's copies in flight

// The launch's arguments, as kernels/radial_erfc_exchange.py:_Launch lays
// them out: the pointers, then the sizes and the plan (m-tiles per item MT,
// 8-column tiles per column group NG, ring stages NS, rows per chunk RC,
// doubles per stage STG, column groups per part CPP, output rows per part
// JP (nprim, or a multiple of 8 MT), window buffers NWB: with two, a task's
// windows are gathered while the task before it runs).
// nang counts the density channels a (ns * nang for ns spins).
struct ReLaunch {
  const double *tei, *Pd;  // tei: the packed table [NL, gstride], 2 doubles of padding after it
  const int *gidx, *owners, *bounds;  // bounds: the nb functions two slots share
  double *Kpair, *KK;
  unsigned long long* nbytes;  // optional [gridDim.x]: the bytes of each block's bulk copies
  void* stream;
  int NL, nelem, nprim, nang, nrad, nb, MT, NG, NS, RC, STG, CPP, JP, NWB, device;
};

// Sizes that follow from the launch (kernels/radial_erfc_exchange.py:plan
// mirrors them).
struct ReSizes {
  int np, nr;    // nr = np (np + 1) / 2: rows of a slab, each of nr entries
  int KS, ws, ldw;  // depth steps of 4 over l; window row stride per i; per column
  int nmg, ncol, nct, ngrp, nrp, npo, npairs, ntask, nchunk, wbd;
  int maxitem;      // the most items of a task (a cross task's, where nrp > 1)
  long long D, F, gstride;  // doubles of a diagonal slab, of another, per g
};

// items per consumer warp: 64 doubles of sums, at most 16 items
__host__ __device__ inline int re_items_per_warp(int MT, int NG) {
  return 32 / (MT * NG) < 16 ? 32 / (MT * NG) : 16;
}

__host__ __device__ inline ReSizes re_sizes(const ReLaunch& a) {
  ReSizes z;
  const int np = a.nprim;
  z.np = np;
  z.nr = np * (np + 1) / 2;
  const int np4 = rb_ceil(np, 4);
  z.KS = np4 / 4;
  z.ws = np4 + 1;  // odd: the transposed window gather writes without bank conflicts
  z.ldw = dmma_ld(np * z.ws);
  z.nmg = ((np + 7) / 8 + a.MT - 1) / a.MT;
  z.ncol = 2 * a.nang;
  z.nct = (z.ncol + 7) / 8;
  z.ngrp = (z.nct + a.NG - 1) / a.NG;
  z.nrp = (np + a.JP - 1) / a.JP;
  z.npo = a.nelem * (a.nelem - 1) / 2;
  z.npairs = z.npo + a.nelem;
  z.ntask = (z.ngrp + a.CPP - 1) / a.CPP * z.nrp * a.NL * z.npairs;
  z.nchunk = (z.nr + a.RC - 1) / a.RC;
  z.wbd = (z.nct < a.NG * a.CPP ? z.nct : a.NG * a.CPP) * 8 * z.ldw;
  const int gm = 8 * a.MT;
  z.maxitem = a.CPP * (z.nrp == 1 ? np * z.nmg
                                   : a.JP * z.nmg + (np - a.JP) * ((a.JP + gm - 1) / gm));
  z.F = (long long)z.nr * z.nr;
  z.D = (long long)z.nr * (z.nr + 1) / 2;
  z.gstride = z.npo * z.F + a.nelem * z.D;
  return z;
}

// Dynamic shared memory: the mbarriers (full, empty), the ring, the window
// buffers (each, after a task's products, its output), the shared tables.
__host__ __device__ inline int re_smem(const ReLaunch& a) {
  const ReSizes z = re_sizes(a);
  return 8 * (2 * a.NS + a.NS * a.STG + a.NWB * z.wbd) +
         pair_tables_bytes(a.nrad, a.nelem, a.nprim);
}

// the row of the symmetric pair (p <= q) in the packed order (p-major)
__host__ __device__ inline int re_tri(int p, int q, int np) {
  return p * np - p * (p - 1) / 2 + q - p;
}
// the slab row of (i, j) and the entry of (k, l) within a row
__device__ __forceinline__ int re_index(int i, int j, int np) {
  return re_tri(min(i, j), max(i, j), np);
}
// the first double of row r within its slab: a triangular slab keeps the
// entries s >= r of row r
__device__ __forceinline__ int re_rowstart(int r, int nr, bool tri) {
  return tri ? r * nr - r * (r - 1) / 2 : r * nr;
}

struct ReTask {
  int g, e, f, cg0, ncg, j0, nj;  // column groups cg0 .. cg0 + ncg - 1, rows j0 .. j0 + nj - 1
  bool diag, cross;  // e = f (the slab is its upper triangle); and split in rows
  const double* slab;
};

// task = (part, g, pair), part = (column part, row part): pairs 0 .. npo - 1
// are e < f (row-major), then the diagonals, as pack_erfc_table lays them out
__device__ __forceinline__ ReTask re_task(const ReLaunch& a, const ReSizes& z, int task) {
  ReTask t;
  const int per = a.NL * z.npairs, part = task / per, rest = task - part * per;
  const int cp = part / z.nrp, rp = part - cp * z.nrp;
  t.g = rest / z.npairs;
  int p = rest - t.g * z.npairs;
  const double* base = a.tei + t.g * z.gstride;
  t.diag = p >= z.npo;
  if (t.diag) {
    t.e = t.f = p - z.npo;
    t.slab = base + z.npo * z.F + t.e * z.D;
  } else {
    t.slab = base + p * z.F;
    int e = 0;
    while (p >= a.nelem - 1 - e) p -= a.nelem - 1 - e++;
    t.e = e;
    t.f = e + 1 + p;
  }
  t.cross = t.diag && z.nrp > 1;
  t.cg0 = cp * a.CPP;
  t.ncg = min(a.CPP, z.ngrp - t.cg0);
  t.j0 = rp * a.JP;
  t.nj = min(a.JP, z.np - t.j0);
  return t;
}

// Item x of task t: output row j, m-group mg, column group lg (of the
// part). The part's rows at every m-group; on a cross task, then every
// other row at the m-groups that cover the part's rows.
struct ReItem {
  int j, mg, lg;
};

__device__ __forceinline__ int re_per_group(const ReSizes& z, const ReTask& t, int MT) {
  const int gm = 8 * MT;
  return t.nj * z.nmg + (t.cross ? (z.np - t.nj) * ((t.nj + gm - 1) / gm) : 0);
}

__device__ __forceinline__ ReItem re_item_at(const ReSizes& z, const ReTask& t, int MT, int per,
                                             int x) {
  ReItem it;
  it.lg = x / per;
  int y = x - it.lg * per;
  const int band = t.nj * z.nmg;
  if (y < band) {
    it.mg = y % z.nmg;
    it.j = t.j0 + y / z.nmg;
  } else {
    const int gm = 8 * MT, nmgp = (t.nj + gm - 1) / gm;
    y -= band;
    it.mg = t.j0 / gm + y % nmgp;
    it.j = y / nmgp;
    if (it.j >= t.j0) it.j += t.nj;
  }
  return it;
}

// chunk c of a slab: rows [c RC, (c + 1) RC), copied from the 16-byte
// boundary at or below their first double (`lead` doubles before it: at an
// odd row length a chunk need not be aligned)
struct ReChunk {
  const double* src;
  unsigned bytes;
  int r0, r1, lead;
};

__device__ __forceinline__ ReChunk re_chunk(const ReLaunch& a, const ReSizes& z, const ReTask& t,
                                            int c) {
  ReChunk ch;
  ch.r0 = c * a.RC;
  ch.r1 = min(z.nr, ch.r0 + a.RC);
  const int s0 = re_rowstart(ch.r0, z.nr, t.diag), s1 = re_rowstart(ch.r1, z.nr, t.diag);
  ch.lead = (int)(((size_t)(t.slab + s0) >> 3) & 1);
  ch.src = t.slab + s0 - ch.lead;
  ch.bytes = (unsigned)((ch.lead + (s1 - s0) + 1) / 2 * 16);
  return ch;
}

__device__ __forceinline__ unsigned re_smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void re_bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(re_smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void re_bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(re_smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void re_bar_wait(unsigned long long* bar, int parity) {
  asm volatile(
      "{\n .reg .pred P1;\nRE_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra RE_DONE;\n bra RE_WAIT;\nRE_DONE:\n}\n" ::"r"(re_smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// arm the stage's mbarrier for `bytes` and copy them (TMA) into the stage
__device__ __forceinline__ void re_bulk_load(double* dst, const double* src, unsigned bytes,
                                             unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(re_smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(re_smem_u32(dst)), "l"(src), "r"(bytes), "r"(re_smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void re_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for the cp.async groups but the `pending` last
__device__ __forceinline__ void re_cp_wait(bool pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// true once the phase of `parity` of the mbarrier has completed (no wait)
__device__ __forceinline__ bool re_bar_done(unsigned long long* bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred P1;\n mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      " selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(re_smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

// The ring's producer: the bulk copies of the block's chunks in order (chunk
// n into stage n % NS, once every warp has released the chunk n - NS there).
struct ReRing {
  int task, c, n;  // the next chunk to copy: chunk c of `task`, the block's n-th
  unsigned long long total;  // bytes requested
  // copy chunks while n < upto: wait for their stages if `block`, else only
  // while a stage is free
  __device__ __forceinline__ void fill(const ReLaunch& a, const ReSizes& z, double* ring,
                                       unsigned long long* full, unsigned long long* empty,
                                       int upto, bool block) {
    while (n < upto && task < z.ntask) {
      const int s = n % a.NS, parity = ((n / a.NS) & 1) ^ 1;
      if (block)
        re_bar_wait(empty + s, parity);
      else if (!re_bar_done(empty + s, parity))
        return;
      const ReChunk ch = re_chunk(a, z, re_task(a, z, task), c);
      re_bulk_load(ring + (size_t)s * a.STG, ch.src, ch.bytes, full + s);
      total += ch.bytes;
      ++n;
      if (++c == z.nchunk) {
        c = 0;
        task += gridDim.x;
      }
    }
  }
};

// The FP64 tensor-core products: m8n8k4 (dmma.cuh) for one 8-row tile,
// m16n8k4 for two (lane (g, t) holds A[g][t] and A[g + 8][t], B[t][g], and
// C[g][2t..2t+1], C[g + 8][2t..2t+1]; the hardware sums in a fixed order).
__device__ __forceinline__ void re_mma16(double (&c)[4], double a0, double a1, double b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, "
               "{%6}, {%0, %1, %2, %3};\n"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a0), "d"(a1), "d"(b));
}

// An item's sums: [MT 8-row tiles][NG slots][2]. An item of NT < NG column
// tiles spreads its depth steps over the free slots (step ks into slot nt +
// NT (ks % (NG / NT))), so that more products run at once; re_store adds
// them back in slot order.
template <int MT, int NG>
struct ReAcc {
  double c[MT][NG][2];
};

// One item over the chunk's rows: output row j, m-tiles mg MT .. mg MT + MT
// - 1 (rows k), NT column tiles of the windows wb (column stride ldw), KS
// depth steps of 4 (l). cur is the item's next depth row i: its slab rows
// (i, j) rise with i, so the item takes them in order across the chunks.
// rows + rowstart(r) is row r; the lane's entries s of (k, l) are the same
// for every row. Past np a lane reads a clamped entry: finite, and its sums
// are dropped (k) or its window entries are 0 (l). TRI: a triangular slab,
// whose row r holds the entries s >= r (the diagonal counts twice).
__device__ __forceinline__ double re_entry(const double* P, int r, int s, bool tri) {
  if (!tri) return P[s];
  const double v = P[s >= r ? s : r];
  return s > r ? v : (s == r ? 0.5 * v : 0.0);
}

// re_item at a depth known at run time (KS = 0, MT = 1): the z.KS depth
// steps in blocks of four, a lane's entry s of (k, l) computed per row;
// the steps past z.KS of the last block load clamped operands and skip
// their products
template <int NG, int NT, bool TRI>
__device__ __forceinline__ void re_item_any(const ReSizes& z, const double* rows, int r1, int j,
                                            int mg, const double* wb, int& cur,
                                            ReAcc<1, NG>& acc) {
  constexpr int SPREAD = NG / NT;  // divides 4: a step's slot depends on ks alone
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, np = z.np;
  const int k = min(8 * mg + gq, np - 1);
  for (; cur < np; ++cur) {
    const int i = cur, r = re_index(i, j, np);
    if (r >= r1) break;
    const double* P = rows + re_rowstart(r, z.nr, TRI) - (TRI ? r : 0);
    const double* b = wb + gq * z.ldw + i * z.ws + tq;
    for (int k0 = 0; k0 < z.KS; k0 += 4) {
      double av[4], bv[4][NT];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int st = min(k0 + ks, z.KS - 1);
        av[ks] = re_entry(P, r, re_index(k, min(4 * st + tq, np - 1), np), TRI);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) bv[ks][nt] = b[nt * 8 * z.ldw + 4 * st];
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (k0 + ks < z.KS)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int slot = nt + NT * (ks % SPREAD);
            dmma884(acc.c[0][slot][0], acc.c[0][slot][1], av[ks], bv[ks][nt]);
          }
    }
  }
}

template <int MT, int KS, int NG, int NT, bool TRI>
__device__ __forceinline__ void re_item(const ReSizes& z, const double* rows, int r1, int j,
                                        int mg, const double* wb, int& cur, ReAcc<MT, NG>& acc) {
  constexpr int SPREAD = NG / NT;
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3, np = z.np;
  int sidx[MT][KS];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      sidx[mt][ks] = re_index(min(8 * (mg * MT + mt) + gq, np - 1), min(4 * ks + tq, np - 1), np);
  for (; cur < np; ++cur) {
    const int i = cur, r = re_index(i, j, np);
    if (r >= r1) break;
    const double* P = rows + re_rowstart(r, z.nr, TRI) - (TRI ? r : 0);
    const double* b = wb + gq * z.ldw + i * z.ws + tq;
    double av[MT][KS], bv[KS][NT];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) bv[ks][nt] = b[nt * 8 * z.ldw + 4 * ks];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int s = sidx[mt][ks];
        if (TRI) {
          const double v = P[s >= r ? s : r];
          av[mt][ks] = s > r ? v : (s == r ? 0.5 * v : 0.0);
        } else {
          av[mt][ks] = P[s];
        }
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int slot = nt + NT * (ks % SPREAD);
        if (MT == 2) {
          double c[4] = {acc.c[0][slot][0], acc.c[0][slot][1], acc.c[MT - 1][slot][0],
                         acc.c[MT - 1][slot][1]};
          re_mma16(c, av[0][ks], av[MT - 1][ks], bv[ks][nt]);
          acc.c[0][slot][0] = c[0];
          acc.c[0][slot][1] = c[1];
          acc.c[MT - 1][slot][0] = c[2];
          acc.c[MT - 1][slot][1] = c[3];
        } else {
          dmma884(acc.c[0][slot][0], acc.c[0][slot][1], av[0][ks], bv[ks][nt]);
        }
      }
  }
}

// re_item for an item of ntn <= NG column tiles
template <int MT, int KS, int NG, bool TRI>
__device__ __forceinline__ void re_run(const ReSizes& z, const double* rows, int r1, int j, int mg,
                                       const double* wb, int ntn, int& cur, ReAcc<MT, NG>& acc) {
#define RE_ITEM(N)                                                \
  if constexpr (KS == 0)                                          \
    re_item_any<NG, N, TRI>(z, rows, r1, j, mg, wb, cur, acc);    \
  else                                                            \
    re_item<MT, KS, NG, N, TRI>(z, rows, r1, j, mg, wb, cur, acc)
  if constexpr (NG == 1) {
    RE_ITEM(1);
  } else if constexpr (NG == 8) {
    switch (ntn) {
      case 1: RE_ITEM(1); break;
      case 2: RE_ITEM(2); break;
      case 3: RE_ITEM(3); break;
      case 4: RE_ITEM(4); break;
      case 5: RE_ITEM(5); break;
      case 6: RE_ITEM(6); break;
      case 7: RE_ITEM(7); break;
      default: RE_ITEM(8); break;
    }
  } else {
    switch (ntn) {
      case 1: RE_ITEM(1); break;
      case 2: RE_ITEM(2); break;
      case 3: RE_ITEM(3); break;
      default: RE_ITEM(4); break;
    }
  }
#undef RE_ITEM
}

// An item's sums into O[col][j np + k] (column stride ldw): column tile nt
// of an item of NT tiles is the sum of its slots, in slot order.
template <int MT, int NG, int NT>
__device__ __forceinline__ void re_store(const ReAcc<MT, NG>& acc, double* O, int ldw, int np,
                                         int j, int k0, int cl0, int ncl) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double v = acc.c[mt][nt][h];
#pragma unroll
        for (int c = 1; c < NG / NT; ++c) v += acc.c[mt][nt + NT * c][h];
        const int k = k0 + 8 * mt + gq, cl = cl0 + 8 * nt + 2 * tq + h;
        if (k < np && cl < ncl) O[cl * ldw + j * np + k] = v;
      }
}

// re_store for an item of ntn <= NG column tiles
template <int MT, int NG>
__device__ __forceinline__ void re_store_n(const ReAcc<MT, NG>& acc, double* O, int ldw, int np,
                                           int j, int k0, int cl0, int ncl, int ntn) {
#define RE_STORE(N) re_store<MT, NG, N>(acc, O, ldw, np, j, k0, cl0, ncl)
  if constexpr (NG == 1) {
    RE_STORE(1);
  } else if constexpr (NG == 8) {
    switch (ntn) {
      case 1: RE_STORE(1); break;
      case 2: RE_STORE(2); break;
      case 3: RE_STORE(3); break;
      case 4: RE_STORE(4); break;
      case 5: RE_STORE(5); break;
      case 6: RE_STORE(6); break;
      case 7: RE_STORE(7); break;
      default: RE_STORE(8); break;
    }
  } else {
    switch (ntn) {
      case 1: RE_STORE(1); break;
      case 2: RE_STORE(2); break;
      case 3: RE_STORE(3); break;
      default: RE_STORE(4); break;
    }
  }
#undef RE_STORE
}

// The windows of task t into W: column 2a is W_a[i, l], 2a + 1 What_a[i, l],
// at W[col ldw + i ws + l], zero past np and on the trash slot; a thread
// takes one (i, l) of every G-th column. cp.async: the caller waits.
__device__ __forceinline__ void re_gather(const ReLaunch& a, const ReSizes& z,
                                          const PairTables& tab, const ReTask& t, double* W) {
  const int np = z.np, np4 = z.ws - 1, nil = np * np4, nrad = a.nrad;
  const int c0 = 8 * a.NG * t.cg0, ncw = 8 * ((min(z.ncol - c0, 8 * a.NG * t.ncg) + 7) / 8);
  const int* ge = tab.gs + t.e * np;
  const int* gf = tab.gs + t.f * np;
  const int G = max(1, RB_THREADS / nil);
  for (int x = threadIdx.x; x < nil * G; x += RB_THREADS) {
    const int cg = x / nil, il = x - cg * nil, i = il / np4, l = il - i * np4;
    const int ni = ge[i], nl = l < np ? gf[l] : nrad;
    const bool live = ni < nrad && nl < nrad;
    const size_t w = (size_t)ni * nrad + nl, wh = (size_t)nl * nrad + ni;
    for (int cl = cg; cl < ncw; cl += G) {
      const int c = c0 + cl;
      double* dst = W + cl * z.ldw + i * z.ws + l;
      if (live && c < z.ncol)
        cp_async8(dst, a.Pd + (size_t)(c >> 1) * nrad * nrad + (c & 1 ? wh : w));
      else
        *dst = 0.0;
    }
  }
  re_cp_commit();
}

template <int MT, int KS, int NG>
__global__ void __launch_bounds__(RB_THREADS, 1) radial_erfc_exchange_kernel(const ReLaunch a) {
  constexpr int NI = (32 / (MT * NG)) < 16 ? 32 / (MT * NG) : 16;  // re_items_per_warp
  extern __shared__ __align__(16) double smem[];
  const ReSizes z = re_sizes(a);
  const int np = a.nprim, NS = a.NS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned long long* full = (unsigned long long*)smem;  // a stage's chunk landed
  unsigned long long* empty = full + NS;                 // every consumer warp is done with it
  double* ring = smem + 2 * NS;
  double* WB = ring + (size_t)NS * a.STG;  // windows [column][i ws + l], then the output
  const PairTables tab = stage_pair_tables(a, WB + a.NWB * z.wbd);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      re_bar_init(full + s, 1);
      re_bar_init(empty + s, RE_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const bool producer = warp == RE_PRODUCER && lane == 0;
  ReRing prod{(int)blockIdx.x, 0, 0, 0};
  if (producer) prod.fill(a, z, ring, full, empty, NS, false);  // the ring's first stages
  __syncwarp();
  int n = 0, it = 0;  // the block's chunk count, task count
  if (a.NWB == 2 && blockIdx.x < z.ntask) re_gather(a, z, tab, re_task(a, z, blockIdx.x), WB);
  for (int task = blockIdx.x; task < z.ntask; task += gridDim.x, ++it) {
    const ReTask t = re_task(a, z, task);
    const int c0 = 8 * NG * t.cg0, ncl = min(z.ncol - c0, 8 * NG * t.ncg), nctl = (ncl + 7) / 8;
    const int per = re_per_group(z, t, MT), nitem = t.ncg * per;  // re_item_at
    double* W = WB + (size_t)(it % a.NWB) * z.wbd;
    __syncthreads();  // the previous task's output is written
    // this task's windows, gathered here or (two buffers) during the
    // previous task, and the next task's into the other buffer
    const bool ahead = a.NWB == 2 && task + gridDim.x < z.ntask;
    if (a.NWB == 1) re_gather(a, z, tab, t, W);
    if (ahead) re_gather(a, z, tab, re_task(a, z, task + gridDim.x), WB + (it + 1) % 2 * z.wbd);
    re_cp_wait(ahead);
    __syncthreads();

    ReAcc<MT, NG> acc[NI];
    int cur[NI];
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      cur[q] = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NG; ++nt) acc[q].c[mt][nt][0] = acc[q].c[mt][nt][1] = 0.0;
    }
    for (int c = 0; c < z.nchunk; ++c, ++n) {
      const int s = n % NS;
      const ReChunk ch = re_chunk(a, z, t, c);
      if (producer) {  // this chunk copied, and those after it whose stages are free
        prod.fill(a, z, ring, full, empty, n + 1, true);
        prod.fill(a, z, ring, full, empty, n + NS, false);
      }
      __syncwarp();
      re_bar_wait(full + s, (n / NS) & 1);
      const double* rows =
          ring + (size_t)s * a.STG + ch.lead - re_rowstart(ch.r0, z.nr, t.diag);
#pragma unroll
      for (int q = 0; q < NI; ++q) {
        const int x = warp + RE_WARPS * q;
        if (x < nitem) {
          const ReItem im = re_item_at(z, t, MT, per, x);
          const double* wb = W + 8 * NG * im.lg * z.ldw;
          const int ntn = min(NG, nctl - NG * im.lg);
          if (t.diag)
            re_run<MT, KS, NG, true>(z, rows, ch.r1, im.j, im.mg, wb, ntn, cur[q], acc[q]);
          else
            re_run<MT, KS, NG, false>(z, rows, ch.r1, im.j, im.mg, wb, ntn, cur[q], acc[q]);
        }
      }
      __syncwarp();
      if (lane == 0) re_bar_arrive(empty + s);
    }

    // the sums through shared memory: O[col][j np + k] over the windows
    __syncthreads();
    double* O = W;
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int x = warp + RE_WARPS * q;
      if (x < nitem) {
        const ReItem im = re_item_at(z, t, MT, per, x);
        re_store_n(acc[q], O, z.ldw, np, im.j, 8 * im.mg * MT, 8 * NG * im.lg, ncl,
                   min(NG, nctl - NG * im.lg));
      }
    }
    __syncthreads();
    // the part's rows j: Kp[e,f][j,k] (column 2a), Kp[f,e][k,j] = column
    // 2a + 1 at (j, k), or for e = f Kp[e,e][j,k] = column 2a at (j, k) +
    // column 2a + 1 at (k, j), into KK or the scratch; consecutive threads
    // on consecutive columns of KK
    const int nch = ncl / 2, ga0 = t.g * a.nang + c0 / 2, npart = t.nj * np;
    const FastDiv by_part(npart), by_np(np), by_nj(t.nj);
    for (int x = tid; x < nch * npart; x += RB_THREADS) {
      const int ch = by_part(x), y = x - ch * npart, j = t.j0 + by_np(y), k = y - (j - t.j0) * np;
      const double* Oc = O + 2 * ch * z.ldw;
      if (t.diag) {
        put_kp(a, kp_dest(a, tab.sl, t.e, j, t.e, k), ga0 + ch,
               Oc[j * np + k] + Oc[z.ldw + k * np + j]);
      } else {
        put_kp(a, kp_dest(a, tab.sl, t.e, j, t.f, k), ga0 + ch, Oc[j * np + k]);
        const int kk = t.nj > 1 ? by_nj(y) : y;  // FastDiv needs a divisor > 1
        const int jj = t.j0 + y - kk * t.nj;    // jj fastest: (f, kk), (e, jj)
        put_kp(a, kp_dest(a, tab.sl, t.f, kk, t.e, jj), ga0 + ch, Oc[z.ldw + jj * np + kk]);
      }
    }
  }
  if (producer && a.nbytes) a.nbytes[blockIdx.x] = prod.total;
  cg::this_grid().sync();

  // ---- phase 2: the boundary rows and columns (pair_assembly.cuh) ----
  assemble_boundaries(a, tab, a.NL * a.nang);
}

// The instance of MT m-tiles per item, KS depth steps (KS = ceil(nprim / 4);
// past 5 the instance of KS = 0 runs them) and NG column tiles per group
// (the plan's), or null.
static const void* re_kernel(int MT, int KS, int NG) {
  if (MT == 1 && KS > 5 && NG == 4) return (const void*)radial_erfc_exchange_kernel<1, 0, 4>;
  if (MT == 1 && KS > 5 && NG == 1) return (const void*)radial_erfc_exchange_kernel<1, 0, 1>;
  if (MT == 1 && KS == 1 && NG == 8) return (const void*)radial_erfc_exchange_kernel<1, 1, 8>;
  if (MT == 1 && KS == 2 && NG == 8) return (const void*)radial_erfc_exchange_kernel<1, 2, 8>;
  if (MT == 2 && KS == 3 && NG == 4) return (const void*)radial_erfc_exchange_kernel<2, 3, 4>;
  if (MT == 2 && KS == 4 && NG == 4) return (const void*)radial_erfc_exchange_kernel<2, 4, 4>;
  if (MT == 1 && KS == 5 && NG == 4) return (const void*)radial_erfc_exchange_kernel<1, 5, 4>;
  return nullptr;
}

// Blocks of `fn` that one SM holds at `smem` bytes, for the cooperative
// launch, after allowing it the card's whole 227 KB and the largest
// shared-memory carveout (once per instance and device).
static int re_blocks_per_sm(const void* fn, int device, int smem) {
  static const void* ready[8][8];
  int k = 0;
  while (k < 8 && ready[device][k] && ready[device][k] != fn) ++k;
  if (k == 8 || !ready[device][k]) {
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448) !=
            cudaSuccess ||
        cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return 0;
    if (k < 8) ready[device][k] = fn;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, RB_THREADS, (size_t)smem) !=
      cudaSuccess)
    return 0;
  return n;
}

// The kernel's dynamic shared memory for these sizes and plan (the wrapper's
// plan must agree).
extern "C" int radial_erfc_exchange_smem(const ReLaunch* a) { return re_smem(*a); }

// Kpair [NL, nang, nelem, nprim, nelem, nprim]: scratch (only the entries in
// boundary rows and columns are written and read); KK: output [NL, nang,
// nrad, nrad]. Returns a cudaError_t.
extern "C" int radial_erfc_exchange_launch(const ReLaunch* a) {
  const ReSizes z = re_sizes(*a);
  const void* fn = re_kernel(a->MT, z.KS, a->NG);
  if (!fn || a->NS < 3 || a->RC < 1 || a->RC > z.nr || a->CPP < 1 || a->STG % 2 ||
      (a->NWB != 1 && a->NWB != 2) || a->STG < a->RC * z.nr + 2 || a->JP < 1 ||
      (a->JP < a->nprim && a->JP % (8 * a->MT)) ||
      z.maxitem > RE_WARPS * re_items_per_warp(a->MT, a->NG))
    return (int)cudaErrorInvalidValue;
  if (a->device < 0 || a->device >= 8) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const int smem = re_smem(*a), per_sm = re_blocks_per_sm(fn, a->device, smem);
  const int nsm = sm_count(a->device);
  if (per_sm < 1 || nsm < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)a};
  return (int)cudaLaunchCooperativeKernel(fn, per_sm * nsm, RB_THREADS, args, (size_t)smem,
                                          (cudaStream_t)a->stream);
}
