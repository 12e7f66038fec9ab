// Launch shape and helpers of K1 and K2, the CONTRA wavefronts of the
// N <= 256 probability tier (contra_inside.cu, contra_outside.cu): one
// block of T threads per sequence, T from the batch, N and the card.
//
// Thread i owns lane i (i < N <= T) and keeps its per-lane state in
// registers; a span computes its live lanes only (i + d < n), and a dead
// cell keeps the zero the wrapper passes.  A span is two phases, each
// ending in a barrier:
//   1. the owners compute their cells from their table cells and the
//      window sum of the phase before, while every thread of the block
//      computes a part of the live lanes' O(d) sums (rna_nw_part: part p of
//      a lane takes its terms p, p + k, p + 2k, ...);
//   2. the owners add their lane's parts in a fixed order and finish the
//      cell, while every thread takes a share of the next span's 2-loop
//      windows, computed for the cells that can close only (listed in
//      phase 1) and over their nonzero ring cells only: each gets a group
//      of GW threads (rna_nw_window_pass).
// The owners' table reads overlap the parts in phase 1: staging them a
// span ahead with cp.async changed nothing on an H100 (PERF.md, PR 10).
// The sums' orders depend on the launch (T, the live lanes, the closable
// count) and not on timing, so a result is the same run to run;
// tests/test_torch_prob_split.py replays them against the plain versions.
//
// The helpers here are K1/K2's own: common.cuh's, which K4/K5 share, and
// cluster.cuh's, which K8/K9 share, stay as they were measured.
#pragma once

#include "launch.cuh"

#define RNA_NW_MAX_THREADS 1024
#define RNA_NW_MIN_THREADS 256
// Terms whose loads a part issues before their FMAs: whole batches, then
// the rest one at a time.  On an H100 (PERF.md, PR 10) 8 inside terms ran
// K1 1.37x slower at N = 128, and 4 outside terms ran K2 5% slower at
// N = 256 than 8 (ptxas allocates each form differently).
#define RNA_NW_BATCH_INSIDE 4
#define RNA_NW_BATCH_OUTSIDE 8

// The block size of a launch over B sequences at N: of T = 1024, 512, 256
// (T >= N), the one that runs the batch in the fewest waves of resident
// blocks (cudaOccupancyMaxActiveBlocksPerMultiprocessor with `smem(N, T)`
// bytes of dynamic shared memory), the larger on a tie; 0 if none
// launches.  Sets the kernel's shared-memory attribute for each T tried.
template <typename Kernel, typename Smem>
static int rna_nw_threads(Kernel kernel, Smem smem, int B, int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int best = 0;
  long long best_waves = 0;
  for (int T = RNA_NW_MAX_THREADS; T >= RNA_NW_MIN_THREADS && T >= N;
       T /= 2) {
    const size_t bytes = smem(N, T);
    int per_sm = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                      bytes) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    if (per_sm < 1) continue;
    const long long slots = (long long)sms * per_sm;
    const long long waves = (B + slots - 1) / slots;
    if (!best || waves < best_waves) {
      best = T;
      best_waves = waves;
    }
  }
  return best;
}

// A thread's part of span d's O(d) sums over its m live lanes (0 .. m-1),
// padded to whole warps (m32): the T threads form k = T / m32 parts of
// m32 consecutive lanes each, and part p of lane l takes the lane's terms
// p, p + k, p + 2k, ... (a warp loads neighbouring lanes at one term).  A
// thread with p >= k has no part; lane l is live when l < m.
struct RnaNwPart {
  int m32, k, p, l;
};

__device__ __forceinline__ RnaNwPart rna_nw_part(int m, int tid, int T) {
  RnaNwPart q;
  q.m32 = (m + 31) & ~31;
  q.k = q.m32 ? T / q.m32 : 0;
  q.p = q.m32 ? tid / q.m32 : 0;
  q.l = q.m32 ? tid - q.p * q.m32 : 0;
  return q;
}

// One part of live lane i's span-d bifurcation sums (K1): the terms
// t = t0, t0 + k, ... < d of
//   es += rm(d-t, i+t) * ext(t-1, i),   s2 += one(t-1, i) * rmmb(d-t, i+t)
// (spans < d only; the tables are one sequence's), RNA_NW_BATCH_INSIDE
// terms' loads issued before their FMAs, the terms left after the whole
// batches one at a time.
__device__ __forceinline__ void rna_nw_inside_part(
    int d, int i, int N, int t0, int k, const float* ext, const float* one,
    const float* rm_hist, const float* rmm_hist, float& es, float& s2) {
  const int diag = d * N + i;   // term t: - t (N - 1)
  const int col = i - N;        // term t: + t N
  int t = t0;
  for (; t + (RNA_NW_BATCH_INSIDE - 1) * k < d;
       t += RNA_NW_BATCH_INSIDE * k) {
    float rv[RNA_NW_BATCH_INSIDE], mv[RNA_NW_BATCH_INSIDE],
        ev[RNA_NW_BATCH_INSIDE], ov[RNA_NW_BATCH_INSIDE];
#pragma unroll
    for (int u = 0; u < RNA_NW_BATCH_INSIDE; ++u) {
      const int tt = t + u * k;
      rv[u] = rm_hist[diag - tt * (N - 1)];
      mv[u] = rmm_hist[diag - tt * (N - 1)];
      ev[u] = ext[col + tt * N];
      ov[u] = one[col + tt * N];
    }
#pragma unroll
    for (int u = 0; u < RNA_NW_BATCH_INSIDE; ++u) {
      es = fmaf(rv[u], ev[u], es);
      s2 = fmaf(ov[u], mv[u], s2);
    }
  }
  for (; t < d; t += k) {
    es = fmaf(rm_hist[diag - t * (N - 1)], ext[col + t * N], es);
    s2 = fmaf(one[col + t * N], rmm_hist[diag - t * (N - 1)], s2);
  }
}

// One part of live lane i's span-d multibranch sums (K2), terms
// u = u0, u0 + k, ... (the tables are one sequence's):
//   pm  += g(d+2+u, i) * one(u, i+d+1),     u < n - 2 - d - i
//   sa  += pm2(d+1+u, i-1-u) * QONE(u+1, i)  \  u < min(i, n - 1 - d)
//   sbc += pm(d+1+u, i-1-u) * QONE(u+1, i)   /
// pm's walk, then sa's and sbc's together, RNA_NW_BATCH_OUTSIDE terms'
// loads a batch, the terms left after the whole batches one at a time
// (walking all three together, with predicated loads past the shorter
// sum's end, ran K2 1.03-1.09x slower on an H100: PERF.md, PR 10).  Live
// cells only.
__device__ __forceinline__ void rna_nw_outside_part(
    int d, int i, int n, int N, int u0, int k, const float* __restrict__ ONE,
    const float* __restrict__ QONE, const float* g_hist,
    const float* pm_hist, const float* pm2_hist, float& pm, float& sa,
    float& sbc) {
  const int gcol = (d + 2) * N + i;     // + u N
  const int orow = i + d + 1;           // + u N
  const int src0 = (d + 1) * N + i - 1;   // + u (N - 1)
  const int qcol = N + i;               // + u N
  const int tn = n - 2 - d - i, tq = min(i, n - 1 - d);
  constexpr int BO = RNA_NW_BATCH_OUTSIDE;
  int u = u0;
  for (; u + (BO - 1) * k < tn; u += BO * k) {
    float gv[BO], ov[BO];
#pragma unroll
    for (int v = 0; v < BO; ++v) {
      const int uu = u + v * k;
      gv[v] = g_hist[gcol + uu * N];
      ov[v] = ONE[orow + uu * N];
    }
#pragma unroll
    for (int v = 0; v < BO; ++v) pm = fmaf(gv[v], ov[v], pm);
  }
  for (; u < tn; u += k) pm = fmaf(g_hist[gcol + u * N], ONE[orow + u * N], pm);
  u = u0;
  for (; u + (BO - 1) * k < tq; u += BO * k) {
    float av[BO], bv[BO], qv[BO];
#pragma unroll
    for (int v = 0; v < BO; ++v) {
      const int uu = u + v * k;
      av[v] = pm2_hist[src0 + uu * (N - 1)];
      bv[v] = pm_hist[src0 + uu * (N - 1)];
      qv[v] = QONE[qcol + uu * N];
    }
#pragma unroll
    for (int v = 0; v < BO; ++v) {
      sa = fmaf(av[v], qv[v], sa);
      sbc = fmaf(bv[v], qv[v], sbc);
    }
  }
  for (; u < tq; u += k) {
    const float q = QONE[qcol + u * N];
    sa = fmaf(pm2_hist[src0 + u * (N - 1)], q, sa);
    sbc = fmaf(pm_hist[src0 + u * (N - 1)], q, sbc);
  }
}

// Threads a closable cell's window gets: the largest power of two <= 32
// with K * GW <= T (K <= N <= T, so at least 1).
__device__ __forceinline__ int rna_nw_group(int K, int T) {
  int g = 32;
  while (g > 1 && K * g > T) g >>= 1;
  return g;
}

// The window pass of span D: the K cells listed in `cells` (their lanes)
// get GW threads each, group k on threads k GW .. k GW + GW - 1.  The
// window sum_{a < r < 32} K[a][r] * ring(age r, lane shifted by a) of a
// cell splits by row a: the 31 rows are dealt to the group's threads in a
// snake (row q GW + g on even rounds q, q GW + GW - 1 - g on odd ones, so
// the long rows of small a spread), each thread adds its rows in order,
// each row in order r = a + 1 .. 31 (FMA), and the group's partial sums
// meet in a halving tree (x[g] += x[g + h], h = GW/2 .. 1, by
// __shfl_xor_sync).  The group's first thread writes the sum to win[lane].
// A row visits only its nonzero ring cells: nz[lane] has bit s & 31 set
// while the lane's ring slot s holds a nonzero value (its owner keeps it
// with the ring; ~2/3 of the cells are 0, every pair that cannot close).
// INSIDE: ring(d-1-r, i+1+a), ring rows LW floats apart, lane l at column
// l and mask nz[l]; outside: ring(d+1+r, i-1-a), lane l at column 32 + l
// and mask nz[32 + l].  Every thread of the block calls this (the
// shuffles take whole warps).
template <bool INSIDE>
__device__ __forceinline__ void rna_nw_window_pass(const float* ring, int LW,
                                                   const unsigned* nz,
                                                   const float* kw,
                                                   const int* cells, int K,
                                                   int D, int T, float* win) {
  const int GW = rna_nw_group(K, T);
  const int tid = threadIdx.x, c = tid / GW, g = tid - c * GW;
  float v = 0.0f;
  int i = 0;
  if (c < K) {
    i = cells[c];
    for (int q = 0; q * GW < RNA_WIN - 1; ++q) {
      const int a = q * GW + ((q & 1) ? GW - 1 - g : g);
      if (a >= RNA_WIN - 1) continue;
      const float* lane = ring + (INSIDE ? i + 1 + a : 31 + i - a);
      const float* krow = kw + a * RNA_WIN;
      // the row's nonzero ring cells: bit r of `ages` is slot (D-1-r) & 31
      // (inside) or (D+1+r) & 31 of the lane's mask, r > a; a zero cell
      // adds fma(K, 0, v) = v, so skipping it changes no bit
      const unsigned m = nz[INSIDE ? i + 1 + a : 31 + i - a];
      unsigned ages =
          INSIDE ? __funnelshift_r(__brev(m), __brev(m), 31 - ((D - 1) & 31))
                 : __funnelshift_r(m, m, (D + 1) & 31);
      ages &= 0xfffffffeu << a;
      while (ages) {
        const int r = __ffs(ages) - 1;
        ages &= ages - 1;
        v = fmaf(krow[r],
                 lane[((INSIDE ? D - 1 - r : D + 1 + r) & (RNA_WIN - 1)) * LW],
                 v);
      }
    }
  }
  for (int off = GW >> 1; off >= 1; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (c < K && g == 0) win[i] = v;
}
