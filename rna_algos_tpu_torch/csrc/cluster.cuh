// Launch shape of the long wavefronts, CONTRA's K8 and K9 (N = 512, 1024,
// 2048) and Turner's K12 and K13 (N = 512, 1024): a thread-block cluster
// of C blocks per sequence.
//
// Each block of a sequence's cluster owns L = N / C lanes, in chunks
// interleaved over the blocks (RnaClLayout), their state in registers (one
// owner thread a lane) and their slice of the window ring and the
// telescoped rows in its own shared memory.  The lanes a chunk reads past
// its edge (the window's 32 neighbours, the telescoped rows' one) its
// block holds as a halo that the neighbouring chunk's block writes into
// through distributed shared memory when it writes its own lanes.  The
// spans are one loop in every block; each ends in one cluster barrier
// (barrier.cluster.arrive.release / wait.acquire), which also orders the
// history tables in global memory that one SM writes and another reads.
// Those are read with L2-only loads (__ldcg): the other SMs' L1 never
// holds a stale line of them.
//
// C is derived from the batch, N and the card, never configured: the
// largest C in {16, 8, 4, 2, 1} whose B * C blocks fit the SMs and of
// which cudaOccupancyMaxActiveClusters reports at least one cluster
// resident (C = 16 is a non-portable cluster size, allowed per kernel);
// fewer clusters than B may be resident at once, and the rest follow in
// waves (measured faster than the C that keeps a whole batch resident, on
// an H100 80GB HBM3 at 700 W: PERF.md).  A batch that no C fits (more
// sequences than SMs at N = 512, or more than half of them at N = 2048,
// where one block's ring exceeds shared memory) takes the smallest C that
// launches (Turner's four rings fit one block's shared memory only from
// C = 4 at N = 512 and C = 8 at N = 1024).  L >= 32 so that a chunk holds
// a warp and its halo comes from one neighbour, and L <= 1024 so that
// each lane has its own thread.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define RNA_CL_THREADS 1024
#define RNA_CL_MIN_LANES 32
#define RNA_CL_MAX_C 16
// Dynamic shared memory a block may use on the H100 (227 KB).
#define RNA_CL_SMEM_LIMIT 232448
// Terms of a part whose loads are issued before their FMAs: K8's sums
// ran fastest in whole batches of 4 with a serial tail, K9's in batches of
// 8 over both sums at once (A/B calls on an H100 80GB HBM3 at 700 W:
// PERF.md).
#define RNA_CL_BATCH_INSIDE 4
#define RNA_CL_BATCH 8

// The lanes of a block of L come in chunks of G = L / 8, at least one warp.
__host__ __device__ inline int rna_cl_chunk(int L) {
  return L / 8 > 32 ? L / 8 : 32;
}

// Whether a cluster of C blocks of `kernel` with `shmem` bytes of dynamic
// shared memory each can be resident; sets the kernel's attributes.
template <typename Kernel>
static bool rna_cl_fits(Kernel kernel, int C, size_t shmem) {
  if (shmem > RNA_CL_SMEM_LIMIT) return false;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)shmem) != cudaSuccess ||
      (C > 8 && cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                    1) != cudaSuccess)) {
    cudaGetLastError();
    return false;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(RNA_CL_THREADS);
  cfg.dynamicSmemBytes = shmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return active >= 1;
}

// The cluster size of a launch over B sequences at N (header comment), 0
// if no C launches; `smem(L)` is the kernel's shared memory at L lanes.
template <typename Kernel, typename Smem>
static int rna_cl_size(Kernel kernel, Smem smem, int B, int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  int smallest = 0;
  for (int C = RNA_CL_MAX_C; C >= 1; C /= 2) {
    const int L = N / C;
    if (N % C || L < RNA_CL_MIN_LANES || L > RNA_CL_THREADS ||
        L % rna_cl_chunk(L) || !rna_cl_fits(kernel, C, smem(L)))
      continue;
    if ((long long)B * C <= sms) return C;
    smallest = C;
  }
  return smallest;
}

// Launch `kernel` on B clusters of C blocks of RNA_CL_THREADS threads
// with `shmem` bytes of dynamic shared memory each; returns the CUDA
// error, 0 on success.
template <typename Kernel, typename... Args>
static int rna_cl_launch(Kernel kernel, int B, int C, size_t shmem,
                         void* stream, Args... args) {
  if (C < 1) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(RNA_CL_THREADS);
  cfg.dynamicSmemBytes = shmem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The lanes' layout over a cluster (rna_cl_chunk above): chunk c of G
// lanes on block c % C as its local chunk c / C, so that the live lanes
// [0, n - d) of every span spread over all C blocks (contiguous lanes per
// block would leave the lowest block the most work at every late span).
// Local lane il = q * G + p is global lane (q * C + r) * G + p.
struct RnaClLayout {
  int C, r, L, G;

  __device__ int lane(int il) const {
    return (il / G * C + r) * G + il % G;
  }

  // The local lanes live at span d (global lane < n - d): a prefix.
  __device__ int live(int n, int d) const {
    const int lg = max(0, n - d), full = lg / G;
    int m = full > r ? ((full - 1 - r) / C + 1) * G : 0;
    if (full % C == r) m += lg % G;
    return min(m, L);
  }

  // The block and local chunk of the chunk next to local chunk q (dir -1
  // below, +1 above); false past either end of the N lanes.
  __device__ bool next_chunk(int q, int dir, int N, int& rank,
                             int& qn) const {
    const int c = q * C + r + dir;
    if (c < 0 || c * G >= N) return false;
    rank = c % C;
    qn = c / C;
    return true;
  }
};

// A block's share of a lane's O(d) sums: at span d block r has m live
// lanes (local lanes 0 .. m - 1), padded to whole warps (m32); its threads
// form k = RNA_CL_THREADS / m32 parts of m32 consecutive local lanes each,
// and part p takes the terms p, p + k, p + 2k, ... of its lane, so a warp
// loads neighbouring lanes at one term.  Local lane `ll` is live when
// ll < m; a thread with p >= k has no part.
struct RnaClPart {
  int m32, k, p, ll;
};

__device__ __forceinline__ RnaClPart rna_cl_part(int m, int tid) {
  RnaClPart q;
  q.m32 = (m + 31) & ~31;
  q.k = q.m32 ? RNA_CL_THREADS / q.m32 : 0;
  q.p = q.m32 ? tid / q.m32 : 0;
  q.ll = q.m32 ? tid - q.p * q.m32 : 0;
  return q;
}

// The parts of K12/K13 (turner_inside.cu, turner_outside.cu): as
// rna_cl_part, but on the threads that own no lane (tid >= L), so that the
// owners run their lane's 2-loop term meanwhile; an owner has no part.
// Every live lane gets at least one part while L <= RNA_CL_THREADS / 2
// (Turner's rings keep L <= 128).
__device__ __forceinline__ RnaClPart rna_cl_part_free(int m, int tid,
                                                      int L) {
  const int t = tid - L;
  RnaClPart q;
  q.m32 = (m + 31) & ~31;
  q.k = q.m32 ? (RNA_CL_THREADS - L) / q.m32 : 0;
  q.p = t >= 0 && q.m32 ? t / q.m32 : q.k;
  q.ll = t >= 0 && q.m32 ? t - q.p * q.m32 : 0;
  return q;
}

// Stage the cells `row` of the `count` tables T into dst[k * stride]
// with cp.async (the caller commits the group): a lane's owner stages its
// next span's cells and reads them a span later, its own copies only,
// after __pipeline_wait_prior(0), so the tables' HBM latency leaves the
// span's critical path.
__device__ __forceinline__ void rna_cl_stage(float* dst, int stride,
                                             const float* const* T,
                                             int count, long long row) {
  for (int k = 0; k < count; ++k)
    __pipeline_memcpy_async(dst + k * stride, T[k] + row, sizeof(float));
}

// K8's close of span d (rna_inside_close with the s2 term s2(d-2, i+1)
// passed in, read from the block's own rows).
__device__ __forceinline__ float rna_cl_inside_close(
    float h_two, float s2_prev, const float* __restrict__ MBC,
    const float* __restrict__ ACC, const RnaScalars& s, long long row, int d,
    RnaInsideLane& st, float* close, float* rm_hist, float* rmm_hist) {
  const float mb_term = d >= 2 ? s2_prev * MBC[row] : 0.0f;
  float c = h_two + mb_term;
  if (d + 1 < RNA_MIN_SPAN_HAIRPIN_CLOSE) c = 0.0f;
  close[row] = c;
  const float acc = c * ACC[row];
  st.rm = st.rm * s.eu1 + acc * s.ebp;
  st.rmmb = st.rmmb * s.mbu1 + acc * s.mbbp;
  st.epow = st.epow * s.eu1;
  rm_hist[row] = st.rm;
  rmm_hist[row] = st.rmmb;
  return c;
}

// One part of live lane i's span-d bifurcation sums: the terms
// t = t0, t0 + k, ... < d of
//   es += rm(d-t, i+t) * ext(t-1, i),   s2 += one(t-1, i) * rmmb(d-t, i+t)
// (spans < d only), RNA_CL_BATCH_INSIDE terms' loads issued before their
// FMAs, the terms left after the whole batches one at a time.
__device__ __forceinline__ void rna_cl_bifurcation_part(
    long long base, int d, int i, int N, int t0, int k, const float* ext,
    const float* one, const float* rm_hist, const float* rmm_hist, float& es,
    float& s2) {
  const long long diag = base + (long long)d * N + i;   // term t: - t (N - 1)
  const long long col = base - N + i;                    // term t: + t N
  int t = t0;
  for (; t + (RNA_CL_BATCH_INSIDE - 1) * k < d;
       t += RNA_CL_BATCH_INSIDE * k) {
    float rv[RNA_CL_BATCH_INSIDE], mv[RNA_CL_BATCH_INSIDE],
        ev[RNA_CL_BATCH_INSIDE], ov[RNA_CL_BATCH_INSIDE];
#pragma unroll
    for (int u = 0; u < RNA_CL_BATCH_INSIDE; ++u) {
      const long long tt = t + u * k;
      rv[u] = __ldcg(rm_hist + diag - tt * (N - 1));
      mv[u] = __ldcg(rmm_hist + diag - tt * (N - 1));
      ev[u] = __ldcg(ext + col + tt * N);
      ov[u] = __ldcg(one + col + tt * N);
    }
#pragma unroll
    for (int u = 0; u < RNA_CL_BATCH_INSIDE; ++u) {
      es = fmaf(rv[u], ev[u], es);
      s2 = fmaf(ov[u], mv[u], s2);
    }
  }
  for (; t < d; t += k) {
    const long long tt = t;
    es = fmaf(__ldcg(rm_hist + diag - tt * (N - 1)),
              __ldcg(ext + col + tt * N), es);
    s2 = fmaf(__ldcg(one + col + tt * N),
              __ldcg(rmm_hist + diag - tt * (N - 1)), s2);
  }
}

// One part of live lane i's span-d multibranch sums (K9), terms
// u = u0, u0 + k, ...:
//   pm  += g(d+2+u, i) * one(u, i+d+1),     u < n - 2 - d - i
//   sa  += pm2(d+1+u, i-1-u) * QONE(u+1, i)  \  u < min(i, n - 1 - d)
//   sbc += pm(d+1+u, i-1-u) * QONE(u+1, i)   /
// pm's terms stop where g's cell dies (past it g is 0, and one's cell is
// not read); the others reach live cells only.  Both sums walk u together,
// RNA_CL_BATCH terms of each a batch, so a part waits out
// max(terms) / RNA_CL_BATCH latencies, not their sum: whole batches of
// both while both last, then batches whose terms past their sum's end
// load nothing and add fma(0, 0) = +0.
__device__ __forceinline__ void rna_cl_outside_part(
    long long base, int d, int i, int n, int N, int u0, int k,
    const float* __restrict__ ONE, const float* __restrict__ QONE,
    const float* g_hist, const float* pm_hist, const float* pm2_hist,
    float& pm, float& sa, float& sbc) {
  const long long gcol = base + (long long)(d + 2) * N + i;   // + u N
  const long long orow = base + i + d + 1;                     // + u N
  const long long src0 = base + (long long)(d + 1) * N + i - 1;  // + u (N-1)
  const long long qcol = base + N + i;                            // + u N
  const int tn = n - 2 - d - i, tq = min(i, n - 1 - d);
  float gv[RNA_CL_BATCH], ov[RNA_CL_BATCH], av[RNA_CL_BATCH],
      bv[RNA_CL_BATCH], qv[RNA_CL_BATCH];
  int u = u0;
  for (; u + (RNA_CL_BATCH - 1) * k < min(tn, tq); u += RNA_CL_BATCH * k) {
#pragma unroll
    for (int v = 0; v < RNA_CL_BATCH; ++v) {
      const long long uu = u + v * k;
      gv[v] = __ldcg(g_hist + gcol + uu * N);
      ov[v] = ONE[orow + uu * N];
      av[v] = __ldcg(pm2_hist + src0 + uu * (N - 1));
      bv[v] = __ldcg(pm_hist + src0 + uu * (N - 1));
      qv[v] = QONE[qcol + uu * N];
    }
#pragma unroll
    for (int v = 0; v < RNA_CL_BATCH; ++v) {
      pm = fmaf(gv[v], ov[v], pm);
      sa = fmaf(av[v], qv[v], sa);
      sbc = fmaf(bv[v], qv[v], sbc);
    }
  }
  for (; u < max(tn, tq); u += RNA_CL_BATCH * k) {
#pragma unroll
    for (int v = 0; v < RNA_CL_BATCH; ++v) {
      const long long uu = u + v * k;
      const bool okp = uu < tn, oks = uu < tq;
      gv[v] = okp ? __ldcg(g_hist + gcol + uu * N) : 0.0f;
      ov[v] = okp ? ONE[orow + uu * N] : 0.0f;
      av[v] = oks ? __ldcg(pm2_hist + src0 + uu * (N - 1)) : 0.0f;
      bv[v] = oks ? __ldcg(pm_hist + src0 + uu * (N - 1)) : 0.0f;
      qv[v] = oks ? QONE[qcol + uu * N] : 0.0f;
    }
#pragma unroll
    for (int v = 0; v < RNA_CL_BATCH; ++v) {
      pm = fmaf(gv[v], ov[v], pm);
      sa = fmaf(av[v], qv[v], sa);
      sbc = fmaf(bv[v], qv[v], sbc);
    }
  }
}

// K9's bppo of span d at a live lane from the pair, its 2-loop context
// `two` (already times CLOSE), the summed parts and qa's telescoped
// neighbour qa(d+1, i-1) (0 at lane 0):
//   bppo = base + two + CLOSE*ACCMB * (sa + sbc + qa),
//   pm2 = g(d+1, i) + mbu1 * pm2(d+1, i),  qa = pm(d+1, i-1) + mbu1 * qa_nb;
// g(d+1, i) is the lane's own g of the span before, `g_prev` (0 before its
// first live span, as past the end).  Writes bppo, g and the pm/pm2 rows
// and sets `qa`; returns g2 = bppo * G2 / CLOSE for the ring.
__device__ __forceinline__ float rna_cl_outside_bppo(
    const RnaOutsidePair& p, float two, bool span_ok, float mbu1,
    float& p2prev, float& g_prev, float pm, float sa, float sbc, float qa_nb,
    const float* __restrict__ ACCMB, const float* __restrict__ MBC,
    const float* __restrict__ G2, long long row, int i, int N, float* bppo,
    float* pm_hist, float* pm2_hist, float* g_hist, float& qa) {
  const float acc_mb = p.c * ACCMB[row];
  const float pm_new = span_ok ? pm : 0.0f;
  const float pm2_raw = g_prev + mbu1 * p2prev;
  p2prev = pm2_raw;
  const float pm2_new = span_ok ? pm2_raw : 0.0f;
  qa = 0.0f;
  if (i >= 1) {
    const float pm_nb = __ldcg(pm_hist + row + N - 1);   // pm(d+1, i-1)
    qa = pm_nb + mbu1 * qa_nb;
  }
  const float mb_ctx = acc_mb * (sa + sbc + qa);
  float bp = p.base + two + mb_ctx;
  if (!(p.pos && span_ok)) bp = 0.0f;
  bppo[row] = bp;
  const float g2 = bp * G2[row] * p.inv_close;
  g_prev = bp * MBC[row] * p.inv_close;
  g_hist[row] = g_prev;
  pm_hist[row] = pm_new;
  pm2_hist[row] = pm2_new;
  return g2;
}
