// What the log-space fold kernels share: K16/K17 (CONTRA) and K18/K19
// (Turner), the parity tier's McCaskill in the semiring (cubic lse_pair, +).
//
// N <= 256, a power of two.  The cubic log-add is commutative but not
// associative, so every sum follows the JAX kernels' order
// (ops/pallas_fold.py _lse_rows): a power-of-two halving tree, x[k] with
// x[k + h/2] level by level.  lse_pair(x, -inf) is x exactly, so leaves of
// -inf past the live rows are identities and the least power of two
// covering the live rows gives the bits of the JAX kernels' taller trees.
//
// All four run one block of RNA_LOG_THREADS threads per sequence, a group
// of threads a lane, and split each tree by residue (the split-tree
// helpers below): the same tree, its partial sums in registers, its top
// levels across the group.  They share one skeleton (rna_log_spans): the
// spans in order (inside 0 .. n-1, outside n-1 .. 0), a span's table cells
// staged one span ahead with cp.async, live lanes only (i + d < n), one
// barrier a span (two inside).  The outside kernels give a lane
// G = 1024 / N threads (rna_log_lanes, one instantiation per G through
// rna_log_launch); the inside kernels give each span's live lanes as many
// threads as the block holds (rna_log_lanes_by_span), and first, in a pass
// of their own, each cell that can close its window (rna_log_window_pass).
//
// Every add and multiply is a round-to-nearest intrinsic, so nvcc contracts
// nothing: the kernels compute what their plain PyTorch versions compute.
#pragma once

#include <cuda_pipeline.h>

#include <type_traits>

#include "launch.cuh"
#include "cubic.cuh"

#define RNA_LOG_MAX_N 256
// The scalar row (ops/pallas_fold.py N_SCAL): the model's weights in 0..3,
// glob (the outside passes) in 4.
#define RNA_LOG_SCAL 8
#define RNA_LOG_GLOB 4
// 2-loop windows: shifts a = 0..30, loop lengths a + b <= 30; the length
// tables are (32, 31) [b][a]
#define RNA_SHIFTS 31
#define RNA_MAX_LOOP 30
#define RNA_LEN_SIZE (32 * RNA_SHIFTS)
#define RNA_NEG (-INFINITY)

__device__ __forceinline__ float radd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float rsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float rmul(float a, float b) {
  return __fmul_rn(a, b);
}

// The least k with 2^k >= max(m, 1).
__device__ __forceinline__ int rna_log2_ceil(int m) {
  int k = 0;
  while ((1 << k) < m) ++k;
  return k;
}

// The log kernels' log-add: rna_lse_pair (cubic.cuh) with the
// segment's coefficients read by index from a copy in shared memory, in
// place of the seven compare-and-select steps: the same coefficients and
// Horner steps, so the same bits, in fewer instructions.  A kernel that
// uses it calls rna_ln_coef_load() and a barrier first.
__shared__ float4 rna_ln_coef[8];

__device__ __forceinline__ void rna_ln_coef_load() {
  if (threadIdx.x < 8) {
    const float* c = kLnCoeffs[threadIdx.x];
    rna_ln_coef[threadIdx.x] = make_float4(c[0], c[1], c[2], c[3]);
  }
}

__device__ __forceinline__ float rna_lse_pair_s(float a, float b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  const float z = __fsub_rn(hi, lo);  // NaN or +inf when an operand is -inf
  if (z < RNA_LSE_THRESHOLD) {
    int k = 0;
#pragma unroll
    for (int j = 0; j < 7; ++j) k += z >= kLnBreaks[j];
    const float4 c = rna_ln_coef[k];
    const float h = __fadd_rn(__fmul_rn(c.x, z), c.y);
    return __fadd_rn(
        lo, __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(h, z), c.z), z), c.w));
  }
  return lo > -INFINITY ? __fadd_rn(lo, z) : hi;
}

// ---------------------------------------------------------------------------
// Split trees: a lane's sums over a group of G threads (a power of two
// <= 32, inside one warp).
//
// The halving tree over 2^h leaves splits by residue: its last level pairs
// the tree of the even leaves with the tree of the odd ones, the level
// before pairs residues mod 4, and so on.  So thread r of the group reduces
// the leaves t = r + G j by the halving tree over j, and the group's top
// log2 G levels pair thread r with r + G/2, then r + G/4, ...
// (rna_group_sum, __shfl_down_sync).  Inside a thread the split repeats
// (rna_thread_tree): the leaves j = c (mod S) form an 8-leaf halving tree
// in registers, and the S class sums another.  lse_pair(x, -inf) is x
// exactly, so a tree whose live leaves end at L reduces the least power of
// two covering L, and every level or class whose leaves all lie past L is
// skipped: the bits are those of the full tree.

#define RNA_LOG_THREADS 1024
static_assert(RNA_LOG_THREADS >= 4 * RNA_LOG_MAX_N,
              "rna_log_by_count gives each lane at least 4 threads");

// Threads a lane of the outside kernels at N, the fewest the inside kernels
// give one: a block of RNA_LOG_THREADS (the most the card runs in one block)
// holds the sequence, at most a warp a lane.
static inline int rna_log_group(int N) {
  const int g = RNA_LOG_THREADS / N;
  return g > 32 ? 32 : g;
}

// The lanes of thread `tid`'s group in its warp (for __shfl_*_sync).
template <int G>
__device__ __forceinline__ unsigned rna_group_mask(int tid) {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((tid & 31) & ~(G - 1));
  }
}

// x[0..H) -> the halving tree's sum, levels below `live` only (every
// x[k >= live] is -inf; `live` a power of two).
template <int H>
__device__ __forceinline__ float rna_halve(float (&x)[H], int live) {
#pragma unroll
  for (int h = H / 2; h >= 1; h >>= 1) {
    if (h < live) {
#pragma unroll
      for (int k = 0; k < h; ++k) x[k] = rna_lse_pair_s(x[k], x[k + h]);
    }
  }
  return x[0];
}

// K halving trees at once over leaf(j, v), j < J <= 8 * OUT: v[k] gets the
// k-th tree's leaf j.  Classes c < S of 8 leaves j = c + S q, then the S
// class sums.
template <int OUT, int K, typename Leaf>
__device__ __forceinline__ void rna_thread_tree(int J, Leaf leaf,
                                                float (&sum)[K]) {
  const int lg = rna_log2_ceil(J);
  const int S = lg > 3 ? 1 << (lg - 3) : 1;
  const int inner = lg > 3 ? 8 : 1 << lg;
  float outer[K][OUT];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < OUT; ++c) outer[k][c] = RNA_NEG;
  for (int c = 0; c < S; ++c) {
    float x[K][8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = c + S * q;
      float v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = RNA_NEG;
      if (j < J) leaf(j, v);
#pragma unroll
      for (int k = 0; k < K; ++k) x[k][q] = v[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float t = rna_halve<8>(x[k], inner);
#pragma unroll
      for (int cc = 0; cc < OUT; ++cc)
        if (cc == c) outer[k][cc] = t;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = rna_halve<OUT>(outer[k], S);
}

// The group's top levels: thread 0 gets the tree's sum.  `live` is the
// least power of two covering the group's live leaves (>= 1).
template <int G>
__device__ __forceinline__ float rna_group_sum(float v, unsigned mask,
                                               int live) {
#pragma unroll
  for (int off = G / 2; off >= 1; off >>= 1) {
    const float o = __shfl_down_sync(mask, v, off, G);
    if (off < live) v = rna_lse_pair_s(v, o);
  }
  return v;
}

// K halving trees over leaf(t, v), t < L, split over the group (thread r
// walks t = r + G j): the sums reach thread 0 of the group.
template <int G, int K, typename Leaf>
__device__ __forceinline__ void rna_split_tree(int L, int r, unsigned mask,
                                               Leaf leaf, float (&sum)[K]) {
  constexpr int OUT = RNA_LOG_MAX_N / G / 8 > 1 ? RNA_LOG_MAX_N / G / 8 : 1;
  const int J = L > r ? (L - r + G - 1) / G : 0;
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = RNA_NEG;
  if (J > 0)
    rna_thread_tree<OUT, K>(
        J, [&](int j, float (&v)[K]) { leaf(r + G * j, v); }, sum);
  const int live = 1 << rna_log2_ceil(L < G ? L : G);
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = rna_group_sum<G>(sum[k], mask, live);
}

// The outside pass's multibranch context of a live lane i at span d, split
// over the group (the sums of rna_log_mb_context, its dead leaves skipped):
//   pm, pm2 = trees over s < n - 1 - d - i (the g cells past the sequence's
//             end, s >= that, are -inf)
//   ctx     = lse(tree_t va, tree_t vb), t in [1, min(i, k)]
// g_t is g transposed ([i][d], a lane's spans contiguous), pp holds
// (pm2, pm) at [i + d][i] (a context's cells (d + t, i - t) contiguous),
// qmb QONEMB transposed.  pm and pm2 come back at thread 0 (before the
// min_span mask); the context only where `want_ctx`.
template <bool CONTRA, int G>
__device__ __forceinline__ float rna_log_split_context(
    float acc_mb, float mbu, long long base, int d, int i, int n, int N,
    int r, unsigned mask, bool want_ctx, const float* __restrict__ ONEP,
    const float* __restrict__ QONE, const float* g_t, const float2* pp,
    const float* qmb, float& pm, float& pm2) {
  const int k = n - 1 - d;
  {
    const float* gl = g_t + base + (long long)i * N + d + 1;
    const float* op = ONEP + base * 2 + i + d + 1;   // ONEP is (N, 2N)
    float s2[2];
    rna_split_tree<G, 2>(
        k - i, r, mask,
        [&](int s, float (&v)[2]) {
          const float g = gl[s];
          v[0] = radd(g, op[(long long)s * 2 * N]);
          v[1] = CONTRA ? radd(g, rmul(mbu, (float)s)) : g;
        },
        s2);
    pm = s2[0];
    pm2 = s2[1];
  }
  if (!want_ctx) return RNA_NEG;
  const float2* pl = pp + base + (long long)(i + d) * N + i;
  const float* ql = qmb + base + (long long)i * N;
  float ab[2];
  rna_split_tree<G, 2>(
      (i < k ? i : k) + 1, r, mask,
      [&](int t, float (&v)[2]) {
        if (t >= 1) {
          const float2 p = pl[-t];
          v[0] = radd(radd(acc_mb, p.x), QONE[base + (long long)t * N + i]);
          v[1] = radd(radd(acc_mb, p.y), ql[t]);
        }
      },
      ab);
  return rna_lse_pair_s(ab[0], ab[1]);
}

// The 2-loop window of a live lane (31 trees a = 0..30 over b, folded in
// order a = 0..30), the trees dealt whole to the group's threads in a snake
// (tree a to thread a % G on even rounds, G - 1 - a % G on odd ones, so the
// long trees of small a spread).  Only the trees a < A have live leaves,
// tree a its first live(a): past them every leaf reads a cell outside the
// sequence or before span 0, -inf, so they are skipped.  leaf(a, b) is the
// window leaf; the sum reaches every thread.
template <int G, typename Live, typename Leaf>
__device__ __forceinline__ float rna_log_split_window(int A, int r,
                                                      unsigned mask,
                                                      Live live, Leaf leaf) {
  constexpr int NQ = (RNA_SHIFTS + G - 1) / G;
  float tsum[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) tsum[q] = RNA_NEG;
  for (int q = 0; q < NQ; ++q) {
    const int a = q * G + ((q & 1) ? G - 1 - r : r);
    if (a >= A) continue;
    float s[1];
    rna_thread_tree<4, 1>(
        live(a), [&](int bb, float (&v)[1]) { v[0] = leaf(a, bb); }, s);
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq)
      if (qq == q) tsum[qq] = s[0];
  }
  float two = RNA_NEG;
  for (int a = 0; a < A; ++a) {
    const int q = a / G;
    const int owner = (q & 1) ? G - 1 - a % G : a % G;
    float mine = tsum[0];
#pragma unroll
    for (int qq = 1; qq < NQ; ++qq)
      if (qq == q) mine = tsum[qq];
    two = rna_lse_pair_s(two, __shfl_sync(mask, mine, owner, G));
  }
  return two;
}

// The outside pass's window limits at a live lane i with r = n - 1 - d - i
// cells to its pair's end: trees a < min(i, 31) (the outer pair's left end
// i - 1 - a >= 0), tree a over min(31 - a, r) leaves (its right end
// j + 1 + b < n).
__device__ __forceinline__ int rna_log_out_trees(int i, int ri) {
  return ri > 0 ? (i < RNA_SHIFTS ? i : RNA_SHIFTS) : 0;
}
__device__ __forceinline__ int rna_log_out_leaves(int a, int ri) {
  const int live = RNA_SHIFTS - a;
  return live < ri ? live : ri;
}

// The inside pass's window limits at span d: the inner pair's span
// d - 2 - a - b >= 0, so trees a <= min(30, d - 2), tree a over
// min(31 - a, d - 1 - a) leaves.
__device__ __forceinline__ int rna_log_in_trees(int d) {
  return d - 1 < RNA_SHIFTS ? d - 1 : RNA_SHIFTS;
}
__device__ __forceinline__ int rna_log_in_leaves(int a, int d) {
  return (d - 1 < RNA_SHIFTS ? d - 1 : RNA_SHIFTS) - a;
}

// The inside pass's span-d bifurcation sums of a live lane i, its three
// trees over t < d reduced together and split over the group
// (rna_split_tree<G, 3>), leaf t:
//   ext: rm(d-t, i+t) + ext(t-1, i)            (ext(-1) = 0)
//   x_t = [t >= 1] (CONTRA: rmmb(d-t, i+t); Turner: rm(d-t, i+t) + w)
//   s1:  CONTRA x_t + w t; Turner x_t
//   s2:  one(t-1, i) + x_t
// `rmp` holds rm (Turner) or (rm, rmmb) (CONTRA) by pair end, [i + d][i]
// (a lane's leaves (d-t, i+t) neighbouring words), `eo` (ext, one)
// transposed, [i][d]; leaf 0's rm is the lane's own of span d, passed in.
// The sums reach thread 0 of the group.
__device__ __forceinline__ float2 rna_rm_pair(const float2* p) { return *p; }
__device__ __forceinline__ float2 rna_rm_pair(const float* p) {
  const float v = *p;
  return make_float2(v, v);
}

template <bool CONTRA, int G, typename RmT>
__device__ __forceinline__ void rna_log_split_bifurcation(
    float rm, float w, long long base, int d, int i, int N, int r,
    unsigned mask, const RmT* rmp, const float2* eo, float (&sum)[3]) {
  const RmT* rl = rmp + base + (long long)(i + d) * N + i;
  const float2* el = eo + base + (long long)i * N - 1;
  rna_split_tree<G, 3>(
      d, r, mask,
      [&](int t, float (&v)[3]) {
        if (t == 0) {
          v[0] = radd(rm, 0.0f);
          return;
        }
        const float2 q = rna_rm_pair(rl + t);
        const float2 e = el[t];
        v[0] = radd(q.x, e.x);
        const float x = CONTRA ? q.y : radd(q.x, w);
        v[1] = CONTRA ? radd(x, rmul(w, (float)t)) : x;
        v[2] = radd(e.y, x);
      },
      sum);
}

// QONEMB(t, i) of the whole sequence, spread over the block, transposed
// into `qmb` ([i][t]).
template <bool CONTRA>
__device__ __forceinline__ void rna_log_qone_mb_t(
    const float* __restrict__ QONE, float mbu, long long base, int N,
    float* qmb) {
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) {
    const int t = e / N, l = e - t * N;
    qmb[base + (long long)l * N + t] = rna_lse_pair_s(
        QONE[base + e], CONTRA ? rmul(mbu, (float)(t - 1)) : 0.0f);
  }
}

// The ring of window rows: span s at slot s % RNA_OWIN.  Span d reads
// spans d + 2 .. d + 32 (outside) or d - 32 .. d - 2 (inside) and writes its
// own slot, which held span d +- 33, so no barrier parts the reads from the
// write.  The inside's s2 rows sit in a ring of RNA_S2_SLOTS likewise: span
// d reads s2(d - 2) and writes s2(d).
#define RNA_OWIN 33
#define RNA_S2_SLOTS 3

// Turner 2-loop window terms (K18, K19; ops/pallas_fold.py _turner_window).

// The small-loop cell (a, b): its index among the seven specials, or -1.
__device__ __forceinline__ int rna_turner_special(int a, int b) {
  if (a == 0) return b <= 1 ? b : -1;           // (0,0) (0,1)
  if (a == 1) return b <= 2 ? 2 + b : -1;       // (1,0) (1,1) (1,2)
  if (a == 2) return b == 1 ? 5 : b == 2 ? 6 : -1;   // (2,1) (2,2)
  return -1;
}

// The terminal-mismatch family of a non-bulge cell: 0, 1, 2 for TM1..3.
__device__ __forceinline__ int rna_turner_family(int a, int b) {
  if (a == 1 || b == 1) return 1;
  if ((a == 2 && b == 3) || (a == 3 && b == 2)) return 2;
  return 0;
}

// The Turner window leaf of cell (a, b): body + blk.  `sp` the seven
// specials, `tm` the pair's three terminal-mismatch scores, `w1..w3` the
// window cell's (ring values at the same slot and lane as `blk`).
__device__ __forceinline__ float rna_turner_leaf(
    int a, int b, const float* lenb, const float* leni, const float (&sp)[7],
    const float (&tm)[3], float aug, float blk, float w1, float w2,
    float w3) {
  const int s = rna_turner_special(a, b);
  float body;
  if (s >= 0) {
    body = s == 0 ? sp[0] : s == 1 ? sp[1] : s == 2 ? sp[2] : s == 3 ? sp[3]
         : s == 4 ? sp[4] : s == 5 ? sp[5] : sp[6];
  } else if (a == 0 || b == 0) {
    body = radd(lenb[b * RNA_SHIFTS + a], aug);
  } else {
    const int f = rna_turner_family(a, b);
    const float t = f == 0 ? tm[0] : f == 1 ? tm[1] : tm[2];
    const float w = f == 0 ? w1 : f == 1 ? w2 : w3;
    body = radd(radd(radd(leni[b * RNA_SHIFTS + a], t), w), aug);
  }
  return radd(body, blk);
}

static inline bool rna_log_shape_ok(int N) {
  return N >= 32 && N <= RNA_LOG_MAX_N && (N & (N - 1)) == 0;
}

// ---------------------------------------------------------------------------
// The skeleton of the four kernels.

// Stage span d's K cells a lane of lanes 0 .. n-1-d into `st` ([k][lane]):
// src(k, d, l) is cell k's address, or nullptr for a 0.
template <int K, typename Src>
__device__ __forceinline__ void rna_log_stage(float* st, int d, int n, int N,
                                              Src src) {
  const int nl = n - d;
  for (int e = threadIdx.x; e < K * nl; e += blockDim.x) {
    const int k = e / nl, l = e - k * nl;
    float* dst = st + k * N + l;
    const float* p = src(k, d, l);
    if (p) {
      __pipeline_memcpy_async(dst, p, sizeof(float));
    } else {
      *dst = 0.0f;
    }
  }
}

// No block-wide pass before a span's cells (the outside kernels).
struct RnaNoPass {};

// The span loop: spans d = 0 .. n-1 (INSIDE) or n-1 .. 0, span d's K cells
// a lane (src, as rna_log_stage) staged during the span before it into a
// double buffer `stage` (2 K N floats); pass(d) on every thread, followed
// by a barrier (unless Pass is RnaNoPass); then lanes(d, st) on every
// thread, `st` span d's staged cells (cell k of lane l at st[k * N + l]).
// One barrier a span (two with a pass): a span reads only what spans
// before it, and its pass, wrote.
template <bool INSIDE, int K, typename Src, typename Pass, typename Lanes>
__device__ __forceinline__ void rna_log_spans(float* stage, int n, int N,
                                              Src src, Pass pass,
                                              Lanes lanes) {
  if (n <= 0) return;
  const int first = INSIDE ? 0 : n - 1;
  rna_log_stage<K>(stage + (first & 1) * K * N, first, n, N, src);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    const int d = INSIDE ? s : n - 1 - s;
    if (s + 1 < n) {
      const int dn = INSIDE ? d + 1 : d - 1;
      rna_log_stage<K>(stage + (dn & 1) * K * N, dn, n, N, src);
    }
    __pipeline_commit();
    if constexpr (!std::is_same_v<Pass, RnaNoPass>) {
      pass(d);
      __syncthreads();
    }
    lanes(d, stage + (d & 1) * K * N);
    __pipeline_wait_prior(0);
    __syncthreads();
  }
}

// The lanes of a span with G threads each, lane tid / G: where lane i is
// live at span d (ri = n - 1 - d - i >= 0), cell(d, ri, st) with `st` its
// staged cells (cell k at st[k * N]).
template <int G, typename Cell>
__device__ __forceinline__ auto rna_log_lanes(int n, Cell cell) {
  return [=](int d, const float* st) {
    const int i = threadIdx.x / G;
    const int ri = n - 1 - d - i;
    if (ri >= 0) cell(d, ri, st + i);
  };
}

// fn(std::integral_constant<int, G>{}) with G the largest power of two
// <= 32 that gives each of `count` <= RNA_LOG_MAX_N items G threads of the
// block (4 at most items).
template <typename Fn>
__device__ __forceinline__ void rna_log_by_count(int count, Fn fn) {
  if (count <= RNA_LOG_THREADS / 32) {
    fn(std::integral_constant<int, 32>{});
  } else if (count <= RNA_LOG_THREADS / 16) {
    fn(std::integral_constant<int, 16>{});
  } else if (count <= RNA_LOG_THREADS / 8) {
    fn(std::integral_constant<int, 8>{});
  } else {
    fn(std::integral_constant<int, 4>{});
  }
}

// The live lanes of span d (i < n - d) with as many threads each as the
// block holds (rna_log_by_count over the n - d lanes): however few lanes
// are live, every thread works.  cell(gc, d, i, r, ri, st) on thread r of
// lane i's group, the group's size decltype(gc)::value.
template <typename Cell>
__device__ __forceinline__ auto rna_log_lanes_by_span(int n, Cell cell) {
  return [=](int d, const float* st) {
    rna_log_by_count(n - d, [&](auto gc) {
      constexpr int GC = decltype(gc)::value;
      const int i = threadIdx.x / GC;
      const int ri = n - 1 - d - i;
      if (ri >= 0) cell(gc, d, i, (int)threadIdx.x % GC, ri, st + i);
    });
  };
}

// The inside kernels' window pass: the span's K cells that can close (live,
// CANON finite, from span 5 on), listed by lane in `cells`, each get a group of
// the block's threads (rna_log_by_count); win(gw, i, r, mask) computes
// lane i's window on thread r of its group, of decltype(gw)::value threads.
// The window's shape depends on the span only, so the groups' work is
// equal, and the cells that cannot close cost nothing.
template <typename Win>
__device__ __forceinline__ void rna_log_window_pass(const int* cells, int K,
                                                    Win win) {
  rna_log_by_count(K, [&](auto gw) {
    constexpr int GW = decltype(gw)::value;
    const int tid = threadIdx.x;
    const int k = tid / GW;
    if (k < K) win(gw, cells[k], tid % GW, rna_group_mask<GW>(tid));
  });
}

// launch(std::integral_constant<int, G>{}) for N's group size G: one
// kernel instantiation per G, the launch's return value (a CUDA error).
template <typename Launch>
static int rna_log_launch(int N, Launch launch) {
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  switch (rna_log_group(N)) {
    case 4: return launch(std::integral_constant<int, 4>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
  }
  return (int)cudaErrorInvalidValue;
}
