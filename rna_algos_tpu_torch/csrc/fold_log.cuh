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
// The inside kernels K16/K18 run one block per sequence, one thread per
// lane i, and build each tree on the fly with RnaTree: visiting leaf
// t = bitreverse(m) for m = 0, 1, ... and keeping one partial sum per
// level, like a binary counter, pairs the leaves exactly as the halving
// tree does.  The outside kernels K17/K19 run a group of G threads a lane
// and split each tree by residue (the split-tree helpers below): the same
// tree, its partial sums in registers, its top levels across the group.
//
// Every add and multiply is a round-to-nearest intrinsic, so nvcc contracts
// nothing: the kernels compute what their plain PyTorch versions compute.
#pragma once

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
// partial sums of a tree over at most RNA_LOG_MAX_N leaves
#define RNA_TREE_LEVELS 9
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

// Leaf index of step m of a tree over 2^lg leaves.
__device__ __forceinline__ int rna_leaf(int m, int lg) {
  return lg ? (int)(__brev((unsigned)m) >> (32 - lg)) : 0;
}

// One tree's partial sums.  push(m, x) adds leaf rna_leaf(m, lg) and
// returns the running carry, which after the last step (m = 2^lg - 1) is
// the tree's sum.
struct RnaTree {
  float s[RNA_TREE_LEVELS];

  __device__ __forceinline__ float push(int m, float x) {
#pragma unroll
    for (int l = 0; l < RNA_TREE_LEVELS; ++l) {
      if (!((m >> l) & 1)) {
        s[l] = x;
        break;
      }
      x = rna_lse_pair(s[l], x);
    }
    return x;
  }
};

// The inside pass's span-d bifurcation sums at lane i (JAX kernels' tail):
//   ext = lse(base, tree_t [t <= d-1] rm(d-t, i+t) + ext(t-1, i))
//   x_t = [1 <= t <= d-1] (CONTRA: rmmb(d-t, i+t); Turner: rm(...) + coeff)
//   s1  = lse(s1_head, tree_t (CONTRA: x_t + mbu * t; Turner: x_t))
//   s2  = tree_t one(t-1, i) + x_t
//   one = lse(s1, s2)
// ext(-1) is 0 and one(-1) is -inf; rows are [d, i], N floats from `base`.
// Writes ext and one at `row`; returns s2.
template <bool CONTRA>
__device__ __forceinline__ float rna_log_bifurcation(
    float ext_base, float s1_head, float w, long long base, long long row,
    int d, int i, int N, const float* rm_hist, const float* rmm_hist,
    float* ext, float* one) {
  const int lg = rna_log2_ceil(d);
  RnaTree te, t1, t2;
  float re = RNA_NEG, r1 = RNA_NEG, r2 = RNA_NEG;
  for (int m = 0; m < (1 << lg); ++m) {
    const int t = rna_leaf(m, lg);
    float e_leaf = RNA_NEG, x = RNA_NEG, one_t = RNA_NEG;
    if (t <= d - 1) {
      float fq = RNA_NEG, fqm = RNA_NEG;
      if (i + t < N) {
        const long long src = base + (long long)(d - t) * N + i + t;
        fq = rm_hist[src];
        fqm = CONTRA ? rmm_hist[src] : fq;
      }
      const float e = t == 0 ? 0.0f : ext[base + (long long)(t - 1) * N + i];
      e_leaf = radd(fq, e);
      if (t >= 1) {
        x = CONTRA ? fqm : radd(fq, w);
        one_t = one[base + (long long)(t - 1) * N + i];
      }
    }
    const float s1_leaf = CONTRA ? radd(x, rmul(w, (float)t)) : x;
    re = te.push(m, e_leaf);
    r1 = t1.push(m, s1_leaf);
    r2 = t2.push(m, radd(one_t, x));
  }
  ext[row] = rna_lse_pair(ext_base, re);
  one[row] = rna_lse_pair(rna_lse_pair(s1_head, r1), r2);
  return r2;
}

// The outside kernels' log-add: rna_lse_pair (cubic.cuh) with the
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
// Split trees (the outside kernels K17, K19): a lane's sums over a group of
// G threads (a power of two <= 32, inside one warp).
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

// Threads a lane at N: a block of RNA_LOG_THREADS (the most the card runs
// in one block) holds the sequence, at most a warp a lane.
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

// The 2-loop window of a live lane i (31 trees a = 0..30 over b, folded in
// order a = 0..30), the trees dealt whole to the group's threads in a snake
// (tree a to thread a % G on even rounds, G - 1 - a % G on odd ones, so the
// long trees of small a spread).  Trees a >= i read lanes left of 0 and
// leaves b >= n - 1 - d - i cells past the sequence's end: -inf, skipped.
// leaf(a, b) is the window leaf; the sum reaches every thread.
template <int G, typename Leaf>
__device__ __forceinline__ float rna_log_split_window(int i, int ri, int r,
                                                      unsigned mask,
                                                      Leaf leaf) {
  constexpr int NQ = (RNA_SHIFTS + G - 1) / G;
  const int A = ri > 0 ? (i < RNA_SHIFTS ? i : RNA_SHIFTS) : 0;
  float tsum[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) tsum[q] = RNA_NEG;
  for (int q = 0; q < NQ; ++q) {
    const int a = q * G + ((q & 1) ? G - 1 - r : r);
    if (a >= A) continue;
    const int live = RNA_SHIFTS - a;
    float s[1];
    rna_thread_tree<4, 1>(
        live < ri ? live : ri, [&](int bb, float (&v)[1]) { v[0] = leaf(a, bb); },
        s);
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

// The outside kernels' ring of window rows: span s at slot s % RNA_OWIN.
// Span d reads spans d + 2 .. d + 32 and writes its own slot, which held
// span d + 33: one barrier a span.
#define RNA_OWIN 33

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
