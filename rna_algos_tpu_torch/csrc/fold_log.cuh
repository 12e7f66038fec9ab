// What the log-space fold kernels share: K16/K17 (CONTRA) and K18/K19
// (Turner), the parity tier's McCaskill in the semiring (cubic lse_pair, +).
//
// One block per sequence, one thread per lane i (N <= 256, a power of two),
// the span loop inside the block.  The cubic log-add is commutative but not
// associative, so every sum follows the JAX kernels' order
// (ops/pallas_fold.py _lse_rows): a power-of-two halving tree, x[k] with
// x[k + h/2] level by level.  RnaTree builds that tree on the fly:
// visiting leaf t = bitreverse(m) for m = 0, 1, ... and keeping one partial
// sum per level, like a binary counter, pairs the leaves exactly as the
// halving tree does.  lse_pair(x, -inf) is x exactly, so leaves of -inf past
// the live rows are identities and the least power of two covering the live
// rows gives the bits of the JAX kernels' taller trees.
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

// The outside pass's multibranch context of pair (i, j = i + d), k spans
// after the first (k = n - 1 - d):
//   pm  = tree_s [s <= k-1] g(d+1+s, i) + ONEP(s, j+1)
//   pm2 = tree_s [s <= k-1] g(d+1+s, i) (+ mbu * s, CONTRA)
//   ctx = lse(tree_t [1 <= t <= k, t <= i] acc_mb + pm2(d+t, i-t) + QONE(t, i),
//             tree_t [...] acc_mb + pm(d+t, i-t) + QONEMB(t, i))
// pm and pm2 come back through the references (before the min_span mask).
template <bool CONTRA>
__device__ __forceinline__ float rna_log_mb_context(
    float acc_mb, float mbu, long long base, int d, int i, int k, int N,
    const float* __restrict__ ONEP, const float* __restrict__ QONE,
    const float* g_hist, const float* pm_hist, const float* pm2_hist,
    const float* qmb, float& pm, float& pm2) {
  const long long onep_row0 = base * 2 + i + d + 1;   // ONEP is (N, 2N)
  {
    const int lg = rna_log2_ceil(k);
    RnaTree ta, tb;
    pm = pm2 = RNA_NEG;
    for (int m = 0; m < (1 << lg); ++m) {
      const int s = rna_leaf(m, lg);
      float g = RNA_NEG;
      if (s <= k - 1) g = g_hist[base + (long long)(d + 1 + s) * N + i];
      pm = ta.push(m, radd(g, ONEP[onep_row0 + (long long)s * 2 * N]));
      pm2 = tb.push(m, CONTRA ? radd(g, rmul(mbu, (float)s)) : g);
    }
  }
  const int lg = rna_log2_ceil(k + 1);
  RnaTree ta, tb;
  float ra = RNA_NEG, rb = RNA_NEG;
  for (int m = 0; m < (1 << lg); ++m) {
    const int t = rna_leaf(m, lg);
    float va = RNA_NEG, vb = RNA_NEG;
    if (t >= 1 && t <= k && t <= i) {
      const long long src = base + (long long)(d + t) * N + i - t;
      const long long q = base + (long long)t * N + i;
      va = radd(radd(acc_mb, pm2_hist[src]), QONE[q]);
      vb = radd(radd(acc_mb, pm_hist[src]), qmb[q]);
    }
    ra = ta.push(m, va);
    rb = tb.push(m, vb);
  }
  return rna_lse_pair(ra, rb);
}

// QONEMB(t, i) = lse(QONE(t, i), mbu * (t - 1)) (CONTRA) or lse(QONE, 0)
// (Turner), lane i's column, into the scratch `qmb`: the span-invariant
// merge of the two multibranch contexts (JAX kernels' s_qone_mb).
template <bool CONTRA>
__device__ __forceinline__ void rna_log_qone_mb(
    const float* __restrict__ QONE, float mbu, long long base, int i, int N,
    float* qmb) {
  for (int t = 0; t < N; ++t) {
    const long long q = base + (long long)t * N + i;
    qmb[q] = rna_lse_pair(QONE[q], CONTRA ? rmul(mbu, (float)(t - 1)) : 0.0f);
  }
}

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
