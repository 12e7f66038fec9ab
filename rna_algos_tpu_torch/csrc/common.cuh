// Shared definitions of the rna_algos_tpu_torch kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

// CONTRAfold 2-loop window: loop lengths a, b in [0, 30], a + b <= 30,
// kept as the 32 x 32 banded matrix K[a][r] = LEN[r - a - 1][a]
// (pallas_fold_prob._banded_window_kernel), whose column r = a + b + 1
// is the window age of the inner pair.
#define RNA_WIN 32
// MIN_HAIRPIN_LEN + 2 (constants.MIN_SPAN_HAIRPIN_CLOSE)
#define RNA_MIN_SPAN_HAIRPIN_CLOSE 5
// The per-sequence scalar row (pallas_fold_prob._scal_rows):
// [eu1, ebp, mbu1, mbbp]
#define RNA_SCAL 4
// The Turner scalar row (pallas_fold_prob._turner_scal_rows):
// [eu1, ebp, mbu1, mbbp, LENI'[3,2], LENI'[2,3]]
#define RNA_TSCAL 6
// Turner 2x3 cells (a, b) = (2, 3), (3, 2): read at window age a + b + 1,
// from a ring of RNA_TM3_SLOTS (a power of two above that age)
#define RNA_TM3_AGE 6
#define RNA_TM3_SLOTS 8

// The recurrences CONTRA (K1, K2) and Turner (K4, K5) share; each model's
// kernel adds only its 2-loop term and ring inserts.  Histories are
// [d, i] rows of N floats from `base`, the lane's cell is `row`.

// The first four columns of either scalar row.
struct RnaScalars {
  float eu1, ebp, mbu1, mbbp;
};

__device__ __forceinline__ RnaScalars rna_scalars(const float* sc) {
  return {sc[0], sc[1], sc[2], sc[3]};
}

// Banded 2-loop window of the inside pass from `a0` on:
// sum_{a >= a0, a < r < 32} K[a][r] * ring(d-1-r, i+1+a), ring rows LW
// floats apart, slot = span & 31.
__device__ __forceinline__ float rna_window_inside(const float* ring,
                                                   const float* k, int a0,
                                                   int d, int i, int LW) {
  float win = 0.0f;
  for (int a = a0; a < RNA_WIN - 1; ++a) {
    const float* lane = ring + (i + 1 + a);
    const float* krow = k + a * RNA_WIN;
    for (int r = a + 1; r < RNA_WIN; ++r)
      win = fmaf(krow[r], lane[((d - 1 - r) & (RNA_WIN - 1)) * LW], win);
  }
  return win;
}

// The outside pass's mirror: ring(d+1+r, i-1-a), lanes offset by 32.
__device__ __forceinline__ float rna_window_outside(const float* ring,
                                                    const float* k, int a0,
                                                    int d, int i, int LW) {
  float win = 0.0f;
  for (int a = a0; a < RNA_WIN - 1; ++a) {
    const float* lane = ring + (32 + i - 1 - a);
    const float* krow = k + a * RNA_WIN;
    for (int r = a + 1; r < RNA_WIN; ++r)
      win = fmaf(krow[r], lane[((d + 1 + r) & (RNA_WIN - 1)) * LW], win);
  }
  return win;
}

// One inside lane's multibranch state across spans: rm(d, i), rmmb(d, i)
// and eu1^(d+1).
struct RnaInsideLane {
  float rm = 0.0f, rmmb = 0.0f, epow = 1.0f;
};

// Close of span d from `h_two` (hairpin + 2-loop) and MBC * s2(d-2, i+1),
// 0 below the shortest hairpin span; writes close and the rm/rmmb rows:
//   rm = rm(d-1, i) * eu1 + close*ACC*ebp    (rmmb with mbu1, mbbp).
// s2r holds s2 by span parity, rows N + 1 floats.
__device__ __forceinline__ float rna_inside_close(
    float h_two, const float* __restrict__ MBC,
    const float* __restrict__ ACC, const float* s2r, const RnaScalars& s,
    long long row, int d, int i, int N, RnaInsideLane& st, float* close,
    float* rm_hist, float* rmm_hist) {
  const float mb_term =
      d >= 2 ? s2r[(d & 1) * (N + 1) + i + 1] * MBC[row] : 0.0f;
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

// Span d's bifurcation sums over the rm/rmmb rows of spans <= d (after
// the barrier that makes them visible):
//   ext = eu1^(d+1) + sum_t rm(d-t, i+t) * ext(t-1, i)
//   s2  = sum_{t>=1} one(t-1, i) * rmmb(d-t, i+t)
//   s1  = mbu1 * (rmmb(d-1, i+1) + s1(d-1, i+1))   (telescoped, flush-safe)
//   one = rmmb + s1 + s2
__device__ __forceinline__ void rna_inside_bifurcation(
    const RnaInsideLane& st, float mbu1, long long base, long long row, int d,
    int i, int N, float* ext, float* one, const float* rm_hist,
    const float* rmm_hist, float* s1r, float* s2r) {
  const int tmax = min(d - 1, N - 1 - i);
  float es = 0.0f, s2 = 0.0f;
  for (int t = 0; t <= tmax; ++t) {
    const long long src = base + (long long)(d - t) * N + i + t;
    const float e = t == 0 ? 1.0f : ext[base + (long long)(t - 1) * N + i];
    es = fmaf(rm_hist[src], e, es);
    if (t >= 1)
      s2 = fmaf(one[base + (long long)(t - 1) * N + i], rmm_hist[src], s2);
  }
  const float ext_new = st.epow + es;
  const float rmm_nb = (d >= 1 && i + 1 < N) ? rmm_hist[row - N + 1] : 0.0f;
  const float s1v = mbu1 * (rmm_nb + s1r[((d - 1) & 1) * (N + 1) + i + 1]);
  s1r[(d & 1) * (N + 1) + i] = s1v;
  s2r[(d & 1) * (N + 1) + i] = s2;
  ext[row] = ext_new;
  one[row] = st.rmmb + s1v + s2;
}

// The smallest normal float: a subnormal CLOSE counts as no pair (XLA
// flushes subnormals to zero, and 1/CLOSE would overflow).
#define RNA_FLT_MIN 1.17549435e-38f

// The outside pass's pair (i, j = i + d): CLOSE, 1/CLOSE (0 unless CLOSE
// is a positive normal float) and the exterior context
// CLOSE * ACCB * ext(j+1, n-1).
struct RnaOutsidePair {
  float c, inv_close, base;
  bool pos;
};

__device__ __forceinline__ RnaOutsidePair rna_outside_pair(
    const float* __restrict__ CLOSE, const float* __restrict__ ACCB,
    const float* __restrict__ EXTR, long long row, int b, int i, int d,
    int N) {
  RnaOutsidePair p;
  p.c = CLOSE[row];
  p.pos = p.c >= RNA_FLT_MIN;
  p.inv_close = p.pos ? 1.0f / p.c : 0.0f;
  const float rt = EXTR[(long long)b * 2 * N + i + d + 1];
  p.base = p.c * ACCB[row] * rt;
  return p;
}

// The outside sums below issue RNA_LOAD_BATCH terms' loads before their
// FMAs; the sums keep their sequential order, so the result is bitwise
// that of the plain loops.  K2's time is sensitive to how ptxas schedules
// these loops: on the H100 the plain loops written as a helper ran K2
// 1.6-1.9x slower than the same loops written inline (the same SASS
// instruction mix), and batches of 8 or 16 were slow there too; batches
// of 4 run K2 at the inline loops' time and K5 2-4% faster.
#define RNA_LOAD_BATCH 4

// bppo of span d from the pair, its 2-loop context `two` (already times
// CLOSE) and the multibranch context
//   CLOSE*ACCMB * (sum_{t>=1} (pm2 + pm)(d+t, i-t) * QONE(t, i) + qa)
//   pm  = sum_{t>=1} g(d+1+t, i) * one(t-1, j+1)
//   pm2 = g(d+1, i) + mbu1 * pm2(d+1, i)          (telescoped in p2prev)
//   qa  = pm(d+1, i-1) + mbu1 * qa(d+1, i-1)      (telescoped in qab, by
//                                                   span parity, rows N)
// bppo is 0 unless CLOSE > 0 and the span reaches min_span.  Writes bppo,
// g = bppo * MBC / CLOSE and the pm/pm2 rows; returns the window row
// g2 = bppo * G2 / CLOSE that the kernel inserts into its ring.
__device__ __forceinline__ float rna_outside_bppo(
    const RnaOutsidePair& p, float two, bool span_ok, float mbu1,
    float& p2prev, const float* __restrict__ ACCMB,
    const float* __restrict__ MBC, const float* __restrict__ G2,
    const float* __restrict__ ONE,
    const float* __restrict__ QONE, long long base, long long row, int d,
    int i, int n, int N, float* bppo, float* pm_hist, float* pm2_hist,
    float* g_hist, float* qab) {
  const float acc_mb = p.c * ACCMB[row];
  float pm = 0.0f;
  if (i + d + 1 < N) {
    // term t + 1: g(d+2+t, i) * one(t, j+1), t < n-2-d
    const float* gp = g_hist + base + (long long)(d + 2) * N + i;
    const float* op = ONE + base + i + d + 1;
    const int tn = n - 2 - d;
    int t = 0;
    for (; t + RNA_LOAD_BATCH <= tn; t += RNA_LOAD_BATCH) {
      float gv[RNA_LOAD_BATCH], ov[RNA_LOAD_BATCH];
#pragma unroll
      for (int u = 0; u < RNA_LOAD_BATCH; ++u) {
        gv[u] = gp[(long long)(t + u) * N];
        ov[u] = op[(long long)(t + u) * N];
      }
#pragma unroll
      for (int u = 0; u < RNA_LOAD_BATCH; ++u) pm = fmaf(gv[u], ov[u], pm);
    }
    for (; t < tn; ++t)
      pm = fmaf(gp[(long long)t * N], op[(long long)t * N], pm);
  }
  const float pm_new = span_ok ? pm : 0.0f;
  const float g1 = d + 1 <= n - 1 ? g_hist[row + N] : 0.0f;
  const float pm2_raw = g1 + mbu1 * p2prev;
  p2prev = pm2_raw;
  const float pm2_new = span_ok ? pm2_raw : 0.0f;

  float qa = 0.0f;
  if (i >= 1) {
    const float pm_nb = d + 1 <= n - 1 ? pm_hist[row + N - 1] : 0.0f;
    qa = pm_nb + mbu1 * qab[((d + 1) & 1) * N + i - 1];
  }
  // term t + 1: (pm2, pm)(d+1+t, i-1-t) * QONE(t+1, i), t < min(i, n-1-d)
  float sa = 0.0f, sbc = 0.0f;
  const long long src0 = base + (long long)(d + 1) * N + i - 1;
  const float* qp = QONE + base + N + i;
  const int tq = min(i, n - 1 - d);
  int t = 0;
  for (; t + RNA_LOAD_BATCH <= tq; t += RNA_LOAD_BATCH) {
    float av[RNA_LOAD_BATCH], bv[RNA_LOAD_BATCH], qv[RNA_LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < RNA_LOAD_BATCH; ++u) {
      const long long src = src0 + (long long)(t + u) * (N - 1);
      av[u] = pm2_hist[src];
      bv[u] = pm_hist[src];
      qv[u] = qp[(long long)(t + u) * N];
    }
#pragma unroll
    for (int u = 0; u < RNA_LOAD_BATCH; ++u) {
      sa = fmaf(av[u], qv[u], sa);
      sbc = fmaf(bv[u], qv[u], sbc);
    }
  }
  for (; t < tq; ++t) {
    const long long src = src0 + (long long)t * (N - 1);
    const float q = qp[(long long)t * N];
    sa = fmaf(pm2_hist[src], q, sa);
    sbc = fmaf(pm_hist[src], q, sbc);
  }
  const float mb_ctx = acc_mb * (sa + sbc + qa);
  float bp = p.base + two + mb_ctx;
  if (!(p.pos && span_ok)) bp = 0.0f;
  bppo[row] = bp;
  const float g2 = bp * G2[row] * p.inv_close;
  g_hist[row] = bp * MBC[row] * p.inv_close;
  pm_hist[row] = pm_new;
  pm2_hist[row] = pm2_new;
  qab[(d & 1) * N + i] = qa;
  return g2;
}
