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
