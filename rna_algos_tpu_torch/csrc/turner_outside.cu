// K5 and K13: Turner outside wavefront in scaled probability space ->
// bppo, at N = 32-1024 in steps of 32.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _turner_outside8m_kernel
// (:2537) and _turner_outside8_kernel (:2349) at N <= 256 (K5), and
// pallas_fold_prob.py _turner_outside_prob_kernel_chunked (:1985, called
// through _turner_prob_run_body_chunked, :2158) at N = 512 and 1024 (K13);
// the per-sequence maths is pallas_fold_prob.py:1578-1704
// (_turner_outside_prob_kernel).  The TPU's row chunks, SONEF delivery and
// live-height ladder do not carry over: one and ext are indexed directly
// in the inside outputs.  The recurrences are K2's (contra_outside.cu)
// with Turner's scalars; only the 2-loop context differs.  For pair
// (i, j = i + d), spans decreasing from n - 1, with the merged tables of
// pallas_fold_prob8._turner_merge_outside:
//
//   two = CLOSE * (TMI1C * winI(g2*TMO1) + AUGT * winB(g2)
//                  + TMI2C * win2(g2*TMO2)
//                  + TMI3C * (LENI'[3,2] * gt3(d+7, i-3)
//                             + LENI'[2,3] * gt3(d+7, i-4))
//                  + SP00*g2(d+2, i-1) + SP01*g2(d+3, i-1)
//                  + SP10*g2(d+3, i-2) + SP11*g2(d+4, i-2)
//                  + SP12*g2(d+5, i-2) + SP21*g2(d+5, i-3)
//                  + SP22*g2(d+6, i-3))
//   win_K(x) = sum_{a, r} K[a][r] * x(d+1+r, i-1-a)
//   g2 = bppo * AUGT / CLOSE (inserted after the span), gt3 = g2 * TMO3
//
// and base, pm, pm2, qa and the multibranch context K2's, through the same
// helpers of common.cuh.  The window matrices and their non-zero arms are
// K4's (turner_inside.cu).
//
// Bound and design as K2/K9: the latency of n dependent spans and each
// lane's serial O(n) multibranch sums; one block per sequence, one thread
// per lane (launch.cuh), the whole span loop in the block.  Three 32-slot
// rings (g2, g2*TMO1, g2*TMO2) and an 8-slot ring of g2*TMO3 (read only
// at age 6), lanes offset by 32 so i-1-a never goes negative, live in
// dynamic shared memory with the three 32 x 32 matrices where they fit
// (~134 KB at N = 256) and in the global scratch at N = 512 and 1024.  The pm/pm2/g
// histories stay in global memory; pm2 and qa are telescoped (flush-safe).
// Rows at or past n stay the zeros the wrapper passes.

#include "launch.cuh"

// pallas_fold_prob8.TURNER_OUTSIDE_TABLES order
enum {
  TO_CLOSE, TO_MBC, TO_ACCB, TO_ACCMB, TO_AUGT, TO_TMI1C, TO_TMI2C, TO_TMI3C,
  TO_SP00, TO_SP01, TO_SP10, TO_SP11, TO_SP12, TO_SP21, TO_SP22,
  TO_TMO1, TO_TMO2, TO_TMO3, TO_COUNT
};

struct TurnerOutsideTables {
  const float* t[TO_COUNT];
};

#define TURNER_RING_ROWS (3 * RNA_WIN + RNA_TM3_SLOTS)

#define TURNER_OUTSIDE_PARAMS                                               \
  TurnerOutsideTables tabs, const float *__restrict__ ONE,                  \
      const float *__restrict__ QONE, const float *__restrict__ EXTR,       \
      const float *__restrict__ KT, const float *__restrict__ scal,         \
      const int *__restrict__ ns, float *bppo, float *pm_hist,              \
      float *pm2_hist, float *g_hist, float *ring_g, int N, int min_span,   \
      int smem_ring
#define TURNER_OUTSIDE_ARGS                                                 \
  tabs, ONE, QONE, EXTR, KT, scal, ns, bppo, pm_hist, pm2_hist, g_hist,     \
      ring_g, N, min_span, smem_ring

template <bool WIDE>
__device__ __forceinline__ void turner_outside_body(TURNER_OUTSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 32;                       // ring row: 32 pad lanes + N
  const int b = blockIdx.x;
  // narrow: rings | kt | qab; wide: kt | qab [| rings]
  float* kt = WIDE ? smem                      // KI | KB | K2
                   : smem + TURNER_RING_ROWS * LW;
  float* qab = kt + 3 * RNA_WIN * RNA_WIN;     // 2 * N, by span parity
  float* ringB = WIDE ? rna_rings(qab + 2 * N, ring_g, b,
                                  (long long)TURNER_RING_ROWS * (N + 33),
                                  smem_ring)
                      : smem;                  // g2         (KB, specials)
  float* ringI = ringB + RNA_WIN * LW;         // g2 * TMO1  (KI)
  float* ring2 = ringI + RNA_WIN * LW;         // g2 * TMO2  (K2)
  float* ring3 = ring2 + RNA_WIN * LW;         // g2 * TMO3  (TM3 cells)
  const float* kI = kt;
  const float* kB = kt + RNA_WIN * RNA_WIN;
  const float* k2 = kt + 2 * RNA_WIN * RNA_WIN;

  const int i = threadIdx.x;
  const long long base = (long long)b * N * N;
  const float* const* T = tabs.t;

  for (int e = i; e < TURNER_RING_ROWS * LW; e += N) ringB[e] = 0.0f;
  for (int e = i; e < 3 * RNA_WIN * RNA_WIN; e += N)
    kt[e] = KT[(long long)b * 3 * RNA_WIN * RNA_WIN + e];
  for (int e = i; e < 2 * N; e += N) qab[e] = 0.0f;
  const float* sc = scal + b * RNA_TSCAL;
  const float mbu1 = sc[2];
  const float leni32 = sc[4], leni23 = sc[5];
  const int n = ns[b];
  __syncthreads();

#define RING(buf, span, lane) \
  (buf)[((span) & (RNA_WIN - 1)) * LW + 32 + (lane)]

  float p2prev = 0.0f;
  for (int d = n - 1; d >= 0; --d) {
    const long long row = base + (long long)d * N + i;
    const bool span_ok = d + 1 >= min_span;

    // phase A: everything but the ring inserts (reads spans > d only)
    const RnaOutsidePair p =
        rna_outside_pair(T[TO_CLOSE], T[TO_ACCB], EXTR, row, b, i, d, N);
    const float winI = rna_window_outside(ringI, kI, 2, d, i, LW);
    float winB = 0.0f;
    for (int r = 1; r < RNA_WIN; ++r)
      winB = fmaf(kB[r], RING(ringB, d + 1 + r, i - 1), winB);
    for (int a = 1; a < RNA_WIN - 1; ++a)
      winB = fmaf(kB[a * RNA_WIN + a + 1], RING(ringB, d + 2 + a, i - 1 - a),
                  winB);
    float win2 = 0.0f;
    for (int r = 2; r < RNA_WIN; ++r)
      win2 = fmaf(k2[RNA_WIN + r], RING(ring2, d + 1 + r, i - 2), win2);
    for (int a = 2; a < RNA_WIN - 2; ++a)
      win2 = fmaf(k2[a * RNA_WIN + a + 2], RING(ring2, d + 3 + a, i - 1 - a),
                  win2);
    const int s3 = ((d + 1 + RNA_TM3_AGE) & (RNA_TM3_SLOTS - 1)) * LW + 32;
    const float tm3 = leni32 * ring3[s3 + i - 3] + leni23 * ring3[s3 + i - 4];

    float two = T[TO_TMI1C][row] * winI;
    two = two + T[TO_AUGT][row] * winB;
    two = two + T[TO_TMI2C][row] * win2;
    two = two + T[TO_TMI3C][row] * tm3;
    two = two + T[TO_SP00][row] * RING(ringB, d + 2, i - 1);
    two = two + T[TO_SP01][row] * RING(ringB, d + 3, i - 1);
    two = two + T[TO_SP10][row] * RING(ringB, d + 3, i - 2);
    two = two + T[TO_SP11][row] * RING(ringB, d + 4, i - 2);
    two = two + T[TO_SP12][row] * RING(ringB, d + 5, i - 2);
    two = two + T[TO_SP21][row] * RING(ringB, d + 5, i - 3);
    two = two + T[TO_SP22][row] * RING(ringB, d + 6, i - 3);
    const float g2 = rna_outside_bppo(
        p, two * p.c, span_ok, mbu1, p2prev, T[TO_ACCMB], T[TO_MBC],
        T[TO_AUGT], ONE, QONE, base, row, d, i, n, N, bppo, pm_hist, pm2_hist,
        g_hist, qab);
    __syncthreads();

    // phase B: insert g2 and its products (the 32-slot rings' slot held
    // span d + 32, read above)
    RING(ringB, d, i) = g2;
    RING(ringI, d, i) = g2 * T[TO_TMO1][row];
    RING(ring2, d, i) = g2 * T[TO_TMO2][row];
    ring3[(d & (RNA_TM3_SLOTS - 1)) * LW + 32 + i] = g2 * T[TO_TMO3][row];
    __syncthreads();
  }
#undef RING
}

__global__ void turner_outside_kernel(TURNER_OUTSIDE_PARAMS) {
  turner_outside_body<false>(TURNER_OUTSIDE_ARGS);
}

__global__ void __launch_bounds__(RNA_MAX_THREADS)
    turner_outside_wide_kernel(TURNER_OUTSIDE_PARAMS) {
  turner_outside_body<true>(TURNER_OUTSIDE_ARGS);
}

extern "C" int rna_turner_outside(void** tables, const float* ONE,
                                  const float* QONE, const float* EXTR,
                                  const float* KT, const float* scal,
                                  const int* ns, float* bppo, float* pm_hist,
                                  float* pm2_hist, float* g_hist,
                                  float* ring_g, int B, int N, int min_span,
                                  void* stream) {
  // one lane per thread: Turner's tiers end at N = 1024
  if (!rna_shape_ok(N) || N > RNA_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  TurnerOutsideTables tabs;
  for (int k = 0; k < TO_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t fixed = sizeof(float) * (3 * RNA_WIN * RNA_WIN + 2 * N);
  const size_t ring = sizeof(float) * TURNER_RING_ROWS * (N + 32);
  int smem_ring = 1;
  if (N <= RNA_NARROW)
    return rna_launch(turner_outside_kernel, B, N, fixed + ring, stream,
                      TURNER_OUTSIDE_ARGS);
  const size_t shmem = rna_smem(fixed, ring, &smem_ring);
  return rna_launch(turner_outside_wide_kernel, B, N, shmem, stream,
                    TURNER_OUTSIDE_ARGS);
}
