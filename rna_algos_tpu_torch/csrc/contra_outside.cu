// K2 and K9: CONTRAfold outside wavefront in scaled probability space ->
// bppo, at N = 32-1024 in steps of 32 and at N = 2048.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _outside8a2_kernel
// (:1054), _outside8a_kernel (:915) and _outside8_kernel (:787) at
// N <= 256 (K2), and pallas_fold_prob.py
// _contra_outside_prob_kernel_chunked (:841, called through
// _outside_call_prob_chunked, :1065) at N = 512, 1024 and 2048 (K9); the
// per-sequence maths is pallas_fold_prob.py:431-582
// (_contra_outside_prob_kernel).  For pair (i, j = i + d), spans
// decreasing from n - 1, with the merged outside tables:
//
//   base  = CLOSE * ACCB * ext(j+1, n-1)             (ACCB holds extL/Z*ebp)
//   two   = CLOSE * (JRB * window + STKO*g2(d+2, i-1) + B0RO*g2(d+3, i-1)
//                    + JRB*b0lo*g2(d+3, i-2) + I11O*g2(d+4, i-2))
//   window = sum_{a+b<=30} K[a][a+b+1] * g2(d+2+a+b, i-1-a)
//   pm    = sum_{t>=1} g(d+1+t, i) * one(t-1, j+1)
//   pm2   = g(d+1, i) + mbu1 * pm2(d+1, i)           (telescoped)
//   qa    = pm(d+1, i-1) + mbu1 * qa(d+1, i-1)       (telescoped diagonally)
//   mb    = CLOSE*ACCMB * (sum_{t>=1} pm2(d+t, i-t) * QONE(t, i)
//                          + sum_{t>=1} pm(d+t, i-t) * QONE(t, i) + qa)
//   bppo  = base + two + mb    (0 unless CLOSE > 0 and span >= min_span)
//   g2 = bppo * JSN / CLOSE,  g = bppo * MBC / CLOSE (inv_close guard)
//
// The TPU pre-rotates ONEP and EXTR by 2N - n (pallas_fold.py:691-709)
// because Mosaic cannot slice lanes dynamically, and its chunked kernel
// adds row chunks, SONEF delivery and a live-height ladder because of
// VMEM; here one(t-1, j+1) and ext(j+1, n-1) are indexed directly in the
// inside outputs.  The window loop, base, pm, pm2, qa and the multibranch
// context are the helpers of common.cuh that K5/K13 (turner_outside.cu)
// share.
//
// Bound and design as K1/K8 (contra_inside.cu): the latency of n dependent
// spans and each lane's serial O(n) multibranch sums (pm over one column,
// sa/sbc over one anti-diagonal: five loads a term); one block per
// sequence, lanes strided (launch.cuh), the g2 window as a 32-slot ring
// (lanes offset by 32 so i-1-a never goes negative) in shared memory up to
// N = 1024 and in global memory at 2048, contracted in FP32 against the
// per-sequence banded matrix, the pm/pm2/g histories in global memory.
// Rows at or past n stay the zeros the wrapper passes.

#include "launch.cuh"

#define CONTRA_OUTSIDE_PARAMS                                               \
  const float *__restrict__ CLOSE, const float *__restrict__ MBC,           \
      const float *__restrict__ ACCB, const float *__restrict__ ACCMB,      \
      const float *__restrict__ STKO, const float *__restrict__ I11O,       \
      const float *__restrict__ B0RO, const float *__restrict__ JRB,        \
      const float *__restrict__ JSN, const float *__restrict__ ONE,         \
      const float *__restrict__ QONE, const float *__restrict__ EXTR,       \
      const float *__restrict__ B0LO, const float *__restrict__ KW,         \
      const float *__restrict__ scal, const int *__restrict__ ns,           \
      float *bppo, float *pm_hist, float *pm2_hist, float *g_hist,          \
      float *ring_g, int N, int min_span, int smem_ring
#define CONTRA_OUTSIDE_ARGS                                                 \
  CLOSE, MBC, ACCB, ACCMB, STKO, I11O, B0RO, JRB, JSN, ONE, QONE, EXTR,     \
      B0LO, KW, scal, ns, bppo, pm_hist, pm2_hist, g_hist, ring_g, N,       \
      min_span, smem_ring

template <int LPT, bool WIDE>
__device__ __forceinline__ void contra_outside_body(CONTRA_OUTSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 32;                  // ring row: 32 pad lanes + N
  const int b = blockIdx.x;
  // narrow: ring | kw | qab; wide: kw | qab [| ring]
  float* kw = WIDE ? smem : smem + RNA_WIN * LW;   // 32 * 32
  float* qab = kw + RNA_WIN * RNA_WIN;    // 2 * N, by span parity
  float* ring = WIDE ? rna_rings(qab + 2 * N, ring_g, b,
                                 (long long)RNA_WIN * (N + 33), smem_ring)
                     : smem;              // RNA_WIN * LW

  const int tid = threadIdx.x;
  const int T = WIDE ? blockDim.x : N;   // narrow: one thread per lane
  const long long base = (long long)b * N * N;

  for (int e = tid; e < RNA_WIN * LW; e += T) ring[e] = 0.0f;
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += T)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  for (int e = tid; e < 2 * N; e += T) qab[e] = 0.0f;
  const float mbu1 = scal[b * RNA_SCAL + 2];
  const int n = ns[b];
  float b0lo[LPT], p2prev[LPT], g2[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    b0lo[k] = B0LO[(long long)b * N + tid + k * T];
    p2prev[k] = 0.0f;
  }
  __syncthreads();

  for (int d = n - 1; d >= 0; --d) {
    const bool span_ok = d + 1 >= min_span;

    // phase A: everything but the ring insert (reads spans > d only)
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = tid + k * T;
      const long long row = base + (long long)d * N + i;
      const RnaOutsidePair p =
          rna_outside_pair(CLOSE, ACCB, EXTR, row, b, i, d, N);
      const float win = rna_window_outside(ring, kw, 0, d, i, LW);
      const float jrb = JRB[row];
      float two = jrb * win;
      two = two + STKO[row] * ring[((d + 2) & (RNA_WIN - 1)) * LW + 31 + i];
      two = two + B0RO[row] * ring[((d + 3) & (RNA_WIN - 1)) * LW + 31 + i];
      two = two +
            jrb * b0lo[k] * ring[((d + 3) & (RNA_WIN - 1)) * LW + 30 + i];
      two = two + I11O[row] * ring[((d + 4) & (RNA_WIN - 1)) * LW + 30 + i];
      g2[k] = rna_outside_bppo(p, two * p.c, span_ok, mbu1, p2prev[k], ACCMB,
                               MBC, JSN, ONE, QONE, base, row, d, i, n, N,
                               bppo, pm_hist, pm2_hist, g_hist, qab);
    }
    __syncthreads();

    // phase B: insert g2 (its slot held span d + 32, read above)
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      ring[(d & (RNA_WIN - 1)) * LW + 32 + tid + k * T] = g2[k];
    __syncthreads();
  }
}

__global__ void contra_outside_kernel(CONTRA_OUTSIDE_PARAMS) {
  contra_outside_body<1, false>(CONTRA_OUTSIDE_ARGS);
}

template <int LPT>
__global__ void __launch_bounds__(RNA_MAX_THREADS)
    contra_outside_wide_kernel(CONTRA_OUTSIDE_PARAMS) {
  contra_outside_body<LPT, true>(CONTRA_OUTSIDE_ARGS);
}

extern "C" int rna_contra_outside(
    const float* CLOSE, const float* MBC, const float* ACCB,
    const float* ACCMB, const float* STKO, const float* I11O,
    const float* B0RO, const float* JRB, const float* JSN, const float* ONE,
    const float* QONE, const float* EXTR, const float* B0LO, const float* KW,
    const float* scal, const int* ns, float* bppo, float* pm_hist,
    float* pm2_hist, float* g_hist, float* ring_g, int B, int N,
    int min_span, void* stream) {
  if (!rna_shape_ok(N)) return (int)cudaErrorInvalidValue;
  const size_t fixed = sizeof(float) * (RNA_WIN * RNA_WIN + 2 * N);
  const size_t ring = sizeof(float) * RNA_WIN * (N + 32);
  int smem_ring = 1;
  if (N <= RNA_NARROW)
    return rna_launch(contra_outside_kernel, B, N, fixed + ring, stream,
                      CONTRA_OUTSIDE_ARGS);
  const size_t shmem = rna_smem(fixed, ring, &smem_ring);
  if (N <= RNA_MAX_THREADS)
    return rna_launch(contra_outside_wide_kernel<1>, B, N, shmem, stream,
                      CONTRA_OUTSIDE_ARGS);
  return rna_launch(contra_outside_wide_kernel<RNA_MAX_LPT>, B,
                    RNA_MAX_THREADS, shmem, stream, CONTRA_OUTSIDE_ARGS);
}
