// K2: CONTRAfold outside wavefront in scaled probability space -> bppo.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _outside8a2_kernel
// (:1054), _outside8a_kernel (:915) and _outside8_kernel (:787); the
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
// because Mosaic cannot slice lanes dynamically; here one(t-1, j+1) and
// ext(j+1, n-1) are indexed directly in the inside outputs.  The window
// loop, base, pm, pm2, qa and the multibranch context are the helpers of
// common.cuh that K5 (turner_outside.cu) shares.
//
// Bound and design as K1 (contra_inside.cu): the latency of n dependent
// spans; one block per sequence, one thread per lane, the g2 window as a
// 32-slot shared-memory ring (lanes offset by 32 so i-1-a never goes
// negative) contracted in FP32 against the per-sequence banded matrix,
// the pm/pm2/g histories in global memory.  Rows at or past n stay the
// zeros the wrapper passes.

#include "common.cuh"

__global__ void contra_outside_kernel(
    const float* __restrict__ CLOSE, const float* __restrict__ MBC,
    const float* __restrict__ ACCB, const float* __restrict__ ACCMB,
    const float* __restrict__ STKO, const float* __restrict__ I11O,
    const float* __restrict__ B0RO, const float* __restrict__ JRB,
    const float* __restrict__ JSN, const float* __restrict__ ONE,
    const float* __restrict__ QONE, const float* __restrict__ EXTR,
    const float* __restrict__ B0LO, const float* __restrict__ KW,
    const float* __restrict__ scal, const int* __restrict__ ns,
    float* bppo, float* pm_hist, float* pm2_hist, float* g_hist, int N,
    int min_span) {
  extern __shared__ float smem[];
  const int LW = N + 32;                  // ring row: 32 pad lanes + N
  float* ring = smem;                     // RNA_WIN * LW
  float* kw = ring + RNA_WIN * LW;        // 32 * 32
  float* qab = kw + RNA_WIN * RNA_WIN;    // 2 * N, by span parity

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const long long base = (long long)b * N * N;

  for (int e = i; e < RNA_WIN * LW; e += N) ring[e] = 0.0f;
  for (int e = i; e < RNA_WIN * RNA_WIN; e += N)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  for (int e = i; e < 2 * N; e += N) qab[e] = 0.0f;
  const float mbu1 = scal[b * RNA_SCAL + 2];
  const int n = ns[b];
  const float b0lo = B0LO[(long long)b * N + i];
  __syncthreads();

  float p2prev = 0.0f;
  for (int d = n - 1; d >= 0; --d) {
    const long long row = base + (long long)d * N + i;
    const bool span_ok = d + 1 >= min_span;

    // phase A: everything but the ring insert (reads spans > d only)
    const RnaOutsidePair p =
        rna_outside_pair(CLOSE, ACCB, EXTR, row, b, i, d, N);
    const float win = rna_window_outside(ring, kw, 0, d, i, LW);
    const float jrb = JRB[row];
    float two = jrb * win;
    two = two + STKO[row] * ring[((d + 2) & (RNA_WIN - 1)) * LW + 31 + i];
    two = two + B0RO[row] * ring[((d + 3) & (RNA_WIN - 1)) * LW + 31 + i];
    two = two + jrb * b0lo * ring[((d + 3) & (RNA_WIN - 1)) * LW + 30 + i];
    two = two + I11O[row] * ring[((d + 4) & (RNA_WIN - 1)) * LW + 30 + i];
    const float g2 = rna_outside_bppo(
        p, two * p.c, span_ok, mbu1, p2prev, ACCMB, MBC, JSN, ONE, QONE,
        base, row, d, i, n, N, bppo, pm_hist, pm2_hist, g_hist, qab);
    __syncthreads();

    // phase B: insert g2 (its slot held span d + 32, read above)
    ring[(d & (RNA_WIN - 1)) * LW + 32 + i] = g2;
    __syncthreads();
  }
}

extern "C" int rna_contra_outside(
    const float* CLOSE, const float* MBC, const float* ACCB,
    const float* ACCMB, const float* STKO, const float* I11O,
    const float* B0RO, const float* JRB, const float* JSN, const float* ONE,
    const float* QONE, const float* EXTR, const float* B0LO, const float* KW,
    const float* scal, const int* ns, float* bppo, float* pm_hist,
    float* pm2_hist, float* g_hist, int B, int N, int min_span,
    void* stream) {
  if (N < 32 || N > 256 || N % 32) return (int)cudaErrorInvalidValue;
  const size_t shmem =
      sizeof(float) * (RNA_WIN * (N + 32) + RNA_WIN * RNA_WIN + 2 * N);
  contra_outside_kernel<<<B, N, shmem, (cudaStream_t)stream>>>(
      CLOSE, MBC, ACCB, ACCMB, STKO, I11O, B0RO, JRB, JSN, ONE, QONE, EXTR,
      B0LO, KW, scal, ns, bppo, pm_hist, pm2_hist, g_hist, N, min_span);
  return (int)cudaGetLastError();
}
