// K4 and K12: Turner inside wavefront in scaled probability space, at
// N = 32-1024 in steps of 32.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _turner_inside8m_kernel
// (:2016) and _turner_inside8_kernel (:1821) at N <= 256 (K4), and
// pallas_fold_prob.py _turner_inside_prob_kernel_chunked (:1832, called
// through _turner_prob_run_body_chunked, :2158) at N = 512 and 1024 (K12);
// the per-sequence maths is pallas_fold_prob.py:1431-1538
// (_turner_inside_prob_kernel).  The TPU's R-row chunks and resident
// scratches do not carry over: the tables and histories are read in global
// memory at every N.  The recurrences are K1's (contra_inside.cu), through
// the same helpers of common.cuh, with eu1 = mbu1 = 1/sigma, ebp = 1 and
// mbbp = exp(COEFF_NUM_BRANCHES); only the 2-loop term and ring inserts
// differ.  Inputs are the merged [d, i] tables of
// pallas_fold_prob8._turner_merge_inside (CANON and the outer terminal
// mismatch * AU/GU products folded in), so for pair (i, j = i + d):
//
//   close = H + two + MBC * s2(d-2, i+1)
//   two   = TMO1C * winI(g*TMI1) + AUGC * winB(g) + TMO2C * win2(g*TMI2)
//         + TMO3C * (LENI'[3,2] * gt3(d-7, i+3) + LENI'[2,3] * gt3(d-7, i+4))
//         + SP00*g(d-2, i+1) + SP01*g(d-3, i+1) + SP10*g(d-3, i+2)
//         + SP11*g(d-4, i+2) + SP12*g(d-5, i+2) + SP21*g(d-5, i+3)
//         + SP22*g(d-6, i+3)
//   win_K(x) = sum_{a, r} K[a][r] * x(d-1-r, i+1+a)
//   g = close * AUGT (inserted after the span), gt3 = g * TMI3
//
// with K in {KI, KB, K2} the per-sequence banded window matrices of
// pallas_fold_prob._turner_banded_kernels; each carries its cells' sigma
// powers (the TPU's aging pass is unnecessary).  KB and K2 are non-zero
// only on one column and one diagonal (bulges: a = 0 or b = 0; 1xn
// arms: a = 1 or b = 1), KI only for a >= 2, so the loops visit those
// cells alone; the plain version contracts the full matrices.
//
// Bound and design as K1/K8: the latency of n dependent spans with a
// __syncthreads each and the lanes' serial O(d) bifurcation sums, not
// FLOPs or bytes.  One block per sequence, one thread per lane i
// (launch.cuh), the whole span loop in the block.  Three 32-slot rings (g,
// g*TMI1, g*TMI2; slot = span & 31) and an 8-slot ring of g*TMI3 (read
// only at age 6) take 104 x (N + 33) floats: in dynamic shared memory with
// the three 32 x 32 matrices where they fit (~137 KB at N = 256, so the
// launch raises the kernel's dynamic shared-memory limit), in the global
// scratch at N = 512 and 1024 (227 KB of rings alone at 512).  The rm/rmmb histories and
// the ext/one tables stay in global memory.  The S1 recurrence is
// telescoped (flush-safe: Turner's mbu = 0 makes a standalone mbu1^t
// column underflow).  Rows at or past n are never written: the wrapper
// passes zeroed outputs.

#include "launch.cuh"

// pallas_fold_prob8.TURNER_INSIDE_TABLES order
enum {
  TI_H, TI_MBC, TI_ACC, TI_AUGC, TI_TMO1C, TI_TMO2C, TI_TMO3C,
  TI_SP00, TI_SP01, TI_SP10, TI_SP11, TI_SP12, TI_SP21, TI_SP22,
  TI_AUGT, TI_TMI1, TI_TMI2, TI_TMI3, TI_COUNT
};

struct TurnerInsideTables {
  const float* t[TI_COUNT];
};

#define TURNER_RING_ROWS (3 * RNA_WIN + RNA_TM3_SLOTS)

#define TURNER_INSIDE_PARAMS                                                \
  TurnerInsideTables tabs, const float *__restrict__ KT,                    \
      const float *__restrict__ scal, const int *__restrict__ ns,           \
      float *close, float *ext, float *one, float *rm_hist,                 \
      float *rmm_hist, float *ring_g, int N, int smem_ring
#define TURNER_INSIDE_ARGS                                                  \
  tabs, KT, scal, ns, close, ext, one, rm_hist, rmm_hist, ring_g, N,        \
      smem_ring

template <bool WIDE>
__device__ __forceinline__ void turner_inside_body(TURNER_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 33;                       // ring row: N lanes + pad
  const int b = blockIdx.x;
  // narrow: rings | kt | s2r | s1r; wide: kt | s2r | s1r [| rings]
  float* kt = WIDE ? smem                      // KI | KB | K2, 32 x 32 each
                   : smem + TURNER_RING_ROWS * LW;
  float* s2r = kt + 3 * RNA_WIN * RNA_WIN;     // 2 * (N + 1), span parity
  float* s1r = s2r + 2 * (N + 1);              // 2 * (N + 1), span parity
  float* ringB = WIDE ? rna_rings(s1r + 2 * (N + 1), ring_g, b,
                                  (long long)TURNER_RING_ROWS * LW, smem_ring)
                      : smem;                  // g          (KB, specials)
  float* ringI = ringB + RNA_WIN * LW;         // g * TMI1   (KI)
  float* ring2 = ringI + RNA_WIN * LW;         // g * TMI2   (K2)
  float* ring3 = ring2 + RNA_WIN * LW;         // g * TMI3   (TM3 cells)
  const float* kI = kt;
  const float* kB = kt + RNA_WIN * RNA_WIN;
  const float* k2 = kt + 2 * RNA_WIN * RNA_WIN;

  const int i = threadIdx.x;
  const long long base = (long long)b * N * N;
  const float* const* T = tabs.t;

  for (int e = i; e < TURNER_RING_ROWS * LW; e += N) ringB[e] = 0.0f;
  for (int e = i; e < 3 * RNA_WIN * RNA_WIN; e += N)
    kt[e] = KT[(long long)b * 3 * RNA_WIN * RNA_WIN + e];
  for (int e = i; e < 2 * (N + 1); e += N) {
    s2r[e] = 0.0f;
    s1r[e] = 0.0f;
  }
  const float* sc = scal + b * RNA_TSCAL;
  const RnaScalars s = rna_scalars(sc);
  const float leni32 = sc[4], leni23 = sc[5];
  const int n = ns[b];
  __syncthreads();

#define RING(buf, span, lane) \
  (buf)[((span) & (RNA_WIN - 1)) * LW + (lane)]

  RnaInsideLane st;
  for (int d = 0; d < n; ++d) {
    const long long row = base + (long long)d * N + i;

    // phase A: close from the rings (spans < d) and the s2 ring
    // generic interior: KI[a][r] for a >= 2
    const float winI = rna_window_inside(ringI, kI, 2, d, i, LW);
    // bulges: column a = 0 and diagonal r = a + 1 (b = 0), a >= 1
    float winB = 0.0f;
    for (int r = 1; r < RNA_WIN; ++r)
      winB = fmaf(kB[r], RING(ringB, d - 1 - r, i + 1), winB);
    for (int a = 1; a < RNA_WIN - 1; ++a)
      winB = fmaf(kB[a * RNA_WIN + a + 1], RING(ringB, d - 2 - a, i + 1 + a),
                  winB);
    // 1xn / 2x3-edge arms: column a = 1 and diagonal r = a + 2 (b = 1),
    // a >= 2 (the a = 0 diagonal cell is the 0x1 bulge, zero in K2)
    float win2 = 0.0f;
    for (int r = 2; r < RNA_WIN; ++r)
      win2 = fmaf(k2[RNA_WIN + r], RING(ring2, d - 1 - r, i + 2), win2);
    for (int a = 2; a < RNA_WIN - 2; ++a)
      win2 = fmaf(k2[a * RNA_WIN + a + 2], RING(ring2, d - 3 - a, i + 1 + a),
                  win2);
    const int s3 = ((d - 1 - RNA_TM3_AGE) & (RNA_TM3_SLOTS - 1)) * LW;
    const float tm3 = leni32 * ring3[s3 + i + 3] + leni23 * ring3[s3 + i + 4];

    float two = T[TI_TMO1C][row] * winI;
    two = two + T[TI_AUGC][row] * winB;
    two = two + T[TI_TMO2C][row] * win2;
    two = two + T[TI_TMO3C][row] * tm3;
    two = two + T[TI_SP00][row] * RING(ringB, d - 2, i + 1);
    two = two + T[TI_SP01][row] * RING(ringB, d - 3, i + 1);
    two = two + T[TI_SP10][row] * RING(ringB, d - 3, i + 2);
    two = two + T[TI_SP11][row] * RING(ringB, d - 4, i + 2);
    two = two + T[TI_SP12][row] * RING(ringB, d - 5, i + 2);
    two = two + T[TI_SP21][row] * RING(ringB, d - 5, i + 3);
    two = two + T[TI_SP22][row] * RING(ringB, d - 6, i + 3);
    const float c =
        rna_inside_close(T[TI_H][row] + two, T[TI_MBC], T[TI_ACC], s2r, s,
                         row, d, i, N, st, close, rm_hist, rmm_hist);
    __syncthreads();

    // phase B: insert this span into the rings; bifurcation sums over the
    // rm/rmmb rows of spans <= d (all lanes now visible)
    const float g = c * T[TI_AUGT][row];
    RING(ringB, d, i) = g;
    RING(ringI, d, i) = g * T[TI_TMI1][row];
    RING(ring2, d, i) = g * T[TI_TMI2][row];
    ring3[(d & (RNA_TM3_SLOTS - 1)) * LW + i] = g * T[TI_TMI3][row];
    rna_inside_bifurcation(st, s.mbu1, base, row, d, i, N, ext, one, rm_hist,
                           rmm_hist, s1r, s2r);
    __syncthreads();
  }
#undef RING
}

__global__ void turner_inside_kernel(TURNER_INSIDE_PARAMS) {
  turner_inside_body<false>(TURNER_INSIDE_ARGS);
}

__global__ void __launch_bounds__(RNA_MAX_THREADS)
    turner_inside_wide_kernel(TURNER_INSIDE_PARAMS) {
  turner_inside_body<true>(TURNER_INSIDE_ARGS);
}

extern "C" int rna_turner_inside(void** tables, const float* KT,
                                 const float* scal, const int* ns,
                                 float* close, float* ext, float* one,
                                 float* rm_hist, float* rmm_hist,
                                 float* ring_g, int B, int N, void* stream) {
  // one lane per thread: Turner's tiers end at N = 1024
  if (!rna_shape_ok(N) || N > RNA_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  TurnerInsideTables tabs;
  for (int k = 0; k < TI_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t fixed =
      sizeof(float) * (3 * RNA_WIN * RNA_WIN + 4 * (N + 1));
  const size_t ring = sizeof(float) * TURNER_RING_ROWS * (N + 33);
  int smem_ring = 1;
  if (N <= RNA_NARROW)
    return rna_launch(turner_inside_kernel, B, N, fixed + ring, stream,
                      TURNER_INSIDE_ARGS);
  const size_t shmem = rna_smem(fixed, ring, &smem_ring);
  return rna_launch(turner_inside_wide_kernel, B, N, shmem, stream,
                    TURNER_INSIDE_ARGS);
}
