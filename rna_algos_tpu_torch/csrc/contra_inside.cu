// K1 and K8: CONTRAfold inside wavefront in scaled probability space, at
// N = 32-1024 in steps of 32 and at N = 2048.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _inside8a2_kernel (:562),
// _inside8a_kernel (:420) and _inside8_kernel (:305) at N <= 256 (K1), and
// pallas_fold_prob.py _contra_inside_prob_kernel_chunked (:706, called
// through _inside_call_prob_chunked, :1024) at N = 512, 1024 and 2048 (K8);
// the per-sequence maths is pallas_fold_prob.py:304-424
// (_contra_inside_prob_kernel).  The TPU kernels differ only in how they
// fit VMEM (G sequences stacked along sublanes; R-row table chunks with
// the DP state resident across grid steps); here the tables and the
// histories are read where they lie in global memory, so one kernel serves
// both tiers.  Inputs are the merged [d, i] tables of
// contra_prob_mats_merged (CANON, the sigma span powers and the
// special-cell LEN factors folded in), so for pair (i, j = i + d):
//
//   close = H + JS * window + STK*c(d-2, i+1) + B0R*c(d-3, i+1)
//         + B0L*c(d-3, i+2) + I11*c(d-4, i+2) + MBC * s2(d-2, i+1)
//   window = sum_{a+b<=30} K[a][a+b+1] * c(d-2-a-b, i+1+a)
//   rm   = rm(d-1, i) * eu1 + close*ACC*ebp        (rmmb likewise)
//   ext  = eu1^(d+1) + sum_t rm(d-t, i+t) * ext(t-1, i)
//   s2   = sum_{t>=1} one(t-1, i) * rmmb(d-t, i+t)
//   s1   = mbu1 * (rmmb(d-1, i+1) + s1(d-1, i+1))   (telescoped, flush-safe)
//   one  = rmmb + s1 + s2
//
// with c(s, l) = close*JB of span s at lane l, the window-buffer rows.
// The window loop, the rm/rmmb update and the bifurcation sums are the
// helpers of common.cuh that K4/K12 (turner_inside.cu) share.
//
// Bound: the latency of n dependent spans, each ending in __syncthreads
// because span d reads lanes of earlier spans, and within a span the O(d)
// bifurcation sums, four loads a term, walked serially by each lane's
// thread (at n = 2000 a thread of the N = 2048 launch walks ~2 x 10^6
// terms per pass).  The FLOPs (~0.7 n^3) and the bytes (each table read
// once) bound it far lower.  Design (launch.cuh): one block per sequence
// (the TPU's sequence stacking becomes the grid), one thread per lane up
// to N = 1024 and two strided lanes a thread at 2048, the whole span loop
// inside the block, in a narrow (N <= 256) and a wide entry kernel.  The
// 2-loop window is a 32-slot ring of inserted rows c(s, .) (slot s & 31),
// in shared memory up to N = 1024 and in a global scratch at 2048, contracted in FP32 with FMA against the per-sequence
// 32 x 32 banded matrix in shared memory; the TPU's SIGL aging pass is
// unnecessary because the matrix already carries each cell's sigma power.
// The rm/rmmb histories and the ext/one tables stay in global memory and
// are read coalesced along anti-diagonals.  Buffers this kernel writes are
// never read through the read-only path.  Rows at or past n are never
// written: the wrapper passes zeroed outputs.  The lever for a later
// change: several blocks per sequence (a cluster with the ring in
// distributed shared memory) to use more than B of the 132 SMs, and a
// blocked form of the bifurcation sums.

#include "launch.cuh"

#define CONTRA_INSIDE_PARAMS                                                \
  const float *__restrict__ H, const float *__restrict__ MBC,               \
      const float *__restrict__ ACC, const float *__restrict__ JS,          \
      const float *__restrict__ STK, const float *__restrict__ I11,         \
      const float *__restrict__ B0R, const float *__restrict__ B0L,         \
      const float *__restrict__ JB, const float *__restrict__ KW,           \
      const float *__restrict__ scal, const int *__restrict__ ns,           \
      float *close, float *ext, float *one, float *rm_hist,                 \
      float *rmm_hist, float *ring_g, int N, int smem_ring
#define CONTRA_INSIDE_ARGS                                                  \
  H, MBC, ACC, JS, STK, I11, B0R, B0L, JB, KW, scal, ns, close, ext, one,   \
      rm_hist, rmm_hist, ring_g, N, smem_ring

template <int LPT, bool WIDE>
__device__ __forceinline__ void contra_inside_body(CONTRA_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 33;                  // ring row: N lanes + window pad
  const int b = blockIdx.x;
  // narrow: ring | kw | s2r | s1r; wide: kw | s2r | s1r [| ring]
  float* kw = WIDE ? smem : smem + RNA_WIN * LW;   // 32 * 32
  float* s2r = kw + RNA_WIN * RNA_WIN;    // 2 * (N + 1), by span parity
  float* s1r = s2r + 2 * (N + 1);         // 2 * (N + 1), by span parity
  float* ring = WIDE ? rna_rings(s1r + 2 * (N + 1), ring_g, b,
                                 (long long)RNA_WIN * LW, smem_ring)
                     : smem;              // RNA_WIN * LW

  const int tid = threadIdx.x;
  const int T = WIDE ? blockDim.x : N;   // narrow: one thread per lane
  const long long base = (long long)b * N * N;

  for (int e = tid; e < RNA_WIN * LW; e += T) ring[e] = 0.0f;
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += T)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  for (int e = tid; e < 2 * (N + 1); e += T) {
    s2r[e] = 0.0f;
    s1r[e] = 0.0f;
  }
  const RnaScalars s = rna_scalars(scal + b * RNA_SCAL);
  const int n = ns[b];
  __syncthreads();

  RnaInsideLane st[LPT];
  float c[LPT];
  for (int d = 0; d < n; ++d) {
    // phase A: close from the window ring and the s2 ring (spans < d)
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = tid + k * T;
      const long long row = base + (long long)d * N + i;
      const float win = rna_window_inside(ring, kw, 0, d, i, LW);
      float two = JS[row] * win;
      two = two + STK[row] * ring[((d - 2) & (RNA_WIN - 1)) * LW + i + 1];
      two = two + B0R[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 1];
      two = two + B0L[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 2];
      two = two + I11[row] * ring[((d - 4) & (RNA_WIN - 1)) * LW + i + 2];
      c[k] = rna_inside_close(H[row] + two, MBC, ACC, s2r, s, row, d, i, N,
                              st[k], close, rm_hist, rmm_hist);
    }
    __syncthreads();

    // phase B: insert this span into the ring; bifurcation sums over the
    // rm/rmmb rows of spans <= d (all lanes now visible)
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int i = tid + k * T;
      const long long row = base + (long long)d * N + i;
      ring[(d & (RNA_WIN - 1)) * LW + i] = c[k] * JB[row];
      rna_inside_bifurcation(st[k], s.mbu1, base, row, d, i, N, ext, one,
                             rm_hist, rmm_hist, s1r, s2r);
    }
    __syncthreads();
  }
}

__global__ void contra_inside_kernel(CONTRA_INSIDE_PARAMS) {
  contra_inside_body<1, false>(CONTRA_INSIDE_ARGS);
}

template <int LPT>
__global__ void __launch_bounds__(RNA_MAX_THREADS)
    contra_inside_wide_kernel(CONTRA_INSIDE_PARAMS) {
  contra_inside_body<LPT, true>(CONTRA_INSIDE_ARGS);
}

extern "C" int rna_contra_inside(
    const float* H, const float* MBC, const float* ACC, const float* JS,
    const float* STK, const float* I11, const float* B0R, const float* B0L,
    const float* JB, const float* KW, const float* scal, const int* ns,
    float* close, float* ext, float* one, float* rm_hist, float* rmm_hist,
    float* ring_g, int B, int N, void* stream) {
  if (!rna_shape_ok(N)) return (int)cudaErrorInvalidValue;
  const size_t fixed = sizeof(float) * (RNA_WIN * RNA_WIN + 4 * (N + 1));
  const size_t ring = sizeof(float) * RNA_WIN * (N + 33);
  int smem_ring = 1;
  if (N <= RNA_NARROW)
    return rna_launch(contra_inside_kernel, B, N, fixed + ring, stream,
                      CONTRA_INSIDE_ARGS);
  const size_t shmem = rna_smem(fixed, ring, &smem_ring);
  if (N <= RNA_MAX_THREADS)
    return rna_launch(contra_inside_wide_kernel<1>, B, N, shmem, stream,
                      CONTRA_INSIDE_ARGS);
  return rna_launch(contra_inside_wide_kernel<RNA_MAX_LPT>, B,
                    RNA_MAX_THREADS, shmem, stream, CONTRA_INSIDE_ARGS);
}
