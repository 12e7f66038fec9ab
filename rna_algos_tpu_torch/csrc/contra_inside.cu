// K1: CONTRAfold inside wavefront in scaled probability space.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _inside8a2_kernel (:562),
// _inside8a_kernel (:420) and _inside8_kernel (:305); the per-sequence
// maths is pallas_fold_prob.py:304-424 (_contra_inside_prob_kernel).
// Inputs are the merged [d, i] tables of contra_prob_mats_merged (CANON,
// the sigma span powers and the special-cell LEN factors folded in), so
// for pair (i, j = i + d):
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
// helpers of common.cuh that K4 (turner_inside.cu) shares.
//
// Bound: the latency of n dependent spans, not FLOPs or bytes.  At N = 128
// the window is ~8 MFLOP per sequence and the O(d) bifurcation sums ~2.8
// MFLOP, far below what a single SM does in the time the span chain takes
// to walk; each span ends in __syncthreads because span d reads lanes of
// earlier spans.  Design: one block per sequence (the TPU's G-sequence
// sublane stacking becomes the grid), one thread per lane i, the whole span
// loop inside the block.  The 2-loop window is a 32-slot ring of inserted
// rows c(s, .) in shared memory (slot s & 31), contracted in FP32 with FMA
// against the per-sequence 32 x 32 banded matrix, also in shared memory;
// the TPU's SIGL aging pass is unnecessary because the matrix already
// carries each cell's sigma power.  The rm/rmmb histories and the ext/one
// tables stay in global memory (L2-resident at these sizes) and are read
// coalesced along anti-diagonals.  Buffers this kernel writes are never
// read through the read-only path.  Rows at or past n are never written:
// the wrapper passes zeroed outputs.

#include "common.cuh"

__global__ void contra_inside_kernel(
    const float* __restrict__ H, const float* __restrict__ MBC,
    const float* __restrict__ ACC, const float* __restrict__ JS,
    const float* __restrict__ STK, const float* __restrict__ I11,
    const float* __restrict__ B0R, const float* __restrict__ B0L,
    const float* __restrict__ JB, const float* __restrict__ KW,
    const float* __restrict__ scal, const int* __restrict__ ns,
    float* close, float* ext, float* one, float* rm_hist, float* rmm_hist,
    int N) {
  extern __shared__ float smem[];
  const int LW = N + 33;                  // ring row: N lanes + window pad
  float* ring = smem;                     // RNA_WIN * LW
  float* kw = ring + RNA_WIN * LW;        // 32 * 32
  float* s2r = kw + RNA_WIN * RNA_WIN;    // 2 * (N + 1), by span parity
  float* s1r = s2r + 2 * (N + 1);         // 2 * (N + 1), by span parity

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  const long long base = (long long)b * N * N;

  for (int e = i; e < RNA_WIN * LW; e += N) ring[e] = 0.0f;
  for (int e = i; e < RNA_WIN * RNA_WIN; e += N)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  for (int e = i; e < 2 * (N + 1); e += N) {
    s2r[e] = 0.0f;
    s1r[e] = 0.0f;
  }
  const RnaScalars s = rna_scalars(scal + b * RNA_SCAL);
  const int n = ns[b];
  __syncthreads();

  RnaInsideLane st;
  for (int d = 0; d < n; ++d) {
    const long long row = base + (long long)d * N + i;

    // phase A: close from the window ring and the s2 ring (spans < d)
    const float win = rna_window_inside(ring, kw, 0, d, i, LW);
    float two = JS[row] * win;
    two = two + STK[row] * ring[((d - 2) & (RNA_WIN - 1)) * LW + i + 1];
    two = two + B0R[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 1];
    two = two + B0L[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 2];
    two = two + I11[row] * ring[((d - 4) & (RNA_WIN - 1)) * LW + i + 2];
    const float c = rna_inside_close(H[row] + two, MBC, ACC, s2r, s, row, d,
                                     i, N, st, close, rm_hist, rmm_hist);
    __syncthreads();

    // phase B: insert this span into the ring; bifurcation sums over the
    // rm/rmmb rows of spans <= d (all lanes now visible)
    ring[(d & (RNA_WIN - 1)) * LW + i] = c * JB[row];
    rna_inside_bifurcation(st, s.mbu1, base, row, d, i, N, ext, one, rm_hist,
                           rmm_hist, s1r, s2r);
    __syncthreads();
  }
}

extern "C" int rna_contra_inside(
    const float* H, const float* MBC, const float* ACC, const float* JS,
    const float* STK, const float* I11, const float* B0R, const float* B0L,
    const float* JB, const float* KW, const float* scal, const int* ns,
    float* close, float* ext, float* one, float* rm_hist, float* rmm_hist,
    int B, int N, void* stream) {
  if (N < 32 || N > 256 || N % 32) return (int)cudaErrorInvalidValue;
  const size_t shmem =
      sizeof(float) * (RNA_WIN * (N + 33) + RNA_WIN * RNA_WIN + 4 * (N + 1));
  contra_inside_kernel<<<B, N, shmem, (cudaStream_t)stream>>>(
      H, MBC, ACC, JS, STK, I11, B0R, B0L, JB, KW, scal, ns, close, ext, one,
      rm_hist, rmm_hist, N);
  return (int)cudaGetLastError();
}
