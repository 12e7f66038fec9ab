// K3: diagonal skew of batched [p, q] tables, both directions.
//
// Replaces rna_algos_tpu/ops/pallas_skew.py:36 _skew_kernel (called through
// skew_pq_batch :95), used forward on the merged score tables
// (pallas_fold_prob8.contra_prob_mats_merged) and with inv=True on the
// final [i, d] probabilities (models/mccaskill._prob_finish).
//
//   forward: out[b, p, d] = in[b, p, p + d]   (p + d >= N -> 0)
//   inverse: out[b, i, j] = in[b, i, j - i]   (j < i -> 0)
//
// Bound: a pure permutation, so device-memory bytes (one read and one write
// of every element).  On the TPU the kernel was shaped by VMEM and the lack
// of dynamic lane shifts (log-depth static shift levels); on this card each
// thread moves one element: writes are fully coalesced, and reads are
// contiguous along a row (shifted by the row index), so both directions run
// at a plain copy's access pattern.  All T tables of a call share one
// launch (grid.z = table), the pointer lists travel in the kernel's
// parameter block.

#include "common.cuh"

#define RNA_SKEW_MAX_TABLES 32  // the Turner precompute skews 18 tables

struct SkewPtrs {
  const float* in[RNA_SKEW_MAX_TABLES];
  float* out[RNA_SKEW_MAX_TABLES];
};

__global__ void skew_kernel(SkewPtrs ptrs, int N, int inv) {
  const int t = blockIdx.z;
  const int b = blockIdx.y;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nn = (long long)N * N;
  if (e >= nn) return;
  const int row = (int)(e / N);
  const int col = (int)(e % N);
  const float* src = ptrs.in[t] + (long long)b * nn + (long long)row * N;
  float v = 0.0f;
  if (inv) {
    if (col >= row) v = src[col - row];
  } else {
    if (row + col < N) v = src[row + col];
  }
  ptrs.out[t][(long long)b * nn + e] = v;
}

extern "C" const char* rna_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int rna_skew(void** ins, void** outs, int T, int B, int N, int inv,
                        void* stream) {
  if (T < 1 || T > RNA_SKEW_MAX_TABLES) return (int)cudaErrorInvalidValue;
  SkewPtrs ptrs;
  for (int t = 0; t < T; ++t) {
    ptrs.in[t] = (const float*)ins[t];
    ptrs.out[t] = (float*)outs[t];
  }
  const int threads = 256;
  const long long nn = (long long)N * N;
  dim3 grid((unsigned)((nn + threads - 1) / threads), B, T);
  skew_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(ptrs, N, inv);
  return (int)cudaGetLastError();
}
