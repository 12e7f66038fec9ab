// K23: the gamma-centroid MEA fill, one fill per (record, gamma).
//
// Replaces no Pallas kernel: the JAX package runs this fill as an XLA loop,
// rna_algos_tpu/models/centroid.py:58 mea_fill (its lax.scan over spans at
// :87), vmapped over the gamma grid by :92 mea_fill_gammas.  The port's
// plain version is ops/mea_fill.py mea_fill_batch_plain.
//
//   M(i, i) = 0;  for j = i + d, d >= 1:
//   M(i, j) = max(M(i+1, j), M(i, j-1),
//                 bpp(i, j) > 0 ? (M(i+1, j-1) + gamma * bpp(i, j)) - 1 : -inf,
//                 max_{t in [1, d-1]} M(i, i+t) + M(i+t+1, j))
//   out[r, g, i, j] = M(i, j) for j >= i, 0 below the diagonal.
//
// The host traceback re-derives every choice by float32 equality, so the
// fill is bitwise the plain version's: the candidate is written with
// __fmul_rn / __fadd_rn / __fsub_rn in the plain version's order (nvcc
// would contract it into an FMA), the bifurcation term is one __fadd_rn,
// and every max propagates NaN as torch.maximum does (fmaxf drops it).
// The max is exact, so the order of the bifurcation's max is free.
//
// Bound: the N^3 / 6 add-max terms of a fill against its N^2 output floats,
// so operations; the spans are N dependent steps (a wavefront, as K1/K2).
// Design: one block per (record, gamma), the spans as a loop with one
// barrier each.
// - Where the live triangle fits in shared memory (N(N+1)/2 floats, N <=
//   340 on the H100: every bucket <= 256), it is kept there by diagonal,
//   D[s][i] = M(i, i+s), and thread i owns lane i: the row reads M(i, i+t)
//   and the column reads M(i+t+1, j) of a warp are both 32 consecutive
//   floats, so they hit 32 banks.  The square is written once at the end.
// - Past that the output itself is the state: M(i, j) at [i][j] and its
//   mirror at [j][i] (the lower triangle, zeroed at the end), so a row read
//   and a column read along t are both contiguous.  A warp takes a cell and
//   its lanes take t, a shuffle tree takes the max.  One fill of a bucket
//   up to N ~ 2,000 stays in the 50 MB L2.
// Lanes past N - d do no work.

#include "launch.cuh"

// Dynamic shared memory a block may hold on the H100 (227 KB).
#define RNA_MEA_SHARED_BYTES 232448
#define RNA_MEA_GLOBAL_THREADS 1024

// torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float mea_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// (m_in + gamma * p) - 1.0 where p > 0, else -inf; p NaN gives -inf too.
__device__ __forceinline__ float mea_pair(float m_in, float gamma, float p) {
  return p > 0.0f ? __fsub_rn(__fadd_rn(m_in, __fmul_rn(gamma, p)), 1.0f)
                  : -INFINITY;
}

// Offset of diagonal s in the shared triangle (diagonals 0 .. s-1 first).
__device__ __forceinline__ int mea_diag(int s, int N) {
  return s * N - (s * (s - 1)) / 2;
}

__global__ void __launch_bounds__(RNA_MAX_THREADS)
mea_fill_shared_kernel(const float* __restrict__ bpp,
                       const float* __restrict__ gammas,
                       float* __restrict__ out, int G, int N) {
  extern __shared__ float tri[];
  const int r = blockIdx.x / G;
  const float gamma = gammas[blockIdx.x % G];
  const float* B = bpp + (long long)r * N * N;
  float* O = out + (long long)blockIdx.x * N * N;
  const int i = threadIdx.x;
  if (i < N) tri[i] = 0.0f;
  __syncthreads();
  for (int d = 1; d < N; ++d) {
    if (i < N - d) {
      const float* prev = tri + mea_diag(d - 1, N);
      const float c1 = prev[i + 1];
      const float c2 = prev[i];
      const float m_in = d >= 2 ? tri[mea_diag(d - 2, N) + i + 1] : 0.0f;
      const float c3 = mea_pair(m_in, gamma, B[(long long)i * N + i + d]);
      float c4 = -INFINITY;
      if (d >= 2) {
        // row M(i, i+t) = D[t][i], column M(i+t+1, i+d) = D[d-1-t][i+t+1]
        const float* row = tri + N + i;
        const float* col = tri + mea_diag(d - 2, N) + i + 2;
        for (int t = 1; t < d; ++t) {
          c4 = mea_max(c4, __fadd_rn(*row, *col));
          row += N - t;            // D[t][.] -> D[t+1][.]
          col -= N - (d - 1 - t);  // D[s][k] -> D[s-1][k+1], s = d-1-t
        }
      }
      tri[mea_diag(d, N) + i] = mea_max(mea_max(c1, c2), mea_max(c3, c4));
    }
    __syncthreads();
  }
  for (int row = 0; row < N; ++row)
    for (int j = i; j < N; j += blockDim.x)
      O[(long long)row * N + j] =
          j >= row ? tri[mea_diag(j - row, N) + row] : 0.0f;
}

__global__ void __launch_bounds__(RNA_MEA_GLOBAL_THREADS)
mea_fill_global_kernel(const float* __restrict__ bpp,
                       const float* __restrict__ gammas, float* out, int G,
                       int N) {
  const int r = blockIdx.x / G;
  const float gamma = gammas[blockIdx.x % G];
  const float* B = bpp + (long long)r * N * N;
  float* O = out + (long long)blockIdx.x * N * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < N; i += blockDim.x)
    O[(long long)i * N + i] = 0.0f;
  __syncthreads();
  for (int d = 1; d < N; ++d) {
    for (int i = warp; i < N - d; i += warps) {
      const int j = i + d;
      const float* row = O + (long long)i * N + i;   // M(i, i+t) at row[t]
      const float* col = O + (long long)j * N + i;   // M(i+t+1, j) at col[t+1]
      float c4 = -INFINITY;
      for (int t = 1 + lane; t < d; t += 32)
        c4 = mea_max(c4, __fadd_rn(row[t], col[t + 1]));
      for (int k = 16; k > 0; k >>= 1)
        c4 = mea_max(c4, __shfl_xor_sync(0xffffffffu, c4, k));
      if (lane == 0) {
        const float c1 = O[(long long)(i + 1) * N + j];
        const float c2 = row[d - 1];
        const float m_in = d >= 2 ? O[(long long)(i + 1) * N + j - 1] : 0.0f;
        const float c3 = mea_pair(m_in, gamma, B[(long long)i * N + j]);
        const float m = mea_max(mea_max(c1, c2), mea_max(c3, c4));
        O[(long long)i * N + j] = m;
        O[(long long)j * N + i] = m;
      }
    }
    __syncthreads();
  }
  for (int row = 1; row < N; ++row)
    for (int j = threadIdx.x; j < row; j += blockDim.x)
      O[(long long)row * N + j] = 0.0f;
}

// bpp (R, N, N), gammas (G,), out (R, G, N, N), all float32 on the device.
extern "C" int rna_mea_fill(const void* bpp, const void* gammas, void* out,
                            int R, int G, int N, void* stream) {
  if (R < 1 || G < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t tri = (size_t)N * (N + 1) / 2 * sizeof(float);
  const int blocks = R * G;
  if (tri <= RNA_MEA_SHARED_BYTES) {
    const int threads = (N + 31) / 32 * 32;
    return rna_launch(mea_fill_shared_kernel, blocks, threads, tri, stream,
                      (const float*)bpp, (const float*)gammas, (float*)out, G,
                      N);
  }
  mea_fill_global_kernel<<<blocks, RNA_MEA_GLOBAL_THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const float*)bpp, (const float*)gammas, (float*)out, G, N);
  return (int)cudaGetLastError();
}
