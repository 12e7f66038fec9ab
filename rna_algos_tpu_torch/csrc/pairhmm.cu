// K14 / K15: the Durbin 3-state pair-HMM wavefront, forward or backward.
//
// Replaces rna_algos_tpu/ops/pallas_align_prob.py:52 _pairhmm_prob_kernel
// (K14, scaled probability space) and rna_algos_tpu/ops/pallas_align.py:66
// _pairhmm_kernel (K15, log space with the reference's cubic lse_pair),
// the fill of `reference/src/durbin_algo.rs:79-199`.
//
// The forward pass writes the match states M[i, j] and the three corner
// sums (M, I, D at (n1-2, n2-2), the partition function); the backward
// pass is the same recurrence on the coordinate-reversed pair with unit
// init scores, and writes the posterior context
//   ssum[i, j] = SS'[n1-2-i, n2-2-j]
// straight into forward coordinates.  Cells outside [0, n1-2] x [0, n2-2]
// hold the semiring's zero.
//
// Bound: latency.  Per pair there are n1 + n2 - 3 dependent anti-diagonals,
// each a handful of flops per row; the bytes (the (N, N) output plane once
// per pass) take microseconds.  On the TPU 128 pairs rode the lanes and the
// 2N diagonals were a sequential grid, with sliding emission windows and a
// diagonal-layout output unskewed by XLA.  Here one block runs one pair,
// thread i owns row i, and the block walks its pair's own diagonals: the
// M/I/D states of row i-1 at d-1 travel through a double-buffered shared
// row (one __syncthreads per diagonal), the row's own d-1 states and its
// neighbour's d-2 states stay in registers.  Emissions are gathered from
// the pair's 5 x 5 match and 5 insert tables in shared memory, indexed by
// the bases x1[i] and x2[d-i]; the backward pass reads both sequences
// reversed by index instead of a reversed copy.
//
// Every add and multiply is a round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA: the kernels compute bit for bit what their plain
// PyTorch versions (ops/pallas_align_prob.py, ops/pallas_align.py) compute,
// the cubic's Horner steps and lse_pair's lo + f(z) included.

#include "common.cuh"
#include "cubic.cuh"

#define RNA_PSEUDO_BASE 4
#define RNA_NB 5  // base slots: A, C, G, U and the score-neutral PSEUDO
#define RNA_PAIRHMM_MAX_N 256

// The two semirings, each in the association of its JAX kernel.
struct ProbSemiring {  // K14: scaled probabilities
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float one() { return 1.0f; }
  // M: m2 * t_mm + (i2 + d2) * m2i
  static __device__ __forceinline__ float match(float m2, float tmm, float i2,
                                                float d2, float m2i) {
    return __fadd_rn(__fmul_rn(m2, tmm), __fmul_rn(__fadd_rn(i2, d2), m2i));
  }
  // I, D: a * ta + b * tb
  static __device__ __forceinline__ float pair(float a, float ta, float b,
                                               float tb) {
    return __fadd_rn(__fmul_rn(a, ta), __fmul_rn(b, tb));
  }
  static __device__ __forceinline__ float emit(float t, float e) {
    return __fmul_rn(t, e);
  }
  // backward context: fm * t_end + (fi + fd) * m2i
  static __device__ __forceinline__ float ss(float fm, float tend, float fi,
                                             float fd, float m2i) {
    return __fadd_rn(__fmul_rn(fm, tend), __fmul_rn(__fadd_rn(fi, fd), m2i));
  }
};

struct LogSemiring {  // K15: log space, cubic lse_pair
  static __device__ __forceinline__ float zero() { return -INFINITY; }
  static __device__ __forceinline__ float one() { return 0.0f; }
  // lse(lse(m2 + t_mm, i2 + m2i), d2 + m2i)
  static __device__ __forceinline__ float match(float m2, float tmm, float i2,
                                                float d2, float m2i) {
    return rna_lse_pair(rna_lse_pair(__fadd_rn(m2, tmm), __fadd_rn(i2, m2i)),
                        __fadd_rn(d2, m2i));
  }
  static __device__ __forceinline__ float pair(float a, float ta, float b,
                                               float tb) {
    return rna_lse_pair(__fadd_rn(a, ta), __fadd_rn(b, tb));
  }
  static __device__ __forceinline__ float emit(float t, float e) {
    return __fadd_rn(t, e);
  }
  static __device__ __forceinline__ float ss(float fm, float tend, float fi,
                                             float fd, float m2i) {
    return rna_lse_pair(rna_lse_pair(__fadd_rn(fm, tend), __fadd_rn(fi, m2i)),
                        __fadd_rn(fd, m2i));
  }
};

#define PAIRHMM_PARAMS                                                       \
  const int *__restrict__ x1, const int *__restrict__ x2,                   \
      const int *__restrict__ n1s, const int *__restrict__ n2s,             \
      const float *__restrict__ ms, const float *__restrict__ ins,          \
      const float *__restrict__ scal, float *__restrict__ out,              \
      float *__restrict__ corner, int N, int backward
#define PAIRHMM_ARGS x1, x2, n1s, n2s, ms, ins, scal, out, corner, N, backward

// One block per pair (blockIdx.x), blockDim.x == N threads, thread i = row i.
template <class S>
__device__ __forceinline__ void pairhmm_body(PAIRHMM_PARAMS) {
  __shared__ int sx2[RNA_PAIRHMM_MAX_N];
  __shared__ float sms[RNA_NB * RNA_NB];
  __shared__ float sins[RNA_NB];
  // [buffer][M, I, D][1 + row]; slot 0 is row -1 and stays zero
  __shared__ float buf[2][3][RNA_PAIRHMM_MAX_N + 1];

  const int p = blockIdx.x;
  const int i = threadIdx.x;
  const int n1 = n1s[p], n2 = n2s[p];
  const float zero = S::zero();
  // scal: m2m, m2i, ext, init_m, init_i
  const float m2m = scal[0], m2i = scal[1], ext = scal[2];
  const float init_m = scal[3], init_i = scal[4];

  for (int k = i; k < RNA_NB * RNA_NB; k += blockDim.x)
    sms[k] = ms[p * RNA_NB * RNA_NB + k];
  for (int k = i; k < RNA_NB; k += blockDim.x) sins[k] = ins[p * RNA_NB + k];
  const int* s1 = x1 + (long long)p * N;
  const int* s2 = x2 + (long long)p * N;
  // the bases in this pass's coordinates (reversed by index backward)
  sx2[i] = i < n2 ? s2[backward ? n2 - 1 - i : i] : RNA_PSEUDO_BASE;
  const int b1 = i < n1 ? s1[backward ? n1 - 1 - i : i] : RNA_PSEUDO_BASE;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    buf[0][s][i + 1] = zero;
    buf[1][s][i + 1] = zero;
    if (i == 0) {
      buf[0][s][0] = zero;
      buf[1][s][0] = zero;
    }
  }
  // cells the wavefront does not reach hold zero
  float* plane = out + (long long)p * N * N;
  for (int e = i; e < N * N; e += blockDim.x) {
    if (e / N >= n1 - 1 || e % N >= n2 - 1) plane[e] = zero;
  }
  __syncthreads();

  const bool row_ok = i < n1 - 1;
  const float* msrow = sms + b1 * RNA_NB;
  const float ins1 = sins[b1];
  float nm1 = zero, ni1 = zero, nd1 = zero;  // row i-1 at d-1
  float own_m = zero, own_d = zero;          // row i at d-1
  const int dmax = n1 + n2 - 4;
  for (int d = 0; d <= dmax; ++d) {
    const float nm2 = nm1, ni2 = ni1, nd2 = nd1;  // row i-1 at d-2
    const int rb = (d + 1) & 1;                   // written at d-1
    nm1 = buf[rb][0][i];
    ni1 = buf[rb][1][i];
    nd1 = buf[rb][2][i];
    const int j = d - i;
    float fm = zero, fi = zero, fd = zero;
    if (row_ok && j >= 0 && j < n2 - 1) {
      const int b2 = sx2[j];
      if (i >= 1 && j >= 1) {
        const float tmm = (i == 1 && j == 1) ? init_m : m2m;
        fm = S::emit(S::match(nm2, tmm, ni2, nd2, m2i), msrow[b2]);
      } else if (i == 0 && j == 0) {
        fm = S::one();
      }
      if (i >= 1) {  // insert: gap in seq 2, from (i-1, j)
        const float tmi = (i == 1 && j == 0) ? init_i : m2i;
        fi = S::emit(S::pair(nm1, tmi, ni1, ext), ins1);
      }
      if (j >= 1) {  // delete: gap in seq 1, from (i, j-1)
        const float td = (i == 0 && j == 1) ? init_i : m2i;
        fd = S::emit(S::pair(own_m, td, own_d, ext), sins[b2]);
      }
      if (backward) {
        const float tend = (i == 0 && j == 0) ? S::one() : m2m;
        plane[(long long)(n1 - 2 - i) * N + (n2 - 2 - j)] =
            S::ss(fm, tend, fi, fd, m2i);
      } else {
        plane[(long long)i * N + j] = fm;
      }
      if (i == n1 - 2 && j == n2 - 2) {
        corner[3 * p] = fm;
        corner[3 * p + 1] = fi;
        corner[3 * p + 2] = fd;
      }
    }
    own_m = fm;
    own_d = fd;
    const int wb = d & 1;
    buf[wb][0][i + 1] = fm;
    buf[wb][1][i + 1] = fi;
    buf[wb][2][i + 1] = fd;
    __syncthreads();
  }
}

__global__ void pairhmm_prob_kernel(PAIRHMM_PARAMS) {
  pairhmm_body<ProbSemiring>(PAIRHMM_ARGS);
}

__global__ void pairhmm_log_kernel(PAIRHMM_PARAMS) {
  pairhmm_body<LogSemiring>(PAIRHMM_ARGS);
}

template <class K>
static int rna_pairhmm_launch(K kernel, const int* x1, const int* x2,
                              const int* n1s, const int* n2s, const float* ms,
                              const float* ins, const float* scal, float* out,
                              float* corner, int P, int N, int backward,
                              void* stream) {
  if (P < 1 || N < 1 || N > RNA_PAIRHMM_MAX_N)
    return (int)cudaErrorInvalidValue;
  kernel<<<P, N, 0, (cudaStream_t)stream>>>(x1, x2, n1s, n2s, ms, ins, scal,
                                            out, corner, N, backward);
  return (int)cudaGetLastError();
}

extern "C" int rna_pairhmm_prob(const int* x1, const int* x2, const int* n1s,
                                const int* n2s, const float* ms,
                                const float* ins, const float* scal,
                                float* out, float* corner, int P, int N,
                                int backward, void* stream) {
  return rna_pairhmm_launch(pairhmm_prob_kernel, x1, x2, n1s, n2s, ms, ins,
                            scal, out, corner, P, N, backward, stream);
}

extern "C" int rna_pairhmm_log(const int* x1, const int* x2, const int* n1s,
                               const int* n2s, const float* ms,
                               const float* ins, const float* scal, float* out,
                               float* corner, int P, int N, int backward,
                               void* stream) {
  return rna_pairhmm_launch(pairhmm_log_kernel, x1, x2, n1s, n2s, ms, ins,
                            scal, out, corner, P, N, backward, stream);
}
