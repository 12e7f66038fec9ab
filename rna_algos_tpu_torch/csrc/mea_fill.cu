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
// would contract it into an FMA), a bifurcation term is one __fadd_rn, and
// every max is max.NaN.f32, which propagates NaN as torch.maximum does.
// The max is exact and order-free, so any split of a cell's terms gives
// the same bits as long as every term t in [1, d-1] is taken.  Every fill
// value is +0 or more (or NaN): it is built from +0, sums of such values
// and c3 = (m + gamma p) - 1, which the max with c2 >= +0 never lets
// through below +0.  So +0 is the identity of a cell's max, and the
// unsigned order of the bits is the order of the values, NaN above all.
//
// Bound: the N^3 / 6 add-max terms of a fill against its N^2 output floats,
// so operations; the spans are N - 1 dependent steps.
//
// Design.  The live triangle is kept by diagonal, D[s][i] = M(i, i+s), so a
// warp whose lanes are 32 consecutive cells of one span reads 32
// consecutive floats for a row operand D[t][i] and for a column operand
// D[d-1-t][i+t+1].  The spans run in bands of K = 8: before span d0 (a
// multiple of K) every thread sums, for the cells of spans d0 .. d0+K-1,
// the terms whose two halves lie in spans below d0 (t in [d - d0, d0 - 1]):
// a thread takes a lane i and a run of its t's, loads the row operand once
// for its K cells (K + 1 loads for K terms, each address one add from the
// last), and folds its K partial maxes into the cells with an unsigned
// atomicMax (the state starts at +0).
// The runs of one lane are whole warps apart, so every load stays
// conflict-free.  Then each span is one short step with a barrier: a
// thread a cell takes the cell's partial, its at most 2K - 3 late terms
// (t < d - d0, t >= d0), c1, c2 and c3, independent loads folded into four
// maxes; a band's K spans are compiled one by one, so each has its own
// slots and fixed address offsets.
// A lane's bpp values for a band's spans are copied into shared memory by
// cp.async before the band's bulk, so no step waits on device memory.  The
// critical path is a barrier and a tree a span, and a band's barrier; the
// N^3 / 6 terms are the bulk, over every thread of the fill.
// - Shared form: the triangle and the band's bpp values ((N (N + 1) / 2 +
//   K N) floats, N <= 332 on the H100: every bucket <= 256) in shared
//   memory, one block a fill; the square is written once at the end.
// - Cluster form (past that): a cluster of C blocks a fill, the triangle in
//   a global workspace read through L2 (__ldcg: blocks of the cluster write
//   it); each block steps its own lanes and a halo of K - 1 lanes above
//   them, so a step ends with the block's barrier and the cluster's
//   barrier comes twice a band, around the bulk; each cell is written to
//   the output when it is final, the lower triangle zeroed first.  C is
//   chosen so that the launch's fills run in one wave where they can
//   (rna_mea_fill_plan), so a launch with fewer fills than SMs spreads
//   each over C >= 2 SMs.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

// Dynamic shared memory a block may hold on the H100 (227 KB).
#define RNA_MEA_SHARED_BYTES 232448
// Spans a band (a power of two).
#define RNA_MEA_K 8
// Threads a block of the cluster form, and the largest cluster.
#define RNA_MEA_CLUSTER_T 512
#define RNA_MEA_MAX_C 16

// torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float mea_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (m_in + gamma * p) - 1.0 where p > 0, else -inf; p NaN gives -inf too.
__device__ __forceinline__ float mea_pair(float m_in, float gamma, float p) {
  return p > 0.0f ? __fsub_rn(__fadd_rn(m_in, __fmul_rn(gamma, p)), 1.0f)
                  : -INFINITY;
}

// Offset of diagonal s in the triangle (diagonals 0 .. s-1 first).
__host__ __device__ __forceinline__ int mea_diag(int s, int N) {
  return s * N - (s * (s - 1)) / 2;
}

// A state read: shared memory, or the workspace through L2 (other blocks
// of the cluster write it).
template <bool SHARED>
__device__ __forceinline__ float mea_ld(const float* p) {
  if constexpr (SHARED) return *p;
  else return __ldcg(p);
}

// The barrier of a step: the block's, or the cluster's (C > 1).
template <bool SHARED>
__device__ __forceinline__ void mea_sync(int C) {
  if (!SHARED && C > 1) cg::this_cluster().sync();
  else __syncthreads();
}

struct MeaArgs {
  const float* bpp;     // (R, N, N)
  const float* gammas;  // (G,)
  float* out;           // (R, G, N, N)
  float* work;          // cluster form: (R G, N (N + 1) / 2), else unused
  int G, N, C;
};

// One step t of a thread's bulk terms for the cells k < kmax of band d0
// (cell k at span d0 + k): the row operand D[t][i] once for its K cells,
// the column operands c[k] = D[d0+k-1-t][i+t+1] on K consecutive
// diagonals.  The addresses go by increments: row = &D[t][i] (the next
// step's is N - t further), col = &D[s][i+t+1] with s = d0 - 1 - t and
// dl = N - s (c[k + 1] is dl - k further; the next step's col is dl
// nearer, its dl one more).  MASKED: t < K, where cell k takes t >= k only
// (its smaller t are late terms).  FULL: every lane of the warp has its K
// cells live (kmax == K), so nothing is predicated.  c lives across the
// steps of a run (this form of the step ran faster on the card than one
// that loads into the sums, PERF.md).
template <bool SHARED, bool MASKED, bool FULL>
__device__ __forceinline__ void mea_bulk_step(const float*& row,
                                              const float*& col, int& dl,
                                              int N, int t, int kmax,
                                              float* c, float* acc) {
  const float r = FULL || kmax > 0 ? mea_ld<SHARED>(row) : 0.0f;
  const float* ck = col;
#pragma unroll
  for (int k = 0; k < RNA_MEA_K; ++k) {
    const bool live = FULL || k < kmax;
    if (live) c[k] = mea_ld<SHARED>(ck);
    if (live && (!MASKED || t >= k))
      acc[k] = mea_max(acc[k], __fadd_rn(r, c[k]));
    ck += dl - k;  // diagonal s + k -> s + k + 1
  }
  row += N - t;
  col -= dl;
  ++dl;
}

// The bulk of band d0: for every live cell (i, d0 + k), k < K, the max of
// its terms t in [max(1, k), d0 - 1], into D[d0+k][i] (which holds +0).
// Lane i's t's go to g parts, part u taking the run [1 + u L, 1 + (u+1) L);
// unit u * lp + i (lp: the lanes rounded up to whole warps) is dealt to
// thread unit mod nthr, so a warp is 32 lanes of one part and runs its
// steps in lockstep (the lanes past the band too, with nothing to load).
template <bool SHARED>
__device__ __forceinline__ void mea_bulk(float* D, int N, int d0, int q,
                                         int nthr) {
  const int nl = N - d0;
  const int lp = (nl + 31) & ~31;
  const int g = nthr / lp > 1 ? nthr / lp : 1;
  const int L = (d0 - 2 + g) / g;
  for (int unit = q; unit < lp * g; unit += nthr) {
    const int u = unit / lp, i = unit - u * lp;
    const int kmax = nl - i < RNA_MEA_K ? nl - i : RNA_MEA_K;
    const bool full = __all_sync(0xffffffffu, kmax == RNA_MEA_K);
    const int t0 = 1 + u * L, t1 = t0 + L < d0 ? t0 + L : d0;
    float acc[RNA_MEA_K], c[RNA_MEA_K];
#pragma unroll
    for (int k = 0; k < RNA_MEA_K; ++k) acc[k] = c[k] = 0.0f;
    const float* row = D + mea_diag(t0, N) + i;
    const float* col = D + mea_diag(d0 - 1 - t0, N) + i + t0 + 1;
    int dl = N - (d0 - 1 - t0);
    int t = t0;
    for (; t < t1 && t < RNA_MEA_K; ++t)
      mea_bulk_step<SHARED, true, false>(row, col, dl, N, t, kmax, c, acc);
    if (full) {
#pragma unroll 2
      for (; t < t1; ++t)
        mea_bulk_step<SHARED, false, true>(row, col, dl, N, t, kmax, c, acc);
    } else {
      for (; t < t1; ++t)
        mea_bulk_step<SHARED, false, false>(row, col, dl, N, t, kmax, c,
                                            acc);
    }
#pragma unroll
    for (int k = 0; k < RNA_MEA_K; ++k)
      if (k < kmax && __float_as_uint(acc[k]) != 0u)
        atomicMax(reinterpret_cast<unsigned int*>(D + mea_diag(d0 + k, N) + i),
                  __float_as_uint(acc[k]));
  }
}

// Cell (i, i + d), d = d0 + M, once its band's bulk is in D[d][i] (+0
// before the first band): the late terms (t in [1, M - 1], and past the
// first band t in [d0, d - 1]), c1, c2 and c3, folded into four
// independent maxes.  M is a compile-time constant, so each slot and each
// address is fixed: diagonal d0 + j lies j (N - d0) - j (j - 1) / 2 past
// diagonal d0.  Returns M(i, i + d).
template <bool SHARED, int M>
__device__ __forceinline__ float mea_cell(const float* D, int N, int d0,
                                          int i, float gamma, float p) {
  const int nd = N - d0;
  const float* b = D + mea_diag(d0, N) + i;  // &D[d0][i]
  auto at = [&](int j, int dx) {             // D[d0 + j][i + dx]
    return mea_ld<SHARED>(b + (j * nd - (j * (j - 1)) / 2) + dx);
  };
  float acc[4];
  acc[0] = at(M, 0);      // the bulk
  acc[1] = at(M - 1, 1);  // c1 = M(i + 1, j)
  acc[2] = at(M - 1, 0);  // c2 = M(i, j - 1)
  acc[3] = mea_pair(M >= 2 || d0 > 0 ? at(M - 2, 1) : 0.0f, gamma, p);
#pragma unroll
  for (int k = 0; k < M - 1; ++k)  // t = 1 + k: M(i, i + t) + M(i + t + 1, j)
    acc[k & 3] = mea_max(
        acc[k & 3], __fadd_rn(mea_ld<SHARED>(D + mea_diag(1 + k, N) + i),
                              at(M - 2 - k, k + 2)));
  if (d0 > 0)
#pragma unroll
    for (int k = 0; k < M; ++k)  // t = d0 + k
      acc[(k + 1) & 3] = mea_max(
          acc[(k + 1) & 3],
          __fadd_rn(at(k, 0), mea_ld<SHARED>(D + mea_diag(M - 1 - k, N) + i +
                                             d0 + k + 1)));
  return mea_max(mea_max(acc[0], acc[1]), mea_max(acc[2], acc[3]));
}

// What a span of a fill's band needs: the triangle, the output, the bpp
// (and a lane's band of it in P), and how the fill's threads share the
// lanes (see mea_fill_kernel).
struct MeaSpan {
  float* D;
  float* O;
  const float* B;
  const float* P;
  float gamma;
  int N, C, nthr, q, lane, ps, top;
  bool ring, halo;
};

// Span d0 + M of the band from d0: the cells of the thread's lane (or
// lanes), then the barrier.
template <bool SHARED, int M>
__device__ __forceinline__ void mea_span(const MeaSpan& s, int d0) {
  const int d = d0 + M, N = s.N;
  if (s.ring) {
    if (s.lane < N - d && s.lane < (s.halo ? s.top - M : N)) {
      const float m = mea_cell<SHARED, M>(s.D, N, d0, s.lane, s.gamma,
                                          s.P[M * s.ps + threadIdx.x]);
      s.D[mea_diag(d, N) + s.lane] = m;
      if (!SHARED) s.O[(long long)s.lane * N + s.lane + d] = m;
    }
  } else {
    for (int i = s.q; i < N - d; i += s.nthr) {
      const float m = mea_cell<SHARED, M>(
          s.D, N, d0, i, s.gamma, __ldg(s.B + (long long)i * N + i + d));
      s.D[mea_diag(d, N) + i] = m;
      if (!SHARED) s.O[(long long)i * N + i + d] = m;
    }
  }
  if (s.halo) __syncthreads();
  else if (SHARED || d + 1 < N) mea_sync<SHARED>(s.C);
}

// The spans d0 + M, ..., d0 + K - 1 of a band (below N; the first band
// starts at span 1).
template <bool SHARED, int M>
__device__ __forceinline__ void mea_band(const MeaSpan& s, int d0) {
  if (d0 + M >= s.N) return;
  if (M > 0 || d0 > 0) mea_span<SHARED, M>(s, d0);
  if constexpr (M + 1 < RNA_MEA_K) mea_band<SHARED, M + 1>(s, d0);
}

// Shared memory of a fill's triangle and its band of bpp values (the shared
// form), and of a block's band of bpp values (the cluster form).
static size_t mea_shared_bytes(int N) {
  return ((size_t)N * (N + 1) / 2 + (size_t)RNA_MEA_K * N) * sizeof(float);
}

template <bool SHARED>
__global__ void __launch_bounds__(RNA_MAX_THREADS)
mea_fill_kernel(MeaArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, C = SHARED ? 1 : a.C;
  const int r = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int f = blockIdx.x / C;  // record f / G, gamma f % G
  const float gamma = a.gammas[f % a.G];
  const float* B = a.bpp + (long long)(f / a.G) * N * N;
  float* O = a.out + (long long)f * N * N;
  const int tri = mea_diag(N, N);  // N (N + 1) / 2
  float* D = SHARED ? smem : a.work + (long long)f * tri;
  const int nthr = C * blockDim.x;
  const int q = r * blockDim.x + threadIdx.x;
  // A thread a lane (every plan the card picks).  Over a cluster, block r
  // owns the W lanes from r W and also steps the H = K - 1 lanes above them
  // (a halo, owned by block r + 1): within a band a cell depends only on
  // cells at most K - 1 lanes above it, so the halo, narrower by a lane a
  // span, keeps every cell the block needs, and the block's steps need
  // only its own barrier; the cluster's barrier comes twice a band, around
  // the bulk.  A halo cell is written twice, by both blocks, with the same
  // bits (the max is exact), and a cell's partial read after its final
  // value was written gives that final value again.  Lane q's bpp for a
  // band's spans is copied into shared memory (P[k][...], k < K) by
  // cp.async before the band's bulk, which hides the copy.  Otherwise a
  // thread takes lanes q, q + nthr, ... and loads their bpp, and every
  // step ends with the fill's barrier.
  const int H = !SHARED && C > 1 ? RNA_MEA_K - 1 : 0;
  const int W = blockDim.x - H;
  const int lane = r * W + threadIdx.x;
  const bool ring = C * W >= N;
  float* P = SHARED ? smem + tri : smem;
  const MeaSpan span = {D, O, B, P, gamma, N, C, nthr, q, lane,
                        SHARED ? N : (int)blockDim.x,  // P's row stride
                        r * W + W + H, ring, ring && H > 0};
  for (int k = q; k < tri; k += nthr) D[k] = 0.0f;
  if (!SHARED)  // the diagonal and below; the cells above as they end
    for (int i = r; i < N; i += C)
      for (int j = threadIdx.x; j <= i; j += blockDim.x)
        O[(long long)i * N + j] = 0.0f;
  mea_sync<SHARED>(C);
  for (int d0 = 0; d0 < N; d0 += RNA_MEA_K) {
    if (ring && lane < N) {
      for (int k = d0 ? 0 : 1; k < RNA_MEA_K && lane + d0 + k < N; ++k)
        __pipeline_memcpy_async(P + k * span.ps + threadIdx.x,
                                B + (long long)lane * N + lane + d0 + k,
                                sizeof(float));
      __pipeline_commit();
    }
    if (d0 > 0) {
      if (span.halo) mea_sync<SHARED>(C);  // the last band, all blocks'
      mea_bulk<SHARED>(D, N, d0, q, nthr);
    }
    if (ring && lane < N) __pipeline_wait_prior(0);
    if (d0 > 0) mea_sync<SHARED>(C);
    mea_band<SHARED, 0>(span, d0);
  }
  if constexpr (SHARED)
    for (int row = 0; row < N; ++row)
      for (int j = q; j < N; j += nthr)
        O[(long long)row * N + j] =
            j >= row ? D[mea_diag(j - row, N) + row] : 0.0f;
}

static int mea_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

// Clusters of C blocks of T threads of the cluster form the card holds at
// once (0 if it cannot launch them).
static int mea_active_clusters(int C, int T) {
  void* k = (void*)mea_fill_kernel<false>;
  if (C > 8 && cudaFuncSetAttribute(
                   k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
                   cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = (size_t)RNA_MEA_K * T * sizeof(float);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, k, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return active;
}

// The launch of R x G fills at bucket N: plan[0] the form (0 shared, 1
// cluster), plan[1] the threads a block, plan[2] the blocks a fill.  Shared
// form (the triangle fits): a thread a lane rounded to whole warps, at
// least 128 (more blocks an SM where the triangle leaves room; wider
// blocks gained nothing at N = 96-332, PERF.md).  Cluster form: blocks of RNA_MEA_CLUSTER_T,
// the largest C (at most RNA_MEA_MAX_C, enough blocks to give each lane
// and each block's halo a thread, no more threads than 8 a lane) whose
// clusters all run at once, else one block a fill where the fills
// outnumber the SMs and two where they do not.
extern "C" int rna_mea_fill_plan(int R, int G, int N, int* plan) {
  if (R < 1 || G < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (mea_shared_bytes(N) <= RNA_MEA_SHARED_BYTES) {
    int T = (N + 31) / 32 * 32;
    plan[0] = 0;
    plan[1] = T < 128 ? 128 : T > RNA_MAX_THREADS ? RNA_MAX_THREADS : T;
    plan[2] = 1;
    return 0;
  }
  const int T = RNA_MEA_CLUSTER_T;
  const long long F = (long long)R * G;
  int C = 1;
  for (int c = RNA_MEA_MAX_C; c >= 2; c /= 2) {
    if (c * (T - (RNA_MEA_K - 1)) < N) break;  // a thread a lane, halos too
    if (c > 2 && (long long)c * T > 8LL * N) continue;
    if (mea_active_clusters(c, T) >= F) {
      C = c;
      break;
    }
  }
  if (C == 1 && F < mea_sms()) C = 2;
  plan[0] = 1;
  plan[1] = T;
  plan[2] = C;
  return 0;
}

// bpp (R, N, N), gammas (G,), out (R, G, N, N), all float32 on the device;
// work: R G N (N + 1) / 2 floats for the cluster form (form 1), else
// unused.  form, T, C: a plan of rna_mea_fill_plan, or another one the
// form takes (T a multiple of 32; C 1 in the shared form, a power of two
// up to RNA_MEA_MAX_C in the cluster form).
extern "C" int rna_mea_fill(const void* bpp, const void* gammas, void* out,
                            void* work, int R, int G, int N, int form, int T,
                            int C, void* stream) {
  if (R < 1 || G < 1 || N < 1 || T < 32 || T % 32 || T > RNA_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  MeaArgs a = {(const float*)bpp, (const float*)gammas, (float*)out,
               (float*)work, G, N, form == 0 ? 1 : C};
  if (form == 0) {
    const size_t bytes = mea_shared_bytes(N);
    if (bytes > RNA_MEA_SHARED_BYTES || C != 1)
      return (int)cudaErrorInvalidValue;
    return rna_launch(mea_fill_kernel<true>, R * G, T, bytes, stream, a);
  }
  if (form != 1 || work == nullptr || C < 1 || C > RNA_MEA_MAX_C ||
      (C & (C - 1)))
    return (int)cudaErrorInvalidValue;
  void* k = (void*)mea_fill_kernel<false>;
  if (C > 8) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(R * G * C);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = (size_t)RNA_MEA_K * T * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, mea_fill_kernel<false>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
