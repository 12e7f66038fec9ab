// K14 / K15: the Durbin 3-state pair-HMM wavefront, forward or backward.
//
// Replaces rna_algos_tpu/ops/pallas_align_prob.py:52 _pairhmm_prob_kernel
// (K14, scaled probability space) and rna_algos_tpu/ops/pallas_align.py:66
// _pairhmm_kernel (K15, log space with the reference's cubic lse_pair, and
// its fast instance with the hardware log-add, which the JAX kernel
// computes when traced under "fast"), the fill of
// `reference/src/durbin_algo.rs:79-199`.
//
// The forward pass writes the match states M[i, j] and the three corner
// sums (M, I, D at (n1-2, n2-2), the partition function); the backward
// pass is the same recurrence on the coordinate-reversed pair with unit
// init scores, and writes the posterior context
//   ssum[i, j] = SS'[n1-2-i, n2-2-j]
// straight into forward coordinates.  Cells outside [0, n1-2] x [0, n2-2]
// hold the semiring's zero.
//
// Bound: bytes.  A pass writes the (N, N) plane once; per pair there are
// n1 + n2 - 3 dependent anti-diagonals of a handful of flops a row, which
// the pairs in flight on an SM overlap.  On the TPU 128 pairs rode the
// lanes and the 2N diagonals were a sequential grid, with a diagonal-layout
// output unskewed by XLA.  Here one block runs one pair and thread i owns
// row i, so a diagonal's cells lie N floats apart; the design keeps that
// from reaching memory, and keeps the step short, since on an H100 the
// warps' issue of their steps, not the flops, sets the pace (PERF.md,
// section 6):
//  * Every plane cell is written once, in 128-byte row segments.  Warp k
//    (rows 32k .. 32k+31) keeps its last RNA_PH_W diagonals in a shared
//    tile, T[l][w] = row 32k + l on diagonal d0 + w: a row's cells of a
//    window are contiguous in the plane (ascending forward, descending
//    backward), and the warp writes them out one row a store instruction
//    (rna_ph_flush), the last partial window at its own last diagonal.
//    The cells outside the box are written by coalesced row stores, 16
//    bytes a thread from the first aligned column (rna_ph_outside); there
//    is no pre-fill.
//  * Only the warps with live rows take part after the set-up: the others
//    write their outside-box zeros and leave.  The live warps step the
//    diagonals together, one named barrier over them a diagonal, row i-1's
//    states at d-1 passing through a double-buffered shared row; a warp
//    computes only the diagonals on which it has live cells (32k to its
//    last row at n2 - 2) and waits at the barrier on the others.
//  * A branch-free step: every lane computes the three states and a select
//    keeps its cell's case; the shared copy of x2 is padded so the
//    emission index needs no bound, and the next diagonal's base is loaded
//    a step ahead; the pass is a template parameter.
// A pipeline without a barrier a diagonal (rows handed from warp to warp
// through a shared ring, by progress counters or by named barriers between
// neighbours) was built and measured slower: the hand-off's shuffles and
// the lag between warps cost more issue slots than the barrier, which took
// 1-2% of a step (PERF.md, section 6).
// Emissions are gathered from the pair's 5 x 5 match and 5 insert tables
// in shared memory, indexed by the bases x1[i] and x2[d-i]; the backward
// pass reads both sequences reversed by index instead of a reversed copy.
//
// Every add and multiply is a round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA: the kernels compute bit for bit what their plain
// PyTorch versions (ops/pallas_align_prob.py, ops/pallas_align.py) compute,
// the cubic's Horner steps and lse_pair's lo + f(z) included.
// tests/test_torch_pairhmm_schedule.py replays the schedule (the row
// exchange, the windows and their flush map, the outside-box writes) in
// plain torch.

#include "common.cuh"
#include "cubic.cuh"

#define RNA_PSEUDO_BASE 4
#define RNA_NB 5  // base slots: A, C, G, U and the score-neutral PSEUDO
#define RNA_PAIRHMM_MAX_N 256
// Diagonals a window: a row's cells of a window are 32 contiguous floats.
#define RNA_PH_W 32
#define RNA_PH_TILE (RNA_PH_W + 1)  // tile row stride, against bank conflicts

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

// K15's fast instance: the same log space with the hardware log-add.
struct LogFastSemiring : LogSemiring {
  static __device__ __forceinline__ float match(float m2, float tmm, float i2,
                                                float d2, float m2i) {
    return rna_lse_pair_fast(
        rna_lse_pair_fast(__fadd_rn(m2, tmm), __fadd_rn(i2, m2i)),
        __fadd_rn(d2, m2i));
  }
  static __device__ __forceinline__ float pair(float a, float ta, float b,
                                               float tb) {
    return rna_lse_pair_fast(__fadd_rn(a, ta), __fadd_rn(b, tb));
  }
  static __device__ __forceinline__ float ss(float fm, float tend, float fi,
                                             float fd, float m2i) {
    return rna_lse_pair_fast(
        rna_lse_pair_fast(__fadd_rn(fm, tend), __fadd_rn(fi, m2i)),
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

// Padding of the shared copy of x2 on either side: a lane reads column
// d - i for every diagonal of its warp's walk, -31 .. N + 30.
#define RNA_PH_PAD 32

// Dynamic shared memory of a block of T threads (T / 32 warps): the
// tiles, the double-buffered row of M, I, D (a slot for row -1 first), x2
// padded, the emission tables.
static size_t rna_ph_shared_bytes(int T) {
  const int nw = T / 32;
  return nw * 32 * RNA_PH_TILE * sizeof(float) +
         2 * 3 * (T + 1) * sizeof(float) +
         (T + 2 * RNA_PH_PAD) * sizeof(int) +
         (RNA_NB * RNA_NB + RNA_NB) * sizeof(float);
}

// Named barrier 1 over the block's first `threads` threads (the live
// warps; barrier 0 is __syncthreads).
__device__ __forceinline__ void rna_ph_bar_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The semiring's zero in the cells of plane rows 32k .. 32k+31 outside
// [0, n1-2] x [0, n2-2]: whole rows past n1-2, the tail past n2-2 of the
// others; one row at a time, 16 bytes a thread from the first column
// aligned to 4 floats on.
__device__ __forceinline__ void rna_ph_outside(float* plane, int N, int n1,
                                               int n2, int k, int lane,
                                               float zero) {
  const bool vec = (N & 3) == 0;
  const float4 z4 = make_float4(zero, zero, zero, zero);
  const int r_end = min(32 * k + 32, N);
  for (int r = 32 * k; r < r_end; ++r) {
    const int c0 = r <= n1 - 2 ? max(n2 - 1, 0) : 0;
    const int a = vec ? min((c0 + 3) & ~3, N) : N;
    float* row = plane + (long long)r * N;
    for (int c = c0 + lane; c < a; c += 32) row[c] = zero;
    for (int c = a + 4 * lane; c < N; c += 128)
      *reinterpret_cast<float4*>(row + c) = z4;
  }
}

// Write warp k's window of `cnt` diagonals from d0 out of its tile: row
// i = 32k + l holds cell (i, j = d0 + w - i) at w; lane w stores it where
// it is live, one row a store (32 contiguous floats, descending backward).
// Row by row the cell moves by N - 1 floats (backward by -(N - 1)).
template <bool B>
__device__ __forceinline__ void rna_ph_flush(float* plane, const float* tile,
                                             int N, int n1, int n2, int k,
                                             int lane, int d0, int cnt) {
  const int rows = min(32, n1 - 1 - 32 * k);
  int j = d0 + lane - 32 * k;  // row 32k
  long long cell = B ? (long long)(n1 - 2 - 32 * k) * N + (n2 - 2 - j)
                     : (long long)(32 * k) * N + j;
  const long long step = B ? -(long long)(N - 1) : (long long)(N - 1);
  const bool in_window = lane < cnt;
  for (int l = 0; l < rows; ++l, --j, cell += step) {
    if (in_window && (unsigned)j <= (unsigned)(n2 - 2))
      plane[cell] = tile[l * RNA_PH_TILE + lane];
  }
}

// One block per pair (blockIdx.x), blockDim.x = N rounded up to whole
// warps, thread i = row i; B: the backward pass.
template <class S, bool B>
__device__ __forceinline__ void pairhmm_body(PAIRHMM_PARAMS) {
  extern __shared__ float rna_ph_smem[];
  const int T = blockDim.x, nw = T >> 5;
  float* tiles = rna_ph_smem;
  float* rows = tiles + nw * 32 * RNA_PH_TILE;  // [d & 1][M, I, D][1 + i]
  int* sx2 = reinterpret_cast<int*>(rows + 2 * 3 * (T + 1));
  float* sms = reinterpret_cast<float*>(sx2 + T + 2 * RNA_PH_PAD);
  float* sins = sms + RNA_NB * RNA_NB;

  const int p = blockIdx.x;
  const int i = threadIdx.x, k = i >> 5, lane = i & 31;
  const int n1 = n1s[p], n2 = n2s[p];
  const float zero = S::zero(), one = S::one();
  // scal: m2m, m2i, ext, init_m, init_i
  const float m2m = scal[0], m2i = scal[1], ext = scal[2];
  const float init_m = scal[3], init_i = scal[4];

  for (int e = i; e < RNA_NB * RNA_NB; e += T)
    sms[e] = ms[p * RNA_NB * RNA_NB + e];
  for (int e = i; e < RNA_NB; e += T) sins[e] = ins[p * RNA_NB + e];
  const int* s1 = x1 + (long long)p * N;
  const int* s2 = x2 + (long long)p * N;
  // the bases in this pass's coordinates (reversed by index backward),
  // PSEUDO on the padding
  for (int c = i; c < T + 2 * RNA_PH_PAD; c += T) {
    const int col = c - RNA_PH_PAD;
    sx2[c] = col >= 0 && col < n2 ? s2[B ? n2 - 1 - col : col]
                                  : RNA_PSEUDO_BASE;
  }
  const int b1 = i < n1 ? s1[B ? n1 - 1 - i : i] : RNA_PSEUDO_BASE;
  // rows before their first diagonal, and row -1, hold zero
  for (int e = i; e < 2 * 3 * (T + 1); e += T) rows[e] = zero;
  float* plane = out + (long long)p * N * N;
  rna_ph_outside(plane, N, n1, n2, k, lane, zero);
  __syncthreads();

  const int live_rows = min(32, n1 - 1 - 32 * k);  // rows i <= n1 - 2
  if (live_rows <= 0 || n2 < 2) return;
  const int live_threads = 32 * min(nw, (n1 - 2) / 32 + 1);
  const float* msrow = sms + b1 * RNA_NB;
  const float ins1 = sins[b1];
  const int* x2d = sx2 + RNA_PH_PAD - i;  // x2d[d]: the base at j = d - i
  float* tile = tiles + k * 32 * RNA_PH_TILE;
  // per lane: live, the first row, the corner's row; the transition
  // scores where the init scores replace them (j = 0 or 1)
  const bool row_ok = lane < live_rows, row0 = i == 0, row_ge1 = i >= 1;
  const bool corner_row = i == n1 - 2;
  const float tmm_j1 = i == 1 ? init_m : m2m;
  const float tmi_j0 = i == 1 ? init_i : m2i;
  const float td_j1 = i == 0 ? init_i : m2i;
  const unsigned jmax = n2 - 2;
  float own_m = zero, own_d = zero;          // row i at d-1
  float nm1 = zero, ni1 = zero, nd1 = zero;  // row i-1 at d-1
  // the warp's live diagonals: row 32k at j = 0 to its last row at n2 - 2
  const int first = 32 * k;
  const int de = first + live_rows - 1 + n2 - 2;
  const int dmax = n1 + n2 - 4;
  int b2 = x2d[first];  // the emission base of the warp's next diagonal
  int d0 = first, w = 0;  // the window's first diagonal, the step in it
  for (int d = 0; d <= dmax; ++d) {
    if (d >= first && d <= de) {
      const float msv = msrow[b2], dsv = sins[b2];
      b2 = x2d[d + 1];
      const float nm2 = nm1, ni2 = ni1, nd2 = nd1;  // row i-1 at d-2
      const float* prev = rows + ((d + 1) & 1) * 3 * (T + 1) + i;
      nm1 = prev[0];
      ni1 = prev[T + 1];
      nd1 = prev[2 * (T + 1)];
      // every lane computes the three states, then keeps those of its
      // cell's case (the semiring's zero elsewhere)
      const int j = d - i;
      const bool live = row_ok && (unsigned)j <= jmax;
      const float fm_c =
          S::emit(S::match(nm2, j == 1 ? tmm_j1 : m2m, ni2, nd2, m2i), msv);
      // insert: gap in seq 2, from (i-1, j)
      const float fi_c =
          S::emit(S::pair(nm1, j == 0 ? tmi_j0 : m2i, ni1, ext), ins1);
      // delete: gap in seq 1, from (i, j-1)
      const float fd_c =
          S::emit(S::pair(own_m, j == 1 ? td_j1 : m2i, own_d, ext), dsv);
      const bool origin = live && row0 && j == 0;
      const float fm = live && row_ge1 && j >= 1 ? fm_c : origin ? one : zero;
      const float fi = live && row_ge1 ? fi_c : zero;
      const float fd = live && j >= 1 ? fd_c : zero;
      if (corner_row && j == (int)jmax) {
        corner[3 * p] = fm;
        corner[3 * p + 1] = fi;
        corner[3 * p + 2] = fd;
      }
      own_m = fm;
      own_d = fd;
      float* cur = rows + (d & 1) * 3 * (T + 1) + i + 1;
      cur[0] = fm;
      cur[T + 1] = fi;
      cur[2 * (T + 1)] = fd;
      tile[lane * RNA_PH_TILE + w] =
          B ? S::ss(fm, origin ? one : m2m, fi, fd, m2i) : fm;
      if (++w == RNA_PH_W || d == de) {
        __syncwarp();
        rna_ph_flush<B>(plane, tile, N, n1, n2, k, lane, d0, w);
        __syncwarp();
        d0 += RNA_PH_W;
        w = 0;
      }
    }
    rna_ph_bar_sync(live_threads);
  }
}

__global__ void pairhmm_prob_kernel(PAIRHMM_PARAMS) {
  if (backward)
    pairhmm_body<ProbSemiring, true>(PAIRHMM_ARGS);
  else
    pairhmm_body<ProbSemiring, false>(PAIRHMM_ARGS);
}

__global__ void pairhmm_log_kernel(PAIRHMM_PARAMS) {
  if (backward)
    pairhmm_body<LogSemiring, true>(PAIRHMM_ARGS);
  else
    pairhmm_body<LogSemiring, false>(PAIRHMM_ARGS);
}

__global__ void pairhmm_log_fast_kernel(PAIRHMM_PARAMS) {
  if (backward)
    pairhmm_body<LogFastSemiring, true>(PAIRHMM_ARGS);
  else
    pairhmm_body<LogFastSemiring, false>(PAIRHMM_ARGS);
}

template <class K>
static int rna_pairhmm_launch(K kernel, const int* x1, const int* x2,
                              const int* n1s, const int* n2s, const float* ms,
                              const float* ins, const float* scal, float* out,
                              float* corner, int P, int N, int backward,
                              void* stream) {
  if (P < 1 || N < 1 || N > RNA_PAIRHMM_MAX_N)
    return (int)cudaErrorInvalidValue;
  const int T = (N + 31) & ~31;
  kernel<<<P, T, rna_ph_shared_bytes(T), (cudaStream_t)stream>>>(
      x1, x2, n1s, n2s, ms, ins, scal, out, corner, N, backward);
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

extern "C" int rna_pairhmm_log_fast(const int* x1, const int* x2,
                                    const int* n1s, const int* n2s,
                                    const float* ms, const float* ins,
                                    const float* scal, float* out,
                                    float* corner, int P, int N, int backward,
                                    void* stream) {
  return rna_pairhmm_launch(pairhmm_log_fast_kernel, x1, x2, n1s, n2s, ms,
                            ins, scal, out, corner, P, N, backward, stream);
}
