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
// histories are read where they lie in global memory.  Inputs are the
// merged [d, i] tables of
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
// K4 (turner_inside.cu) shares K1's layout and sums (narrow.cuh); K12
// shares K8's sums (cluster.cuh) and common.cuh's window loop; K8's close
// and its share of the sums are cluster.cuh's, K1's narrow.cuh's.
//
// K1 (N <= 256): one block of T = 256-1,024 threads per sequence, T from
// the batch and the card (narrow.cuh), thread i owning lane i; live cells
// only (i + d < n), a dead cell stays the zero the wrapper passes.  What
// bounds it: the latency of n dependent spans.  One thread a lane walking
// its 496-term window (a chain of shared-memory loads) and its O(d)
// bifurcation terms (four loads each, one in flight) took ~33 us a span at
// N = 256 on an H100 (PERF.md, PR 10: without the window 0.46 / 0.67 of the
// time at N = 128 / 256, without the sums 0.64 / 0.34).  So each span is
// two phases of the whole block: (1) the owners compute close from their
// table cells and the window sum of the phase before and insert close*JB
// into the 32-slot ring (slot d & 31 held span d - 32, which no lane reads
// any more), while every thread takes a part of the live lanes' terms
// t >= 1; (2) the owners add their parts and finish ext, one, s1 and s2,
// while the block computes the next span's windows, only at the cells
// that can close (d >= 4, merged JS != 0: CANON zeroes H, JS, STK, I11,
// B0R, B0L and MBC elsewhere, so close is the same without the window),
// listed by the owners in phase 1.  Two barriers a span.  The 32 x 32
// banded matrix carries each cell's sigma power, so the TPU's SIGL aging
// pass is unnecessary; the histories rm, rmmb, ext and one stay in global
// memory (L2), read coalesced along anti-diagonals and columns.
//
// K8 (N = 512, 1024, 2048): a cluster of C blocks per sequence
// (cluster.cuh; C = 16 at N = 2048 B = 8).  What bounds it: each span's
// bifurcation sums re-read the history triangle of the spans before it,
// four loads a term, ~16 B x n^3 / 6 per sequence (~10 GB at n = 1,550),
// with little reuse once a batch's histories outgrow the 50 MB L2; the
// FLOPs (~0.7 n^3) and the bytes of one pass over the tables bound it far
// lower.  One block per sequence kept that re-read to B SMs and walked
// each lane's O(d) terms on one thread (~1 load in flight a thread).  Here
// each block owns N / C lanes, in chunks interleaved over the cluster so
// that every span's live lanes spread over all its blocks; only live cells
// (i + d < n) are computed, and a dead cell stays the zero the wrapper
// passes (nothing downstream reads one: tests/test_torch_long_deadcells.py);
// each live lane's terms t >= 1 are spread over the block's threads that
// lanes leave idle (rna_cl_part), RNA_CL_BATCH_INSIDE terms' loads at a time,
// and their parts summed in a fixed order by the lane's owner thread.  The
// window ring keeps 32 slots of, per chunk, its lanes and the next chunk's
// first 32 (written by that chunk's block through distributed shared
// memory); a span's row is inserted at the start of the next span, into
// the slot of span d - 33 that no lane reads then, so one cluster barrier
// a span suffices.  s1 and s2 rows by span & 3 with one halo lane a chunk.

#include "cluster.cuh"
#include "launch.cuh"
#include "narrow.cuh"

#define CONTRA_INSIDE_PARAMS                                                \
  const float *__restrict__ H, const float *__restrict__ MBC,               \
      const float *__restrict__ ACC, const float *__restrict__ JS,          \
      const float *__restrict__ STK, const float *__restrict__ I11,         \
      const float *__restrict__ B0R, const float *__restrict__ B0L,         \
      const float *__restrict__ JB, const float *__restrict__ KW,           \
      const float *__restrict__ scal, const int *__restrict__ ns,           \
      float *close, float *ext, float *one, float *rm_hist,                 \
      float *rmm_hist, int N
#define CONTRA_INSIDE_ARGS                                                  \
  H, MBC, ACC, JS, STK, I11, B0R, B0L, JB, KW, scal, ns, close, ext, one,   \
      rm_hist, rmm_hist, N

// K1's shared memory at N lanes and T threads: kw | ring, 32 rows of N + 32
// lanes | s2r, s1r, 2 rows of N + 1 each | win, N | the es and s2 parts, T
// each | the closable lists, 2 spans of N ints, and their two counts.
static size_t contra_inside_smem(int N, int T) {
  return sizeof(float) * (RNA_WIN * RNA_WIN + RNA_WIN * (N + 32) +
                          4 * (N + 1) + N + 2 * T) +
         sizeof(int) * (2 * N + 2 + N + 32);
}

__global__ void __launch_bounds__(RNA_NW_MAX_THREADS)
    contra_inside_kernel(CONTRA_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  // ring row: N lanes + 32 zero pad lanes (lane i + 1 + a <= N + 30); rows
  // a multiple of 32 floats apart, so the threads of a window group, each
  // on its own row a of one cell, read distinct banks
  const int LW = N + 32;
  float* kw = smem;                       // 32 * 32
  float* ring = kw + RNA_WIN * RNA_WIN;   // RNA_WIN * LW, slot s & 31
  float* s2r = ring + RNA_WIN * LW;       // 2 * (N + 1), by span parity
  float* s1r = s2r + 2 * (N + 1);         // 2 * (N + 1), by span parity
  float* win = s1r + 2 * (N + 1);         // N: the span's windows
  float* part = win + N;                  // es | s2, T each
  int* list = (int*)(part + 2 * T);       // 2 * N
  int* count = list + 2 * N;              // 2
  unsigned* nz = (unsigned*)(count + 2);  // N + 32: a lane's nonzero slots

  const long long base = (long long)b * N * N;
  for (int e = tid; e < RNA_WIN * LW + 4 * (N + 1); e += T)
    ring[e] = 0.0f;                       // ring, s2r and s1r
  for (int e = tid; e < N + 32; e += T) nz[e] = 0u;
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += T)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  if (tid < 2) count[tid] = 0;
  const RnaScalars s = rna_scalars(scal + b * RNA_SCAL);
  const int n = ns[b];
  const float* rmb = rm_hist + base;
  const float* rmmb = rmm_hist + base;
  const float* extb = ext + base;
  const float* oneb = one + base;
  __syncthreads();

  // thread i owns lane i
  const int i = tid;
  RnaInsideLane st;
  for (int d = 0; d < n; ++d) {
    const int m = n - d;                  // live lanes 0 .. m-1
    const long long row = base + (long long)d * N + i;
    // phase 1: list span d + 1's cells that can close
    if (i < m - 1 && d + 2 >= RNA_MIN_SPAN_HAIRPIN_CLOSE &&
        JS[row + N] != 0.0f)
      list[((d + 1) & 1) * N + atomicAdd(&count[(d + 1) & 1], 1)] = i;
    // the owners' close of span d from its window (where the cell can
    // close; elsewhere JS and every term that pairs are 0), the ring rows
    // of spans < d and s2(d-2, i+1); and rmmb(d-1, i+1) for phase 2
    float rmm_nb = 0.0f;
    if (i < m) {
      const float js = JS[row];
      const float w = d + 1 >= RNA_MIN_SPAN_HAIRPIN_CLOSE && js != 0.0f
                          ? win[i] : 0.0f;
      float two = js * w;
      two = two + STK[row] * ring[((d - 2) & (RNA_WIN - 1)) * LW + i + 1];
      two = two + B0R[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 1];
      two = two + B0L[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 2];
      two = two + I11[row] * ring[((d - 4) & (RNA_WIN - 1)) * LW + i + 2];
      const float mb_term =
          d >= 2 ? s2r[(d & 1) * (N + 1) + i + 1] * MBC[row] : 0.0f;
      float c = H[row] + two + mb_term;
      if (d + 1 < RNA_MIN_SPAN_HAIRPIN_CLOSE) c = 0.0f;
      close[row] = c;
      const float ca = c * ACC[row];
      st.rm = st.rm * s.eu1 + ca * s.ebp;
      st.rmmb = st.rmmb * s.mbu1 + ca * s.mbbp;
      st.epow = st.epow * s.eu1;
      rm_hist[row] = st.rm;
      rmm_hist[row] = st.rmmb;
      // span d's row, read from span d + 2 on (its slot held span d - 32)
      const float x = c * JB[row];
      const unsigned bit = 1u << (d & (RNA_WIN - 1));
      ring[(d & (RNA_WIN - 1)) * LW + i] = x;
      nz[i] = x != 0.0f ? nz[i] | bit : nz[i] & ~bit;
      if (d >= 1) rmm_nb = rmm_hist[row - N + 1];
    }
    // every thread: a part of the live lanes' sums, terms t >= 1
    const RnaNwPart pt = rna_nw_part(m, tid, T);
    if (pt.p < pt.k) {
      float es = 0.0f, s2 = 0.0f;
      if (pt.l < m)
        rna_nw_inside_part(d, pt.l, N, 1 + pt.p, pt.k, extb, oneb, rmb,
                           rmmb, es, s2);
      part[tid] = es;
      part[T + tid] = s2;
    }
    __syncthreads();

    // phase 2: the owners finish span d (the parts in order p = 0 .. k-1)
    if (i < m) {
      float es = st.rm, s2 = 0.0f;    // term t = 0: rm(d, i) * ext(-1, i)
      for (int k = 0; k < pt.k; ++k) {
        es += part[k * pt.m32 + i];
        s2 += part[T + k * pt.m32 + i];
      }
      const float s1v =
          s.mbu1 * (rmm_nb + s1r[((d - 1) & 1) * (N + 1) + i + 1]);
      s1r[(d & 1) * (N + 1) + i] = s1v;
      s2r[(d & 1) * (N + 1) + i] = s2;
      ext[row] = st.epow + es;
      one[row] = st.rmmb + s1v + s2;
    }
    // every thread: span d + 1's windows (ring rows of spans <= d - 1)
    if (d + 1 < n)
      rna_nw_window_pass<true>(ring, LW, nz, kw, list + ((d + 1) & 1) * N,
                               count[(d + 1) & 1], d + 1, T, win);
    if (tid == 0) count[d & 1] = 0;       // span d's list, read at d - 1
    __syncthreads();
  }
}

// K8's shared memory at L lanes a block: kw | ring, 32 rows of L / G
// segments of G + 32 lanes | s2r, s1r, 4 rows of L / G segments of G + 1
// lanes each | the es and s2 parts, one a thread each.
static size_t contra_inside_cl_smem(int L) {
  const int segs = L / rna_cl_chunk(L);
  return sizeof(float) * (RNA_WIN * RNA_WIN + RNA_WIN * (L + 32 * segs) +
                          8 * (L + segs) + 2 * RNA_CL_THREADS);
}

__global__ void __launch_bounds__(RNA_CL_THREADS)
    contra_inside_cluster_kernel(CONTRA_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int L = N / C;
  const RnaClLayout y = {C, (int)cluster.block_rank(), L, rna_cl_chunk(L)};
  const int b = blockIdx.x / C;
  const int SW = y.G + 32;           // ring segment: a chunk + the next 32
  const int LW = L / y.G * SW;       // ring row
  const int TW = L / y.G * (y.G + 1);  // s1/s2 row: a chunk + the next one
  float* kw = smem;                        // 32 * 32
  float* ring = kw + RNA_WIN * RNA_WIN;    // RNA_WIN * LW, slot s & 31
  float* s2r = ring + RNA_WIN * LW;        // 4 * TW, row s & 3
  float* s1r = s2r + 4 * TW;               // 4 * TW, row s & 3
  float* part = s1r + 4 * TW;              // es | s2, RNA_CL_THREADS each

  const int tid = threadIdx.x;
  const long long base = (long long)b * N * N;
  for (int e = tid; e < RNA_WIN * LW + 8 * TW; e += RNA_CL_THREADS)
    ring[e] = 0.0f;                        // ring, s2r and s1r
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += RNA_CL_THREADS)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  const RnaScalars s = rna_scalars(scal + b * RNA_SCAL);
  const int n = ns[b];

  // the lane this thread owns (if il < L), its ring and s1/s2 columns, and
  // where its chunk is the halo of the chunk below
  const int il = tid, q = il / y.G, p = il % y.G;
  const int i = y.lane(il);
  const int col = q * SW + p, tcol = q * (y.G + 1) + p;
  int lo_rank = 0, lo_q = 0;
  const bool lo = il < L && y.next_chunk(q, -1, N, lo_rank, lo_q);
  float* lo_ring = lo ? cluster.map_shared_rank(ring, lo_rank) : nullptr;
  float* lo_s2r = lo ? cluster.map_shared_rank(s2r, lo_rank) : nullptr;
  float* lo_s1r = lo ? cluster.map_shared_rank(s1r, lo_rank) : nullptr;
  const int lo_col = lo_q * SW + y.G + p, lo_tcol = lo_q * (y.G + 1) + y.G;
  cluster.sync();   // every block zeroed before the first halo write

  RnaInsideLane st;
  float ins = 0.0f;     // c * JB of the span before, for the ring
  for (int d = 0; d < n; ++d) {
    if (d >= 1 && il < y.live(n, d - 1)) {
      const int slot = ((d - 1) & (RNA_WIN - 1)) * LW;
      ring[slot + col] = ins;
      if (lo && p < 32) lo_ring[slot + lo_col] = ins;
    }
    const int m = y.live(n, d);
    const RnaClPart pt = rna_cl_part(m, tid);
    if (pt.p < pt.k) {
      float es = 0.0f, s2 = 0.0f;
      if (pt.ll < m)
        rna_cl_bifurcation_part(base, d, y.lane(pt.ll), N, 1 + pt.p, pt.k,
                                ext, one, rm_hist, rmm_hist, es, s2);
      part[tid] = es;
      part[RNA_CL_THREADS + tid] = s2;
    }
    const long long row = base + (long long)d * N + i;
    if (il < m) {
      const float win = rna_window_inside(ring, kw, 0, d, col, LW);
      float two = JS[row] * win;
      two = two + STK[row] * ring[((d - 2) & (RNA_WIN - 1)) * LW + col + 1];
      two = two + B0R[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + col + 1];
      two = two + B0L[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + col + 2];
      two = two + I11[row] * ring[((d - 4) & (RNA_WIN - 1)) * LW + col + 2];
      const float s2_prev = d >= 2 ? s2r[((d - 2) & 3) * TW + tcol + 1] : 0.0f;
      const float c = rna_cl_inside_close(H[row] + two, s2_prev, MBC, ACC, s,
                                          row, d, st, close, rm_hist,
                                          rmm_hist);
      ins = c * JB[row];
    }
    __syncthreads();
    if (il < m) {
      // term t = 0: rm(d, i) * ext(-1, i) = rm(d, i)
      float es = st.rm, s2 = 0.0f;
      for (int k = 0; k < pt.k; ++k) {
        es += part[k * pt.m32 + il];
        s2 += part[RNA_CL_THREADS + k * pt.m32 + il];
      }
      const float rmm_nb =
          (d >= 1 && i + 1 < N) ? __ldcg(rmm_hist + row - N + 1) : 0.0f;
      const float s1v = s.mbu1 * (rmm_nb + s1r[((d - 1) & 3) * TW + tcol + 1]);
      s1r[(d & 3) * TW + tcol] = s1v;
      s2r[(d & 3) * TW + tcol] = s2;
      if (lo && p == 0) {
        lo_s1r[(d & 3) * TW + lo_tcol] = s1v;
        lo_s2r[(d & 3) * TW + lo_tcol] = s2;
      }
      ext[row] = st.epow + es;
      one[row] = st.rmmb + s1v + s2;
    }
    cluster.sync();
  }
}

extern "C" int rna_contra_inside(
    const float* H, const float* MBC, const float* ACC, const float* JS,
    const float* STK, const float* I11, const float* B0R, const float* B0L,
    const float* JB, const float* KW, const float* scal, const int* ns,
    float* close, float* ext, float* one, float* rm_hist, float* rmm_hist,
    int B, int N, void* stream) {
  if (!rna_shape_ok(N)) return (int)cudaErrorInvalidValue;
  if (N <= RNA_NARROW) {
    const int T = rna_nw_threads(contra_inside_kernel, contra_inside_smem, B,
                                 N);
    if (!T) return (int)cudaErrorInvalidConfiguration;
    return rna_launch(contra_inside_kernel, B, T, contra_inside_smem(N, T),
                      stream, CONTRA_INSIDE_ARGS);
  }
  const int C = rna_cl_size(contra_inside_cluster_kernel,
                            contra_inside_cl_smem, B, N);
  return rna_cl_launch(contra_inside_cluster_kernel, B, C,
                       C ? contra_inside_cl_smem(N / C) : 0, stream,
                       CONTRA_INSIDE_ARGS);
}

// The cluster size K8 takes for B sequences at N (0: none launches).
extern "C" int rna_contra_inside_cluster(int B, int N) {
  return rna_cl_size(contra_inside_cluster_kernel, contra_inside_cl_smem, B,
                     N);
}

// The block size K1 takes for B sequences at N <= 256 (0: none launches).
extern "C" int rna_contra_inside_threads(int B, int N) {
  return rna_nw_threads(contra_inside_kernel, contra_inside_smem, B, N);
}
