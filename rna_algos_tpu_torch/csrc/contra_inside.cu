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
// The window loop, the rm/rmmb update and K1's bifurcation sums are the
// helpers of common.cuh that K4/K12 (turner_inside.cu) share; K8's close
// and its share of the sums are cluster.cuh's.
//
// K1 (N <= 256): one block per sequence, one thread per lane, the whole
// span loop inside the block (launch.cuh's narrow entry), bound by the
// latency of n dependent spans, each ending in __syncthreads because span
// d reads lanes of earlier spans.  The 2-loop window is a 32-slot ring of
// inserted rows c(s, .) (slot s & 31) in shared memory, contracted in FP32
// with FMA against the per-sequence 32 x 32 banded matrix in shared
// memory; the TPU's SIGL aging pass is unnecessary because the matrix
// already carries each cell's sigma power.  The rm/rmmb histories and the
// ext/one tables stay in global memory and are read coalesced along
// anti-diagonals.  Buffers this kernel writes are never read through the
// read-only path.  Rows at or past n are never written: the wrapper passes
// zeroed outputs.
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

__global__ void contra_inside_kernel(CONTRA_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 33;                  // ring row: N lanes + window pad
  const int b = blockIdx.x;
  // ring | kw | s2r | s1r
  float* kw = smem + RNA_WIN * LW;        // 32 * 32
  float* s2r = kw + RNA_WIN * RNA_WIN;    // 2 * (N + 1), by span parity
  float* s1r = s2r + 2 * (N + 1);         // 2 * (N + 1), by span parity
  float* ring = smem;                     // RNA_WIN * LW

  const int tid = threadIdx.x;
  const int T = N;                        // one thread per lane
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

  RnaInsideLane st;
  float c;
  const int i = tid;
  for (int d = 0; d < n; ++d) {
    // phase A: close from the window ring and the s2 ring (spans < d)
    {
      const long long row = base + (long long)d * N + i;
      const float win = rna_window_inside(ring, kw, 0, d, i, LW);
      float two = JS[row] * win;
      two = two + STK[row] * ring[((d - 2) & (RNA_WIN - 1)) * LW + i + 1];
      two = two + B0R[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 1];
      two = two + B0L[row] * ring[((d - 3) & (RNA_WIN - 1)) * LW + i + 2];
      two = two + I11[row] * ring[((d - 4) & (RNA_WIN - 1)) * LW + i + 2];
      c = rna_inside_close(H[row] + two, MBC, ACC, s2r, s, row, d, i, N, st,
                           close, rm_hist, rmm_hist);
    }
    __syncthreads();

    // phase B: insert this span into the ring; bifurcation sums over the
    // rm/rmmb rows of spans <= d (all lanes now visible)
    {
      const long long row = base + (long long)d * N + i;
      ring[(d & (RNA_WIN - 1)) * LW + i] = c * JB[row];
      rna_inside_bifurcation(st, s.mbu1, base, row, d, i, N, ext, one,
                             rm_hist, rmm_hist, s1r, s2r);
    }
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
    const size_t shmem = sizeof(float) * (RNA_WIN * RNA_WIN + 4 * (N + 1) +
                                          RNA_WIN * (N + 33));
    return rna_launch(contra_inside_kernel, B, N, shmem, stream,
                      CONTRA_INSIDE_ARGS);
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
