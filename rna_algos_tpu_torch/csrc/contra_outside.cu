// K2 and K9: CONTRAfold outside wavefront in scaled probability space ->
// bppo, at N = 32-1024 in steps of 32 and at N = 2048.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _outside8a2_kernel
// (:1054), _outside8a_kernel (:915) and _outside8_kernel (:787) at
// N <= 256 (K2), and pallas_fold_prob.py
// _contra_outside_prob_kernel_chunked (:841, called through
// _outside_call_prob_chunked, :1065) at N = 512, 1024 and 2048 (K9); the
// per-sequence maths is pallas_fold_prob.py:431-582
// (_contra_outside_prob_kernel).  For pair (i, j = i + d), spans
// decreasing from n - 1, with the merged outside tables:
//
//   base  = CLOSE * ACCB * ext(j+1, n-1)             (ACCB holds extL/Z*ebp)
//   two   = CLOSE * (JRB * window + STKO*g2(d+2, i-1) + B0RO*g2(d+3, i-1)
//                    + JRB*b0lo*g2(d+3, i-2) + I11O*g2(d+4, i-2))
//   window = sum_{a+b<=30} K[a][a+b+1] * g2(d+2+a+b, i-1-a)
//   pm    = sum_{t>=1} g(d+1+t, i) * one(t-1, j+1)
//   pm2   = g(d+1, i) + mbu1 * pm2(d+1, i)           (telescoped)
//   qa    = pm(d+1, i-1) + mbu1 * qa(d+1, i-1)       (telescoped diagonally)
//   mb    = CLOSE*ACCMB * (sum_{t>=1} pm2(d+t, i-t) * QONE(t, i)
//                          + sum_{t>=1} pm(d+t, i-t) * QONE(t, i) + qa)
//   bppo  = base + two + mb    (0 unless CLOSE > 0 and span >= min_span)
//   g2 = bppo * JSN / CLOSE,  g = bppo * MBC / CLOSE (inv_close guard)
//
// The TPU pre-rotates ONEP and EXTR by 2N - n (pallas_fold.py:691-709)
// because Mosaic cannot slice lanes dynamically, and its chunked kernel
// adds row chunks, SONEF delivery and a live-height ladder because of
// VMEM; here one(t-1, j+1) and ext(j+1, n-1) are indexed directly in the
// inside outputs.  K5 (turner_outside.cu) shares K2's layout and sums
// (narrow.cuh), K13 K9's (cluster.cuh) and common.cuh's window loop; K9's
// share of the sums and its bppo are cluster.cuh's, K2's narrow.cuh's and
// its own.
//
// K2 (N <= 256): K1's layout (contra_inside.cu, narrow.cuh): one block of
// T = 256-1,024 threads per sequence, thread i owning lane i, live cells
// only (a dead cell's bppo stays 0; its g, pm and pm2 are never read), two
// phases a span: (1) the owners compute the pair, base and 2-loop context
// from their table cells and the window of the phase before, while every
// thread takes a part of the live lanes' pm, sa and sbc terms (five loads
// a term, both walks together); (2) the owners add their parts and finish
// bppo, g, pm, pm2, qa and the g2 ring row (its slot held span d + 32,
// which no lane reads any more), while the block computes the next span's
// windows at the cells where bppo can be nonzero (CLOSE a positive normal
// float, the span reaching min_span).  The g2 ring keeps 32 slots, lanes
// offset by 32 so i-1-a never goes negative; the pm/pm2/g histories stay
// in global memory (L2).
//
// K9 (N = 512, 1024, 2048): a cluster of C blocks per sequence, as K8
// (cluster.cuh, contra_inside.cu): each block owns N / C lanes in chunks
// interleaved over the cluster and computes their live cells only (a dead
// cell's bppo stays 0; its g, pm and pm2 are never read); each live lane's
// pm, sa and sbc terms are spread over the block's idle threads and their
// parts summed by the lane's owner.  The ring holds 32 slots of, per
// chunk, the chunk below's last 32 lanes (written by that chunk's block
// through distributed shared memory) and its own; span d + 1's row is
// inserted at the start of span d, into the slot of span d + 33, which no
// lane reads then; qa's rows by span parity with one halo lane a chunk.
// One cluster barrier a span.

#include "cluster.cuh"
#include "launch.cuh"
#include "narrow.cuh"

#define CONTRA_OUTSIDE_PARAMS                                               \
  const float *__restrict__ CLOSE, const float *__restrict__ MBC,           \
      const float *__restrict__ ACCB, const float *__restrict__ ACCMB,      \
      const float *__restrict__ STKO, const float *__restrict__ I11O,       \
      const float *__restrict__ B0RO, const float *__restrict__ JRB,        \
      const float *__restrict__ JSN, const float *__restrict__ ONE,         \
      const float *__restrict__ QONE, const float *__restrict__ EXTR,       \
      const float *__restrict__ B0LO, const float *__restrict__ KW,         \
      const float *__restrict__ scal, const int *__restrict__ ns,           \
      float *bppo, float *pm_hist, float *pm2_hist, float *g_hist, int N,   \
      int min_span
#define CONTRA_OUTSIDE_ARGS                                                 \
  CLOSE, MBC, ACCB, ACCMB, STKO, I11O, B0RO, JRB, JSN, ONE, QONE, EXTR,     \
      B0LO, KW, scal, ns, bppo, pm_hist, pm2_hist, g_hist, N, min_span

// K2's shared memory at N lanes and T threads: kw | ring, 32 rows of 32 pad
// lanes + N | qab, 2 rows of N | win, N | the pm, sa and sbc parts, T
// each | the closable lists, 2 spans of N ints, and their two counts.
static size_t contra_outside_smem(int N, int T) {
  return sizeof(float) * (RNA_WIN * RNA_WIN + RNA_WIN * (N + 32) + 2 * N +
                          N + 3 * T) +
         sizeof(int) * (2 * N + 2 + 32 + N);
}

__global__ void __launch_bounds__(RNA_NW_MAX_THREADS)
    contra_outside_kernel(CONTRA_OUTSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  const int LW = N + 32;                  // ring row: 32 pad lanes + N
  float* kw = smem;                       // 32 * 32
  float* ring = kw + RNA_WIN * RNA_WIN;   // RNA_WIN * LW, slot s & 31
  float* qab = ring + RNA_WIN * LW;       // 2 * N, by span parity
  float* win = qab + 2 * N;               // N: the span's windows
  float* part = win + N;                  // pm | sa | sbc, T each
  int* list = (int*)(part + 3 * T);       // 2 * N
  int* count = list + 2 * N;              // 2
  unsigned* nz = (unsigned*)(count + 2);  // 32 + N: a lane's nonzero slots

  const long long base = (long long)b * N * N;
  for (int e = tid; e < RNA_WIN * LW + 3 * N; e += T)
    ring[e] = 0.0f;                       // ring, qab and win
  for (int e = tid; e < 32 + N; e += T) nz[e] = 0u;
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += T)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  if (tid < 2) count[tid] = 0;
  const float mbu1 = scal[b * RNA_SCAL + 2];
  const int n = ns[b];
  const float* gb = g_hist + base;
  const float* pmb = pm_hist + base;
  const float* pm2b = pm2_hist + base;
  const float* oneb = ONE + base;
  const float* qoneb = QONE + base;
  __syncthreads();

  // thread i owns lane i; lane i lives from span n - 1 - i down
  const int i = tid;
  const float b0lo = i < N ? B0LO[(long long)b * N + i] : 0.0f;
  float p2prev = 0.0f, g_prev = 0.0f;   // pm2(d+1, i), g(d+1, i)
  for (int d = n - 1; d >= 0; --d) {
    const int m = n - d;                  // live lanes 0 .. m-1
    const bool span_ok = d + 1 >= min_span;
    const long long row = base + (long long)d * N + i;
    // phase 1: list span d - 1's cells that can close
    if (d >= 1 && d >= min_span && i < m + 1 &&
        CLOSE[row - N] >= RNA_FLT_MIN)
      list[((d - 1) & 1) * N + atomicAdd(&count[(d - 1) & 1], 1)] = i;
    // the owners' pair and 2-loop context of span d, from its window (where
    // bppo can be nonzero) and the ring rows of spans > d; and the cells
    // phase 2 reads
    RnaOutsidePair pr = {};
    float two = 0.0f, accmb = 0.0f, jsn = 0.0f, mbc = 0.0f, pm_nb = 0.0f;
    if (i < m) {
      pr = rna_outside_pair(CLOSE, ACCB, EXTR, row, b, i, d, N);
      const float w = pr.pos && span_ok ? win[i] : 0.0f;
      const float jrb = JRB[row];
      two = jrb * w;
      two = two + STKO[row] * ring[((d + 2) & (RNA_WIN - 1)) * LW + 31 + i];
      two = two + B0RO[row] * ring[((d + 3) & (RNA_WIN - 1)) * LW + 31 + i];
      two = two + jrb * b0lo * ring[((d + 3) & (RNA_WIN - 1)) * LW + 30 + i];
      two = two + I11O[row] * ring[((d + 4) & (RNA_WIN - 1)) * LW + 30 + i];
      two = two * pr.c;
      accmb = ACCMB[row];
      jsn = JSN[row];
      mbc = MBC[row];
      if (i >= 1) pm_nb = pmb[(d + 1) * N + i - 1];   // pm(d+1, i-1)
    }
    // every thread: a part of the live lanes' sums
    const RnaNwPart pt = rna_nw_part(m, tid, T);
    if (pt.p < pt.k) {
      float pm = 0.0f, sa = 0.0f, sbc = 0.0f;
      if (pt.l < m)
        rna_nw_outside_part(d, pt.l, n, N, pt.p, pt.k, oneb, qoneb, gb, pmb,
                            pm2b, pm, sa, sbc);
      part[tid] = pm;
      part[T + tid] = sa;
      part[2 * T + tid] = sbc;
    }
    __syncthreads();

    // phase 2: the owners finish span d (the parts in order p = 0 .. k-1)
    if (i < m) {
      float pm = 0.0f, sa = 0.0f, sbc = 0.0f;
      for (int k = 0; k < pt.k; ++k) {
        pm += part[k * pt.m32 + i];
        sa += part[T + k * pt.m32 + i];
        sbc += part[2 * T + k * pt.m32 + i];
      }
      const float pm_new = span_ok ? pm : 0.0f;
      const float pm2_raw = g_prev + mbu1 * p2prev;
      p2prev = pm2_raw;
      const float pm2_new = span_ok ? pm2_raw : 0.0f;
      float qa = 0.0f;
      if (i >= 1)   // pm(d+1, i-1) + mbu1 * qa(d+1, i-1)
        qa = pm_nb + mbu1 * qab[((d + 1) & 1) * N + i - 1];
      const float acc_mb = pr.c * accmb;
      float bp = pr.base + two + acc_mb * (sa + sbc + qa);
      if (!(pr.pos && span_ok)) bp = 0.0f;
      bppo[row] = bp;
      // span d's g2 row, read from span d - 2 on (its slot held d + 32)
      const float x = bp * jsn * pr.inv_close;
      const unsigned bit = 1u << (d & (RNA_WIN - 1));
      ring[(d & (RNA_WIN - 1)) * LW + 32 + i] = x;
      nz[32 + i] = x != 0.0f ? nz[32 + i] | bit : nz[32 + i] & ~bit;
      g_prev = bp * mbc * pr.inv_close;
      g_hist[row] = g_prev;
      pm_hist[row] = pm_new;
      pm2_hist[row] = pm2_new;
      qab[(d & 1) * N + i] = qa;
    }
    // every thread: span d - 1's windows (ring rows of spans >= d + 1)
    if (d >= 1)
      rna_nw_window_pass<false>(ring, LW, nz, kw, list + ((d - 1) & 1) * N,
                                count[(d - 1) & 1], d - 1, T, win);
    if (tid == 0) count[d & 1] = 0;       // span d's list, read at d + 1
    __syncthreads();
  }
}

// K9's shared memory at L lanes a block: kw | ring, 32 rows of L / G
// segments of 32 + G lanes | qab, 2 rows of L / G segments of 1 + G lanes
// | the pm, sa and sbc parts, one a thread each.
static size_t contra_outside_cl_smem(int L) {
  const int segs = L / rna_cl_chunk(L);
  return sizeof(float) * (RNA_WIN * RNA_WIN + RNA_WIN * (L + 32 * segs) +
                          2 * (L + segs) + 3 * RNA_CL_THREADS);
}

__global__ void __launch_bounds__(RNA_CL_THREADS)
    contra_outside_cluster_kernel(CONTRA_OUTSIDE_PARAMS) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int L = N / C;
  const RnaClLayout y = {C, (int)cluster.block_rank(), L, rna_cl_chunk(L)};
  const int b = blockIdx.x / C;
  const int SW = 32 + y.G;           // ring segment: the chunk below's last
                                     // 32 lanes + a chunk
  const int LW = L / y.G * SW;       // ring row
  const int TW = L / y.G * (1 + y.G);  // qab row: one lane below + a chunk
  float* kw = smem;                        // 32 * 32
  float* ring = kw + RNA_WIN * RNA_WIN;    // RNA_WIN * LW, slot s & 31
  float* qab = ring + RNA_WIN * LW;        // 2 * TW, row s & 1
  float* part = qab + 2 * TW;              // pm | sa | sbc

  const int tid = threadIdx.x;
  const long long base = (long long)b * N * N;
  for (int e = tid; e < RNA_WIN * LW + 2 * TW; e += RNA_CL_THREADS)
    ring[e] = 0.0f;                        // ring and qab
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += RNA_CL_THREADS)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  const float mbu1 = scal[b * RNA_SCAL + 2];
  const int n = ns[b];

  // the lane this thread owns (if il < L), its ring and qab columns, and
  // where its chunk is the halo of the chunk above
  const int il = tid, q = il / y.G, p = il % y.G;
  const int i = y.lane(il);
  const int col = q * SW + 32 + p, qcol = q * (1 + y.G) + 1 + p;
  int hi_rank = 0, hi_q = 0;
  const bool hi = il < L && y.next_chunk(q, 1, N, hi_rank, hi_q);
  float* hi_ring = hi ? cluster.map_shared_rank(ring, hi_rank) : nullptr;
  float* hi_qab = hi ? cluster.map_shared_rank(qab, hi_rank) : nullptr;
  const int hi_col = hi_q * SW + p - (y.G - 32), hi_qcol = hi_q * (1 + y.G);
  const float b0lo = il < L ? B0LO[(long long)b * N + i] : 0.0f;
  float p2prev = 0.0f, g_prev = 0.0f, g2 = 0.0f;
  cluster.sync();   // every block zeroed before the first halo write

  for (int d = n - 1; d >= 0; --d) {
    if (d + 1 < n && il < y.live(n, d + 1)) {
      const int slot = ((d + 1) & (RNA_WIN - 1)) * LW;
      ring[slot + col] = g2;
      if (hi && p >= y.G - 32) hi_ring[slot + hi_col] = g2;
    }
    const bool span_ok = d + 1 >= min_span;
    const int m = y.live(n, d);
    const RnaClPart pt = rna_cl_part(m, tid);
    if (pt.p < pt.k) {
      float pm = 0.0f, sa = 0.0f, sbc = 0.0f;
      if (pt.ll < m)
        rna_cl_outside_part(base, d, y.lane(pt.ll), n, N, pt.p, pt.k, ONE,
                            QONE, g_hist, pm_hist, pm2_hist, pm, sa, sbc);
      part[tid] = pm;
      part[RNA_CL_THREADS + tid] = sa;
      part[2 * RNA_CL_THREADS + tid] = sbc;
    }
    const long long row = base + (long long)d * N + i;
    RnaOutsidePair pr = {};
    float two = 0.0f;
    if (il < m) {
      pr = rna_outside_pair(CLOSE, ACCB, EXTR, row, b, i, d, N);
      const int w = col - 32;   // the ring helpers' lane: 32 + w - 1 - a
      const float win = rna_window_outside(ring, kw, 0, d, w, LW);
      const float jrb = JRB[row];
      two = jrb * win;
      two = two + STKO[row] * ring[((d + 2) & (RNA_WIN - 1)) * LW + 31 + w];
      two = two + B0RO[row] * ring[((d + 3) & (RNA_WIN - 1)) * LW + 31 + w];
      two = two + jrb * b0lo * ring[((d + 3) & (RNA_WIN - 1)) * LW + 30 + w];
      two = two + I11O[row] * ring[((d + 4) & (RNA_WIN - 1)) * LW + 30 + w];
    }
    __syncthreads();
    if (il < m) {
      float pm = 0.0f, sa = 0.0f, sbc = 0.0f;
      for (int k = 0; k < pt.k; ++k) {
        pm += part[k * pt.m32 + il];
        sa += part[RNA_CL_THREADS + k * pt.m32 + il];
        sbc += part[2 * RNA_CL_THREADS + k * pt.m32 + il];
      }
      float qa;
      g2 = rna_cl_outside_bppo(pr, two * pr.c, span_ok, mbu1, p2prev, g_prev,
                               pm, sa, sbc,
                               qab[((d + 1) & 1) * TW + qcol - 1], ACCMB,
                               MBC, JSN, row, i, N, bppo, pm_hist, pm2_hist,
                               g_hist, qa);
      qab[(d & 1) * TW + qcol] = qa;
      if (hi && p == y.G - 1) hi_qab[(d & 1) * TW + hi_qcol] = qa;
    }
    cluster.sync();
  }
}

extern "C" int rna_contra_outside(
    const float* CLOSE, const float* MBC, const float* ACCB,
    const float* ACCMB, const float* STKO, const float* I11O,
    const float* B0RO, const float* JRB, const float* JSN, const float* ONE,
    const float* QONE, const float* EXTR, const float* B0LO, const float* KW,
    const float* scal, const int* ns, float* bppo, float* pm_hist,
    float* pm2_hist, float* g_hist, int B, int N, int min_span,
    void* stream) {
  if (!rna_shape_ok(N)) return (int)cudaErrorInvalidValue;
  if (N <= RNA_NARROW) {
    const int T = rna_nw_threads(contra_outside_kernel, contra_outside_smem,
                                 B, N);
    if (!T) return (int)cudaErrorInvalidConfiguration;
    return rna_launch(contra_outside_kernel, B, T, contra_outside_smem(N, T),
                      stream, CONTRA_OUTSIDE_ARGS);
  }
  const int C = rna_cl_size(contra_outside_cluster_kernel,
                            contra_outside_cl_smem, B, N);
  return rna_cl_launch(contra_outside_cluster_kernel, B, C,
                       C ? contra_outside_cl_smem(N / C) : 0, stream,
                       CONTRA_OUTSIDE_ARGS);
}

// The cluster size K9 takes for B sequences at N (0: none launches).
extern "C" int rna_contra_outside_cluster(int B, int N) {
  return rna_cl_size(contra_outside_cluster_kernel, contra_outside_cl_smem,
                     B, N);
}

// The block size K2 takes for B sequences at N <= 256 (0: none launches).
extern "C" int rna_contra_outside_threads(int B, int N) {
  return rna_nw_threads(contra_outside_kernel, contra_outside_smem, B, N);
}
