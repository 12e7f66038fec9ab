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
// inside outputs.  The window loop, base, pm, pm2, qa and the multibranch
// context are the helpers of common.cuh that K5/K13 (turner_outside.cu)
// share; K9's share of the sums and its bppo are cluster.cuh's.
//
// K2 (N <= 256): bound and design as K1 (contra_inside.cu): the latency of
// n dependent spans and each lane's serial O(n) multibranch sums (pm over
// one column, sa/sbc over one anti-diagonal: five loads a term); one block
// per sequence, one thread per lane, the g2 window as a 32-slot ring
// (lanes offset by 32 so i-1-a never goes negative) in shared memory,
// contracted in FP32 against the per-sequence banded matrix, the pm/pm2/g
// histories in global memory.  Rows at or past n stay the zeros the
// wrapper passes.
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

__global__ void contra_outside_kernel(CONTRA_OUTSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 32;                  // ring row: 32 pad lanes + N
  const int b = blockIdx.x;
  // ring | kw | qab
  float* kw = smem + RNA_WIN * LW;        // 32 * 32
  float* qab = kw + RNA_WIN * RNA_WIN;    // 2 * N, by span parity
  float* ring = smem;                     // RNA_WIN * LW

  const int tid = threadIdx.x;
  const int T = N;                        // one thread per lane
  const long long base = (long long)b * N * N;

  for (int e = tid; e < RNA_WIN * LW; e += T) ring[e] = 0.0f;
  for (int e = tid; e < RNA_WIN * RNA_WIN; e += T)
    kw[e] = KW[(long long)b * RNA_WIN * RNA_WIN + e];
  for (int e = tid; e < 2 * N; e += T) qab[e] = 0.0f;
  const float mbu1 = scal[b * RNA_SCAL + 2];
  const int n = ns[b];
  const int i = tid;
  const float b0lo = B0LO[(long long)b * N + i];
  float p2prev = 0.0f, g2;
  __syncthreads();

  for (int d = n - 1; d >= 0; --d) {
    const bool span_ok = d + 1 >= min_span;

    // phase A: everything but the ring insert (reads spans > d only)
    {
      const long long row = base + (long long)d * N + i;
      const RnaOutsidePair p =
          rna_outside_pair(CLOSE, ACCB, EXTR, row, b, i, d, N);
      const float win = rna_window_outside(ring, kw, 0, d, i, LW);
      const float jrb = JRB[row];
      float two = jrb * win;
      two = two + STKO[row] * ring[((d + 2) & (RNA_WIN - 1)) * LW + 31 + i];
      two = two + B0RO[row] * ring[((d + 3) & (RNA_WIN - 1)) * LW + 31 + i];
      two = two + jrb * b0lo * ring[((d + 3) & (RNA_WIN - 1)) * LW + 30 + i];
      two = two + I11O[row] * ring[((d + 4) & (RNA_WIN - 1)) * LW + 30 + i];
      g2 = rna_outside_bppo(p, two * p.c, span_ok, mbu1, p2prev, ACCMB, MBC,
                            JSN, ONE, QONE, base, row, d, i, n, N, bppo,
                            pm_hist, pm2_hist, g_hist, qab);
    }
    __syncthreads();

    // phase B: insert g2 (its slot held span d + 32, read above)
    ring[(d & (RNA_WIN - 1)) * LW + 32 + i] = g2;
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
    const size_t shmem = sizeof(float) * (RNA_WIN * RNA_WIN + 2 * N +
                                          RNA_WIN * (N + 32));
    return rna_launch(contra_outside_kernel, B, N, shmem, stream,
                      CONTRA_OUTSIDE_ARGS);
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
