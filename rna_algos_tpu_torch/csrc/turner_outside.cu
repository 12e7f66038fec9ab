// K5 and K13: Turner outside wavefront in scaled probability space ->
// bppo, at N = 32-1024 in steps of 32.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _turner_outside8m_kernel
// (:2537) and _turner_outside8_kernel (:2349) at N <= 256 (K5), and
// pallas_fold_prob.py _turner_outside_prob_kernel_chunked (:1985, called
// through _turner_prob_run_body_chunked, :2158) at N = 512 and 1024 (K13);
// the per-sequence maths is pallas_fold_prob.py:1578-1704
// (_turner_outside_prob_kernel).  The TPU's row chunks, SONEF delivery and
// live-height ladder do not carry over: one and ext are indexed directly
// in the inside outputs.  The recurrences are K2's (contra_outside.cu)
// with Turner's scalars; only the 2-loop context differs.  For pair
// (i, j = i + d), spans decreasing from n - 1, with the merged tables of
// pallas_fold_prob8._turner_merge_outside:
//
//   two = CLOSE * (TMI1C * winI(g2*TMO1) + AUGT * winB(g2)
//                  + TMI2C * win2(g2*TMO2)
//                  + TMI3C * (LENI'[3,2] * gt3(d+7, i-3)
//                             + LENI'[2,3] * gt3(d+7, i-4))
//                  + SP00*g2(d+2, i-1) + SP01*g2(d+3, i-1)
//                  + SP10*g2(d+3, i-2) + SP11*g2(d+4, i-2)
//                  + SP12*g2(d+5, i-2) + SP21*g2(d+5, i-3)
//                  + SP22*g2(d+6, i-3))
//   win_K(x) = sum_{a, r} K[a][r] * x(d+1+r, i-1-a)
//   g2 = bppo * AUGT / CLOSE (inserted after the span), gt3 = g2 * TMO3
//
// and base, pm, pm2, qa and the multibranch context K2's, through
// common.cuh's pair and K2's sums of narrow.cuh (K13: K9's sums of
// cluster.cuh).  The window matrices and their non-zero arms are K4's
// (turner_inside.cu).
//
// K5 (N <= 256): K2's layout (contra_outside.cu, narrow.cuh): one block
// of T = 256-1,024 threads per sequence, T from the batch and the card,
// thread i owning lane i, live cells only (a dead cell's bppo stays 0;
// its g, pm and pm2 are never read), two phases a span: (1) the owners
// compute the pair, base and 2-loop context from their 18 table cells, the
// three window sums of the phase before, the TM3 ring and the seven
// special cells, while every thread takes a part of the live lanes' pm,
// sa and sbc terms; (2) the owners add their parts and finish bppo, g, pm,
// pm2, qa and insert g2 and its products into the rings (slot d & 31 held
// span d + 32, which no lane reads any more; the TM3 slot d & 7 span
// d + 8), while the block computes the next span's three windows
// (rna_nw_turner_window_pass) at the cells where bppo can be nonzero
// (CLOSE a positive normal float, the span reaching min_span).  What
// bounds it is K2's: the latency of n dependent spans, in which one thread
// a lane walked its window and its O(n) multibranch sums alone (PR 2's
// form, PERF.md).  Three 32-slot rings (g2, g2*TMO1, g2*TMO2) and an
// 8-slot ring of g2*TMO3 (read at age 6 only), lanes offset by 32 so
// i-1-a never goes negative, take 104 x (N + 32) floats of dynamic shared
// memory beside the three 32 x 32 matrices (~149 KB a block at N = 256,
// ~87 KB at N = 128).  The pm/pm2/g histories stay in global memory (L2);
// pm2 and qa are telescoped (flush-safe).
//
// K13 (N = 512, 1024): a cluster of C blocks per sequence, as K9
// (cluster.cuh, contra_outside.cu) and with K12's cluster sizes and design
// (turner_inside.cu): each block owns N / C lanes in chunks interleaved over
// the cluster and computes their live cells only (a dead cell's bppo stays
// 0; its g, pm and pm2 are never read); each live lane's pm, sa and sbc
// terms are spread over the block's threads that own no lane, and their
// parts summed by the lane's owner, who meanwhile computes the 2-loop
// context from its 18 table cells and ext(j + 1, n - 1), staged a span
// ahead with cp.async (the first design, the owners taking parts and
// reading the tables in the span, ran 1.6x / 1.5x slower at N = 512 B = 32
// / 1024 B = 16 on an H100 80GB HBM3 at 700 W, PERF.md).  The four rings
// keep their slots of, per chunk, the chunk below's last 32 lanes (the
// window reads down to lane i - 31), written by that chunk's block through
// distributed shared memory, and its own; span d + 1's rows are inserted
// at the start of span d, into the slot of span d + 33 (the 32-slot rings,
// which read spans d + 2 .. d + 32) and of span d + 9 (the TM3 ring, which
// reads span d + 7 only), which no lane reads then; qa's rows by span
// parity with one halo lane a chunk.  One cluster barrier a span.

#include "cluster.cuh"
#include "launch.cuh"
#include "narrow.cuh"

// pallas_fold_prob8.TURNER_OUTSIDE_TABLES order
enum {
  TO_CLOSE, TO_MBC, TO_ACCB, TO_ACCMB, TO_AUGT, TO_TMI1C, TO_TMI2C, TO_TMI3C,
  TO_SP00, TO_SP01, TO_SP10, TO_SP11, TO_SP12, TO_SP21, TO_SP22,
  TO_TMO1, TO_TMO2, TO_TMO3, TO_COUNT
};

struct TurnerOutsideTables {
  const float* t[TO_COUNT];
};

#define TURNER_RING_ROWS (3 * RNA_WIN + RNA_TM3_SLOTS)

#define TURNER_OUTSIDE_PARAMS                                               \
  TurnerOutsideTables tabs, const float *__restrict__ ONE,                  \
      const float *__restrict__ QONE, const float *__restrict__ EXTR,       \
      const float *__restrict__ KT, const float *__restrict__ scal,         \
      const int *__restrict__ ns, float *bppo, float *pm_hist,              \
      float *pm2_hist, float *g_hist, int N, int min_span
#define TURNER_OUTSIDE_ARGS                                                 \
  tabs, ONE, QONE, EXTR, KT, scal, ns, bppo, pm_hist, pm2_hist, g_hist, N,  \
      min_span

// A 32-slot ring's cell of `span` at `lane`, 32 pad columns first (rows
// LW floats).
#define RING(buf, span, lane) \
  (buf)[((span) & (RNA_WIN - 1)) * LW + 32 + (lane)]

// K5's shared memory at N lanes and T threads: kt | the rings, 104 rows of
// 32 pad lanes + N | qab, 2 rows of N | win, 3 rows of N | the pm, sa and
// sbc parts, T each | the closable lists, 2 spans of N ints, and their two
// counts | nz, 32 + N.
static size_t turner_outside_smem(int N, int T) {
  return sizeof(float) * (3 * RNA_WIN * RNA_WIN +
                          TURNER_RING_ROWS * (N + 32) + 2 * N + 3 * N +
                          3 * T) +
         sizeof(int) * (2 * N + 2 + 32 + N);
}

__global__ void __launch_bounds__(RNA_NW_MAX_THREADS)
    turner_outside_kernel(TURNER_OUTSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  const int LW = N + 32;                       // ring row: 32 pad lanes + N
  float* kt = smem;                            // KI | KB | K2, 32 x 32 each
  float* ringB = kt + 3 * RNA_WIN * RNA_WIN;   // g2         (KB, specials)
  float* ringI = ringB + RNA_WIN * LW;         // g2 * TMO1  (KI)
  float* ring2 = ringI + RNA_WIN * LW;         // g2 * TMO2  (K2)
  float* ring3 = ring2 + RNA_WIN * LW;         // g2 * TMO3, 8 slots
  float* qab = ring3 + RNA_TM3_SLOTS * LW;     // 2 * N, by span parity
  float* win = qab + 2 * N;                    // winI | winB | win2, N each
  float* part = win + 3 * N;                   // pm | sa | sbc, T each
  int* list = (int*)(part + 3 * T);            // 2 * N
  int* count = list + 2 * N;                   // 2
  unsigned* nz = (unsigned*)(count + 2);       // 32 + N: nonzero slots of g2

  const long long base = (long long)b * N * N;
  const float* const* tab = tabs.t;
  for (int e = tid; e < TURNER_RING_ROWS * LW + 5 * N; e += T)
    ringB[e] = 0.0f;                           // the rings, qab and win
  for (int e = tid; e < 32 + N; e += T) nz[e] = 0u;
  for (int e = tid; e < 3 * RNA_WIN * RNA_WIN; e += T)
    kt[e] = KT[(long long)b * 3 * RNA_WIN * RNA_WIN + e];
  if (tid < 2) count[tid] = 0;
  const float* sc = scal + b * RNA_TSCAL;
  const float mbu1 = sc[2];
  const float leni32 = sc[4], leni23 = sc[5];
  const int n = ns[b];
  const float* gb = g_hist + base;
  const float* pmb = pm_hist + base;
  const float* pm2b = pm2_hist + base;
  const float* oneb = ONE + base;
  const float* qoneb = QONE + base;
  __syncthreads();

  // thread i owns lane i; lane i lives from span n - 1 - i down
  const int i = tid;
  float p2prev = 0.0f, g_prev = 0.0f;   // pm2(d+1, i), g(d+1, i)
  for (int d = n - 1; d >= 0; --d) {
    const int m = n - d;                       // live lanes 0 .. m-1
    const bool span_ok = d + 1 >= min_span;
    const long long row = base + (long long)d * N + i;
    // phase 1: list span d - 1's cells that can close, their CLOSE loaded
    // with the owners' cells and appended after the owners' work (1-2% of
    // K5 on an H100, PERF.md, PR 11)
    const bool lists = d >= 1 && d >= min_span && i < m + 1;
    const float close_next = lists ? tab[TO_CLOSE][row - N] : 0.0f;
    // the owners' pair and 2-loop context of span d, from its windows
    // (where bppo can be nonzero) and the rings of spans > d; and the cells
    // phase 2 reads
    RnaOutsidePair pr = {};
    float two = 0.0f, accmb = 0.0f, mbc = 0.0f, augt = 0.0f, tmo1 = 0.0f,
          tmo2 = 0.0f, tmo3 = 0.0f, pm_nb = 0.0f;
    if (i < m) {
      pr = rna_outside_pair(tab[TO_CLOSE], tab[TO_ACCB], EXTR, row, b, i, d,
                            N);
      const bool can = pr.pos && span_ok;
      augt = tab[TO_AUGT][row];
      const int s3 = ((d + 1 + RNA_TM3_AGE) & (RNA_TM3_SLOTS - 1)) * LW + 32;
      const float tm3 = leni32 * ring3[s3 + i - 3] + leni23 * ring3[s3 + i - 4];
      two = tab[TO_TMI1C][row] * (can ? win[i] : 0.0f);
      two = two + augt * (can ? win[N + i] : 0.0f);
      two = two + tab[TO_TMI2C][row] * (can ? win[2 * N + i] : 0.0f);
      two = two + tab[TO_TMI3C][row] * tm3;
      two = two + tab[TO_SP00][row] * RING(ringB, d + 2, i - 1);
      two = two + tab[TO_SP01][row] * RING(ringB, d + 3, i - 1);
      two = two + tab[TO_SP10][row] * RING(ringB, d + 3, i - 2);
      two = two + tab[TO_SP11][row] * RING(ringB, d + 4, i - 2);
      two = two + tab[TO_SP12][row] * RING(ringB, d + 5, i - 2);
      two = two + tab[TO_SP21][row] * RING(ringB, d + 5, i - 3);
      two = two + tab[TO_SP22][row] * RING(ringB, d + 6, i - 3);
      two = two * pr.c;
      accmb = tab[TO_ACCMB][row];
      mbc = tab[TO_MBC][row];
      tmo1 = tab[TO_TMO1][row];
      tmo2 = tab[TO_TMO2][row];
      tmo3 = tab[TO_TMO3][row];
      if (i >= 1) pm_nb = pmb[(d + 1) * N + i - 1];   // pm(d+1, i-1)
    }
    if (lists && close_next >= RNA_FLT_MIN)
      list[((d - 1) & 1) * N + atomicAdd(&count[(d - 1) & 1], 1)] = i;
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
      // span d's rows, read from span d - 2 on
      const float g2 = bp * augt * pr.inv_close;
      const unsigned bit = 1u << (d & (RNA_WIN - 1));
      RING(ringB, d, i) = g2;
      RING(ringI, d, i) = g2 * tmo1;
      RING(ring2, d, i) = g2 * tmo2;
      ring3[(d & (RNA_TM3_SLOTS - 1)) * LW + 32 + i] = g2 * tmo3;
      nz[32 + i] = g2 != 0.0f ? nz[32 + i] | bit : nz[32 + i] & ~bit;
      g_prev = bp * mbc * pr.inv_close;
      g_hist[row] = g_prev;
      pm_hist[row] = pm_new;
      pm2_hist[row] = pm2_new;
      qab[(d & 1) * N + i] = qa;
    }
    // every thread: span d - 1's windows (ring rows of spans >= d + 1)
    if (d >= 1)
      rna_nw_turner_window_pass<false>(ringB, LW, nz, kt,
                                       list + ((d - 1) & 1) * N,
                                       count[(d - 1) & 1], d - 1, T, N, win);
    if (tid == 0) count[d & 1] = 0;            // span d's list, read at d + 1
    __syncthreads();
  }
}

// K13's shared memory at L lanes a block: kt | the rings, 104 rows of
// L / G segments of 32 + G lanes | qab, 2 rows of L / G segments of 1 + G
// lanes | the pm, sa and sbc parts, one a thread each | the staged table
// cells, 2 spans x (18 tables + EXTR) x L lanes.
static size_t turner_outside_cl_smem(int L) {
  const int segs = L / rna_cl_chunk(L);
  return sizeof(float) *
         (3 * RNA_WIN * RNA_WIN + TURNER_RING_ROWS * (L + 32 * segs) +
          2 * (L + segs) + 3 * RNA_CL_THREADS + 2 * (TO_COUNT + 1) * L);
}

__global__ void __launch_bounds__(RNA_CL_THREADS)
    turner_outside_cluster_kernel(TURNER_OUTSIDE_PARAMS) {
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
  const int RW = RNA_WIN * LW;       // a 32-slot ring
  const int SS = (TO_COUNT + 1) * L;   // a span's staged cells
  float* kt = smem;                  // KI | KB | K2, 32 x 32 each
  float* ringB = kt + 3 * RNA_WIN * RNA_WIN;   // g2         (KB, specials)
  float* ringI = ringB + RW;                   // g2 * TMO1  (KI)
  float* ring2 = ringI + RW;                   // g2 * TMO2  (K2)
  float* ring3 = ring2 + RW;                   // g2 * TMO3, 8 slots
  float* qab = ring3 + RNA_TM3_SLOTS * LW;     // 2 * TW, row s & 1
  float* part = qab + 2 * TW;                  // pm | sa | sbc
  float* stage = part + 3 * RNA_CL_THREADS;    // [span & 1][table][lane]
  const float* kI = kt;
  const float* kB = kt + RNA_WIN * RNA_WIN;
  const float* k2 = kt + 2 * RNA_WIN * RNA_WIN;

  const int tid = threadIdx.x;
  const long long base = (long long)b * N * N;
  const float* const* T = tabs.t;
  for (int e = tid; e < TURNER_RING_ROWS * LW + 2 * TW; e += RNA_CL_THREADS)
    ringB[e] = 0.0f;                       // the rings and qab
  for (int e = tid; e < 3 * RNA_WIN * RNA_WIN; e += RNA_CL_THREADS)
    kt[e] = KT[(long long)b * 3 * RNA_WIN * RNA_WIN + e];
  const float* sc = scal + b * RNA_TSCAL;
  const float mbu1 = sc[2];
  const float leni32 = sc[4], leni23 = sc[5];
  const int n = ns[b];

  // the lane this thread owns (if il < L), its ring and qab columns, and
  // where its chunk is the halo of the chunk above (the rings at the same
  // offsets from the neighbour's ringB)
  const int il = tid, q = il / y.G, p = il % y.G;
  const int i = y.lane(il);
  const int col = q * SW + 32 + p, qcol = q * (1 + y.G) + 1 + p;
  int hi_rank = 0, hi_q = 0;
  const bool hi = il < L && y.next_chunk(q, 1, N, hi_rank, hi_q);
  float* hi_ring = hi ? cluster.map_shared_rank(ringB, hi_rank) : nullptr;
  float* hi_qab = hi ? cluster.map_shared_rank(qab, hi_rank) : nullptr;
  const int hi_col = hi_q * SW + p - (y.G - 32), hi_qcol = hi_q * (1 + y.G);
  const float* extr = EXTR + (long long)b * 2 * N + i + 1;   // + d
  // stage span d's cells of lane i: the 18 tables and ext(i + d + 1, n - 1)
  auto stage_span = [&](int d) {
    float* dst = stage + (d & 1) * SS + il;
    rna_cl_stage(dst, L, T, TO_COUNT, base + (long long)d * N + i);
    __pipeline_memcpy_async(dst + TO_COUNT * L, extr + d, sizeof(float));
    __pipeline_commit();
  };
  if (n >= 1 && il < y.live(n, n - 1)) stage_span(n - 1);
  float p2prev = 0.0f, g_prev = 0.0f;
  // g2, g2 * TMO1, g2 * TMO2, g2 * TMO3 of the span after, for the rings
  float gB = 0.0f, gI = 0.0f, g2 = 0.0f, g3 = 0.0f;
  cluster.sync();   // every block zeroed before the first halo write

  for (int d = n - 1; d >= 0; --d) {
    if (d + 1 < n && il < y.live(n, d + 1)) {
      const int slot = ((d + 1) & (RNA_WIN - 1)) * LW;
      const int slot3 = ((d + 1) & (RNA_TM3_SLOTS - 1)) * LW;
      ringB[slot + col] = gB;
      ringI[slot + col] = gI;
      ring2[slot + col] = g2;
      ring3[slot3 + col] = g3;
      if (hi && p >= y.G - 32) {
        hi_ring[slot + hi_col] = gB;
        hi_ring[RW + slot + hi_col] = gI;
        hi_ring[2 * RW + slot + hi_col] = g2;
        hi_ring[3 * RW + slot3 + hi_col] = g3;
      }
    }
    const bool span_ok = d + 1 >= min_span;
    const int m = y.live(n, d);
    const RnaClPart pt = rna_cl_part_free(m, tid, L);
    if (pt.p < pt.k) {
      float pm = 0.0f, sa = 0.0f, sbc = 0.0f;
      if (pt.ll < m)
        rna_cl_outside_part(base, d, y.lane(pt.ll), n, N, pt.p, pt.k, ONE,
                            QONE, g_hist, pm_hist, pm2_hist, pm, sa, sbc);
      part[tid - L] = pm;
      part[RNA_CL_THREADS + tid - L] = sa;
      part[2 * RNA_CL_THREADS + tid - L] = sbc;
    }
    const long long row = base + (long long)d * N + i;
    const float* v = stage + (d & 1) * SS + il;   // span d's staged cells
#define TV(k) v[(k) * L]
    RnaOutsidePair pr = {};
    float two = 0.0f, pm_nb = 0.0f;
    if (il < m) {
      // pm(d + 1, i - 1), written the span after
      if (i >= 1 && d + 1 <= n - 1) pm_nb = __ldcg(pm_hist + row + N - 1);
      __pipeline_wait_prior(0);
      // rna_outside_pair on the staged cells
      pr.c = TV(TO_CLOSE);
      pr.pos = pr.c >= RNA_FLT_MIN;
      pr.inv_close = pr.pos ? 1.0f / pr.c : 0.0f;
      pr.base = pr.c * TV(TO_ACCB) * TV(TO_COUNT);
      // K5's 2-loop context (turner_outside_kernel) at lane w of the ring
      // helpers, whose column is 32 + w
      const int w = col - 32;
      const float winI = rna_window_outside(ringI, kI, 2, d, w, LW);
      float winB = 0.0f;
      for (int r = 1; r < RNA_WIN; ++r)
        winB = fmaf(kB[r], RING(ringB, d + 1 + r, w - 1), winB);
      for (int a = 1; a < RNA_WIN - 1; ++a)
        winB = fmaf(kB[a * RNA_WIN + a + 1],
                    RING(ringB, d + 2 + a, w - 1 - a), winB);
      float win2 = 0.0f;
      for (int r = 2; r < RNA_WIN; ++r)
        win2 = fmaf(k2[RNA_WIN + r], RING(ring2, d + 1 + r, w - 2), win2);
      for (int a = 2; a < RNA_WIN - 2; ++a)
        win2 = fmaf(k2[a * RNA_WIN + a + 2],
                    RING(ring2, d + 3 + a, w - 1 - a), win2);
      const int s3 = ((d + 1 + RNA_TM3_AGE) & (RNA_TM3_SLOTS - 1)) * LW + 32;
      const float tm3 =
          leni32 * ring3[s3 + w - 3] + leni23 * ring3[s3 + w - 4];

      two = TV(TO_TMI1C) * winI;
      two = two + TV(TO_AUGT) * winB;
      two = two + TV(TO_TMI2C) * win2;
      two = two + TV(TO_TMI3C) * tm3;
      two = two + TV(TO_SP00) * RING(ringB, d + 2, w - 1);
      two = two + TV(TO_SP01) * RING(ringB, d + 3, w - 1);
      two = two + TV(TO_SP10) * RING(ringB, d + 3, w - 2);
      two = two + TV(TO_SP11) * RING(ringB, d + 4, w - 2);
      two = two + TV(TO_SP12) * RING(ringB, d + 5, w - 2);
      two = two + TV(TO_SP21) * RING(ringB, d + 5, w - 3);
      two = two + TV(TO_SP22) * RING(ringB, d + 6, w - 3);
    }
    __syncthreads();
    if (il < m) {
      float pm = 0.0f, sa = 0.0f, sbc = 0.0f;
      for (int k = 0; k < pt.k; ++k) {
        pm += part[k * pt.m32 + il];
        sa += part[RNA_CL_THREADS + k * pt.m32 + il];
        sbc += part[2 * RNA_CL_THREADS + k * pt.m32 + il];
      }
      // rna_cl_outside_bppo on the staged cells
      const float acc_mb = pr.c * TV(TO_ACCMB);
      const float pm_new = span_ok ? pm : 0.0f;
      const float pm2_raw = g_prev + mbu1 * p2prev;
      p2prev = pm2_raw;
      const float pm2_new = span_ok ? pm2_raw : 0.0f;
      const float qa =
          i >= 1 ? pm_nb + mbu1 * qab[((d + 1) & 1) * TW + qcol - 1] : 0.0f;
      const float mb_ctx = acc_mb * (sa + sbc + qa);
      float bp = pr.base + two * pr.c + mb_ctx;
      if (!(pr.pos && span_ok)) bp = 0.0f;
      bppo[row] = bp;
      gB = bp * TV(TO_AUGT) * pr.inv_close;
      g_prev = bp * TV(TO_MBC) * pr.inv_close;
      g_hist[row] = g_prev;
      pm_hist[row] = pm_new;
      pm2_hist[row] = pm2_new;
      gI = gB * TV(TO_TMO1);
      g2 = gB * TV(TO_TMO2);
      g3 = gB * TV(TO_TMO3);
      qab[(d & 1) * TW + qcol] = qa;
      if (hi && p == y.G - 1) hi_qab[(d & 1) * TW + hi_qcol] = qa;
    }
#undef TV
    // the next span's cells, also of the lanes it brings to life
    if (d >= 1 && il < y.live(n, d - 1)) stage_span(d - 1);
    cluster.sync();
  }
}

extern "C" int rna_turner_outside(void** tables, const float* ONE,
                                  const float* QONE, const float* EXTR,
                                  const float* KT, const float* scal,
                                  const int* ns, float* bppo, float* pm_hist,
                                  float* pm2_hist, float* g_hist, int B,
                                  int N, int min_span, void* stream) {
  // Turner's tiers end at N = 1024
  if (!rna_shape_ok(N) || N > RNA_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  TurnerOutsideTables tabs;
  for (int k = 0; k < TO_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  if (N <= RNA_NARROW) {
    const int T = rna_nw_threads(turner_outside_kernel, turner_outside_smem,
                                 B, N);
    if (!T) return (int)cudaErrorInvalidConfiguration;
    return rna_launch(turner_outside_kernel, B, T, turner_outside_smem(N, T),
                      stream, TURNER_OUTSIDE_ARGS);
  }
  const int C = rna_cl_size(turner_outside_cluster_kernel,
                            turner_outside_cl_smem, B, N);
  return rna_cl_launch(turner_outside_cluster_kernel, B, C,
                       C ? turner_outside_cl_smem(N / C) : 0, stream,
                       TURNER_OUTSIDE_ARGS);
}

// The cluster size K13 takes for B sequences at N (0: none launches).
extern "C" int rna_turner_outside_cluster(int B, int N) {
  return rna_cl_size(turner_outside_cluster_kernel, turner_outside_cl_smem,
                     B, N);
}

// The block size K5 takes for B sequences at N <= 256 (0: none launches).
extern "C" int rna_turner_outside_threads(int B, int N) {
  return rna_nw_threads(turner_outside_kernel, turner_outside_smem, B, N);
}
