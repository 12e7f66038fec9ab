// K4 and K12: Turner inside wavefront in scaled probability space, at
// N = 32-1024 in steps of 32.
//
// Replaces rna_algos_tpu/ops/pallas_fold_prob8.py _turner_inside8m_kernel
// (:2016) and _turner_inside8_kernel (:1821) at N <= 256 (K4), and
// pallas_fold_prob.py _turner_inside_prob_kernel_chunked (:1832, called
// through _turner_prob_run_body_chunked, :2158) at N = 512 and 1024 (K12);
// the per-sequence maths is pallas_fold_prob.py:1431-1538
// (_turner_inside_prob_kernel).  The TPU's R-row chunks and resident
// scratches do not carry over: the tables and histories are read in global
// memory at every N.  The recurrences are K1's (contra_inside.cu), through
// common.cuh's close and K1's sums of narrow.cuh (K12: K8's sums of
// cluster.cuh), with eu1 = mbu1 = 1/sigma, ebp = 1 and mbbp =
// exp(COEFF_NUM_BRANCHES); only the 2-loop term and ring inserts differ.
// Inputs are the merged [d, i] tables of
// pallas_fold_prob8._turner_merge_inside (CANON and the outer terminal
// mismatch * AU/GU products folded in), so for pair (i, j = i + d):
//
//   close = H + two + MBC * s2(d-2, i+1)
//   two   = TMO1C * winI(g*TMI1) + AUGC * winB(g) + TMO2C * win2(g*TMI2)
//         + TMO3C * (LENI'[3,2] * gt3(d-7, i+3) + LENI'[2,3] * gt3(d-7, i+4))
//         + SP00*g(d-2, i+1) + SP01*g(d-3, i+1) + SP10*g(d-3, i+2)
//         + SP11*g(d-4, i+2) + SP12*g(d-5, i+2) + SP21*g(d-5, i+3)
//         + SP22*g(d-6, i+3)
//   win_K(x) = sum_{a, r} K[a][r] * x(d-1-r, i+1+a)
//   g = close * AUGT (inserted after the span), gt3 = g * TMI3
//
// with K in {KI, KB, K2} the per-sequence banded window matrices of
// pallas_fold_prob._turner_banded_kernels; each carries its cells' sigma
// powers (the TPU's aging pass is unnecessary).  KB and K2 are non-zero
// only on one row and one diagonal (bulges: a = 0 or b = 0; 1xn arms:
// a = 1 or b = 1), KI only for a >= 2, so the loops visit those cells
// alone (K4: their exact supports, narrow.cuh rna_tw_first); the plain
// version contracts the full matrices.
//
// K4 (N <= 256): K1's layout (contra_inside.cu, narrow.cuh): one block
// of T = 256-1,024 threads per sequence, T from the batch and the card,
// thread i owning lane i, live cells only (i + d < n; a dead cell stays
// the zero the wrapper passes), two phases a span: (1) the owners compute
// close from their 18 table cells, the three window sums of the phase
// before, the TM3 ring and the seven special cells, and insert g and its
// products into the rings (slot d & 31 held span d - 32, which no lane
// reads any more; the TM3 slot d & 7 span d - 8), while every thread takes
// a part of the live lanes' bifurcation terms t >= 1; (2) the owners add
// their parts and finish ext, one, s1 and s2, while the block computes the
// next span's three windows (rna_nw_turner_window_pass), only at the cells
// that can close (d >= 4, AUGC != 0: TMO1C, TMO2C and TMO3C carry AUGC,
// and the window terms are multiplied by 0 elsewhere), listed by the
// owners in phase 1.  What bounds it is K1's: the latency of n dependent
// spans, in which one thread a lane walked a window of ~550 terms out of
// shared memory and its O(d) bifurcation terms with one load in flight
// (PR 2's form, PERF.md).  Three 32-slot rings (g, g*TMI1, g*TMI2) and an
// 8-slot ring of g*TMI3 (read at age 6 only), rows N + 32 floats apart so
// that a window group's threads read distinct banks, take 104 x (N + 32)
// floats of dynamic shared memory beside the three 32 x 32 matrices
// (~147 KB a block at N = 256, ~86 KB at N = 128: two blocks an SM).  The
// rm/rmmb histories and the ext/one tables stay in global memory (L2).
// The S1 recurrence is telescoped (flush-safe: Turner's mbu = 0 makes a
// standalone mbu1^t column underflow).
//
// K12 (N = 512, 1024): a cluster of C blocks per sequence, as K8
// (cluster.cuh, contra_inside.cu; C = 4 at N = 512 B = 32, 8 at N = 1024
// B = 16 on an H100): each block owns N / C lanes in chunks interleaved
// over the cluster and computes their live cells only (a dead cell stays
// the zero the wrapper passes; nothing downstream reads one:
// tests/test_torch_long_deadcells.py).  What bounds it is K8's: each span
// re-reads the history triangle, 16 B a bifurcation term, and Turner adds
// a 2-loop term of ~560 shared-memory FMAs and 18 table cells a lane.  So
// each live lane's bifurcation terms are spread over the block's threads
// that own no lane (rna_cl_part_free) while the owners compute their
// lanes' 2-loop terms, and the owner sums the parts in a fixed order; each
// owner stages its next span's 18 table cells into shared memory with
// cp.async (rna_cl_stage), so no HBM latency of the tables (far past the
// L2 at the long shapes) lies on a span's path (first design, without
// either: 1.1x / 1.2x slower at N = 512 B = 32 / 1024 B = 16 on an H100
// 80GB HBM3 at 700 W, PERF.md).  The four rings keep their slots (32, 32,
// 32 and 8) of, per chunk, its lanes and the next chunk's first 32 (the
// window reads up to lane i + 31), written by that chunk's block through
// distributed shared memory: 104 ring rows, ~149 KB of shared memory a
// block at N / C = 128 lanes, so C = 1 or 2 at N = 512 and C = 4 at
// N = 1024 do not fit (and N / C <= 128 leaves 896 threads for the
// parts).  A span's rows are inserted at the start of the next span, span
// d - 1 into the slot of span d - 33 (the 32-slot rings, which read spans
// d - 2 .. d - 32) and of span d - 9 (the TM3 ring, which reads span d - 7
// only), so no lane reads a slot while it is written and one cluster
// barrier a span suffices.  s1 and s2 rows by span & 3 with one halo lane
// a chunk.

#include "cluster.cuh"
#include "launch.cuh"
#include "narrow.cuh"

// pallas_fold_prob8.TURNER_INSIDE_TABLES order
enum {
  TI_H, TI_MBC, TI_ACC, TI_AUGC, TI_TMO1C, TI_TMO2C, TI_TMO3C,
  TI_SP00, TI_SP01, TI_SP10, TI_SP11, TI_SP12, TI_SP21, TI_SP22,
  TI_AUGT, TI_TMI1, TI_TMI2, TI_TMI3, TI_COUNT
};

struct TurnerInsideTables {
  const float* t[TI_COUNT];
};

#define TURNER_RING_ROWS (3 * RNA_WIN + RNA_TM3_SLOTS)

#define TURNER_INSIDE_PARAMS                                                \
  TurnerInsideTables tabs, const float *__restrict__ KT,                    \
      const float *__restrict__ scal, const int *__restrict__ ns,           \
      float *close, float *ext, float *one, float *rm_hist,                 \
      float *rmm_hist, int N
#define TURNER_INSIDE_ARGS                                                  \
  tabs, KT, scal, ns, close, ext, one, rm_hist, rmm_hist, N

// A 32-slot ring's cell of `span` at ring column `lane` (rows LW floats).
#define RING(buf, span, lane) \
  (buf)[((span) & (RNA_WIN - 1)) * LW + (lane)]

// K4's shared memory at N lanes and T threads: kt | the rings, 104 rows of
// N + 32 lanes | s2r, s1r, 2 rows of N + 1 each | win, 3 rows of N | the es
// and s2 parts, T each | the closable lists, 2 spans of N ints, and their
// two counts | nz, N + 32.
static size_t turner_inside_smem(int N, int T) {
  return sizeof(float) * (3 * RNA_WIN * RNA_WIN +
                          TURNER_RING_ROWS * (N + 32) + 4 * (N + 1) + 3 * N +
                          2 * T) +
         sizeof(int) * (2 * N + 2 + N + 32);
}

__global__ void __launch_bounds__(RNA_NW_MAX_THREADS)
    turner_inside_kernel(TURNER_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  // ring row: N lanes + 32 zero pad lanes (lane i + 1 + a <= N + 30), a
  // multiple of 32 floats
  const int LW = N + 32;
  float* kt = smem;                            // KI | KB | K2, 32 x 32 each
  float* ringB = kt + 3 * RNA_WIN * RNA_WIN;   // g          (KB, specials)
  float* ringI = ringB + RNA_WIN * LW;         // g * TMI1   (KI)
  float* ring2 = ringI + RNA_WIN * LW;         // g * TMI2   (K2)
  float* ring3 = ring2 + RNA_WIN * LW;         // g * TMI3, 8 slots
  float* s2r = ring3 + RNA_TM3_SLOTS * LW;     // 2 * (N + 1), span parity
  float* s1r = s2r + 2 * (N + 1);              // 2 * (N + 1), span parity
  float* win = s1r + 2 * (N + 1);              // winI | winB | win2, N each
  float* part = win + 3 * N;                   // es | s2, T each
  int* list = (int*)(part + 2 * T);            // 2 * N
  int* count = list + 2 * N;                   // 2
  unsigned* nz = (unsigned*)(count + 2);       // N + 32: nonzero slots of g

  const long long base = (long long)b * N * N;
  const float* const* tab = tabs.t;
  for (int e = tid; e < TURNER_RING_ROWS * LW + 4 * (N + 1); e += T)
    ringB[e] = 0.0f;                           // the rings, s2r and s1r
  for (int e = tid; e < N + 32; e += T) nz[e] = 0u;
  for (int e = tid; e < 3 * RNA_WIN * RNA_WIN; e += T)
    kt[e] = KT[(long long)b * 3 * RNA_WIN * RNA_WIN + e];
  if (tid < 2) count[tid] = 0;
  const float* sc = scal + b * RNA_TSCAL;
  const RnaScalars s = rna_scalars(sc);
  const float leni32 = sc[4], leni23 = sc[5];
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
    const int m = n - d;                       // live lanes 0 .. m-1
    const long long row = base + (long long)d * N + i;
    // phase 1: list span d + 1's cells that can close, their AUGC loaded
    // with the owners' cells and appended after the owners' work.  Every
    // load of the phase comes before its first store, which it could alias
    // (the compiler keeps the two in order), so the loads are in flight
    // together (2-4% of K4 on an H100, PERF.md, PR 11).
    const bool lists = i < m - 1 && d + 2 >= RNA_MIN_SPAN_HAIRPIN_CLOSE;
    const float augc_next = lists ? tab[TI_AUGC][row + N] : 0.0f;
    // the owners' close of span d from its windows (where the cell can
    // close; elsewhere TMO1C, AUGC and TMO2C are 0), the rings of spans
    // < d and s2(d-2, i+1); and rmmb(d-1, i+1) for phase 2
    float rmm_nb = 0.0f;
    if (i < m) {
      float v[TI_COUNT];
#pragma unroll
      for (int k = 0; k < TI_COUNT; ++k) v[k] = tab[k][row];
      if (d >= 1) rmm_nb = rmm_hist[row - N + 1];
      const bool can =
          d + 1 >= RNA_MIN_SPAN_HAIRPIN_CLOSE && v[TI_AUGC] != 0.0f;
      const int s3 = ((d - 1 - RNA_TM3_AGE) & (RNA_TM3_SLOTS - 1)) * LW;
      const float tm3 = leni32 * ring3[s3 + i + 3] + leni23 * ring3[s3 + i + 4];
      float two = v[TI_TMO1C] * (can ? win[i] : 0.0f);
      two = two + v[TI_AUGC] * (can ? win[N + i] : 0.0f);
      two = two + v[TI_TMO2C] * (can ? win[2 * N + i] : 0.0f);
      two = two + v[TI_TMO3C] * tm3;
      two = two + v[TI_SP00] * RING(ringB, d - 2, i + 1);
      two = two + v[TI_SP01] * RING(ringB, d - 3, i + 1);
      two = two + v[TI_SP10] * RING(ringB, d - 3, i + 2);
      two = two + v[TI_SP11] * RING(ringB, d - 4, i + 2);
      two = two + v[TI_SP12] * RING(ringB, d - 5, i + 2);
      two = two + v[TI_SP21] * RING(ringB, d - 5, i + 3);
      two = two + v[TI_SP22] * RING(ringB, d - 6, i + 3);
      // rna_inside_close on the loaded cells
      const float mb_term =
          d >= 2 ? s2r[(d & 1) * (N + 1) + i + 1] * v[TI_MBC] : 0.0f;
      float c = (v[TI_H] + two) + mb_term;
      if (d + 1 < RNA_MIN_SPAN_HAIRPIN_CLOSE) c = 0.0f;
      close[row] = c;
      const float ca = c * v[TI_ACC];
      st.rm = st.rm * s.eu1 + ca * s.ebp;
      st.rmmb = st.rmmb * s.mbu1 + ca * s.mbbp;
      st.epow = st.epow * s.eu1;
      rm_hist[row] = st.rm;
      rmm_hist[row] = st.rmmb;
      // span d's rows, read from span d + 2 on
      const float g = c * v[TI_AUGT];
      const unsigned bit = 1u << (d & (RNA_WIN - 1));
      RING(ringB, d, i) = g;
      RING(ringI, d, i) = g * v[TI_TMI1];
      RING(ring2, d, i) = g * v[TI_TMI2];
      ring3[(d & (RNA_TM3_SLOTS - 1)) * LW + i] = g * v[TI_TMI3];
      nz[i] = g != 0.0f ? nz[i] | bit : nz[i] & ~bit;
    }
    if (lists && augc_next != 0.0f)
      list[((d + 1) & 1) * N + atomicAdd(&count[(d + 1) & 1], 1)] = i;
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
      rna_nw_turner_window_pass<true>(ringB, LW, nz, kt,
                                      list + ((d + 1) & 1) * N,
                                      count[(d + 1) & 1], d + 1, T, N, win);
    if (tid == 0) count[d & 1] = 0;            // span d's list, read at d - 1
    __syncthreads();
  }
}

// K12's shared memory at L lanes a block: kt | the rings, 104 rows of
// L / G segments of G + 32 lanes | s2r, s1r, 4 rows of L / G segments of
// G + 1 lanes each | the es and s2 parts, one a thread each | the staged
// table cells, 2 spans x 18 tables x L lanes.
static size_t turner_inside_cl_smem(int L) {
  const int segs = L / rna_cl_chunk(L);
  return sizeof(float) *
         (3 * RNA_WIN * RNA_WIN + TURNER_RING_ROWS * (L + 32 * segs) +
          8 * (L + segs) + 2 * RNA_CL_THREADS + 2 * TI_COUNT * L);
}

__global__ void __launch_bounds__(RNA_CL_THREADS)
    turner_inside_cluster_kernel(TURNER_INSIDE_PARAMS) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int L = N / C;
  const RnaClLayout y = {C, (int)cluster.block_rank(), L, rna_cl_chunk(L)};
  const int b = blockIdx.x / C;
  const int SW = y.G + 32;           // ring segment: a chunk + the next 32
  const int LW = L / y.G * SW;       // ring row
  const int TW = L / y.G * (y.G + 1);  // s1/s2 row: a chunk + the next one
  const int RW = RNA_WIN * LW;       // a 32-slot ring
  float* kt = smem;                  // KI | KB | K2, 32 x 32 each
  float* ringB = kt + 3 * RNA_WIN * RNA_WIN;   // g          (KB, specials)
  float* ringI = ringB + RW;                   // g * TMI1   (KI)
  float* ring2 = ringI + RW;                   // g * TMI2   (K2)
  float* ring3 = ring2 + RW;                   // g * TMI3, 8 slots
  float* s2r = ring3 + RNA_TM3_SLOTS * LW;     // 4 * TW, row s & 3
  float* s1r = s2r + 4 * TW;                   // 4 * TW, row s & 3
  float* part = s1r + 4 * TW;                  // es | s2
  float* stage = part + 2 * RNA_CL_THREADS;    // [span & 1][table][lane]
  const float* kI = kt;
  const float* kB = kt + RNA_WIN * RNA_WIN;
  const float* k2 = kt + 2 * RNA_WIN * RNA_WIN;

  const int tid = threadIdx.x;
  const long long base = (long long)b * N * N;
  const float* const* T = tabs.t;
  for (int e = tid; e < TURNER_RING_ROWS * LW + 8 * TW; e += RNA_CL_THREADS)
    ringB[e] = 0.0f;                       // the rings, s2r and s1r
  for (int e = tid; e < 3 * RNA_WIN * RNA_WIN; e += RNA_CL_THREADS)
    kt[e] = KT[(long long)b * 3 * RNA_WIN * RNA_WIN + e];
  const float* sc = scal + b * RNA_TSCAL;
  const RnaScalars s = rna_scalars(sc);
  const float leni32 = sc[4], leni23 = sc[5];
  const int n = ns[b];

  // the lane this thread owns (if il < L), its ring and s1/s2 columns, and
  // where its chunk is the halo of the chunk below (the rings at the same
  // offsets from the neighbour's ringB)
  const int il = tid, q = il / y.G, p = il % y.G;
  const int i = y.lane(il);
  const int col = q * SW + p, tcol = q * (y.G + 1) + p;
  int lo_rank = 0, lo_q = 0;
  const bool lo = il < L && y.next_chunk(q, -1, N, lo_rank, lo_q);
  float* lo_ring = lo ? cluster.map_shared_rank(ringB, lo_rank) : nullptr;
  float* lo_s2r = lo ? cluster.map_shared_rank(s2r, lo_rank) : nullptr;
  float* lo_s1r = lo ? cluster.map_shared_rank(s1r, lo_rank) : nullptr;
  const int lo_col = lo_q * SW + y.G + p, lo_tcol = lo_q * (y.G + 1) + y.G;
  if (il < y.live(n, 0)) {
    rna_cl_stage(stage + il, L, T, TI_COUNT, base + i);
    __pipeline_commit();
  }
  cluster.sync();   // every block zeroed before the first halo write

  RnaInsideLane st;
  // g, g * TMI1, g * TMI2, g * TMI3 of the span before, for the rings
  float gB = 0.0f, gI = 0.0f, g2 = 0.0f, g3 = 0.0f;
  for (int d = 0; d < n; ++d) {
    if (d >= 1 && il < y.live(n, d - 1)) {
      const int slot = ((d - 1) & (RNA_WIN - 1)) * LW;
      const int slot3 = ((d - 1) & (RNA_TM3_SLOTS - 1)) * LW;
      ringB[slot + col] = gB;
      ringI[slot + col] = gI;
      ring2[slot + col] = g2;
      ring3[slot3 + col] = g3;
      if (lo && p < 32) {
        lo_ring[slot + lo_col] = gB;
        lo_ring[RW + slot + lo_col] = gI;
        lo_ring[2 * RW + slot + lo_col] = g2;
        lo_ring[3 * RW + slot3 + lo_col] = g3;
      }
    }
    const int m = y.live(n, d);
    const RnaClPart pt = rna_cl_part_free(m, tid, L);
    if (pt.p < pt.k) {
      float es = 0.0f, s2 = 0.0f;
      if (pt.ll < m)
        rna_cl_bifurcation_part(base, d, y.lane(pt.ll), N, 1 + pt.p, pt.k,
                                ext, one, rm_hist, rmm_hist, es, s2);
      part[tid - L] = es;
      part[RNA_CL_THREADS + tid - L] = s2;
    }
    const long long row = base + (long long)d * N + i;
    float rmm_nb = 0.0f;   // rmmb(d - 1, i + 1), written the span before
    if (il < m) {
      if (d >= 1 && i + 1 < N) rmm_nb = __ldcg(rmm_hist + row - N + 1);
      // this span's table cells, staged the span before
      __pipeline_wait_prior(0);
      const float* v = stage + (d & 1) * TI_COUNT * L + il;
#define TV(k) v[(k) * L]
      // K4's 2-loop term (turner_inside_kernel) at ring column col
      const float winI = rna_window_inside(ringI, kI, 2, d, col, LW);
      float winB = 0.0f;
      for (int r = 1; r < RNA_WIN; ++r)
        winB = fmaf(kB[r], RING(ringB, d - 1 - r, col + 1), winB);
      for (int a = 1; a < RNA_WIN - 1; ++a)
        winB = fmaf(kB[a * RNA_WIN + a + 1],
                    RING(ringB, d - 2 - a, col + 1 + a), winB);
      float win2 = 0.0f;
      for (int r = 2; r < RNA_WIN; ++r)
        win2 = fmaf(k2[RNA_WIN + r], RING(ring2, d - 1 - r, col + 2), win2);
      for (int a = 2; a < RNA_WIN - 2; ++a)
        win2 = fmaf(k2[a * RNA_WIN + a + 2],
                    RING(ring2, d - 3 - a, col + 1 + a), win2);
      const int s3 = ((d - 1 - RNA_TM3_AGE) & (RNA_TM3_SLOTS - 1)) * LW;
      const float tm3 =
          leni32 * ring3[s3 + col + 3] + leni23 * ring3[s3 + col + 4];

      float two = TV(TI_TMO1C) * winI;
      two = two + TV(TI_AUGC) * winB;
      two = two + TV(TI_TMO2C) * win2;
      two = two + TV(TI_TMO3C) * tm3;
      two = two + TV(TI_SP00) * RING(ringB, d - 2, col + 1);
      two = two + TV(TI_SP01) * RING(ringB, d - 3, col + 1);
      two = two + TV(TI_SP10) * RING(ringB, d - 3, col + 2);
      two = two + TV(TI_SP11) * RING(ringB, d - 4, col + 2);
      two = two + TV(TI_SP12) * RING(ringB, d - 5, col + 2);
      two = two + TV(TI_SP21) * RING(ringB, d - 5, col + 3);
      two = two + TV(TI_SP22) * RING(ringB, d - 6, col + 3);
      // rna_cl_inside_close on the staged cells
      const float s2_prev = d >= 2 ? s2r[((d - 2) & 3) * TW + tcol + 1] : 0.0f;
      const float mb_term = d >= 2 ? s2_prev * TV(TI_MBC) : 0.0f;
      float c = (TV(TI_H) + two) + mb_term;
      if (d + 1 < RNA_MIN_SPAN_HAIRPIN_CLOSE) c = 0.0f;
      close[row] = c;
      const float acc = c * TV(TI_ACC);
      st.rm = st.rm * s.eu1 + acc * s.ebp;
      st.rmmb = st.rmmb * s.mbu1 + acc * s.mbbp;
      st.epow = st.epow * s.eu1;
      rm_hist[row] = st.rm;
      rmm_hist[row] = st.rmmb;
      gB = c * TV(TI_AUGT);
      gI = gB * TV(TI_TMI1);
      g2 = gB * TV(TI_TMI2);
      g3 = gB * TV(TI_TMI3);
#undef TV
      if (d + 1 < n && il < y.live(n, d + 1)) {
        rna_cl_stage(stage + ((d + 1) & 1) * TI_COUNT * L + il, L, T,
                     TI_COUNT, row + N);
        __pipeline_commit();
      }
    }
    __syncthreads();
    if (il < m) {
      // term t = 0: rm(d, i) * ext(-1, i) = rm(d, i)
      float es = st.rm, s2 = 0.0f;
      for (int k = 0; k < pt.k; ++k) {
        es += part[k * pt.m32 + il];
        s2 += part[RNA_CL_THREADS + k * pt.m32 + il];
      }
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

extern "C" int rna_turner_inside(void** tables, const float* KT,
                                 const float* scal, const int* ns,
                                 float* close, float* ext, float* one,
                                 float* rm_hist, float* rmm_hist, int B,
                                 int N, void* stream) {
  // Turner's tiers end at N = 1024
  if (!rna_shape_ok(N) || N > RNA_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  TurnerInsideTables tabs;
  for (int k = 0; k < TI_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  if (N <= RNA_NARROW) {
    const int T = rna_nw_threads(turner_inside_kernel, turner_inside_smem, B,
                                 N);
    if (!T) return (int)cudaErrorInvalidConfiguration;
    return rna_launch(turner_inside_kernel, B, T, turner_inside_smem(N, T),
                      stream, TURNER_INSIDE_ARGS);
  }
  const int C = rna_cl_size(turner_inside_cluster_kernel,
                            turner_inside_cl_smem, B, N);
  return rna_cl_launch(turner_inside_cluster_kernel, B, C,
                       C ? turner_inside_cl_smem(N / C) : 0, stream,
                       TURNER_INSIDE_ARGS);
}

// The cluster size K12 takes for B sequences at N (0: none launches).
extern "C" int rna_turner_inside_cluster(int B, int N) {
  return rna_cl_size(turner_inside_cluster_kernel, turner_inside_cl_smem, B,
                     N);
}

// The block size K4 takes for B sequences at N <= 256 (0: none launches).
extern "C" int rna_turner_inside_threads(int B, int N) {
  return rna_nw_threads(turner_inside_kernel, turner_inside_smem, B, N);
}
