// K19: Turner 2004 outside wavefront in log space with the reference's
// cubic log-add (the parity tier), N = 32..256, a power of two.
//
// Replaces rna_algos_tpu/ops/pallas_fold.py _turner_outside_kernel
// (:1028) with its 2-loop term _turner_tl (:871), launched by
// mccaskill_turner_pallas (:1434).  As K17 (contra_outside_log.cu), with
// the Turner 2-loop body of K18 (turner_inside_log.cu) mirrored: window
// cell (a, b) is the outer pair (i-1-a, j+1+b) of span d+2+a+b, the
// family's terminal mismatch of the pair itself is TMi_f(i, j) and the
// window cell's is TMo_f (the rings hold TMo1..3 of each span reached), the
// specials are the outside translations STKO..I22O, and
//
//   base = EXTL(i) + (CLOSE + ACC) + EXTR(j+1) - glob
//   g2   = bppo - CLOSE + AUGT,  g = bppo + MBC - CLOSE
//   pm2  = tree_s g(d+1+s, i), QONEMB = QONE (+) 0, acc_mb = acc + coeff.
//
// Bound and design as K17, with K18's four shared-memory rings.

#include "fold_log.cuh"

#define TOL_COUNT 17
struct TurnerOutsideLogTables {
  // CLOSE MBC ACC STKO B01O B10O I11O I12O I21O I22O TMo1 TMo2 TMo3 AUGT
  // TMi1 TMi2 TMi3
  const float* t[TOL_COUNT];
};

#define TOL_PARAMS                                                           \
  TurnerOutsideLogTables tabs, const float *__restrict__ ONEP,               \
      const float *__restrict__ QONE, const float *__restrict__ EXTL,        \
      const float *__restrict__ EXTR, const float *__restrict__ LENB,        \
      const float *__restrict__ LENI, const float *__restrict__ scal,        \
      const int *__restrict__ ns, float *bppo, float *g_hist,                \
      float *pm_hist, float *pm2_hist, float *qmb, int N, int min_span

__global__ void turner_outside_log_kernel(TOL_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 32;
  const int RING = RNA_WIN * LW;
  float* og = smem;                      // bppo - close + AUGT
  float* tw = smem + RING;               // TMo1..3 rings, RING apart
  float* lenb = smem + 4 * RING;
  float* leni = lenb + RNA_LEN_SIZE;
  const float* CLOSE = tabs.t[0];
  const float* MBC = tabs.t[1];
  const float* ACC = tabs.t[2];
  const float* AUGT = tabs.t[13];

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  for (int e = i; e < 4 * RING; e += N) smem[e] = RNA_NEG;
  for (int e = i; e < RNA_LEN_SIZE; e += N) {
    lenb[e] = LENB[e];
    leni[e] = LENI[e];
  }
  const float* sc = scal + b * RNA_LOG_SCAL;
  const float coeff = sc[0];
  const float glob = sc[RNA_LOG_GLOB];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  rna_log_qone_mb<false>(QONE, 0.0f, base, i, N, qmb);
  const float lt = EXTL[(long long)b * N + i];
  __syncthreads();

  for (int d = n - 1; d >= 0; --d) {
    const long long row = base + (long long)d * N + i;
    const bool span_ok = d + 1 >= min_span;
    const float c = CLOSE[row];
    const float acc = radd(c, ACC[row]);
    const float bse = rsub(
        radd(radd(lt, acc), EXTR[(long long)b * 2 * N + i + d + 1]), glob);
    float sp[7], tm[3];
#pragma unroll
    for (int k = 0; k < 7; ++k) sp[k] = tabs.t[3 + k][row];
#pragma unroll
    for (int k = 0; k < 3; ++k) tm[k] = tabs.t[14 + k][row];
    const float aug = AUGT[row];
    float two = RNA_NEG;
    for (int a = 0; a < RNA_SHIFTS; ++a) {
      const int live = RNA_SHIFTS - a;
      const int lg = rna_log2_ceil(live);
      const int lane = 32 + i - 1 - a;
      RnaTree tr;
      float tsum = RNA_NEG;
      for (int m = 0; m < (1 << lg); ++m) {
        const int bb = rna_leaf(m, lg);
        float leaf = RNA_NEG;
        if (bb < live) {
          const int at = ((d + 2 + a + bb) & (RNA_WIN - 1)) * LW + lane;
          leaf = radd(rna_turner_leaf(a, bb, lenb, leni, sp, tm, aug, og[at],
                                      tw[at], tw[RING + at],
                                      tw[2 * RING + at]),
                      c);
        }
        tsum = tr.push(m, leaf);
      }
      two = rna_lse_pair(two, tsum);
    }
    float pm, pm2;
    const float ctx = rna_log_mb_context<false>(
        radd(acc, coeff), 0.0f, base, d, i, n - 1 - d, N, ONEP, QONE, g_hist,
        pm_hist, pm2_hist, qmb, pm, pm2);
    float bp = rna_lse_pair(rna_lse_pair(bse, two), ctx);
    const bool ok = c > RNA_NEG;
    if (!(ok && span_ok)) bp = RNA_NEG;
    bppo[row] = bp;
    g_hist[row] = ok ? rsub(radd(bp, MBC[row]), c) : RNA_NEG;
    pm_hist[row] = span_ok ? pm : RNA_NEG;
    pm2_hist[row] = span_ok ? pm2 : RNA_NEG;
    const float g2 = ok ? radd(rsub(bp, c), aug) : RNA_NEG;
    __syncthreads();

    const int slot = (d & (RNA_WIN - 1)) * LW + 32 + i;
    og[slot] = g2;
#pragma unroll
    for (int k = 0; k < 3; ++k) tw[k * RING + slot] = tabs.t[10 + k][row];
    __syncthreads();
  }
}

extern "C" int rna_turner_outside_log(
    void** tables, const float* ONEP, const float* QONE, const float* EXTL,
    const float* EXTR, const float* LENB, const float* LENI,
    const float* scal, const int* ns, float* bppo, float* g_hist,
    float* pm_hist, float* pm2_hist, float* qmb, int B, int N, int min_span,
    void* stream) {
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  TurnerOutsideLogTables tabs;
  for (int k = 0; k < TOL_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem =
      sizeof(float) * (4 * RNA_WIN * (N + 32) + 2 * RNA_LEN_SIZE);
  return rna_launch(turner_outside_log_kernel, B, N, shmem, stream, tabs,
                    ONEP, QONE, EXTL, EXTR, LENB, LENI, scal, ns, bppo,
                    g_hist, pm_hist, pm2_hist, qmb, N, min_span);
}
