// K17: CONTRAfold outside wavefront in log space with the reference's cubic
// log-add (the parity tier), N = 32..256, a power of two.
//
// Replaces rna_algos_tpu/ops/pallas_fold.py _contra_outside_kernel (:309),
// launched by mccaskill_contra_pallas (:830).  Spans run from d = n - 1
// down to 0.  For pair (i, j = i + d), with (+) the cubic lse_pair and
// every sum in the JAX kernel's order (fold_log.cuh):
//
//   base  = EXTL(i) + (CLOSE + ACC) + EXTR(j+1) - glob + ebp
//   two   = (+)_{a = 0..30} tree_b [a + b <= 30]
//             body(a, b) + g2(d+2+a+b, i-1-a) + CLOSE
//   body  = JB + LEN[b][a]; (0,0): STKO - JS(d+2, i-1); (0,1): + B0RO;
//           (1,0): + B0LO(i); (1,1): + I11O
//   bppo  = base (+) two (+) ctx, -inf where CLOSE is -inf or the span is
//           below min_span; ctx, pm, pm2: rna_log_mb_context
//   g2    = bppo - CLOSE + JS,  g = bppo + MBC - CLOSE (-inf where CLOSE is)
//
// with g2 of each finished span in the window ring.  Every -inf - -inf of
// the JAX kernel is guarded as it guards it (the stack's JS term is 0 where
// span d + 2 was not reached; g2 and g are -inf where CLOSE is), so no NaN
// reaches presence.
//
// Bound: latency, as K16: n dependent spans, each lane's ~650 window
// leaves and ~2 x 2k multibranch leaves a span, each a cubic log-add.
// Design as K16: one block per sequence, thread i = lane i, the window a
// 32-slot ring of g2 rows in shared memory (lanes offset by 32, -inf to the
// left), the g/pm/pm2 histories in global scratch in [d, i] layout
// (coalesced reads of pm(d+t, i-t)); the span-invariant QONEMB column of
// each lane is computed once, into scratch, before the span loop.

#include "fold_log.cuh"

struct ContraOutsideLogTables {
  const float* t[8];  // CLOSE MBC ACC STKO I11O B0RO JB JS
};

#define COL_PARAMS                                                           \
  ContraOutsideLogTables tabs, const float *__restrict__ ONEP,               \
      const float *__restrict__ QONE, const float *__restrict__ B0LO,        \
      const float *__restrict__ EXTL, const float *__restrict__ EXTR,        \
      const float *__restrict__ LEN, const float *__restrict__ scal,         \
      const int *__restrict__ ns, float *bppo, float *g_hist,                \
      float *pm_hist, float *pm2_hist, float *qmb, int N, int min_span

__global__ void contra_outside_log_kernel(COL_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 32;                 // ring row: 32 pad lanes + N
  float* ring = smem;                    // RNA_WIN * LW
  float* len = ring + RNA_WIN * LW;      // RNA_LEN_SIZE
  const float* CLOSE = tabs.t[0];
  const float* MBC = tabs.t[1];
  const float* ACC = tabs.t[2];
  const float* STKO = tabs.t[3];
  const float* I11O = tabs.t[4];
  const float* B0RO = tabs.t[5];
  const float* JB = tabs.t[6];
  const float* JS = tabs.t[7];

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  for (int e = i; e < RNA_WIN * LW; e += N) ring[e] = RNA_NEG;
  for (int e = i; e < RNA_LEN_SIZE; e += N) len[e] = LEN[e];
  const float* sc = scal + b * RNA_LOG_SCAL;
  const float ebp = sc[1], mbu = sc[2], mbbp = sc[3];
  const float glob = sc[RNA_LOG_GLOB];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  rna_log_qone_mb<true>(QONE, mbu, base, i, N, qmb);
  const float lt = EXTL[(long long)b * N + i];
  const float b0lo = B0LO[(long long)b * N + i];
  __syncthreads();

  for (int d = n - 1; d >= 0; --d) {
    // phase A: bppo from the ring (spans > d + 1) and the histories of
    // spans > d
    const long long row = base + (long long)d * N + i;
    const bool span_ok = d + 1 >= min_span;
    const float c = CLOSE[row];
    const float acc = radd(c, ACC[row]);
    const float bse = radd(
        rsub(radd(radd(lt, acc), EXTR[(long long)b * 2 * N + i + d + 1]),
             glob),
        ebp);
    const float jrb = JB[row];
    const float stk_js =
        rsub(STKO[row], (d + 2 <= n - 1 && i >= 1)
                            ? JS[base + (long long)(d + 2) * N + i - 1]
                            : 0.0f);
    const float b0ro = B0RO[row], i11o = I11O[row];
    float two = RNA_NEG;
    for (int a = 0; a < RNA_SHIFTS; ++a) {
      const int live = RNA_SHIFTS - a;
      const int lg = rna_log2_ceil(live);
      const float* lane = ring + 32 + i - 1 - a;
      RnaTree tr;
      float tsum = RNA_NEG;
      for (int m = 0; m < (1 << lg); ++m) {
        const int bb = rna_leaf(m, lg);
        float leaf = RNA_NEG;
        if (bb < live) {
          float body;
          if (a == 0 && bb == 0) {
            body = stk_js;
          } else {
            body = radd(jrb, len[bb * RNA_SHIFTS + a]);
            if (a == 0 && bb == 1) body = radd(body, b0ro);
            else if (a == 1 && bb == 0) body = radd(body, b0lo);
            else if (a == 1 && bb == 1) body = radd(body, i11o);
          }
          leaf = radd(
              radd(body, lane[((d + 2 + a + bb) & (RNA_WIN - 1)) * LW]), c);
        }
        tsum = tr.push(m, leaf);
      }
      two = rna_lse_pair(two, tsum);
    }
    float pm, pm2;
    const float ctx = rna_log_mb_context<true>(
        radd(acc, mbbp), mbu, base, d, i, n - 1 - d, N, ONEP, QONE, g_hist,
        pm_hist, pm2_hist, qmb, pm, pm2);
    float bp = rna_lse_pair(rna_lse_pair(bse, two), ctx);
    const bool ok = c > RNA_NEG;
    if (!(ok && span_ok)) bp = RNA_NEG;
    bppo[row] = bp;
    g_hist[row] = ok ? rsub(radd(bp, MBC[row]), c) : RNA_NEG;
    pm_hist[row] = span_ok ? pm : RNA_NEG;
    pm2_hist[row] = span_ok ? pm2 : RNA_NEG;
    const float g2 = ok ? radd(rsub(bp, c), JS[row]) : RNA_NEG;
    __syncthreads();

    // phase B: insert span d into the ring
    ring[(d & (RNA_WIN - 1)) * LW + 32 + i] = g2;
    __syncthreads();
  }
}

extern "C" int rna_contra_outside_log(
    void** tables, const float* ONEP, const float* QONE, const float* B0LO,
    const float* EXTL, const float* EXTR, const float* LEN, const float* scal,
    const int* ns, float* bppo, float* g_hist, float* pm_hist,
    float* pm2_hist, float* qmb, int B, int N, int min_span, void* stream) {
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  ContraOutsideLogTables tabs;
  for (int k = 0; k < 8; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem = sizeof(float) * (RNA_WIN * (N + 32) + RNA_LEN_SIZE);
  return rna_launch(contra_outside_log_kernel, B, N, shmem, stream, tabs,
                    ONEP, QONE, B0LO, EXTL, EXTR, LEN, scal, ns, bppo, g_hist,
                    pm_hist, pm2_hist, qmb, N, min_span);
}
