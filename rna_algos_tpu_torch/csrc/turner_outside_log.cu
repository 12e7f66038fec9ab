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
// Bound and design as K17: a group of G = 1024 / N threads a lane, the
// trees split as the halving tree splits, live work only (no dead cell's
// g, g2, pm, pm2 or TMo ring cell is read, so none is written), four
// 33-slot rings in shared memory (g2 and TMo1..3), the span's 17 table
// cells and EXTR a lane staged one span ahead with cp.async (the span loop
// K16-K19 share, fold_log.cuh rna_log_spans).

#include "fold_log.cuh"

#define TOL_COUNT 17
struct TurnerOutsideLogTables {
  // CLOSE MBC ACC STKO B01O B10O I11O I12O I21O I22O TMo1 TMo2 TMo3 AUGT
  // TMi1 TMi2 TMi3
  const float* t[TOL_COUNT];
};

// Staged cells of a lane and span: the 17 tables at (d, i), EXTR(j+1).
#define TOL_EXTR TOL_COUNT
#define TOL_STAGED (TOL_COUNT + 1)

#define TOL_PARAMS                                                           \
  TurnerOutsideLogTables tabs, const float *__restrict__ ONEP,               \
      const float *__restrict__ QONE, const float *__restrict__ EXTL,        \
      const float *__restrict__ EXTR, const float *__restrict__ LENB,        \
      const float *__restrict__ LENI, const float *__restrict__ scal,        \
      const int *__restrict__ ns, float *bppo, float *g_t, float2 *pp,       \
      float *qmb, int N, int min_span

template <int G>
__global__ void __launch_bounds__(RNA_LOG_THREADS, 1)
    turner_outside_log_kernel(TOL_PARAMS) {
  extern __shared__ float smem[];
  const int RING = RNA_OWIN * N;
  float* og = smem;                      // bppo - close + AUGT
  float* tw = smem + RING;               // TMo1..3 rings, RING apart
  float* lenb = smem + 4 * RING;
  float* leni = lenb + RNA_LEN_SIZE;
  float* stage = leni + RNA_LEN_SIZE;    // 2 * TOL_STAGED * N

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / G, r = tid % G;
  const unsigned mask = rna_group_mask<G>(tid);
  rna_ln_coef_load();
  __syncthreads();
  for (int e = tid; e < RNA_LEN_SIZE; e += blockDim.x) {
    lenb[e] = LENB[e];
    leni[e] = LENI[e];
  }
  const float* sc = scal + b * RNA_LOG_SCAL;
  const float coeff = sc[0];
  const float glob = sc[RNA_LOG_GLOB];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  rna_log_qone_mb_t<false>(QONE, 0.0f, base, N, qmb);
  const float lt = EXTL[(long long)b * N + i];

  rna_log_spans<false, TOL_STAGED>(
      stage, n, N,
      [&](int k, int d, int l) -> const float* {
        return k < TOL_COUNT ? tabs.t[k] + base + (long long)d * N + l
                             : EXTR + (long long)b * 2 * N + l + d + 1;
      },
      RnaNoPass{}, rna_log_lanes<G>(n, [&](int d, int ri, const float* st) {
        const float c = st[0];
        const bool span_ok = d + 1 >= min_span;
        const bool ok = c > RNA_NEG;
        float bp = RNA_NEG, pm = RNA_NEG, pm2 = RNA_NEG;
        if (span_ok) {
          const float acc = radd(c, st[2 * N]);
          const float ctx = rna_log_split_context<false, G>(
              radd(acc, coeff), 0.0f, base, d, i, n, N, r, mask, ok, ONEP,
              QONE, g_t, pp, qmb, pm, pm2);
          if (ok) {
            const float bse =
                rsub(radd(radd(lt, acc), st[TOL_EXTR * N]), glob);
            float sp[7], tm[3];
#pragma unroll
            for (int k = 0; k < 7; ++k) sp[k] = st[(3 + k) * N];
#pragma unroll
            for (int k = 0; k < 3; ++k) tm[k] = st[(14 + k) * N];
            const float aug = st[13 * N];
            const int slot0 = (d + 2) % RNA_OWIN;
            const float two = rna_log_split_window<G>(
                rna_log_out_trees(i, ri), r, mask,
                [&](int a) { return rna_log_out_leaves(a, ri); },
                [&](int a, int bb) {
                  int s = slot0 + a + bb;
                  if (s >= RNA_OWIN) s -= RNA_OWIN;
                  const int at = s * N + i - 1 - a;
                  return radd(rna_turner_leaf(a, bb, lenb, leni, sp, tm, aug,
                                              og[at], tw[at], tw[RING + at],
                                              tw[2 * RING + at]),
                              c);
                });
            bp = rna_lse_pair_s(rna_lse_pair_s(bse, two), ctx);
          }
        }
        if (r == 0) {
          const long long row = base + (long long)d * N + i;
          bppo[row] = bp;
          g_t[base + (long long)i * N + d] =
              ok ? rsub(radd(bp, st[1 * N]), c) : RNA_NEG;
          pp[base + (long long)(i + d) * N + i] = make_float2(pm2, pm);
          const int slot = (d % RNA_OWIN) * N + i;
          og[slot] = ok ? radd(rsub(bp, c), st[13 * N]) : RNA_NEG;
#pragma unroll
          for (int k = 0; k < 3; ++k) tw[k * RING + slot] = st[(10 + k) * N];
        }
      }));
}

extern "C" int rna_turner_outside_log(
    void** tables, const float* ONEP, const float* QONE, const float* EXTL,
    const float* EXTR, const float* LENB, const float* LENI,
    const float* scal, const int* ns, float* bppo, float* g_t, float* pp,
    float* qmb, int B, int N, int min_span, void* stream) {
  TurnerOutsideLogTables tabs;
  for (int k = 0; k < TOL_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem = sizeof(float) * (4 * RNA_OWIN * N +
                                        2 * RNA_LEN_SIZE +
                                        2 * TOL_STAGED * N);
  return rna_log_launch(N, [&](auto g) {
    return rna_launch(turner_outside_log_kernel<decltype(g)::value>, B,
                      N * decltype(g)::value, shmem, stream, tabs, ONEP, QONE,
                      EXTL, EXTR, LENB, LENI, scal, ns, bppo, g_t,
                      (float2*)pp, qmb, N, min_span);
  });
}
