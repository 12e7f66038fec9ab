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
//           below min_span; ctx, pm, pm2: rna_log_split_context
//   g2    = bppo - CLOSE + JS,  g = bppo + MBC - CLOSE (-inf where CLOSE is)
//
// Every -inf - -inf of the JAX kernel is guarded as it guards it (the
// stack's JS term is 0 where span d + 2 was not reached; g2 and g are -inf
// where CLOSE is), so no NaN reaches presence.
//
// Bound: latency and issue.  n dependent spans; a live lane's span is ~500
// window leaves and ~2k + 2 min(i, k) multibranch leaves (k = n - 1 - d),
// each a cubic log-add of ~40 dependent instructions.
// Design: one block of 1,024 threads per sequence, a group of G = 1024 / N
// threads a lane (fold_log.cuh rna_log_group: 4 at N = 256, 8 at 128).
// The group splits every tree as the halving tree splits (bitwise equal to
// the plain version): the window's 31 trees dealt whole to its threads, the
// four multibranch trees by residue, with shuffles for the top levels.
// Only live work runs: a lane with i + d >= n does nothing at span d (its
// bppo stays the wrapper's -inf), and a lane whose CLOSE is -inf computes
// only pm and pm2.  Nothing reads a dead cell's g, g2, pm or pm2 (the
// window's and pm's leaves that would lie past the sequence's end, and the
// window's lanes left of 0, are skipped; the context reads (d+t, i-t),
// live), so those cells are never written.  The window rows sit in a
// 33-slot ring in shared memory (RNA_OWIN: one barrier a span); a span's
// ten table cells a lane are staged one span ahead with cp.async (the span
// loop K16-K19 share, fold_log.cuh rna_log_spans); g
// (transposed), (pm2, pm) (by pair end j) and QONEMB (transposed, computed
// by the whole block first) live in the wrapper's scratch, laid out so a
// group's leaves read neighbouring words.  Every log-add takes its cubic's
// coefficients from shared memory by index (rna_lse_pair_s), the same bits
// as rna_lse_pair in fewer instructions.

#include "fold_log.cuh"

struct ContraOutsideLogTables {
  const float* t[8];  // CLOSE MBC ACC STKO I11O B0RO JB JS
};

// Staged cells of a lane and span: the 8 tables at (d, i), JS(d+2, i-1)
// (0 where span d + 2 was not reached) and EXTR(j+1).
#define COL_JS2 8
#define COL_EXTR 9
#define COL_STAGED 10

#define COL_PARAMS                                                           \
  ContraOutsideLogTables tabs, const float *__restrict__ ONEP,               \
      const float *__restrict__ QONE, const float *__restrict__ B0LO,        \
      const float *__restrict__ EXTL, const float *__restrict__ EXTR,        \
      const float *__restrict__ LEN, const float *__restrict__ scal,         \
      const int *__restrict__ ns, float *bppo, float *g_t, float2 *pp,       \
      float *qmb, int N, int min_span

template <int G>
__global__ void __launch_bounds__(RNA_LOG_THREADS, 1)
    contra_outside_log_kernel(COL_PARAMS) {
  extern __shared__ float smem[];
  float* ring = smem;                    // RNA_OWIN * N: g2 rows
  float* len = ring + RNA_OWIN * N;      // RNA_LEN_SIZE
  float* stage = len + RNA_LEN_SIZE;     // 2 * COL_STAGED * N

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int i = tid / G, r = tid % G;
  const unsigned mask = rna_group_mask<G>(tid);
  rna_ln_coef_load();
  __syncthreads();
  for (int e = tid; e < RNA_LEN_SIZE; e += blockDim.x) len[e] = LEN[e];
  const float* sc = scal + b * RNA_LOG_SCAL;
  const float ebp = sc[1], mbu = sc[2], mbbp = sc[3];
  const float glob = sc[RNA_LOG_GLOB];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  rna_log_qone_mb_t<true>(QONE, mbu, base, N, qmb);
  const float lt = EXTL[(long long)b * N + i];
  const float b0lo = B0LO[(long long)b * N + i];

  rna_log_spans<false, COL_STAGED>(
      stage, n, N,
      [&](int k, int d, int l) -> const float* {
        if (k < COL_JS2) return tabs.t[k] + base + (long long)d * N + l;
        if (k == COL_EXTR) return EXTR + (long long)b * 2 * N + l + d + 1;
        return d + 2 <= n - 1 && l >= 1
                   ? tabs.t[7] + base + (long long)(d + 2) * N + l - 1
                   : nullptr;
      },
      RnaNoPass{}, rna_log_lanes<G>(n, [&](int d, int ri, const float* st) {
        const float c = st[0];
        const bool span_ok = d + 1 >= min_span;
        const bool ok = c > RNA_NEG;
        float bp = RNA_NEG, pm = RNA_NEG, pm2 = RNA_NEG;
        if (span_ok) {
          const float acc = radd(c, st[2 * N]);
          const float ctx = rna_log_split_context<true, G>(
              radd(acc, mbbp), mbu, base, d, i, n, N, r, mask, ok, ONEP,
              QONE, g_t, pp, qmb, pm, pm2);
          if (ok) {
            const float bse = radd(
                rsub(radd(radd(lt, acc), st[COL_EXTR * N]), glob), ebp);
            const float jrb = st[6 * N];
            const float stk_js = rsub(st[3 * N], st[COL_JS2 * N]);
            const float b0ro = st[5 * N], i11o = st[4 * N];
            const int slot0 = (d + 2) % RNA_OWIN;
            const float two = rna_log_split_window<G>(
                rna_log_out_trees(i, ri), r, mask,
                [&](int a) { return rna_log_out_leaves(a, ri); },
                [&](int a, int bb) {
                  float body;
                  if (a == 0 && bb == 0) {
                    body = stk_js;
                  } else {
                    body = radd(jrb, len[bb * RNA_SHIFTS + a]);
                    if (a == 0 && bb == 1) body = radd(body, b0ro);
                    else if (a == 1 && bb == 0) body = radd(body, b0lo);
                    else if (a == 1 && bb == 1) body = radd(body, i11o);
                  }
                  int s = slot0 + a + bb;
                  if (s >= RNA_OWIN) s -= RNA_OWIN;
                  return radd(radd(body, ring[s * N + i - 1 - a]), c);
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
          ring[(d % RNA_OWIN) * N + i] =
              ok ? radd(rsub(bp, c), st[7 * N]) : RNA_NEG;
        }
      }));
}

// Threads a lane of K17 and K19 at N, the fewest K16 and K18 give a lane
// (0 if N is not a log shape).
extern "C" int rna_log_group_of(int N) {
  return rna_log_shape_ok(N) ? rna_log_group(N) : 0;
}

extern "C" int rna_contra_outside_log(
    void** tables, const float* ONEP, const float* QONE, const float* B0LO,
    const float* EXTL, const float* EXTR, const float* LEN, const float* scal,
    const int* ns, float* bppo, float* g_t, float* pp, float* qmb, int B,
    int N, int min_span, void* stream) {
  ContraOutsideLogTables tabs;
  for (int k = 0; k < 8; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem =
      sizeof(float) * (RNA_OWIN * N + RNA_LEN_SIZE + 2 * COL_STAGED * N);
  return rna_log_launch(N, [&](auto g) {
    return rna_launch(contra_outside_log_kernel<decltype(g)::value>, B,
                      N * decltype(g)::value, shmem, stream, tabs, ONEP, QONE,
                      B0LO, EXTL, EXTR, LEN, scal, ns, bppo, g_t, (float2*)pp,
                      qmb, N, min_span);
  });
}
