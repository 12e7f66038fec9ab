// K16: CONTRAfold inside wavefront in log space with the reference's cubic
// log-add (the parity tier), N = 32..256, a power of two.
//
// Replaces rna_algos_tpu/ops/pallas_fold.py _contra_inside_kernel (:167),
// launched by _contra_inside_call (:734).  Inputs are the [d, i] tables of
// contra_precompute_di.  For pair (i, j = i + d), with (+) the cubic
// lse_pair and every sum in the JAX kernel's order (fold_log.cuh):
//
//   two   = (+)_{a = 0..30} tree_b [a + b <= 30] body(a, b) + cj(d-2-a-b, i+1+a)
//   body  = JS + LEN[b][a]; (0,0): STK - JB(d-2, i+1); (0,1): + B0R;
//           (1,0): + B0L; (1,1): + I11
//   close = (H (+) two (+) MBC + s2(d-2, i+1)) + CANON, -inf below span 5
//   rm    = (rm(d-1, i) + eu) (+) (close + ACC + ebp)   (rmmb: mbu, mbbp)
//   ext, one, s2: rna_log_split_bifurcation
//
// with cj(s, l) = close + JB of span s at lane l, the window ring's rows.
//
// Bound: latency and issue.  n dependent spans; a live cell's span is its
// ~3d bifurcation leaves and, where it can close, up to 496 window leaves,
// each a cubic log-add of ~20 dependent instructions.
// Design: one block of 1,024 threads per sequence and the outside kernels'
// span loop and staging (fold_log.cuh rna_log_spans), two barriers a span.
// First a window pass: the span's cells that can close (live, CANON finite
// (6 of the 16 base pairs), from span 5 on), listed the span before, each get
// a group of 4-32 threads, the most that fit (rna_log_window_pass); the
// group reduces the 31 window trees, each dealt whole to a thread, and
// folds them in order a.  Then every live lane, again with as many threads
// as fit (4 at N = 256 early on, up to 32 as the lanes die), computes close
// from its window sum, rm and rmmb, and the three bifurcation trees split
// by residue and reduced together (rna_log_split_bifurcation).  Every tree
// splits as the halving tree splits, so the kernel is bitwise equal to its
// plain version on every live cell.  Only live work runs: a lane with
// i + d >= n does nothing at span d (its close, ext and one stay the
// wrapper's fills; nothing reads them), a cell that cannot close computes
// no window, H or multibranch term (its close is -inf whatever they hold),
// and window trees and leaves whose inner pair would lie before span 0 are
// skipped.  The window rows sit in a 33-slot ring in shared memory and the
// s2 rows in a 3-slot one; a span's eleven table cells a lane are staged
// one span ahead with cp.async; (rm, rmmb) by pair end and (ext, one)
// transposed live in the wrapper's scratch, laid out so a group's leaves
// read neighbouring words.  Every log-add takes its cubic's coefficients
// from shared memory by index (rna_lse_pair_s).

#include "fold_log.cuh"

struct ContraInsideLogTables {
  const float* t[10];  // H MBC ACC JS STK I11 B0R B0L CANON JB
};

// Staged cells of a lane and span: the 10 tables at (d, i) and JB(d-2, i+1)
// (0 below span 2).
#define CIL_JB2 10
#define CIL_STAGED 11

#define CIL_PARAMS                                                           \
  ContraInsideLogTables tabs, const float *__restrict__ LEN,                 \
      const float *__restrict__ scal, const int *__restrict__ ns,            \
      float *close, float *ext, float *one, float2 *rmp, float2 *eo, int N

__global__ void __launch_bounds__(RNA_LOG_THREADS, 1)
    contra_inside_log_kernel(CIL_PARAMS) {
  extern __shared__ float smem[];
  float* ring = smem;                    // RNA_OWIN * N: cj rows
  float* len = ring + RNA_OWIN * N;      // RNA_LEN_SIZE
  float* s2r = len + RNA_LEN_SIZE;       // RNA_S2_SLOTS * N
  float* twos = s2r + RNA_S2_SLOTS * N;  // N: the span's window sums
  float2* rms = (float2*)(twos + N);     // 2 * N: (rm, rmmb), span parity
  float* stage = (float*)(rms + 2 * N);  // 2 * CIL_STAGED * N
  // 2 * N: the lanes that can close, by span parity
  int* cells = (int*)(stage + 2 * CIL_STAGED * N);
  int* count = cells + 2 * N;            // 2: by span parity

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  rna_ln_coef_load();
  for (int e = tid; e < RNA_LEN_SIZE; e += blockDim.x) len[e] = LEN[e];
  for (int e = tid; e < N; e += blockDim.x)
    rms[N + e] = make_float2(RNA_NEG, RNA_NEG);   // span -1
  if (tid == 0) count[0] = 0;
  const float* sc = scal + b * RNA_LOG_SCAL;
  const float eu = sc[0], ebp = sc[1], mbu = sc[2], mbbp = sc[3];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  const float* CANON = tabs.t[8];

  rna_log_spans<true, CIL_STAGED>(
      stage, n, N,
      [&](int k, int d, int l) -> const float* {
        if (k < CIL_JB2) return tabs.t[k] + base + (long long)d * N + l;
        return d >= 2 ? tabs.t[9] + base + (long long)(d - 2) * N + l + 1
                      : nullptr;
      },
      [&](int d) {
        const float* sd = stage + (d & 1) * CIL_STAGED * N;
        const int slot0 = (d - 2) % RNA_OWIN;
        rna_log_window_pass(
            cells + (d & 1) * N, count[d & 1],
            [&](auto gw, int l, int rr, unsigned m) {
              const float* st = sd + l;
              const float js = st[3 * N];
              const float stk_jb = rsub(st[4 * N], st[CIL_JB2 * N]);
              const float b0r = st[6 * N], b0l = st[7 * N], i11 = st[5 * N];
              const float* lane = ring + l + 1;
              const float two = rna_log_split_window<decltype(gw)::value>(
                  rna_log_in_trees(d), rr, m,
                  [&](int a) { return rna_log_in_leaves(a, d); },
                  [&](int a, int bb) {
                    float body;
                    if (a == 0 && bb == 0) {
                      body = stk_jb;
                    } else {
                      body = radd(js, len[bb * RNA_SHIFTS + a]);
                      if (a == 0 && bb == 1) body = radd(body, b0r);
                      else if (a == 1 && bb == 0) body = radd(body, b0l);
                      else if (a == 1 && bb == 1) body = radd(body, i11);
                    }
                    int s = slot0 - a - bb;
                    if (s < 0) s += RNA_OWIN;
                    return radd(body, lane[s * N + a]);
                  });
              if (rr == 0) twos[l] = two;
            });
        if (tid == 0) count[(d + 1) & 1] = 0;
      },
      rna_log_lanes_by_span(n, [&](auto gc, int d, int i, int r, int ri,
                                   const float* st) {
        constexpr int GC = decltype(gc)::value;
        float c = RNA_NEG;
        if (d + 1 >= RNA_MIN_SPAN_HAIRPIN_CLOSE && st[8 * N] > RNA_NEG) {
          const float mb =
              radd(s2r[((d - 2) % RNA_S2_SLOTS) * N + i + 1], st[1 * N]);
          c = radd(rna_lse_pair_s(rna_lse_pair_s(st[0], twos[i]), mb),
                   st[8 * N]);
        }
        const float acc = radd(c, st[2 * N]);
        const float2 prev = rms[((d + 1) & 1) * N + i];
        const float rm = rna_lse_pair_s(radd(prev.x, eu), radd(acc, ebp));
        const float rmm = rna_lse_pair_s(radd(prev.y, mbu), radd(acc, mbbp));
        float sum[3];
        rna_log_split_bifurcation<true, GC>(rm, mbu, base, d, i, N, r,
                                            rna_group_mask<GC>(tid), rmp, eo,
                                            sum);
        if (r == 0) {
          const long long row = base + (long long)d * N + i;
          const float e = rna_lse_pair_s(rmul(eu, (float)(d + 1)), sum[0]);
          const float o =
              rna_lse_pair_s(rna_lse_pair_s(rmm, sum[1]), sum[2]);
          close[row] = c;
          ext[row] = e;
          one[row] = o;
          eo[base + (long long)i * N + d] = make_float2(e, o);
          rmp[base + (long long)(i + d) * N + i] = make_float2(rm, rmm);
          rms[(d & 1) * N + i] = make_float2(rm, rmm);
          s2r[(d % RNA_S2_SLOTS) * N + i] = sum[2];
          ring[(d % RNA_OWIN) * N + i] = radd(c, st[9 * N]);
          // list lane i for span d + 1's window pass if it can close there
          if (ri >= 1 && d + 2 >= RNA_MIN_SPAN_HAIRPIN_CLOSE &&
              CANON[row + N] > RNA_NEG)
            cells[((d + 1) & 1) * N + atomicAdd(&count[(d + 1) & 1], 1)] = i;
        }
      }));
}

extern "C" int rna_contra_inside_log(void** tables, const float* LEN,
                                     const float* scal, const int* ns,
                                     float* close, float* ext, float* one,
                                     float* rmp, float* eo, int B, int N,
                                     void* stream) {
  ContraInsideLogTables tabs;
  for (int k = 0; k < 10; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem =
      sizeof(float) * (RNA_OWIN * N + RNA_LEN_SIZE + RNA_S2_SLOTS * N + N +
                       4 * N + 2 * CIL_STAGED * N + 2 * N + 2);
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  return rna_launch(contra_inside_log_kernel, B, RNA_LOG_THREADS, shmem,
                    stream, tabs, LEN, scal, ns, close, ext, one,
                    (float2*)rmp, (float2*)eo, N);
}
