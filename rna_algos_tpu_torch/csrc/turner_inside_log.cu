// K18: Turner 2004 inside wavefront in log space with the reference's
// cubic log-add (the parity tier), N = 32..256, a power of two.
//
// Replaces rna_algos_tpu/ops/pallas_fold.py _turner_inside_kernel (:931)
// with its 2-loop term _turner_tl (:871), launched by _turner_inside_call
// (:1345).  Inputs are the [d, i] tables of turner_precompute_di.  As K16
// (contra_inside_log.cu), with the Turner 2-loop body of window cell (a, b)
// (inner pair (i+1+a, j-1-b), span d-2-a-b):
//
//   bulge (a == 0 or b == 0):  LENB[b][a] + AUGT
//   else:  LENI[b][a] + TMo_f(i, j) + TMi_f(inner) + AUGT, family f = 2 for
//          1 x n loops (a == 1 or b == 1), 3 at the 2 x 3 cells (2, 3) and
//          (3, 2), else 1
//   the seven small-loop cells (0,0) STKT, (0,1) B01, (1,0) B10, (1,1)
//   I11T, (1,2) I12T, (2,1) I21T, (2,2) I22T replace the body;
//   + (close + AUGT) of the inner pair, the merged window
//
// and rm = rm(d-1, i) (+) close + ACC, ext's base 0, x_t = rm + coeff.
//
// Bound and design as K16: a window pass over the span's cells that can
// close, then every live lane, each with as many threads as fit, the trees
// split as the halving tree splits, live and canonical work only; four
// 33-slot rings in shared memory (close + AUGT and the three inner
// terminal-mismatch tables TMi1..3 of each finished span, 135 KB at
// N = 256), the s2 rows in a 3-slot ring, the span's 18 table cells a lane
// staged one span ahead with cp.async, rm by pair end and (ext, one)
// transposed in the wrapper's scratch.

#include "fold_log.cuh"

#define TIL_COUNT 18
struct TurnerInsideLogTables {
  // H MBC ACC CANON STKT B01 B10 I11T I12T I21T I22T TMo1 TMo2 TMo3 AUGT
  // TMi1 TMi2 TMi3
  const float* t[TIL_COUNT];
};

#define TIL_PARAMS                                                          \
  TurnerInsideLogTables tabs, const float *__restrict__ LENB,               \
      const float *__restrict__ LENI, const float *__restrict__ scal,       \
      const int *__restrict__ ns, float *close, float *ext, float *one,     \
      float *rmp, float2 *eo, int N

__global__ void __launch_bounds__(RNA_LOG_THREADS, 1)
    turner_inside_log_kernel(TIL_PARAMS) {
  extern __shared__ float smem[];
  const int RING = RNA_OWIN * N;
  float* caw = smem;                     // close + AUGT
  float* tw = smem + RING;               // TMi1..3 rings, RING apart
  float* lenb = smem + 4 * RING;
  float* leni = lenb + RNA_LEN_SIZE;
  float* s2r = leni + RNA_LEN_SIZE;      // RNA_S2_SLOTS * N
  float* twos = s2r + RNA_S2_SLOTS * N;  // N: the span's window sums
  float* rms = twos + N;                 // 2 * N: rm, by span parity
  float* stage = rms + 2 * N;            // 2 * TIL_COUNT * N
  // 2 * N: the lanes that can close, by span parity
  int* cells = (int*)(stage + 2 * TIL_COUNT * N);
  int* count = cells + 2 * N;            // 2: by span parity

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  rna_ln_coef_load();
  for (int e = tid; e < RNA_LEN_SIZE; e += blockDim.x) {
    lenb[e] = LENB[e];
    leni[e] = LENI[e];
  }
  for (int e = tid; e < N; e += blockDim.x) rms[N + e] = RNA_NEG;  // span -1
  if (tid == 0) count[0] = 0;
  const float coeff = scal[b * RNA_LOG_SCAL];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  const float* CANON = tabs.t[3];

  rna_log_spans<true, TIL_COUNT>(
      stage, n, N,
      [&](int k, int d, int l) -> const float* {
        return tabs.t[k] + base + (long long)d * N + l;
      },
      [&](int d) {
        const float* sd = stage + (d & 1) * TIL_COUNT * N;
        const int slot0 = (d - 2) % RNA_OWIN;
        rna_log_window_pass(
            cells + (d & 1) * N, count[d & 1],
            [&](auto gw, int l, int rr, unsigned m) {
              const float* st = sd + l;
              float sp[7], tm[3];
#pragma unroll
              for (int k = 0; k < 7; ++k) sp[k] = st[(4 + k) * N];
#pragma unroll
              for (int k = 0; k < 3; ++k) tm[k] = st[(11 + k) * N];
              const float aug = st[14 * N];
              const float two = rna_log_split_window<decltype(gw)::value>(
                  rna_log_in_trees(d), rr, m,
                  [&](int a) { return rna_log_in_leaves(a, d); },
                  [&](int a, int bb) {
                    int s = slot0 - a - bb;
                    if (s < 0) s += RNA_OWIN;
                    const int at = s * N + l + 1 + a;
                    return rna_turner_leaf(a, bb, lenb, leni, sp, tm, aug,
                                           caw[at], tw[at], tw[RING + at],
                                           tw[2 * RING + at]);
                  });
              if (rr == 0) twos[l] = two;
            });
        if (tid == 0) count[(d + 1) & 1] = 0;
      },
      rna_log_lanes_by_span(n, [&](auto gc, int d, int i, int r, int ri,
                                   const float* st) {
        constexpr int GC = decltype(gc)::value;
        float c = RNA_NEG;
        if (d + 1 >= RNA_MIN_SPAN_HAIRPIN_CLOSE && st[3 * N] > RNA_NEG) {
          const float mb =
              radd(s2r[((d - 2) % RNA_S2_SLOTS) * N + i + 1], st[1 * N]);
          c = radd(rna_lse_pair_s(rna_lse_pair_s(st[0], twos[i]), mb),
                   st[3 * N]);
        }
        const float rm = rna_lse_pair_s(rms[((d + 1) & 1) * N + i],
                                        radd(c, st[2 * N]));
        float sum[3];
        rna_log_split_bifurcation<false, GC>(rm, coeff, base, d, i, N, r,
                                             rna_group_mask<GC>(tid), rmp,
                                             eo, sum);
        if (r == 0) {
          const long long row = base + (long long)d * N + i;
          const float e = rna_lse_pair_s(0.0f, sum[0]);
          const float o = rna_lse_pair_s(
              rna_lse_pair_s(radd(rm, coeff), sum[1]), sum[2]);
          close[row] = c;
          ext[row] = e;
          one[row] = o;
          eo[base + (long long)i * N + d] = make_float2(e, o);
          rmp[base + (long long)(i + d) * N + i] = rm;
          rms[(d & 1) * N + i] = rm;
          s2r[(d % RNA_S2_SLOTS) * N + i] = sum[2];
          const int slot = (d % RNA_OWIN) * N + i;
          caw[slot] = radd(c, st[14 * N]);
#pragma unroll
          for (int k = 0; k < 3; ++k) tw[k * RING + slot] = st[(15 + k) * N];
          // list lane i for span d + 1's window pass if it can close there
          if (ri >= 1 && d + 2 >= RNA_MIN_SPAN_HAIRPIN_CLOSE &&
              CANON[row + N] > RNA_NEG)
            cells[((d + 1) & 1) * N + atomicAdd(&count[(d + 1) & 1], 1)] = i;
        }
      }));
}

extern "C" int rna_turner_inside_log(void** tables, const float* LENB,
                                     const float* LENI, const float* scal,
                                     const int* ns, float* close, float* ext,
                                     float* one, float* rmp, float* eo, int B,
                                     int N, void* stream) {
  TurnerInsideLogTables tabs;
  for (int k = 0; k < TIL_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem =
      sizeof(float) * (4 * RNA_OWIN * N + 2 * RNA_LEN_SIZE +
                       RNA_S2_SLOTS * N + 3 * N + 2 * TIL_COUNT * N + 2 * N +
                       2);
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  return rna_launch(turner_inside_log_kernel, B, RNA_LOG_THREADS, shmem,
                    stream, tabs, LENB, LENI, scal, ns, close, ext, one, rmp,
                    (float2*)eo, N);
}
