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
//   ext, one, s2: rna_log_bifurcation
//
// with cj(s, l) = close + JB of span s at lane l, the window ring's rows.
//
// Bound: the latency of n dependent spans, each ending in __syncthreads, and
// within a span each lane's ~650 window leaves and ~3d bifurcation leaves,
// each a cubic log-add of ~40 dependent instructions (the segment select
// chain, the Horner steps).  The bytes (each table read once) take tens of
// microseconds.  Design: one block per sequence, thread i = lane i; the
// window is a 32-slot ring of cj rows in shared memory (36 KB at N = 256),
// the length table and the s2 rows (by span parity) beside it; the rm/rmmb
// histories live in global scratch in [d, i] layout, so a lane's reads of
// rm(d-t, i+t) are coalesced across the warp.  Two barriers a span: the
// ring slot that span d fills (d & 31) is the one its own window reads for
// span d - 32.  The lever for a later change: more lanes at work than one
// block's N (several blocks a sequence), and the select chain of the cubic.

#include "fold_log.cuh"

struct ContraInsideLogTables {
  const float* t[10];  // H MBC ACC JS STK I11 B0R B0L CANON JB
};

#define CIL_PARAMS                                                           \
  ContraInsideLogTables tabs, const float *__restrict__ LEN,                 \
      const float *__restrict__ scal, const int *__restrict__ ns,            \
      float *close, float *ext, float *one, float *rm_hist, float *rmm_hist, \
      int N

__global__ void contra_inside_log_kernel(CIL_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 33;                 // ring row: N lanes + window pad
  float* ring = smem;                    // RNA_WIN * LW
  float* len = ring + RNA_WIN * LW;      // RNA_LEN_SIZE
  float* s2r = len + RNA_LEN_SIZE;       // 2 * (N + 1), by span parity
  const float* H = tabs.t[0];
  const float* MBC = tabs.t[1];
  const float* ACC = tabs.t[2];
  const float* JS = tabs.t[3];
  const float* STK = tabs.t[4];
  const float* I11 = tabs.t[5];
  const float* B0R = tabs.t[6];
  const float* B0L = tabs.t[7];
  const float* CANON = tabs.t[8];
  const float* JB = tabs.t[9];

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  for (int e = i; e < RNA_WIN * LW; e += N) ring[e] = RNA_NEG;
  for (int e = i; e < RNA_LEN_SIZE; e += N) len[e] = LEN[e];
  for (int e = i; e < 2 * (N + 1); e += N) s2r[e] = RNA_NEG;
  const float* sc = scal + b * RNA_LOG_SCAL;
  const float eu = sc[0], ebp = sc[1], mbu = sc[2], mbbp = sc[3];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  __syncthreads();

  float rm = RNA_NEG, rmm = RNA_NEG;
  for (int d = 0; d < n; ++d) {
    // phase A: close from the window ring and the s2 rows (spans < d)
    const long long row = base + (long long)d * N + i;
    const float js = JS[row];
    const float stk_jb =
        rsub(STK[row], (d >= 2 && i + 1 < N)
                           ? JB[base + (long long)(d - 2) * N + i + 1]
                           : 0.0f);
    const float b0r = B0R[row], b0l = B0L[row], i11 = I11[row];
    float two = RNA_NEG;
    for (int a = 0; a < RNA_SHIFTS; ++a) {
      const int live = RNA_SHIFTS - a;
      const int lg = rna_log2_ceil(live);
      const float* lane = ring + i + 1 + a;
      RnaTree tr;
      float tsum = RNA_NEG;
      for (int m = 0; m < (1 << lg); ++m) {
        const int bb = rna_leaf(m, lg);
        float leaf = RNA_NEG;
        if (bb < live) {
          float body;
          if (a == 0 && bb == 0) {
            body = stk_jb;
          } else {
            body = radd(js, len[bb * RNA_SHIFTS + a]);
            if (a == 0 && bb == 1) body = radd(body, b0r);
            else if (a == 1 && bb == 0) body = radd(body, b0l);
            else if (a == 1 && bb == 1) body = radd(body, i11);
          }
          leaf = radd(body, lane[((d - 2 - a - bb) & (RNA_WIN - 1)) * LW]);
        }
        tsum = tr.push(m, leaf);
      }
      two = rna_lse_pair(two, tsum);
    }
    const float mb = d >= 2 ? radd(s2r[(d & 1) * (N + 1) + i + 1], MBC[row])
                            : RNA_NEG;
    float c = radd(rna_lse_pair(rna_lse_pair(H[row], two), mb), CANON[row]);
    if (d + 1 < RNA_MIN_SPAN_HAIRPIN_CLOSE) c = RNA_NEG;
    close[row] = c;
    const float acc = radd(c, ACC[row]);
    rm = rna_lse_pair(radd(rm, eu), radd(acc, ebp));
    rmm = rna_lse_pair(radd(rmm, mbu), radd(acc, mbbp));
    rm_hist[row] = rm;
    rmm_hist[row] = rmm;
    __syncthreads();

    // phase B: insert span d into the ring; bifurcation sums over the
    // rm/rmmb rows of spans <= d (all lanes now visible)
    ring[(d & (RNA_WIN - 1)) * LW + i] = radd(c, JB[row]);
    s2r[(d & 1) * (N + 1) + i] = rna_log_bifurcation<true>(
        rmul(eu, (float)(d + 1)), rmm, mbu, base, row, d, i, N, rm_hist,
        rmm_hist, ext, one);
    __syncthreads();
  }
}

extern "C" int rna_contra_inside_log(void** tables, const float* LEN,
                                     const float* scal, const int* ns,
                                     float* close, float* ext, float* one,
                                     float* rm_hist, float* rmm_hist, int B,
                                     int N, void* stream) {
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  ContraInsideLogTables tabs;
  for (int k = 0; k < 10; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem = sizeof(float) *
                       (RNA_WIN * (N + 33) + RNA_LEN_SIZE + 2 * (N + 1));
  return rna_launch(contra_inside_log_kernel, B, N, shmem, stream, tabs, LEN,
                    scal, ns, close, ext, one, rm_hist, rmm_hist, N);
}
