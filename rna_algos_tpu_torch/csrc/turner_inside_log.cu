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
// Bound: latency, as K16 (the same leaves, a few more loads each).  Design
// as K16: one block per sequence, thread i = lane i; four 32-slot window
// rings in shared memory (close + AUGT and the three inner
// terminal-mismatch tables TMi1..3 of each finished span, 148 KB at
// N = 256, under the 227 KB a block may have), the rm history in global
// scratch in [d, i] layout.

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
      float *rm_hist, int N

__global__ void turner_inside_log_kernel(TIL_PARAMS) {
  extern __shared__ float smem[];
  const int LW = N + 33;
  const int RING = RNA_WIN * LW;
  float* caw = smem;                     // close + AUGT
  float* tw = smem + RING;               // TMi1..3 rings, RING apart
  float* lenb = smem + 4 * RING;
  float* leni = lenb + RNA_LEN_SIZE;
  float* s2r = leni + RNA_LEN_SIZE;      // 2 * (N + 1), by span parity
  const float* H = tabs.t[0];
  const float* MBC = tabs.t[1];
  const float* ACC = tabs.t[2];
  const float* CANON = tabs.t[3];
  const float* AUGT = tabs.t[14];

  const int b = blockIdx.x;
  const int i = threadIdx.x;
  for (int e = i; e < 4 * RING; e += N) smem[e] = RNA_NEG;
  for (int e = i; e < RNA_LEN_SIZE; e += N) {
    lenb[e] = LENB[e];
    leni[e] = LENI[e];
  }
  for (int e = i; e < 2 * (N + 1); e += N) s2r[e] = RNA_NEG;
  const float coeff = scal[b * RNA_LOG_SCAL];
  const int n = ns[b];
  const long long base = (long long)b * N * N;
  __syncthreads();

  float rm = RNA_NEG;
  for (int d = 0; d < n; ++d) {
    const long long row = base + (long long)d * N + i;
    float sp[7], tm[3];
#pragma unroll
    for (int k = 0; k < 7; ++k) sp[k] = tabs.t[4 + k][row];
#pragma unroll
    for (int k = 0; k < 3; ++k) tm[k] = tabs.t[11 + k][row];
    const float aug = AUGT[row];
    float two = RNA_NEG;
    for (int a = 0; a < RNA_SHIFTS; ++a) {
      const int live = RNA_SHIFTS - a;
      const int lg = rna_log2_ceil(live);
      const int lane = i + 1 + a;
      RnaTree tr;
      float tsum = RNA_NEG;
      for (int m = 0; m < (1 << lg); ++m) {
        const int bb = rna_leaf(m, lg);
        float leaf = RNA_NEG;
        if (bb < live) {
          const int at = ((d - 2 - a - bb) & (RNA_WIN - 1)) * LW + lane;
          leaf = rna_turner_leaf(a, bb, lenb, leni, sp, tm, aug, caw[at],
                                 tw[at], tw[RING + at], tw[2 * RING + at]);
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
    rm = rna_lse_pair(rm, radd(c, ACC[row]));
    rm_hist[row] = rm;
    __syncthreads();

    const int slot = (d & (RNA_WIN - 1)) * LW + i;
    caw[slot] = radd(c, aug);
#pragma unroll
    for (int k = 0; k < 3; ++k) tw[k * RING + slot] = tabs.t[15 + k][row];
    s2r[(d & 1) * (N + 1) + i] = rna_log_bifurcation<false>(
        0.0f, radd(rm, coeff), coeff, base, row, d, i, N, rm_hist, rm_hist,
        ext, one);
    __syncthreads();
  }
}

extern "C" int rna_turner_inside_log(void** tables, const float* LENB,
                                     const float* LENI, const float* scal,
                                     const int* ns, float* close, float* ext,
                                     float* one, float* rm_hist, int B,
                                     int N, void* stream) {
  if (!rna_log_shape_ok(N)) return (int)cudaErrorInvalidValue;
  TurnerInsideLogTables tabs;
  for (int k = 0; k < TIL_COUNT; ++k) tabs.t[k] = (const float*)tables[k];
  const size_t shmem =
      sizeof(float) *
      (4 * RNA_WIN * (N + 33) + 2 * RNA_LEN_SIZE + 2 * (N + 1));
  return rna_launch(turner_inside_log_kernel, B, N, shmem, stream, tabs, LENB,
                    LENI, scal, ns, close, ext, one, rm_hist, N);
}
