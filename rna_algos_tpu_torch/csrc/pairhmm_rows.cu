// K22: one pass of the Durbin pair-HMM row scan, forward or backward.
//
// Replaces no TPU kernel: it is the JAX package's XLA row scan,
// rna_algos_tpu/models/durbin.py:52 _pairhmm_rows with its delete-state
// lax.associative_scan (:40 _linrec_lse), which serves every pair bucket the
// wavefronts K14/K15 (pairhmm.cu) do not take: rectangular buckets and
// buckets past 256.  The plain version is ops/pairhmm_rows.py.
//
// Row i of the fill is computed from row i - 1: the match and insert states
// M[i, j], I[i, j] cell by cell, then the delete state of the whole row as a
// prefix scan x[j] = lse(b[j], c[j] + x[j-1]) (b = M[i, j-1] + t + ins2[j],
// c = ext + ins2[j]).  JAX sums that scan through lax.associative_scan, whose
// combine on (c, b) elements is (cl + cr, lse(br, cr + bl)), and the cubic
// log-add is neither associative nor shift-invariant, so the bits follow its
// tree: pairs (2k, 2k+1) combined, the halves scanned recursively, each odd
// output the recursion's, out[2k] = combine(scan[k-1], x[2k]).  That is the
// in-place up-sweep / down-sweep over any power of two W >= the pair's live
// columns n2 - 1 (columns past them are -inf and never feed a live one; a
// prefix's tree does not depend on the row's width):
//  * up-sweep level l: x[(k+1) 2^l - 1] = combine(x[k 2^l + 2^(l-1) - 1],
//    x[(k+1) 2^l - 1]), the combine of the recursion's pairs;
//  * down-sweep level l, k >= 1: x[(2k+1) 2^l - 1] = combine(x[2k 2^l - 1],
//    x[(2k+1) 2^l - 1]), the recursion's even outputs.
// The right operand's c is always an up-sweep aggregate of c, which does not
// depend on the row: the c tree is summed once a pass and the rows' sweeps
// move b alone.  Any schedule that gives every node its two operands gives
// the same bits, so the tree is summed where its operands are:
//  * a thread owns a run of R contiguous columns (RowsRegs: R = 2 in
//    registers): the run's previous row M, I, D and its c subtree; the
//    tree's lowest log2 R levels are the run's own, in registers;
//  * the next five levels across a warp's lanes by __shfl_up_sync (lane t
//    combines with lane t - 2^m at level m);
//  * the levels over a block's warps in every warp, over the warps'
//    aggregates (one shared slot a warp); the levels over a cluster's
//    blocks in every warp too, over the block aggregates that each block
//    writes into every block of its cluster (distributed shared memory);
//  * the down-sweep back the same way, each warp and each block given the
//    final value at the column before it (its carry).
// A row takes two block barriers (after the cells: the M and I at each
// warp's edge; after the warp aggregates, which every warp then sums
// itself), and with a cluster the first is a cluster barrier and one more
// comes after the block aggregates.  A column's neighbours come by
// shuffle, and across a warp's or a block's edge through one shared slot.
//
// One pair runs on a cluster of C blocks of T threads, T C R = W columns, W
// the least power of two >= max(N2, 64): one block up to 512 columns, a
// cluster past them (rows_plan); past 8,192 columns (8 blocks of 512
// threads) the run is longer than the registers hold and lives in a
// global scratch that the wrapper allocates (RowsGlobal, the same body).
// No cap on N1 (the rows are a loop) or N2.  Every plane cell is written
// once: a forward row's FM as row segments, a backward row's posterior
// context ssum (the JAX finish's reversed, shifted B planes, ends where the
// reversed cell is (0, 0)) as one reversed segment of forward row
// n1-2-i, the cells outside [0, n1-2] x [0, n2-2] with -inf in the same
// sweep.  The corner (M, I, D at (n1-2, n2-2)) is written once.
//
// Every add is a round-to-nearest intrinsic (the log-add's too: K22's
// branch-free copy of cubic.cuh's), so nvcc contracts nothing into an FMA:
// under "exact" and "parity" (the same cubic instance) the kernel computes
// bit for bit what the plain version and the eager JAX row scan compute.
// The fast instance uses the hardware log-add (rna_lse_pair_fast's).
//
// Bound: the rows depend on each other, and a row's tree is ~2 log2 W
// dependent log-adds, each a level of the tree; the cells' three log-adds
// and the backward outputs' two are independent across columns.  So a
// pass is each warp's chain of log-adds, row after row: every log-add is
// branch-free (the compiler interleaves the independent ones), a
// backward row's outputs are computed during the next row's sweep up, a
// run's levels need no shuffle, and a row takes two barriers.  More
// blocks a pair do not shorten the chain (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cubic.cuh"

namespace cg = cooperative_groups;

#define RNA_ROWS_PSEUDO 4
#define RNA_ROWS_NB 5         // base slots: A, C, G, U and the PSEUDO row
#define RNA_ROWS_R 2          // columns a thread in registers
#define RNA_ROWS_T 256        // threads a block, while 8 blocks hold a pair
#define RNA_ROWS_MAX_T 512    // threads a block
#define RNA_ROWS_MAX_C 8      // blocks a cluster (the portable size)
#define RNA_ROWS_SCRATCH 7    // scratch rows of W floats a pair (RowsGlobal)
#define RNA_ROWS_FULL 0xffffffffu

// cubic.cuh's ln(1 + e^x) coefficients, one float4 a segment, a copy a
// block (loaded before the first log-add)
__shared__ float4 rows_cubic[8];

// rna_lse_pair bit for bit without its branches, so that the compiler can
// interleave independent log-adds: z's segment is the count of breaks <=
// z (they ascend: rna_ln_exp_1p's last break z passes), its coefficients
// one float4 from rows_cubic, the Horner steps and the add cubic.cuh's;
// an operand -inf (z NaN or +inf) and z past the threshold take its other
// cases by selects.
__device__ __forceinline__ float rows_cubic_lse(float a, float b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  const float z = __fsub_rn(hi, lo);
  int seg = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) seg += z >= kLnBreaks[k];
  const float4 c = rows_cubic[seg];
  const float h = __fadd_rn(__fmul_rn(c.x, z), c.y);
  const float f =
      __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(h, z), c.z), z), c.w);
  const float past = lo > -INFINITY ? __fadd_rn(lo, z) : hi;
  return z < RNA_LSE_THRESHOLD ? __fadd_rn(lo, f) : past;
}

// rna_lse_pair_fast bit for bit, its -inf case by a select
__device__ __forceinline__ float rows_fast_lse(float a, float b) {
  const float r = __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(__fsub_rn(a, b)))));
  return isinf(a) && a == b ? a : r;
}

template <bool FAST>
__device__ __forceinline__ float rows_lse(float a, float b) {
  if constexpr (FAST)
    return rows_fast_lse(a, b);
  else
    return rows_cubic_lse(a, b);
}

// A barrier of the row loop: the cluster's when C > 1, else the block's.
__device__ __forceinline__ void rows_sync(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Level l of a run's c tree starts at ct(ofs(l)) (level 0 the R leaves).
__host__ __device__ constexpr int rows_ofs(int R, int l) {
  return 2 * R - ((2 * R) >> l);
}

// A thread's run in registers: the previous row's M, I and D of its R
// columns (updated in place), their bases and insert scores, and the run's
// c tree.
template <int RR>
struct RowsRegs {
  static constexpr int R = RR;
  float m_[RR], i_[RR], d_[RR], ins_[RR], ct_[2 * RR];
  int x_[RR];
  __device__ float& m(int k) { return m_[k]; }
  __device__ float& i(int k) { return i_[k]; }
  __device__ float& d(int k) { return d_[k]; }
  __device__ float& ins2(int k) { return ins_[k]; }
  __device__ float& ct(int k) { return ct_[k]; }
  __device__ int& x2(int k) { return x_[k]; }
};

// The same run in a global scratch (RNA_ROWS_SCRATCH rows of W a pair:
// M, I, D, ins2, the bases, then the runs' c trees, 2R a thread), for runs
// longer than the registers hold.  Only its own thread touches a run.
struct RowsGlobal {
  int R;
  float *m_, *i_, *d_, *ins_, *ct_;
  int* x_;
  __device__ RowsGlobal(float* pair, int W, int first, int R_)
      : R(R_),
        m_(pair + first),
        i_(pair + W + first),
        d_(pair + 2 * W + first),
        ins_(pair + 3 * W + first),
        ct_(pair + 5 * W + 2 * first),
        x_(reinterpret_cast<int*>(pair + 4 * W) + first) {}
  __device__ float& m(int k) { return m_[k]; }
  __device__ float& i(int k) { return i_[k]; }
  __device__ float& d(int k) { return d_[k]; }
  __device__ float& ins2(int k) { return ins_[k]; }
  __device__ float& ct(int k) { return ct_[k]; }
  __device__ int& x2(int k) { return x_[k]; }
};

struct RowsArgs {
  const int *x1, *x2, *n1s, *n2s;
  const float *ms, *ins, *scal;
  float *out, *corner, *scratch;
  int N1, N2, W, C, backward;
};

// Warp-wide sweeps over one value a lane (lane u the u-th unit: a thread's
// run, a block's warp or a cluster's block) through levels 0 .. lv - 1 of
// units.  cs[m]: the c sum of the 2^m units ending at this one.
template <bool FAST>
__device__ __forceinline__ float rows_up(float v, const float* cs, int lv,
                                         int lane) {
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    if (m >= lv) break;
    const float u = __shfl_up_sync(RNA_ROWS_FULL, v, 1 << m);
    const float w = rows_lse<FAST>(v, __fadd_rn(cs[m], u));
    v = ((lane + 1) & ((2 << m) - 1)) == 0 ? w : v;
  }
  return v;
}

// The down-sweep of those levels; `carry` is the final value at the unit
// before unit 0, combined in only when `has_carry` (not the pair's first).
template <bool FAST>
__device__ __forceinline__ float rows_down(float v, const float* cs, int lv,
                                           int lane, float carry,
                                           bool has_carry) {
#pragma unroll
  for (int m = 4; m >= 0; --m) {
    if (m >= lv) continue;
    const int s = 1 << m;
    const float u = __shfl_up_sync(RNA_ROWS_FULL, v, s);
    const float w = rows_lse<FAST>(v, __fadd_rn(cs[m], lane >= s ? u : carry));
    v = ((lane + 1) & (2 * s - 1)) == s && (lane >= s || has_carry) ? w : v;
  }
  return v;
}

// The c sums of those levels: cs[m] as above; returns the sum of the 2^lv
// units ending at this one (the total at lane 2^lv - 1).
__device__ __forceinline__ float rows_csums(float s, float* cs, int lv,
                                            int lane) {
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    if (m >= lv) break;
    cs[m] = s;
    const float u = __shfl_up_sync(RNA_ROWS_FULL, s, 1 << m);
    if (((lane + 1) & ((2 << m) - 1)) == 0) s = __fadd_rn(u, s);
  }
  return s;
}

__device__ __forceinline__ int rows_log2(int x) { return 31 - __clz(x); }

// Backward row i's outputs at a run of R columns from its M, I, D: the
// posterior context ssum into row rows-1-i, reversed (-inf past the box);
// every log-add computed, the stores by column.
template <bool FAST>
__device__ __forceinline__ void rows_outputs(float* plane, const float* fm,
                                             const float* fi, const float* fd,
                                             int R, int first, int i,
                                             int rows, int L, int N2,
                                             float m2m, float m2i) {
  float* out = plane + (long long)(rows - 1 - i) * N2;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int j = first + k;
    const float tend = i == 0 && j == 0 ? 0.0f : m2m;
    const float ss = rows_lse<FAST>(
        rows_lse<FAST>(__fadd_rn(fm[k], tend), __fadd_rn(m2i, fi[k])),
        __fadd_rn(m2i, fd[k]));
    if (j < L)
      out[L - 1 - j] = ss;
    else if (j < N2)
      out[j] = -INFINITY;
  }
}

// One pair on a cluster of a.C blocks (B: the backward pass), runs of RR
// columns (RR = 0: S.R).
template <bool FAST, bool B, int RR, class Run>
__device__ __forceinline__ void rows_body(const RowsArgs& a, Run& S, int r,
                                          int p, int first) {
  __shared__ float sms[RNA_ROWS_NB * RNA_ROWS_NB], sins[RNA_ROWS_NB];
  __shared__ float wagg[32];      // the warps' up-sweep aggregates (c sums)
  __shared__ float edge[32][2];   // edge[q]: row i's M, I before warp q
  __shared__ float bagg[RNA_ROWS_MAX_C], bc[RNA_ROWS_MAX_C];  // the blocks'

  const int C = a.C, t = threadIdx.x, T = blockDim.x;
  const int lane = t & 31, q = t >> 5, NW = T >> 5;
  const int lw = rows_log2(NW), lc = rows_log2(C);
  const int R = RR > 0 ? RR : S.R, lr = rows_log2(R);
  const int N1 = a.N1, N2 = a.N2;
  const int n1 = a.n1s[p], n2 = a.n2s[p];
  const float NEG = -INFINITY;
  // scal: m2m, m2i, ext, init_m, init_i
  const float m2m = a.scal[0], m2i = a.scal[1], ext = a.scal[2];
  const float init_m = a.scal[3], init_i = a.scal[4];
  const int rows = max(n1 - 1, 0);  // live rows 0 .. n1-2
  const int L = max(n2 - 1, 0);     // live columns 0 .. n2-2
  const bool live = ((r * NW + q) * 32) * R < L;  // the warp has one
  const bool lead_warp = r == 0 && q == 0, lead = lead_warp && lane == 0;
  cg::cluster_group cluster = cg::this_cluster();

  for (int e = t; e < RNA_ROWS_NB * RNA_ROWS_NB; e += T)
    sms[e] = a.ms[p * RNA_ROWS_NB * RNA_ROWS_NB + e];
  for (int e = t; e < RNA_ROWS_NB; e += T) sins[e] = a.ins[p * RNA_ROWS_NB + e];
  for (int e = t; e < 8; e += T)
    rows_cubic[e] = make_float4(kLnCoeffs[e][0], kLnCoeffs[e][1],
                                kLnCoeffs[e][2], kLnCoeffs[e][3]);
  __syncthreads();
  const int* s1 = a.x1 + (long long)p * N1;
  const int* s2 = a.x2 + (long long)p * N2;
  // the run: bases in this pass's coordinates (reversed by index
  // backward), row -1 all -inf, the c leaves and the run's c tree
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int c = first + k;
    const int x = c < n2 ? s2[B ? n2 - 1 - c : c] : RNA_ROWS_PSEUDO;
    S.x2(k) = x;
    S.ins2(k) = sins[x];
    S.m(k) = S.i(k) = S.d(k) = NEG;
    S.ct(k) = c >= 1 && c < L ? __fadd_rn(ext, sins[x]) : NEG;
  }
#pragma unroll
  for (int l = 1; (1 << l) <= R; ++l)
#pragma unroll
    for (int k = 0; k < (R >> l); ++k)
      S.ct(rows_ofs(R, l) + k) = __fadd_rn(S.ct(rows_ofs(R, l - 1) + 2 * k),
                                           S.ct(rows_ofs(R, l - 1) + 2 * k + 1));
  // the c sums of the warp's, the block's and the cluster's levels
  float cw[5], cb[5], cc[5];
  const float wtot = rows_csums(S.ct(2 * R - 2), cw, 5, lane);
  if (lane == 31) wagg[q] = wtot;
  if (C > 1) cluster.sync();  // every block running before the first write
  __syncthreads();
  {  // every warp holds the block's and the cluster's c sums
    const float btot = rows_csums(lane < NW ? wagg[lane] : NEG, cb, lw, lane);
    const float tot = __shfl_sync(RNA_ROWS_FULL, btot, NW - 1);
    if (C > 1 && q == 0 && lane < C) cluster.map_shared_rank(bc, lane)[r] = tot;
  }
  if (C > 1) cluster.sync();
  if (C > 1) rows_csums(lane < C ? bc[lane] : NEG, cc, lc, lane);

  float* plane = a.out + (long long)p * N1 * N2;
  // the last column before this run's, in row i - 1: M, I, D
  float hm = NEG, hi = NEG, hd = NEG;
  // backward, a live run in registers: a row's M, I, D kept for its
  // outputs, which the next row computes during its sweep up (independent
  // of it, so they fill the log-adds' latency there)
  constexpr int RO = B && RR > 0 ? RR : 1;
  float om[RO], oi[RO], od[RO];
  int b1_next = rows ? s1[B ? n1 - 1 : 0] : 0;  // each row's base a row ahead
  for (int i = 0; i < rows; ++i) {
    const int b1 = b1_next;
    if (i + 1 < rows) b1_next = s1[B ? n1 - 2 - i : i + 1];
    const float* msr = sms + b1 * RNA_ROWS_NB;
    const float ins1 = sins[b1];
    float lm = NEG, li = NEG;  // row i's M, I at the column before the run
    if (live) {
      // the cells' M and I from row i - 1, from the run's last column down
      // so that column k - 1's row i - 1 values are still there; every
      // log-add computed and the case taken by selects
#pragma unroll
      for (int k = R - 1; k >= 0; --k) {
        const int j = first + k;
        const float pm = k ? S.m(k - 1) : hm, pi = k ? S.i(k - 1) : hi;
        const float pd = k ? S.d(k - 1) : hd;
        // match: from (i-1, j-1)
        const float tmm = i == 1 && j == 1 ? init_m : m2m;
        const float tm = rows_lse<FAST>(
            rows_lse<FAST>(__fadd_rn(pm, tmm), __fadd_rn(pi, m2i)),
            __fadd_rn(pd, m2i));
        // insert (gap in seq 2): from (i-1, j)
        const float tmi = i == 1 && j == 0 ? init_i : m2i;
        const float ti = rows_lse<FAST>(__fadd_rn(S.m(k), tmi),
                                        __fadd_rn(S.i(k), ext));
        const bool cell = j < L && i >= 1;
        S.m(k) = cell && j >= 1 ? __fadd_rn(tm, msr[S.x2(k)])
                 : i == 0 && j == 0 && j < L ? 0.0f
                                              : NEG;
        S.i(k) = cell ? __fadd_rn(ti, ins1) : NEG;
      }
      lm = __shfl_up_sync(RNA_ROWS_FULL, S.m(R - 1), 1);
      li = __shfl_up_sync(RNA_ROWS_FULL, S.i(R - 1), 1);
      if (lane == 31) {
        float* to = q + 1 < NW ? edge[q + 1]
                    : r + 1 < C ? cluster.map_shared_rank(&edge[0][0], r + 1)
                                : nullptr;
        if (to) {
          to[0] = S.m(R - 1);
          to[1] = S.i(R - 1);
        }
      }
    }
    if (!B) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (first + k < N2) plane[(long long)i * N2 + first + k] = S.m(k);
    }
    rows_sync(C);  // the edges' M and I
    if (live) {
      if (lane == 0) {
        lm = lead ? NEG : edge[q][0];
        li = lead ? NEG : edge[q][1];
      }
      // the scan's leaves: delete (gap in seq 1) from (i, j-1)
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int j = first + k;
        const float b = __fadd_rn(__fadd_rn(k ? S.m(k - 1) : lm,
                                            i == 0 && j == 1 ? init_i : m2i),
                                  S.ins2(k));
        S.d(k) = j >= 1 && j < L ? b : NEG;
      }
      if constexpr (B && RR > 0) {
        if (i > 0)
          rows_outputs<FAST>(plane, om, oi, od, R, first, i - 1, rows, L, N2,
                             m2m, m2i);
      }
      // up-sweep: the run's levels, then the warp's
#pragma unroll
      for (int l = 1; (1 << l) <= R; ++l) {
        const int h = 1 << (l - 1);
#pragma unroll
        for (int k = 2 * h - 1; k < R; k += 2 * h)
          S.d(k) = rows_lse<FAST>(
              S.d(k), __fadd_rn(S.ct(rows_ofs(R, l - 1) + (k >> (l - 1))),
                                S.d(k - h)));
      }
      S.d(R - 1) = rows_up<FAST>(S.d(R - 1), cw, 5, lane);
      if (lane == 31) wagg[q] = S.d(R - 1);
    } else if (lane == 31) {
      wagg[q] = NEG;
    }
    rows_sync(1);  // the warps' aggregates
    // every warp sums the block's levels over the warps' aggregates (lane u
    // warp u), and with a cluster the blocks' levels over the blocks'
    // aggregates, itself: no barrier after them
    float v = rows_up<FAST>(lane < NW ? wagg[lane] : NEG, cb, lw, lane);
    float bcarry = NEG, bfinal = NEG;  // D final before, at the block's end
    if (C > 1) {
      const float tot = __shfl_sync(RNA_ROWS_FULL, v, NW - 1);
      if (q == 0 && lane < C) cluster.map_shared_rank(bagg, lane)[r] = tot;
      rows_sync(C);  // the blocks' aggregates
      float u = rows_up<FAST>(lane < C ? bagg[lane] : NEG, cc, lc, lane);
      u = rows_down<FAST>(u, cc, lc, lane, NEG, false);
      const float before = __shfl_sync(RNA_ROWS_FULL, u, r > 0 ? r - 1 : 0);
      bfinal = __shfl_sync(RNA_ROWS_FULL, u, r);
      if (r > 0) bcarry = before;
    }
    v = rows_down<FAST>(v, cb, lw, lane, bcarry, r > 0);
    // the block's last column: final at the cluster's levels (C = 1: its
    // up-sweep value is the row's total, final)
    if (C > 1 && lane == NW - 1) v = bfinal;
    // D final before warp q and at its last column
    const float before_q = __shfl_sync(RNA_ROWS_FULL, v, q > 0 ? q - 1 : 0);
    const float end_q = __shfl_sync(RNA_ROWS_FULL, v, q);
    if (live) {
      // down-sweep: the warp's levels, then the run's
      const float carry = q > 0 ? before_q : bcarry;
      const float top = rows_down<FAST>(lane == 31 ? end_q : S.d(R - 1), cw,
                                        5, lane, carry, !lead_warp);
      S.d(R - 1) = top;
      float prev = __shfl_up_sync(RNA_ROWS_FULL, top, 1);
      if (lane == 0) prev = carry;
#pragma unroll
      for (int l = lr - 1; l >= 0; --l) {
        const int s = 1 << l;
#pragma unroll
        for (int k = s - 1; k < R; k += 2 * s) {
          const float w = rows_lse<FAST>(
              S.d(k), __fadd_rn(S.ct(rows_ofs(R, l) + (k >> l)),
                                k >= s ? S.d(k - s) : prev));
          S.d(k) = k >= s || !lead ? w : S.d(k);
        }
      }
      hm = lm;
      hi = li;
      hd = prev;
    }
    // the corner; backward, the row's outputs (or its values for them)
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (i == rows - 1 && first + k == L - 1) {
        a.corner[3 * p] = S.m(k);
        a.corner[3 * p + 1] = S.i(k);
        a.corner[3 * p + 2] = S.d(k);
      }
    if constexpr (B) {
      if (RR > 0 && live) {
#pragma unroll
        for (int k = 0; k < RO; ++k) {
          om[k] = S.m(k);
          oi[k] = S.i(k);
          od[k] = S.d(k);
        }
      } else {
        rows_outputs<FAST>(plane, &S.m(0), &S.i(0), &S.d(0), R, first, i,
                           rows, L, N2, m2m, m2i);
      }
    }
  }
  if constexpr (B && RR > 0) {
    if (live && rows > 0)
      rows_outputs<FAST>(plane, om, oi, od, R, first, rows - 1, rows, L, N2,
                         m2m, m2i);
  }
  // the rows past the box
  for (int row = rows; row < N1; ++row)
#pragma unroll
    for (int k = 0; k < R; ++k)
      if (first + k < N2) plane[(long long)row * N2 + first + k] = NEG;
  if (C > 1) cluster.sync();  // no block leaves while a peer writes to it
}

// RR > 0: runs of RR columns in registers; RR = 0: runs in the scratch.
template <bool FAST, int RR>
__global__ void __launch_bounds__(RNA_ROWS_MAX_T)
    pairhmm_rows_kernel(RowsArgs a) {
  const int r = a.C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int p = blockIdx.x / a.C;
  const int gt = r * blockDim.x + threadIdx.x;
  if constexpr (RR > 0) {
    RowsRegs<RR> S;
    if (a.backward)
      rows_body<FAST, true, RR>(a, S, r, p, gt * RR);
    else
      rows_body<FAST, false, RR>(a, S, r, p, gt * RR);
  } else {
    const int R = a.W / (blockDim.x * a.C);
    RowsGlobal S(a.scratch + (long long)p * RNA_ROWS_SCRATCH * a.W, a.W,
                 gt * R, R);
    if (a.backward)
      rows_body<FAST, true, 0>(a, S, r, p, gt * R);
    else
      rows_body<FAST, false, 0>(a, S, r, p, gt * R);
  }
}

// Whether a cluster of C blocks of T threads of `kernel` can be resident.
template <typename Kernel>
static bool rows_fits(Kernel kernel, int C, int T) {
  if (C == 1) return true;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(T);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return active >= 1;
}

static int rows_pow2(int n) {
  int w = 1;
  while (w < n) w <<= 1;
  return w;
}

// The launch of a pass at N2 columns: plan[0..4] = W, T, C, R and 1 when
// the runs live in the scratch.  Blocks of at most RNA_ROWS_T threads, as
// few as hold the runs, while RNA_ROWS_MAX_C of them do; then blocks of up
// to RNA_ROWS_MAX_T.  A pass is each warp's chain of dependent log-adds a
// row, about two a level of the tree, so what a level costs decides: one
// over the warps of a block or over the blocks of a cluster (PERF.md: at
// the SSU bucket 4 blocks of 256 threads beat 2 of 512; where one block of
// 256 holds the runs, 2-8 blocks ran 19-106% slower).  Past
// RNA_ROWS_MAX_C blocks of RNA_ROWS_MAX_T threads of RNA_ROWS_R columns,
// the runs go to the scratch with the largest C that fits.
static void rows_plan(int N2, bool fast, int* plan) {
  const int W = rows_pow2(N2 > 32 * RNA_ROWS_R ? N2 : 32 * RNA_ROWS_R);
  const bool regs = W <= RNA_ROWS_R * RNA_ROWS_MAX_T * RNA_ROWS_MAX_C;
  void* k = regs ? (fast ? (void*)pairhmm_rows_kernel<true, RNA_ROWS_R>
                         : (void*)pairhmm_rows_kernel<false, RNA_ROWS_R>)
                 : (fast ? (void*)pairhmm_rows_kernel<true, 0>
                         : (void*)pairhmm_rows_kernel<false, 0>);
  const int units = regs ? W / RNA_ROWS_R : W;  // runs if one column each
  int C;
  if (regs) {
    C = units > RNA_ROWS_T ? units / RNA_ROWS_T : 1;
    if (C > RNA_ROWS_MAX_C) C = units / RNA_ROWS_MAX_T;
  } else {
    C = RNA_ROWS_MAX_C;
    while (C > 1 && !rows_fits(k, C, RNA_ROWS_MAX_T)) C /= 2;
  }
  const int T = regs ? units / C
                     : (W / C < RNA_ROWS_MAX_T ? W / C : RNA_ROWS_MAX_T);
  plan[0] = W;
  plan[1] = T;
  plan[2] = C;
  plan[3] = W / (T * C);
  plan[4] = regs ? 0 : 1;
}

template <typename Kernel>
static int rows_launch(Kernel kernel, int P, int T, int C, void* stream,
                       const RowsArgs& a) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(P * C);
  cfg.blockDim = dim3(T);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The plan of a pass (rows_plan): W, T, C, R and whether the runs live in
// the scratch of RNA_ROWS_SCRATCH x W floats a pair.
extern "C" int rna_pairhmm_rows_plan(int N2, int fast, int* plan) {
  if (N2 < 1) return (int)cudaErrorInvalidValue;
  rows_plan(N2, fast != 0, plan);
  return 0;
}

extern "C" int rna_pairhmm_rows(const int* x1, const int* x2, const int* n1s,
                                const int* n2s, const float* ms,
                                const float* ins, const float* scal,
                                float* out, float* corner, float* scratch,
                                int P, int N1, int N2, int backward, int fast,
                                void* stream) {
  if (P < 1 || N1 < 1 || N2 < 1) return (int)cudaErrorInvalidValue;
  int plan[5];
  rows_plan(N2, fast != 0, plan);
  const int W = plan[0], T = plan[1], C = plan[2];
  if (plan[4] && !scratch) return (int)cudaErrorInvalidValue;
  const RowsArgs a = {x1,  x2,     n1s,     n2s, ms, ins, scal, out,
                      corner, scratch, N1, N2, W, C, backward};
  if (plan[4])
    return fast ? rows_launch(pairhmm_rows_kernel<true, 0>, P, T, C, stream, a)
                : rows_launch(pairhmm_rows_kernel<false, 0>, P, T, C, stream,
                              a);
  return fast ? rows_launch(pairhmm_rows_kernel<true, RNA_ROWS_R>, P, T, C,
                            stream, a)
              : rows_launch(pairhmm_rows_kernel<false, RNA_ROWS_R>, P, T, C,
                            stream, a);
}
