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
// output the recursion's, out[2k] = combine(scan[k-1], x[2k]).  Here that is
// the in-place up-sweep / down-sweep over W' = the least power of two >= the
// pair's live columns n2 - 1 (columns past them are -inf and never feed a
// live one, and a prefix's tree does not depend on the row's width):
//  * up-sweep level l: x[(k+1) 2^l - 1] = combine(x[k 2^l + 2^(l-1) - 1],
//    x[(k+1) 2^l - 1]), the combine of the recursion's pairs;
//  * down-sweep level l, k >= 1: x[(2k+1) 2^l - 1] = combine(x[2k 2^l - 1],
//    x[(2k+1) 2^l - 1]), the recursion's even outputs.
// The right operand's c is always an up-sweep aggregate of c, which does not
// depend on the row: the c tree is summed once a pass (its levels one after
// the other in `hc`) and the rows' sweeps move b alone.
//
// One block a pair, its threads over the columns (column j to thread
// j mod T), the rows in a loop, so N1 is unbounded; the previous row's
// M and I in double-buffered shared rows with a -inf slot before column 0,
// D in the scan's own shared row; each row takes a barrier after its cells,
// one after the scan's leaves and one after each tree level (~2 log2 W'
// a row).  A forward row's FM is stored as one contiguous row segment; a
// backward row's posterior context ssum (the JAX finish's reversed, shifted
// B planes, ends where the reversed cell is (0, 0)) as one reversed segment
// of forward row n1-2-i.  The corner (M, I, D at (n1-2, n2-2)) is written
// once.  Cells outside [0, n1-2] x [0, n2-2] are written with -inf, what the
// plain version holds there, before the rows start: every cell of the
// plane is written once.
//
// Every add is a round-to-nearest intrinsic (cubic.cuh's log-add too), so
// nvcc contracts nothing into an FMA: under "exact" and "parity" (the same
// cubic instance) the kernel computes bit for bit what the plain version
// and the eager JAX row scan compute.  The fast instance uses the hardware
// log-add (rna_lse_pair_fast).
//
// Bound: its cubic log-adds (three a cell and one a tree step, ~40
// instructions each) and its ~2 log2 W' barriers a row, with the row loop
// dependent from row to row.  One block a pair: a bucket of fewer pairs
// than the card has SMs (132) leaves SMs idle (the SSU-scale pairs of
// chip_smoke.py are 28 in a call); splitting a pair over blocks is a later
// lever.

#include "cubic.cuh"
#include "launch.cuh"

#define RNA_ROWS_PSEUDO 4
#define RNA_ROWS_NB 5        // base slots: A, C, G, U and the PSEUDO row
#define RNA_ROWS_MAX_N2 4096 // columns (the second sequence's bucket)
#define RNA_ROWS_MAX_T 1024

template <bool FAST>
__device__ __forceinline__ float rows_lse(float a, float b) {
  if constexpr (FAST)
    return rna_lse_pair_fast(a, b);
  else
    return rna_lse_pair(a, b);
}

// The shared row width of a launch: the least power of two >= N2.
static int rows_width(int N2) {
  int w = 1;
  while (w < N2) w <<= 1;
  return w;
}

// Dynamic shared memory at width W: M and I double-buffered and D, each
// with a slot before column 0; the c tree (2W); x2 (W ints); the emission
// tables.
static size_t rows_shared_bytes(int W) {
  return (5 * (W + 1) + 2 * W + RNA_ROWS_NB * RNA_ROWS_NB + RNA_ROWS_NB) *
             sizeof(float) +
         W * sizeof(int);
}

#define ROWS_PARAMS                                                         \
  const int *__restrict__ x1, const int *__restrict__ x2,                  \
      const int *__restrict__ n1s, const int *__restrict__ n2s,            \
      const float *__restrict__ ms, const float *__restrict__ ins,         \
      const float *__restrict__ scal, float *__restrict__ out,             \
      float *__restrict__ corner, int N1, int N2, int W, int backward
#define ROWS_ARGS x1, x2, n1s, n2s, ms, ins, scal, out, corner, N1, N2, W, backward

// One block per pair (blockIdx.x); B: the backward pass.
template <bool FAST, bool B>
__device__ __forceinline__ void rows_body(ROWS_PARAMS) {
  extern __shared__ float rows_smem[];
  float* mb = rows_smem;           // [2][1 + W]: M of rows i, i - 1
  float* ib = mb + 2 * (W + 1);    // [2][1 + W]: I
  float* sd = ib + 2 * (W + 1);    // [1 + W]: D, the scan's row
  float* hc = sd + (W + 1);        // [2W]: the c tree, level l at ofs(l)
  float* sms = hc + 2 * W;
  float* sins = sms + RNA_ROWS_NB * RNA_ROWS_NB;
  int* sx2 = reinterpret_cast<int*>(sins + RNA_ROWS_NB);

  const int p = blockIdx.x, t = threadIdx.x, T = blockDim.x;
  const int n1 = n1s[p], n2 = n2s[p];
  const float NEG = -INFINITY;
  // scal: m2m, m2i, ext, init_m, init_i
  const float m2m = scal[0], m2i = scal[1], ext = scal[2];
  const float init_m = scal[3], init_i = scal[4];
  const int rows = max(n1 - 1, 0);  // live rows 0 .. n1-2
  const int L = max(n2 - 1, 0);     // live columns 0 .. n2-2
  int Wp = 1, lg = 0;               // the tree's width and depth
  while (Wp < L) {
    Wp <<= 1;
    ++lg;
  }

  for (int e = t; e < RNA_ROWS_NB * RNA_ROWS_NB; e += T)
    sms[e] = ms[p * RNA_ROWS_NB * RNA_ROWS_NB + e];
  for (int e = t; e < RNA_ROWS_NB; e += T) sins[e] = ins[p * RNA_ROWS_NB + e];
  const int* s1 = x1 + (long long)p * N1;
  const int* s2 = x2 + (long long)p * N2;
  // the bases in this pass's coordinates (reversed by index backward)
  for (int c = t; c < W; c += T)
    sx2[c] = c < n2 ? s2[B ? n2 - 1 - c : c] : RNA_ROWS_PSEUDO;
  for (int e = t; e < 5 * (W + 1); e += T) mb[e] = NEG;  // mb, ib, sd
  // the cells outside [0, n1-2] x [0, n2-2]
  float* plane = out + (long long)p * N1 * N2;
  for (int r = 0; r < N1; ++r) {
    float* row = plane + (long long)r * N2;
    for (int c = (r < rows ? L : 0) + t; c < N2; c += T) row[c] = NEG;
  }
  __syncthreads();
  // the c tree: level 0 the leaves, level l the sums of level l - 1's pairs
  for (int j = t; j < Wp; j += T)
    hc[j] = j >= 1 && j < L ? __fadd_rn(ext, sins[sx2[j]]) : NEG;
  __syncthreads();
  for (int l = 1, ofs = 0; l <= lg; ++l) {
    const int prev = ofs;
    ofs += Wp >> (l - 1);
    for (int k = t; k < (Wp >> l); k += T)
      hc[ofs + k] = __fadd_rn(hc[prev + 2 * k], hc[prev + 2 * k + 1]);
    __syncthreads();
  }

  for (int i = 0; i < rows; ++i) {
    const int b1 = s1[B ? n1 - 1 - i : i];
    const float* msr = sms + b1 * RNA_ROWS_NB;
    const float ins1 = sins[b1];
    float* mc = mb + (i & 1) * (W + 1);  // column j at [1 + j]
    float* ic = ib + (i & 1) * (W + 1);
    const float* mp = mb + ((i + 1) & 1) * (W + 1);
    const float* ip = ib + ((i + 1) & 1) * (W + 1);
    // the cells' M and I, from row i - 1 (and D of row i - 1 in sd)
    for (int j = t; j < L; j += T) {
      float fm = NEG, fi = NEG;
      if (i >= 1) {
        if (j >= 1) {
          // match: from (i-1, j-1)
          const float tmm = i == 1 && j == 1 ? init_m : m2m;
          const float tm = rows_lse<FAST>(
              rows_lse<FAST>(__fadd_rn(mp[j], tmm), __fadd_rn(ip[j], m2i)),
              __fadd_rn(sd[j], m2i));
          fm = __fadd_rn(tm, msr[sx2[j]]);
        }
        // insert (gap in seq 2): from (i-1, j)
        const float tmi = i == 1 && j == 0 ? init_i : m2i;
        fi = __fadd_rn(rows_lse<FAST>(__fadd_rn(mp[1 + j], tmi),
                                      __fadd_rn(ip[1 + j], ext)),
                       ins1);
      } else if (j == 0) {
        fm = 0.0f;
      }
      mc[1 + j] = fm;
      ic[1 + j] = fi;
      if (!B) plane[(long long)i * N2 + j] = fm;
    }
    __syncthreads();
    // the scan's leaves: delete (gap in seq 1) from (i, j-1)
    for (int j = t; j < Wp; j += T) {
      float b = NEG;
      if (j >= 1 && j < L)
        b = __fadd_rn(__fadd_rn(mc[j], i == 0 && j == 1 ? init_i : m2i),
                      sins[sx2[j]]);
      sd[1 + j] = b;
    }
    __syncthreads();
    // up-sweep: level l combines level l - 1's pairs (2k, 2k + 1)
    for (int l = 1, ofs = 0; l <= lg; ++l) {
      const int h = 1 << (l - 1);
      for (int k = t; k < (Wp >> l); k += T) {
        const int pos = 1 + (k + 1) * 2 * h - 1;
        sd[pos] = rows_lse<FAST>(
            sd[pos], __fadd_rn(hc[ofs + 2 * k + 1], sd[pos - h]));
      }
      ofs += Wp >> (l - 1);
      __syncthreads();
    }
    // down-sweep: out[2k] = combine(scan[k - 1], x[2k]) at level l, k >= 1;
    // x[2k]'s c is level l's aggregate k' = 2k, at ofs(l) = 2 (Wp - Wp/2^l)
    for (int l = lg - 1; l >= 0; --l) {
      const int s = 1 << l, m = Wp >> (l + 1);
      if (m < 2) continue;
      const int o = 2 * (Wp - (Wp >> l));
      for (int k = 1 + t; k < m; k += T) {
        const int pos = 1 + (2 * k + 1) * s - 1;
        sd[pos] = rows_lse<FAST>(sd[pos],
                                 __fadd_rn(hc[o + 2 * k], sd[pos - s]));
      }
      __syncthreads();
    }
    // the row's outputs
    for (int j = t; j < L; j += T) {
      const float fm = mc[1 + j], fi = ic[1 + j], fd = sd[1 + j];
      if (i == rows - 1 && j == L - 1) {
        corner[3 * p] = fm;
        corner[3 * p + 1] = fi;
        corner[3 * p + 2] = fd;
      }
      if (B) {
        const float tend = i == 0 && j == 0 ? 0.0f : m2m;
        plane[(long long)(rows - 1 - i) * N2 + (L - 1 - j)] = rows_lse<FAST>(
            rows_lse<FAST>(__fadd_rn(fm, tend), __fadd_rn(m2i, fi)),
            __fadd_rn(m2i, fd));
      }
    }
  }
}

template <bool FAST>
__global__ void pairhmm_rows_kernel(ROWS_PARAMS) {
  if (backward)
    rows_body<FAST, true>(ROWS_ARGS);
  else
    rows_body<FAST, false>(ROWS_ARGS);
}

extern "C" int rna_pairhmm_rows(const int* x1, const int* x2, const int* n1s,
                                const int* n2s, const float* ms,
                                const float* ins, const float* scal,
                                float* out, float* corner, int P, int N1,
                                int N2, int backward, int fast, void* stream) {
  if (P < 1 || N1 < 1 || N2 < 1 || N2 > RNA_ROWS_MAX_N2)
    return (int)cudaErrorInvalidValue;
  const int W = rows_width(N2);
  const int T = W < 32 ? 32 : W > RNA_ROWS_MAX_T ? RNA_ROWS_MAX_T : W;
  const size_t shmem = rows_shared_bytes(W);
  if (fast)
    return rna_launch(pairhmm_rows_kernel<true>, P, T, shmem, stream, x1, x2,
                      n1s, n2s, ms, ins, scal, out, corner, N1, N2, W,
                      backward);
  return rna_launch(pairhmm_rows_kernel<false>, P, T, shmem, stream, x1, x2,
                    n1s, n2s, ms, ins, scal, out, corner, N1, N2, W,
                    backward);
}
