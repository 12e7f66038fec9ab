// Kernels K20 and K21: one span of the generic-N McCaskill scan
// (rna_algos_tpu/models/mccaskill.py `_inside` :72 and `_outside` :179),
// the path the JAX package runs through XLA for the buckets its TPU
// kernels do not take.  ops/fold_scan.py launches K20 once per span d =
// 0 .. N-1 and K21 once per span d = N-1 .. 0.
//
// One block per live lane: blockIdx.x = i, blockIdx.y = sequence b, the
// block leaves at once when i + d >= n.  State tables are (B, N, N)
// float32 in global memory, left layout [b][i][d] = state(i, i + d) (close,
// ext, mb, one; bppo, G) or right layout [b][j][e] = state(j - e, j)
// (rm, rmmb, one; pm, pm2), so every O(d) sum reads a contiguous row.
//
// Every sum is numerics.lse_reduce's halving tree (x[k] (+) x[k + half])
// at the term index the JAX scan gives it: the 2-loop window at a*31 + b,
// the O(d) sums at t, the multibranch context at t, N + t and 2N + t.
// Thread `tid` of T holds the leaves tid + m*T, m < L (the least power of
// two with L * T >= the tree's extent, at most 2^SCAN_MAX_LG), so the tree
// over L T leaves is a halving tree over each thread's leaves, then one
// over the T threads; leaves past the live terms are -inf, and as
// lse_pair(x, -inf) = x bit for bit, that is the JAX tree over its wider
// power of two.  The cubic log-add and every add are round-to-nearest
// intrinsics (cubic.cuh), so under "exact" and "parity" a kernel and its
// plain version agree bit for bit.  FAST: torch.logaddexp for a pair and
// the max-form m + log(sum exp(x - m)) for a tree, with a running max.
#include <cuda_runtime.h>
#include <math.h>

#include "cubic.cuh"

#define SCAN_W 31                  // 2-loop window extent
#define SCAN_WIN (SCAN_W * SCAN_W) // its 961 terms
#define SCAN_MAX_LG 7              // at most 2^7 tree leaves a thread
#define SCAN_MIN_T 32
#define SCAN_MAX_T 1024
#define SCAN_TREES 4               // trees reduced together at most
#define NB 5                       // NUM_BASES_PAD
#define PSEUDO 4

struct ScanArgs {
  const float* tab[10];          // per-sequence [b][i][d] score tables
  const unsigned char* canon;    // (B, N, N) canonical mask
  const float* par[12];          // parameter tables
  float* st[8];                  // state tables
  const int* seq;                // (B, N)
  const int* ns;                 // (B,)
  int N, d, min_span;
};

// ----------------------------------------------------------------------
// numerics
// ----------------------------------------------------------------------

template <bool FAST>
__device__ __forceinline__ float lse2(float a, float b) {
  if constexpr (FAST) {  // torch.logaddexp
    if (isinf(a) && a == b) return a;
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
  } else {
    return rna_lse_pair(a, b);
  }
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// log2 of the leaves a thread holds for a tree of `extent` terms over T
// threads: the least power of two L with L * T >= extent
__device__ __forceinline__ int scan_lg(int extent, int T) {
  int lg = 0;
  while ((T << lg) < extent) ++lg;
  return lg;
}

// K trees of `extent` terms: leaf(k, x) puts term k of tree j in x[j]
// (-inf past the live terms).  The sums land in out[j] (shared), visible
// to every thread on return.  Thread tid holds the leaves k = tid + m*T,
// m < L = 2^lg.  Cubic: it takes them in bit-reversed order of m, so that
// a stack of one partial sum a level closes the halving tree over its
// leaves (m with m + L/2 first, the lower m on the left), then the
// threads' tree in `red`.  FAST: a running max and sum of exp(x - max) a
// thread, then the threads' pairs in `red` and red + K*T.
template <bool FAST, int K, class Leaf>
__device__ void scan_reduce(int extent, const Leaf& leaf, float* red,
                            float* out) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int lg = scan_lg(extent, T), L = 1 << lg;
  float x[K];
  if constexpr (!FAST) {
    float stk[K][SCAN_MAX_LG + 1];
    for (int q = 0; q < L; ++q) {
      const int m = lg ? (int)(__brev((unsigned)q) >> (32 - lg)) : 0;
      leaf(tid + m * T, x);
      const int z = __ffs(~q) - 1;  // q's trailing ones: the levels it closes
#pragma unroll
      for (int l = 0; l <= SCAN_MAX_LG; ++l) {
        if (l < z) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            x[k] = x[k] != -INFINITY ? rna_lse_pair(stk[k][l], x[k])
                                     : stk[k][l];
        } else if (l == z) {
#pragma unroll
          for (int k = 0; k < K; ++k) stk[k][l] = x[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * T + tid] = x[k];
    __syncthreads();
    for (int h = T / 2; h >= 32; h >>= 1) {
      if (tid < h)
#pragma unroll
        for (int k = 0; k < K; ++k)
          red[k * T + tid] =
              rna_lse_pair(red[k * T + tid], red[k * T + tid + h]);
      __syncthreads();
    }
    if (tid < 32) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float y = red[k * T + tid];
#pragma unroll
        for (int h = 16; h >= 1; h >>= 1)
          y = rna_lse_pair(y, __shfl_down_sync(0xffffffffu, y, h));
        if (tid == 0) out[k] = y;
      }
    }
    __syncthreads();
  } else {
    float mx[K], sm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) mx[k] = -INFINITY, sm[k] = 0.0f;
    for (int m = 0; m < L; ++m) {
      leaf(tid + m * T, x);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (x[k] == -INFINITY) continue;
        if (x[k] > mx[k]) {
          sm[k] = sm[k] * expf(mx[k] - x[k]) + 1.0f;
          mx[k] = x[k];
        } else {
          sm[k] += expf(x[k] - mx[k]);
        }
      }
    }
    float* rs = red + K * T;
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * T + tid] = mx[k], rs[k * T + tid] = sm[k];
    __syncthreads();
    for (int h = T / 2; h >= 1; h >>= 1) {
      if (tid < h)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int a = k * T + tid;
          const float m1 = red[a], m2 = red[a + h], M = fmaxf(m1, m2);
          if (M != -INFINITY)
            rs[a] = rs[a] * expf(m1 - M) + rs[a + h] * expf(m2 - M);
          red[a] = M;
        }
      __syncthreads();
    }
    if (tid == 0)
#pragma unroll
      for (int k = 0; k < K; ++k)
        out[k] = isfinite(red[k * T]) ? red[k * T] + logf(rs[k * T])
                                      : -INFINITY;
    __syncthreads();
  }
}

// ----------------------------------------------------------------------
// the 2-loop terms (ops/scores.py twoloop_*), term for term in the order
// the JAX functions add them
// ----------------------------------------------------------------------

// sget: the base at position p of a length-N row, PSEUDO outside [-N, N),
// counted from the end below 0 (jnp.take(mode="fill") semantics)
__device__ __forceinline__ int sget(const int* s, int N, int p) {
  if (p < -N || p >= N) return PSEUDO;
  return s[p < 0 ? p + N : p];
}

__device__ __forceinline__ int ix4(int a, int b, int c, int d) {
  return ((a * NB + b) * NB + c) * NB + d;
}
__device__ __forceinline__ int ix6(int a, int b, int c, int d, int e, int f) {
  return ix4(a, b, c, d) * NB * NB + e * NB + f;
}
__device__ __forceinline__ int ix7(int a, int b, int c, int d, int e, int f,
                                   int g) {
  return ix6(a, b, c, d, e, f) * NB + g;
}
__device__ __forceinline__ int ix8(int a, int b, int c, int d, int e, int f,
                                   int g, int h) {
  return ix7(a, b, c, d, e, f, g) * NB + h;
}

// The mismatch family of a generic interior cell: 1 x n, 2 x 3, other.
__device__ __forceinline__ int turner_family(int a, int b) {
  if (a == 1 || b == 1) return 1;
  if ((a == 2 && b == 3) || (a == 3 && b == 2)) return 2;
  return 0;
}

// The per-lane values of a Turner 2-loop (stacks, bulges of one, the
// special interior loops, the lane's AU/GU and mismatch terms).
struct TurnerLane {
  float stack00, b01, b10, i11, i12, i21, i22, aug, tm[3];
};

// Turner tables: tab = H, MBC, ACC, AUGU, TMo x3, TMi x3; par = stack,
// int_1x1, int_1x2, int_2x2, bulge_init, coeff, init_int, init_bulge,
// ninio.
__device__ TurnerLane turner_lane(const ScanArgs& p, size_t base,
                                  const int* s, int i, int j, int cd,
                                  bool inside) {
  const int N = p.N;
  const float* stk = p.par[0];
  const float* i11 = p.par[1];
  const float* i12 = p.par[2];
  const float* i22 = p.par[3];
  const float b1 = p.par[4][1];
  const int xi = sget(s, N, i), xj = sget(s, N, j);
  TurnerLane L;
  if (inside) {
    const int i1 = sget(s, N, i + 1), i2 = sget(s, N, i + 2),
              i3 = sget(s, N, i + 3);
    const int j1 = sget(s, N, j - 1), j2 = sget(s, N, j - 2),
              j3 = sget(s, N, j - 3);
    L.stack00 = stk[ix4(xi, xj, i1, j1)];
    L.b01 = add(b1, stk[ix4(xi, xj, i1, j2)]);
    L.b10 = add(b1, stk[ix4(xi, xj, i2, j1)]);
    L.i11 = i11[ix6(xi, xj, i1, j1, i2, j2)];
    L.i12 = i12[ix7(xi, xj, i1, j1, j2, i2, j3)];
    L.i21 = i12[ix7(j2, i3, j1, i2, i1, xj, xi)];
    L.i22 = i22[ix8(xi, xj, i1, j1, i2, j2, i3, j3)];
  } else {
    const int m1 = sget(s, N, i - 1), m2 = sget(s, N, i - 2),
              m3 = sget(s, N, i - 3);
    const int p1 = sget(s, N, j + 1), p2 = sget(s, N, j + 2),
              p3 = sget(s, N, j + 3);
    L.stack00 = stk[ix4(m1, p1, xi, xj)];
    L.b01 = add(b1, stk[ix4(m1, p2, xi, xj)]);
    L.b10 = add(b1, stk[ix4(m2, p1, xi, xj)]);
    L.i11 = i11[ix6(m2, p2, m1, p1, xi, xj)];
    L.i12 = i12[ix7(m2, p3, m1, p2, p1, xi, xj)];
    L.i21 = i12[ix7(xj, xi, p1, m1, m2, p2, m3)];
    L.i22 = i22[ix8(m3, p3, m2, p2, m1, p1, xi, xj)];
  }
  L.aug = p.tab[3][base + cd];
  // inside: the outer pair's mismatches (TMo); outside: the inner's (TMi)
  const int off = inside ? 4 : 7;
#pragma unroll
  for (int f = 0; f < 3; ++f) L.tm[f] = p.tab[off + f][base + cd];
  return L;
}

// TL(a, b) of the Turner 2-loop; `w` is the window cell (the inner pair of
// the inside, the outer pair of the outside) in its sequence's tables.
__device__ __forceinline__ float turner_tl(const ScanArgs& p, size_t base,
                                           const TurnerLane& L, int a, int b,
                                           int w, bool inside) {
  const int m = a + b;
  if (m == 0) return L.stack00;
  if (a == 0 && b == 1) return L.b01;
  if (a == 1 && b == 0) return L.b10;
  const float waug = p.tab[3][base + w];
  const int c = a * SCAN_W + b;
  if (a == 0 || b == 0) return add(add(p.par[7][c], L.aug), waug);
  if (a == 1 && b == 1) return L.i11;
  if (a == 1 && b == 2) return L.i12;
  if (a == 2 && b == 1) return L.i21;
  if (a == 2 && b == 2) return L.i22;
  const int f = turner_family(a, b);
  // inside: outer TMo of the lane, then the inner TMi of the window cell;
  // outside: the outer TMo of the window cell, then the lane's TMi
  const float wtm = p.tab[(inside ? 7 : 4) + f][base + w];
  const float first = inside ? L.tm[f] : wtm;
  const float second = inside ? wtm : L.tm[f];
  return add(add(add(add(add(p.par[6][c], p.par[8][c]), first), second),
                 L.aug),
             waug);
}

// The per-lane values of a CONTRA 2-loop.
struct ContraLane {
  float stack00, left, right, i1x1, js, jsrev, bp;
};

// CONTRA tables: tab = H, MBC, ACC, JS, JB, JSrev, BP; par = stack, bp,
// bulge_0x1, interior_1x1, eu, ebp, mbu, mbbp, bulge_len, interior_len.
__device__ ContraLane contra_lane(const ScanArgs& p, size_t base,
                                  const int* s, int i, int j, int cd,
                                  bool inside) {
  const int N = p.N;
  const float* stk = p.par[0];
  const float* bp = p.par[1];
  const float* b0x1 = p.par[2];
  const float* i1x1 = p.par[3];
  const int xi = sget(s, N, i), xj = sget(s, N, j);
  ContraLane L;
  if (inside) {
    const int i1 = sget(s, N, i + 1), j1 = sget(s, N, j - 1);
    L.stack00 = add(stk[ix4(xi, xj, i1, j1)], bp[i1 * NB + j1]);
    L.left = b0x1[i1];
    L.right = b0x1[j1];
    L.i1x1 = i1x1[i1 * NB + j1];
  } else {
    const int m1 = sget(s, N, i - 1), p1 = sget(s, N, j + 1);
    L.stack00 = add(stk[ix4(m1, p1, xi, xj)], bp[xi * NB + xj]);
    L.left = b0x1[m1];
    L.right = b0x1[p1];
    L.i1x1 = i1x1[m1 * NB + p1];
  }
  L.js = p.tab[3][base + cd];
  L.jsrev = p.tab[5][base + cd];
  L.bp = p.tab[6][base + cd];
  return L;
}

__device__ __forceinline__ float contra_tl(const ScanArgs& p, size_t base,
                                           const ContraLane& L, int a, int b,
                                           int w, bool inside) {
  const int m = a + b;
  if (m == 0) return L.stack00;
  const int c = a * SCAN_W + b;
  float sel;
  if (a == 0 || b == 0)
    sel = add(p.par[8][c], m == 1 ? (a == 1 ? L.left : L.right) : 0.0f);
  else
    sel = add(p.par[9][c], (a == 1 && b == 1) ? L.i1x1 : 0.0f);
  if (inside) return add(add(sel, L.js), p.tab[4][base + w]);
  return add(add(add(sel, L.jsrev), p.tab[3][base + w]), L.bp);
}

// ----------------------------------------------------------------------
// K20: the inside step at span d
// ----------------------------------------------------------------------

// state: close, ext, mb, one, qone, qrm, qrmmb
template <bool CONTRA, bool FAST>
__global__ void scan_inside_kernel(ScanArgs p) {
  const int i = blockIdx.x, b = blockIdx.y, N = p.N, d = p.d;
  const int n = p.ns[b], j = i + d;
  if (j >= n) return;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * N * N;
  const int* s = p.seq + (size_t)b * N;
  float* close = p.st[0] + base;
  float* ext = p.st[1] + base;
  float* mb = p.st[2] + base;
  float* one = p.st[3] + base;
  float* qone = p.st[4] + base;
  float* qrm = p.st[5] + base;
  float* qrmmb = p.st[6] + base;
  __shared__ float red[(FAST ? 2 : 1) * SCAN_TREES * SCAN_MAX_T];
  __shared__ float out[SCAN_TREES];
  __shared__ float cell[2];
  const int cd = i * N + d;
  const bool closes = p.canon[base + cd] && d + 1 >= p.min_span;

  float two = -INFINITY;
  if (closes) {  // the 2-loop window: inner pair (i+1+a, j-1-b)
    TurnerLane tl;
    ContraLane cl;
    if (CONTRA)
      cl = contra_lane(p, base, s, i, j, cd, true);
    else
      tl = turner_lane(p, base, s, i, j, cd, true);
    const auto window = [&](int k, float (&x)[1]) {
      x[0] = -INFINITY;
      if (k >= SCAN_WIN) return;
      const int a = k / SCAN_W, bb = k - a * SCAN_W;
      const int dp = d - 2 - a - bb;
      if (dp < 0) return;
      const int w = (i + 1 + a) * N + dp;
      const float c = close[w];
      if (c != -INFINITY)
        x[0] = add(c, CONTRA ? contra_tl(p, base, cl, a, bb, w, true)
                             : turner_tl(p, base, tl, a, bb, w, true));
    };
    scan_reduce<FAST, 1>(SCAN_WIN, window, red, out);
    two = out[0];
  }
  if (tid == 0) {
    float c = -INFINITY;
    if (closes) {
      const float mb_in = d >= 2 ? mb[(i + 1) * N + d - 2] : -INFINITY;
      const float mbt = add(mb_in, p.tab[1][base + cd]);
      c = lse2<FAST>(lse2<FAST>(p.tab[0][base + cd], two), mbt);
    }
    const float acc = add(c, p.tab[2][base + cd]);
    const float prev = d >= 1 ? qrm[(j - 1) * N + d - 1] : -INFINITY;
    float rm, rmmb = -INFINITY;
    if (CONTRA) {
      rm = lse2<FAST>(add(prev, p.par[4][0]), add(acc, p.par[5][0]));
      const float pmb = d >= 1 ? qrmmb[(j - 1) * N + d - 1] : -INFINITY;
      rmmb = lse2<FAST>(add(pmb, p.par[6][0]), add(acc, p.par[7][0]));
      qrmmb[j * N + d] = rmmb;
    } else {
      rm = lse2<FAST>(prev, acc);
    }
    close[cd] = c;
    qrm[j * N + d] = rm;
    cell[0] = rm;
    cell[1] = rmmb;
  }
  __syncthreads();
  const float rm = cell[0], rmmb = cell[1];

  // the O(d) sums over t = k - i: ext over [0, d-1], s1 / s2 over [1, d-1]
  const float coeff = CONTRA ? 0.0f : p.par[5][0];
  const float mbu = CONTRA ? p.par[6][0] : 0.0f;
  const auto sums = [&](int t, float (&x)[3]) {
    x[0] = x[1] = x[2] = -INFINITY;
    if (t >= d) return;
    const float q = t == 0 ? rm : qrm[j * N + d - t];
    x[0] = add(q, t == 0 ? 0.0f : ext[i * N + t - 1]);
    if (t == 0) return;
    const float o = one[i * N + t - 1];
    if (CONTRA) {
      const float y = qrmmb[j * N + d - t];
      x[1] = add(y, __fmul_rn(mbu, (float)t));
      x[2] = add(o, y);
    } else {
      const float y = add(q, coeff);
      x[1] = y;
      x[2] = add(o, y);
    }
  };
  scan_reduce<FAST, 3>(d, sums, red, out);
  if (tid == 0) {
    const float eb =
        CONTRA ? add(0.0f, __fmul_rn(p.par[4][0], (float)(d + 1))) : 0.0f;
    const float s1 = CONTRA ? lse2<FAST>(rmmb, out[1])
                            : lse2<FAST>(add(rm, coeff), out[1]);
    const float s2 = out[2];
    const float o = lse2<FAST>(s1, s2);
    ext[cd] = lse2<FAST>(eb, out[0]);
    mb[cd] = s2;
    one[cd] = o;
    qone[j * N + d] = o;
  }
}

// ----------------------------------------------------------------------
// K21: the outside step at span d
// ----------------------------------------------------------------------

// state: close, ext, one, qone (the inside's), bppo, g, qpm, qpm2
template <bool CONTRA, bool FAST>
__global__ void scan_outside_kernel(ScanArgs p) {
  const int i = blockIdx.x, b = blockIdx.y, N = p.N, d = p.d;
  const int n = p.ns[b], j = i + d;
  if (j >= n) return;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * N * N;
  const int* s = p.seq + (size_t)b * N;
  const float* close = p.st[0] + base;
  const float* ext = p.st[1] + base;
  const float* one = p.st[2] + base;
  const float* qone = p.st[3] + base;
  float* bppo = p.st[4] + base;
  float* g = p.st[5] + base;
  float* qpm = p.st[6] + base;
  float* qpm2 = p.st[7] + base;
  __shared__ float red[(FAST ? 2 : 1) * SCAN_TREES * SCAN_MAX_T];
  __shared__ float out[SCAN_TREES];
  const int cd = i * N + d;
  const bool valid = d + 1 >= p.min_span;
  const float cl = close[cd];
  const bool pair = valid && isfinite(cl);
  const float mbu = CONTRA ? p.par[6][0] : 0.0f;
  const float acc = add(cl, p.tab[2][base + cd]);
  const float acc_mb = add(acc, CONTRA ? p.par[7][0] : p.par[5][0]);

  TurnerLane tl;
  ContraLane cn;
  if (pair) {
    if (CONTRA)
      cn = contra_lane(p, base, s, i, j, cd, false);
    else
      tl = turner_lane(p, base, s, i, j, cd, false);
  }
  // trees: pm, pm2 (t in [1, n-1-j]); the window; the context
  const auto terms = [&](int k, float (&x)[4]) {
    x[0] = x[1] = x[2] = x[3] = -INFINITY;
    if (valid && k >= 1 && k <= n - 1 - j) {
      const float gv = g[i * N + d + k];
      x[0] = add(gv, k >= 2 ? one[(j + 1) * N + k - 2] : -INFINITY);
      x[1] = CONTRA ? add(gv, __fmul_rn(mbu, __fsub_rn((float)k, 1.0f)))
                    : gv;
    }
    if (!pair) return;
    if (k < SCAN_WIN) {  // outer pair (i-1-a, j+1+b)
      const int a = k / SCAN_W, bb = k - a * SCAN_W;
      const int oi = i - 1 - a;
      if (oi >= 0 && j + 1 + bb <= n - 1) {
        const int w = oi * N + d + 2 + a + bb;
        const float wcl = close[w];
        if (isfinite(wcl))
          x[2] = add(__fsub_rn(add(bppo[w], cl), wcl),
                     CONTRA ? contra_tl(p, base, cn, a, bb, w, false)
                            : turner_tl(p, base, tl, a, bb, w, false));
      }
    }
    const int seg = k / N, t = k - seg * N;
    if (seg < 3 && t >= 1 && t <= i) {  // k' = i - t < i
      const float q = t >= 2 ? qone[(i - 1) * N + t - 2] : -INFINITY;
      if (seg == 0) {
        x[3] = add(add(acc_mb, qpm2[j * N + d + t]), q);
      } else {
        const float r = add(acc_mb, qpm[j * N + d + t]);
        if (seg == 2)
          x[3] = add(r, q);
        else
          x[3] = CONTRA ? add(r, __fmul_rn(mbu, __fsub_rn((float)t, 1.0f)))
                        : r;
      }
    }
  };
  scan_reduce<FAST, 4>(max(SCAN_WIN, 3 * N - d), terms, red, out);
  if (tid == 0) {
    qpm[j * N + d] = out[0];
    qpm2[j * N + d] = out[1];
    float bp = -INFINITY, gv = -INFINITY;
    if (pair) {
      const float lt = i >= 1 ? ext[i - 1] : 0.0f;
      const float rt = j <= n - 2 ? ext[(j + 1) * N + n - 2 - j] : 0.0f;
      float bs = __fsub_rn(add(add(lt, acc), rt), ext[n - 1]);
      if (CONTRA) bs = add(bs, p.par[5][0]);
      bp = lse2<FAST>(lse2<FAST>(bs, out[2]), out[3]);
      gv = __fsub_rn(add(bp, p.tab[1][base + cd]), cl);
    }
    bppo[cd] = bp;
    g[cd] = gv;
  }
}

// ----------------------------------------------------------------------
// C entry points
// ----------------------------------------------------------------------

template <bool INSIDE, bool CONTRA, bool FAST>
static int scan_launch(const ScanArgs& a, int B, int T, void* stream) {
  dim3 grid(a.N - a.d, B);
  if (INSIDE)
    scan_inside_kernel<CONTRA, FAST><<<grid, T, 0, (cudaStream_t)stream>>>(a);
  else
    scan_outside_kernel<CONTRA, FAST><<<grid, T, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool INSIDE>
static int scan_entry(const void** tabs, const void* canon, const void** pars,
                      void** sts, const void* seq, const void* ns, int B,
                      int N, int d, int contra, int fast, int min_span,
                      int threads, void* stream) {
  if (N < 1 || d < 0 || d >= N || B < 1 || threads < SCAN_MIN_T ||
      threads > SCAN_MAX_T || (threads & (threads - 1)) ||
      (threads << SCAN_MAX_LG) < (INSIDE ? d : 3 * N - d))
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  const int nt = contra ? 7 : 10, np = contra ? 10 : 9;
  for (int k = 0; k < 10; ++k) a.tab[k] = k < nt ? (const float*)tabs[k] : 0;
  for (int k = 0; k < 12; ++k) a.par[k] = k < np ? (const float*)pars[k] : 0;
  for (int k = 0; k < 8; ++k) a.st[k] = (float*)sts[k];
  a.canon = (const unsigned char*)canon;
  a.seq = (const int*)seq;
  a.ns = (const int*)ns;
  a.N = N;
  a.d = d;
  a.min_span = min_span;
  if (contra)
    return fast ? scan_launch<INSIDE, true, true>(a, B, threads, stream)
                : scan_launch<INSIDE, true, false>(a, B, threads, stream);
  return fast ? scan_launch<INSIDE, false, true>(a, B, threads, stream)
              : scan_launch<INSIDE, false, false>(a, B, threads, stream);
}

extern "C" int rna_scan_inside(const void** tabs, const void* canon,
                               const void** pars, void** sts, const void* seq,
                               const void* ns, int B, int N, int d,
                               int contra, int fast, int min_span,
                               int threads, void* stream) {
  return scan_entry<true>(tabs, canon, pars, sts, seq, ns, B, N, d, contra,
                          fast, min_span, threads, stream);
}

extern "C" int rna_scan_outside(const void** tabs, const void* canon,
                                const void** pars, void** sts,
                                const void* seq, const void* ns, int B, int N,
                                int d, int contra, int fast, int min_span,
                                int threads, void* stream) {
  return scan_entry<false>(tabs, canon, pars, sts, seq, ns, B, N, d, contra,
                           fast, min_span, threads, stream);
}
