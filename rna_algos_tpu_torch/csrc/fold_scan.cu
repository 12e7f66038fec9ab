// Kernels K20 and K21: the generic-N McCaskill scan
// (rna_algos_tpu/models/mccaskill.py `_inside` :72 and `_outside` :179),
// the path the JAX package runs through XLA for the buckets its TPU
// kernels do not take.  ops/fold_scan.py launches each once a pass.
//
// One persistent cooperative launch a pass: the grid holds as many blocks
// of SCAN_T threads as the card keeps resident, and walks the spans in
// order (K20 d = 0 .. N-1, K21 d = N-1 .. 0) with one grid barrier a span.
// One barrier is enough: a lane at span d reads only cells of earlier
// spans (inside: d' < d; outside: d' > d), which other blocks wrote before
// the barrier; such state is read from L2 (__ldcg), never a stale L1 line.
//
// A span's work comes in kinds, each handed to groups of its own width g
// (a power of two from 1 to SCAN_T, scan_group: no wider than the kind's
// largest live tree over SCAN_MIN_LEAVES leaves a thread, nor than the
// grid's threads over its items; no narrower than a thread's leaves allow,
// 2^LG).  K20 at span d: the 2-loop windows of span d + 1's lanes that can
// close (their inner pairs are of spans <= d - 1), the list of span d +
// 2's such lanes, then span d's live lanes (b, i with i + d < n_b: close
// from its window sum, rm, the O(d) sums).  K21 at span d: the contexts
// of span d's lanes that can pair, the pm/pm2 trees of all its lanes, the
// windows of span d - 1's pair lanes (their outer pairs are of spans >= d
// + 1), then the list of span d - 2's.  Lists are built by warp-wide
// atomics two spans ahead; the lanes are numbered sequence by sequence
// (the wrapper's lane offsets, (N, B + 1)).  Groups of up to 32 threads
// share a warp and reduce by shuffles of that width; wider groups reduce
// through shared memory under a named barrier of their own, so a block
// runs one kind at a time.  A unit (a warp of groups, or one group) takes
// its items in rounds, units interleaved over the blocks.
//
// State tables are (B, N, N) float32 in global memory, left layout
// [b][i][d] = state(i, i + d) (close, ext, mb, one; bppo, G) or right
// layout [b][j][e] = state(j - e, j) (rm, rmmb, one; pm, pm2), so every
// O(d) sum reads a contiguous row, consecutive threads of a group on
// consecutive terms.
//
// Every sum is numerics.lse_reduce's halving tree (x[k] (+) x[k + half])
// at the term index the JAX scan gives it: the 2-loop window at a*31 + b,
// the O(d) sums at t, the multibranch context at t, N + t and 2N + t.
// Thread t of a group of g holds the terms t + m*g, m < L (the least power
// of two with L * g >= the tree's live extent), which is the subtree of
// the terms = t mod g; it takes them in bit-reversed order of m, so that a
// stack of one partial sum a level closes the halving tree over them
// (ScanTree), then the group halves over its threads: the tree over L*g
// terms.  Terms past the live ones are -inf, and as lse_pair(x, -inf) = x
// bit for bit, that is the JAX tree over its wider power of two.  For the
// same reason a dead term is never summed (its loads point at a cell the
// lane owns), and the context's tree is walked from the root, a block of
// positions with no live term (a residue class of its terms) pushed
// whole.  A thread takes its positions 4 at a time: their loads in flight
// together, the 4 leaves closed as the subtree the stack would build.  The
// cubic log-add and every add are round-to-nearest intrinsics (cubic.cuh;
// scan_lse its bitwise copy), so under "exact" and "parity" a
// kernel and its plain version agree bit for bit.  FAST: torch.logaddexp
// for a pair and the max-form m + log(sum exp(x - m)) for a tree, with a
// running max.
//
// Bound: the cubic log-add (~40 instructions) over ~N^3/6 terms a tree a
// sequence; the ops bound of chip_smoke.py counts it as 8 FLOPs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cubic.cuh"

namespace cg = cooperative_groups;

#define SCAN_W 31                  // 2-loop window extent
#define SCAN_WIN (SCAN_W * SCAN_W) // its 961 terms
#define SCAN_T 512                 // threads a block
#define SCAN_LG_INSIDE 7           // K20: at most 2^7 leaves a thread a tree
#define SCAN_LG_OUTSIDE 8          // K21: 2^8 (the 3N context at N = 43,690)
#define SCAN_MIN_LEAVES 4          // a span's widest tree: >= 4 leaves a thread
#define SCAN_RUN_LG 2              // a thread takes its positions 4 at a time
#define NB 5                       // NUM_BASES_PAD
#define PSEUDO 4

struct ScanArgs {
  const float* tab[10];          // per-sequence [b][i][d] score tables
  const unsigned char* canon;    // (B, N, N) canonical mask
  const float* par[12];          // parameter tables
  float* st[8];                  // state tables
  const int* seq;                // (B, N)
  const int* ns;                 // (B,)
  const int* lanes;              // (N, B + 1): live lanes before sequence b
  int* lists;                    // (3, B N) work lists (list_of)
  int* counts;                   // (N,) their lengths, a span each
  float* windows;                // (2, B, N) window sums (window_sum)
  int B, N, min_span, gcap;
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

// cubic.cuh's ln(1 + e^x) coefficients, one copy a block (scan_cubic_load)
__shared__ float scan_cubic[32];

__device__ __forceinline__ void scan_cubic_load() {
  if (threadIdx.x < 32)
    scan_cubic[threadIdx.x] = kLnCoeffs[threadIdx.x / 4][threadIdx.x % 4];
  __syncthreads();
}

// rna_lse_pair for finite operands, bit for bit: z's segment is the count
// of breaks <= z (they ascend), its coefficients come from scan_cubic, and
// the Horner steps and the final add are cubic.cuh's
__device__ __forceinline__ float scan_lse(float a, float b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  const float z = __fsub_rn(hi, lo);
  if (!(z < RNA_LSE_THRESHOLD)) return __fadd_rn(lo, z);
  int seg = 0;
#pragma unroll
  for (int k = 0; k < 7; ++k) seg += z >= kLnBreaks[k];
  const float* c = scan_cubic + 4 * seg;
  const float h = __fadd_rn(__fmul_rn(c[0], z), c[1]);
  return __fadd_rn(
      lo, __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(h, z), c[2]), z), c[3]));
}

// lse_pair with its -inf case taken without the cubic: lse_pair(x, -inf)
// = lse_pair(-inf, x) = x bit for bit, and fmaxf gives the same
__device__ __forceinline__ float merge(float a, float b) {
  if (a == -INFINITY || b == -INFINITY) return fmaxf(a, b);
  return scan_lse(a, b);
}

// FAST: (max, sum of exp(x - max)) pairs
__device__ __forceinline__ void merge_fast(float& m, float& s, float m2,
                                           float s2) {
  const float M = fmaxf(m, m2);
  if (M != -INFINITY) s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

__device__ __forceinline__ int pow2_ceil(int x) {  // least 2^k >= x
  return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}
__device__ __forceinline__ int pow2_floor(int x) {  // x >= 1
  return 1 << (31 - __clz(x));
}
__device__ __forceinline__ int log2_of(int p) {  // p a power of two
  return 31 - __clz(p);
}
// position q's term m in a thread's tree of 2^lg leaves
__device__ __forceinline__ int bitrev(int q, int lg) {
  return lg ? (int)(__brev((unsigned)q) >> (32 - lg)) : 0;
}

// One thread's trees (K of them, over the same positions): cubic, a stack
// of one partial sum a level, whose entries stand at the set bits of the
// positions taken so far; FAST, a running max and sum.
template <bool FAST, int K, int LG>
struct ScanTree {
  float a[K][FAST ? 2 : LG + 1];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int l = 0; l < (FAST ? 2 : LG + 1); ++l) a[k][l] = -INFINITY;
      if (FAST) a[k][1] = 0.0f;
    }
  }

  // the leaves x at position q
  __device__ __forceinline__ void leaf(int q, float (&x)[K]) {
    if constexpr (FAST) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (x[k] == -INFINITY) continue;
        if (x[k] > a[k][0]) {
          a[k][1] = a[k][1] * expf(a[k][0] - x[k]) + 1.0f;
          a[k][0] = x[k];
        } else {
          a[k][1] += expf(x[k] - a[k][0]);
        }
      }
    } else {
      carry<0>(q, x);
    }
  }

  // the run of 2^SCAN_RUN_LG positions at q: ((x0 (+) x1) (+) (x2 (+) x3)),
  // the subtree the stack builds over them
  __device__ __forceinline__ void run(int q, float (&x)[1 << SCAN_RUN_LG][K]) {
    if constexpr (FAST) {
#pragma unroll
      for (int u = 0; u < (1 << SCAN_RUN_LG); ++u) leaf(q + u, x[u]);
    } else {
      float s[K];
#pragma unroll
      for (int k = 0; k < K; ++k)
        s[k] = merge(merge(x[0][k], x[1][k]), merge(x[2][k], x[3][k]));
      carry<SCAN_RUN_LG>(q, s);
    }
  }

  // a dead aligned block of 2^z positions at q (q a multiple of 2^z,
  // z >= SCAN_RUN_LG)
  template <int l = SCAN_RUN_LG>
  __device__ __forceinline__ void dead(int q, int z) {
    if constexpr (!FAST && l <= LG) {
      if (z == l) {
        float x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = -INFINITY;
        carry<l>(q, x);
      } else {
        dead<l + 1>(q, z);
      }
    }
  }

  // cubic: the subtree x standing at level l (q a multiple of 2^l) closes
  // the levels of q's trailing ones from l up and stands above them; the
  // levels are compile-time, so the stack stays in registers
  template <int l>
  __device__ __forceinline__ void carry(int q, float (&x)[K]) {
    if constexpr (l <= LG) {
      if ((q >> l) & 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) x[k] = merge(a[k][l], x[k]);
        carry<l + 1>(q, x);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) a[k][l] = x[k];
      }
    }
  }

  // the thread's sums once the positions [q, 2^lg) left are dead: the
  // stack's entries, the highest level leftmost (v; FAST: max v, sum w)
  __device__ __forceinline__ void finish(int q, float (&v)[K],
                                         float (&w)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (FAST) {
        v[k] = a[k][0];
        w[k] = a[k][1];
      } else {
        v[k] = -INFINITY;
      }
    }
    if constexpr (!FAST) {
#pragma unroll
      for (int l = 0; l <= LG; ++l)
        if ((q >> l) & 1)
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = merge(a[k][l], v[k]);
    }
  }
};

__device__ __forceinline__ void group_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The halving tree over a group's g threads (thread t of the group, the
// group `gib` of its block): x[t] (+) x[t + g/2] first, down to x[0] (+)
// x[1].  Wider than 32, the levels down to 32 in `red` (K x SCAN_T floats;
// FAST twice that) under the group's named barrier, then the first warp's
// shuffles.  Every thread of a warp must call it together (full-warp
// shuffles); the sums land in thread 0 (FAST: max v, sum w).  A block
// runs one kind of work at a time (__syncthreads between kinds): groups of
// another width would share the barrier ids.
template <bool FAST, int K>
__device__ __forceinline__ void group_reduce(float (&v)[K], float (&w)[K],
                                             int g, int t, int gib,
                                             float* red) {
  if (g > 32) {
    float* r = red + gib * g;
    float* rs = red + K * SCAN_T + gib * g;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k * SCAN_T + t] = v[k];
      if (FAST) rs[k * SCAN_T + t] = w[k];
    }
    group_bar(1 + gib, g);
    for (int h = g / 2; h >= 32; h >>= 1) {
      if (t < h) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float* x = r + k * SCAN_T + t;
          if constexpr (FAST) {
            float m = x[0], s = rs[k * SCAN_T + t];
            merge_fast(m, s, x[h], rs[k * SCAN_T + t + h]);
            x[0] = m;
            rs[k * SCAN_T + t] = s;
          } else {
            x[0] = merge(x[0], x[h]);
          }
        }
      }
      group_bar(1 + gib, g);
    }
    if (t >= 32) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = r[k * SCAN_T + t];
      if (FAST) w[k] = rs[k * SCAN_T + t];
    }
  }
  const int width = g < 32 ? g : 32;
  for (int h = width / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float o = __shfl_down_sync(0xffffffffu, v[k], h, width);
      if constexpr (FAST) {
        const float os = __shfl_down_sync(0xffffffffu, w[k], h, width);
        merge_fast(v[k], w[k], o, os);
      } else {
        v[k] = merge(v[k], o);
      }
    }
  }
}

// FAST: the tree's value from its (max, sum)
template <bool FAST>
__device__ __forceinline__ float tree_value(float v, float w) {
  if constexpr (FAST) return isfinite(v) ? v + logf(w) : -INFINITY;
  return v;
}

// One thread's tree over the live extent E (terms k < E): thread t of g
// takes k = t + m g, m = bitrev(q) over q < L = pow2_ceil(ceil(E / g)),
// 4 positions at a time once L >= 4 (a run, its loads in flight
// together).  The aligned block of 2^z positions at q holds the terms k0
// + u S, u < 2^z (k0 = t + bitrev(q) g, S = (L >> z) g); where Live::dfs,
// the tree is walked from the root and a block that live(k0, S, 2^z) says
// holds no live term is pushed whole as dead.  leaf(k, in, x) fills x, -inf
// for a dead term (in: k < E).
template <bool FAST, int K, int LG, class Leaf, class Live>
__device__ __forceinline__ void thread_tree(int E, int g, int t,
                                            const Leaf& leaf,
                                            const Live& live, float (&v)[K],
                                            float (&w)[K]) {
  constexpr int R = 1 << SCAN_RUN_LG;
  ScanTree<FAST, K, LG> tr;
  tr.init();
  const int L = E > 0 ? pow2_ceil((E + g - 1) / g) : 0;
  const int lg = L ? log2_of(L) : 0;
  if (L >= R) {
    for (int q = 0; q < L;) {
      if constexpr (Live::dfs) {
        // from the widest block aligned at q down to a run: a dead block
        // is pushed whole, a live one split
        int z = q ? __ffs(q) - 1 : lg;
        for (;;) {
          if (!live(t + bitrev(q, lg) * g, (L >> z) * g, 1 << z)) {
            tr.dead(q, z);
            q += 1 << z;
            z = -1;
            break;
          }
          if (z == SCAN_RUN_LG) break;
          --z;
        }
        if (z < 0) continue;
      }
      float x[R][K];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int k = t + bitrev(q + u, lg) * g;
        leaf(k, k < E, x[u]);
      }
      tr.run(q, x);
      q += R;
    }
  } else {
    for (int q = 0; q < L; ++q) {
      float x[K];
      const int k = t + bitrev(q, lg) * g;
      leaf(k, k < E, x);
      tr.leaf(q, x);
    }
  }
  tr.finish(L, v, w);
}

// every term may be live: no walk
struct AnyLive {
  static constexpr bool dfs = false;
  __device__ __forceinline__ bool operator()(int, int, int) const {
    return true;
  }
};

// The span's lanes in rounds: units of max(g, 32) threads (a warp of
// 32 / g groups, or one group), interleaved over the blocks; unit u takes
// the lanes [u * per_unit, +per_unit) of each round.  body(lane, active, t,
// gib): every thread of a unit calls it together (active: lane < lanes).
template <class Body>
__device__ __forceinline__ void span_lanes(int g, int lanes,
                                           const Body& body) {
  const int tb = threadIdx.x;
  const int per = g > 32 ? g : 32;
  const int lpu = per / g;
  const int units = (SCAN_T / per) * gridDim.x;
  const int u = (tb / per) * gridDim.x + blockIdx.x;
  const int t = tb & (g - 1), gib = tb / g, gin = (tb % per) / g;
  for (int first = u * lpu; first < lanes; first += units * lpu) {
    const int lane = first + gin;
    body(lane, lane < lanes, t, gib);
  }
}

// lane -> (sequence b, left end i): off = the span's (B + 1) offsets
__device__ __forceinline__ void lane_of(const int* off, int B, int lane,
                                        int& b, int& i) {
  int lo = 0, hi = B;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= lane)
      lo = mid;
    else
      hi = mid;
  }
  b = lo;
  i = lane - off[lo];
}

// The group width of a span: widest tree E live terms, widest tree width
// W (a power of two), `lanes` live lanes, LG the kernel's leaves a thread.
__device__ __forceinline__ int scan_group(int E, int W, int lanes, int LG,
                                          int gcap) {
  int g = pow2_ceil((E + SCAN_MIN_LEAVES - 1) / SCAN_MIN_LEAVES);
  g = min(g, pow2_floor(max(1, (int)gridDim.x * SCAN_T / lanes)));
  g = min(g, gcap);
  g = max(g, max(1, W >> LG));
  return min(g, SCAN_T);
}

// the 2-loop window of an inside lane at span d: (a, b) with a + b <=
// d - 2, a, b <= 30; its terms and its extent (last live a*31 + b, + 1)
__device__ __forceinline__ int inside_window_terms(int d) {
  int n = 0;
  for (int a = 0; a <= min(SCAN_W - 1, d - 2); ++a)
    n += min(SCAN_W - 1, d - 2 - a) + 1;
  return n;
}
__device__ __forceinline__ int inside_window_extent(int d) {
  if (d < 2) return 0;
  const int a = min(SCAN_W - 1, d - 2);
  return a * SCAN_W + min(SCAN_W - 1, d - 2 - a) + 1;
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
// Every load is issued up front (all from cells the lane may read) and
// the case picked by selects, each case's value added in the JAX order.
__device__ __forceinline__ float turner_tl(const ScanArgs& p, size_t base,
                                           const TurnerLane& L, int a, int b,
                                           int w, bool inside) {
  const int c = a * SCAN_W + b;
  const int f = turner_family(a, b);
  const int off = inside ? 7 : 4;  // the window cell's mismatch tables
  const float* wtab = f == 0 ? p.tab[off] : f == 1 ? p.tab[off + 1]
                                                   : p.tab[off + 2];
  const float waug = p.tab[3][base + w];
  const float wtm = wtab[base + w];
  const float p6 = p.par[6][c], p7 = p.par[7][c], p8 = p.par[8][c];
  const float ltm = f == 0 ? L.tm[0] : f == 1 ? L.tm[1] : L.tm[2];
  // inside: outer TMo of the lane, then the inner TMi of the window cell;
  // outside: the outer TMo of the window cell, then the lane's TMi
  const float first = inside ? ltm : wtm;
  const float second = inside ? wtm : ltm;
  const float generic =
      add(add(add(add(add(p6, p8), first), second), L.aug), waug);
  const float bulge = add(add(p7, L.aug), waug);
  float v = generic;
  v = a == 2 && b == 2 ? L.i22 : v;
  v = a == 2 && b == 1 ? L.i21 : v;
  v = a == 1 && b == 2 ? L.i12 : v;
  v = a == 1 && b == 1 ? L.i11 : v;
  v = a == 0 || b == 0 ? bulge : v;
  v = a == 1 && b == 0 ? L.b10 : v;
  v = a == 0 && b == 1 ? L.b01 : v;
  return a + b == 0 ? L.stack00 : v;
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
  const int m = a + b, c = a * SCAN_W + b;
  const float p8 = p.par[8][c], p9 = p.par[9][c];
  const float tw = p.tab[inside ? 4 : 3][base + w];  // loads up front
  const float sel =
      a == 0 || b == 0
          ? add(p8, m == 1 ? (a == 1 ? L.left : L.right) : 0.0f)
          : add(p9, (a == 1 && b == 1) ? L.i1x1 : 0.0f);
  const float v = inside ? add(add(sel, L.js), tw)
                         : add(add(add(sel, L.jsrev), tw), L.bp);
  return m == 0 ? L.stack00 : v;
}

// ----------------------------------------------------------------------
// work lists: the lanes of a later span that carry a 2-loop window
// ----------------------------------------------------------------------

// The item lists are (3, B * N) ints (entry b * N + i) with a count a
// span; list_of(p, d) holds span d's.  Every thread of a warp calls
// list_append together; the warp takes its slots with one atomic.
__device__ __forceinline__ int* list_of(const ScanArgs& p, int d) {
  return p.lists + (size_t)(d % 3) * p.B * p.N;
}

__device__ __forceinline__ void list_append(const ScanArgs& p, int d,
                                            bool keep, int entry) {
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (!m) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int first = 0;
  if (lane == leader) first = atomicAdd(p.counts + d, __popc(m));
  first = __shfl_sync(0xffffffffu, first, leader);
  if (keep) list_of(p, d)[first + __popc(m & ((1u << lane) - 1))] = entry;
}

// span d's lanes (b, i) with keep(b, i), appended to its list: one thread
// a lane (groups of 1, a warp a unit)
template <class Keep>
__device__ __forceinline__ void build_list(const ScanArgs& p, int d,
                                           const Keep& keep) {
  const int lanes = p.lanes[(size_t)d * (p.B + 1) + p.B];
  span_lanes(1, lanes, [&](int lane, bool active, int, int) {
    int b = 0, i = 0;
    if (active) lane_of(p.lanes + (size_t)d * (p.B + 1), p.B, lane, b, i);
    list_append(p, d, active && keep(b, i), b * p.N + i);
  });
}

// a list entry -> (b, i)
__device__ __forceinline__ void entry_of(const ScanArgs& p, int d, int item,
                                         int& b, int& i) {
  const int e = __ldcg(list_of(p, d) + item);
  b = e / p.N;
  i = e - b * p.N;
}

// the window sums of span d's listed lanes, one a lane and span parity
__device__ __forceinline__ float* window_sum(const ScanArgs& p, int d, int b,
                                             int i) {
  return p.windows + ((size_t)(d & 1) * p.B + b) * p.N + i;
}

// ----------------------------------------------------------------------
// K20: the inside pass
// ----------------------------------------------------------------------

// The 2-loop window of a closing lane (b, i) at span d: inner pair
// (i+1+a, j-1-b), a + b <= d - 2, summed a span early (its inner pairs
// are of spans <= d - 2).
template <bool CONTRA, bool FAST>
__device__ __forceinline__ void inside_window(const ScanArgs& p, int d,
                                             int g, int item, bool active,
                                             int t, int gib, float* red) {
  const int N = p.N;
  int b = 0, i = 0;
  if (active) entry_of(p, d, item, b, i);
  const int j = i + d;
  const size_t base = (size_t)b * N * N;
  const int* s = p.seq + (size_t)b * N;
  const float* close = p.st[0] + base;
  const int cd = i * N + d;
  float v[1] = {-INFINITY}, w[1] = {0.0f};
  if (active) {
    TurnerLane tl;
    ContraLane cl;
    if (CONTRA)
      cl = contra_lane(p, base, s, i, j, cd, true);
    else
      tl = turner_lane(p, base, s, i, j, cd, true);
    const auto window = [&](int k, bool in, float (&x)[1]) {
      const int kk = in ? k : 0;  // a, b <= 30: the tables' cells
      const int a = kk / SCAN_W, bb = kk - a * SCAN_W;
      const int dp = d - 2 - a - bb;
      const bool live = in && dp >= 0;
      const int wc = live ? (i + 1 + a) * N + dp : cd;
      const float c = live ? __ldcg(close + wc) : -INFINITY;
      const float tlv = CONTRA ? contra_tl(p, base, cl, a, bb, wc, true)
                               : turner_tl(p, base, tl, a, bb, wc, true);
      x[0] = c != -INFINITY ? add(c, tlv) : -INFINITY;
    };
    thread_tree<FAST, 1, SCAN_LG_INSIDE>(inside_window_extent(d), g, t,
                                         window, AnyLive(), v, w);
  }
  group_reduce<FAST, 1>(v, w, g, t, gib, red);
  if (active && t == 0) *window_sum(p, d, b, i) = tree_value<FAST>(v[0], w[0]);
}

// state: close, ext, mb, one, qone, qrm, qrmmb
template <bool CONTRA, bool FAST>
__device__ __forceinline__ void inside_lane(const ScanArgs& p, int d, int g,
                                            int lane, bool active, int t,
                                            int gib, float* red) {
  const int N = p.N;
  int b = 0, i = 0;
  if (active) lane_of(p.lanes + (size_t)d * (p.B + 1), p.B, lane, b, i);
  const int j = i + d;
  const size_t base = (size_t)b * N * N;
  float* close = p.st[0] + base;
  float* ext = p.st[1] + base;
  float* mb = p.st[2] + base;
  float* one = p.st[3] + base;
  float* qone = p.st[4] + base;
  float* qrm = p.st[5] + base;
  float* qrmmb = p.st[6] + base;
  const int cd = i * N + d;

  float rm = -INFINITY, rmmb = -INFINITY;
  if (active && t == 0) {
    float c = -INFINITY;
    if (p.canon[base + cd] && d + 1 >= p.min_span) {
      const float two = d >= 2 ? __ldcg(window_sum(p, d, b, i)) : -INFINITY;
      const float mb_in =
          d >= 2 ? __ldcg(mb + (i + 1) * N + d - 2) : -INFINITY;
      const float mbt = add(mb_in, p.tab[1][base + cd]);
      c = lse2<FAST>(lse2<FAST>(p.tab[0][base + cd], two), mbt);
    }
    const float acc = add(c, p.tab[2][base + cd]);
    const float prev = d >= 1 ? __ldcg(qrm + (j - 1) * N + d - 1) : -INFINITY;
    if (CONTRA) {
      rm = lse2<FAST>(add(prev, p.par[4][0]), add(acc, p.par[5][0]));
      const float pmb =
          d >= 1 ? __ldcg(qrmmb + (j - 1) * N + d - 1) : -INFINITY;
      rmmb = lse2<FAST>(add(pmb, p.par[6][0]), add(acc, p.par[7][0]));
      qrmmb[j * N + d] = rmmb;
    } else {
      rm = lse2<FAST>(prev, acc);
    }
    close[cd] = c;
    qrm[j * N + d] = rm;
  }
  // the O(d) sums over t' = k - i: ext over [0, d-1], s1 / s2 over
  // [1, d-1]; term 0 (thread 0's first leaf) is rm's
  const float coeff = CONTRA ? 0.0f : p.par[5][0];
  const float mbu = CONTRA ? p.par[6][0] : 0.0f;
  const auto sums = [&](int tt, bool in, float (&x)[3]) {
    const bool live = in && tt >= 1;
    const int ts = live ? tt : 1;  // d >= 1: a cell of the lane's rows
    const float q = __ldcg(qrm + j * N + d - ts);
    const float e = __ldcg(ext + i * N + ts - 1);
    const float o = __ldcg(one + i * N + ts - 1);
    const float y = CONTRA ? __ldcg(qrmmb + j * N + d - ts) : 0.0f;
    x[0] = x[1] = x[2] = -INFINITY;
    if (in && tt == 0) x[0] = add(rm, 0.0f);
    if (!live) return;
    x[0] = add(q, e);
    if (CONTRA) {
      x[1] = add(y, __fmul_rn(mbu, (float)tt));
      x[2] = add(o, y);
    } else {
      const float yc = add(q, coeff);
      x[1] = yc;
      x[2] = add(o, yc);
    }
  };
  float v3[3], w3[3];
  thread_tree<FAST, 3, SCAN_LG_INSIDE>(active ? d : 0, g, t, sums, AnyLive(),
                                       v3, w3);
  if (d > 0) group_reduce<FAST, 3>(v3, w3, g, t, gib, red);
  if (active && t == 0) {
    float out[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = tree_value<FAST>(v3[k], w3[k]);
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

// At span d: the windows of span d + 1's closing lanes (listed at span
// d - 1), the list of span d + 2's, then span d's lanes.
template <bool CONTRA, bool FAST>
__global__ void __launch_bounds__(SCAN_T, 2) scan_inside_kernel(ScanArgs p) {
  __shared__ float red[(FAST ? 2 : 1) * 3 * SCAN_T];
  cg::grid_group grid = cg::this_grid();
  scan_cubic_load();
  const int N = p.N;
  for (int d = 0; d < N; ++d) {
    if (d + 1 < N && d + 1 >= 2) {
      const int items = __ldcg(p.counts + d + 1);
      if (items > 0) {
        const int g = scan_group(inside_window_terms(d + 1),
                                 pow2_ceil(inside_window_extent(d + 1)),
                                 items, SCAN_LG_INSIDE, p.gcap);
        span_lanes(g, items, [&](int item, bool active, int t, int gib) {
          inside_window<CONTRA, FAST>(p, d + 1, g, item, active, t, gib,
                                      red);
        });
      }
    }
    __syncthreads();  // the next kind's groups reuse the barrier ids
    if (d + 2 < N && d + 3 >= p.min_span)
      build_list(p, d + 2, [&](int b, int i) {
        return p.canon[(size_t)b * N * N + i * N + d + 2] != 0;
      });
    const int lanes = p.lanes[(size_t)d * (p.B + 1) + p.B];
    if (lanes > 0) {
      const int g = scan_group(d, pow2_ceil(d), lanes, SCAN_LG_INSIDE,
                               p.gcap);
      span_lanes(g, lanes, [&](int lane, bool active, int t, int gib) {
        inside_lane<CONTRA, FAST>(p, d, g, lane, active, t, gib, red);
      });
    }
    if (d + 1 < N) grid.sync();
  }
}

// ----------------------------------------------------------------------
// K21: the outside pass
// ----------------------------------------------------------------------

// K21's context at left end i: is any term of its three segments (s N + 1
// .. s N + i, s = 0, 1, 2) among k0 + u S, u < cnt (S a power of two)?
struct ContextLive {
  static constexpr bool dfs = true;
  int i, N;
  __device__ __forceinline__ bool operator()(int k0, int S, int cnt) const {
    const int sh = log2_of(S);
#pragma unroll
    for (int seg = 0; seg < 3; ++seg) {
      const int lo = seg * N + 1, hi = seg * N + i;
      const int u = lo > k0 ? (lo - k0 + S - 1) >> sh : 0;
      if (u < cnt && k0 + u * S <= hi) return true;
    }
    return false;
  }
};

// state: close, ext, one, qone (the inside's), bppo, g, qpm, qpm2

// pm, pm2 of a lane (b, i) at span d: pairs (i, j + k), k in [1, n-1-j];
// and bppo, G = -inf where (i, j) cannot pair
template <bool CONTRA, bool FAST>
__device__ __forceinline__ void outside_pm(const ScanArgs& p, int d, int g,
                                          int lane, bool active, int t,
                                          int gib, float* red) {
  const int N = p.N;
  int b = 0, i = 0;
  if (active) lane_of(p.lanes + (size_t)d * (p.B + 1), p.B, lane, b, i);
  const int n = p.ns[b], j = i + d;
  const size_t base = (size_t)b * N * N;
  const float* one = p.st[2] + base;
  float* gt = p.st[5] + base;
  const int cd = i * N + d;
  const bool valid = active && d + 1 >= p.min_span;
  const float mbu = CONTRA ? p.par[6][0] : 0.0f;
  const auto pm = [&](int k, bool in, float (&x)[2]) {
    const bool live = in && k >= 1;
    const bool two = live && k >= 2;  // then j + 1 <= n - 2
    const float gv = __ldcg(gt + (live ? i * N + d + k : cd));
    const float o = one[two ? (j + 1) * N + k - 2 : cd];
    x[0] = x[1] = -INFINITY;
    if (!live) return;
    x[0] = add(gv, two ? o : -INFINITY);
    x[1] = CONTRA ? add(gv, __fmul_rn(mbu, __fsub_rn((float)k, 1.0f))) : gv;
  };
  float v[2], w[2];
  thread_tree<FAST, 2, SCAN_LG_OUTSIDE>(valid ? n - j : 0, g, t, pm,
                                        AnyLive(), v, w);
  group_reduce<FAST, 2>(v, w, g, t, gib, red);
  if (active && t == 0) {
    p.st[6][base + j * N + d] = tree_value<FAST>(v[0], w[0]);
    p.st[7][base + j * N + d] = tree_value<FAST>(v[1], w[1]);
    if (!(valid && isfinite(p.st[0][base + cd]))) {
      p.st[4][base + cd] = -INFINITY;
      gt[cd] = -INFINITY;
    }
  }
}

// The 2-loop window of a pair lane (b, i) at span d: outer pair (i-1-a,
// j+1+b) inside the sequence, summed a span early (its outer pairs are of
// spans >= d + 2).
template <bool CONTRA, bool FAST>
__device__ __forceinline__ void outside_window(const ScanArgs& p, int d,
                                              int g, int item, bool active,
                                              int t, int gib, float* red) {
  const int N = p.N;
  int b = 0, i = 0;
  if (active) entry_of(p, d, item, b, i);
  const int n = p.ns[b], j = i + d;
  const size_t base = (size_t)b * N * N;
  const int* s = p.seq + (size_t)b * N;
  const float* close = p.st[0] + base;
  const float* bppo = p.st[4] + base;
  const int cd = i * N + d;
  const float cl = close[cd];
  float v[1] = {-INFINITY}, w[1] = {0.0f};
  if (active) {
    TurnerLane tl;
    ContraLane cn;
    if (CONTRA)
      cn = contra_lane(p, base, s, i, j, cd, false);
    else
      tl = turner_lane(p, base, s, i, j, cd, false);
    const int amax = min(SCAN_W - 1, i - 1), bmax = min(SCAN_W - 1, n - 2 - j);
    const auto window = [&](int k, bool in, float (&x)[1]) {
      const int kk = in ? k : 0;  // a, b <= 30: the tables' cells
      const int a = kk / SCAN_W, bb = kk - a * SCAN_W;
      const bool live = in && a <= amax && bb <= bmax;
      const int wc = live ? (i - 1 - a) * N + d + 2 + a + bb : cd;
      const float wcl = close[wc];
      const float bw = __ldcg(bppo + wc);
      const float tlv = CONTRA ? contra_tl(p, base, cn, a, bb, wc, false)
                               : turner_tl(p, base, tl, a, bb, wc, false);
      x[0] = live && isfinite(wcl) ? add(__fsub_rn(add(bw, cl), wcl), tlv)
                                   : -INFINITY;
    };
    thread_tree<FAST, 1, SCAN_LG_OUTSIDE>(
        amax >= 0 && bmax >= 0 ? amax * SCAN_W + bmax + 1 : 0, g, t, window,
        AnyLive(), v, w);
  }
  group_reduce<FAST, 1>(v, w, g, t, gib, red);
  if (active && t == 0) *window_sum(p, d, b, i) = tree_value<FAST>(v[0], w[0]);
}

// The multibranch context of a pair lane (b, i) at span d: k' = i - t' <
// i, t' in [1, i], the terms at t', N + t' and 2N + t' of one tree over 2N
// + i + 1 positions (blocks with no live term skipped whole); then bppo
// and G from it, the window (summed at span d + 1) and the exterior.
template <bool CONTRA, bool FAST>
__device__ __forceinline__ void outside_context(const ScanArgs& p, int d,
                                               int g, int item, bool active,
                                               int t, int gib, float* red) {
  const int N = p.N;
  int b = 0, i = 0;
  if (active) entry_of(p, d, item, b, i);
  const int n = p.ns[b], j = i + d;
  const size_t base = (size_t)b * N * N;
  const float* close = p.st[0] + base;
  const float* ext = p.st[1] + base;
  const float* qone = p.st[3] + base;
  const float* qpm = p.st[6] + base;
  const float* qpm2 = p.st[7] + base;
  const int cd = i * N + d;
  const float cl = close[cd];
  const float mbu = CONTRA ? p.par[6][0] : 0.0f;
  const float acc = add(cl, p.tab[2][base + cd]);
  const float acc_mb = add(acc, CONTRA ? p.par[7][0] : p.par[5][0]);
  float v[1] = {-INFINITY}, w[1] = {0.0f};
  if (active && i >= 1) {
    const auto context = [&](int k, bool in, float (&x)[1]) {
      const int seg = k >= 2 * N ? 2 : k >= N ? 1 : 0, tt = k - seg * N;
      const bool live = in && tt >= 1 && tt <= i;
      const int ts = live ? tt : 1;
      const float q = qone[(i - 1) * N + (ts >= 2 ? ts - 2 : 0)];
      const float r0 = __ldcg((seg == 0 ? qpm2 : qpm) + j * N + d + ts);
      x[0] = -INFINITY;
      if (!live) return;
      const float qq = tt >= 2 ? q : -INFINITY;
      if (seg == 0) {
        x[0] = add(add(acc_mb, r0), qq);
      } else {
        const float r = add(acc_mb, r0);
        if (seg == 2)
          x[0] = add(r, qq);
        else
          x[0] = CONTRA ? add(r, __fmul_rn(mbu, __fsub_rn((float)tt, 1.0f)))
                        : r;
      }
    };
    thread_tree<FAST, 1, SCAN_LG_OUTSIDE>(2 * N + i + 1, g, t, context,
                                          ContextLive{i, N}, v, w);
  }
  group_reduce<FAST, 1>(v, w, g, t, gib, red);
  if (active && t == 0) {
    const float two = __ldcg(window_sum(p, d, b, i));
    const float ctx = tree_value<FAST>(v[0], w[0]);
    const float lt = i >= 1 ? ext[i - 1] : 0.0f;
    const float rt = j <= n - 2 ? ext[(j + 1) * N + n - 2 - j] : 0.0f;
    float bs = __fsub_rn(add(add(lt, acc), rt), ext[n - 1]);
    if (CONTRA) bs = add(bs, p.par[5][0]);
    const float bp = lse2<FAST>(lse2<FAST>(bs, two), ctx);
    p.st[4][base + cd] = bp;
    p.st[5][base + cd] = __fsub_rn(add(bp, p.tab[1][base + cd]), cl);
  }
}

// span d's lanes that can pair (d + 1 >= min_span, close finite)
__device__ __forceinline__ void outside_list(const ScanArgs& p, int d) {
  if (d < 0 || d + 1 < p.min_span) return;
  build_list(p, d, [&](int b, int i) {
    return isfinite(p.st[0][(size_t)b * p.N * p.N + i * p.N + d]);
  });
}

// At span d: the contexts of span d's pair lanes (listed at span d + 2),
// the pm/pm2 trees of all its lanes, the windows of span d - 1's pair
// lanes (listed at span d + 1), then the list of span d - 2's.  Before
// the first span: the lists of spans N - 1 and N - 2 (their windows hold
// no live term, so their sums keep the wrapper's -inf).
template <bool CONTRA, bool FAST>
__global__ void __launch_bounds__(SCAN_T, 2) scan_outside_kernel(ScanArgs p) {
  __shared__ float red[(FAST ? 2 : 1) * 2 * SCAN_T];
  cg::grid_group grid = cg::this_grid();
  scan_cubic_load();
  const int N = p.N;
  outside_list(p, N - 1);
  outside_list(p, N - 2);
  grid.sync();
  for (int d = N - 1; d >= 0; --d) {
    // the widest trees: the context 3 (N - 1 - d) live terms over 3N - d
    // positions, pm/pm2 N - 1 - d over N - d, the window 961 over 1,024
    const int pairs = d + 1 >= p.min_span ? __ldcg(p.counts + d) : 0;
    if (pairs > 0) {
      const int g = scan_group(max(3 * (N - 1 - d), 1), pow2_ceil(3 * N - d),
                               pairs, SCAN_LG_OUTSIDE, p.gcap);
      span_lanes(g, pairs, [&](int item, bool active, int t, int gib) {
        outside_context<CONTRA, FAST>(p, d, g, item, active, t, gib, red);
      });
    }
    __syncthreads();  // the next kind's groups reuse the barrier ids
    const int lanes = p.lanes[(size_t)d * (p.B + 1) + p.B];
    if (lanes > 0) {
      const int g = scan_group(max(N - 1 - d, 1), pow2_ceil(N - d), lanes,
                               SCAN_LG_OUTSIDE, p.gcap);
      span_lanes(g, lanes, [&](int lane, bool active, int t, int gib) {
        outside_pm<CONTRA, FAST>(p, d, g, lane, active, t, gib, red);
      });
    }
    __syncthreads();
    const int wins = d >= 1 && d >= p.min_span ? __ldcg(p.counts + d - 1) : 0;
    if (wins > 0) {
      const int g = scan_group(SCAN_WIN, pow2_ceil(SCAN_WIN), wins,
                               SCAN_LG_OUTSIDE, p.gcap);
      span_lanes(g, wins, [&](int item, bool active, int t, int gib) {
        outside_window<CONTRA, FAST>(p, d - 1, g, item, active, t, gib, red);
      });
    }
    outside_list(p, d - 2);
    if (d > 0) grid.sync();
  }
}

// ----------------------------------------------------------------------
// C entry points
// ----------------------------------------------------------------------

template <bool INSIDE, bool CONTRA, bool FAST>
static const void* scan_kernel() {
  if (INSIDE) return (const void*)scan_inside_kernel<CONTRA, FAST>;
  return (const void*)scan_outside_kernel<CONTRA, FAST>;
}

static const void* scan_pick(int inside, int contra, int fast) {
  if (inside)
    return contra ? (fast ? scan_kernel<true, true, true>()
                          : scan_kernel<true, true, false>())
                  : (fast ? scan_kernel<true, false, true>()
                          : scan_kernel<true, false, false>());
  return contra ? (fast ? scan_kernel<false, true, true>()
                        : scan_kernel<false, true, false>())
                : (fast ? scan_kernel<false, false, true>()
                        : scan_kernel<false, false, false>());
}

// The grid of a pass: the blocks of SCAN_T threads the card keeps
// resident for the kernel instance (a cooperative launch takes no more).
extern "C" int rna_scan_blocks(int inside, int contra, int fast,
                               int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_pick(inside, contra, fast), SCAN_T, 0);
  *blocks = per_sm * sms;
  if (err == cudaSuccess && *blocks < 1) err = cudaErrorInvalidConfiguration;
  return (int)err;
}

// One pass (K20 if `inside`, else K21) in one cooperative launch of
// `blocks` blocks (at most rna_scan_blocks'), groups at most `gcap` wide;
// `lists` (3 B N + N ints, the counts zero) and `windows` (2 B N floats,
// -inf) are its work lists and window sums.
extern "C" int rna_scan_pass(int inside, const void** tabs,
                             const void* canon, const void** pars,
                             void** sts, const void* seq, const void* ns,
                             const void* lanes, void* lists, void* windows,
                             int B, int N, int contra, int fast,
                             int min_span, int gcap, int blocks,
                             void* stream) {
  if (N < 1 || B < 1 || blocks < 1 || gcap < 1 || (gcap & (gcap - 1)))
    return (int)cudaErrorInvalidValue;
  ScanArgs a;
  const int nt = contra ? 7 : 10, np = contra ? 10 : 9;
  for (int k = 0; k < 10; ++k) a.tab[k] = k < nt ? (const float*)tabs[k] : 0;
  for (int k = 0; k < 12; ++k) a.par[k] = k < np ? (const float*)pars[k] : 0;
  for (int k = 0; k < 8; ++k) a.st[k] = (float*)sts[k];
  a.canon = (const unsigned char*)canon;
  a.seq = (const int*)seq;
  a.ns = (const int*)ns;
  a.lanes = (const int*)lanes;
  a.lists = (int*)lists;
  a.counts = (int*)lists + (size_t)3 * B * N;
  a.windows = (float*)windows;
  a.B = B;
  a.N = N;
  a.min_span = min_span;
  a.gcap = gcap;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      scan_pick(inside, contra, fast), dim3(blocks), dim3(SCAN_T), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
