"""Knock-out probes of the generic-N scan kernels K20/K21 of a build
(``csrc/fold_scan.cu`` with its ``ops/fold_scan.py``), for timing only, on
a CUDA GPU.

    python scripts/scan_probes.py --tree DIR

DIR is an unpacked checkout (``git archive COMMIT rna_algos_tpu_torch``,
or the repository itself).  The script writes copies of its kernel
sources to DIR/_probes/<name>/csrc that differ from it in ``fold_scan.cu``
alone, each substitution checked to apply where it should.  For a build
whose kernels take one launch a span:

  base      unchanged
  launch    K20 and K21 return at once: the pass's launches and host cost
  nowindow  K20 without its 2-loop window (every lane's window sum -inf)
  ctxcut    K21's trees over the lane's live terms only: the extent
            max(961, n - j, 3i + 3) instead of 3N - d, the context's three
            segments dealt t-major (k = 3(t - 1) + segment); not the
            JAX tree's order, timing only
  clock     clock64() marks: thread 0 of every live block adds the cycles
            of the kernel, of each tree's leaves and of its block tree

For a build with one cooperative launch a pass (its kinds of work a span):

  base      unchanged
  launch    both kernels return once the block has its cubic table: the
            launch, the wrapper's set-up and one block barrier
  nolse     every tree's log-add (``merge``) a max: the cubic's share
  nowindow  the window kinds skipped (K20's and K21's): their share
  kinds     %globaltimer marks in block 0 at each kind's end and after the
            grid barrier: a pass's time by kind, as block 0 sees it

and times one pass of each kernel (CUDA events, the mean of REPS passes
after a warm-up) through DIR's own ``ops/fold_scan.py`` at chip_smoke.py's
scan shapes: CONTRA and Turner at N = 1536 B = 2 (exact) and N = 384 B = 8
(parity), on ``chip_smoke.scan_inputs``; for a build of one launch a span
also the launch and base passes captured once in a CUDA graph and
replayed (the same launches without the host).  Prints the card's name
and power limit and the base build's ptxas lines first.  Needs a GPU.

    python scripts/scan_probes.py --rows --tree DIR

makes knock-out copies of the Durbin row scan K22 instead
(``csrc/pairhmm_rows.cu``, driven through DIR's own
``ops/pairhmm_rows.py``), each differing from it in ``pairhmm_rows.cu``
alone:

  base       unchanged
  nobarrier  the block barriers of the row loop removed (one after the
             cells, one after the leaves, one a level of each sweep in a
             build of one block a pair; the three a row of a build with
             the tree in registers and shuffles)
  nolse      every log-add a max (``rows_lse``): the cubic's share
  both       nobarrier and nolse: what is left (the loads, the stores, the
             adds and the loop)

and, for the redesign (runs of columns a thread, its own branch-free
log-add):

  cubich     cubic.cuh's log-add (rna_lse_pair, branching on z) instead
  r4, r1     runs of 4 and 1 columns a thread instead of 2
  t512       blocks of up to 512 threads before a cluster (not 256)
  c1 .. c8   a pair on a cluster of 1, 2, 4 or 8 blocks (where the runs
             fit; a launch that is refused is reported)
  phases     clock64() marks in warps 0 and 1 of block 0: a row's cycles
             by phase (the cells, the forward stores, the wait at each of
             the two barriers, the leaves with the previous row's backward
             outputs and the sweeps up, the block's levels, the carries'
             shuffles, the sweeps down, the row's end), and the loop's
             %globaltimer nanoseconds

``--variants a,b`` times only those (and base).

and times a forward and a backward pass of each (CUDA events, the mean of
ROWS_REPS after a warm-up) at chip_smoke.py's K22 shapes (``ROWS_CHECK``:
the RNase P set's (384, 512) and (512, 384) buckets and the SSU set's
commonest bucket, all their pairs); then the base build again with the
bucket's pairs repeated to as many pairs as the card has SMs (one block a
pair on every SM in the first form).
"""

import argparse
import pathlib
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

REPS = 2
SHAPES = (("contra", 1536, 2, "exact"), ("turner", 1536, 2, "exact"),
          ("contra", 384, 8, "parity"), ("turner", 384, 8, "parity"))
# the files a probe build needs: the scan source, its headers, and
# skew.cu for rna_error_string
SOURCES = ("fold_scan.cu", "skew.cu")

INSIDE_HEAD = "__global__ void scan_inside_kernel(ScanArgs p) {\n"
OUTSIDE_HEAD = "__global__ void scan_outside_kernel(ScanArgs p) {\n"
EARLY = "  if (j >= n) return;\n  const int tid = threadIdx.x;\n"
LEAVES_END = ("#pragma unroll\n    for (int k = 0; k < K; ++k) "
              "red[k * T + tid] = x[k];\n")
TREE_END = ("        if (tid == 0) out[k] = y;\n      }\n    }\n"
            "    __syncthreads();\n  } else {\n")
INSIDE_END = "    qone[j * N + d] = o;\n  }\n}\n"
OUTSIDE_END = "    bppo[cd] = bp;\n    g[cd] = gv;\n  }\n}\n"
PROBE_DECL = r"""
// clock64() probe: [0] K20 cycles, [1] K20 live blocks, [2 K] / [2 K + 1]
// scan_reduce<K>'s leaves / block tree (K = 1 the window, 3 the O(d)
// sums, 4 K21's trees), [10] K21 cycles, [11] K21 live blocks
__device__ unsigned long long rna_scan_probe[12];
extern "C" int rna_scan_probe_read(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, rna_scan_probe,
                                       sizeof(rna_scan_probe));
  if (e == cudaSuccess && reset) {
    unsigned long long zero[12] = {0};
    e = cudaMemcpyToSymbol(rna_scan_probe, zero, sizeof(zero));
  }
  return (int)e;
}
"""
PROBE_SLOTS = {"K20 kernel": 0, "K20 window leaves": 2,
               "K20 window tree": 3, "K20 O(d) leaves": 6,
               "K20 O(d) tree": 7, "K21 kernel": 10,
               "K21 leaves": 8, "K21 tree": 9}


def _add(total, mark):
    return (f"    if (tid == 0) {{ atomicAdd(&rna_scan_probe[{total}], "
            f"(unsigned long long)(clock64() - {mark})); "
            f"atomicAdd(&rna_scan_probe[{total + 1}], 1ull); }}\n")


VARIANTS = {
    "base": [],
    "launch": [(INSIDE_HEAD, INSIDE_HEAD + "  if (p.N > 0) return;\n"),
               (OUTSIDE_HEAD, OUTSIDE_HEAD + "  if (p.N > 0) return;\n")],
    "nowindow": [("  if (closes) {  // the 2-loop window",
                  "  if (false) {  // the 2-loop window")],
    "ctxcut": [("scan_reduce<FAST, 4>(max(SCAN_WIN, 3 * N - d), terms, red, "
                "out);",
                "scan_reduce<FAST, 4>(max(SCAN_WIN, max(n - j, 3 * i + 3)), "
                "terms, red, out);"),
               ("const int seg = k / N, t = k - seg * N;",
                "const int seg = k % 3, t = k / 3 + 1;")],
    "clock": [('#include "cubic.cuh"\n', '#include "cubic.cuh"\n' + PROBE_DECL),
              ("  const int lg = scan_lg(extent, T), L = 1 << lg;\n",
               "  const int lg = scan_lg(extent, T), L = 1 << lg;\n"
               "  const long long rna_t0 = clock64();\n"),
              (LEAVES_END, "    const long long rna_t1 = clock64();\n"
               + LEAVES_END),
              (TREE_END, TREE_END.replace(
                  "  } else {\n",
                  "    if (tid == 0) { atomicAdd(&rna_scan_probe[2 * K], "
                  "(unsigned long long)(rna_t1 - rna_t0)); "
                  "atomicAdd(&rna_scan_probe[2 * K + 1], (unsigned long long)"
                  "(clock64() - rna_t1)); }\n  } else {\n")),
              (EARLY, EARLY + "  const long long rna_k0 = clock64();\n",
               2),
              (INSIDE_END, INSIDE_END[:-2] + _add(0, "rna_k0") + "}\n"),
              (OUTSIDE_END, OUTSIDE_END[:-2] + _add(10, "rna_k0") + "}\n")],
}


KIND_DECL = r"""
// %globaltimer probe: [0][*] K20's windows, lists and lanes, grid barrier;
// [1][*] K21's contexts, pm, windows and lists, grid barrier (block 0, ns)
__device__ unsigned long long rna_kind_ns[2][4];
extern "C" int rna_kind_read(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, rna_kind_ns, sizeof(rna_kind_ns));
  if (e == cudaSuccess && reset) {
    unsigned long long zero[8] = {0};
    e = cudaMemcpyToSymbol(rna_kind_ns, zero, sizeof(zero));
  }
  return (int)e;
}
__device__ __forceinline__ unsigned long long rna_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define RNA_MARK(k, s)                                    \
  if (threadIdx.x == 0 && blockIdx.x == 0) {              \
    const unsigned long long tn = rna_now();              \
    rna_kind_ns[k][s] += tn - rna_t;                      \
    rna_t = tn;                                           \
  }
"""
IN_LOOP = "  for (int d = 0; d < N; ++d) {\n    if (d + 1 < N && d + 1 >= 2) {\n"
OUT_LOOP = "  grid.sync();\n  for (int d = N - 1; d >= 0; --d) {\n"
SYNC = "    __syncthreads();  // the next kind's groups reuse the barrier ids\n"
IN_WIN = ("          inside_window<CONTRA, FAST>(p, d + 1, g, item, active, t, "
          "gib,\n                                      red);\n        });\n"
          "      }\n    }\n")
OUT_CTX = ("        outside_context<CONTRA, FAST>(p, d, g, item, active, t, gib, "
           "red);\n      });\n    }\n")
IN_END = "    if (d + 1 < N) grid.sync();\n"
OUT_PM = ("        outside_pm<CONTRA, FAST>(p, d, g, lane, active, t, gib, red);\n"
          "      });\n    }\n    __syncthreads();\n")
OUT_END = "    outside_list(p, d - 2);\n    if (d > 0) grid.sync();\n"
KIND_NAMES = (("windows", "lanes and lists", None, "grid barrier"),
              ("contexts", "pm/pm2", "windows", "lists and grid barrier"))
NEW_VARIANTS = {
    "base": [],
    "launch": [("  scan_cubic_load();\n",
                "  scan_cubic_load();\n  if (p.N > 0) return;\n", 2)],
    "nolse": [("  if (a == -INFINITY || b == -INFINITY) return fmaxf(a, b);\n"
               "  return scan_lse(a, b);", "  return fmaxf(a, b);")],
    "nowindow": [("const int items = __ldcg(p.counts + d + 1);",
                  "const int items = 0;"),
                 ("const int wins = d >= 1 && d >= p.min_span ? "
                  "__ldcg(p.counts + d - 1) : 0;", "const int wins = 0;")],
    "kinds": [('#include "cubic.cuh"\n', '#include "cubic.cuh"\n' + KIND_DECL),
              (IN_LOOP, "  unsigned long long rna_t = rna_now();\n" + IN_LOOP),
              (OUT_LOOP, "  grid.sync();\n  unsigned long long rna_t = "
               "rna_now();\n  for (int d = N - 1; d >= 0; --d) {\n"),
              (IN_WIN + SYNC, IN_WIN + SYNC + "    RNA_MARK(0, 0)\n"),
              (OUT_CTX + SYNC, OUT_CTX + SYNC + "    RNA_MARK(1, 0)\n"),
              (IN_END, "    __syncthreads();\n    RNA_MARK(0, 1)\n" + IN_END
               + "    RNA_MARK(0, 3)\n"),
              (OUT_PM, OUT_PM + "    RNA_MARK(1, 1)\n"),
              (OUT_END, "    __syncthreads();\n    RNA_MARK(1, 2)\n" + OUT_END
               + "    RNA_MARK(1, 3)\n")],
}


def make_variant(tree, name):
    """DIR/_probes/<name>/csrc: the scan source with the variant's
    substitutions (each ``(old, new[, count])``: ``old`` must occur
    ``count`` times, once by default), skew.cu and every header of DIR's
    csrc."""
    src = tree / "rna_algos_tpu_torch" / "csrc"
    dst = tree / "_probes" / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for p in src.iterdir():
        if p.suffix == ".cuh" or p.name in SOURCES:
            shutil.copy(p, dst / p.name)
    text = (src / "fold_scan.cu").read_text()
    subs = (NEW_VARIANTS if "scan_cubic_load" in text else VARIANTS)[name]
    for old, new, *count in subs:
        if text.count(old) != (count[0] if count else 1):
            raise RuntimeError(f"{name}: {old[:60]!r} occurs "
                               f"{text.count(old)} times in fold_scan.cu")
        text = text.replace(old, new)
    (dst / "fold_scan.cu").write_text(text)
    return dst


def passes(FS, x, mode):
    """(inside pass, outside pass) closures on ``x`` through module FS."""
    a = (x["seqs"], x["ns"], x["tbl"], x["pre"])
    ins = FS.scan_inside(*a, x["contra"], False, mode)
    return (lambda: FS.scan_inside(*a, x["contra"], False, mode),
            lambda: FS.scan_outside(*a, ins, x["contra"], False, mode))


def graph_ms(fn, reps):
    """Mean ms of a replay of ``fn`` captured once in a CUDA graph."""
    import chip_smoke

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return chip_smoke.cuda_ms(g.replay, reps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="unpacked checkout with rna_algos_tpu_torch/")
    ap.add_argument("--rows", action="store_true",
                    help="the Durbin row scan K22 instead of K20/K21")
    ap.add_argument("--variants", default="",
                    help="with --rows: only these variants (and base)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_probes: no CUDA GPU available", file=sys.stderr)
        return 2
    if args.rows:
        return rows_main(pathlib.Path(args.tree).resolve(),
                         [v for v in args.variants.split(",") if v])
    import ab_kernels
    import chip_smoke
    from rna_algos_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    tree = pathlib.Path(args.tree).resolve()
    FS = ab_kernels.fold_scan_module(tree / "rna_algos_tpu_torch" / "csrc")
    text = (tree / "rna_algos_tpu_torch" / "csrc" / "fold_scan.cu").read_text()
    per_pass = "scan_cubic_load" in text   # one launch a pass
    names = NEW_VARIANTS if per_pass else VARIANTS
    libs = {name: ab_kernels.load(make_variant(tree, name), False)
            for name in names}
    for kernel, line in ab_kernels.ptxas_lines(libs["base"].compiler_output):
        if "scan_" in kernel:
            print(f"ptxas {kernel}: {line}")
    dev = torch.device("cuda")
    for model, N, B, mode in SHAPES:
        x = chip_smoke.scan_inputs(model, N, B, seed=N + B, device=dev)
        label = f"{model} N={N} B={B} {mode}"
        for name, lib in libs.items():
            ab_kernels.use(lib)
            k20, k21 = passes(FS, x, mode)
            if name == "clock":
                print(f"{label} clock: {clock_marks(lib, k20, k21)}")
            elif name == "kinds":
                print(f"{label} kinds: {kind_marks(lib, k20, k21)}")
            else:
                ms = [chip_smoke.cuda_ms(fn, REPS) for fn in (k20, k21)]
                print(f"{label} {name}: K20 {ms[0]:.4f} ms a pass, K21 "
                      f"{ms[1]:.4f} ms a pass "
                      f"({'one launch' if per_pass else f'{N} launches'} "
                      "each)")
            if name in ("launch", "base") and not per_pass:
                gms = [graph_ms(fn, REPS) for fn in (k20, k21)]
                print(f"{label} {name} as a CUDA graph: K20 {gms[0]:.4f} "
                      f"ms, K21 {gms[1]:.4f} ms a pass")
        del x
        torch.cuda.empty_cache()
    return 0


def _read(fn, n):
    """One pass of each kernel between two reads of a probe array of n
    counters (the first read resets it)."""
    from rna_algos_tpu_torch.ops import _build

    def run(k20, k21):
        fn.argtypes = [_build._P, _build._I]
        fn.restype = _build._I
        counts = (_build.ctypes.c_ulonglong * n)()
        fn(counts, 1)
        torch.cuda.synchronize()
        k20()
        k21()
        torch.cuda.synchronize()
        if fn(counts, 1):
            raise RuntimeError("scan_probes: probe read failed")
        return list(counts)
    return run


def clock_marks(lib, k20, k21):
    c = _read(lib.lib.rna_scan_probe_read, 12)(k20, k21)
    parts = ", ".join(
        f"{k} {c[s]:.4e} cycles"
        f" ({c[s] / max(c[0 if k.startswith('K20') else 10], 1):.3f})"
        for k, s in PROBE_SLOTS.items())
    return (f"live blocks K20 {c[1]}, K21 {c[11]}; {parts}; cycles a live "
            f"block K20 {c[0] / max(c[1], 1):.1f}, K21 "
            f"{c[10] / max(c[11], 1):.1f}")


def kind_marks(lib, k20, k21):
    c = _read(lib.lib.rna_kind_read, 8)(k20, k21)
    parts = []
    for k, names in enumerate(KIND_NAMES):
        total = sum(c[4 * k:4 * k + 4])
        parts.append(f"K{20 + k} " + ", ".join(
            f"{name} {c[4 * k + s] / 1e6:.3f} ms "
            f"({c[4 * k + s] / max(total, 1):.3f})"
            for s, name in enumerate(names) if name))
    return "; ".join(parts)


ROWS_REPS = 3
# The row loop's block barriers of PR 15's K22 (one block a pair, the
# tree in shared memory), each with the text around it
ROWS_OLD_SYNCS = [
    ("      if (!B) plane[(long long)i * N2 + j] = fm;\n    }\n"
     "    __syncthreads();\n",
     "      if (!B) plane[(long long)i * N2 + j] = fm;\n    }\n"),
    ("      sd[1 + j] = b;\n    }\n    __syncthreads();\n",
     "      sd[1 + j] = b;\n    }\n"),
    ("      ofs += Wp >> (l - 1);\n      __syncthreads();\n",
     "      ofs += Wp >> (l - 1);\n"),
    ("__fadd_rn(hc[o + 2 * k], sd[pos - s]));\n      }\n"
     "      __syncthreads();\n",
     "__fadd_rn(hc[o + 2 * k], sd[pos - s]));\n      }\n")]
# The row loop's three block barriers of the redesign (rows_sync)
ROWS_NEW_SYNCS = [("__device__ __forceinline__ void rows_sync(int C) {\n",
                   "__device__ __forceinline__ void rows_sync(int C) {\n"
                   "  if (C > 0) return;\n")]
ROWS_LSE = ("  if constexpr (FAST)\n    return {}(a, b);\n"
            "  else\n    return {}(a, b);\n")
ROWS_MAX = "  return fmaxf(a, b);\n"
ROWS_RUN = "#define RNA_ROWS_R 2 "
ROWS_CLUSTER = "    C = units > RNA_ROWS_T ? units / RNA_ROWS_T : 1;\n"
ROWS_PHASE_DECL = r"""
// clock64() marks: [w][k] the cycles of phase k in warp w of block 0,
// [w][9] the row loop's %globaltimer nanoseconds
__device__ unsigned long long rna_rows_probe[2][10];
extern "C" int rna_rows_probe_read(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, rna_rows_probe,
                                       sizeof(rna_rows_probe));
  if (e == cudaSuccess && reset) {
    unsigned long long zero[20] = {0};
    e = cudaMemcpyToSymbol(rna_rows_probe, zero, sizeof(zero));
  }
  return (int)e;
}
__device__ __forceinline__ unsigned long long rows_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define ROWS_WATCH (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 32))
#define ROWS_MARK(k)                                                 \
  if (ROWS_WATCH) {                                                  \
    const long long tn = clock64();                                  \
    rna_rows_probe[threadIdx.x >> 5][k] += tn - rows_t;              \
    rows_t = tn;                                                     \
  }
"""
ROWS_PHASES = [
    ('#include "cubic.cuh"\n', '#include "cubic.cuh"\n' + ROWS_PHASE_DECL),
    ("  for (int i = 0; i < rows; ++i) {\n",
     "  long long rows_t = clock64();\n"
     "  const unsigned long long rows_g = rows_now();\n"
     "  for (int i = 0; i < rows; ++i) {\n    ROWS_MARK(8)\n"),
    ("    if (!B) {\n", "    ROWS_MARK(0)\n    if (!B) {\n"),
    ("    rows_sync(C);  // the edges' M and I\n",
     "    ROWS_MARK(1)\n    rows_sync(C);  // the edges' M and I\n"
     "    ROWS_MARK(2)\n"),
    ("    rows_sync(1);  // the warps' aggregates\n",
     "    ROWS_MARK(3)\n    rows_sync(1);  // the warps' aggregates\n"
     "    ROWS_MARK(4)\n"),
    ("    // D final before warp q and at its last column\n",
     "    ROWS_MARK(5)\n    // D final before warp q and at its last column\n"),
    ("    if (live) {\n      // down-sweep: the warp's levels, then the run's\n",
     "    ROWS_MARK(6)\n    if (live) {\n"
     "      // down-sweep: the warp's levels, then the run's\n"),
    ("    // the corner; backward, the row's outputs",
     "    ROWS_MARK(7)\n    // the corner; backward, the row's outputs"),
    ("  // the rows past the box\n",
     "  if (ROWS_WATCH) rna_rows_probe[threadIdx.x >> 5][9] += "
     "rows_now() - rows_g;\n  // the rows past the box\n")]
ROWS_PHASE_NAMES = ("cells", "forward stores", "wait (edges)",
                    "leaves, outputs and up", "wait (aggregates)",
                    "block levels", "carries", "down", "row's end")


def rows_variants(text):
    """name -> substitutions for the K22 source ``text``."""
    if "RNA_ROWS_MAX_N2" in text:   # PR 15's form
        syncs, extra = ROWS_OLD_SYNCS, {}
        lse = ROWS_LSE.format("rna_lse_pair_fast", "rna_lse_pair")
    else:
        syncs = ROWS_NEW_SYNCS
        lse = ROWS_LSE.format("rows_fast_lse", "rows_cubic_lse")
        extra = {"cubich": [(lse, ROWS_LSE.format("rows_fast_lse",
                                                  "rna_lse_pair"))],
                 "r4": [(ROWS_RUN, ROWS_RUN.replace("2", "4"))],
                 "r1": [(ROWS_RUN, ROWS_RUN.replace("2", "1"))],
                 "t512": [("#define RNA_ROWS_T 256 ",
                           "#define RNA_ROWS_T 512 ")],
                 "phases": ROWS_PHASES,
                 **{f"c{C}": [(ROWS_CLUSTER, f"    C = {C};\n")]
                    for C in (1, 2, 4, 8)}}
    return {"base": [], "nobarrier": syncs, "nolse": [(lse, ROWS_MAX)],
            "both": syncs + [(lse, ROWS_MAX)], **extra}


def make_rows_variant(tree, name, subs):
    """DIR/_probes/rows_<name>/csrc: pairhmm_rows.cu with the
    substitutions (each must occur once), skew.cu and the headers."""
    src = tree / "rna_algos_tpu_torch" / "csrc"
    dst = tree / "_probes" / f"rows_{name}" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for p in src.iterdir():
        if p.suffix == ".cuh" or p.name == "skew.cu":
            shutil.copy(p, dst / p.name)
    text = (src / "pairhmm_rows.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"rows_{name}: {old[:60]!r} occurs "
                               f"{text.count(old)} times in pairhmm_rows.cu")
        text = text.replace(old, new)
    (dst / "pairhmm_rows.cu").write_text(text)
    return dst


def rows_shapes(dev, sms):
    """label -> inputs: chip_smoke.py's K22 buckets, and each with its
    pairs repeated to ``sms`` pairs."""
    import chip_smoke
    from rna_algos_tpu_torch.utils.io import read_fasta

    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    rsets = chip_smoke.rows_sets(trnas)
    out = {}
    for name, key in chip_smoke.ROWS_CHECK:
        seqs, pairs = rsets[name]
        groups = chip_smoke.rows_buckets(seqs, pairs)
        if key is None:
            key = max(groups, key=lambda g: len(groups[g]))
        ps = groups[key]
        label = f"{name.split('_')[0]}_N{key[0]}x{key[1]}"
        out[f"{label}_P{len(ps)}"] = chip_smoke.rows_inputs(seqs, ps, key,
                                                            dev)
        full = [ps[k % len(ps)] for k in range(sms)]
        out[f"{label}_P{sms}"] = chip_smoke.rows_inputs(seqs, full, key, dev)
    return out


def rows_pass_ms(PR, x):
    """Mean ms of a pass (a forward and a backward launch, halved)."""
    import chip_smoke

    def run():
        for b in (0, 1):
            PR._rows_cuda(x["x1"], x["x2"], x["n1"], x["n2"], x["ms"],
                          x["ins"], x["scal"][b], b, "exact")
    return chip_smoke.cuda_ms(run, ROWS_REPS) / 2


def rows_phases(lib, PR, x):
    """One forward and one backward pass of ``x`` through a ``phases``
    build: each watched warp's cycles a row by phase, and the clock."""
    from rna_algos_tpu_torch.ops import _build

    fn = lib.lib.rna_rows_probe_read
    fn.argtypes = [_build._P, _build._I]
    fn.restype = _build._I
    counts = (_build.ctypes.c_ulonglong * 20)()
    out = []
    for b in (0, 1):
        fn(counts, 1)
        torch.cuda.synchronize()
        PR._rows_cuda(x["x1"], x["x2"], x["n1"], x["n2"], x["ms"], x["ins"],
                      x["scal"][b], b, "exact")
        torch.cuda.synchronize()
        if fn(counts, 1):
            raise RuntimeError("scan_probes: probe read failed")
        rows = int(x["n1"][0]) - 1
        for w in (0, 1):
            c = list(counts)[10 * w:10 * w + 10]
            cyc = sum(c[:9])
            out.append(f"{'backward' if b else 'forward'} warp {w}: "
                       + ", ".join(f"{n} {c[k] / rows:.0f}"
                                   for k, n in enumerate(ROWS_PHASE_NAMES))
                       + f" cycles a row ({cyc / rows:.0f} in all, "
                       f"{c[9] / rows:.1f} ns a row, "
                       f"{cyc / max(c[9], 1):.3f} GHz)")
    return "; ".join(out)


def rows_main(tree, only=None):
    """The K22 knock-outs of DIR (module docstring)."""
    import ab_kernels

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    csrc = tree / "rna_algos_tpu_torch" / "csrc"
    PR = ab_kernels.tree_module(csrc, "pairhmm_rows")
    variants = rows_variants((csrc / "pairhmm_rows.cu").read_text())
    if only:
        variants = {k: v for k, v in variants.items()
                    if k == "base" or k in only}
    libs = {}
    for name, subs in variants.items():
        try:
            libs[name] = ab_kernels.load(make_rows_variant(tree, name, subs),
                                         False)
        except RuntimeError as err:   # a variant that does not build
            print(f"{name}: does not build ({str(err)[-2000:]})")
    for kernel, line in ab_kernels.ptxas_lines(libs["base"].compiler_output):
        if "rows" in kernel:
            print(f"ptxas {kernel}: {line}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, x in rows_shapes(dev, sms).items():
        own = x["P"] != sms
        for name, lib in libs.items():
            if name != "base" and not own:
                continue
            ab_kernels.use(lib)
            try:
                ms = rows_pass_ms(PR, x)
            except RuntimeError as err:   # a refused launch
                print(f"{label} {name}: does not launch ({err})")
                continue
            print(f"{label} {name}: {ms:.4f} ms a pass")
            if name.startswith("phases"):
                print(f"{label} {name}: {rows_phases(lib, PR, x)}")
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
