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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_probes: no CUDA GPU available", file=sys.stderr)
        return 2
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


if __name__ == "__main__":
    sys.exit(main())
