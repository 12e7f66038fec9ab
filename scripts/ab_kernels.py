"""Time the wavefront kernels of two builds of ``csrc/`` in one process on
a CUDA GPU, in turns (A, B, B, A), on the same inputs.

    python scripts/ab_kernels.py --a OLD_CSRC_DIR [--b NEW_CSRC_DIR]
        [--a-split] [--short-only | --pairhmm | --log] [--paths]

``--b`` defaults to the package's own ``csrc/``.  Each build goes into the
``_build`` directory beside its sources.  A build from before the cluster
kernels (K8/K9 for CONTRA, K12/K13 for Turner) is handed the ring scratch
its entry points take (``ring_g``, a global one past N = 256), and the
cluster kernels' and K1/K2's outputs are compared on live cells (i + d < n)
only.
``--a-split`` says build A predates the merge of the stacked and long
kernels: its N <= 256 entry points take no ring scratch, and its N > 256
ones (if it has them) carry a ``_long`` suffix and take one.  Inputs and
shapes are chip_smoke.py's main-path ones: N = 128, B = 192 and N = 256,
B = 96 for the four kernels (K1/K2, K4/K5), and unless ``--short-only``
the long tier's (K8/K9 at N = 512, 1024, 2048; K12/K13 at 512, 1024).
Prints each kernel's CUDA-event ms per build and turn (REPS launches after
one warm-up), each build's ptxas register and spill lines, the largest
difference between the two builds' outputs (K1/K2 and the cluster kernels
on live cells) and whether they are bitwise equal, and each kernel's mean
ms per build over its two turns with the ratio A / B.  ``--paths`` then
times the exact main paths (``FoldEngine``, both models, chip_smoke.py's
tRNA and random 150-200 nt batches) through each build in turns A, B, B, A,
with their seqs/s and peak memory, as ``--log`` does for the parity
paths.
With the long tier it then times the barriers that end each span of the
cluster kernels, alone: a probe kernel (built with nvcc into a temporary
directory) runs B clusters of C blocks of 1,024 threads at each long
launch shape of chip_smoke.py (C that model's), each block looping over
2,000 spans with one ``__syncthreads()`` and one cluster ``sync()`` a span
and nothing else.
``--pairhmm`` times the Durbin pair-HMM kernels K14 and K15 instead (a
forward and a backward launch per timed call) on chip_smoke.py's two Durbin
sets (630 tRNA pairs at N = 128, 2,016 random pairs at N = 256).
``--log`` times the parity tier's log-space kernels K16-K19 instead, on
chip_smoke.py's log inputs (``log_inputs``: the arguments one parity fold
hands its kernels) at N = 128, B = 192 and N = 256, B = 96, prints each
build's registers, spills and stack frame for them, and whether the two
builds' outputs are bitwise equal (K16/K18 on the live cells, i + d < n:
a build before their redesign computes the dead ones too); then it times
the parity main paths (``FoldEngine(numerics="parity")``, both models,
chip_smoke.py's tRNA and random 150-200 nt batches) through each build in
the same turns, with their seqs/s and peak memory.  A build whose K17/K19
entry points take the separate pm and pm2 scratches of before is handed
them; one whose K18 entry point takes no (ext, one) scratch is not handed
it (K16's two scratches fit the rm and rmmb histories it took before).
Entry points a build does not define are not bound.  Needs a GPU.
"""

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = {128: 10, 256: 10, 512: 3, 1024: 3, 2048: 3}
WAVEFRONT = ("rna_contra_inside", "rna_contra_outside", "rna_turner_inside",
             "rna_turner_outside")
_P, _I = ctypes.c_void_p, ctypes.c_int
# Ring rows a sequence of an older build's ring scratch: CONTRA's window
# ring, Turner's three 32-slot rings and its 8-slot ring.
RING_ROWS = {"rna_contra_inside": 32, "rna_contra_outside": 32,
             "rna_turner_inside": 104, "rna_turner_outside": 104}


def ring_signature(sig):
    """An entry point's argument types with the ring scratch (a pointer)
    before B, the first int."""
    k = sig.index(_I)
    return [*sig[:k], _P, *sig[k:]]


def with_ring(name, args):
    """The arguments of a wavefront entry point with its ring scratch
    inserted before B: (B, rows, N + 33) floats past N = 256, empty
    below."""
    k = next(j for j, a in enumerate(args) if isinstance(a, int))
    B, N = args[k], args[k + 1]
    ring = torch.empty((B, RING_ROWS[name], N + 33) if N > 256 else (0,),
                       device="cuda")
    return (*args[:k], ctypes.c_void_p(ring.data_ptr()), *args[k:])


class RingBuild:
    """A build whose wavefront entry points in ``ringed`` take a ring
    scratch (from before the cluster kernels), called with today's
    arguments."""

    def __init__(self, lib, ringed):
        self.lib = lib
        self.ringed = ringed
        self.path = lib.path
        self.compiler_output = lib.compiler_output

    def call(self, name, *args):
        if name in self.ringed:
            args = with_ring(name, args)
        return self.lib.call(name, *args)


LOG_OUTSIDE = ("rna_contra_outside_log", "rna_turner_outside_log")


class PmBuild:
    """A build whose K17/K19 entry points take g, pm, pm2 and qmb (B, N, N)
    scratches, called with today's g, (pm2, pm) and qmb."""

    def __init__(self, lib):
        self.lib = lib
        self.path = lib.path
        self.compiler_output = lib.compiler_output

    def call(self, name, *args):
        if name in LOG_OUTSIDE:
            k = next(j for j, a in enumerate(args) if isinstance(a, int))
            B, N = args[k], args[k + 1]
            pm, pm2 = (torch.empty((B, N, N), device="cuda")
                       for _ in range(2))
            self._keep = (pm, pm2)
            args = (*args[:k - 2], ctypes.c_void_p(pm.data_ptr()),
                    ctypes.c_void_p(pm2.data_ptr()), *args[k - 1:])
        return self.lib.call(name, *args)


class NoEoBuild:
    """A build whose K18 entry point takes no (ext, one) scratch (from
    before K16/K18's redesign), called with today's arguments."""

    def __init__(self, lib):
        self.lib = lib
        self.path = lib.path
        self.compiler_output = lib.compiler_output

    def call(self, name, *args):
        if name == "rna_turner_inside_log":
            k = next(j for j, a in enumerate(args) if isinstance(a, int))
            args = (*args[:k - 1], *args[k:])
        return self.lib.call(name, *args)


class SplitBuild(RingBuild):
    """A build from before the merge, called with the merged entry points'
    arguments: past N = 256 the ``_long`` entry point is called, with its
    ring scratch; below it the entry point itself, which takes none."""

    def call(self, name, *args):
        if name in WAVEFRONT:
            k = next(j for j, a in enumerate(args) if isinstance(a, int))
            if args[k + 1] > 256:
                args = with_ring(name, args)
                name += "_long"
        return self.lib.call(name, *args)


def load(csrc, split):
    """Build (if needed) and load the library of ``csrc``."""
    from rna_algos_tpu_torch.ops import _build

    csrc = pathlib.Path(csrc).resolve()
    _build.CSRC_DIR = csrc
    _build.BUILD_DIR = csrc.parent / "_build"
    _build.library.cache_clear()
    saved = _build.SIGNATURES
    text = "".join(p.read_text() for p in csrc.glob("*.cu"))
    if split:
        sigs = {k: saved[k] for k in ("rna_skew", *WAVEFRONT)}
        if (csrc / "contra_inside_long.cu").exists():
            sigs.update({k + "_long": ring_signature(saved[k])
                         for k in WAVEFRONT})
        ringed = set()
    else:
        decl = {k: re.search(rf'"C" int {k}\(([^)]*)\)', text)
                for k in WAVEFRONT}
        ringed = {k for k, m in decl.items() if "ring_g" in m.group(1)}
        sigs = {k: ring_signature(v) if k in ringed else v
                for k, v in saved.items() if f'"C" int {k}(' in text}
        log_decl = re.search(r'"C" int rna_contra_outside_log\(([^)]*)\)',
                             text)
        pm_split = bool(log_decl) and "pm2" in log_decl.group(1)
        if pm_split:
            sigs.update({k: [*saved[k][:13], _P, *saved[k][13:]]
                         for k in LOG_OUTSIDE})
        k18 = "rna_turner_inside_log"
        k18_decl = re.search(rf'"C" int {k18}\(([^)]*)\)', text)
        no_eo = bool(k18_decl) and not re.search(r"\beo\b",
                                                  k18_decl.group(1))
        if no_eo:
            sigs[k18] = [*saved[k18][:9], *saved[k18][10:]]
    _build.SIGNATURES = sigs
    try:
        lib = _build.library()
    finally:
        _build.SIGNATURES = saved
    if split:
        return SplitBuild(lib, ringed)
    if pm_split:
        lib = PmBuild(lib)
    if no_eo:
        lib = NoEoBuild(lib)
    return RingBuild(lib, ringed) if ringed else lib


def use(lib):
    """Make the wrappers launch through ``lib`` (after every ``load``)."""
    from rna_algos_tpu_torch.ops import _build

    _build.library = lambda: lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="csrc directory of build A")
    ap.add_argument("--b", default=str(ROOT / "rna_algos_tpu_torch" / "csrc"),
                    help="csrc directory of build B (default: the package's)")
    ap.add_argument("--a-split", action="store_true",
                    help="build A predates the stacked/long merge")
    ap.add_argument("--short-only", action="store_true",
                    help="only N = 128 and 256")
    ap.add_argument("--pairhmm", action="store_true",
                    help="the Durbin pair-HMM kernels K14 and K15 instead")
    ap.add_argument("--log", action="store_true",
                    help="the parity tier's kernels K16-K19 instead")
    ap.add_argument("--paths", action="store_true",
                    help="then the exact main paths through each build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    libs = {"A": load(args.a, args.a_split), "B": load(args.b, False)}
    for k, lib in libs.items():
        print(f"build {k}: {lib.path}")
        for name, line in ptxas_lines(lib.compiler_output):
            if not args.log or "_log_kernel" in name:
                print(f"  {k} ptxas: {name}: {line}")
    use(libs["B"])
    if args.pairhmm:
        return ab_pairhmm(libs, dev, chip_smoke)
    if args.log:
        return ab_log(libs, dev, chip_smoke)
    cases = []   # (N, B, inputs)
    for N, B in chip_smoke.SHAPES_MAIN:
        cases.append((N, B, chip_smoke.kernel_inputs(N, B, seed=7 * N,
                                                     device=dev)))
        cases.append((N, B, chip_smoke.turner_inputs(N, B, seed=7 * N + 1,
                                                     device=dev)))
    if not args.short_only:
        builders = {"contra": chip_smoke.kernel_inputs,
                    "turner": chip_smoke.turner_inputs}
        for model, shapes in chip_smoke.LONG_MAIN.items():
            for N, B in shapes:
                cases.append((N, B, builders[model](N, B, seed=7 * N,
                                                    device=dev)))
    outs, times = {}, {}
    for turn, which in enumerate(("A", "B", "B", "A")):
        use(libs[which])
        for N, B, x in cases:
            for kernel, a in zip(x["kernels"],
                                 (x["inside_args"], x["outside_args"])):
                fn = chip_smoke.wrappers(kernel)[0]
                ms = chip_smoke.cuda_ms(lambda: fn(*a), REPS[N])
                out = fn(*a)
                outs.setdefault((N, B, kernel), {})[which] = (
                    out if isinstance(out, tuple) else (out,))
                times.setdefault((N, B, kernel), {}).setdefault(
                    which, []).append(ms)
                print(f"turn {turn} build {which} N={N} B={B} {kernel}: "
                      f"{ms:.4f} ms")
    for (N, B, kernel), got in outs.items():
        a, b, note = got["A"], got["B"], ""
        if kernel in chip_smoke.LIVE_ONLY:
            # a build before the cluster kernels, or before K1/K2's
            # redesign, computes the dead cells too
            x = next(c for n_, b_, c in cases
                     if (n_, b_) == (N, B) and kernel in c["kernels"])
            r = torch.arange(N, device=dev)
            live = ((r[None, :, None] + r[None, None, :])
                    < x["ns"].view(-1, 1, 1))
            a, b = [t[live] for t in a], [t[live] for t in b]
            note = " on live cells"
        rel = max(float(((x - y).abs() / y.abs().clamp(min=1e-30)).max())
                  for x, y in zip(a, b))
        diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))
        print(f"N={N} B={B} {kernel}: max |A - B| {diff:.3e}, max "
              f"relative {rel:.3e}{note}{' (bitwise equal)' if same else ''}")
    for (N, B, kernel), ms in times.items():
        a, b = (sum(ms[k]) / len(ms[k]) for k in ("A", "B"))
        print(f"mean N={N} B={B} {kernel}: A {a:.4f} ms, B {b:.4f} ms, "
              f"A / B {a / b:.4f}")
    if not args.short_only:
        use(libs["B"])
        barrier_probe(chip_smoke)
    if args.paths:
        ab_main_paths(libs, "exact")
    return 0


BARRIER_SPANS = 2000
BARRIER_PROBE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(1024) probe(int spans, int* sink) {
  cg::cluster_group cluster = cg::this_cluster();
  int acc = 0;
  for (int d = 0; d < spans; ++d) {
    acc += d ^ threadIdx.x;
    __syncthreads();
    cluster.sync();
  }
  if (acc == -1) sink[0] = acc;
}

extern "C" int probe_launch(int B, int C, int spans, int* sink,
                            void* stream) {
  cudaError_t err = cudaSuccess;
  if (C > 8)
    err = cudaFuncSetAttribute(
        probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(1024);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, probe, spans, sink);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


def barrier_probe(chip_smoke):
    """The barriers that end each span of the cluster kernels, alone: per
    long launch shape (N, B) of each model and its inside kernel's cluster
    size C (K8's or K12's), the ms of one probe launch
    of BARRIER_SPANS spans (CUDA events, 5 launches after a warm-up) and
    the microseconds a span."""
    from rna_algos_tpu_torch.ops import _build
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL

    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    shapes = [(model, N, B) for model in ("contra", "turner")
              for N, B in sorted(set(chip_smoke.LONG_MAIN[model])
                                 | set(chip_smoke.LONG_CHECK[model]))]
    with tempfile.TemporaryDirectory() as tmp:
        src, so = pathlib.Path(tmp, "probe.cu"), pathlib.Path(tmp, "probe.so")
        src.write_text(BARRIER_PROBE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:6], "-shared",
                        "-o", str(so), str(src)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.probe_launch.argtypes = [_I] * 3 + [_P] * 2
        for model, N, B in shapes:
            C = getattr(PL, f"{model}_cluster_sizes")(B, N)[0]

            def launch():
                err = lib.probe_launch(B, C, BARRIER_SPANS, sink.data_ptr(),
                                       stream)
                if err:
                    raise RuntimeError(f"barrier probe: CUDA error {err}")

            ms = chip_smoke.cuda_ms(launch, 5)
            print(f"barrier {model} N={N} B={B} C={C}: {ms:.4f} ms for "
                  f"{BARRIER_SPANS} spans, {1e3 * ms / BARRIER_SPANS:.4f} us "
                  "a span (cluster barrier + block barrier)")


def ptxas_lines(output):
    """(kernel, line) for each ptxas line on registers, spills or stack
    frame in a build's compiler output."""
    name = ""
    for line in output.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
        elif "registers" in line or "spill" in line or "stack" in line:
            yield name, line.strip()


def ab_log(libs, dev, chip_smoke):
    """K16-K19 of the two builds in turns A, B, B, A on the parity path's
    arguments (3 launches after a warm-up each), and whether their outputs
    are bitwise equal."""
    cases = []
    for N, B in chip_smoke.SHAPES_MAIN:
        for model in ("contra", "turner"):
            cases.append((N, B, chip_smoke.log_inputs(
                model, N, B, seed=11 * N + len(model), device=dev)))
        print(f"N={N} B={B}: {chip_smoke.log_groups(N)}")
    outs = {}
    for turn, which in enumerate(("A", "B", "B", "A")):
        use(libs[which])
        for N, B, x in cases:
            for kernel, a in zip(x["kernels"],
                                 (x["inside_args"], x["outside_args"])):
                fn = chip_smoke.wrappers(kernel)[0]
                ms = chip_smoke.cuda_ms(lambda: fn(*a), 3)
                out = fn(*a)
                outs.setdefault((N, B, kernel), {})[which] = (
                    out if isinstance(out, tuple) else (out,))
                print(f"turn {turn} build {which} N={N} B={B} {kernel}: "
                      f"{ms:.4f} ms")
    for (N, B, kernel), got in outs.items():
        a, b, note = got["A"], got["B"], ""
        if kernel.endswith("_inside_log"):
            x = next(c for n_, b_, c in cases
                     if (n_, b_) == (N, B) and kernel in c["kernels"])
            live = chip_smoke.log_live(x, a[0])
            a, b = [t[live] for t in a], [t[live] for t in b]
            note = " on live cells"
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))
        print(f"N={N} B={B} {kernel}: outputs of A and B bitwise equal"
              f"{note}: {same}")
    ab_main_paths(libs, "parity")
    return 0


def ab_main_paths(libs, numerics):
    """The main paths of chip_smoke.py in ``numerics`` (FoldEngine, both
    models, on the tRNA and the random 150-200 nt batches) through each
    build in turns A, B, B, A: seqs/s (CUDA events around 3 batches after a
    warm-up, chip_smoke.cuda_ms) and the peak device memory of one batch
    above what was held before it."""
    import chip_smoke
    from rna_algos_tpu_torch.parallel.runner import FoldEngine
    from rna_algos_tpu_torch.utils.io import read_fasta

    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    batches = {"trna_N128_B192": trnas * 32,
               "rfam_N256_B96": chip_smoke.random_batch(96, 150, 200,
                                                        seed=2024)}
    for turn, which in enumerate(("A", "B", "B", "A")):
        use(libs[which])
        for model in ("contra", "turner"):
            engine = FoldEngine(uses_contra_model=model == "contra",
                                device="cuda", numerics=numerics)
            for key, seqs in batches.items():
                ms = chip_smoke.cuda_ms(lambda: engine.fold_batch(seqs), 3)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                engine.fold_batch(seqs)
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                print(f"turn {turn} build {which} {model}_{numerics}_{key}: "
                      f"{ms:.4f} ms a batch, {1e3 * len(seqs) / ms:.2f} "
                      f"seqs/s, peak {peak:.3f} GiB above {held / 2**30:.3f}")


def ab_pairhmm(libs, dev, chip_smoke):
    """K14 and K15 of the two builds in turns A, B, B, A on the Durbin sets
    (10 timed calls of a forward and a backward launch each), and the
    largest difference between their outputs."""
    from rna_algos_tpu_torch.utils.io import read_fasta

    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    sets = {key: chip_smoke.durbin_inputs(seqs, pairs, dev)
            for key, (seqs, pairs) in chip_smoke.durbin_sets(trnas).items()}
    outs = {}
    for turn, which in enumerate(("A", "B", "B", "A")):
        use(libs[which])
        for key, x in sets.items():
            for kernel in ("pairhmm_prob", "pairhmm_log"):
                fn = chip_smoke.pairhmm_wrappers(kernel)[0]
                calls = chip_smoke.pairhmm_calls(kernel, x, fn)
                ms = chip_smoke.cuda_ms(lambda: [c() for c in calls], 10) / 2
                outs.setdefault((key, kernel), {})[which] = [
                    t for c in calls for t in c()]
                print(f"turn {turn} build {which} {key} {kernel}: "
                      f"{ms:.4f} ms per launch")
    for (key, kernel), got in outs.items():
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got["A"], got["B"]))
        print(f"{key} {kernel}: outputs of A and B bitwise equal: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
