"""Time the wavefront kernels of two builds of ``csrc/`` in one process on
a CUDA GPU, in turns (A, B, B, A), on the same inputs.

    python scripts/ab_kernels.py --a OLD_CSRC_DIR [--b NEW_CSRC_DIR]
        [--a-split] [--short-only | --pairhmm | --log | --scan | --rows]
        [--paths]

``--b`` defaults to the package's own ``csrc/``.  Each build goes into the
``_build`` directory beside its sources.  A build from before the cluster
kernels (K8/K9 for CONTRA, K12/K13 for Turner) is handed the ring scratch
its entry points take (``ring_g``, a global one past N = 256), and the
cluster kernels' and K1/K2's and K4/K5's outputs are compared on live cells
(i + d < n) only.
``--a-split`` says build A predates the merge of the stacked and long
kernels: its N <= 256 entry points take no ring scratch, and its N > 256
ones (if it has them) carry a ``_long`` suffix and take one.  Inputs and
shapes are chip_smoke.py's main-path ones: N = 128, B = 192 and N = 256,
B = 96 for the four kernels (K1/K2, K4/K5), and unless ``--short-only``
the long tier's (K8/K9 at N = 512, 1024, 2048; K12/K13 at 512, 1024).
Prints each kernel's CUDA-event ms per build and turn (REPS launches after
one warm-up), each build's ptxas register and spill lines, the largest
difference between the two builds' outputs (K1/K2, K4/K5 and the cluster
kernels on live cells) and whether they are bitwise equal, and each kernel's mean
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
sets (630 tRNA pairs at N = 128, 2,016 random pairs at N = 256), says
whether the two builds' outputs are bitwise equal, then times the Durbin
main paths (``AlignEngine``, chip_smoke.py's ``DURBIN_RUNS``) through each
build in the same turns, with their pairs/s and peak memory.
``--scan`` times the generic-N scan's kernels K20/K21 instead: ``--a`` is
the ``csrc`` of a checkout (e.g. ``git archive PARENT rna_algos_tpu_torch``
unpacked), driven by that checkout's own ``ops/fold_scan.py`` beside it
(its C entry points may differ from today's).  One pass of each kernel
(CUDA events, the mean of SCAN_REPS passes after a warm-up) per build in
turns A, B, B, A, at CONTRA and Turner N = 1536 B = 2 (exact) and N = 384
B = 8 (parity) on ``chip_smoke.scan_inputs``; each build's ptxas lines for
them; whether the two builds' state tables are bitwise equal on the live
cells; the bare grid barrier (``grid_barrier_probe``); then the generic
main paths (``FoldEngine``: Turner N = 1536 B = 5, CONTRA N = 2944 B = 2,
parity N = 384 B = 8 for both models, chip_smoke.py's batches) through
each build in the same turns, with their seqs/s (host clock around one
batch ending in the copy to the host, after a warm-up) and peak memory.
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
``--rows`` times the Durbin row scan K22 instead: ``--a`` is the ``csrc``
of a checkout, driven by that checkout's own ``ops/pairhmm_rows.py`` (its C
entry point may differ from today's).  A pass (a forward and a backward
launch, halved; CUDA events, the mean of ROWS_REPS after a warm-up) per
build in turns A, B, B, A at chip_smoke.py's K22 buckets (``ROWS_CHECK``:
the RNase P set's (384, 512) and (512, 384), the SSU set's commonest
bucket), whether the two builds' planes and corners are bitwise equal
there (exact), then the row scan's main paths (``AlignEngine``,
chip_smoke.py's ``ROWS_RUNS``) through each build in the same turns, with
their pairs/s (CUDA events around 3 calls after a warm-up, each ending in
the copy to the host) and peak memory.
``--mea`` times the gamma-centroid MEA fill K23 instead: ``--a`` is the
``csrc`` of a checkout, driven by that checkout's own ``ops/mea_fill.py``
(its C entry point may differ from today's).  The fills of the 18 gammas
(CUDA events, the mean of MEA_REPS calls after a warm-up) per build in
turns A, B, B, A at ``MEA_AB`` (chip_smoke.py's ``mea_inputs``; the
main-path shapes N = 128 R = 192 and N = 256 R = 96 as
``centroid_structures`` launches them, one launch a chunk of
``fill_chunks``), whether the two builds' fills are bitwise equal there,
each build's ptxas lines for K23, then the centroid CLI on the committed
tRNA set (``cli.centroid_fold -c``, host clock around one call after a
warm-up) through each build in the same turns, its files compared between
the builds.
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
# Entry points of earlier builds that today's library no longer has: K20
# and K21 one launch a span
LEGACY_SIGNATURES = {
    name: [ctypes.POINTER(_P), _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
           _P, _P] + [_I] * 7 + [_P]
    for name in ("rna_scan_inside", "rna_scan_outside")}
SCAN_REPS = 3
SCAN_SHAPES = (("contra", 1536, 2, "exact"), ("turner", 1536, 2, "exact"),
               ("contra", 384, 8, "parity"), ("turner", 384, 8, "parity"))
ROWS_REPS = 3
MEA_REPS = 3
# (bucket N, records R) of the K23 A/B
MEA_AB = ((96, 6), (256, 4), (384, 2), (128, 192), (256, 96), (512, 8),
          (1536, 1))
# K23's entry point before its redesign (no workspace, no plan)
MEA_LEGACY = [_P] * 3 + [_I] * 3 + [_P]
# K22's entry point before its redesign (no scratch, no cluster size)
ROWS_LEGACY = [_P] * 9 + [_I] * 5 + [_P]
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
        ringed = {k for k, m in decl.items() if m and "ring_g" in m.group(1)}
        sigs = {k: ring_signature(v) if k in ringed else v
                for k, v in {**LEGACY_SIGNATURES, **saved}.items()
                if f'"C" int {k}(' in text}
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
        rows_decl = re.search(r'"C" int rna_pairhmm_rows\(([^)]*)\)', text)
        if rows_decl and "scratch" not in rows_decl.group(1):
            sigs["rna_pairhmm_rows"] = ROWS_LEGACY
        mea_decl = re.search(r'"C" int rna_mea_fill\(([^)]*)\)', text)
        if mea_decl and "work" not in mea_decl.group(1):
            sigs["rna_mea_fill"] = MEA_LEGACY
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


def fold_scan_module(csrc):
    """The ``ops/fold_scan.py`` beside ``csrc`` (see ``tree_module``)."""
    return tree_module(csrc, "fold_scan")


def tree_module(csrc, stem):
    """The ``ops/<stem>.py`` beside ``csrc`` as a module of this package:
    its relative imports resolve here, and it launches through
    ``_build.library()`` (see ``use``)."""
    import importlib.util

    path = pathlib.Path(csrc).resolve().parent / "ops" / f"{stem}.py"
    name = f"rna_algos_tpu_torch.ops._{stem}_{abs(hash(str(path)))}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    ap.add_argument("--scan", action="store_true",
                    help="the generic-N scan's kernels K20/K21 instead")
    ap.add_argument("--rows", action="store_true",
                    help="the Durbin row scan K22 instead")
    ap.add_argument("--mea", action="store_true",
                    help="the gamma-centroid MEA fill K23 instead")
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
            if args.scan and "scan_" not in name:
                continue
            if args.rows and "rows" not in name:
                continue
            if args.mea and "mea" not in name:
                continue
            if not args.log or "_log_kernel" in name:
                print(f"  {k} ptxas: {name}: {line}")
    use(libs["B"])
    if args.scan:
        return ab_scan(libs, args, dev, chip_smoke)
    if args.rows:
        return ab_rows(libs, args, dev, chip_smoke)
    if args.mea:
        return ab_mea(libs, args, dev, chip_smoke)
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
            # a build before the cluster kernels, or before K1/K2's or
            # K4/K5's redesign, computes the dead cells too
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


GRID_SPANS = 2000
GRID_BARRIER_PROBE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(512, 2) probe(int spans, int* sink) {
  cg::grid_group grid = cg::this_grid();
  int acc = 0;
  for (int d = 0; d < spans; ++d) {
    acc += d ^ threadIdx.x;
    grid.sync();
  }
  if (acc == -1) sink[0] = acc;
}

extern "C" int probe_launch(int blocks, int spans, int* sink, void* stream) {
  void* args[] = {&spans, &sink};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)probe, dim3(blocks), dim3(512), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int probe_blocks(int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe, 512,
                                                        0);
  *out = per_sm * sms;
  return (int)err;
}
"""


def grid_barrier_probe(chip_smoke):
    """The bare grid barrier of a cooperative launch, alone: blocks of 512
    threads at the occupancy limit (and at one and at 132 blocks), looping
    over GRID_SPANS spans with one ``grid.sync()`` a span and nothing
    else; the ms of one launch (CUDA events, 5 launches after a warm-up)
    and the microseconds a span."""
    from rna_algos_tpu_torch.ops import _build

    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        src, so = pathlib.Path(tmp, "grid.cu"), pathlib.Path(tmp, "grid.so")
        src.write_text(GRID_BARRIER_PROBE)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:6], "-shared",
                        "-o", str(so), str(src)], check=True)
        lib = ctypes.CDLL(str(so))
        lib.probe_launch.argtypes = [_I, _I, _P, _P]
        lib.probe_blocks.argtypes = [_P]
        most = ctypes.c_int(0)
        if lib.probe_blocks(ctypes.byref(most)):
            raise RuntimeError("grid barrier probe: occupancy query failed")
        for blocks in sorted({1, 132, most.value}):
            def launch():
                err = lib.probe_launch(blocks, GRID_SPANS, sink.data_ptr(),
                                       stream)
                if err:
                    raise RuntimeError(f"grid barrier probe: CUDA error "
                                       f"{err}")

            ms = chip_smoke.cuda_ms(launch, 5)
            print(f"grid barrier: {blocks} blocks of 512 threads (occupancy "
                  f"limit {most.value}): {ms:.4f} ms for {GRID_SPANS} spans, "
                  f"{1e3 * ms / GRID_SPANS:.4f} us a span")


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


def ab_scan(libs, args, dev, chip_smoke):
    """K20 and K21 of the two builds in turns A, B, B, A (each build's own
    ops/fold_scan.py), whether their state tables are bitwise equal on the
    live cells, the bare grid barrier, then the generic main paths."""
    from rna_algos_tpu_torch.ops import fold_scan

    mods = {"A": fold_scan_module(args.a), "B": fold_scan}
    outs, times = {}, {}
    for model, N, B, mode in SCAN_SHAPES:
        x = chip_smoke.scan_inputs(model, N, B, seed=N + B, device=dev)
        a = (x["seqs"], x["ns"], x["tbl"], x["pre"])
        key = f"{model} N={N} B={B} {mode}"
        for turn, which in enumerate(("A", "B", "B", "A")):
            use(libs[which])
            FS = mods[which]
            ins = FS.scan_inside(*a, x["contra"], False, mode)
            out = FS.scan_outside(*a, ins, x["contra"], False, mode)
            outs.setdefault(key, {})[which] = (ins, out)
            for kernel, fn in (
                    ("K20", lambda: FS.scan_inside(*a, x["contra"], False,
                                                   mode)),
                    ("K21", lambda: FS.scan_outside(*a, ins, x["contra"],
                                                    False, mode))):
                ms = chip_smoke.cuda_ms(fn, SCAN_REPS)
                times.setdefault((key, kernel), {}).setdefault(
                    which, []).append(ms)
                print(f"turn {turn} build {which} {key} {kernel}: {ms:.4f} "
                      "ms a pass")
        same = {}
        for kernel, k in (("K20", 0), ("K21", 1)):
            ta, tb = outs[key]["A"][k], outs[key]["B"][k]
            same[kernel] = all(
                torch.equal(ta[s][live].view(torch.int32),
                            tb[s][live].view(torch.int32))
                for s in chip_smoke.SCAN_STATE[
                    "scan_inside" if k == 0 else "scan_outside"]
                if s != "qrmmb" or x["contra"]
                for live in [chip_smoke.scan_live(x["ns"], N,
                                                  s.startswith("q"))])
            print(f"{key} {kernel}: state tables of A and B bitwise equal "
                  f"on the live cells: {same[kernel]}")
        del x, outs[key]
        torch.cuda.empty_cache()
    for (key, kernel), ms in times.items():
        a_ms, b_ms = (sum(ms[k]) / len(ms[k]) for k in ("A", "B"))
        print(f"mean {key} {kernel}: A {a_ms:.4f} ms, B {b_ms:.4f} ms, "
              f"A / B {a_ms / b_ms:.4f}")
    grid_barrier_probe(chip_smoke)
    ab_scan_paths(libs, mods, chip_smoke)
    return 0


def ab_rows(libs, args, dev, chip_smoke):
    """K22 of the two builds in turns A, B, B, A (each build's own
    ops/pairhmm_rows.py), whether their planes and corners are bitwise
    equal, then the row scan's main paths through each build."""
    from rna_algos_tpu_torch.ops import pairhmm_rows
    from rna_algos_tpu_torch.utils.io import read_fasta

    mods = {"A": tree_module(args.a, "pairhmm_rows"), "B": pairhmm_rows}
    trnas = [r.seq for r in read_fasta(ROOT / "assets" / "sampled_trnas.fa")]
    rsets = chip_smoke.rows_sets(trnas)
    times, same = {}, {}
    for name, key in chip_smoke.ROWS_CHECK:
        seqs, pairs = rsets[name]
        groups = chip_smoke.rows_buckets(seqs, pairs)
        if key is None:
            key = max(groups, key=lambda g: len(groups[g]))
        x = chip_smoke.rows_inputs(seqs, groups[key], key, dev)
        label = f"{name.split('_')[0]}_N{key[0]}x{key[1]}_P{x['P']}"
        outs = {}
        for turn, which in enumerate(("A", "B", "B", "A")):
            use(libs[which])
            calls = [lambda b=b: mods[which]._rows_cuda(
                x["x1"], x["x2"], x["n1"], x["n2"], x["ms"], x["ins"],
                x["scal"][b], b, "exact") for b in (0, 1)]
            ms = chip_smoke.cuda_ms(lambda: [c() for c in calls],
                                    ROWS_REPS) / 2
            outs[which] = [t for c in calls for t in c()]
            times.setdefault(label, {}).setdefault(which, []).append(ms)
            print(f"turn {turn} build {which} {label} K22: {ms:.4f} ms a "
                  "pass")
        same[label] = all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(outs["A"], outs["B"]))
        print(f"{label} K22: planes and corners of A and B bitwise equal: "
              f"{same[label]}")
        del x, outs
        torch.cuda.empty_cache()
    for label, ms in times.items():
        a_ms, b_ms = (sum(ms[k]) / len(ms[k]) for k in ("A", "B"))
        print(f"mean {label} K22: A {a_ms:.4f} ms, B {b_ms:.4f} ms, A / B "
              f"{a_ms / b_ms:.4f}")
    ab_rows_paths(libs, mods, chip_smoke, rsets)
    return 0 if all(same.values()) else 1


def ab_mea(libs, args, dev, chip_smoke):
    """K23 of the two builds in turns A, B, B, A (each build's own
    ops/mea_fill.py) at MEA_AB, whether their fills are bitwise equal, then
    the centroid CLI through each build."""
    from rna_algos_tpu_torch.models.centroid import (DEFAULT_GAMMAS,
                                                     fill_chunks)
    from rna_algos_tpu_torch.ops import mea_fill

    mods = {"A": tree_module(args.a, "mea_fill"), "B": mea_fill}
    G = len(DEFAULT_GAMMAS)
    times, same = {}, {}
    for N, R in MEA_AB:
        x = chip_smoke.mea_inputs(N, R, seed=N + R, device=dev)
        chunks = fill_chunks(R, G, N)
        label = f"N{N}_R{R}" + (f" in {len(chunks)} launches"
                                if len(chunks) > 1 else "")
        outs = {}
        for turn, which in enumerate(("A", "B", "B", "A")):
            use(libs[which])
            MF = mods[which]

            def fill():
                return [MF.mea_fill_batch(x[c0:c1], DEFAULT_GAMMAS)
                        for c0, c1 in chunks]

            ms = chip_smoke.cuda_ms(fill, MEA_REPS)
            outs[which] = fill()
            times.setdefault(label, {}).setdefault(which, []).append(ms)
            print(f"turn {turn} build {which} {label} K23: {ms:.4f} ms")
        same[label] = all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(outs["A"], outs["B"]))
        bms, by = chip_smoke.mea_bound(R, G, N)
        first = chunks[0][1] - chunks[0][0]
        use(libs["B"])
        print(f"{label} K23: fills of A and B bitwise equal: "
              f"{same[label]}; plan of B {mea_fill.plan(first, G, N)} for a "
              f"launch of {first} records; bound {bms:.4f} ms ({by})")
        del x, outs
        torch.cuda.empty_cache()
    for label, ms in times.items():
        a_ms, b_ms = (sum(ms[k]) / len(ms[k]) for k in ("A", "B"))
        N, R = (int(v[1:]) for v in label.split()[0].split("_"))
        bms, _ = chip_smoke.mea_bound(R, G, N)
        print(f"mean {label} K23: A {a_ms:.4f} ms (share {bms / a_ms:.4f}), "
              f"B {b_ms:.4f} ms (share {bms / b_ms:.4f}), A / B "
              f"{a_ms / b_ms:.4f}")
    same["cli"] = ab_mea_cli(libs, mods)
    return 0 if all(same.values()) else 1


def ab_mea_cli(libs, mods):
    """``cli.centroid_fold -c`` on the committed tRNA set through each
    build in turns A, B, B, A (host clock around one call after a warm-up,
    the fold included); whether the builds wrote the same files."""
    import tempfile
    import time

    from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
    from rna_algos_tpu_torch.models import centroid as TC

    fasta = str(ROOT / "assets" / "sampled_trnas.fa")
    saved, files = TC.MF, {}
    try:
        for turn, which in enumerate(("A", "B", "B", "A")):
            use(libs[which])
            TC.MF = mods[which]
            with tempfile.TemporaryDirectory() as tmp:
                cf_cli.main(["-i", fasta, "-o", tmp, "-c"])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cf_cli.main(["-i", fasta, "-o", tmp, "-c"])
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                files[which] = {p.name: p.read_bytes()
                                for p in sorted(pathlib.Path(tmp).iterdir())}
            print(f"turn {turn} build {which} centroid CLI -c, tRNA set: "
                  f"{s:.4f} s a call")
    finally:
        TC.MF = saved
    same = files["A"] == files["B"]
    print(f"centroid CLI -c: files of A and B identical: {same}")
    return same


def ab_rows_paths(libs, mods, chip_smoke, rsets):
    """The row scan's main paths of chip_smoke.py (``AlignEngine`` on
    ``ROWS_RUNS``) through each build in turns A, B, B, A: pairs/s (CUDA
    events around 3 calls after a warm-up) and the peak device memory of
    one call above what was held before it."""
    from rna_algos_tpu_torch.ops import pairhmm_rows
    from rna_algos_tpu_torch.parallel.runner import AlignEngine

    saved = pairhmm_rows._rows_cuda
    fns = {"A": mods["A"]._rows_cuda, "B": saved}
    try:
        for turn, which in enumerate(("A", "B", "B", "A")):
            use(libs[which])
            pairhmm_rows._rows_cuda = fns[which]
            for path, mode, key in chip_smoke.ROWS_RUNS:
                seqs, pairs = rsets[key]
                engine = AlignEngine(device="cuda", numerics=mode)
                ms = chip_smoke.cuda_ms(
                    lambda: engine.match_probs_pairs(seqs, pairs), 3)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                engine.match_probs_pairs(seqs, pairs)
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                print(f"turn {turn} build {which} {path}_{key}: {ms:.4f} ms "
                      f"a call, {1e3 * len(pairs) / ms:.2f} pairs/s, peak "
                      f"{peak:.3f} GiB above {held / 2**30:.3f}")
    finally:
        pairhmm_rows._rows_cuda = saved


def ab_scan_paths(libs, mods, chip_smoke):
    """The generic main paths of chip_smoke.py (``FoldEngine``: Turner
    exact N = 1536 B = 5 with seq_1536, CONTRA exact N = 2944 B = 2,
    parity N = 384 B = 8 both models) through each build in turns A, B, B,
    A: seqs/s (host clock around one batch that ends in the copy to the
    host, after a warm-up) and the peak device memory of that batch above
    what was held before it."""
    import time

    import numpy as np

    from rna_algos_tpu_torch.models import mccaskill as M
    from rna_algos_tpu_torch.parallel.runner import FoldEngine

    g = np.load(ROOT / "tests" / "golden" / "longn_f64_1536.npz")
    runs = {"turner_scan_N1536_B5": (False, "exact", [
        [int(b) for b in g["seq_1536"]]] + chip_smoke.random_batch(
            *chip_smoke.SCAN_TURNER[:3], seed=chip_smoke.SCAN_TURNER[3])),
        "contra_scan_N2944_B2": (True, "exact", chip_smoke.random_batch(
            *chip_smoke.SCAN_CONTRA[:3], seed=chip_smoke.SCAN_CONTRA[3]))}
    for model in ("contra", "turner"):
        runs[f"{model}_parity_scan_N384_B8"] = (
            model == "contra", "parity", chip_smoke.random_batch(
                *chip_smoke.SCAN_PARITY[:3], seed=chip_smoke.SCAN_PARITY[3]))
    saved = M.FS
    try:
        for turn, which in enumerate(("A", "B", "B", "A")):
            use(libs[which])
            M.FS = mods[which]
            for label, (contra, mode, seqs) in runs.items():
                engine = FoldEngine(uses_contra_model=contra, device="cuda",
                                    numerics=mode)
                engine.fold_batch(seqs)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                engine.fold_batch(seqs)
                wall = time.perf_counter() - t0
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                print(f"turn {turn} build {which} {label}: "
                      f"{len(seqs) / wall:.4f} seqs/s ({wall:.4f} s a "
                      f"batch), peak {peak:.3f} GiB above "
                      f"{held / 2**30:.3f}")
    finally:
        M.FS = saved


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
    ab_durbin_paths(libs, chip_smoke, trnas)
    return 0


def ab_durbin_paths(libs, chip_smoke, trnas):
    """The Durbin main paths of chip_smoke.py (``AlignEngine``, exact on
    both sets, parity on the tRNA set) through each build in turns A, B,
    B, A: pairs/s (CUDA events around 3 calls after a warm-up, each call
    ending in the copy to the host) and the peak device memory of one call
    above what was held before it."""
    from rna_algos_tpu_torch.parallel.runner import AlignEngine

    dsets = chip_smoke.durbin_sets(trnas)
    for turn, which in enumerate(("A", "B", "B", "A")):
        use(libs[which])
        for path, mode, key in chip_smoke.DURBIN_RUNS:
            seqs, pairs = dsets[key]
            engine = AlignEngine(device="cuda", numerics=mode)
            ms = chip_smoke.cuda_ms(
                lambda: engine.match_probs_pairs(seqs, pairs), 3)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            engine.match_probs_pairs(seqs, pairs)
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            print(f"turn {turn} build {which} {path}_{key}: {ms:.4f} ms a "
                  f"call, {1e3 * len(pairs) / ms:.2f} pairs/s, peak "
                  f"{peak:.3f} GiB above {held / 2**30:.3f}")


if __name__ == "__main__":
    sys.exit(main())
