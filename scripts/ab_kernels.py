"""Time the wavefront kernels of two builds of ``csrc/`` in one process on
a CUDA GPU, in turns (A, B, B, A), on the same inputs.

    python scripts/ab_kernels.py --a OLD_CSRC_DIR [--b NEW_CSRC_DIR]
        [--a-split] [--short-only | --pairhmm]

``--b`` defaults to the package's own ``csrc/``.  Each build goes into the
``_build`` directory beside its sources.  ``--a-split`` says build A
predates the merge of the stacked and long kernels: its N <= 256 entry
points take no ring scratch, and its N > 256 ones (if it has them) carry a
``_long`` suffix.  Inputs and shapes are chip_smoke.py's main-path ones:
N = 128, B = 192 and N = 256, B = 96 for the four kernels (K1/K2, K4/K5),
and unless ``--short-only`` the long tier's (K8/K9 at N = 512, 1024, 2048;
K12/K13 at 512, 1024).  Prints each kernel's CUDA-event ms per build and
turn (REPS launches after one warm-up), each build's ptxas register and
spill lines, and the largest difference between the two builds' outputs.
``--pairhmm`` times the Durbin pair-HMM kernels K14 and K15 instead (a
forward and a backward launch per timed call) on chip_smoke.py's two Durbin
sets (630 tRNA pairs at N = 128, 2,016 random pairs at N = 256).  Entry
points a build does not define are not bound.  Needs a GPU.
"""

import argparse
import ctypes
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = {128: 10, 256: 10, 512: 3, 1024: 3, 2048: 3}
WAVEFRONT = ("rna_contra_inside", "rna_contra_outside", "rna_turner_inside",
             "rna_turner_outside")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the entry points of a build from before the merge
SPLIT_SIGNATURES = {
    "rna_contra_inside": [_P] * 17 + [_I, _I, _P],
    "rna_contra_outside": [_P] * 20 + [_I, _I, _I, _P],
    "rna_turner_inside": [ctypes.POINTER(_P)] + [_P] * 8 + [_I, _I, _P],
    "rna_turner_outside": [ctypes.POINTER(_P)] + [_P] * 10 + [_I, _I, _I, _P],
}


class SplitBuild:
    """A build from before the merge, called with the merged entry points'
    arguments: below N = 257 the ring scratch (the last pointer before B)
    is dropped, past it the ``_long`` entry point is called."""

    def __init__(self, lib):
        self.lib = lib
        self.path = lib.path
        self.compiler_output = lib.compiler_output

    def call(self, name, *args):
        if name in WAVEFRONT:
            k = next(j for j, a in enumerate(args) if isinstance(a, int))
            if args[k + 1] <= 256:
                args = args[:k - 1] + args[k:]
            else:
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
    _build.SIGNATURES = {k: v for k, v in saved.items()
                         if f'"C" int {k}(' in text}
    if split:
        sigs = {"rna_skew": saved["rna_skew"], **SPLIT_SIGNATURES}
        if (csrc / "contra_inside_long.cu").exists():
            sigs.update({k + "_long": saved[k] for k in WAVEFRONT})
        _build.SIGNATURES = sigs
    try:
        lib = _build.library()
    finally:
        _build.SIGNATURES = saved
    return SplitBuild(lib) if split else lib


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
        for line in lib.compiler_output.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {k} ptxas: {line.strip()}")
    use(libs["B"])
    if args.pairhmm:
        return ab_pairhmm(libs, dev, chip_smoke)
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
    outs = {}
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
                print(f"turn {turn} build {which} N={N} B={B} {kernel}: "
                      f"{ms:.4f} ms")
    for (N, B, kernel), got in outs.items():
        diff = max(float((x - y).abs().max())
                   for x, y in zip(got["A"], got["B"]))
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got["A"], got["B"]))
        print(f"N={N} B={B} {kernel}: max |A - B| {diff:.3e}"
              f"{' (bitwise equal)' if same else ''}")
    return 0


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
