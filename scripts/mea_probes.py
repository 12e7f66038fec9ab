"""Probe the launch plans of K23 (the gamma-centroid MEA fill,
``csrc/mea_fill.cu``) on a CUDA GPU, and time knock-out copies of it.

    python scripts/mea_probes.py [--shapes N:R,...] [--reps REPS]
        [--no-plans] [--no-knock]

Prints the card's name and power limit and K23's ptxas lines.  Then
``CLUSTER_SMALL``: the cluster form at small N, with narrow blocks and
every cluster size, against the plain version (where a fault in its deal
would show first).  Then for each shape (bucket N, R records
of ``chip_smoke.mea_inputs``, the 18 gammas): the plan
``rna_mea_fill_plan`` picks (form, threads a block, blocks a fill), checked bitwise against the plain version by
``chip_smoke.check_mea`` (also NaN-filled and with a NaN BPP cell), then
that plan and each alternative of ``ALTERNATIVES`` (each bitwise the plain
version's output, or the script fails; one the card refuses to launch is
reported and skipped) with its time: CUDA events, the mean of REPS calls
after a warm-up.  Last, ``KNOCKS``: copies of ``mea_fill.cu`` with a part
taken out (the bulk, the step's cell, its late terms, or both), each
built alone into ``rna_algos_tpu_torch/_build/probes/`` and timed at each
shape under the picked plan (their fills are wrong by design and are not
checked).  Needs a GPU.
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

SHAPES = ((96, 6), (128, 192), (256, 4), (256, 56), (332, 2), (333, 2),
          (384, 2), (512, 8), (1536, 1))


# (N) -> the plans (form, threads a block, blocks a fill) tried beside the
# picked one
ALTERNATIVES = {
    96: [(0, t, 1) for t in (96, 192, 512)],
    128: [(0, t, 1) for t in (192, 256)],
    256: [(0, t, 1) for t in (512, 1024)],
    332: [(0, 704, 1), (1, 512, 4)],
    333: [(1, 512, c) for c in (1, 2, 8)],
    384: [(1, t, c) for t, c in ((512, 2), (1024, 2), (256, 8))],
    512: [(1, t, c) for t, c in ((512, 2), (1024, 1))],
    1536: [(1, t, c) for t, c in ((512, 4), (512, 16), (1024, 4))],
}
# (N, R, plans): the cluster form where its deal is narrow
CLUSTER_SMALL = [(n, 2, [(1, t, c) for t in (32, 64, 512)
                         for c in (1, 2, 4, 8, 16)])
                 for n in (2, 9, 33, 64, 96)]
# knock-out copies: (name, [(old, new), ...]) text replacements
BULK = "      mea_bulk<SHARED>(D, N, d0, q, nthr);\n"
CELL = "  const int nd = N - d0;\n"
LO = "  for (int k = 0; k < M - 1; ++k)"
HI = "  if (d0 > 0)\n#pragma unroll\n    for (int k = 0; k < M; ++k)"
KNOCKS = (
    ("no-bulk", [(BULK, "")]),
    ("no-cell", [(CELL, "  if (N > 0) return p;\n" + CELL)]),
    ("no-late", [(LO, "  for (int k = 0; k < 0; ++k)"),
                 (HI, HI.replace("d0 > 0", "d0 < 0"))]),
    ("barriers", [(BULK, ""), (CELL, "  if (N > 0) return p;\n" + CELL)]),
)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def knock_build(name, edits, build):
    """Build a copy of csrc/mea_fill.cu with ``edits`` (and skew.cu, for
    the error strings) alone; its loaded library.  ``build``: the
    package's ``_build.library`` (``ab_kernels.use`` replaces it)."""
    from ab_kernels import load
    from rna_algos_tpu_torch.ops import _build

    _build.library = build
    src = ROOT / "rna_algos_tpu_torch" / "csrc"
    dst = ROOT / "rna_algos_tpu_torch" / "_build" / "probes" / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for p in [*src.glob("*.cuh"), src / "skew.cu"]:
        shutil.copy(p, dst / p.name)
    text = (src / "mea_fill.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"knock-out {name}: pattern not found")
        text = text.replace(old, new)
    (dst / "mea_fill.cu").write_text(text)
    return load(dst, False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None,
                    help="N:R pairs, comma-separated (default SHAPES)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-plans", action="store_true",
                    help="only the picked plans")
    ap.add_argument("--no-knock", action="store_true",
                    help="no knock-out copies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mea_probes: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke
    from ab_kernels import ptxas_lines, use
    from rna_algos_tpu_torch.models.centroid import DEFAULT_GAMMAS
    from rna_algos_tpu_torch.ops import _build
    from rna_algos_tpu_torch.ops import mea_fill as MF

    card = smi()
    print(card)
    build = _build.library
    lib = build()
    print(f"build {lib.build_seconds:.1f} s")
    for name, line in ptxas_lines(lib.compiler_output):
        if "mea" in name:
            print(f"ptxas: {name}: {line}")
    dev = torch.device("cuda")
    G = len(DEFAULT_GAMMAS)
    for N, R, plans in CLUSTER_SMALL:
        x = chip_smoke.mea_inputs(N, R, seed=N, device=dev)
        want = MF.mea_fill_batch_plain(x, DEFAULT_GAMMAS)
        for p in plans:
            chip_smoke.mea_bitwise(MF.mea_fill_batch(x, DEFAULT_GAMMAS, p),
                                   want, f"N{N}_R{R} plan {p}")
        print(f"cluster form N{N} R{R}: bitwise under {len(plans)} plans")
    shapes = SHAPES if args.shapes is None else [
        tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]

    def timed(x, p, label):
        ms = chip_smoke.cuda_ms(
            lambda: MF.mea_fill_batch(x, DEFAULT_GAMMAS, p), args.reps)
        N, R = x.shape[1], x.shape[0]
        bms, by = chip_smoke.mea_bound(R, G, N)
        print(f"time N{N}_R{R} G={G} plan {p}{label}: {ms:.4f} ms, "
              f"{ms / R:.4f} ms a record, bound {bms:.4f} ms ({by}), share "
              f"{bms / ms:.4f}, on {card}")

    picked = {}
    for N, R in shapes:
        x = chip_smoke.mea_inputs(N, R, seed=N + R, device=dev)
        picked[N, R] = MF.plan(R, G, N)
        want, _ = chip_smoke.check_mea(x, f"N{N}_R{R} plan {picked[N, R]}")
        alts = [] if args.no_plans else ALTERNATIVES.get(N, [])
        for p in [picked[N, R]] + [a for a in alts if a != picked[N, R]]:
            try:
                got = MF.mea_fill_batch(x, DEFAULT_GAMMAS, p)
            except RuntimeError as e:   # a launch the card refuses
                if p == picked[N, R]:
                    raise
                print(f"plan {p} at N{N}_R{R}: refused ({e})")
                continue
            chip_smoke.mea_bitwise(got, want, f"N{N}_R{R} plan {p}")
            timed(x, p, " (picked)" if p == picked[N, R] else "")
        del x, want
        torch.cuda.empty_cache()
    if args.no_knock:
        return 0
    for name, edits in KNOCKS:
        use(knock_build(name, edits, build))
        for N, R in shapes:
            x = chip_smoke.mea_inputs(N, R, seed=N + R, device=dev)
            timed(x, picked[N, R], f" knock-out {name}")
            del x
            torch.cuda.empty_cache()
    use(lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
