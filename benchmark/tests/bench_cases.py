"""Shared set-up of the benchmark's CPU tests: the benchmark's folder and
the repository root on the import path, and cells cut to a size the CPU
folds in a second."""

import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("contrafold_surrogate.centroid_trna", "turner2004.bpp_rnasep")


def tiny_spec(cell):
    """The cell's spec with its traffic cut to a few short sequences a
    call (two tRNA templates of 40 nt, or 3 random ones of 30-50 nt) and a
    few gammas."""
    from benchlib import spec as spec_lib

    spec = spec_lib.load(cell)
    t = spec["traffic"]
    if "templates" in t:
        t["templates"] = {k: v[:40] for k, v in
                          list(t["templates"].items())[:2]}
        t["batch"] = 4
        t["gammas"] = t["gammas"][::3]
    else:
        t.update(batch=3, length_min=30, length_max=50)
    return spec
