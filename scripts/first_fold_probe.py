"""The first folds of a fresh process on the card: each seed-set family's
``FoldEngine.fold_batch`` time, Turner then CONTRA, twice over (the first
pass pays the process's one-off set-up), then a ``torch.profiler`` table of
one warm CONTRA family's fold.

    python3 scripts/first_fold_probe.py

Needs a CUDA GPU; prints each family's (file, records, buckets, inside
launches, ms) and each pass's total.
"""

import os
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from rna_algos_tpu_torch.eval.rfam import compile_rna_fams  # noqa: E402
from rna_algos_tpu_torch.ops import _build  # noqa: E402
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8  # noqa: E402
from rna_algos_tpu_torch.parallel.runner import (  # noqa: E402
    FoldEngine, kernel_bucket)
from rna_algos_tpu_torch.utils.io import read_fasta  # noqa: E402


def main():
    _build.library()
    with tempfile.TemporaryDirectory() as work:
        compile_rna_fams(str(ROOT / "assets/synth_rfam_seed.sth"),
                         work + "/s", work + "/r")
        fams = [[r.seq for r in read_fasta(os.path.join(work, "s", f))]
                for f in sorted(os.listdir(work + "/s"))]
        names = sorted(os.listdir(work + "/s"))
    for model in ("turner", "contra", "turner", "contra"):
        contra = model == "contra"
        eng = FoldEngine(uses_contra_model=contra, device="cuda")
        tot, rows = 0.0, []
        for name, seqs in zip(names, fams):
            P8.inside_launches.reset()
            P8.turner_inside_launches.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.fold_batch(seqs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            tot += dt
            rows.append((name, len(seqs),
                         sorted({kernel_bucket(len(s), contra) for s in seqs}),
                         P8.inside_launches.count
                         + P8.turner_inside_launches.count,
                         round(dt * 1e3, 2)))
        print(model, f"total {tot:.3f} s", rows, flush=True)
    eng = FoldEngine(uses_contra_model=True, device="cuda")
    eng.fold_batch(fams[0])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.fold_batch(fams[0])
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=25))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=20))


if __name__ == "__main__":
    main()
