"""End-to-end accuracy-evaluation pipeline (``rna_algos_tpu.eval.pipeline``).

Re-creation of the reference's `scripts/run_ss_estimation_programs.py` +
`run_all.py`: run the centroid estimator and the threshold estimator over
every compiled family for both models and the full gamma grid, then
aggregate PPV/sens/FPR/F1/MCC per gamma (PR/ROC/F1/MCC curve data), on the
port's ``FoldEngine``.  Results are written as strict JSON (plot-ready),
with the wall time per column and a ``PhaseTimer`` split of each model's
stages: fold, MEA fill, traceback, threshold arm, stats.

    python -m rna_algos_tpu_torch.eval.pipeline --sth SEED.sth --work DIR \\
        [--device cuda|cpu] [--numerics exact|fast|parity]

writes only under ``--work``.  The fold runs ``--numerics``' mode, by
default ``RNA_ALGOS_NUMERICS``'s ("exact" when unset), as the JAX
pipeline follows the global mode; so do ``run_all`` and
``run_estimation`` when given no ``numerics``.
"""

import argparse
import json
import math
import os
import sys
import time

from ..cli.common import add_numerics_flag, default_numerics, numerics_of
from ..models.centroid import (DEFAULT_GAMMAS, centroid_structures,
                               gamma_file_name, write_gamma_files)
from ..utils.io import read_fasta
from ..utils.trace import PhaseTimer, dp_cells
from . import stats


PROGRAMS = ("centroid_estimator", "threshold_estimator")


def _families(rna_dir):
    return [os.path.splitext(f)[0] for f in sorted(os.listdir(rna_dir))
            if f.endswith(".fa")]


def run_estimation(rna_dir, out_root, models=("turner", "contra"),
                   programs=PROGRAMS, device="cuda", timer=None,
                   numerics=None):
    """Fold every family once per model, write gamma-grid structure files.

    One directory per (program, model):
    ``{out_root}/{program}_{model}/{family}/centroid_threshold={g}.fa``.
    BPPs are computed ONCE per (family, model) on ``device`` in the
    ``numerics`` mode (``RNA_ALGOS_NUMERICS``'s when None) and shared by
    both programs; the centroid program fills all 18 gammas of a record at
    once.  ``timer`` (a ``PhaseTimer``) receives the phases
    ``fold_{model}``, ``mea_fill_{model}``, ``traceback_{model}`` and
    ``threshold_{model}``.  Returns the seconds of each column (its model's
    fold plus its program), as the JAX pipeline does."""
    from ..parallel.runner import FoldEngine
    from .baseline import write_gamma_file_threshold

    timer = PhaseTimer() if timer is None else timer
    numerics = default_numerics() if numerics is None else numerics
    fams = _families(rna_dir)
    timings = {}
    for model in models:
        engine = FoldEngine(uses_contra_model=(model == "contra"),
                            device=device, numerics=numerics)
        fold_results = {}
        t0 = time.time()
        for fam in fams:
            records = read_fasta(os.path.join(rna_dir, fam + ".fa"))
            seqs = [r.seq for r in records]
            with timer.phase(f"fold_{model}", items=len(seqs),
                             cells=sum(dp_cells(len(s)) for s in seqs),
                             device=engine.device):
                folded = engine.fold_batch(seqs)
            fold_results[fam] = [
                (bpp, presence, len(records[k].seq))
                for k, (bpp, presence) in enumerate(folded)
            ]
        fold_time = time.time() - t0
        for program in programs:
            t0 = time.time()
            for fam, results in fold_results.items():
                fam_dir = os.path.join(out_root, f"{program}_{model}", fam)
                os.makedirs(fam_dir, exist_ok=True)
                if program == "centroid_estimator":
                    write_gamma_files(fam_dir, centroid_structures(
                        results, DEFAULT_GAMMAS, engine.device, timer=timer,
                        tag=f"_{model}"))
                    continue
                with timer.phase(f"threshold_{model}",
                                 items=len(results) * len(DEFAULT_GAMMAS)):
                    for gamma in DEFAULT_GAMMAS:
                        write_gamma_file_threshold(
                            os.path.join(fam_dir, gamma_file_name(gamma)),
                            results, gamma)
            timings[f"{program}_{model}"] = fold_time + (time.time() - t0)
    return timings


def compute_stats(out_root, rna_dir, ref_ss_dir, models=("turner", "contra"),
                  programs=PROGRAMS):
    """Aggregate accuracy curves (get_stats_of_ss_estimation_programs.py:46-111).

    One curve per (program, model) column, keyed "{program}_{model}"; the
    bare model name keys the centroid_estimator column too, as in the JAX
    pipeline."""
    curves = {}
    for model in models:
        for program in programs:
            model_dir = os.path.join(out_root, f"{program}_{model}")
            if not os.path.isdir(model_dir):
                continue
            per_gamma = []
            for gamma in DEFAULT_GAMMAS:
                counts = []
                for fam in _families(rna_dir):
                    fam_file = fam + ".fa"
                    est_path = os.path.join(model_dir, fam,
                                            gamma_file_name(gamma))
                    seq_lens = [
                        len(r.seq)
                        for r in read_fasta(os.path.join(rna_dir, fam_file))
                    ]
                    est = stats.read_sss(est_path)
                    ref = stats.read_sss(os.path.join(ref_ss_dir, fam_file))
                    counts.append(stats.pos_neg_counts(est, ref, seq_lens))
                tp, tn, fp, fn = stats.final_sum(counts)
                per_gamma.append(
                    {"gamma": gamma, **stats.summarize(tp, tn, fp, fn)}
                )
            curves[f"{program}_{model}"] = per_gamma
            if program == "centroid_estimator":
                curves[model] = per_gamma
    return curves


def _nan_to_null(obj):
    if isinstance(obj, float) and (math.isnan(obj) or math.isinf(obj)):
        return None
    if isinstance(obj, dict):
        return {k: _nan_to_null(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_nan_to_null(v) for v in obj]
    return obj


def run_all(sth_path, work_dir, models=("turner", "contra"),
            programs=PROGRAMS, device="cuda", numerics=None):
    """Full pipeline: compile families -> estimate -> stats (run_all.py:7-10).

    Writes ``eval_report.json`` (strict JSON: degenerate metric cells are
    null) and, where matplotlib is installed, ``fig_1.png`` into
    ``work_dir``.  The report's ``phases`` holds the ``PhaseTimer`` summary
    (``stats`` included), ``wall_s`` the whole run's seconds and
    ``numerics`` the fold's mode (``RNA_ALGOS_NUMERICS``'s when None)."""
    from .rfam import compile_rna_fams

    t0 = time.perf_counter()
    timer = PhaseTimer()
    seq_dir = os.path.join(work_dir, "compiled_rna_fams")
    ss_dir = os.path.join(work_dir, "ref_sss")
    out_root = os.path.join(work_dir, "estimates")
    n_fams = compile_rna_fams(sth_path, seq_dir, ss_dir)
    numerics = default_numerics() if numerics is None else numerics
    timings = run_estimation(seq_dir, out_root, models, programs,
                             device=device, timer=timer, numerics=numerics)
    with timer.phase("stats", items=n_fams):
        curves = compute_stats(out_root, seq_dir, ss_dir, models, programs)
    report = {"num_families": n_fams, "timings_s": timings, "curves": curves,
              "device": str(device), "numerics": numerics,
              "phases": timer.summary(),
              "wall_s": time.perf_counter() - t0}
    with open(os.path.join(work_dir, "eval_report.json"), "w") as f:
        json.dump(_nan_to_null(report), f, indent=2, allow_nan=False)
    try:
        from .plots import plot_curves

        column_keys = [f"{p}_{m}" for p in programs for m in models]
        report["figure"] = plot_curves(
            {k: curves[k] for k in column_keys if k in curves},
            os.path.join(work_dir, "fig_1.png"),
        )
    except ImportError:
        pass  # matplotlib absent: the JSON report is the artifact
    return report


def best(rows, key):
    """Best finite value of ``key`` over a column's rows (NaN if none)."""
    vals = [r[key] for r in rows if r[key] is not None and r[key] == r[key]]
    return max(vals, default=float("nan"))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="rna_algos_tpu_torch.eval.pipeline",
        description="accuracy evaluation on the port (CUDA)")
    ap.add_argument("--sth", required=True,
                    help="Stockholm seed set (e.g. assets/synth_rfam_seed.sth)")
    ap.add_argument("--work", required=True,
                    help="work directory: the compiled families, the "
                    "estimates, eval_report.json and fig_1.png go here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to fold on (default cuda; no "
                    "fallback to the CPU)")
    add_numerics_flag(ap, "the fold's numerics mode")
    args = ap.parse_args(argv)
    os.makedirs(args.work, exist_ok=True)
    report = run_all(args.sth, args.work, device=args.device,
                     numerics=numerics_of(args))
    for key, rows in sorted(report["curves"].items()):
        if "_" not in key:
            continue
        print(json.dumps({
            "column": key, "best_f1": best(rows, "f1"),
            "best_mcc": best(rows, "mcc"),
            "time_s": report["timings_s"].get(key),
        }))
    print(json.dumps({"phases": report["phases"],
                      "wall_s": report["wall_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
