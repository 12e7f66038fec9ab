"""The port's eval package against the JAX package's, on the CPU.

The framework-free copies (``synth``, ``rfam``, ``stats``, ``baseline``,
``plots``) give the originals' files and values.  On the toy family of
``tests/test_eval.py``: given the JAX ``FoldEngine``'s BPPs (fed to the
port's pipeline through a stub engine), the port writes the JAX pipeline's
gamma files byte for byte for both programs and ``compute_stats`` gives
its curves; and ``run_all(device="cpu")``, folding on the port, gives the
JAX ``run_all``'s curves."""

import filecmp
import json
import math
import os

import numpy as np
import pytest
import torch

from rna_algos_tpu.eval import baseline as JB
from rna_algos_tpu.eval import pipeline as JP
from rna_algos_tpu.eval import rfam as JRF
from rna_algos_tpu.eval import stats as JS
from rna_algos_tpu.eval import synth as JSY

from rna_algos_tpu_torch.eval import baseline as TB
from rna_algos_tpu_torch.eval import pipeline as TP
from rna_algos_tpu_torch.eval import rfam as TRF
from rna_algos_tpu_torch.eval import stats as TS
from rna_algos_tpu_torch.eval import synth as TSY

from .conftest import REPO_ROOT
from .test_eval import STH

SEED_SET = REPO_ROOT / "assets" / "synth_rfam_seed.sth"


def same_curves(a, b):
    """Curves equal value for value (NaN equal to NaN, None to None)."""
    assert sorted(a) == sorted(b)
    for key in a:
        assert len(a[key]) == len(b[key]) == 18, key
        for ra, rb in zip(a[key], b[key]):
            assert sorted(ra) == sorted(rb)
            for k in ra:
                x, y = ra[k], rb[k]
                if isinstance(x, float) and math.isnan(x):
                    assert isinstance(y, float) and math.isnan(y), (key, k)
                else:
                    assert x == y, (key, k, x, y)


def same_trees(a, b):
    """Two directory trees with the same files, byte for byte."""
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (a, mismatch, errors)
    for sub in cmp.common_dirs:
        same_trees(os.path.join(a, sub), os.path.join(b, sub))


@pytest.mark.parametrize("n_families,seed", [(5, 11), (20, 20260819)])
def test_generate_seed_set_identical(tmp_path, n_families, seed):
    want, got = tmp_path / "j.sth", tmp_path / "t.sth"
    assert (JSY.generate_seed_set(str(want), n_families, seed)
            == TSY.generate_seed_set(str(got), n_families, seed))
    assert want.read_bytes() == got.read_bytes()
    if n_families == 20:
        # the committed seed set is this generator's output
        assert got.read_bytes() == SEED_SET.read_bytes()


@pytest.mark.parametrize("source", ["toy", "seed_set"])
def test_compile_rna_fams_identical(tmp_path, source):
    sth = SEED_SET
    if source == "toy":
        sth = tmp_path / "toy.sth"
        sth.write_text(STH)
    n = JRF.compile_rna_fams(str(sth), str(tmp_path / "js"),
                             str(tmp_path / "jr"))
    assert n == TRF.compile_rna_fams(str(sth), str(tmp_path / "ts"),
                                     str(tmp_path / "tr"))
    assert n >= 1
    same_trees(tmp_path / "js", tmp_path / "ts")
    same_trees(tmp_path / "jr", tmp_path / "tr")
    assert (list(JRF.parse_stockholm(str(sth)))
            == list(TRF.parse_stockholm(str(sth))))


def test_stats_identical(tmp_path):
    rng = np.random.default_rng(3)
    for ss in ("((..AA..))..aa", "<<..>>[[..]]{..}", "(((...)))BB..bb.."):
        assert TS.parse_ss_string(ss) == JS.parse_ss_string(ss)
    path = tmp_path / "s.fa"
    path.write_text(">0\n((..))\n..\n>1\n....\n>2\n(((...)))\n")
    assert TS.read_sss(str(path)) == JS.read_sss(str(path))
    for _ in range(20):
        n = int(rng.integers(4, 40))
        est = [{(int(i), int(j)) for i, j in rng.integers(0, n, (5, 2))
                if i < j}]
        ref = [{(int(i), int(j)) for i, j in rng.integers(0, n, (5, 2))
                if i < j}]
        counts = TS.pos_neg_counts(est, ref, [n])
        assert counts == JS.pos_neg_counts(est, ref, [n])
        assert json.dumps(TS.summarize(*counts)) == json.dumps(
            JS.summarize(*counts))
    assert TS.final_sum([(1, 2, 3, 4), (5, 6, 7, 8)]) == JS.final_sum(
        [(1, 2, 3, 4), (5, 6, 7, 8)])
    got, want = TS.summarize(0, 10, 0, 0), JS.summarize(0, 10, 0, 0)
    assert json.dumps(got) == json.dumps(want)   # degenerate cells: NaN


def test_threshold_pairs_identical(tmp_path):
    rng = np.random.default_rng(9)
    results = []
    for n in (8, 30, 75):
        bpp = rng.random((n, n)).astype(np.float32) ** 6
        bpp = np.triu(bpp, 1)
        for gamma in (0.25, 1.0, 4.0, 64.0):
            assert TB.threshold_pairs(bpp, n, gamma) == JB.threshold_pairs(
                bpp, n, gamma)
        results.append((bpp, bpp > 0, n))
    for gamma in (0.5, 8.0):
        TB.write_gamma_file_threshold(str(tmp_path / "t.fa"), results, gamma)
        JB.write_gamma_file_threshold(str(tmp_path / "j.fa"), results, gamma)
        assert (tmp_path / "t.fa").read_bytes() == (
            tmp_path / "j.fa").read_bytes()


def test_plot_curves_writes_a_figure(tmp_path):
    pytest.importorskip("matplotlib")
    from rna_algos_tpu_torch.eval.plots import plot_curves

    rows = [
        {"gamma": 2.0 ** p, "ppv": 0.9 - 0.02 * p, "sens": 0.3 + 0.03 * p,
         "fpr": 0.001 * (p + 8), "f1": 0.5 + 0.01 * p,
         "mcc": float("nan") if p == -7 else 0.5}
        for p in range(-7, 11)
    ]
    out = plot_curves({"turner": rows, "contra": rows},
                      str(tmp_path / "fig.png"), title="curves")
    assert os.path.exists(out) and os.path.getsize(out) > 1000


class RecordedEngine:
    """A ``FoldEngine`` stand-in that returns recorded BPPs, keyed by model
    and sequence."""

    recorded = {}

    def __init__(self, uses_contra_model=False, device="cpu", **kw):
        self.model = "contra" if uses_contra_model else "turner"
        self.device = torch.device(device)

    def fold_batch(self, seqs):
        return [self.recorded[self.model, np.asarray(s).tobytes()]
                for s in seqs]


@pytest.fixture(scope="module")
def jax_toy(tmp_path_factory):
    """The JAX ``run_all`` on the toy family, both models, with the JAX
    ``FoldEngine``'s BPPs recorded."""
    from rna_algos_tpu.parallel import runner as JR

    work = tmp_path_factory.mktemp("jax_toy")
    sth = work / "toy.sth"
    sth.write_text(STH)
    real = JR.FoldEngine
    recorded = {}

    class Recording(real):
        def fold_batch(self, seqs):
            out = real.fold_batch(self, seqs)
            model = "contra" if self.contra else "turner"
            for s, r in zip(seqs, out):
                recorded[model, np.asarray(s).tobytes()] = tuple(
                    np.asarray(x) for x in r)
            return out

    JR.FoldEngine = Recording
    try:
        report = JP.run_all(str(sth), str(work / "run"))
    finally:
        JR.FoldEngine = real
    return sth, work / "run", report, recorded


def test_gamma_files_and_stats_equal_jax_given_its_bpps(jax_toy, tmp_path,
                                                        monkeypatch):
    from rna_algos_tpu_torch.parallel import runner as TR

    sth, jwork, jreport, recorded = jax_toy
    monkeypatch.setattr(RecordedEngine, "recorded", recorded)
    monkeypatch.setattr(TR, "FoldEngine", RecordedEngine)
    seq_dir = jwork / "compiled_rna_fams"
    ss_dir = jwork / "ref_sss"
    timings = TP.run_estimation(str(seq_dir), str(tmp_path / "est"),
                                device="cpu")
    assert sorted(timings) == sorted(jreport["timings_s"])
    same_trees(jwork / "estimates", tmp_path / "est")
    same_curves(TP.compute_stats(str(tmp_path / "est"), str(seq_dir),
                                 str(ss_dir)),
                JP.compute_stats(str(jwork / "estimates"), str(seq_dir),
                                 str(ss_dir)))


def test_run_all_cpu_equals_jax_curves(jax_toy, tmp_path):
    """The port's whole pipeline on the CPU: the JAX run_all's curves, a
    strict JSON report with the phase split, the figure where matplotlib
    is installed."""
    sth, _, jreport, _ = jax_toy
    report = TP.run_all(str(sth), str(tmp_path), device="cpu")
    assert report["num_families"] == jreport["num_families"] == 1
    same_curves(report["curves"], jreport["curves"])
    with open(tmp_path / "eval_report.json") as f:
        text = f.read()
    assert "NaN" not in text
    saved = json.loads(text)
    assert saved["curves"].keys() == report["curves"].keys()
    phases = saved["phases"]
    for model in ("turner", "contra"):
        for stage in ("fold", "mea_fill", "traceback", "threshold"):
            assert phases[f"{stage}_{model}"]["calls"] >= 1, (stage, model)
    assert phases["stats"]["calls"] == 1 and saved["wall_s"] > 0
    if "figure" in report:
        assert os.path.getsize(report["figure"]) > 1000


@pytest.mark.slow
def test_eval_accuracy_gate(tmp_path):
    """``tests/test_eval_synth.py::test_eval_accuracy_gate`` on the port:
    on a small synthetic slice the centroid estimator beats minimum
    F1/MCC, and the comparison arm writes its column."""
    sth = tmp_path / "seed.sth"
    TSY.generate_seed_set(str(sth), n_families=3, seed=11)
    report = TP.run_all(str(sth), str(tmp_path / "work"), models=("contra",),
                        device="cpu")
    rows = report["curves"]["centroid_estimator_contra"]
    assert TP.best(rows, "mcc") > 0.3
    assert TP.best(rows, "f1") > 0.3
    assert len(report["curves"]["threshold_estimator_contra"]) == 18
