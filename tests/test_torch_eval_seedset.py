"""The port's eval pipeline against the JAX package's on the three families
of ``generate_seed_set(n_families=3, seed=11)`` (76-173 nt, buckets 96 and
192), given the same BPPs (fed through a stub engine).

Tier-1 case, with the port's CPU Turner ``FoldEngine``'s BPPs (the model
only chooses the BPPs; the port's CONTRA plain fold takes ~10 s here on one
thread): the port's ``run_estimation`` writes the JAX threshold writer's
files for all 18 gammas and the JAX centroid writer's
(``cli.centroid_fold.write_gamma_file``) at GAMMAS_CHECKED, byte for byte,
and the port's ``compute_stats`` gives the JAX ``compute_stats``' curves on
those estimates.  The JAX centroid writer runs one jitted MEA scan a record
and gamma: ~15 s a model for all 18 gammas alone, ten times that under the
suite's parallel load.

Slow cases: the JAX ``FoldEngine``'s BPPs (~45-75 s a model on the CPU)
through both whole pipelines, every file of both programs compared."""

import os

import numpy as np
import pytest

from rna_algos_tpu.cli.centroid_fold import write_gamma_file as j_centroid
from rna_algos_tpu.eval import pipeline as JP
from rna_algos_tpu.eval.baseline import write_gamma_file_threshold as j_thresh
from rna_algos_tpu.parallel import runner as JR

from rna_algos_tpu_torch.eval import pipeline as TP
from rna_algos_tpu_torch.eval import rfam as TRF
from rna_algos_tpu_torch.eval import synth as TSY
from rna_algos_tpu_torch.models.centroid import DEFAULT_GAMMAS, gamma_file_name
from rna_algos_tpu_torch.parallel import runner as TR
from rna_algos_tpu_torch.utils.io import read_fasta

from .scan_cases import single_torch_thread  # noqa: F401  (fixture)
from .test_torch_eval import RecordedEngine, same_curves, same_trees

GAMMAS_CHECKED = (1.0, 16.0)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    work = tmp_path_factory.mktemp("seed11")
    TSY.generate_seed_set(str(work / "seed.sth"), n_families=3, seed=11)
    n = TRF.compile_rna_fams(str(work / "seed.sth"), str(work / "seqs"),
                             str(work / "sss"))
    assert n == 3
    fams = {f[:-3]: [r.seq for r in read_fasta(work / "seqs" / f)]
            for f in sorted(os.listdir(work / "seqs"))}
    return work, fams


def _record(engine, model, fams):
    seqs = [s for f in fams.values() for s in f]
    return {(model, np.asarray(s).tobytes()): tuple(np.asarray(x) for x in r)
            for s, r in zip(seqs, engine.fold_batch(seqs))}


@pytest.mark.usefixtures("single_torch_thread")
def test_gamma_files_equal_given_the_same_bpps(families, tmp_path,
                                               monkeypatch):
    work, fams = families
    model = "turner"
    engine = TR.FoldEngine(uses_contra_model=False, device="cpu")
    recorded = _record(engine, model, fams)
    monkeypatch.setattr(RecordedEngine, "recorded", recorded)
    monkeypatch.setattr(TR, "FoldEngine", RecordedEngine)
    seq_dir, ss_dir = str(work / "seqs"), str(work / "sss")
    out = tmp_path / "port"
    TP.run_estimation(seq_dir, str(out), models=(model,), device="cpu")
    checked = 0
    for fam, seqs in fams.items():
        results = [recorded[model, np.asarray(s).tobytes()] + (len(s),)
                   for s in seqs]
        for writer, program, gammas in (
                (j_thresh, "threshold_estimator", DEFAULT_GAMMAS),
                (j_centroid, "centroid_estimator", GAMMAS_CHECKED)):
            for gamma in gammas:
                name = gamma_file_name(gamma)
                writer(str(tmp_path / name), results, gamma)
                got = out / f"{program}_{model}" / fam / name
                assert got.read_bytes() == (tmp_path / name).read_bytes(), (
                    program, fam, gamma)
                checked += 1
    assert checked == 3 * (18 + len(GAMMAS_CHECKED))
    same_curves(TP.compute_stats(str(out), seq_dir, ss_dir, models=(model,)),
                JP.compute_stats(str(out), seq_dir, ss_dir, models=(model,)))


@pytest.mark.slow
@pytest.mark.parametrize("model", ["contra", "turner"])
def test_gamma_files_equal_given_the_jax_engines_bpps(families, model,
                                                      tmp_path, monkeypatch):
    work, fams = families
    engine = JR.FoldEngine(uses_contra_model=model == "contra")
    monkeypatch.setattr(RecordedEngine, "recorded",
                        _record(engine, model, fams))
    monkeypatch.setattr(JR, "FoldEngine", RecordedEngine)
    monkeypatch.setattr(TR, "FoldEngine", RecordedEngine)
    seq_dir, ss_dir = str(work / "seqs"), str(work / "sss")
    JP.run_estimation(seq_dir, str(tmp_path / "jax"), models=(model,))
    TP.run_estimation(seq_dir, str(tmp_path / "port"), models=(model,),
                      device="cpu")
    same_trees(tmp_path / "jax", tmp_path / "port")
    same_curves(
        TP.compute_stats(str(tmp_path / "port"), seq_dir, ss_dir,
                         models=(model,)),
        JP.compute_stats(str(tmp_path / "jax"), seq_dir, ss_dir,
                         models=(model,)))
