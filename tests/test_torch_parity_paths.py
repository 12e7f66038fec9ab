"""The parity tier as a whole on the CPU (the plain versions of K16-K19):
``FoldEngine(numerics="parity")`` through the fold CLIs against the
C-baseline goldens, which come from the reference's cubic numerics, and
the buckets ``kernel_bucket(n, contra, "parity")`` picks against the JAX
runner's rule.

- ``cli.mccaskill --numerics parity``: the key set of every record
  identical to ``c_baseline/mccaskill_{contra,turner}.txt`` (presence is
  isfinite(bppo), pairs whose BPP the cubic expf flushes to 0 included)
  and the BPPs within 5e-4 (tests/test_reference_golden.py's bound).
- ``cli.centroid_fold --numerics parity``: the 18 CONTRA files
  byte-identical to ``centroid_contra/``; Turner byte-identical to
  ``centroid_turner/`` or off by the one gamma = 1 tie
  (``chip_smoke.turner_centroid_verdict``), the verdict printed.

Each model's fold of the FASTA runs once: the second CLI of a model gets
the first one's ``FoldEngine.fold_batch`` result (``shared_folds``).
"""

import os
import pathlib

import pytest

import chip_smoke
from rna_algos_tpu import numerics as JN
from rna_algos_tpu.models import mccaskill as JM
from rna_algos_tpu.parallel import runner as JR

from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
from rna_algos_tpu_torch.cli import mccaskill as mc_cli
from rna_algos_tpu_torch.parallel import runner as TR

from .test_torch_long_tiers import on_tpu  # noqa: F401  (fixture)
from .test_torch_parity_contra import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
FASTA = str(ROOT / "assets" / "sampled_trnas.fa")
GOLDEN = ROOT / "tests" / "golden" / "c_baseline"
MODELS = [(["-c"], "contra"), ([], "turner")]
MODEL_IDS = ["contra", "turner"]
_FOLDS = {}


@pytest.fixture
def shared_folds(monkeypatch):
    """FoldEngine.fold_batch memoized across this module's CLI tests, by
    model, numerics and sequences."""
    fold = TR.FoldEngine.fold_batch

    def fold_batch(self, seqs):
        key = (self.contra, self.numerics, tuple(map(tuple, seqs)))
        if key not in _FOLDS:
            _FOLDS[key] = fold(self, seqs)
        return _FOLDS[key]

    monkeypatch.setattr(TR.FoldEngine, "fold_batch", fold_batch)


@pytest.mark.parametrize("flag,model", MODELS, ids=MODEL_IDS)
def test_mccaskill_cli_parity_meets_golden(tmp_path, shared_folds, flag,
                                           model):
    out = tmp_path / "bpp.txt"
    assert mc_cli.main(["-i", FASTA, "-o", str(out), "--device", "cpu",
                        "--numerics", "parity", *flag]) == 0
    ref = chip_smoke.parse_triples(
        (GOLDEN / f"mccaskill_{model}.txt").read_text())
    got = chip_smoke.parse_triples(out.read_text())
    # raises unless every record's key set is identical
    worst, _ = chip_smoke.compare_triples(ref, got, 5e-4, model)
    print(f"{model} parity vs c_baseline: identical key sets, worst "
          f"{worst:.3e}")
    assert out.read_text().startswith(mc_cli.HEADER)


@pytest.mark.parametrize("flag,model", MODELS, ids=MODEL_IDS)
def test_centroid_cli_parity_meets_golden(tmp_path, shared_folds, flag,
                                          model):
    out = tmp_path / "centroids"
    assert cf_cli.main(["-i", FASTA, "-o", str(out), "--device", "cpu",
                        "--numerics", "parity", *flag]) == 0
    ref_dir = GOLDEN / f"centroid_{model}"
    if model == "contra":
        names = sorted(os.listdir(ref_dir))
        assert len(names) == 18 and names == sorted(os.listdir(out))
        for name in names:
            assert (ref_dir / name).read_bytes() == (out / name).read_bytes()
    else:
        verdict = chip_smoke.turner_centroid_verdict(ref_dir, out)
        print(f"Turner parity centroid verdict: {verdict}")


@pytest.mark.parametrize("contra", [True, False], ids=MODEL_IDS)
def test_parity_kernel_bucket_matches_jax_runner(on_tpu, contra):  # noqa: F811
    lengths = range(1, 301)
    with JN.force_mode("parity"):
        JR.FoldEngine(uses_contra_model=contra).fold_batch(
            [[0] * n for n in lengths])
        for n in lengths:
            N = on_tpu[n]
            if JM.pallas_available(contra, N):
                assert TR.kernel_bucket(n, contra, "parity") == N, n
            else:
                # the JAX package runs the XLA scan past 256 under parity
                assert n > 256
                with pytest.raises(NotImplementedError, match="A10"):
                    TR.kernel_bucket(n, contra, "parity")


def test_fold_engine_checks_numerics():
    with pytest.raises(ValueError, match="numerics"):
        TR.FoldEngine(device="cpu", numerics="cubic")
