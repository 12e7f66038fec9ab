"""The engines' and CLIs' contracts against the JAX package, on the CPU:
``AlignEngine.match_probs_pairs`` returns ``{(a, b): probs}`` (C1),
``FoldEngine`` takes a CONTRAfold score-set dict ``fss`` (C2), and the CLIs
take their default numerics mode from ``RNA_ALGOS_NUMERICS`` (C3)."""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest

from rna_algos_tpu.params import build_fold_score_sets as j_build_fss
from rna_algos_tpu.parallel import runner as JR

from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
from rna_algos_tpu_torch.cli import durbin as du_cli
from rna_algos_tpu_torch.cli import mccaskill as mc_cli
from rna_algos_tpu_torch.cli.common import numerics_of
from rna_algos_tpu_torch.parallel.runner import AlignEngine, FoldEngine

from .conftest import REPO_ROOT
from .test_reference_golden import _parse_triples
from .test_torch_durbin_e2e import _wrapped

# the port's exact Durbin path sits 5.5e-5 from the JAX row scan
TOL_ALIGN = 1e-4
TOL_BPP = 5e-4


def test_align_engine_dict_matches_jax(trna_records):
    """Two tRNAs and two 40-50 nt sequences, pairs within each bucket (port
    buckets 128 and 64), one reversed: the port's dict has the JAX engine's
    keys, and each array its shape and values within 1e-4."""
    rng = np.random.default_rng(5)
    seqs = _wrapped([trna_records[0].seq, trna_records[3].seq,
                     rng.integers(0, 4, 41), rng.integers(0, 4, 48)])
    pairs = [(0, 1), (2, 3), (3, 2), (1, 0)]
    got = AlignEngine(device="cpu").match_probs_pairs(seqs, pairs)
    want = JR.AlignEngine().match_probs_pairs(seqs, pairs)
    assert isinstance(got, dict) and set(got) == set(want)
    assert list(got) == pairs
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].shape == w.shape
        assert float(np.abs(got[key] - w).max()) <= TOL_ALIGN, key


def _perturbed_fss():
    """A copy of the default score-set dict with a few weights moved."""
    fss = copy.deepcopy(j_build_fss())
    fss["multibranch_score_base"] = np.float32(fss["multibranch_score_base"]
                                               - 0.5)
    fss["external_score_unpair"] = np.float32(
        fss["external_score_unpair"] + 0.25)
    fss["stack_scores"] = (np.asarray(fss["stack_scores"]) * 1.2).astype(
        np.float32)
    return fss


def test_fold_engine_takes_fss(trna_records):
    """``FoldEngine(uses_contra_model=True, fss=...)`` folds with the given
    weights: the BPPs of the JAX engine on the same dict (5e-4), and not
    those of the default weights.  Turner ignores ``fss``."""
    seqs = [r.seq for r in trna_records[:3]]
    fss = _perturbed_fss()
    got = FoldEngine(uses_contra_model=True, fss=fss,
                     device="cpu").fold_batch(seqs)
    want = JR.FoldEngine(uses_contra_model=True, fss=fss).fold_batch(seqs)
    default = FoldEngine(uses_contra_model=True,
                         device="cpu").fold_batch(seqs)
    moved = 0.0
    for (bpp, _), (wbpp, _), (dbpp, _) in zip(got, want, default):
        assert bpp.shape == wbpp.shape
        assert float(np.abs(bpp - np.asarray(wbpp)).max()) <= TOL_BPP
        moved = max(moved, float(np.abs(bpp - dbpp).max()))
    assert moved > 10 * TOL_BPP
    turner = FoldEngine(uses_contra_model=False, fss=fss, device="cpu")
    assert "stack_scores" not in turner.tbl


@pytest.mark.parametrize("cli", [mc_cli, cf_cli, du_cli],
                         ids=["mccaskill", "centroid_fold", "durbin"])
def test_cli_numerics_default_from_env(monkeypatch, cli):
    """Each CLI runs RNA_ALGOS_NUMERICS's mode unless --numerics is given,
    exact when it is unset; an invalid value raises, flag or not."""
    base = ["-i", "in.fa", "-o", "out"]
    parse = cli.build_parser().parse_args
    monkeypatch.delenv("RNA_ALGOS_NUMERICS", raising=False)
    assert numerics_of(parse(base)) == "exact"
    monkeypatch.setenv("RNA_ALGOS_NUMERICS", "parity")
    assert numerics_of(parse(base)) == "parity"
    assert numerics_of(parse(base + ["--numerics", "fast"])) == "fast"
    monkeypatch.setenv("RNA_ALGOS_NUMERICS", "turbo")
    for argv in (base, base + ["--numerics", "exact"]):
        with pytest.raises(ValueError, match="turbo"):
            numerics_of(parse(argv))


def test_mccaskill_cli_env_parity_matches_jax_cli(tmp_path):
    """With RNA_ALGOS_NUMERICS=parity in the environment of a subprocess,
    the port's ``cli.mccaskill -c`` writes the key set of the JAX CLI
    under the same variable (both on a short FASTA, BPPs within 5e-4); an
    invalid value makes the port's CLI fail."""
    fasta = tmp_path / "in.fa"
    rng = np.random.default_rng(3)
    fasta.write_text("".join(
        f">s{k}\n" + "".join("ACGU"[b] for b in rng.integers(0, 4, n)) + "\n"
        for k, n in enumerate((36, 52))))
    env = dict(os.environ, RNA_ALGOS_NUMERICS="parity", JAX_PLATFORMS="cpu")

    def run(module, out, extra=(), environ=env):
        return subprocess.Popen(
            [sys.executable, "-m", module, "-i", str(fasta), "-o", str(out),
             "-c", *extra], cwd=REPO_ROOT, env=environ,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = [run("rna_algos_tpu_torch.cli.mccaskill", tmp_path / "t.txt",
                 ("--device", "cpu")),
             run("rna_algos_tpu.cli.mccaskill", tmp_path / "j.txt"),
             run("rna_algos_tpu_torch.cli.mccaskill", tmp_path / "x.txt",
                 ("--device", "cpu"), dict(env, RNA_ALGOS_NUMERICS="turbo"))]
    outs = [p.communicate()[0] for p in procs]
    assert procs[0].returncode == 0, outs[0]
    assert procs[1].returncode == 0, outs[1]
    assert procs[2].returncode != 0 and "turbo" in outs[2]
    got = _parse_triples((tmp_path / "t.txt").read_text())
    want = _parse_triples((tmp_path / "j.txt").read_text())
    assert list(got) == list(want)
    for rid in want:
        assert set(got[rid]) == set(want[rid]), rid
        worst = max(abs(p - got[rid][k]) for k, p in want[rid].items())
        assert worst <= TOL_BPP
