"""The two CLIs of the port without ``-c`` (the Turner model) vs the
C-baseline goldens, on the CPU.

Centroid files: 17 of the 18 in ``c_baseline/centroid_turner/`` are
byte-identical.  ``centroid_threshold=1.fa`` is too, or differs only in
record 0's pair (2, 80): the golden (cubic log-space tier) puts that
pair's BPP at 1.0000076, the probability-space tier at ~0.999993, and
gamma = 1 pairs only above 1.  The test computes the file the JAX
package's own probability-space path gives there, so the tie is pinned
rather than skipped.  BPP triples: within the 5e-4 golden budget.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.models import centroid as JC
from rna_algos_tpu.models.mccaskill import _prob_finish
from rna_algos_tpu.ops import pallas_fold_prob as PP
from rna_algos_tpu.utils.io import read_fasta
from rna_algos_tpu.utils.output import fold_str

from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
from rna_algos_tpu_torch.cli import mccaskill as mc_cli
from rna_algos_tpu_torch.parallel.runner import kernel_bucket, pick_bucket

import chip_smoke

from .conftest import REPO_ROOT
from .test_reference_golden import _parse_triples
from .test_torch_turner_tables import TT_J

FASTA = str(REPO_ROOT / "assets" / "sampled_trnas.fa")
GOLDEN = REPO_ROOT / "tests" / "golden" / "c_baseline"
TIE_FILE, TIE_REC, TIE_PAIR = chip_smoke.TURNER_TIE


def _jax_prob_structure(seq, gamma):
    """Dot-bracket of ``seq`` at ``gamma`` through the JAX package's
    probability-space Turner path and its MEA fill and traceback."""
    n = len(seq)
    N = kernel_bucket(n, contra=False)
    arr = np.full((1, N), PSEUDO_BASE, np.int32)
    arr[0, :n] = seq
    ns = jnp.asarray([n], jnp.int32)
    bppo, _ = PP.mccaskill_turner_pallas_prob(jnp.asarray(arr), ns, TT_J,
                                              N=N, interpret=True)
    bpp = np.asarray(_prob_finish(bppo, ns, N)[0][0, :n, :n])
    Nc = pick_bucket(n)
    padded = np.zeros((Nc, Nc), np.float32)
    padded[:n, :n] = bpp
    M = np.asarray(JC.mea_fill(jnp.asarray(padded), gamma, N=Nc))
    pairs, _ = JC.traceback(M, padded, gamma, n)
    return fold_str(pairs, n), float(bpp[TIE_PAIR])


@pytest.fixture(scope="module")
def centroids(tmp_path_factory):
    out = tmp_path_factory.mktemp("turner_centroids")
    assert cf_cli.main(["-i", FASTA, "-o", str(out), "--device", "cpu"]) == 0
    return out


def test_turner_centroid_cli_17_files_byte_identical(centroids):
    ref_dir = GOLDEN / "centroid_turner"
    names = sorted(os.listdir(ref_dir))
    assert len(names) == 18 and names == sorted(os.listdir(centroids))
    for name in names:
        if name != TIE_FILE:
            assert (ref_dir / name).read_bytes() == (
                centroids / name).read_bytes(), name
    assert chip_smoke.turner_centroid_verdict(ref_dir, centroids) in (
        "identical", "tie")


def test_turner_centroid_tie_matches_jax_probability_path(centroids):
    golden = (GOLDEN / "centroid_turner" / TIE_FILE).read_text()
    lines = golden.split("\n")
    seq = read_fasta(FASTA)[TIE_REC].seq
    jax_rec, jax_bpp = _jax_prob_structure(seq, 1.0)
    # the JAX probability path sits below 1 at the tie and leaves the pair
    assert jax_bpp < 1.0 and jax_rec != lines[2 * TIE_REC + 1]
    lines[2 * TIE_REC + 1] = jax_rec
    expected = "\n".join(lines)
    got = (centroids / TIE_FILE).read_text()
    assert got in (golden, expected)
    # and what the JAX path gives is exactly the tie rule's one exception
    chip_smoke_dir = centroids.parent / "jax_tie"
    chip_smoke_dir.mkdir()
    for name in os.listdir(centroids):
        text = expected if name == TIE_FILE else (centroids / name).read_text()
        (chip_smoke_dir / name).write_text(text)
    assert chip_smoke.turner_centroid_verdict(
        GOLDEN / "centroid_turner", chip_smoke_dir) == "tie"


def test_turner_mccaskill_cli_within_golden_budget(tmp_path):
    out = tmp_path / "bpp.txt"
    assert mc_cli.main(["-i", FASTA, "-o", str(out), "--device", "cpu"]) == 0
    ref = _parse_triples((GOLDEN / "mccaskill_turner.txt").read_text())
    got = _parse_triples(out.read_text())
    assert set(ref) == set(got)
    worst = 0.0
    for rid, pairs in ref.items():
        for key, p in pairs.items():
            worst = max(worst, abs(p - got[rid].get(key, 0.0)))
    assert worst <= 5e-4, worst
    assert out.read_text().startswith(mc_cli.HEADER)
