"""The port's Durbin path past the wavefront buckets on the CPU: the row
scan (kernel K22's plain version) through ``AlignEngine`` and
``cli.durbin``, against the JAX engine and CLI, whose CPU runs take the
XLA row scan for every pair.

Tolerances: the port's plain row scan rounds every add and multiply on its
own; the jitted JAX scan contracts the cubic's Horner steps into fused
multiply-adds, a few ulps a log-add (TOL_JIT_LONG; measured 1.9e-5 at
bucket (384, 384) and 4.5e-6 at (64, 384)).  The CLI's triples within the 5e-4 golden budget.
"""

import itertools

import numpy as np
import pytest

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.cli import durbin as j_cli
from rna_algos_tpu.parallel.runner import AlignEngine as JAlignEngine

from rna_algos_tpu_torch.cli import durbin as du_cli
from rna_algos_tpu_torch.constants import PSEUDO_BASE
from rna_algos_tpu_torch.parallel.runner import AlignEngine, align_bucket

from .test_reference_golden import _parse_triples
from .test_torch_durbin_rows import one_torch_thread  # noqa: F401

TOL_JIT_LONG = 5e-5
LONG = 300


def _wrapped(seqs):
    return [np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]]).astype(np.int32)
            for s in seqs]


@pytest.fixture(scope="module")
def mix():
    """Two short sequences and two of ~300 nt; a short pair, a long pair
    and a short x long pair, three buckets."""
    rng = np.random.default_rng(300)
    seqs = _wrapped([rng.integers(0, 4, n) for n in (40, 55, LONG, LONG - 7)])
    pairs = [(0, 1), (2, 3), (0, 2)]
    return seqs, pairs


def test_engine_mix_crops_and_matches_alone(mix):
    seqs, pairs = mix
    assert [align_bucket(len(seqs[a]), len(seqs[b])) for a, b in pairs] == [
        (64, 64), (384, 384), (64, 384)]
    engine = AlignEngine(device="cpu")
    got = engine.match_probs_pairs(seqs, pairs)
    assert list(got) == pairs
    for (a, b) in pairs:
        mat = got[(a, b)]
        assert mat.shape == (len(seqs[a]), len(seqs[b]))
        assert np.isfinite(mat).all() and mat.max() > 0.05
        alone = engine.match_probs_pairs(seqs, [(a, b)])[(a, b)]
        np.testing.assert_array_equal(mat, alone)


@pytest.mark.parametrize("numerics", ["exact", "parity"])
def test_engine_long_pairs_match_jax_engine(mix, numerics):
    """The pairs with a 300-nt sequence (the row scan in both packages)
    against the JAX AlignEngine on the CPU."""
    seqs, pairs = mix
    longs = [p for p in pairs if max(len(seqs[a]) for a in p) > 256]
    got = AlignEngine(device="cpu", numerics=numerics).match_probs_pairs(
        seqs, longs)
    with JN.force_mode(numerics):
        want = JAlignEngine().match_probs_pairs(seqs, longs)
    for key in longs:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        assert np.abs(got[key] - w).max() <= TOL_JIT_LONG
        np.testing.assert_array_equal(got[key] > 0, w > 0)


def test_cli_parity_long_record_matches_jax_cli(tmp_path, mix):
    """``cli.durbin --device cpu --numerics parity`` on a FASTA with two
    ~300-nt records (pairs at buckets (64, 384) and (384, 384)) against
    the JAX CLI: the same key set, probabilities within 5e-4."""
    seqs, _ = mix
    fasta = tmp_path / "long.fa"
    fasta.write_text("".join(
        f">r{k}\n" + "".join("ACGU"[b] for b in s[1:-1]) + "\n"
        for k, s in enumerate(seqs[1:])))
    du_cli.main(["-i", str(fasta), "-o", str(tmp_path / "t.txt"),
                 "--device", "cpu", "--numerics", "parity"])
    mode = JN.get_mode()
    try:
        j_cli.main(["-i", str(fasta), "-o", str(tmp_path / "j.txt"),
                    "--numerics", "parity"])
    finally:
        JN.set_mode(mode)
    got = _parse_triples((tmp_path / "t.txt").read_text())
    want = _parse_triples((tmp_path / "j.txt").read_text())
    assert list(got) == list(want) == ["0,1", "0,2", "1,2"]
    for rid in want:
        assert set(got[rid]) == set(want[rid])
        assert max(abs(p - got[rid][k]) for k, p in want[rid].items()) <= 5e-4
    assert max(i for i, _ in got["1,2"]) > 250   # the long records' rows
    assert len(list(itertools.chain(*got.values()))) > 600
