"""Centroid fill, traceback and the two CLIs of the port vs the JAX package
and the C-baseline goldens: the fill and the traceback are bitwise, the
centroid files byte-identical."""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.models import centroid as JC

from rna_algos_tpu_torch.models import centroid as TC
from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
from rna_algos_tpu_torch.cli import mccaskill as mc_cli

from .conftest import REPO_ROOT
from .test_reference_golden import _parse_triples

FASTA = str(REPO_ROOT / "assets" / "sampled_trnas.fa")
GOLDEN = REPO_ROOT / "tests" / "golden"
GAMMAS = (0.0078125, 1.0, 256.0)
N = 96


@pytest.fixture(scope="module")
def fills():
    gold = np.load(GOLDEN / "trna_bpps.npz")
    out = []
    for k in (0, 5):
        bpp = gold[f"rec{k}_contra"].astype(np.float32)
        n = bpp.shape[0]
        padded = np.zeros((N, N), np.float32)
        padded[:n, :n] = bpp
        want = np.stack([np.asarray(JC.mea_fill(jnp.asarray(padded), g, N=N))
                         for g in GAMMAS])
        got = TC.mea_fill_gammas(torch.as_tensor(padded), GAMMAS, N).numpy()
        out.append((padded, n, want, got))
    return out


def test_mea_fill_bitwise(fills):
    for _padded, _n, want, got in fills:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_traceback_pairs_identical(fills):
    for padded, n, want, got in fills:
        for g, Mj, Mt in zip(GAMMAS, want, got):
            pj, aj = JC.traceback(Mj, padded, g, n)
            pt, at = TC.traceback(Mt, padded, g, n)
            assert pj == pt and aj == at
            if g == max(GAMMAS):
                assert len(pt) > 0


def test_centroid_fold_matches_jax(fills):
    for padded, n, _want, _got in fills:
        got = TC.centroid_fold(torch.as_tensor(padded), n, 4.0)
        assert got == JC.centroid_fold(padded, n, 4.0)
        assert len(got[0]) > 0


def test_centroid_cli_matches_golden_bytes(tmp_path):
    out = tmp_path / "centroids"
    assert cf_cli.main(["-i", FASTA, "-o", str(out), "-c",
                        "--device", "cpu"]) == 0
    ref_dir = GOLDEN / "c_baseline" / "centroid_contra"
    names = sorted(os.listdir(ref_dir))
    assert len(names) == 18
    assert names == sorted(os.listdir(out))
    for name in names:
        assert (ref_dir / name).read_bytes() == (out / name).read_bytes(), name


def test_mccaskill_cli_within_golden_budget(tmp_path):
    out = tmp_path / "bpp.txt"
    assert mc_cli.main(["-i", FASTA, "-o", str(out), "-c",
                        "--device", "cpu"]) == 0
    ref = _parse_triples((GOLDEN / "c_baseline" / "mccaskill_contra.txt")
                         .read_text())
    got = _parse_triples(out.read_text())
    assert set(ref) == set(got)
    worst = 0.0
    for rid, pairs in ref.items():
        for key, p in pairs.items():
            # the probability path may differ from the cubic golden in
            # presence only (values the reference flushes to zero)
            worst = max(worst, abs(p - got[rid].get(key, 0.0)))
    assert worst <= 5e-4, worst
    assert out.read_text().startswith(mc_cli.HEADER)


@pytest.mark.parametrize("cli", [cf_cli, mc_cli])
def test_cli_refuses_what_is_not_ported(tmp_path, cli):
    out = str(tmp_path / "o")
    # under parity the JAX package folds buckets past 256 with the XLA
    # scan, which is not ported
    fa400 = tmp_path / "n400.fa"
    fa400.write_text(">n400\n" + "GCAU" * 100 + "\n")
    with pytest.raises(NotImplementedError, match="A10"):
        cli.main(["-i", str(fa400), "-o", out, "-c", "--device", "cpu",
                  "--numerics", "parity"])
    # past the kernel tiers (CONTRA n > 2048, Turner n > 1024) the JAX
    # package runs the XLA scan, which is not ported
    for model, n in ((["-c"], 2052), ([], 1028)):
        long_fa = tmp_path / "long.fa"
        long_fa.write_text(">long\n" + "GCAU" * (n // 4) + "\n")
        with pytest.raises(NotImplementedError, match="A10"):
            cli.main(["-i", str(long_fa), "-o", out, "--device", "cpu",
                      *model])
