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
from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.parallel.runner import kernel_bucket
from rna_algos_tpu_torch.cli import centroid_fold as cf_cli
from rna_algos_tpu_torch.cli import mccaskill as mc_cli

from .conftest import REPO_ROOT
from .test_reference_golden import _parse_triples
from .scan_cases import single_torch_thread  # noqa: F401  (fixture)

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
@pytest.mark.usefixtures("single_torch_thread")
def test_cli_refuses_what_is_not_ported(tmp_path, cli, monkeypatch):
    """(Named when these records were refused.) Under parity past 256 (the
    400-nt record: bucket 512) and past the kernel tiers (CONTRA n > 2048,
    Turner n > 1024) the JAX package folds with the XLA scan, and so does
    the port (the generic-N path, K20/K21 on the card). On the CPU at a
    small size: with no kernel tier taking a bucket, the CLIs fold the tRNA
    fixture through the plain scan under parity and match the C baseline as
    the JAX scan does: the same key sets within 5e-4, the centroid files
    byte for byte."""
    for n, contra, mode, N in ((400, True, "parity", 512),
                               (2052, True, "exact", 2176),
                               (1028, False, "exact", 1152)):
        assert kernel_bucket(n, contra, mode) == N
        assert not TM.pallas_available(contra, N, mode)
    monkeypatch.setattr(TM, "pallas_available", lambda *a, **k: False)
    out = tmp_path / "o"
    flags = ["-i", FASTA, "-c", "--device", "cpu", "--numerics", "parity"]
    if cli is mc_cli:
        assert cli.main(flags + ["-o", str(out)]) == 0
        ref = _parse_triples((GOLDEN / "c_baseline" / "mccaskill_contra.txt")
                             .read_text())
        got = _parse_triples(out.read_text())
        assert set(ref) == set(got)
        worst = 0.0
        for rid, pairs in ref.items():
            assert set(pairs) == set(got[rid]), rid
            worst = max([worst] + [abs(p - got[rid][k])
                                   for k, p in pairs.items()])
        assert worst <= 5e-4, worst
    else:
        assert cli.main(flags + ["-o", str(out)]) == 0
        ref_dir = GOLDEN / "c_baseline" / "centroid_contra"
        names = sorted(os.listdir(ref_dir))
        assert names == sorted(os.listdir(out))
        for name in names:
            assert (ref_dir / name).read_bytes() == (out / name).read_bytes()


@pytest.mark.slow
@pytest.mark.parametrize("cli", [cf_cli, mc_cli])
def test_cli_folds_past_the_tiers(tmp_path, cli):
    """The records the CLIs once refused fold on the CPU: a 400-nt record
    under parity, a 1,028-nt Turner and a 2,052-nt CONTRA record (random,
    seeded; the plain scan at buckets 512, 1152 and 2176).  The BPPs lie in
    [0, 1 + 1e-2]: the cubic log-add drifts ~5e-3 from float64 at these
    lengths (chip_smoke.TOL_GOLDEN_SCAN)."""
    cases = ((["-c", "--numerics", "parity"], 400), ([], 1028),
             (["-c"], 2052))
    for flags, n in cases:
        rng = np.random.default_rng(n)
        fa = tmp_path / f"n{n}.fa"
        fa.write_text(f">n{n}\n" + "".join(rng.choice(list("ACGU"), n))
                      + "\n")
        out = tmp_path / f"o{n}"
        assert cli.main(["-i", str(fa), "-o", str(out), "--device", "cpu",
                         *flags]) == 0
        if cli is mc_cli:
            (pairs,) = _parse_triples(out.read_text()).values()
            assert pairs and all(0 <= p <= 1 + 1e-2 for p in pairs.values())
        else:
            assert len(os.listdir(out)) > 0
