"""The port's square BPPs vs the JAX XLA scan (``mccaskill_bpp_batch``) and
the tRNA goldens, within the repo's 5e-4 golden budget."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.params import build_fold_score_sets
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.models import mccaskill as JM

from rna_algos_tpu_torch.weights import contra_tables
from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.parallel.runner import FoldEngine, kernel_bucket

from .conftest import REPO_ROOT
from .test_torch_tables import make_batch
from .scan_cases import single_torch_thread  # noqa: F401  (fixture)

FSS = build_fold_score_sets()
BUDGET = 5e-4


def test_square_bpp_matches_xla_scan():
    N, B = 64, 4
    seqs, ns = make_batch(B, N, 31)
    want, want_presence = JM.mccaskill_bpp_batch(
        jnp.asarray(seqs), jnp.asarray(ns), S.contra_table_pytree(FSS), N=N,
        contra=True,
    )
    got, presence = TM.mccaskill_bpp_batch_auto(
        torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns),
        contra_tables(FSS, "cpu"), N=N, contra=True,
    )
    assert got.shape == (B, N, N) and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() < BUDGET


@pytest.fixture(scope="module")
def trna_folds(trna_records):
    engine = FoldEngine(uses_contra_model=True, device="cpu")
    return engine.fold_batch([r.seq for r in trna_records])


def test_trna_goldens(trna_records, trna_folds):
    gold = np.load(REPO_ROOT / "tests" / "golden" / "trna_bpps.npz")
    for k, rec in enumerate(trna_records):
        bpp, presence = trna_folds[k]
        n = len(rec.seq)
        assert kernel_bucket(n, contra=True) == 128
        assert bpp.shape == (n, n)
        assert np.abs(bpp - gold[f"rec{k}_contra"]).max() < BUDGET
        np.testing.assert_array_equal(presence, bpp > 0)


@pytest.mark.usefixtures("single_torch_thread")
def test_engine_rejects_off_slice_inputs(monkeypatch):
    """(Named when these inputs were refused.) Past the kernel tiers
    (CONTRA n > 2048, Turner n > 1024) the JAX package runs the XLA scan,
    and so does the port: the generic-N path at the JAX runner's bucket
    (2176, 1152). On the CPU at a small size: with no kernel tier taking
    the bucket, the engine folds a tRNA-length batch (bucket 128) through
    the plain scan, against the JAX XLA scan within the golden budget, with
    the same presence."""
    for contra, n, N in ((True, 2049, 2176), (False, 1025, 1152)):
        assert kernel_bucket(n, contra) == N
        assert not TM.pallas_available(contra, N)
    monkeypatch.setattr(TM, "pallas_available", lambda *a, **k: False)
    seqs, ns = make_batch(2, 96, 17)
    batch = [list(s[:n]) for s, n in zip(seqs, ns)]
    for contra in (True, False):
        engine = FoldEngine(uses_contra_model=contra, device="cpu")
        assert engine.contra is contra
        got = engine.fold_batch(batch)
        tbl = (S.contra_table_pytree(FSS) if contra
               else S.turner_table_pytree())
        padded = np.full((2, 128), 4, np.int32)
        for k, s in enumerate(batch):
            padded[k, :len(s)] = s
        want, want_presence = JM.mccaskill_bpp_batch(
            jnp.asarray(padded), jnp.asarray(ns), tbl, N=128, contra=contra)
        for k, s in enumerate(batch):
            n = len(s)
            bpp, presence = got[k]
            assert bpp.shape == (n, n)
            assert np.abs(bpp - np.asarray(want)[k, :n, :n]).max() < BUDGET
            np.testing.assert_array_equal(
                presence, np.asarray(want_presence)[k, :n, :n])


@pytest.mark.slow
@pytest.mark.parametrize("contra,n", [(True, 2049), (False, 1025)],
                         ids=["contra", "turner"])
def test_engine_folds_past_the_tiers(contra, n):
    """The records the port once refused fold on the CPU (the plain scan
    at bucket 2176 / 1152): finite BPPs of the record's shape, presence
    where the BPP is positive and some pairs present."""
    rng = np.random.default_rng(n)
    seq = list(rng.integers(0, 4, n))
    engine = FoldEngine(uses_contra_model=contra, device="cpu")
    if n > 2048:
        with pytest.warns(RuntimeWarning):
            ((bpp, presence),) = engine.fold_batch([seq])
    else:
        ((bpp, presence),) = engine.fold_batch([seq])
    assert bpp.shape == (n, n) and np.isfinite(bpp).all()
    assert presence.any() and (presence | (bpp == 0)).all()
    assert bpp.sum(axis=0).max() <= 1.0 + 1e-3


def test_engine_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        FoldEngine(uses_contra_model=True, device="cuda")
