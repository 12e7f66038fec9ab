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


def test_engine_rejects_off_slice_inputs():
    """Past the kernel tiers (CONTRA n > 2048, Turner n > 1024) the JAX
    package runs the XLA scan, which is not ported (ROADMAP A10)."""
    for contra, n in ((True, 2049), (False, 1025)):
        engine = FoldEngine(uses_contra_model=contra, device="cpu")
        assert engine.contra is contra
        with pytest.raises(NotImplementedError, match="A10"):
            engine.fold_batch([[0] * 80, [0] * n])


def test_engine_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        FoldEngine(uses_contra_model=True, device="cuda")
