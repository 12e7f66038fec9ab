"""The port's whole Turner fold vs the JAX stacked path
(``mccaskill_turner_pallas_prob8`` in interpret mode, one group of
``P8.G``): bppo within 1e-4 (the window precision note of
test_torch_turner_fold.py, accumulated over both passes) and ``ln_sigma``
array-equal; and the tRNA BPPs through ``FoldEngine`` within the 5e-4
golden budget of ``tests/golden/trna_bpps.npz``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.ops import pallas_fold_prob as PP
from rna_algos_tpu.ops import pallas_fold_prob8 as P8

from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as TP8
from rna_algos_tpu_torch.parallel.runner import FoldEngine, kernel_bucket

from .conftest import REPO_ROOT
from .test_torch_turner_tables import TT, TT_J, turner_batch

N = 64
BUDGET = 5e-4


@pytest.fixture(scope="module")
def folded():
    B = P8.G   # one stacked group
    seqs, ns = turner_batch(B, N, 61)
    want, ls_w = P8.mccaskill_turner_pallas_prob8(
        jnp.asarray(seqs), jnp.asarray(ns), TT_J, N=N, interpret=True,
    )
    tn = torch.as_tensor(ns)
    got, ls_g = TP8.mccaskill_turner_prob(
        torch.as_tensor(seqs, dtype=torch.int64), tn, TT, N
    )
    return dict(ns=ns, tn=tn, want=np.asarray(want), ls_w=np.asarray(ls_w),
                got=got, ls_g=ls_g)


def test_turner_bppo_matches_stacked_interpret(folded):
    err = np.abs(folded["got"].numpy() - folded["want"]).max()
    assert err < 1e-4, err
    assert folded["want"].max() > 0.5


def test_turner_ln_sigma_array_equal(folded):
    np.testing.assert_array_equal(folded["ls_w"], folded["ls_g"].numpy())
    # seeded at the Turner scale, and these lengths need no re-run
    assert (folded["ls_g"].numpy() == np.float32(PP.LN_SIGMA0_TURNER)).all()


def test_turner_square_bpp_zero_past_length(folded):
    bpp, presence = TM._prob_finish(folded["got"], folded["tn"], N)
    bpp = bpp.numpy()
    for k, n in enumerate(folded["ns"]):
        assert (bpp[k, n:, :] == 0).all() and (bpp[k, :, n:] == 0).all()
        assert (np.tril(bpp[k]) == 0).all()
        assert np.isfinite(bpp[k]).all() and bpp[k].max() <= 1.0 + 1e-3
        assert (folded["got"][k, n:].numpy() == 0).all()
    np.testing.assert_array_equal(presence.numpy(), bpp > 0)


def test_turner_trna_goldens(trna_records):
    engine = FoldEngine(uses_contra_model=False, device="cpu")
    folds = engine.fold_batch([r.seq for r in trna_records])
    gold = np.load(REPO_ROOT / "tests" / "golden" / "trna_bpps.npz")
    for k, rec in enumerate(trna_records):
        bpp, presence = folds[k]
        n = len(rec.seq)
        assert kernel_bucket(n, contra=False) == 128
        assert bpp.shape == (n, n) and bpp.dtype == np.float32
        assert np.abs(bpp - gold[f"rec{k}_turner"]).max() < BUDGET
        np.testing.assert_array_equal(presence, bpp > 0)
