"""The port's whole CONTRA fold vs the JAX stacked path
(``mccaskill_contra_pallas_prob8`` in interpret mode): bppo within 1e-4
(the window precision note of test_torch_fold.py, accumulated over the
inside and outside passes) and ``ln_sigma`` array-equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.params import build_fold_score_sets
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.ops import pallas_fold_prob8 as P8

from rna_algos_tpu_torch.weights import contra_tables
from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as TP8

from .test_torch_tables import make_batch

N = 64
FSS = build_fold_score_sets()


@pytest.fixture(scope="module")
def folded():
    B = P8.G   # one stacked group
    seqs, ns = make_batch(B, N, 21)
    want, ls_w = P8.mccaskill_contra_pallas_prob8(
        jnp.asarray(seqs), jnp.asarray(ns), S.contra_table_pytree(FSS), N=N,
        interpret=True,
    )
    ts = torch.as_tensor(seqs, dtype=torch.int64)
    tn = torch.as_tensor(ns)
    got, ls_g = TP8.mccaskill_contra_prob(ts, tn, contra_tables(FSS, "cpu"), N)
    return dict(ns=ns, tn=tn, want=np.asarray(want), ls_w=np.asarray(ls_w),
                got=got, ls_g=ls_g)


def test_bppo_matches_stacked_interpret(folded):
    err = np.abs(folded["got"].numpy() - folded["want"]).max()
    assert err < 1e-4, err


def test_ln_sigma_array_equal(folded):
    np.testing.assert_array_equal(folded["ls_w"], folded["ls_g"].numpy())


def test_square_bpp_zero_past_length(folded):
    bpp, presence = TM._prob_finish(folded["got"], folded["tn"], N)
    bpp = bpp.numpy()
    for k, n in enumerate(folded["ns"]):
        assert (bpp[k, n:, :] == 0).all() and (bpp[k, :, n:] == 0).all()
        assert (np.tril(bpp[k]) == 0).all()
        assert np.isfinite(bpp[k]).all() and bpp[k].max() <= 1.0 + 1e-3
    np.testing.assert_array_equal(presence.numpy(), bpp > 0)
    # bppo rows (spans) at or past each length are exact zeros
    for k, n in enumerate(folded["ns"]):
        assert (folded["got"][k, n:].numpy() == 0).all()
