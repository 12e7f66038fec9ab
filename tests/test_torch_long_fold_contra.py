"""The port's whole long-tier CONTRA fold (``pallas_fold_long``, plain
versions on CPU tensors) against the JAX package's
``mccaskill_contra_pallas_prob`` (the span-chunked kernels in interpret
mode, its rescale retries) at bucket 512, n = 400: bppo within 1e-4 and
ln_sigma array-equal (the window precision note of test_torch_fold.py,
accumulated over the inside and outside passes)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.ops import pallas_fold_prob as PP

from rna_algos_tpu_torch.ops import pallas_fold_long as TPL

from .test_torch_fold import CT, TT
from .test_torch_long_contra import one_seq
from .test_torch_turner_tables import TT as TT_TURNER, TT_J

TOL = 1e-4


def fold_case(contra, N, n, seed):
    """(JAX (bppo, ln_sigma), port (bppo, ln_sigma)) of one sequence."""
    seqs, ns = one_seq(n, N, seed)
    js, jn = jnp.asarray(seqs), jnp.asarray(ns)
    ts, tn = torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns)
    if contra:
        want = PP.mccaskill_contra_pallas_prob(js, jn, CT, N=N, interpret=True)
        got = TPL.mccaskill_contra_pallas_prob(ts, tn, TT, N=N)
    else:
        want = PP.mccaskill_turner_pallas_prob(js, jn, TT_J, N=N,
                                               interpret=True)
        got = TPL.mccaskill_turner_pallas_prob(ts, tn, TT_TURNER, N=N)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.fixture(scope="module")
def folded():
    return fold_case(True, 512, 400, 512)


def test_long_contra_bppo_matches_jax(folded):
    (want, _), (got, _) = folded
    assert np.abs(got - want).max() <= TOL
    assert want.max() > 0.5


def test_long_contra_ln_sigma_array_equal(folded):
    (_, ls_w), (_, ls_t) = folded
    np.testing.assert_array_equal(ls_t, ls_w)
