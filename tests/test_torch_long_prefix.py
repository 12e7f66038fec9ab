"""The prefix-seeded tier: the port's CONTRA fold at bucket 1024, n = 600,
whose first run is seeded by a run over the first 512 bases
(``_estimate_ls0``), against the JAX package's
``mccaskill_contra_pallas_prob`` in interpret mode: bppo within 1e-4 and
ln_sigma within 2 ulp (the seed is ln(Z)/n of the prefix run, whose Z the
two packages sum in different orders, so its last float32 bit may round
either way; measured 1 ulp)."""

import numpy as np
import pytest

from .test_torch_long_fold_contra import TOL, fold_case


@pytest.fixture(scope="module")
def folded():
    return fold_case(True, 1024, 600, 1024)


def test_prefix_seeded_bppo_matches_jax(folded):
    (want, _), (got, _) = folded
    assert np.abs(got - want).max() <= TOL
    assert want.max() > 0.5


def test_prefix_seeded_ln_sigma_within_two_ulp(folded):
    (_, ls_w), (_, ls_t) = folded
    np.testing.assert_array_max_ulp(ls_t, ls_w, maxulp=2)
