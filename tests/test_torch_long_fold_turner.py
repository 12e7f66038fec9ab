"""The port's whole long-tier Turner fold against the JAX package's
``mccaskill_turner_pallas_prob`` (interpret mode) at bucket 512, n = 400:
bppo within 1e-4 and ln_sigma array-equal (retries seeded at 0.5)."""

import numpy as np
import pytest

from .test_torch_long_fold_contra import TOL, fold_case


@pytest.fixture(scope="module")
def folded():
    return fold_case(False, 512, 400, 513)


def test_long_turner_bppo_matches_jax(folded):
    (want, _), (got, _) = folded
    assert np.abs(got - want).max() <= TOL
    assert want.max() > 0.5


def test_long_turner_ln_sigma_array_equal(folded):
    (_, ls_w), (_, ls_t) = folded
    np.testing.assert_array_equal(ls_t, ls_w)
