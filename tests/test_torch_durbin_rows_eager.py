"""The port's plain row scan (``models.durbin.durbin_match_probs_batch``,
K22's plain version) bitwise against the JAX row scan's body
(``_durbin_match_probs_body``) run eagerly under ``jax.disable_jit``: each
add and multiply rounded on its own in both, the same cubics, the same
associative-scan tree.  Under "exact" and "parity" bit for bit; under
"fast" within TOL_FAST_EAGER (torch's and XLA's logaddexp and exp).
Rectangular and square buckets, lengths from 2 (no inner cell) to the
bucket."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.models import durbin as JD

from .test_torch_durbin_rows import (SCJ, one_torch_thread,  # noqa: F401
                                     port_probs, random_rect)

TOL_FAST_EAGER = 1e-6


def eager_jax_probs(s1, n1, s2, n2, N1, N2, mode):
    with jax.disable_jit(), JN.force_mode(mode):
        return np.stack([np.asarray(JD._durbin_match_probs_body(
            jnp.asarray(s1[p]), jnp.int32(n1[p]), jnp.asarray(s2[p]),
            jnp.int32(n2[p]), SCJ, N1, N2)) for p in range(len(n1))])


@pytest.mark.parametrize("mode", ["exact", "parity", "fast"])
@pytest.mark.parametrize("N1,N2", [(12, 20), (20, 12), (16, 16)])
def test_plain_matches_eager_jax(N1, N2, mode):
    pairs = random_rect(N1, N2, 4, N1 * 100 + N2)
    got = port_probs(*pairs, N1, N2, mode)
    want = eager_jax_probs(*pairs, N1, N2, mode)
    assert got.shape == (4, N1, N2) and (got[1] == 0).all()
    assert got.max() > 0.05
    if mode == "fast":
        assert np.abs(got - want).max() <= TOL_FAST_EAGER
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
