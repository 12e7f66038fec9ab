"""The long tier's Turner kernels K12 (inside) and K13 (outside): the port's
fixed-scale run body on CPU tensors (the wrappers' plain versions) against
the JAX ``_turner_prob_run_body_chunked`` (the span-chunked Pallas kernels
in interpret mode) at N = 128, R = 64 (two chunks), B = 1, n = 112, with
ln_sigma equal: bppo within 1e-4 absolute and the scaled partition function
(the inside pass's ext(0, n - 1)) within rtol 1e-4."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.ops import pallas_fold_prob as PP

from rna_algos_tpu_torch.ops import pallas_fold_long as TPL

from .test_torch_long_contra import one_seq
from .test_torch_turner_tables import TT, TT_J

N, R, n = 128, 64, 112


@pytest.fixture(scope="module")
def runs():
    seqs, ns = one_seq(n, N, 91)
    ls = np.float32([0.45])
    want = PP._turner_prob_run_body_chunked(
        jnp.asarray(seqs), jnp.asarray(ns), TT_J, jnp.asarray(ls), N, R, True)
    got = TPL._turner_run_body(torch.as_tensor(seqs, dtype=torch.int64),
                               torch.as_tensor(ns), TT, torch.as_tensor(ls), N)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def test_long_turner_bppo_matches_jax_chunked(runs):
    (want, _), (got, _) = runs
    assert np.abs(got - want).max() <= 1e-4
    assert want.max() > 0.5


def test_long_turner_glob_matches_jax_chunked(runs):
    (_, want), (_, got) = runs
    np.testing.assert_allclose(got, want, rtol=1e-4)
