"""The port's whole Durbin paths on the CPU against the JAX package's:
K14's (both passes, the finish and the retry loop) within 1e-6 of the JAX
probability kernel in interpret mode with every pair's ln_sigma equal, and
within 5e-4 of the JAX row scan; K15's within 1e-5 of the JAX log-space
kernel under parity numerics."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.models.durbin import durbin_match_probs_batch
from rna_algos_tpu.ops import pallas_align as JPA
from rna_algos_tpu.ops import pallas_align_prob as JPAP
from rna_algos_tpu.ops import pallas_fold_prob as JPP

from rna_algos_tpu_torch.ops import pallas_align as PA
from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
from rna_algos_tpu_torch.weights import align_tables

from .test_torch_durbin_kernels import (LANES, SC, jax_scores, random_pairs,
                                        to_jax, to_torch)


def _jax_prob_ls(s1, n1, s2, n2, sc, N):
    """(probs, ln_sigma) of the JAX probability path in interpret mode:
    its own body and retry loop, on the 128-lane padded batch."""
    P = s1.shape[0]

    def pad(x, fill):
        return jnp.concatenate(
            [x, jnp.full((LANES - P,) + x.shape[1:], fill, x.dtype)])

    a1, b1 = pad(jnp.asarray(s1), PSEUDO_BASE), pad(jnp.asarray(n1), 3)
    a2, b2 = pad(jnp.asarray(s2), PSEUDO_BASE), pad(jnp.asarray(n2), 3)

    @jax.jit
    def go(a1, b1, a2, b2, scj):
        # the seed and the loop of durbin_match_probs_batch_pallas_prob
        ls0 = 0.5 * (jnp.mean(scj["match_scores"][:4, :4])
                     + scj["match2match_score"])
        return JPP._retrying(
            lambda ls: JPAP._durbin_prob_body(a1, b1, a2, b2, scj, ls, N,
                                              True), LANES, ls0=ls0)

    probs, ls = go(a1, b1, a2, b2, jax_scores(sc))
    return np.asarray(probs)[:P], np.asarray(ls)[:P]


def port_prob_ls(s1, n1, s2, n2, sc, N):
    """(probs, ln_sigma, runs) of the port's probability path on the CPU."""
    seen = []
    orig = PP._retrying

    def retrying(run, ns, **kw):
        calls = []

        def counted(ls):
            calls.append(1)
            return run(ls)

        out = orig(counted, ns, **kw)
        seen.append((out[1], len(calls)))
        return out

    PP._retrying = retrying
    try:
        probs = PAP.durbin_match_probs_batch_pallas_prob(
            *to_torch(s1, n1, s2, n2), align_tables(sc, "cpu"), N)
    finally:
        PP._retrying = orig
    (ls, runs), = seen
    return probs.numpy(), ls.numpy(), runs


def steep_scores():
    """Scores whose seed (mean match score) is far below an identical
    pair's growth: a match on the diagonal scores +3, off it -3."""
    sc = {k: np.copy(v) for k, v in SC.items()}
    ms = np.full((5, 5), -3.0, np.float32)
    np.fill_diagonal(ms, 3.0)
    ms[4, :] = ms[:, 4] = 0.0
    sc["match_scores"] = ms
    return sc


@pytest.mark.parametrize("case", ["random", "retry_walk"])
def test_prob_path_matches_jax(case):
    """K14's whole path (both passes, finish, retries) vs the JAX kernel
    path, with equal ln_sigma; the retry case's identical pairs overflow
    on the first run and walk (0.9 steps, halving on a flip) into band."""
    rng = np.random.default_rng(11)
    if case == "random":
        sc, pairs, N = SC, random_pairs(rng, 6, 32, same=1), 32
    else:
        sc, pairs, N = steep_scores(), random_pairs(rng, 5, 32, 20, 30,
                                                    same=3), 32
    got, ls, runs = port_prob_ls(*pairs, sc, N)
    want, ls_j = _jax_prob_ls(*pairs, sc, N)
    np.testing.assert_array_equal(ls, ls_j)
    assert np.abs(got - want).max() <= 1e-6
    assert (got >= -1e-3).all() and (got < 1.001).all()
    seed = np.float32(PAP.ln_sigma_seed(align_tables(sc, "cpu")))
    if case == "retry_walk":
        assert runs >= 3 and (ls != seed).sum() >= 3
    else:
        assert runs == 1 and (ls == seed).all()
        s1, n1, s2, n2 = to_jax(*pairs)
        scan = np.asarray(durbin_match_probs_batch(
            s1, n1, s2, n2, jax_scores(sc), N1=N, N2=N))
        assert np.abs(got - scan).max() < 5e-4


def test_log_path_matches_jax():
    """K15's whole path vs the JAX log-space kernel under parity."""
    pairs = random_pairs(np.random.default_rng(5), 6, 32, same=1)
    got = PA.durbin_match_probs_batch_pallas(
        *to_torch(pairs[0], pairs[1], pairs[2], pairs[3]),
        align_tables(SC, "cpu"), 32, numerics="parity").numpy()
    with JN.force_mode("parity"):
        want = np.asarray(JPA.durbin_match_probs_batch_pallas(
            *to_jax(*pairs), jax_scores(SC), N=32, interpret=True))
    assert np.abs(got - want).max() <= 1e-5
    assert (got >= 0).all() and (got < 1.001).all()


def test_log_fast_path_matches_jax():
    """K15's whole path in fast mode (its fast instance, ``torch.exp`` in
    the finish) vs the JAX log-space kernel traced under "fast", within
    1e-5 (measured: 1.6e-7)."""
    pairs = random_pairs(np.random.default_rng(6), 6, 32, same=1)
    got = PA.durbin_match_probs_batch_pallas(
        *to_torch(pairs[0], pairs[1], pairs[2], pairs[3]),
        align_tables(SC, "cpu"), 32, numerics="fast").numpy()
    with JN.force_mode("fast"):
        want = np.asarray(JPA.durbin_match_probs_batch_pallas(
            *to_jax(*pairs), jax_scores(SC), N=32, interpret=True))
    assert np.abs(got - want).max() <= 1e-5
    assert (got >= 0).all() and (got < 1.001).all() and got.max() > 0.05
