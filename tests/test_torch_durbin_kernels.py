"""Plain versions of kernels K14 (scaled probabilities) and K15 (log
space) against the JAX pair-HMM Pallas kernels in interpret mode, one
pass at a time, and the no-jump retry walk.

Both packages get the same tables: K14 at a fixed ln_sigma within 1e-6
relative (1e-30 absolute floor: XLA flushes subnormals to zero, torch
keeps them).  K15 within 1e-4 on log values, -inf exactly where JAX has
it: jitted XLA contracts the cubic's Horner steps into fused
multiply-adds and the port (like the reference) does not, a few ulps on
each log-add.  The whole paths are in ``test_torch_durbin_paths.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.ops import pallas_align as JPA
from rna_algos_tpu.ops import pallas_align_prob as JPAP
from rna_algos_tpu.ops import pallas_fold_prob as JPP
from rna_algos_tpu.params import build_align_scores

from rna_algos_tpu_torch.ops import pallas_align as PA
from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
from rna_algos_tpu_torch.weights import align_tables

from .test_torch_fold import _synthetic_run

SC = build_align_scores()
LANES = JPA.LANES


def random_pairs(rng, P, N, lo=5, hi=28, same=0):
    """(s1, n1, s2, n2) numpy: P sentinel-wrapped pairs of lo..hi-1 bases,
    the last ``same`` of them a sequence paired with itself."""
    s1 = np.full((P, N), PSEUDO_BASE, np.int32)
    s2 = np.full((P, N), PSEUDO_BASE, np.int32)
    n1 = np.zeros(P, np.int32)
    n2 = np.zeros(P, np.int32)
    for p in range(P):
        a = int(rng.integers(lo, hi))
        b = a if p >= P - same else int(rng.integers(lo, hi))
        s1[p, 1:a + 1] = rng.integers(0, 4, a)
        s2[p, 1:b + 1] = s1[p, 1:a + 1] if p >= P - same else rng.integers(0, 4, b)
        n1[p], n2[p] = a + 2, b + 2
    return s1, n1, s2, n2


def to_jax(*xs):
    return [jnp.asarray(x) for x in xs]


def to_torch(*xs):
    return [torch.as_tensor(x) for x in xs]


def jax_scores(sc):
    return {k: jnp.asarray(v) for k, v in sc.items()}


def _jax_pass(s1, n1, s2, n2, ms, ins, scal, N, backward, prob,
              mode="parity"):
    """One pass of the JAX kernel on the port's tables (ms (P, 5, 5), ins
    (P, 5), scal (5,), numpy), padded to one 128-lane block, traced under
    the numerics ``mode``: (out (P, N, N), corner (P, 3)) in the port's
    contract."""
    P = s1.shape[0]
    G = 1

    def pad(x, fill):
        return np.concatenate(
            [x, np.full((LANES - P,) + x.shape[1:], fill, x.dtype)])

    S1, S2 = pad(s1, PSEUDO_BASE), pad(s2, PSEUDO_BASE)
    N1, N2 = pad(n1, 3), pad(n2, 3)
    MS, INS = pad(ms, 0.0), pad(ins, 0.0)
    if backward:
        S1 = np.asarray(JPA._reverse_seqs(jnp.asarray(S1), jnp.asarray(N1), N))
        S2 = np.asarray(JPA._reverse_seqs(jnp.asarray(S2), jnp.asarray(N2), N))
    rows = np.arange(LANES)[:, None]
    p1 = np.transpose(MS[rows, S1], (0, 2, 1)).reshape(LANES, 5 * N)
    blocks = [JPA._to_blocks(jnp.asarray(x), G) for x in (
        p1, INS[rows, S1], S2.astype(np.float32), INS[rows, S2])]
    NN = np.zeros((LANES, 8), np.float32)
    NN[:, 0], NN[:, 1] = N1, N2
    sc8 = np.zeros(8, np.float32)
    sc8[:5] = scal
    call = JPAP._pairhmm_prob_call if prob else JPA._pairhmm_call
    with JN.force_mode(mode):
        out, corn = call(jnp.asarray(sc8)[None, None],
                         JPA._to_blocks(jnp.asarray(NN), G), blocks[0],
                         blocks[1], blocks[2], blocks[3], G, N, backward, True)
    fill = 0.0 if prob else -np.inf
    M = np.asarray(JPA._unskew(out.reshape(G, 2 * N, N, LANES), N,
                               fill=fill)).reshape(LANES, N, N)[:P]
    corner = np.asarray(corn)[0, :3, :P].T
    if not backward:
        return M, corner
    ssum = np.full((P, N, N), fill, np.float32)
    for p in range(P):
        a, b = n1[p] - 1, n2[p] - 1
        ssum[p, :a, :b] = M[p, :a, :b][::-1, ::-1]
    return ssum, corner


def _port_tables(prob, ls, P, backward):
    at = align_tables(SC, "cpu")
    zero = torch.zeros(())
    init = (zero, zero) if backward else (at["init_match_score"],
                                          at["init_insert_score"])
    scal = PA._scalars(at, *init)
    if prob:
        ms = torch.exp(at["match_scores"][None] - 2.0 * ls[:, None, None])
        ins = torch.exp(at["insert_scores"][None] - ls[:, None])
        scal = torch.exp(scal)
    else:
        ms = at["match_scores"].expand(P, 5, 5).contiguous()
        ins = at["insert_scores"].expand(P, 5).contiguous()
    return ms, ins, scal


@pytest.fixture(scope="module")
def pairs32():
    return random_pairs(np.random.default_rng(3), 6, 32, same=1)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("prob", [True, False], ids=["K14", "K15"])
def test_pass_matches_jax_kernel(pairs32, prob, backward):
    s1, n1, s2, n2 = pairs32
    P, N = s1.shape
    ls = torch.full((P,), 1.15)
    ms, ins, scal = _port_tables(prob, ls, P, backward)
    fn = PAP.pairhmm_prob if prob else PA.pairhmm_log
    got, gcorn = fn(*to_torch(s1, s2, n1, n2), ms, ins, scal, backward)
    want, wcorn = _jax_pass(s1, n1, s2, n2, ms.numpy(), ins.numpy(),
                            scal.numpy(), N, backward, prob)
    got = got.numpy()
    if prob:
        assert (got >= 0).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
        if not backward:
            np.testing.assert_allclose(gcorn.numpy(), wcorn, rtol=1e-6)
    else:
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        assert fin.sum() > 1000
        assert np.abs(got[fin] - want[fin]).max() <= 1e-4
        if not backward:
            assert np.abs(gcorn.numpy() - wcorn).max() <= 1e-4


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_log_fast_pass_matches_jax_kernel(pairs32, backward):
    """K15's fast instance (the plain log wavefront with ``torch.logaddexp``)
    against the JAX log kernel traced under "fast" in interpret mode: the
    -inf pattern identical, finite cells within 1e-4 (measured: 3.8e-6 on
    log values up to ~60; torch's and XLA's logaddexp round differently)."""
    s1, n1, s2, n2 = pairs32
    P, N = s1.shape
    ms, ins, scal = _port_tables(False, None, P, backward)
    got, gcorn = PA.pairhmm_log(*to_torch(s1, s2, n1, n2), ms, ins, scal,
                                backward, fast=True)
    want, wcorn = _jax_pass(s1, n1, s2, n2, ms.numpy(), ins.numpy(),
                            scal.numpy(), N, backward, False, mode="fast")
    got = got.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() > 1000
    assert np.abs(got[fin] - want[fin]).max() <= 1e-4
    if not backward:
        assert np.abs(gcorn.numpy() - wcorn).max() <= 1e-4
    cubic, _ = PA.pairhmm_log(*to_torch(s1, s2, n1, n2), ms, ins, scal,
                              backward)
    assert not np.array_equal(cubic.numpy(), got)


@pytest.mark.parametrize("label,z", [
    ("overflow", [2.2, 1.9, 0.95, 2.5]),
    ("underflow", [0.0, -0.4, 0.85, 0.2]),
    ("finite_out_of_band", [1.6, 0.1, 0.9, 1.45]),
])
def test_retrying_no_jump_matches_jax(label, z):
    """``_retrying(jump=False)`` against the JAX loop called without
    ``ns``: every bad lane walks, long lanes included (no jump to
    ln(glob)/n, no long-n step growth)."""
    z = np.asarray(z, np.float64)
    ns = np.array([200, 700, 150, 1500], np.int32)
    run = _synthetic_run(z, ns.astype(np.float64))
    B = len(z)
    shapes = (jax.ShapeDtypeStruct((B, 2, 2), jnp.float32),
              jax.ShapeDtypeStruct((B,), jnp.float32))
    ls0 = np.float32(1.2)
    bppo_j, ls_j = JPP._retrying(
        lambda ls: jax.pure_callback(run, shapes, ls), B,
        ls0=jnp.asarray(ls0))

    def trun(ls):
        bppo, glob = run(ls.numpy())
        return torch.as_tensor(bppo), torch.as_tensor(glob)

    bppo_t, ls_t = PP._retrying(trun, torch.as_tensor(ns),
                                ls0=torch.tensor(ls0), jump=False)
    np.testing.assert_array_equal(np.asarray(ls_j), ls_t.numpy())
    np.testing.assert_array_equal(np.asarray(bppo_j), bppo_t.numpy())
    # the jumping loop settles elsewhere on the same lanes
    _, ls_jump = PP._retrying(trun, torch.as_tensor(ns),
                              ls0=torch.tensor(ls0))
    assert not np.array_equal(ls_jump.numpy(), ls_t.numpy()), label
