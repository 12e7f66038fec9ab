"""Plain versions of kernels K16 (CONTRA inside, log space) and K17 (CONTRA
outside) against the JAX log-space Pallas kernels in interpret mode, in
the parity numerics: ``mccaskill_contra_pallas`` against the JAX
function, whose close, ext and one are ``_contra_inside_call``'s (K16's
outputs) and bppo the outside kernel's (K17's).  One case at the default
weights and the minimum hairpin span, one at a randomized CONTRAfold
weight set with ``allows_short_hairpins``.

The -inf pattern must be identical and finite cells within
1e-4 * max(1, |x|):
jitted XLA on the CPU contracts the cubic's multiply-adds into fused
multiply-adds and the port (like the reference) does not, a few ulps on
each log-add, and the windows add up to ~650 of them per cell.  The
largest difference seen is printed.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.ops import pallas_fold as PF
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.params import build_fold_score_sets

from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.weights import contra_tables

N, B = 64, 2
FSS = build_fold_score_sets()
RTOL_LOG = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain log versions run thousands of small torch ops a span; with
    several test workers on the machine, torch's thread pools would
    oversubscribe it many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def log_batch(B, N, seed, nmin=30):
    """Mixed lengths; sequence 0 fills the bucket (n = N)."""
    rng = np.random.default_rng(seed)
    seqs = np.full((B, N), PSEUDO_BASE, dtype=np.int32)
    ns = np.zeros(B, dtype=np.int32)
    for k in range(B):
        n = N if k == 0 else int(rng.integers(nmin, N - 1))
        seqs[k, :n] = rng.integers(0, 4, size=n)
        ns[k] = n
    return seqs, ns


def assert_log_close(got, want, label):
    """-inf pattern identical, no NaN, finite cells within
    RTOL_LOG * max(1, |want|); returns the largest difference."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert not np.isnan(got).any(), label
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=f"{label}: -inf pattern")
    fin = np.isfinite(want)
    if not fin.any():
        return 0.0
    err = np.abs(got[fin] - want[fin])
    assert (err <= RTOL_LOG * np.maximum(1.0, np.abs(want[fin]))).all(), (
        label, float(err.max()))
    return float(err.max())


def jax_parity(fn, **static):
    """A fresh jit of a JAX log-space function traced in parity mode (the
    JAX package reads the numerics mode at trace time)."""
    jitted = jax.jit(getattr(fn, "__wrapped__", fn),
                     static_argnames=tuple(static))

    def call(*args):
        with JN.force_mode("parity"):
            return jitted(*args, **static)

    return call


def _contra_fold_case(ct, tt, seed, short):
    seqs, ns = log_batch(B, N, seed)
    want = jax_parity(PF.mccaskill_contra_pallas, N=N,
                      allows_short_hairpins=short, interpret=True)(
        jnp.asarray(seqs), jnp.asarray(ns), ct)
    got = TPF.mccaskill_contra_pallas(
        torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns), tt, N,
        allows_short_hairpins=short)
    worst = max(assert_log_close(g, w, name) for name, g, w in
                zip(("bppo", "close", "ext", "one"), got, want))
    print(f"K16+K17 plain vs JAX interpret (short={short}): max abs diff "
          f"{worst:.3e}")


def test_contra_log_plain_matches_jax():
    _contra_fold_case(S.contra_table_pytree(FSS), contra_tables(FSS, "cpu"),
                      seed=12, short=False)


def test_contra_log_randomized_weights_short_hairpins():
    """A randomized CONTRAfold weight set, as
    tests/test_contra_weights_dropin.py makes it, with short hairpins."""
    from .test_contra_weights_dropin import synth_full_params_text
    from rna_algos_tpu.params.contrafold import parse_contrafold_params

    rng = np.random.default_rng(20260821)
    fss = build_fold_score_sets(raw=parse_contrafold_params(
        synth_full_params_text(rng)))
    _contra_fold_case(S.contra_table_pytree(fss), contra_tables(fss, "cpu"),
                      seed=13, short=True)
