"""The port's cubic numerics (``rna_algos_tpu_torch.numerics``) against the
JAX package's ``numerics.logsumexp``, evaluated eagerly on the CPU.

Bitwise, except where the two libraries' hardware functions differ:
``expf``'s exact branch (x >= 0) and "fast" mode's ``exp`` are held to 1
ulp, "fast" mode's ``logaddexp`` to 1e-6 (its log1p, near a zero result,
rounds differently).  Subnormal inputs stay out of the grids: XLA reads
them as zero.  (Jitted XLA code on the CPU contracts the cubics'
Horner steps into fused multiply-adds, as eager JAX, torch and the
reference do not; the pair-HMM tests state what that costs.)
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.numerics import logsumexp as JL

from rna_algos_tpu_torch import numerics as TN
from rna_algos_tpu_torch.constants import LOGSUMEXP_THRESHOLD_UPPER
from rna_algos_tpu_torch.numerics import logsumexp as TL

F32 = np.float32


def _grid(seed):
    """Every breakpoint and the threshold with their float32 neighbours,
    +-0, +-inf and -inf, and a random grid over [-15, 15]."""
    marks = np.concatenate([JL._LN_EXP_1P_BREAKS, JL._EXPF_BREAKS,
                            [LOGSUMEXP_THRESHOLD_UPPER]]).astype(F32)
    near = np.concatenate([marks, np.nextafter(marks, F32(np.inf)),
                           np.nextafter(marks, F32(-np.inf))])
    near = near[(near == 0) | (np.abs(near) >= np.finfo(F32).tiny)]
    rng = np.random.default_rng(seed)
    return np.concatenate([
        near, F32([0.0, -0.0, np.inf, -np.inf]),
        rng.uniform(-15.0, 15.0, 20000).astype(F32),
    ]).astype(F32)


def _ulps(a, b):
    """|a - b| in float32 ulps (equal values, NaN pairs and equal infs: 0)."""
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, np.int64(-2**31) - ai, ai)
    bi = np.where(bi < 0, np.int64(-2**31) - bi, bi)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return np.where(same, 0, np.abs(ai - bi))


def test_tables_identical():
    for name in ("LN_EXP_1P_BREAKS", "LN_EXP_1P_COEFFS", "EXPF_BREAKS",
                 "EXPF_COEFFS"):
        want = getattr(JL, "_" + name)
        got = getattr(TL, name)
        assert want.dtype == got.dtype and want.tobytes() == got.tobytes()


def test_ln_exp_1p_bitwise():
    x = np.abs(_grid(0))
    want = np.asarray(JN.ln_exp_1p(jnp.asarray(x)))
    got = TN.ln_exp_1p(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_expf(mode):
    x = _grid(1)
    with JN.force_mode(mode):
        want = np.asarray(JN.expf(jnp.asarray(x)))
    got = TN.expf(torch.as_tensor(x), mode).numpy()
    ulps = _ulps(got, want)
    if mode == "parity":
        # the cubic branch (x < 0) is bitwise, the exact exp within 1 ulp
        assert (ulps[x < 0] == 0).all()
        assert got[x < F32(-9.91152)].max() == 0.0
    assert ulps.max() <= 1, x[ulps.argmax()]


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_lse_pair(mode):
    rng = np.random.default_rng(2)
    a = np.concatenate([_grid(3), rng.uniform(-30, 30, 20000).astype(F32)])
    a = a[a != np.inf]   # DP states are finite or -inf
    b = rng.permutation(a)
    # differences at the threshold, and -inf on either side and both
    b[:200] = a[:200] - F32(LOGSUMEXP_THRESHOLD_UPPER)
    a[200:300] = -np.inf
    b[250:350] = -np.inf
    with JN.force_mode(mode):
        want = np.asarray(JN.lse_pair(jnp.asarray(a), jnp.asarray(b)))
    got = TN.lse_pair(torch.as_tensor(a), torch.as_tensor(b), mode).numpy()
    both = (a == -np.inf) & (b == -np.inf)
    assert (got[both] == -np.inf).all()
    if mode == "parity":
        np.testing.assert_array_equal(got, want)
    else:
        fin = np.isfinite(want)
        assert (got[~fin] == want[~fin]).all()
        err = np.abs(got[fin] - want[fin])
        assert (err <= 1e-6 * np.maximum(1.0, np.abs(want[fin]))).all()


def test_mode_is_checked():
    with pytest.raises(ValueError):
        TN.expf(torch.zeros(2), "turbo")
