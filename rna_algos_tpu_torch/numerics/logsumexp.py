"""CONTRAfold's piecewise-cubic log-sum-exp (``rna_algos_tpu.numerics.logsumexp``).

The reference's streaming log-sum-exp rests on two piecewise-cubic
approximations (`reference/src/utils.rs:579-655`):

* ``ln_exp_1p(x)`` ~= ln(1 + e^x) for 0 <= x <= LOGSUMEXP_THRESHOLD_UPPER
  (8 cubic segments),
* ``expf(x)`` ~= e^x for x < 0 (7 cubic segments; exact ``exp`` for x >= 0).

Same float32 breakpoints and coefficients as the JAX package, the same
segment choice (the JAX package's select chain upgrades the four Horner
coefficients at each break x >= break; here the segment index is the
number of such breaks, one ``bucketize``) and the same Horner nesting
``((c3*x + c2)*x + c1)*x + c0``.  Torch runs each
elementwise operation on its own, rounded, so nothing is contracted into a
fused multiply-add; the log-space kernel (``csrc/pairhmm.cu``) writes its
cubic with round-to-nearest intrinsics for the same reason.

The mode is a value, not a global: "exact" and "parity" evaluate the
cubics; "fast" uses ``torch.logaddexp`` and ``torch.exp``.  -inf is the
additive identity and ``lse_pair`` skips it as the reference does.
"""

import numpy as np
import torch

from ..constants import LOGSUMEXP_THRESHOLD_UPPER, NEG_INF

MODES = ("exact", "parity", "fast")


def check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"numerics mode {mode!r}: expected one of {MODES}")
    return mode


# ln(1 + e^x) cubics (utils.rs:602-627): segment k covers
# [BREAKS[k-1], BREAKS[k]); rows are (c3, c2, c1, c0).
LN_EXP_1P_BREAKS = np.array(
    [0.66153675, 1.6320158, 2.4912589, 3.37925, 4.426169, 5.789071, 7.8162727],
    dtype=np.float32,
)
LN_EXP_1P_COEFFS = np.array(
    [
        [-0.0065591595, 0.12764427, 0.49965546, 0.6931542],
        [-0.015515756, 0.14467756, 0.48829398, 0.6958093],
        [-0.012890925, 0.13010283, 0.51503986, 0.6795586],
        [-0.0072142647, 0.087754086, 0.6208708, 0.5909676],
        [-0.0031455354, 0.046722945, 0.7592532, 0.43487945],
        [-0.0010110698, 0.018594341, 0.88317305, 0.25236955],
        [-0.000196278, 0.0046084408, 0.9634432, 0.09831489],
        [-0.0000113994, 0.0003734731, 0.9959107, 0.0149855051],
    ],
    dtype=np.float32,
)

# e^x cubics for x < 0 (utils.rs:631-655): below the first break the
# result is 0, at or above 0 the exact exp is used.
EXPF_BREAKS = np.array(
    [-9.91152, -5.8622823, -3.839663, -2.4915035, -1.4805375, -0.6725053, 0.0],
    dtype=np.float32,
)
EXPF_COEFFS = np.array(
    [
        [0.0, 0.0, 0.0, 0.0],  # x < -9.91152 -> 0
        [0.0000803850, 0.002162743, 0.019470856, 0.058808003],
        [0.0013889414, 0.024467647, 0.14712906, 0.30427578],
        [0.0072335607, 0.09060027, 0.39831114, 0.62459594],
        [0.023241036, 0.2085646, 0.6906368, 0.86823225],
        [0.057378277, 0.35802585, 0.9121133, 0.9793092],
        [0.119917594, 0.48156682, 0.9975992, 0.9999505],
    ],
    dtype=np.float32,
)


def _piecewise_cubic(x, breaks, coeffs):
    """Horner evaluation with the coefficients of x's segment, row k of
    ``coeffs`` for the k breaks at or below x."""
    seg = torch.bucketize(x.contiguous(),
                          torch.as_tensor(breaks, device=x.device),
                          right=True)
    c3, c2, c1, c0 = torch.as_tensor(coeffs, device=x.device)[seg].unbind(-1)
    return ((c3 * x + c2) * x + c1) * x + c0


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def ln_exp_1p(x):
    """CONTRAfold approximation of ln(1 + e^x) for 0 <= x <= 11.862479."""
    return _piecewise_cubic(_f32(x), LN_EXP_1P_BREAKS, LN_EXP_1P_COEFFS)


def expf(x, mode="exact"):
    """CONTRAfold approximation of e^x (exact for x >= 0, 0 below
    -9.91152); ``torch.exp`` in "fast" mode."""
    x = _f32(x)
    if check_mode(mode) == "fast":
        return torch.exp(x)
    approx = _piecewise_cubic(x, EXPF_BREAKS[:-1], EXPF_COEFFS)
    # the all-zero cubic gives 0 * -inf = NaN at x = -inf
    approx = torch.where(x < float(EXPF_BREAKS[0]), 0.0, approx)
    return torch.where(x >= 0.0, torch.exp(x), approx)


def lse_pair(a, b, mode="exact"):
    """Symmetric pairwise log-add with the reference's skip / threshold
    semantics (``logsumexp``, utils.rs:579-596).  Operands are finite or
    -inf: z = hi - lo is NaN (both -inf) or +inf (one -inf) exactly when
    the finite branch must not be taken, and both compare false against
    the threshold, so the surviving operand (or -inf) comes back."""
    a, b = _f32(a), _f32(b)
    if check_mode(mode) == "fast":
        return torch.logaddexp(a, b)
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    z = hi - lo
    # the reference's `y + z` (1-ulp faithful) where both are finite
    big = torch.where(lo > NEG_INF, lo + z, hi)
    return torch.where(z < LOGSUMEXP_THRESHOLD_UPPER, lo + ln_exp_1p(z), big)
