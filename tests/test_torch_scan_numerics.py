"""``numerics.lse_reduce`` and ``lse_accumulate`` of the port against the
JAX package's, evaluated eagerly on the CPU: the halving tree of the
generic-N scan (K20/K21).

Bitwise under "exact" and "parity" (the same tree over the same padded
width, each pair ``lse_pair``); "fast" is the max-form, within 1e-6 (its
exp and log are the two libraries' own).  The widths are those of the
scan's sums: 1, 31, the 961-term 2-loop window, 1,000 and the 3N-wide
multibranch context at N = 160, each with runs of -inf (the identity).
Also: a tree over a prefix of live terms gives the bits of the tree over
any wider power of two, which lets the kernels sum O(d) terms only.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rna_algos_tpu import numerics as JN

from rna_algos_tpu_torch import numerics as TN

F32 = np.float32
WIDTHS = (1, 31, 961, 1000, 3 * 160)


def _rows(width, seed, rows=24):
    """Log-space terms of a scan sum: values in [-60, 40], runs of -inf,
    one row all -inf and one with a single finite term."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-60.0, 40.0, (rows, width)).astype(F32)
    for r in range(rows):
        lo = int(rng.integers(0, width))
        hi = int(rng.integers(lo, width + 1))
        x[r, lo:hi] = -np.inf
    x[0] = -np.inf
    x[1] = -np.inf
    x[1, width // 2] = F32(3.25)
    return x


def _jax(fn, mode, *args):
    with JN.force_mode(mode):
        return np.asarray(fn(*[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("mode", ["exact", "parity"])
@pytest.mark.parametrize("width", WIDTHS)
def test_lse_reduce_bitwise(mode, width):
    x = _rows(width, seed=width)
    want = _jax(JN.lse_reduce, mode, x)
    got = TN.lse_reduce(torch.as_tensor(x), -1, mode).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    assert np.isneginf(got[0]) and got[1] == F32(3.25)


@pytest.mark.parametrize("width", WIDTHS)
def test_lse_reduce_fast(width):
    x = _rows(width, seed=width + 1)
    want = _jax(JN.lse_reduce, "fast", x)
    got = TN.lse_reduce(torch.as_tensor(x), -1, "fast").numpy()
    np.testing.assert_array_equal(np.isfinite(want), np.isfinite(got))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-6 * max(
        1.0, np.abs(want[fin]).max())


def test_lse_reduce_axis_and_empty():
    x = _rows(37, seed=5).reshape(4, 6, 37).transpose(0, 2, 1).copy()
    want = _jax(lambda a: JN.lse_reduce(a, axis=1), "exact", x)
    got = TN.lse_reduce(torch.as_tensor(x), 1, "exact").numpy()
    np.testing.assert_array_equal(want, got)
    empty = TN.lse_reduce(torch.zeros((3, 0)), -1, "exact")
    assert empty.shape == (3,) and torch.isneginf(empty).all()


def test_lse_reduce_prefix_width_is_free():
    """Live terms in a prefix [0, L]: the tree over next_pow2(L + 1) is the
    tree over any wider power of two (lse_pair(x, -inf) is x)."""
    x = _rows(100, seed=7)
    x[:, 100:] = -np.inf
    narrow = TN.lse_reduce(torch.as_tensor(x), -1, "exact")
    wide = np.full((x.shape[0], 2048), -np.inf, F32)
    wide[:, :100] = x
    wide = TN.lse_reduce(torch.as_tensor(wide), -1, "exact")
    assert torch.equal(narrow, wide)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_lse_accumulate(mode):
    rng = np.random.default_rng(11)
    s = rng.uniform(-20, 20, 4000).astype(F32)
    x = rng.uniform(-20, 20, 4000).astype(F32)
    s[::7] = -np.inf
    x[::5] = -np.inf
    x[::11] = np.nan
    s[::13] = np.nan
    want = _jax(JN.lse_accumulate, mode, s, x)
    got = TN.lse_accumulate(torch.as_tensor(s), torch.as_tensor(x),
                            mode).numpy()
    same = (want == got) | (np.isnan(want) & np.isnan(got))
    if mode == "exact":
        assert same.all()
    else:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(fin, np.isfinite(got))
        assert np.abs(got[fin] - want[fin]).max() <= 1e-6 * 21
