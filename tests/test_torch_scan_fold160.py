"""The port's generic-N path against the JAX package's XLA scan at
N = 160 (a bucket no kernel tier takes: not a power of two), both
models, all three numerics modes, and CONTRA with
``allows_short_hairpins`` (tolerances in ``tests/scan_cases.py``)."""

import pytest

from .scan_cases import MODES, check_against_jax, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_plain_scan_matches_jax_n160(contra, mode):
    e_log, e_bpp = check_against_jax(160, 2, seed=160 + contra,
                                     contra=contra, mode=mode)
    print(f"N=160 contra={contra} {mode}: log {e_log:.3e}, BPP {e_bpp:.3e}")


def test_plain_scan_short_hairpins_n160():
    check_against_jax(160, 2, seed=161, contra=True, mode="parity", ash=True)
