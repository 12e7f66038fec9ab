"""The port's generic-N path (``mccaskill_bpp_batch``: the plain versions
of K20/K21 on the CPU) against the JAX package's XLA scan at N = 64 and
96, both models, all three numerics modes, and CONTRA with
``allows_short_hairpins`` (tolerances in ``tests/scan_cases.py``)."""

import pytest

from .scan_cases import MODES, check_against_jax, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
@pytest.mark.parametrize("N,B", [(64, 3), (96, 2)])
def test_plain_scan_matches_jax(N, B, contra, mode):
    e_log, e_bpp = check_against_jax(N, B, seed=N + contra, contra=contra,
                                     mode=mode)
    print(f"N={N} contra={contra} {mode}: log {e_log:.3e}, BPP {e_bpp:.3e}")


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_plain_scan_short_hairpins(mode):
    check_against_jax(64, 2, seed=7, contra=True, mode=mode, ash=True)
