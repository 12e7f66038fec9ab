"""The port's plain generic-N scan against the JAX package's, evaluated
eagerly (``jax.disable_jit``) on the CPU: bit for bit.  Eager XLA rounds
every add and multiply on its own, as torch does, so the inside tables
(close, ext, one, mb) and bppo agree exactly on the live cells (i + d <
n), and so do the BPPs and presence; what the jitted tests allow is only
jitted XLA's fused multiply-adds.  N = 12: eager JAX is one dispatch an
operation."""

import numpy as np
import pytest

from .scan_cases import (jax_bppo, live, one_torch_thread,  # noqa: F401
                         port_scan, scan_batch, tables)

N = 12


@pytest.mark.parametrize("contra,ash", [(True, False), (True, True),
                                        (False, False)],
                         ids=["contra", "contra_short", "turner"])
def test_plain_scan_bitwise_vs_eager_jax(contra, ash):
    jt, tt = tables(contra)
    seqs, ns = scan_batch(N, 2, seed=12 + contra + 2 * ash)
    bppo, ins, _bpp, _pres = port_scan(seqs, ns, tt, N, contra, ash, "exact")
    jbppo, jins = jax_bppo(seqs, ns, jt, N, contra, ash, "exact", jit=False)
    mask = live(ns, N)
    np.testing.assert_array_equal(bppo, jbppo)
    for key, jkey in (("close", "P_close"), ("ext", "P_ext"),
                      ("one", "P_one"), ("mb", "P_mb")):
        np.testing.assert_array_equal(ins[key].numpy()[mask],
                                      jins[jkey][mask], err_msg=key)
