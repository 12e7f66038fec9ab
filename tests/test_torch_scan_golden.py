"""The Turner n = 1,536 gate of ``chip_smoke.py`` (TOL_GOLDEN_SCAN): the
drift from the float64 golden of ``seq_1536``
(``tests/golden/longn_f64_1536.npz``) of the JAX package's XLA scan
(exact numerics, jitted on the CPU) and of the port's plain generic-N path
on the CPU, printed.  The gate is the JAX scan's drift plus 1e-3, and the
port's drift must sit within it.  Minutes on the CPU: marked slow."""

import time

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from rna_algos_tpu import numerics as JN
from rna_algos_tpu.models import mccaskill as JM
from rna_algos_tpu.ops import scores as JS

from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.weights import turner_tables

from .conftest import REPO_ROOT

MARGIN = 1e-3


@pytest.mark.slow
def test_turner_1536_golden_gate():
    g = np.load(REPO_ROOT / "tests" / "golden" / "longn_f64_1536.npz")
    seq, ref = g["seq_1536"], g["bpp_1536_turner"]
    n = N = len(seq)
    t0 = time.perf_counter()
    with JN.force_mode("exact"):
        jbpp, _ = JM.mccaskill_bpp(jnp.asarray(seq), n, JS.turner_table_pytree(),
                                   N=N, contra=False)
    jax_drift = float(np.abs(np.asarray(jbpp)[:n, :n] - ref).max())
    t1 = time.perf_counter()
    bpp, _ = TM.mccaskill_bpp_batch(
        torch.as_tensor(seq[None], dtype=torch.int64),
        torch.tensor([n], dtype=torch.int32), turner_tables("cpu"), N)
    port_drift = float(np.abs(bpp[0].numpy() - ref).max())
    t2 = time.perf_counter()
    print(f"seq_1536 Turner vs float64: JAX scan {jax_drift!r} ({t1 - t0:.1f} "
          f"s), port plain path {port_drift!r} ({t2 - t1:.1f} s); gate "
          f"{chip_smoke.TOL_GOLDEN_SCAN}")
    assert jax_drift + MARGIN <= chip_smoke.TOL_GOLDEN_SCAN
    assert port_drift <= chip_smoke.TOL_GOLDEN_SCAN
