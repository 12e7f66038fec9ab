"""Plain versions of kernels K18 (Turner inside, log space) and K19 (Turner
outside) against the JAX log-space Pallas kernels in interpret mode, in
the parity numerics, with the tolerance of test_torch_parity_contra.py
(the -inf pattern identical, finite cells within 1e-4 * max(1, |x|)):
``mccaskill_turner_pallas`` against the JAX function, whose close, ext
and one are ``_turner_inside_call``'s (K18) and bppo the outside
kernel's (K19).

The port folds on its own tables, which equal the JAX package's but for
the hairpin-extrapolation cells (2 ulp at most,
test_torch_turner_tables.py).  The batch mixes lengths (sequence 0 fills
the bucket) and plants a special hairpin in sequence 1.
"""

import jax.numpy as jnp
import torch

from rna_algos_tpu.ops import pallas_fold as PF

from rna_algos_tpu_torch.ops import pallas_fold as TPF

from .test_torch_parity_contra import (  # noqa: F401  (fixture)
    assert_log_close, jax_parity, one_torch_thread)
from .test_torch_turner_tables import TT, TT_J, turner_batch

N, B = 64, 2


def test_turner_log_plain_matches_jax():
    seqs, ns = turner_batch(B, N, 22)
    want = jax_parity(PF.mccaskill_turner_pallas, N=N, interpret=True)(
        jnp.asarray(seqs), jnp.asarray(ns), TT_J)
    got = TPF.mccaskill_turner_pallas(
        torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns), TT, N)
    worst = max(assert_log_close(g, w, name) for name, g, w in
                zip(("bppo", "close", "ext", "one"), got, want))
    print(f"K18+K19 plain vs JAX interpret: max abs diff {worst:.3e}")
