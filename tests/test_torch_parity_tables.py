"""The parity tier's host preparation against the JAX package, on the CPU,
bitwise: the log-space CONTRA [d, i] tables (``contra_precompute_di``,
every key), the outside kernels' aux in log space (``_skew_qone``,
``contra_outside_aux`` with the fills (-inf, 0), ``onep``; the JAX package
pre-rotates ONEP and extR by 2N - n, the port indexes them directly) and
``_lse_rows``, the tree that fixes the association of every cubic log-add,
against eager JAX in parity mode (eager, because jitted XLA fuses the
cubic's multiply-adds; test_torch_parity_contra.py)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.constants import NEG_INF
from rna_algos_tpu.ops import pallas_fold as PF
from rna_algos_tpu.ops import scores as S

from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.weights import contra_tables

from .test_torch_parity_contra import FSS, log_batch
from .test_torch_tables import assert_bitwise

B = 3
CT = S.contra_table_pytree(FSS)
TT = contra_tables(FSS, "cpu")


@pytest.mark.parametrize("N", [32, 64])
def test_contra_precompute_di_bitwise(N):
    seqs, ns = log_batch(B, N, N + 1, nmin=10)
    want = jax.jit(PF.contra_precompute_di, static_argnums=3)(
        jnp.asarray(seqs), jnp.asarray(ns), CT, N)
    got = TPF.contra_precompute_di(torch.as_tensor(seqs, dtype=torch.int64),
                                   torch.as_tensor(ns), TT, N)
    assert set(got) == set(want)
    for k in sorted(want):
        assert_bitwise(np.broadcast_to(np.asarray(want[k]), got[k].shape),
                       got[k])


def _log_ext_one(rng, ns, N):
    """Random log-space ext / one tables with the inside kernels' fills in
    the rows past each length (ext 0, one -inf) and some -inf cells."""
    ext = rng.normal(0.0, 3.0, (B, N, N)).astype(np.float32)
    one = rng.normal(0.0, 3.0, (B, N, N)).astype(np.float32)
    one[rng.random((B, N, N)) < 0.2] = NEG_INF
    live = np.arange(N)[None, :, None] < ns[:, None, None]
    return np.where(live, ext, 0.0), np.where(live, one, NEG_INF)


@pytest.mark.parametrize("N", [32, 64])
def test_log_outside_aux_bitwise(N):
    seqs, ns = log_batch(B, N, N + 2, nmin=10)
    ext, one = _log_ext_one(np.random.default_rng(N), ns, N)
    ONEP, QONE, extL, extR, glob = PF.contra_outside_aux(
        jnp.asarray(ns), jnp.asarray(ext), jnp.asarray(one), N,
        neg=NEG_INF, one_val=0.0)
    QONE_t, extL_t, extR_t, glob_t = TPF.contra_outside_aux(
        torch.as_tensor(ns), torch.as_tensor(ext), torch.as_tensor(one), N,
        NEG_INF, 0.0)
    assert_bitwise(QONE, QONE_t)
    assert_bitwise(extL, extL_t)
    assert_bitwise(glob, glob_t)
    onep_t = TPF.onep(torch.as_tensor(one), N)
    for k in range(B):
        n = int(ns[k])
        assert_bitwise(np.roll(np.asarray(extR[k]), n), extR_t[k])
        assert_bitwise(np.roll(np.asarray(ONEP[k]), n, axis=-1), onep_t[k])
        assert_bitwise(PF._skew_qone(jnp.asarray(one[k]), N, NEG_INF),
                       TPF._skew_qone(torch.as_tensor(one[k]), N, NEG_INF))


@pytest.mark.parametrize("rows", [1, 2, 8, 24, 32, 64])
def test_lse_rows_matches_eager_jax(rows):
    """Random rows (a spread that exercises every cubic segment and the
    threshold), the rows past a live count -inf, and some -inf cells."""
    rng = np.random.default_rng(rows)
    x = rng.normal(0.0, 6.0, (rows, 40)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = NEG_INF
    x[max(1, rows // 2 + 1):] = NEG_INF
    with JN.force_mode("parity"):
        want = np.asarray(PF._lse_rows(jnp.asarray(x)))[0]
    got = TPF._lse_rows(torch.as_tensor(x))
    assert_bitwise(want, got)
    # -inf rows past the live ones are identities of a power-of-two tree:
    # the least power of two covering them (the kernels' height) agrees
    if rows & (rows - 1) == 0:
        least = 1 << (max(1, rows // 2 + 1) - 1).bit_length()
        assert_bitwise(want, TPF._lse_rows(torch.as_tensor(x[:least])))
