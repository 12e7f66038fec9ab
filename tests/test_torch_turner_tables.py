"""Port Turner tables vs the JAX package, on the CPU.

Parameters, lookups, skews and the [d, i] assembly are bitwise, with one
exception: the hairpin length extrapolation (hairpin length > 30) takes a
float32 ``log``, where torch's result is correctly rounded and XLA's CPU
``log`` is off by one ulp at some arguments (28 of the lengths 1..299).
That ulp, scaled by the extrapolation coefficient and rounded again in
the sums, moves those H cells by at most 2 ulp (measured 2), so they are
held to 2 ulp, and their exponentials to rtol 1e-5 (measured 3.9e-6).
The other probability-space tables agree to rtol 1e-6 because torch's
and XLA's ``exp`` differ by an ulp or two.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rna_algos_tpu.constants import MAX_HAIRPIN_LEN_EXTRAPOLATION
from rna_algos_tpu.params import turner as T
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.ops import pallas_fold as PF
from rna_algos_tpu.ops import pallas_fold_prob as PP
from rna_algos_tpu.ops.pallas_skew import skew_pq_batch as jax_skew

from rna_algos_tpu_torch.weights import turner_tables
from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.ops import scores as TS
from rna_algos_tpu_torch.ops.pallas_skew import skew_pq_batch

from .test_torch_tables import assert_bitwise, make_batch

N, B = 64, 8
TT_J = S.turner_table_pytree()
TT = turner_tables("cpu")


def turner_batch(B, N, seed):
    """make_batch with a special hairpin (the first of the parameter set,
    closing pair included) planted in sequence 1 at position 10."""
    seqs, ns = make_batch(B, N, seed)
    L = int(TT_J["special_lens"][0])
    seqs[1, 10:10 + L] = np.asarray(TT_J["special_seqs"][0])[:L]
    return seqs, ns


@pytest.fixture(scope="module")
def batch():
    seqs, ns = turner_batch(B, N, 41)
    ls = np.random.default_rng(42).uniform(0.4, 0.6, B).astype(np.float32)
    return seqs, ns, ls


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_turner_tables_match_pytree():
    assert set(TT) == set(TT_J)
    for k, want in TT_J.items():
        got = TT[k]
        if k in ("special_seqs", "special_lens"):
            assert got.dtype == torch.int64, k
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
        else:
            assert got.dtype == torch.float32, k
            assert_bitwise(want, got)


def test_turner_tables_take_a_drop_in():
    tabs = dict(T.active_tables())
    tabs["STACK_SCORES"] = np.asarray(tabs["STACK_SCORES"]) + np.float32(0.25)
    tabs["NINIO_MAX"] = np.float64(-2.5)
    got = turner_tables("cpu", tabs)
    want = S.turner_table_pytree(tabs)
    for k in ("stack", "ninio_max", "hairpin_init"):
        assert got[k].dtype == torch.float32
        assert_bitwise(want[k], got[k])
    assert not torch.equal(got["stack"], TT["stack"])


def test_augu_matrix():
    assert_bitwise(S.AUGU_MAT, TS.augu_mat("cpu"))


def test_special_hairpin_id_bitwise(batch):
    seqs, _, _ = batch
    want = jax.vmap(lambda s: S.special_hairpin_id(s, TT_J, N))(
        jnp.asarray(seqs))
    got = TS.special_hairpin_id(_t(seqs, torch.int64), TT, N)
    assert_bitwise(want, got)
    # the planted hairpin [10, 10 + L - 1] carries its special score
    L = int(TT_J["special_lens"][0])
    assert got[1, 10, L - 1] == TT["special_scores"][0]
    assert int(torch.isfinite(got).sum()) >= 1


def test_turner_precompute_di(batch):
    seqs, ns, _ = batch
    want = PF.turner_precompute_di(jnp.asarray(seqs), jnp.asarray(ns), TT_J, N)
    got = TPF.turner_precompute_di(_t(seqs, torch.int64), _t(ns), TT, N)
    assert set(want) == set(got)
    for k in want:
        if k != "H":
            assert_bitwise(want[k], got[k])
    # H: bitwise up to the extrapolated hairpin lengths (span d = hlen + 1)
    d_ext = MAX_HAIRPIN_LEN_EXTRAPOLATION + 2
    wH, gH = np.asarray(want["H"]), got["H"].numpy()
    assert_bitwise(wH[:, :d_ext], gH[:, :d_ext])
    np.testing.assert_array_max_ulp(wH[:, d_ext:], gH[:, d_ext:], maxulp=2)
    # the special-hairpin override reached the [d, i] hairpin table
    L = int(TT_J["special_lens"][0])
    assert gH[1, L - 1, 10] == float(TT["special_scores"][0])


def test_turner_len_and_banded_tables(batch):
    _, _, ls = batch
    for w, g in zip(PF._turner_len_di(TT_J), TPF._turner_len_di(TT)):
        assert_bitwise(w, g)
    want = PP._turner_len_prob(TT_J, jnp.asarray(ls))
    got = TPP._turner_len_prob(TT, _t(ls))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    # the banded matrices are a pure re-layout of the same LEN values
    kj = PP._turner_banded_kernels(*(jnp.asarray(g.numpy()) for g in got))
    kt = TPP._turner_banded_kernels(*got)
    for w, g in zip(kj, kt):
        assert_bitwise(w, g)


def test_turner_prob_mats(batch):
    seqs, ns, ls = batch
    want = PP.turner_prob_mats(jnp.asarray(seqs), jnp.asarray(ns), TT_J,
                               jnp.asarray(ls), N)
    got = TPP.turner_prob_mats(_t(seqs, torch.int64), _t(ns), TT, _t(ls), N)
    assert set(want) == set(got)
    d_ext = MAX_HAIRPIN_LEN_EXTRAPOLATION + 2
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        np.testing.assert_allclose(g[:, :d_ext], w[:, :d_ext], rtol=1e-6,
                                   atol=0, err_msg=k)
        rtol = 1e-5 if k == "H" else 1e-6
        np.testing.assert_allclose(g[:, d_ext:], w[:, d_ext:], rtol=rtol,
                                   atol=0, err_msg=k)


def test_turner_scal_rows(batch):
    _, _, ls = batch
    jl = jnp.asarray(ls)
    _, LENIp = PP._turner_len_prob(TT_J, jl)
    u = np.exp(-ls)
    want = np.stack([
        np.asarray(jnp.exp(-jl)), np.ones(B, np.float32), np.asarray(jnp.exp(-jl)),
        np.full(B, np.asarray(jnp.exp(TT_J["coeff_num_branches"]))),
        np.asarray(LENIp[:, 3, 2]), np.asarray(LENIp[:, 2, 3]),
    ], axis=1)
    _, LENIt = TPP._turner_len_prob(TT, _t(ls))
    got = TPP._turner_scal_rows(TT, _t(ls), LENIt)
    assert got.shape == (B, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:, 0].numpy(), u, rtol=1e-6)


def test_plain_skew_of_18_tables_bitwise():
    """The Turner precompute skews 18 tables in one call (over the CUDA
    kernel's former 16-table cap; tests/test_torch_cuda.py holds the
    kernel itself).  Against the JAX function's own CPU path, which is
    the plain permutation the Pallas kernel is held to in
    test_torch_tables.py."""
    rng = np.random.default_rng(9)
    mats = [rng.standard_normal((2, N, N)).astype(np.float32)
            for _ in range(18)]
    want = jax_skew([jnp.asarray(m) for m in mats])
    got = skew_pq_batch([torch.as_tensor(m) for m in mats])
    assert len(got) == 18
    for w, g in zip(want, got):
        assert_bitwise(w, g)
