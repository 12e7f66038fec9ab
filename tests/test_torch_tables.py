"""Port tables vs the JAX package, on the CPU.

Table assembly, lookups and permutations are bitwise; the merged
probability-space tables agree to rtol 1e-6 because torch's and XLA's
``exp`` differ by an ulp or two.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.params import build_fold_score_sets
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.ops import pallas_fold as PF
from rna_algos_tpu.ops import pallas_fold_prob as PP
from rna_algos_tpu.ops import pallas_fold_prob8 as P8
from rna_algos_tpu.ops.lut import sep_lookup as jax_sep
from rna_algos_tpu.ops.pallas_skew import skew_pq_batch as jax_skew

from rna_algos_tpu_torch.weights import contra_tables
from rna_algos_tpu_torch.ops import diag as TD
from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as TP8
from rna_algos_tpu_torch.ops import scores as TS
from rna_algos_tpu_torch.ops.lut import sep_lookup as torch_sep
from rna_algos_tpu_torch.ops.pallas_skew import skew_pq_batch

N, B = 64, 8
FSS = build_fold_score_sets()
CT = S.contra_table_pytree(FSS)
TT = contra_tables(FSS, "cpu")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bitwise(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(_bits(a), _bits(b))


def make_batch(B, N, seed):
    """Mixed lengths; sequence 0 fills the bucket (n = N)."""
    rng = np.random.default_rng(seed)
    seqs = np.full((B, N), PSEUDO_BASE, dtype=np.int32)
    ns = np.zeros(B, dtype=np.int32)
    for k in range(B):
        n = N if k == 0 else int(rng.integers(30, N - 1))
        seqs[k, :n] = rng.integers(0, 4, size=n)
        ns[k] = n
    return seqs, ns


@pytest.fixture(scope="module")
def batch():
    seqs, ns = make_batch(B, N, 5)
    ls = np.random.default_rng(6).uniform(0.7, 1.1, B).astype(np.float32)
    return seqs, ns, ls


def test_contra_tables_float32_and_equal():
    fss64 = {k: np.asarray(v, dtype=np.float64) for k, v in FSS.items()}
    tt = contra_tables(fss64, "cpu")
    ct = S.contra_table_pytree(fss64)
    assert set(tt) == set(ct)
    for k in ct:
        assert tt[k].dtype == torch.float32, k
        assert_bitwise(ct[k], tt[k])


def test_sget_matches_jnp_take_fill():
    seq = np.array([[1, 2, 3, 0, 2], [3, 1, 0, 2, 4]], dtype=np.int32)
    idx = np.arange(-7, 8)
    want = np.stack([np.asarray(S.sget(jnp.asarray(s), jnp.asarray(idx)))
                     for s in seq])
    got = TS.sget(torch.as_tensor(seq, dtype=torch.int64),
                  torch.as_tensor(idx))
    np.testing.assert_array_equal(want, got.numpy())
    # [-L, 0) counts from the end; outside [-L, L) reads the fill
    assert got[0, idx.tolist().index(-1)] == seq[0, -1]
    assert got[0, idx.tolist().index(-6)] == PSEUDO_BASE
    assert got[0, idx.tolist().index(5)] == PSEUDO_BASE


@pytest.mark.parametrize(
    "name,i_dims,j_dims,perm",
    [
        ("helix_close_scores", 1, 1, None),
        ("helix_close_scores", 1, 1, (1, 0)),
        ("terminal_mismatch_scores", 2, 2, (0, 2, 1, 3)),
        ("terminal_mismatch_scores", 2, 2, (1, 3, 0, 2)),
        ("dangling_scores_left", 2, 1, (0, 2, 1)),
        ("dangling_scores_right", 1, 2, None),
    ],
)
def test_sep_lookup_bitwise(name, i_dims, j_dims, perm):
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 5, size=N) for _ in range(i_dims + j_dims)]
    want = jax_sep(
        CT[name],
        tuple(jnp.asarray(p) for p in parts[:i_dims]),
        tuple(jnp.asarray(p) for p in parts[i_dims:]),
        perm=perm,
    )
    got = torch_sep(
        TT[name],
        tuple(torch.as_tensor(p) for p in parts[:i_dims]),
        tuple(torch.as_tensor(p) for p in parts[i_dims:]),
        perm=perm,
    )
    assert_bitwise(want, got)


def test_contra_pq_tables_bitwise(batch):
    seqs, ns, _ = batch
    pq_j, m1_j, x1_j = PF.contra_pq_tables(
        jnp.asarray(seqs), jnp.asarray(ns), CT, N
    )
    pq_t, m1_t, x1_t = TPF.contra_pq_tables(
        torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns), TT, N
    )
    assert set(pq_j) == set(pq_t)
    for k in pq_j:
        assert_bitwise(pq_j[k], pq_t[k])
    assert_bitwise(m1_j, m1_t)
    assert_bitwise(x1_j, x1_t)


def test_len_tables_bitwise(batch):
    _, ns, ls = batch
    assert_bitwise(PF._contra_len_di(CT), TPF._contra_len_di(TT))
    # exp of the same arguments: torch and XLA differ by ulps
    np.testing.assert_allclose(
        TPP._scal_rows(TT, torch.as_tensor(ls)).numpy(),
        np.asarray(PP._scal_rows(CT, jnp.asarray(ls), jnp.asarray(ns)))[:, 0, :4],
        rtol=1e-6, atol=0,
    )
    LENp_j = np.asarray(PP._contra_len_prob(CT, jnp.asarray(ls)))
    LENp_t = TPP._contra_len_prob(TT, torch.as_tensor(ls))
    np.testing.assert_allclose(LENp_t.numpy(), LENp_j, rtol=1e-6, atol=0)
    # the banded matrix is a pure re-layout of the same LEN values
    assert_bitwise(
        PP._banded_window_kernel(jnp.asarray(LENp_t.numpy())),
        TPP._banded_window_kernel(LENp_t),
    )


@pytest.mark.parametrize("inv", [False, True])
def test_plain_skew_bitwise_vs_pallas_kernel(inv):
    rng = np.random.default_rng(3)
    mats = [rng.standard_normal((B, N, N)).astype(np.float32)
            for _ in range(3)]
    mats[1][0, 0, 0] = np.float32(-0.0)
    mats[2][1, 5, 7] = np.inf
    want = jax_skew([jnp.asarray(m) for m in mats], interpret=True, inv=inv)
    got = skew_pq_batch([torch.as_tensor(m) for m in mats], inv=inv)
    for w, g in zip(want, got):
        assert_bitwise(w, g)
    # the two directions are inverse permutations on the live triangle
    back = skew_pq_batch(got, inv=not inv)
    p = np.arange(N)[:, None]
    q = np.arange(N)[None, :]
    live = (q >= p) if not inv else (p + q < N)
    np.testing.assert_array_equal(
        np.where(live, back[0].numpy(), 0), np.where(live, mats[0], 0)
    )


def test_shift_pq_matches_shift_di():
    from rna_algos_tpu.ops import diag as JD

    M = np.random.default_rng(4).standard_normal((N, N)).astype(np.float32)
    for dd, ll in ((2, -1), (4, -2), (2, 0), (-1, 1), (-2, 2), (1, -1)):
        assert_bitwise(JD.shift_di(jnp.asarray(M), dd, ll),
                       TD.shift_pq(torch.as_tensor(M), dd, ll))


def test_skew_qone_and_outside_aux_bitwise(batch):
    seqs, ns, _ = batch
    rng = np.random.default_rng(8)
    ext = rng.uniform(0.5, 2.0, (B, N, N)).astype(np.float32)
    one = rng.uniform(0.0, 2.0, (B, N, N)).astype(np.float32)
    live = np.arange(N)[None, :, None] < ns[:, None, None]
    ext, one = np.where(live, ext, 0), np.where(live, one, 0)
    ONEP, QONE, extL, extR, glob = PF.contra_outside_aux(
        jnp.asarray(ns), jnp.asarray(ext), jnp.asarray(one), N,
        neg=0.0, one_val=1.0,
    )
    QONE_t, extL_t, extR_t, glob_t = TPF.contra_outside_aux(
        torch.as_tensor(ns), torch.as_tensor(ext), torch.as_tensor(one), N
    )
    assert_bitwise(QONE, QONE_t)
    assert_bitwise(extL, extL_t)
    assert_bitwise(glob, glob_t)
    # JAX pre-rotates extR right by 2N - n; the port indexes it directly
    extR = np.asarray(extR)
    for k in range(B):
        np.testing.assert_array_equal(
            _bits(np.roll(extR[k], int(ns[k]))), _bits(extR_t[k].numpy())
        )
    for k in (0, 1):
        assert_bitwise(PF._skew_qone(jnp.asarray(one[k]), N, 0.0),
                       TPF._skew_qone(torch.as_tensor(one[k]), N))


def test_contra_prob_mats_merged(batch):
    seqs, ns, ls = batch
    mi_j, mo_j, acc_j, b0_j = P8.contra_prob_mats_merged(
        jnp.asarray(seqs), jnp.asarray(ns), CT, jnp.asarray(ls), N,
        interpret=True,
    )
    mi_t, mo_t, acc_t, b0_t = TP8.contra_prob_mats_merged(
        torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns), TT,
        torch.as_tensor(ls), N,
    )
    pairs = [(mi_j[k], mi_t[k]) for k in mi_j]
    pairs += [(mo_j[k], mo_t[k]) for k in mo_j]
    pairs += [(acc_j, acc_t), (b0_j, b0_t)]
    assert set(mi_j) == set(mi_t) and set(mo_j) == set(mo_t)
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
