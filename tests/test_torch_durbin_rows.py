"""The row scan of the port's Durbin path (``ops.pairhmm_rows``, kernel
K22's plain version, and ``models.durbin.durbin_match_probs_batch``)
against the JAX package's XLA row scan on the CPU.

* ``_linrec_lse``, the replica of ``lax.associative_scan``'s tree, bitwise
  against ``lax.associative_scan`` with the cubic combine at widths 1-70.
* K22's schedule (``csrc/pairhmm_rows.cu``: the c tree summed once, the
  in-place up-sweep and down-sweep over the least power of two >= the live
  columns, the items of a level dealt to T threads) replayed in plain
  torch, bitwise against the replica at every width the kernel takes.
* The whole row scan (against the JAX body run eagerly: in
  ``test_torch_durbin_rows_eager.py``) against the jitted JAX batch within
  TOL_JIT (jitted XLA
  contracts the cubic's Horner steps into fused multiply-adds, a few ulps
  a log-add; measured 2.2e-6 to 5.7e-6 at 24-96 columns); against the
  float32 NumPy oracle of the reference at a rectangular pair within 1e-4.
* Padding independence: a pair in its own bucket and in a larger one gives
  the same bits on the cropped box.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.models import durbin as JD
from rna_algos_tpu.params import build_align_scores

from rna_algos_tpu_torch.constants import PSEUDO_BASE
from rna_algos_tpu_torch.models import durbin as TD
from rna_algos_tpu_torch.numerics import lse_pair
from rna_algos_tpu_torch.ops import pairhmm_rows as PR
from rna_algos_tpu_torch.weights import align_tables

from .oracle.durbin_oracle import durbin_oracle

SC = build_align_scores()
SCJ = {k: jnp.asarray(v) for k, v in SC.items()}
TOL_JIT = 2e-5          # vs the jitted JAX batch (fused multiply-adds)
MAX_N2 = PR.MAX_N2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain row scan is many small torch ops; with several test
    workers on the machine, torch's thread pools would oversubscribe it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(extent, seed, rows=6):
    """(b, c) rows of log-space leaves with -inf runs, as a row of the scan
    sees them: c = ext + ins2 < 0, b spread over [-40, 10]; row 0 all
    finite, row 1 with a -inf tail (the dead columns), the others with a
    -inf run anywhere."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(-40.0, 10.0, (rows, extent)).astype(np.float32)
    c = rng.uniform(-3.0, -0.5, (rows, extent)).astype(np.float32)
    for r in range(1, rows):
        lo = int(rng.integers(0, extent)) if r > 1 else extent // 2
        hi = int(rng.integers(lo, extent + 1)) if r > 1 else extent
        b[r, lo:hi] = -np.inf
        c[r, lo:hi] = -np.inf
    b[:, 0] = c[:, 0] = -np.inf       # column 0 is never live
    return b, c


def _jax_linrec(b, c):
    with jax.disable_jit(), JN.force_mode("exact"):
        return np.asarray(jax.vmap(JD._linrec_lse)(jnp.asarray(b),
                                                   jnp.asarray(c)))


@pytest.mark.parametrize("widths", [range(1, 12), range(12, 33),
                                    range(33, 50), range(50, 71)],
                         ids=["1-11", "12-32", "33-49", "50-70"])
def test_linrec_replica_matches_associative_scan(widths):
    for n in widths:
        b, c = _rows(n, 100 + n)
        got = PR._linrec_lse(torch.as_tensor(b), torch.as_tensor(c), "exact")
        want = _jax_linrec(b, c)
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32), err_msg=str(n))


def k22_scan(b, c, L, T, skip_down=None):
    """K22's scan of one row, as the kernel's loops run it: b, c (R, Wp)
    leaves (columns >= L are the kernel's -inf pads); T threads, item k of
    a level to thread k mod T.  Checks that no item of a level reads a
    slot another item of the level writes, and that the items of a level
    are dealt to the threads once each.  Returns the scanned b.
    ``skip_down``: a down-sweep level left out (a mutation)."""
    R, Wp = b.shape
    lg = Wp.bit_length() - 1
    assert 1 << lg == Wp
    # the c tree, level l at ofs(l) = 2 (Wp - Wp / 2^l)
    hc = torch.full((R, 2 * Wp), float("-inf"))
    hc[:, :Wp] = c
    ofs = 0
    for l in range(1, lg + 1):
        prev, ofs = ofs, ofs + (Wp >> (l - 1))
        assert ofs == 2 * (Wp - (Wp >> l))
        k = torch.arange(Wp >> l)
        hc[:, ofs + k] = hc[:, prev + 2 * k] + hc[:, prev + 2 * k + 1]
    sd = b.clone()

    def level(pos, left, cidx):
        dealt = [list(range(t, len(pos), T)) for t in range(T)]
        assert sorted(sum(dealt, [])) == list(range(len(pos)))
        assert not set(pos.tolist()) & set(left.tolist())
        sd[:, pos] = lse_pair(sd[:, pos], hc[:, cidx] + sd[:, left], "exact")

    ofs = 0
    for l in range(1, lg + 1):
        h = 1 << (l - 1)
        k = torch.arange(Wp >> l)
        pos = (k + 1) * 2 * h - 1
        level(pos, pos - h, ofs + 2 * k + 1)
        ofs += Wp >> (l - 1)
    for l in range(lg - 1, -1, -1):
        s, m = 1 << l, Wp >> (l + 1)
        if m < 2 or l == skip_down:
            continue
        k = torch.arange(1, m)
        pos = (2 * k + 1) * s - 1
        level(pos, pos - s, 2 * (Wp - (Wp >> l)) + 2 * k)
    return sd


def _pads(b, c, Wp):
    R, L = b.shape
    pad = torch.full((R, Wp - L), float("-inf"))
    return torch.cat([b, pad], 1), torch.cat([c, pad], 1)


@pytest.mark.parametrize("T", [32, 1024])
def test_k22_schedule_matches_replica(T):
    """Every width the kernel takes (Wp = 1 .. MAX_N2), live widths at and
    around its edges: the kernel's tree over Wp equals the replica over
    the live columns, bit for bit, on the live columns."""
    Wp = 1
    while Wp <= MAX_N2:
        # the live widths the kernel sums over Wp: (Wp / 2, Wp]
        lives = sorted({L for L in (Wp // 2 + 1, Wp - 1, Wp)
                        if Wp // 2 < L <= Wp})
        for L in lives:
            b, c = (torch.as_tensor(x) for x in _rows(L, Wp + L))
            want = PR._linrec_lse(b, c, "exact")
            got = k22_scan(*_pads(b, c, Wp), L, T)[:, :L]
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (Wp, L)
        Wp *= 2


@pytest.mark.parametrize("skip", [0, 3])
def test_k22_schedule_fails_with_a_level_skipped(skip):
    """The replay is not vacuous: a down-sweep that leaves out one level
    gives other bits on the live columns."""
    b, c = (torch.as_tensor(x) for x in _rows(64, 7))
    want = PR._linrec_lse(b, c, "exact")
    assert torch.equal(k22_scan(b, c, 64, 32), want)
    got = k22_scan(b, c, 64, 32, skip_down=skip)
    assert not torch.equal(got[:2], want[:2])


def random_rect(N1, N2, P, seed, lengths=None):
    """(s1, n1, s2, n2) numpy: P sentinel-wrapped pairs in an (N1, N2)
    bucket; pair 0 fills the bucket, pair 1 is (2, 2) (no inner cell),
    the others random in [2, N] (or the given (n1, n2) ``lengths``)."""
    rng = np.random.default_rng(seed)
    s1 = np.full((P, N1), PSEUDO_BASE, np.int32)
    s2 = np.full((P, N2), PSEUDO_BASE, np.int32)
    if lengths is None:
        n1 = rng.integers(2, N1 + 1, P)
        n2 = rng.integers(2, N2 + 1, P)
        n1[0], n2[0] = N1, N2
        n1[1], n2[1] = 2, 2
        lengths = list(zip(n1, n2))
    n1 = np.array([a for a, _ in lengths], np.int32)
    n2 = np.array([b for _, b in lengths], np.int32)
    for p in range(P):
        s1[p, 1:n1[p] - 1] = rng.integers(0, 4, n1[p] - 2)
        s2[p, 1:n2[p] - 1] = rng.integers(0, 4, n2[p] - 2)
    return s1, n1, s2, n2


def port_probs(s1, n1, s2, n2, N1, N2, mode, sc=SC):
    args = [torch.as_tensor(x) for x in (s1, n1, s2, n2)]
    return TD.durbin_match_probs_batch(*args, align_tables(sc, "cpu"), N1,
                                       N2, mode).numpy()


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("N1,N2", [(24, 40), (40, 24)])
def test_plain_matches_jitted_jax(N1, N2, mode):
    pairs = random_rect(N1, N2, 8, N1 + N2)
    got = port_probs(*pairs, N1, N2, mode)
    with JN.force_mode(mode):
        want = np.asarray(JD.durbin_match_probs_batch(
            *(jnp.asarray(x) for x in pairs), SCJ, N1=N1, N2=N2))
    assert np.abs(got - want).max() <= TOL_JIT
    np.testing.assert_array_equal(got > 0, want > 0)


def test_plain_matches_oracle_rectangular():
    """The float32 NumPy oracle of the reference (streaming log-adds) at
    one rectangular pair: within 1e-4."""
    s1, n1, s2, n2 = random_rect(30, 44, 1, 9, lengths=[(27, 44)])
    got = port_probs(s1, n1, s2, n2, 30, 44, "parity")[0]
    want = durbin_oracle(s1[0, :27], s2[0, :44], SC)
    assert want.shape == (27, 44)
    assert np.abs(got[:27, :44] - want).max() <= 1e-4
    assert (got[27:] == 0).all() and got.max() > 0.05


@pytest.mark.parametrize("backward", [False, True], ids=["forward",
                                                         "backward"])
def test_padding_independence(backward):
    """One pass of pairs in their own bucket and in a larger one (rows and
    columns): the box [0, n1-2] x [0, n2-2] bitwise equal, -inf outside,
    the corners equal."""
    lengths = [(13, 21), (2, 9), (13, 2), (7, 21)]
    small = random_rect(13, 21, 4, 17, lengths=lengths)
    big = [np.full((4, 24), PSEUDO_BASE, np.int32), small[1],
           np.full((4, 40), PSEUDO_BASE, np.int32), small[3]]
    big[0][:, :13], big[2][:, :21] = small[0], small[2]
    at = align_tables(SC, "cpu")
    ms = at["match_scores"].expand(4, 5, 5).contiguous()
    ins = at["insert_scores"].expand(4, 5).contiguous()
    scal = torch.stack([at[k] for k in (
        "match2match_score", "match2insert_score", "insert_extend_score",
        "init_match_score", "init_insert_score")])
    if backward:
        scal[3:] = 0.0

    def run(s1, n1, s2, n2):
        return PR.pairhmm_rows(torch.as_tensor(s1), torch.as_tensor(s2),
                               torch.as_tensor(n1), torch.as_tensor(n2), ms,
                               ins, scal, backward, "parity")

    (pa, ca), (pb, cb) = run(*small), run(*big)
    assert torch.equal(ca, cb)
    for p, (a, b) in enumerate(lengths):
        box = (slice(0, a - 1), slice(0, b - 1))
        assert torch.equal(pa[p][box].view(torch.int32),
                           pb[p][box].view(torch.int32))
        for plane, (R, C) in ((pa[p], (13, 21)), (pb[p], (24, 40))):
            outside = torch.ones((R, C), dtype=torch.bool)
            outside[box] = False
            assert (plane[outside] == float("-inf")).all()
    assert torch.isfinite(pa[0][:12, 1:20]).any()


def test_single_pair_entry_point():
    """``durbin_match_probs`` (one pair) is the batch's row."""
    s1, n1, s2, n2 = random_rect(10, 14, 2, 3, lengths=[(10, 14), (8, 5)])
    batch = port_probs(s1, n1, s2, n2, 10, 14, "exact")
    at = align_tables(SC, "cpu")
    for p in range(2):
        one = TD.durbin_match_probs(torch.as_tensor(s1[p]), int(n1[p]),
                                    torch.as_tensor(s2[p]), int(n2[p]), at,
                                    10, 14)
        np.testing.assert_array_equal(one.numpy(), batch[p])
