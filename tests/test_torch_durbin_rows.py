"""The row scan of the port's Durbin path (``ops.pairhmm_rows``, kernel
K22's plain version, and ``models.durbin.durbin_match_probs_batch``)
against the JAX package's XLA row scan on the CPU.

* ``_linrec_lse``, the replica of ``lax.associative_scan``'s tree, bitwise
  against ``lax.associative_scan`` with the cubic combine at widths 1-70.
* K22's schedule (``csrc/pairhmm_rows.cu``: the c tree summed once, the
  in-place up-sweep and down-sweep over a power of two >= the live
  columns, a thread's run of R columns holding the tree's lowest levels,
  the next five across a warp's lanes by shuffles, then over a block's
  warps and a cluster's blocks, the sweeps down with each warp's and
  block's carry; past what registers hold, longer runs) replayed in plain
  torch, bitwise against the replica at every power of two up to 65,536
  columns, each level's tree nodes computed once; a level, a shuffle
  level or the cluster's exchange left out gives other bits.
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


def _shfl_up(v, s, dim):
    """__shfl_up_sync along ``dim``: unit u takes unit u - s, units below s
    keep their own."""
    u = torch.arange(v.shape[dim])
    return v.index_select(dim, torch.where(u >= s, u - s, u))


def _up_nodes(n, m):
    """Units of n that combine at level m of the sweeps up."""
    return ((torch.arange(n) + 1) & ((2 << m) - 1)) == 0


def _down_nodes(n, m):
    """Units of n that combine at level m of the sweeps down (the first
    such unit's left operand is the unit before the group: its carry)."""
    s = 1 << m
    return ((torch.arange(n) + 1) & (2 * s - 1)) == s


def k22_layout(W, T, C=None):
    """(R, T, C) of K22 (csrc/pairhmm_rows.cu rows_plan) at a power of two
    W >= 64 with at most T threads a block: runs of R = 2 columns in
    registers over the fewest blocks (or C, given) while W <= 2 * T * 8;
    past that 8 blocks of T threads and runs of W / (8 T) columns (the
    global scratch)."""
    if W <= 2 * T * 8:
        units = W // 2
        C = C or max(1, units // T)
        return 2, units // C, C
    C = C or 8
    return W // (T * C), T, C


def k22_scan(b, c, L, T, C=None, skip=None, check=True):
    """K22's scan of rows (b, c) as the kernel deals it (rows_body): the
    columns padded with -inf to the layout's W = R T C (``k22_layout``),
    thread g of the pair owning the run [g R, (g + 1) R); the tree's
    levels in the run, across a warp's lanes by shuffles, over a block's
    warps, over the cluster's blocks (each block summing the block
    aggregates itself); the sweeps down with each warp's and block's
    carry.  ``check``: every level computes each of its tree nodes once
    and reads no position it writes.  ``skip``: a mutation, ("down", l)
    leaves out global down-sweep level l, ("shfl_up", m) / ("shfl_down",
    m) a warp's shuffle level, ("cluster",) the exchange of the block
    aggregates.  Returns the scanned b on b's columns."""
    R0, L0 = b.shape
    Wp = 1
    while Wp < max(L0, 64):
        Wp *= 2
    R, T, C = k22_layout(Wp, T, C)
    NW = T // 32
    lr, lw, lc = (x.bit_length() - 1 for x in (R, NW, C))
    assert R * T * C == Wp and NW * 32 == T
    pad = torch.full((R0, Wp - L0), float("-inf"))
    shape = (R0, C, NW, 32, R)
    d = torch.cat([b, pad], 1).view(shape).clone()
    cl = torch.cat([c, pad], 1).view(shape)
    pos = torch.arange(Wp).view(C, NW, 32, R)
    levels = {}

    def lse(x, cv, y):
        return lse_pair(x, cv + y, "exact")

    def record(key, nodes, lefts):
        w, r = levels.setdefault(key, ([], []))
        w.append(nodes.flatten())
        r.append(lefts.flatten())

    # the c sums: the run's tree, then the warps', blocks' and cluster's
    ct = [cl]
    for _ in range(lr):
        ct.append(ct[-1][..., 0::2] + ct[-1][..., 1::2])

    def csums(s, dim, n, lv):
        sums = []
        for m in range(lv):
            sums.append(s)
            mask = _up_nodes(n, m).view([-1] + [1] * (s.dim() - dim - 1))
            s = torch.where(mask, _shfl_up(s, 1 << m, dim) + s, s)
        return sums, s

    cw, s = csums(ct[lr][..., 0], 3, 32, 5)
    cb, s = csums(s[..., 31], 2, NW, lw)
    cc, _ = csums(s[..., NW - 1], 1, C, lc)

    def up(v, vpos, cs, dim, n, lv, l0, key=None):
        """The sweeps up over n units along dim (levels l0 + 1 + m)."""
        for m in range(lv):
            if skip == (key, m):
                continue
            mask = _up_nodes(n, m)
            view = [-1] + [1] * (v.dim() - dim - 1)
            u = _shfl_up(v, 1 << m, dim)
            v = torch.where(mask.view(view), lse(v, cs[m], u), v)
            sel = [slice(None)] * (dim - 1) + [mask]
            record(("up", l0 + 1 + m), vpos[tuple(sel)],
                   _shfl_up(vpos, 1 << m, dim - 1)[tuple(sel)])
        return v

    def down(v, vpos, cs, dim, n, lv, l0, carry, cpos, has, key=None):
        """The sweeps down over n units along dim (levels l0 + m); the
        first unit's carry ``carry`` (at position cpos) where ``has``."""
        for m in reversed(range(lv)):
            if skip in (("down", l0 + m), (key, m)):
                continue
            s = 1 << m
            mask = _down_nodes(n, m)
            inside = mask & (torch.arange(n) >= s)
            edge = mask & (torch.arange(n) < s)
            view = [-1] + [1] * (v.dim() - dim - 1)
            u = _shfl_up(v, s, dim)
            v = torch.where(inside.view(view), lse(v, cs[m], u), v)
            cview = carry.unsqueeze(dim).expand_as(v)
            hv = has.view(list(has.shape) + [1] * (v.dim() - 1 - has.dim()))
            v = torch.where(edge.view(view) & hv, lse(v, cs[m], cview), v)
            sel = [slice(None)] * (dim - 1) + [inside]
            record(("down", l0 + m), vpos[tuple(sel)],
                   _shfl_up(vpos, s, dim - 1)[tuple(sel)])
            if edge.any() and has.any():
                sel = [slice(None)] * (dim - 1) + [edge]
                hp = has.view(list(has.shape)
                              + [1] * (vpos.dim() - has.dim()))
                nodes = vpos[tuple(sel)][hp.expand_as(vpos)[tuple(sel)]]
                lefts = cpos.unsqueeze(dim - 1).expand_as(vpos)[tuple(sel)]
                record(("down", l0 + m), nodes,
                       lefts[hp.expand_as(vpos)[tuple(sel)]])
        return v

    # up: the run's levels, the warp's (shuffles), the block's, the cluster's
    for l in range(1, lr + 1):
        h = 1 << (l - 1)
        k = torch.arange(2 * h - 1, R, 2 * h)
        d[..., k] = lse(d[..., k], ct[l - 1][..., k >> (l - 1)], d[..., k - h])
        record(("up", l), pos[..., k], pos[..., k - h])
    lastpos = pos[..., R - 1]                        # (C, NW, 32)
    top = up(d[..., R - 1], lastpos, cw, 3, 32, 5, lr, "shfl_up")
    wpos = lastpos[..., 31]                          # (C, NW)
    wv = up(top[..., 31], wpos, cb, 2, NW, lw, lr + 5)
    bpos = wpos[..., NW - 1]                         # (C,)
    bv = wv[..., NW - 1]
    first_block = torch.arange(C) == 0
    if skip == ("cluster",) or C == 1:
        bfinal = bv
        bcarry = torch.full_like(bv, float("-inf"))
    else:
        u = up(bv, bpos, cc, 1, C, lc, lr + 5 + lw)
        u = down(u, bpos, cc, 1, C, lc, lr + 5 + lw, torch.zeros(R0),
                 bpos, torch.zeros(C, dtype=torch.bool))
        bfinal = u
        bcarry = torch.cat([torch.full_like(u[:, :1], float("-inf")),
                            u[:, :-1]], 1)
    # down: the block's levels with its carry, the warp's, the run's
    cprev = torch.cat([bpos[:1], bpos[:-1]])        # position before block
    wv = down(wv, wpos, cb, 2, NW, lw, lr + 5, bcarry, cprev, ~first_block)
    if C > 1:
        wv[..., NW - 1] = bfinal
    fin = torch.cat([bcarry.unsqueeze(2), wv], 2)   # fin[q]: before warp q
    wprev = torch.cat([cprev.unsqueeze(1), wpos[:, :-1]], 1)
    lead_warp = torch.zeros(C, NW, dtype=torch.bool)
    lead_warp[0, 0] = True
    top = top.clone()
    top[..., 31] = fin[..., 1:]
    top = down(top, lastpos, cw, 3, 32, 5, lr, fin[..., :-1], wprev,
               ~lead_warp, "shfl_down")
    d[..., R - 1] = top
    prev = _shfl_up(top, 1, 3)
    prev[..., 0] = fin[..., :-1]
    ppos = _shfl_up(lastpos, 1, 2)
    ppos[..., 0] = wprev
    lead = torch.zeros(C, NW, 32, dtype=torch.bool)
    lead[0, 0, 0] = True
    for l in reversed(range(lr)):
        if skip == ("down", l):
            continue
        s = 1 << l
        for k in range(s - 1, R, 2 * s):
            cv = ct[l][..., k >> l]
            if k >= s:
                d[..., k] = lse(d[..., k], cv, d[..., k - s])
                record(("down", l), pos[..., k], pos[..., k - s])
            else:
                d[..., k] = torch.where(~lead, lse(d[..., k], cv, prev),
                                        d[..., k])
                record(("down", l), pos[..., k][~lead], ppos[~lead])
    if check:
        lg = Wp.bit_length() - 1
        for l in range(1, lg + 1):
            want = torch.arange(1, Wp // (1 << l) + 1) * (1 << l) - 1
            _check_level(levels, ("up", l), want)
        for l in range(lg):
            s = 1 << l
            want = (2 * torch.arange(1, Wp // (2 * s)) + 1) * s - 1
            _check_level(levels, ("down", l), want)
    return d.view(R0, Wp)[:, :L0]


def _check_level(levels, key, want):
    """A level's nodes are the tree's, each computed once, and none is a
    left operand of the same level."""
    w, r = levels.get(key, ([torch.empty(0, dtype=torch.long)],
                            [torch.empty(0, dtype=torch.long)]))
    w, r = torch.cat(w), torch.cat(r)
    assert w.numel() == want.numel(), key
    assert torch.equal(w.sort().values, want), key
    assert not torch.isin(r, w).any(), key


WIDEST = 65536     # the replays' widest row (K22 takes any width)


@pytest.mark.parametrize("T", [32, 1024])
def test_k22_schedule_matches_replica(T):
    """Every power of two up to WIDEST as the tree's width Wp (the kernel
    pads to 64 and more), live widths at and around its edges, T threads
    a block at most: the kernel's deal (runs, shuffles, warps, a cluster of
    blocks, past 4 T 8 columns the scratch's longer runs) equals the
    replica over the live columns, bit for bit; a handful of rows past
    4,096."""
    Wp = 1
    while Wp <= WIDEST:
        # the live widths the kernel sums over Wp: (Wp / 2, Wp]
        lives = sorted({L for L in (Wp // 2 + 1, Wp - 1, Wp)
                        if Wp // 2 < L <= Wp})
        for L in lives:
            rows = 6 if Wp <= 4096 else 3
            b, c = (torch.as_tensor(x) for x in _rows(L, Wp + L, rows))
            want = PR._linrec_lse(b, c, "exact")
            got = k22_scan(b, c, L, T)
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
    got = k22_scan(b, c, 64, 32, skip=("down", skip), check=False)
    assert not torch.equal(got[:2], want[:2])


@pytest.mark.parametrize("skip", [("shfl_up", 2), ("shfl_down", 1),
                                  ("cluster",)],
                         ids=["shuffle-up", "shuffle-down", "cluster"])
def test_k22_schedule_fails_without_a_shuffle_or_the_cluster(skip):
    """A shuffle level of the warps, up or down, or the exchange of the
    block aggregates over a cluster of 8 blocks left out gives other bits
    on the live columns."""
    b, c = (torch.as_tensor(x) for x in _rows(512, 11, 3))
    want = PR._linrec_lse(b, c, "exact")
    assert k22_layout(512, 32) == (2, 32, 8)
    assert torch.equal(k22_scan(b, c, 512, 32), want)
    got = k22_scan(b, c, 512, 32, skip=skip, check=False)
    assert not torch.equal(got, want)


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
