"""The schedule of kernels K20/K21 (``csrc/fold_scan.cu``) replayed in
plain PyTorch on the CPU.

A group of g threads reduces a tree: thread t holds the terms k = t + m g,
m < L (the least power of two with L g >= the tree's live extent).  Under
the cubic modes it takes its positions q in order, leaf m = bitrev(q), and
closes the halving tree over them with a stack of one partial sum a level
(``ScanTree``), 4 positions at a time once it has 4 (a run, closed as
the subtree the stack would build): a dead term is -inf, the context's
tree is walked from the root and a block of positions with no live term
pushed whole as one -inf block, and the sums meet with ``lse_pair``
unless one side is -inf (then the other, bit for bit).  Then the group halves over its
threads.  That must be ``numerics.lse_reduce``'s tree bit for bit at every
g the kernels may use (1 to 512) and every L (1 to 256): over the 2-loop
windows (K20's a + b <= d - 2, K21's outer pairs inside the sequence), the
O(d) sums, K21's pm/pm2 trees over their own extent and its context tree
(three segments at t, N + t, 2N + t, 1 <= t <= i) over 2N + i + 1, where
the plain outside pass sums the window and the context over one shared
width.  Under "fast" a thread keeps a running max and sum of exp(x - max)
and the group merges the pairs: within 1e-6 of the max-form.

The work: the span loop replayed (``fold_scan.span_work``, ``span_units``,
the lane offsets) at N = 160 on the edge lengths and at N = 384 on mixed
ones, on a full grid and on grids small enough that the items take many
rounds: each live (b, i) goes to exactly one group a span, the lists of
lanes that can close or pair are built before they are read, and each
window is summed once, a span before its lane needs it.  The group
chooser covers every tree up to 3 MAX_N and refuses the next.
"""

import numpy as np
import pytest
import torch

from rna_algos_tpu_torch.numerics import lse_pair, lse_reduce
from rna_algos_tpu_torch.ops import fold_scan as FS

NEG_INF = float("-inf")
# (group width, extent): L = 1, 2, 16, 32, 64 and 128 leaves a thread; the
# window (961), K21's context tree at N = 384 and 1536 and at MAX_N
CASES = ((64, 961), (1024, 961), (32, 1000), (64, 1152 - 7), (32, 1152),
         (512, 3 * 1536 - 5), (64, 3 * 1536), (1024, 3 * FS.MAX_N))
GROUPS = (1, 2, 4, 8, 16, 32, 64, 512)


def _terms(extent, seed, rows=8):
    """Rows of log-space terms, with runs of -inf (the identity): in
    [-3, 3], where every term moves the sum and so the order shows in the
    last bits, and in [-60, 40]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, (rows, extent)).astype(np.float32)
    x[rows // 2:] = rng.uniform(-60.0, 40.0, (rows - rows // 2, extent))
    for r in range(rows):
        lo = int(rng.integers(0, extent))
        x[r, lo:int(rng.integers(lo, extent + 1))] = -np.inf
    return torch.as_tensor(x)


def _bitrev(q, lg):
    return int(format(q, f"0{lg}b")[::-1], 2) if lg else 0


def _merge(a, b, mode):
    """ScanTree's merge: lse_pair, the other side where one is -inf."""
    return torch.where((a == NEG_INF) | (b == NEG_INF), torch.maximum(a, b),
                       lse_pair(a, b, mode))


class Stack:
    """A group's per-thread stacks (rows, g) a level, as ScanTree keeps
    them: an entry stands at each set bit of the positions taken."""

    def __init__(self, mode):
        self.mode = mode
        self.a = {}

    def block(self, q, z, x):
        """The subtree x of the 2^z positions at q closes the levels
        [z, zt) (q's trailing ones above z) and stands at zt."""
        zt = z
        while (q >> zt) & 1:
            x = _merge(self.a[zt], x, self.mode)
            zt += 1
        self.a[zt] = x

    def finish(self, q, like):
        v = torch.full_like(like, NEG_INF)
        for lev in range(q.bit_length()):
            if (q >> lev) & 1:
                v = _merge(self.a[lev], v, self.mode)
        return v


def context_live(k0, S, cnt, i, N):
    """``ContextLive`` in csrc/fold_scan.cu: is any term of the context's
    three segments among k0 + u S, u < cnt?"""
    for seg in range(3):
        lo, hi = seg * N + 1, seg * N + i
        u = (lo - k0 + S - 1) // S if lo > k0 else 0
        if u < cnt and k0 + u * S <= hi:
            return True
    return False


def context_thread_tree(x, t, g, E, mode, live, i, N):
    """``thread_tree`` with ``ContextLive`` for thread t alone (rows of
    x): the walk from the root, a dead block (checked dead by brute force)
    pushed whole at its level, a live one split down to runs."""
    R, width = x.shape
    L = FS.pow2_ceil(-(-E // g))
    lg = max(L.bit_length() - 1, 0)
    st = Stack(mode)
    neg = torch.full((R,), NEG_INF)

    def leaf(k):
        ok = k < E and live(k)
        return x[:, min(k, width - 1)] if ok else neg

    if L < FS.RUN:
        for q in range(L):
            st.block(q, 0, leaf(t + _bitrev(q, lg) * g))
        return st.finish(L, neg)
    q = 0
    while q < L:
        z = (q & -q).bit_length() - 1 if q else lg
        while True:
            k0, S = t + _bitrev(q, lg) * g, (L >> z) * g
            if not context_live(k0, S, 1 << z, i, N):
                assert not any(live(k0 + u * S) for u in range(1 << z)
                               if k0 + u * S < E)
                st.block(q, z, neg)
                q += 1 << z
                z = -1
                break
            if z == 2:
                break
            z -= 1
        if z < 0:
            continue
        xs = [leaf(t + _bitrev(q + u, lg) * g) for u in range(FS.RUN)]
        st.block(q, 2, _merge(_merge(xs[0], xs[1], mode),
                              _merge(xs[2], xs[3], mode), mode))
        q += FS.RUN
    return st.finish(L, neg)


def group_tree(x, g, mode, E=None, live=None, context=None):
    """A group of g threads' tree over the terms x (rows, width) with live
    extent E (default: the width), as ``thread_tree`` takes it: dead terms
    (k >= E, or ``live(k)`` false) -inf; once L >= RUN the positions RUN at
    a time, each run closed as the static subtree ((x0 (+) x1) (+) (x2 (+)
    x3)) and pushed at level 2; with ``context = (i, N)`` each thread walks
    its tree (``context_thread_tree``); then the halving tree over the
    threads."""
    R, width = x.shape
    E = width if E is None else E
    if context is not None:
        y = torch.stack([context_thread_tree(x, t, g, E, mode, live,
                                             *context) for t in range(g)], 1)
        while y.shape[1] > 1:
            h = y.shape[1] // 2
            y = _merge(y[:, :h], y[:, h:], mode)
        return y[:, 0]
    L = FS.pow2_ceil(-(-E // g)) if E > 0 else 0
    lg = max(L.bit_length() - 1, 0)
    st = Stack(mode)
    neg = torch.full((R, g), NEG_INF)
    ts = torch.arange(g)
    z = FS.RUN.bit_length() - 1

    def leaves(q):
        k = ts + _bitrev(q, lg) * g
        ok = k < E
        if live is not None:
            ok &= torch.tensor([bool(live(int(c))) for c in k])
        return torch.where(ok, x[:, k.clamp(max=width - 1)], neg)

    if L < FS.RUN:
        for q in range(L):
            st.block(q, 0, leaves(q))
    for q0 in range(0, L if L >= FS.RUN else 0, FS.RUN):
        xs = [leaves(q0 + u) for u in range(FS.RUN)]
        st.block(q0, z, _merge(_merge(xs[0], xs[1], mode),
                               _merge(xs[2], xs[3], mode), mode))
    y = st.finish(L, neg)
    while y.shape[1] > 1:
        h = y.shape[1] // 2
        y = _merge(y[:, :h], y[:, h:], mode)
    return y[:, 0]


def kernel_tree(x, T, mode):
    """The tree of a group of T threads over every term of x."""
    return group_tree(x, T, mode)


def kernel_tree_fast(x, T):
    """The fast order: a running (max, sum of exp(x - max)) a thread over
    its positions, then the threads' pairs merged by halving."""
    R, E = x.shape
    L = FS.pow2_ceil(-(-E // T))
    lg = max(L.bit_length() - 1, 0)
    pad = torch.full((R, L * T - E), NEG_INF)
    v = torch.cat([x, pad], 1).view(R, L, T)
    mx = torch.full((R, T), NEG_INF)
    sm = torch.zeros(R, T)
    for q in range(L):
        y = v[:, _bitrev(q, lg)]
        live = y != NEG_INF
        up = live & (y > mx)
        sm = torch.where(up, sm * torch.exp(mx - y) + 1.0,
                         torch.where(live, sm + torch.exp(y - mx), sm))
        mx = torch.where(up, y, mx)
    while mx.shape[1] > 1:
        h = mx.shape[1] // 2
        a, b = mx[:, :h], mx[:, h:]
        M = torch.maximum(a, b)
        both = sm[:, :h] * torch.exp(a - M) + sm[:, h:] * torch.exp(b - M)
        sm = torch.where(M != NEG_INF, both, sm[:, :h])
        mx = M
    m, s = mx[:, 0], sm[:, 0]
    return torch.where(torch.isfinite(m), m + torch.log(s),
                       torch.full_like(m, NEG_INF))


def _bits_equal(got, want):
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode", ["exact", "parity"])
@pytest.mark.parametrize("T,extent", CASES)
def test_kernel_tree_is_lse_reduce(T, extent, mode):
    x = _terms(extent, seed=T + extent)
    _bits_equal(kernel_tree(x, T, mode), lse_reduce(x, -1, mode))


@pytest.mark.parametrize("T,extent", CASES)
def test_kernel_tree_fast(T, extent):
    x = _terms(extent, seed=T + extent + 1)
    got = kernel_tree_fast(x, T)
    want = lse_reduce(x, -1, "fast")
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert bool(((got - want)[fin].abs()
                 <= 1e-6 * want[fin].abs().clamp(min=1.0)).all())


def test_kernel_tree_all_identity():
    x = torch.full((2, 1000), NEG_INF)
    assert (kernel_tree(x, 32, "exact") == NEG_INF).all()
    assert (kernel_tree_fast(x, 32) == NEG_INF).all()


def _live_terms(x, live):
    """x with -inf at every dead term, so that skipping a live one shows."""
    ok = torch.tensor([bool(live(k)) for k in range(x.shape[1])])
    return torch.where(ok, x, torch.full((), NEG_INF))


def _dense(extent, seed, rows=4):
    """Finite terms in [-3, 3] (every live term moves the sum)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.uniform(-3.0, 3.0, (rows, extent)).astype(np.float32))


# K20's window at span d: (a, b), a + b <= d - 2, at a * 31 + b
INSIDE_SPANS = (3, 10, 33, 62, 200)


@pytest.mark.parametrize("mode", ["exact", "parity"])
@pytest.mark.parametrize("g", GROUPS)
def test_inside_window_trees(g, mode):
    """K20's window over its live extent, with the holes a + b > d - 2
    and inner pairs whose close is -inf tested dead: lse_reduce over the
    plain pass's 961 terms."""
    W = FS.W
    for d in INSIDE_SPANS:
        x = _dense(W * W, seed=d + g)
        x[:, ::7] = NEG_INF            # closes that are -inf
        live = lambda k, d=d: (k // W + k % W <= d - 2 and k < W * W  # noqa
                               and k % 7 != 0)
        want = lse_reduce(_live_terms(x, live), -1, mode)
        got = group_tree(x, g, mode, E=FS.inside_window_extent(d),
                         live=live)
        _bits_equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "parity"])
@pytest.mark.parametrize("g", GROUPS)
def test_outside_split_trees(g, mode):
    """K21's trees split: pm/pm2 over k in [1, n - 1 - j] (their extent
    n - j), the window over the outer pairs inside the sequence (a <= i -
    1, b <= n - 2 - j) and the context over 2N + i + 1 positions with its
    dead runs skipped, each against the plain outside pass's trees: pm/pm2
    over the batch's widest extent, the window and the context over one
    width max(961, 2N + Lc + 1)."""
    W = FS.W
    for N, n, i, j, Lc in ((160, 160, 70, 90, 140), (160, 97, 3, 50, 150),
                           (384, 384, 1, 1, 380), (1536, 1500, 37, 900,
                                                   1400)):
        width = max(W * W, 2 * N + Lc + 1)
        ctx_live = lambda k, i=i, N=N: 1 <= k % N <= i and k < 3 * N  # noqa
        x = _dense(width, seed=N + i)
        want = lse_reduce(_live_terms(x, ctx_live), -1, mode)
        got = group_tree(x, g, mode, E=2 * N + i + 1, live=ctx_live,
                         context=(i, N))
        _bits_equal(got, want)
        amax, bmax = min(W - 1, i - 1), min(W - 1, n - 2 - j)
        win_live = lambda k, a=amax, b=bmax: k // W <= a and k % W <= b  # noqa
        x = _dense(width, seed=N + j)
        want = lse_reduce(_live_terms(x, win_live), -1, mode)
        got = group_tree(x, g, mode, E=amax * W + bmax + 1, live=win_live)
        _bits_equal(got, want)
        pm_live = lambda k, r=n - 1 - j: 1 <= k <= r  # noqa
        x = _dense(N, seed=j)
        want = lse_reduce(_live_terms(x, pm_live), -1, mode)
        got = group_tree(x, g, mode, E=n - j, live=pm_live)
        _bits_equal(got, want)


@pytest.mark.parametrize("mode", ["exact", "parity"])
@pytest.mark.parametrize("g", (1, 4, 32, 512))
def test_inside_sums_and_dead_runs(g, mode):
    """The O(d) sums (terms 0 .. d - 1, s1/s2 from 1) over extent d, and
    a context whose whole segments lie past i (runs of dead positions):
    lse_reduce over the plain width."""
    for d in (1, 2, 5, 64, 513, 1000):
        x = _dense(max(d, 1), seed=d)
        if d % 2:
            x[:, 0] = NEG_INF
        _bits_equal(group_tree(x, g, mode, E=d), lse_reduce(x, -1, mode))
    N, i = 1536, 5
    x = _dense(3 * N, seed=g)
    live = lambda k: 1 <= k % N <= i  # noqa: E731
    _bits_equal(group_tree(x, g, mode, E=2 * N + i + 1, live=live,
                           context=(i, N)),
                lse_reduce(_live_terms(x, live), -1, mode))


def test_dead_block_is_dead_leaves():
    """Pushing an aligned run of 2^z -inf positions whole leaves the
    stack as 2^z -inf leaves one by one would, at every level the later
    positions read."""
    rng = np.random.default_rng(3)
    for q0, z, before in ((8, 3, 8), (16, 3, 13), (24, 3, 24), (0, 3, 0),
                          (32, 4, 29)):
        a, b = Stack("exact"), Stack("exact")
        for q in range(before):
            v = torch.as_tensor(rng.uniform(-3, 3, (1, 1)).astype(np.float32))
            a.block(q, 0, v)
            b.block(q, 0, v)
        for q in range(before, q0):     # the run up to q0: dead leaves
            a.block(q, 0, torch.full((1, 1), NEG_INF))
            b.block(q, 0, torch.full((1, 1), NEG_INF))
        neg = torch.full((1, 1), NEG_INF)
        a.block(q0, z, neg)
        for q in range(q0, q0 + (1 << z)):
            b.block(q, 0, neg)
        end = q0 + (1 << z)
        for lev in range(end.bit_length()):
            if (end >> lev) & 1:
                _bits_equal(a.a[lev], b.a[lev])


def test_context_live_is_brute_force():
    """ContextLive against the terms themselves."""
    N = 160
    for i in (1, 2, 9, 80, 159):
        for S in (1, 4, 64, 256):
            for cnt in (4, 8, 64):
                for k0 in range(0, 3 * N, 7):
                    brute = any(1 <= (k0 + u * S) % N <= i
                                and k0 + u * S < 3 * N
                                for u in range(cnt))
                    assert context_live(k0, S, cnt, i, N) == brute


def _taken(g, count, blocks):
    """The items of a kind that each group takes (its thread 0's), every
    round; every thread of a group holds its group's item."""
    t, _, rounds = FS.span_units(g, count, blocks)
    taken = []
    for item in rounds:
        for blk in range(blocks):
            per_group = item[blk].reshape(-1, g)
            assert (per_group == per_group[:, :1]).all()
        got = item[t == 0]
        taken += got[got >= 0].tolist()
    return taken


def _replay_pass(inside, N, ns, blocks, marks, cap=None):
    """The span loop of K20 (``inside``) or K21 as span_work orders it,
    with every kind's items handed out by span_units: the lists (built
    from ``marks``, the lanes that can close or pair, two spans ahead and
    read only in later spans), each window summed once before its lane
    reads it, and every live lane of a span taken exactly once."""
    min_span = FS.min_span(False, False)
    off = FS.lane_offsets(torch.as_tensor(ns, dtype=torch.int32), N).numpy()
    threads = blocks * FS.SCAN_T
    lists, built, summed = {}, {}, {}

    def lanes_of(d, taken):
        b = np.searchsorted(off[d], taken, side="right") - 1
        return list(zip(b.tolist(), (np.asarray(taken) - off[d][b]).tolist()))

    def live(d):
        return sorted((b, i) for b, n in enumerate(ns) for i in range(n - d))

    def marked(d):
        return sorted(x for x in live(d) if marks[x[0], x[1], d]
                      and d + 1 >= min_span)

    def build(d, at):
        got = lanes_of(d, _taken(1, int(off[d][-1]), blocks))
        assert sorted(got) == live(d)
        lists[d] = [x for x in got if marks[x[0], x[1], d]]
        built[d] = at

    spans = range(N) if inside else range(N - 1, -1, -1)
    if not inside:
        for d in (N - 1, N - 2):
            if d >= 0 and d + 1 >= min_span:
                build(d, N)
    for d in spans:
        work = FS.span_work(inside, d, N, lambda e: int(off[e][-1]),
                            lambda e: len(lists.get(e, ())), min_span,
                            threads, cap)
        for kind, at, count, g in work:
            assert 1 <= g <= FS.SCAN_T and not g & (g - 1)
            taken = _taken(g, count, blocks)
            assert sorted(taken) == list(range(count))
            if kind == "list":
                build(at, d)
                continue
            if kind in ("window", "context"):
                assert built[at] != d and sorted(lists[at]) == marked(at)
                if kind == "window":
                    summed[at] = (d, sorted(lists[at][k] for k in taken))
                else:
                    # the window sums of span d were summed a span before
                    assert d == N - 1 or summed.get(d, (d + 1,))[0] == d + 1
                continue
            assert sorted(lanes_of(d, taken)) == live(d)
            if inside and d >= 2:
                assert summed.get(d, (d - 1, [])) == (d - 1, marked(d))
        if not inside and d < N - 1:
            assert summed.get(d, (d + 1, []))[1] == marked(d)


@pytest.mark.parametrize("inside", [True, False], ids=["K20", "K21"])
@pytest.mark.parametrize("N,ns,blocks", [
    (160, (1, 2, 3, 160, 45, 97, 130, 159), 264),
    (160, (1, 2, 3, 160, 45, 97, 130, 159), 1),
    (384, (384, 300, 201, 383, 192, 250, 330, 384), 264),
    (384, (384, 300, 201, 383, 192, 250, 330, 384), 3)])
def test_span_work_covers_every_live_lane_once(N, ns, blocks, inside):
    """At every span each live (b, i) (i + d < n_b) is taken by exactly
    one group in one round, and no dead one; the lists hold exactly the
    lanes that can close (K20) or pair (K21), built in an earlier span;
    every window is summed once, a span before its lane reads it; the
    group widths powers of two within [1, SCAN_T]; also with the
    narrowest groups."""
    marks = np.random.default_rng(N + blocks).random((len(ns), N, N)) < 0.4
    for cap in (None, 1):
        _replay_pass(inside, N, ns, blocks, marks, cap)


def test_threads_cover_every_extent_up_to_max_n():
    """The group chooser: for a context tree of each extent (N = extent /
    3, span 0, one item), a power of two within [1, SCAN_T] whose threads
    hold every position at 2^LG_OUTSIDE leaves a thread, also when held
    narrow; a tree past one block refuses."""
    for extent in (1, 961, 1024, 16 * 1024, 16 * 1024 + 1, 3 * 5462,
                   3 * FS.MAX_N):
        N = -(-extent // 3)
        width = FS.pow2_ceil(3 * N)
        for cap in (None, 1):
            g = FS.group_width(max(3 * (N - 1), 1), width, 1, FS.SCAN_T,
                               FS.LG_OUTSIDE, cap)
            assert 1 <= g <= FS.SCAN_T and not g & (g - 1)
            assert g << FS.LG_OUTSIDE >= width
    with pytest.raises(ValueError, match="exceeds one block"):
        FS.group_width(1, FS.pow2_ceil(3 * (FS.MAX_N + 1)), 1, FS.SCAN_T,
                       FS.LG_OUTSIDE)
