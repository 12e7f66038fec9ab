"""The split trees of the parity kernels K16-K19 (``csrc/fold_log.cuh``,
``rna_split_tree``, ``rna_log_split_window``,
``rna_log_split_bifurcation``): a plain-torch replica of the split,
bitwise against the port's plain halving tree ``_lse_rows`` and the plain
inside pass's sums.

A lane's group of G threads splits a tree of L leaves by residue: thread r
reduces the leaves t = r + G j by the halving tree over j, itself split into
classes j = c (mod S) of 8 leaves and the S class sums; the group's top
log2 G levels pair thread r with r + G/2, r + G/4, ...  Every subtree, class
and level whose leaves all lie past the live ones is skipped, as the kernels
skip them.  The replica follows that order step by step and must give the
bits of ``_lse_rows`` over a 256-row tree with -inf past L: the claim that
makes K16-K19 bitwise equal to their plain versions.  Leaves are random
log values with -inf leaves and all -inf runs, from a seed; tree sizes
1-256, G = 1, 2, 4, 8, 16, 32.  The inside kernels' sums are replayed at
every span d < N of N = 32 and 64: the three bifurcation trees over t < d,
reduced together, against the plain inside pass's leaves at its reduction
height; the window's trees a <= min(30, d - 2) over their
min(31 - a, d - 1 - a) live leaves, dealt whole to a group's threads and
folded in order a, against ``_fold_windows``.  Torch on one thread, as the
parity files."""

import numpy as np
import pytest
import torch

from rna_algos_tpu_torch.constants import NEG_INF
from rna_algos_tpu_torch.ops import pallas_fold as TPF

H_PLAIN = 256     # RNA_LOG_MAX_N: the tallest tree the plain versions reduce
COLS = 16         # independent trees reduced side by side
GROUPS = (1, 2, 4, 8, 16, 32)
INNER = 8         # leaves of a class inside a thread (rna_thread_tree)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def log2_ceil(m):
    k = 0
    while (1 << k) < m:
        k += 1
    return k


def halve(x, live):
    """rna_halve: the halving tree over the rows of x (a power of two),
    levels below ``live`` only."""
    h = x.shape[0] // 2
    while h >= 1:
        if h < live:
            x = torch.cat([TPF._lse(x[:h], x[h:2 * h]), x[2 * h:]])
        h //= 2
    return x[0]


def pad(rows, height):
    fill = torch.full((height - rows.shape[0],) + rows.shape[1:], NEG_INF)
    return torch.cat([rows, fill])


def thread_tree(leaves):
    """rna_thread_tree over the J rows of ``leaves`` (J, ...): classes
    c < S of 8 leaves j = c + S q, each an 8-leaf halving tree, then the S
    class sums (the classes side by side: row j = q S + c)."""
    J = leaves.shape[0]
    lg = log2_ceil(J)
    S = 1 << (lg - 3) if lg > 3 else 1
    inner = INNER if lg > 3 else 1 << lg
    x = pad(leaves, INNER * S).view(INNER, S, *leaves.shape[1:])
    return halve(halve(x, inner), S)


def split_tree(x, L, G):
    """rna_split_tree over the first L rows of x: thread r's residue class
    (threads with the same number of leaves side by side), then the group's
    top levels (off < the live power of two)."""
    v = torch.full((G,) + x.shape[1:], NEG_INF)
    counts = [(L - r + G - 1) // G if L > r else 0 for r in range(G)]
    for J in set(counts) - {0}:
        rs = [r for r in range(G) if counts[r] == J]
        v[rs] = thread_tree(torch.stack([x[r:L:G] for r in rs], dim=1))
    live = 1 << log2_ceil(min(L, G))
    off = G // 2
    while off >= 1:
        if off < live:
            v = torch.cat([TPF._lse(v[:off], v[off:2 * off]), v[off:]])
        off //= 2
    return v[0]


def leaves(L, seed):
    """L rows of random log values: -inf leaves and an all -inf run."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 4.0, size=(L, COLS)).astype(np.float32)
    x[rng.random((L, COLS)) < 0.2] = -np.inf
    a = int(rng.integers(0, L))
    x[a:a + int(rng.integers(0, L - a + 1))] = -np.inf
    return torch.from_numpy(x)


@pytest.mark.parametrize("G", GROUPS)
def test_split_tree_matches_lse_rows_bitwise(G):
    for L in range(1, H_PLAIN + 1):
        x = leaves(L, 1000 * G + L)
        want = TPF._lse_rows(pad(x, H_PLAIN))
        got = split_tree(x, L, G)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            G, L)


def test_split_tree_all_dead_is_neg_inf():
    for G in GROUPS:
        x = torch.full((40, COLS), NEG_INF)
        assert torch.equal(split_tree(x, 40, G), torch.full((COLS,), NEG_INF))


# ---------------------------------------------------------------------------
# The inside kernels K16/K18


INSIDE_N = (32, 64)


def inside_leaves(H, d, seed, contra, w=0.75):
    """The three bifurcation trees' leaves of one span d, rows t < H (the
    plain inside pass's height), columns the lanes: (plain, kernel), each
    (H, 3, COLS).  Plain: ``_inside_log_plain``'s terms, x and s2 leaves,
    masked past t = d - 1 as it masks them; kernel: the leaves of
    ``rna_log_split_bifurcation``, leaf 0 from the lane's own rm."""
    rng = np.random.default_rng(seed)

    def rows():
        x = rng.normal(0.0, 4.0, size=(H, COLS)).astype(np.float32)
        x[rng.random((H, COLS)) < 0.25] = -np.inf
        return torch.from_numpy(x)

    fq, fqm, ext, one = rows(), rows(), rows(), rows()
    t = torch.arange(H)[:, None]
    neg = torch.full((), NEG_INF)
    wt = torch.full((1, COLS), w)
    extr = torch.where(t == 0, torch.zeros(()), ext)
    onet = torch.where(t == 0, neg, one)
    live = (t >= 1) & (t <= d - 1)
    x = torch.where(live, fqm if contra else fq + wt, neg)
    s1 = x + wt * t.to(torch.float32) if contra else x
    plain = torch.stack([torch.where(t <= d - 1, fq + extr, neg), s1,
                         onet + x], dim=1)
    kx = fqm if contra else fq + wt
    kern = torch.stack([
        fq + extr,
        kx + wt * t.to(torch.float32) if contra else kx,
        onet + kx], dim=1)
    kern[0, 1:] = NEG_INF          # leaf 0: ext's term only
    return plain, kern


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
@pytest.mark.parametrize("G", GROUPS)
def test_inside_bifurcation_split_matches_plain_bitwise(G, contra):
    for N in INSIDE_N:
        for d in range(N):
            H = TPF._live_height(N, d)
            plain, kern = inside_leaves(H, d, 7 * N + 1000 * G + d, contra)
            want = TPF._lse_rows(plain)
            got = split_tree(kern[:d], d, G)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (N, G, d)


def snake_owner(a, G):
    """The thread of a group that reduces window tree a."""
    q = a // G
    return G - 1 - a % G if q & 1 else a % G


def inside_window(tl, d, G):
    """rna_log_split_window at span d with the inside's limits: the trees
    a < min(31, d - 1) (the inner pair's span d - 2 - a - b >= 0), tree a
    over its first min(31 - a, d - 1 - a) leaves, each reduced whole by the
    thread it is dealt to (rna_thread_tree), then folded in order a."""
    A = max(min(TPF.W, d - 1), 0)
    sums = {}
    for r in range(G):
        q = 0
        while q * G < TPF.W:
            a = q * G + (G - 1 - r if q & 1 else r)
            if a < A:
                assert snake_owner(a, G) == r and a not in sums
                sums[a] = thread_tree(tl[a, :min(TPF.W - a, d - 1 - a)])
            q += 1
    assert sorted(sums) == list(range(A))
    two = torch.full((COLS,), NEG_INF)
    for a in range(A):
        two = TPF._lse(two, sums[a])
    return two


@pytest.mark.parametrize("G", GROUPS)
def test_inside_window_split_matches_fold_windows_bitwise(G):
    a = torch.arange(TPF.W)[:, None, None]
    b = torch.arange(TPF.W2)[None, :, None]
    for N in INSIDE_N:
        for d in range(N):
            rng = np.random.default_rng(11 * N + 1000 * G + d)
            x = rng.normal(0.0, 4.0, size=(TPF.W, TPF.W2, COLS))
            x[rng.random(x.shape) < 0.2] = -np.inf
            tl = torch.from_numpy(x.astype(np.float32))
            # the plain version's leaves: -inf past the loop-length cap and
            # where the inner pair's span d - 2 - a - b is below 0
            live = (a + b <= TPF.MAX_LOOP_LEN) & (a + b <= d - 2)
            want = TPF._fold_windows(
                torch.where(live, tl, NEG_INF)[None])[0]
            got = inside_window(tl, d, G)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (N, G, d)
