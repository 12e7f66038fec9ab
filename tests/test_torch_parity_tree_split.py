"""The split trees of the parity outside kernels K17 and K19
(``csrc/fold_log.cuh``, ``rna_split_tree``): a plain-torch replica of the
split, bitwise against the port's plain halving tree ``_lse_rows``.

A lane's group of G threads splits a tree of L leaves by residue: thread r
reduces the leaves t = r + G j by the halving tree over j, itself split into
classes j = c (mod S) of 8 leaves and the S class sums; the group's top
log2 G levels pair thread r with r + G/2, r + G/4, ...  Every subtree, class
and level whose leaves all lie past the live ones is skipped, as the kernels
skip them.  The replica follows that order step by step and must give the
bits of ``_lse_rows`` over a 256-row tree with -inf past L: the claim that
makes K17 and K19 bitwise equal to their plain versions.  Leaves are random
log values with -inf leaves and all -inf runs, from a seed; tree sizes
1-256, G = 1, 2, 4, 8, 16, 32.  Torch on one thread, as the parity files."""

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
    v = torch.full((G, COLS), NEG_INF)
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
