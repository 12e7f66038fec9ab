"""The roofline's work count: equal to a brute-force count of the live
cells' terms and the closable cells' window terms, and the same for a
sequence alone, in a padded batch, or in any order."""

import numpy as np
import pytest

import bench_cases  # noqa: F401
from benchlib import work as Wk

CANON = set(Wk.CANONICAL)


def brute_terms(s):
    """Loop-by-loop count of the terms ``work.terms`` documents."""
    n, S, W = len(s), Wk.MIN_SPAN, Wk.WINDOW
    total = 0
    for i in range(n):
        for j in range(i, n):
            d = j - i
            close = (int(s[i]), int(s[j])) in CANON and d + 1 >= S
            # inside: ext d + 1, s1 d, s2 max(d - 1, 0), one 2, rm 2
            total += (d + 1) + d + max(d - 1, 0) + 2 + 2
            if close:
                total += 2
                for a in range(W):
                    for b in range(W - a):
                        k, l = i + 1 + a, j - 1 - b
                        if l - k + 1 >= S:
                            total += 1
            if d + 1 >= S:
                total += 2 * (n - 1 - j)
            if close:
                total += 3 + 3 * i
                for a in range(W):
                    for b in range(W - a):
                        if i - 1 - a >= 0 and j + 1 + b <= n - 1:
                            total += 1
    return total


@pytest.mark.parametrize("n", [1, 2, 5, 6, 9, 17, 40, 45])
def test_terms_match_a_brute_force_count(n):
    rng = np.random.default_rng(n)
    s = rng.integers(0, 4, size=n).astype(np.int8)
    assert Wk.terms([s]) == [brute_terms(s)]


def test_terms_do_not_depend_on_padding_or_order():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, size=n).astype(np.int8)
            for n in (7, 44, 23, 61, 12)]
    alone = [Wk.terms([s])[0] for s in seqs]
    assert Wk.terms(seqs) == alone
    assert Wk.terms(seqs[::-1]) == alone[::-1]
    # blocks of one sequence each, and of the whole batch
    assert Wk.terms(seqs, cells=1) == alone
    flops, nbytes = Wk.call_work(seqs, 100)
    assert flops == Wk.FLOPS_PER_TERM * sum(alone)
    assert nbytes == sum(len(s) + 5 * len(s) ** 2 for s in seqs) + 100


@pytest.mark.parametrize("n", [1, 2, 3, 10, 33])
def test_centroid_terms_match_a_brute_force_count(n):
    want = sum(3 + (j - i - 1) for i in range(n) for j in range(i + 1, n))
    assert Wk.centroid_terms(n, 18) == 18 * want


def test_least_time_takes_the_larger_bound():
    assert Wk.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert Wk.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert Wk.least_seconds(67e12, 6.7e12) == pytest.approx(2.0)
