"""The traffic generator: deterministic for a seed, and each cell's calls
carry the stated batch, lengths and substitution rate."""

from collections import Counter

import numpy as np
import pytest

import bench_cases
from benchlib import spec as spec_lib, traffic as T

BIG_SEEDS = (0, 2 ** 31 + 12345, 2 ** 40 + 7, -5)


@pytest.mark.parametrize("cell", bench_cases.CELLS)
def test_pool_is_deterministic_for_a_seed(cell):
    t = spec_lib.load(cell)["traffic"]
    for seed in BIG_SEEDS:
        a, b = T.pool(t, seed, 3), T.pool(t, seed, 3)
        assert all(np.array_equal(x, y) for ca, cb in zip(a, b)
                   for x, y in zip(ca, cb))
    one, two = T.pool(t, 11, 1)[0], T.pool(t, 12, 1)[0]
    assert any(not np.array_equal(x, y) for x, y in zip(one, two))
    warm = T.pool(t, 11, 1, stream=T.WARMUP)[0]
    assert any(not np.array_equal(x, y) for x, y in zip(one, warm))


@pytest.mark.parametrize("cell", bench_cases.CELLS[1:])
def test_uniform_calls_match_the_stated_lengths(cell):
    t = spec_lib.load(cell)["traffic"]
    B, lo, hi = t["batch"], t["length_min"], t["length_max"]
    for call in T.pool(t, 2 ** 31 + 99, 20):
        assert len(call) == B
        n = np.sort([len(s) for s in call])
        assert n.min() >= lo and n.max() <= hi
        # stratified: the k-th shortest lies in the k-th B-quantile
        edges = lo + np.arange(B + 1) * (hi - lo + 1) / B
        assert np.all(n >= np.floor(edges[:-1])) and np.all(
            n <= np.ceil(edges[1:]))
        assert all(s.dtype == np.int8 and s.min() >= 0 and s.max() <= 3
                   for s in call)


def test_trna_variants_match_the_templates_and_the_rate():
    t = spec_lib.load("contrafold_surrogate.centroid_trna")["traffic"]
    temps = [T.encode(s) for s in t["templates"].values()]
    assert len(temps) == 6 and min(len(x) for x in temps) == 68
    copies = t["batch"] // len(temps)
    want = Counter(len(x) for x in temps for _ in range(copies))
    hits = total = 0
    for call in T.pool(t, 2 ** 33 + 1, 10):
        assert len(call) == t["batch"] == 192
        assert Counter(len(s) for s in call) == want
        for s in call:
            # the template it came from: the nearest of its length
            hits += min(int(np.sum(s != x)) for x in temps
                        if len(x) == len(s))
            total += len(s)
    assert abs(hits / total - t["substitution_rate"]) < 0.01
