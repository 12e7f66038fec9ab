"""The port's native host runtime (``rna_algos_tpu_torch._native``, built
from ``csrc/native_host.c`` by ``cc``) against the JAX package and the
port's plain versions: the centroid traceback's pairs and expected
accuracy identical to ``rna_algos_tpu.models.centroid.traceback`` and to
the port's ``traceback``, one structure at a time and in the batch entry;
the formatter byte-identical to ``probs2str`` / ``_fmt``; the build keyed
on the source and the flags, with ``-ffp-contract=off``, writing only
under its build directory."""

import os
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.models import centroid as JC

from rna_algos_tpu_torch import _native as NA
from rna_algos_tpu_torch.models import centroid as TC
from rna_algos_tpu_torch.ops import mea_fill as MF
from rna_algos_tpu_torch.utils import output as TOUT

from .conftest import REPO_ROOT

GAMMAS = TC.DEFAULT_GAMMAS
N = 96


@pytest.fixture(autouse=True)
def host_compiler():
    if shutil.which("cc") is None:
        pytest.skip("no host C compiler (cc) on PATH to build the native "
                    "host runtime")


@pytest.fixture(scope="module", autouse=True)
def own_build_dir(tmp_path_factory):
    """The library of these tests is built in a directory of their own,
    so that no other test sees the package's ``_build/`` change."""
    default = NA.BUILD_DIR
    NA.BUILD_DIR = tmp_path_factory.mktemp("native") / "_build"
    NA.library.cache_clear()
    try:
        yield default
    finally:
        NA.BUILD_DIR = default
        NA.library.cache_clear()


def outcomes(M, bpp, gamma, n):
    """The branches the plain traceback takes on (M, bpp): a set of
    labels (the test's instrument, the loop of ``traceback``)."""
    gamma, one, seen = np.float32(gamma), np.float32(1.0), set()
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i:
            seen.add("empty")
            continue
        m = M[i, j]
        if m == 0:
            seen.add("zero")
        elif m == M[i + 1, j]:
            seen.add("down")
            stack.append((i + 1, j))
        elif m == M[i, j - 1]:
            seen.add("left")
            stack.append((i, j - 1))
        elif bpp[i, j] > 0.0 and m == np.float32(
                (M[i + 1, j - 1] + gamma * bpp[i, j]) - one):
            seen.add("pair")
            stack.append((i + 1, j - 1))
        else:
            seen.add("no_pair_bpp_positive" if bpp[i, j] > 0.0
                     else "no_pair_bpp_zero")
            for k in range(i + 1, j):
                if m == np.float32(M[i, k] + M[k + 1, j]):
                    seen.add("split" if k == i + 1 else "split_later")
                    stack.append((i, k))
                    stack.append((k + 1, j))
                    break
    return seen


def assert_same(M, bpp, gamma, n):
    """Native, JAX and the port's plain traceback agree on (M, bpp)."""
    want = JC.traceback(M, bpp, gamma, n)
    assert TC.traceback(M, bpp, gamma, n) == want
    assert NA.traceback(M, bpp, gamma, n) == want
    return want


@pytest.fixture(scope="module")
def trna_fills():
    """trna_bpps.npz records 0 and 5, CONTRA and Turner, padded to 96,
    with the JAX fills of the 18 gammas."""
    gold = np.load(REPO_ROOT / "tests" / "golden" / "trna_bpps.npz")
    out = []
    for key in ("rec0_contra", "rec5_contra", "rec0_turner", "rec5_turner"):
        bpp = gold[key].astype(np.float32)
        n = bpp.shape[0]
        padded = np.zeros((N, N), np.float32)
        padded[:n, :n] = bpp
        fills = np.asarray(JC.mea_fill_gammas(
            jnp.asarray(padded), jnp.asarray(GAMMAS, jnp.float32), N=N))
        out.append((key, padded, n, fills))
    return out


def test_traceback_matches_jax_on_trna_goldens(trna_fills):
    for key, padded, n, fills in trna_fills:
        paired = 0
        for g, M in zip(GAMMAS, fills):
            paired += len(assert_same(M, padded, g, n)[0])
        assert paired > 0, key


def random_case(N, n, seed, density):
    """A symmetric (N, N) BPP-like matrix of n live bases: ``density`` of
    the cells i < j nonzero, uniform variates to the sixth power."""
    rng = np.random.default_rng(seed)
    v = rng.random((n, n)) ** 6 * (rng.random((n, n)) < density)
    up = np.triu(v, 1).astype(np.float32)
    bpp = np.zeros((N, N), np.float32)
    bpp[:n, :n] = up + up.T
    return bpp


def random_cases():
    cases = []
    for N_, n, seed, density in ((64, 64, 1, 0.5), (64, 41, 2, 0.05),
                                 (96, 96, 3, 0.3), (96, 77, 4, 1.0),
                                 (96, 1, 5, 0.5), (96, 2, 6, 1.0)):
        bpp = random_case(N_, n, seed, density)
        fills = MF.mea_fill_batch_plain(torch.as_tensor(bpp)[None],
                                        GAMMAS)[0].numpy()
        cases.append((bpp, n, fills))
    return cases


def test_traceback_matches_jax_on_random_bpps():
    """Seeded random BPPs at N = 64 and 96 (dense, sparse, n = 1, 2):
    identical to JAX and the plain version at every gamma, and together
    the cases take both sides of every candidate test."""
    seen = set()
    for bpp, n, fills in random_cases():
        for g, M in zip(GAMMAS, fills):
            assert_same(M, bpp, g, n)
            seen |= outcomes(M, bpp, g, n)
    assert seen == {"empty", "zero", "down", "left", "pair",
                    "no_pair_bpp_positive", "no_pair_bpp_zero", "split",
                    "split_later"}


def test_pair_test_rounds_twice():
    """A pair whose fill value is M + gamma * bpp - 1 rounded after each
    operation, where one rounding of M + gamma * bpp (a fused multiply-add)
    gives another float32: the native build must find the pair, as JAX and
    the plain version do.  (With the grid's powers of two gamma * bpp is
    exact, so the gamma here is not one.)"""
    rng = np.random.default_rng(11)
    f32 = np.float32
    for _ in range(10_000):
        x, b, g = (f32(rng.random() * s) for s in (4, 1, 10))
        twice = f32(f32(x + f32(g * b)) - f32(1))
        once = f32(f32(np.float64(x) + np.float64(g) * np.float64(b)) - 1)
        if twice != once and twice != 0 and twice != x:
            break
    else:
        raise AssertionError("no seeded case where one rounding differs")
    M = np.zeros((4, 4), np.float32)
    bpp = np.zeros((4, 4), np.float32)
    M[1, 2], M[0, 3], bpp[0, 3] = x, twice, b
    assert assert_same(M, bpp, float(g), 4) == ([(0, 3)], float(twice))


def test_batch_entry_matches_single():
    """The batch entry over records of different n and the 18 gammas gives
    each (record, gamma) the single entry's pairs; its dot-brackets are
    ``fold_str``'s."""
    cases = [c for c in random_cases() if c[0].shape[0] == N]
    bpps = np.stack([c[0] for c in cases])
    ns = [c[1] for c in cases]
    fills = np.stack([c[2] for c in cases])
    pairs, counts = NA.traceback_batch(fills, bpps, ns, GAMMAS)
    assert pairs.shape == (len(cases), len(GAMMAS), N // 2, 2)
    strs = TOUT.fold_strs(pairs, counts, ns, N)
    for r, n in enumerate(ns):
        for g, gamma in enumerate(GAMMAS):
            got = [tuple(map(int, p)) for p in pairs[r, g, :counts[r, g]]]
            want, _ = NA.traceback(fills[r, g], bpps[r], gamma, n)
            assert got == want
            assert strs[r][g] == TOUT.fold_str(want, n)
    with pytest.raises(ValueError):
        NA.traceback_batch(fills, bpps, [N + 1] * len(ns), GAMMAS)


def test_formatter_byte_identical():
    """At least 10^5 seeded float32 bit patterns in [0, 1], the edge
    values, and every kind of bit pattern (negative, large, subnormal,
    infinite, NaN): the native text is the plain ``probs2str``'s, also
    through ``probs2str_arrays(device="cuda")``."""
    rng = np.random.default_rng(2024)
    unit = rng.integers(0, 0x3F800001, 120_000, dtype=np.uint32)
    edges = np.array([0.0, -0.0, 1e-45, 1.1754944e-38, 1.0, 1.0000076,
                      0.99999315], np.float32)
    anybits = rng.integers(0, 2**32, 20_000, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001,
                        0x7F7FFFFF, 0x00000001, 0x807FFFFF], np.uint32)
    pv = np.concatenate([unit.view(np.float32), edges,
                         anybits.view(np.float32), special.view(np.float32)])
    iv = rng.integers(0, 4096, pv.size).astype(np.int32)
    jv = rng.integers(-1, 2**31 - 1, pv.size).astype(np.int32)
    want = TOUT.probs2str(zip(iv, jv, pv))
    assert NA.probs2str_arrays(iv, jv, pv) == want
    assert TOUT.probs2str_arrays(iv, jv, pv, device="cuda") == want
    assert TOUT.probs2str_arrays(iv, jv, pv, device="cpu") == want
    for v in edges:
        assert NA.probs2str_arrays([0], [1], [v]) == f"0,1,{TOUT._fmt(v)} "
    assert NA.probs2str_arrays([], [], []) == ""


def test_device_rule():
    assert NA.on_card("cuda") and NA.on_card(torch.device("cuda", 0))
    assert not NA.on_card("cpu")
    for dev in ("meta", "mps"):
        with pytest.raises(ValueError):
            NA.on_card(dev)
        with pytest.raises(ValueError):
            TC.centroid_structures([], GAMMAS, dev)


def test_build_keyed_and_contained(tmp_path, monkeypatch, own_build_dir):
    """The name changes with the source and with the flags; the flags keep
    -ffp-contract=off; a build writes only its library under its build
    directory (the compiler's temporary files included); a failed build
    raises with the compiler's output."""
    src = NA.SOURCE.read_bytes()
    name = NA.library_name(src, NA.CC_FLAGS)
    assert NA.library_name(src + b"\n", NA.CC_FLAGS) != name
    assert NA.library_name(src, NA.CC_FLAGS + ("-g",)) != name
    assert "-ffp-contract=off" in NA.CC_FLAGS
    assert NA.library().rna_native_triple_bytes() > 0
    assert os.listdir(NA.BUILD_DIR) == [name]
    assert own_build_dir == NA.PKG_DIR / "_build"

    tmpdir, pkg = tmp_path / "tmp", tmp_path / "pkg"
    tmpdir.mkdir()
    pkg.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmpdir))
    so = NA.build(pkg / "_build")
    assert so == pkg / "_build" / name
    assert os.listdir(pkg) == ["_build"]
    assert os.listdir(pkg / "_build") == [name]
    assert os.listdir(tmpdir) == []
    with pytest.raises(RuntimeError, match="cc failed"):
        NA.build(pkg / "_build", NA.CC_FLAGS + ("-fno-such-flag-here",))
    assert os.listdir(pkg / "_build") == [name]
