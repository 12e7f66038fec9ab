"""The per-sequence score assembly of the generic-N scan against the JAX
package (``rna_algos_tpu.ops.scores``), evaluated eagerly on the CPU:
``precompute_turner`` / ``precompute_contra`` (each of the JAX function's
(N, N) tables, batch row by row) and the per-span 2-loop tensors
``twoloop_{inside,outside}_{turner,contra}`` at N = 64 and 96, the Turner
batch with two special hairpins planted.

Bitwise, except the Turner hairpin's extrapolated cells (hairpin length
> 30): XLA's CPU ``log`` is one ulp off at some lengths, so they are held
to 2 ulps (ROADMAP section C).  The lane form (``lanes=``), which the
plain scan uses on the cells that can close, equals the full tensors.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.ops import scores as JS
from rna_algos_tpu.params import build_fold_score_sets

from rna_algos_tpu_torch.ops import scores as TS
from rna_algos_tpu_torch.weights import contra_tables, turner_tables

FSS = build_fold_score_sets()
SPANS = (0, 1, 4, 7, 19, 33, 62)


def batch(N, seed, tt=None):
    """B = 3: a full-length sequence, two shorter ones; with Turner tables
    ``tt``, the first two special hairpins planted in sequence 1."""
    rng = np.random.default_rng(seed)
    ns = np.array([N, N - 9, N // 2 + 3], np.int32)
    seqs = np.full((3, N), PSEUDO_BASE, np.int32)
    for k, n in enumerate(ns):
        seqs[k, :n] = rng.integers(0, 4, n)
    if tt is not None:
        sp, lens = np.asarray(tt["special_seqs"]), np.asarray(tt["special_lens"])
        at = 3
        for s in range(2):
            seqs[1, at:at + lens[s]] = sp[s, :lens[s]]
            at += lens[s] + 2
    return seqs, ns


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    return np.where(same, 0, np.abs(ai - bi))


def _model(contra):
    if contra:
        return (JS.contra_table_pytree(FSS), contra_tables(FSS, "cpu"),
                JS.precompute_contra, TS.precompute_contra)
    return (JS.turner_table_pytree(), turner_tables("cpu"),
            JS.precompute_turner, TS.precompute_turner)


@pytest.fixture(scope="module", params=[(64, True), (64, False), (96, True),
                                        (96, False)],
                ids=["contra64", "turner64", "contra96", "turner96"])
def case(request):
    N, contra = request.param
    jt, tt, jpre_fn, tpre_fn = _model(contra)
    seqs, ns = batch(N, seed=N + contra, tt=None if contra else jt)
    ts = torch.as_tensor(seqs, dtype=torch.int64)
    pre = tpre_fn(ts, torch.as_tensor(ns), N, tt)
    jpre = [jpre_fn(jnp.asarray(seqs[b]), int(ns[b]), N, jt)
            for b in range(len(ns))]
    return dict(N=N, contra=contra, jt=jt, tt=tt, seqs=seqs, ns=ns, ts=ts,
                pre=pre, jpre=jpre)


def test_precompute_matches_jax(case):
    N = case["N"]
    hlen = np.arange(N) - 1
    for b, jpre in enumerate(case["jpre"]):
        for key, got in case["pre"].items():
            if key in ("JB",):
                want = np.asarray(jpre["JSrev"]) + np.asarray(jpre["BP"])
            else:
                want = np.asarray(jpre[key])
            got = got[b].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, key
            if key == "H" and not case["contra"]:
                u = _ulps(got, want)
                assert (u[:, hlen <= 30] == 0).all(), key
                assert u.max() <= 2, key
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    if not case["contra"]:
        sp = TS.special_hairpin_id(case["ts"][1:2], case["tt"], N)[0]
        assert torch.isfinite(sp).sum() >= 2   # the planted hairpins


@pytest.mark.parametrize("inside", [True, False], ids=["inside", "outside"])
def test_twoloop_matches_jax(case, inside):
    contra, N = case["contra"], case["N"]
    name = ("twoloop_" + ("inside" if inside else "outside") + "_"
            + ("contra" if contra else "turner"))
    jfn, tfn = getattr(JS, name), getattr(TS, name)
    for d in SPANS:
        if d >= N:
            continue
        got = tfn(case["ts"], case["tt"], case["pre"], d, N)
        assert got.shape == (3, N, 31, 31)
        for b, jpre in enumerate(case["jpre"]):
            want = np.asarray(jfn(jnp.asarray(case["seqs"][b]), case["jt"],
                                  jpre, d, N))
            np.testing.assert_array_equal(got[b].numpy(), want,
                                          err_msg=f"{name} d={d} b={b}")
        bi = torch.tensor([0, 2, 1, 0])
        ii = torch.tensor([0, 5, N - 1 - d, 3])
        lanes = tfn(case["ts"], case["tt"], case["pre"], d, N,
                    lanes=(bi, ii))
        assert torch.equal(lanes, got[bi, ii])


def test_fam_select_families():
    fam = TS._fam_select(torch.zeros(31, 31), torch.ones(31, 31),
                         torch.full((31, 31), 2.0))
    want = np.asarray(JS._fam_select(jnp.zeros((31, 31)), jnp.ones((31, 31)),
                                     jnp.full((31, 31), 2.0)))
    np.testing.assert_array_equal(fam.numpy(), want)
    assert fam[1, 7] == 1 and fam[2, 3] == 2 and fam[4, 4] == 0


def test_canonical_matrix_matches_jax():
    seqs, ns = batch(64, seed=3)
    got = TS.canonical_matrix(torch.as_tensor(seqs, dtype=torch.int64),
                              torch.as_tensor(ns), 64)
    for b in range(3):
        want = np.asarray(JS.canonical_matrix(jnp.asarray(seqs[b]),
                                              int(ns[b]), 64))
        np.testing.assert_array_equal(got[b].numpy(), want)
