"""The long tier's CONTRA kernels K8 (inside) and K9 (outside): the port's
wrappers on CPU tensors (their plain versions) against the JAX span-chunked
Pallas kernels ``_inside_call_prob_chunked`` and
``_outside_call_prob_chunked`` in interpret mode, at N = 128, R = 64 (two
chunks), B = 1, n = 112, with ln_sigma equal.

Tolerances as for K1/K2 (test_torch_fold.py): rtol 1e-4 on close, ext and
one (JAX contracts the window in three bf16 passes, the port in FP32), and
1e-4 absolute on bppo (a probability).  At n = 112 the ext and one cells
past the sequence's end (which no live cell reads) fall to ~1e-35, where
XLA flushes subnormal intermediates to zero and torch keeps them, so the
relative bound has chip_smoke.py's absolute floor of 1e-30 for that
noise.

The fixture builds the port's inputs before any JAX work and from tables
of its own, built afresh from the parameters: the shared CONTRA tables
alias the parameter arrays, and JAX zero-copies those of them the
allocator happened to align, so the two sides shared memory in some
processes.  In one such process the port's hairpin table moved by up to
7.6e-5 relative at a few cells while the JAX reference stayed bitwise the
same.  ``test_shared_tables_are_unchanged`` checks the shared tables
against a fresh build, so a write into them shows where it happens."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.ops import pallas_fold as PF
from rna_algos_tpu.ops import pallas_fold_prob as PP

from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.ops import pallas_fold_long as TPL
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as TP8

from rna_algos_tpu_torch.params import build_fold_score_sets
from rna_algos_tpu_torch.weights import contra_tables

from .test_torch_fold import CT, TT

N, R, n = 128, 64, 112
RTOL = 1e-4
ATOL_BPPO = 1e-4
ATOL_TINY = 1e-30


def assert_rel(got, want, rtol):
    """|got - want| <= rtol * |want| + ATOL_TINY."""
    err = np.abs(got.numpy() - want)
    bad = err > rtol * np.abs(want) + ATOL_TINY
    assert not bad.any(), (int(bad.sum()), float(err.max()))


def one_seq(n, N, seed):
    seqs = np.full((1, N), PSEUDO_BASE, dtype=np.int32)
    seqs[0, :n] = np.random.default_rng(seed).integers(0, 4, size=n)
    return seqs, np.array([n], np.int32)


@pytest.fixture(scope="module")
def case():
    seqs, ns = one_seq(n, N, 81)
    ls = np.float32([0.85])
    # The port's inputs first, from tables built afresh that share no
    # memory with the JAX side: the shared tables TT alias the parameter
    # arrays, which the JAX tables CT zero-copy where the allocator aligned
    # them.
    tt = contra_tables(build_fold_score_sets(), "cpu")
    ts = torch.as_tensor(seqs, dtype=torch.int64)
    tn, tl = torch.tensor(ns), torch.tensor(ls)
    port = dict(
        tn=tn,
        port=TP8.contra_prob_mats_merged(ts, tn, tt, tl, N),
        KW=TPP._banded_window_kernel(TPP._contra_len_prob(tt, tl)),
        scal=TPP._scal_rows(tt, tl),
    )
    js, jn, jl = jnp.asarray(seqs), jnp.asarray(ns), jnp.asarray(ls)
    pm = PP.contra_prob_mats(js, jn, CT, jl, N)
    LENp = PP._contra_len_prob(CT, jl)
    inside = PP._inside_call_prob_chunked(
        pm, LENp, PP._scal_rows(CT, jl, jn), 1, N, R, True)
    ONEP, QONE, extL, extR, glob = PF.contra_outside_aux(
        jn, inside[1], inside[2], N, neg=0.0, one_val=1.0)
    bppo = PP._outside_call_prob_chunked(
        pm, inside[0], ONEP, QONE, extL, extR, LENp,
        PP._scal_rows(CT, jl, jn, glob=glob), 1, N, R, 5, True)
    live = np.arange(N)[None, :, None] < ns[:, None, None]
    return dict(
        port, glob=np.asarray(glob), bppo=np.asarray(bppo),
        inside=[np.where(live, np.asarray(x), np.float32(0)) for x in inside],
    )


def test_shared_tables_are_unchanged(case):
    """After this file's JAX work, the shared tables TT (which the JAX
    tables may alias) still equal a fresh build, bit for bit."""
    fresh = contra_tables(build_fold_score_sets(), "cpu")
    assert TT.keys() == fresh.keys()
    for k, v in fresh.items():
        assert torch.equal(TT[k].view(torch.int32), v.view(torch.int32)), k


@pytest.mark.parametrize("k,name", [(0, "close"), (1, "ext"), (2, "one")])
def test_long_inside_matches_jax_chunked_kernel(case, k, name):
    got = TPL.contra_inside_long(case["port"][0], case["KW"], case["scal"],
                                 case["tn"])
    assert_rel(got[k], case["inside"][k], RTOL)
    assert got[k].abs().max() > 0


def test_long_outside_matches_jax_chunked_kernel(case):
    _mi, mo_pre, acc, b0lo = case["port"]
    close, ext, one = (torch.as_tensor(x) for x in case["inside"])
    tn, scal = case["tn"], case["scal"]
    QONE, extL, extR, glob = TPF.contra_outside_aux(tn, ext, one, N)
    np.testing.assert_array_equal(glob.numpy(), case["glob"])
    mo = dict(mo_pre)
    mo["ACCB"] = (acc * extL[:, None, :] * (1.0 / glob)[:, None, None]
                  * scal[:, 1][:, None, None])
    mo["CLOSE"] = close
    got = TPL.contra_outside_long(mo, one, QONE, extR, b0lo, case["KW"],
                                  scal, tn, 5)
    want = case["bppo"]
    assert np.abs(got.numpy() - want).max() <= ATOL_BPPO
    assert want.max() > 0.5
