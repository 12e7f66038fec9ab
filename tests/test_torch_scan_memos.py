"""The FoldScores memos of the port against the JAX package's:
``mccaskill_bpp_batch_auto(..., return_memos=True)`` on a kernel-tier
bucket (N = 64, the probability tier's plain versions) and on a generic
one (N = 160, the scan), ``mccaskill_bpp`` (one sequence through the scan,
with the inside tables close and external) and ``mccaskill_twoloop_memo``
at N = 64.

The score grids (hairpin, multibranch_close, accessible) are bitwise,
except the Turner hairpin's extrapolated cells (hairpin length > 30, 2
ulps: XLA's CPU ``log``); presence is equal; close and external, log
values of the jitted JAX scan, within RTOL_LOG * max(1, |x|) on the live
cells (i + d < n: past the end the port keeps the fills); the BPPs as in
``tests/scan_cases.py``; the 2-loop memo bitwise.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rna_algos_tpu import numerics as JN
from rna_algos_tpu.models import mccaskill as JM

from rna_algos_tpu_torch import models as TMS
from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.ops import fold_scan as FS

from .scan_cases import (TOL_BPP_JIT, assert_log_close, live,  # noqa: F401
                         one_torch_thread, scan_batch, tables)

GRIDS = ("hairpin", "multibranch_close", "accessible")


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    return np.where(a == b, 0, np.abs(ai - bi))


def assert_grids(got, want, N, contra):
    for key in GRIDS:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        if key == "hairpin" and not contra:
            u = _ulps(g, w)
            assert (u[..., np.arange(N) - 1 <= 30] == 0).all(), key
            assert u.max() <= 2, key
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("N", [64, 160], ids=["kernel_tier", "generic"])
@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_batch_memos_match_jax(N, contra, monkeypatch):
    jt, tt = tables(contra)
    seqs, ns = scan_batch(N, 2, seed=N + 3 * contra)
    calls = []
    orig = FS.scan_inside_plain
    monkeypatch.setattr(FS, "scan_inside_plain",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    bpp, memos = TM.mccaskill_bpp_batch_auto(
        torch.as_tensor(seqs, dtype=torch.int64), torch.as_tensor(ns), tt,
        N=N, contra=contra, return_memos=True)
    assert len(calls) == (N == 160)       # the scan only off the tiers
    assert set(memos) == set(GRIDS) | {"presence"}
    with JN.force_mode("exact"):
        jbpp, jmemos = JM.mccaskill_bpp_batch_auto(
            jnp.asarray(seqs), jnp.asarray(ns), jt, N=N, contra=contra,
            return_memos=True)
    assert_grids(memos, jmemos, N, contra)
    if N == 160:   # the same function: the scan on both sides
        np.testing.assert_array_equal(memos["presence"].numpy(),
                                      np.asarray(jmemos["presence"]))
        assert np.abs(bpp.numpy() - np.asarray(jbpp)).max() <= TOL_BPP_JIT
    else:          # the probability tier against the cubic scan
        assert np.abs(bpp.numpy() - np.asarray(jbpp)).max() <= 5e-4
        np.testing.assert_array_equal(memos["presence"].numpy(),
                                      bpp.numpy() > 0)


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_mccaskill_bpp_memos_match_jax(contra):
    N = 64
    jt, tt = tables(contra)
    seqs, ns = scan_batch(N, 2, seed=5 + contra)
    seq, n = seqs[1], int(ns[1])
    bpp, memos = TMS.mccaskill_bpp(torch.as_tensor(seq), n, tt, N,
                                   contra=contra)
    with JN.force_mode("exact"):
        jbpp, jmemos = JM.mccaskill_bpp(jnp.asarray(seq), n, jt, N=N,
                                        contra=contra)
    assert set(memos) == set(jmemos)
    assert_grids(memos, jmemos, N, contra)
    mask = live([n], N)[0]
    for key in ("close", "external"):
        assert_log_close(memos[key].numpy(), np.asarray(jmemos[key]), mask,
                         key)
    np.testing.assert_array_equal(memos["presence"].numpy(),
                                  np.asarray(jmemos["presence"]))
    assert bpp.shape == (N, N)
    assert np.abs(bpp.numpy() - np.asarray(jbpp)).max() <= TOL_BPP_JIT


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_twoloop_memo_matches_jax(contra):
    N = 64
    jt, tt = tables(contra)
    seqs, ns = scan_batch(N, 2, seed=9 + contra)
    seq, n = seqs[1], int(ns[1])
    got = TM.mccaskill_twoloop_memo(torch.as_tensor(seq), n, tt, N,
                                    contra=contra)
    want = np.asarray(JM.mccaskill_twoloop_memo(jnp.asarray(seq), n, jt, N=N,
                                                contra=contra))
    assert got.shape == (N, N, 31, 31)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isfinite(want).any()


def test_models_exports():
    assert TMS.mccaskill_bpp is TM.mccaskill_bpp
    assert TMS.mccaskill_bpp_batch is TM.mccaskill_bpp_batch
