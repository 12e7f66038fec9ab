"""Plain versions of kernels K1 (inside) and K2 (outside) vs the JAX
per-sequence Pallas kernels in interpret mode, and the rescale-retry loop.

Tolerance of K1/K2: rtol 1e-4 elementwise.  JAX contracts the 2-loop window
in three bf16 passes (``pallas_fold_prob._mm_3pass``), which keeps about 16
of float32's 24 mantissa bits of each window weight (~2^-17 relative per
product); the port contracts it in FP32.  Measured here: 2.5e-5 relative at
most, and 1e-6 when JAX runs the window at full float32
(RNA_ALGOS_BAND_PRECISION=highest).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rna_algos_tpu.params import build_fold_score_sets
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.ops import pallas_fold_prob as PP

from rna_algos_tpu_torch.weights import contra_tables
from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as TP8

from .test_torch_tables import make_batch

N, B = 64, 8
FSS = build_fold_score_sets()
CT = S.contra_table_pytree(FSS)
TT = contra_tables(FSS, "cpu")
RTOL = 1e-4


@pytest.fixture(scope="module")
def case():
    seqs, ns = make_batch(B, N, 11)
    ls = np.random.default_rng(12).uniform(0.8, 1.0, B).astype(np.float32)
    js, jn, jl = jnp.asarray(seqs), jnp.asarray(ns), jnp.asarray(ls)
    pm = PP.contra_prob_mats(js, jn, CT, jl, N)
    LENp = PP._contra_len_prob(CT, jl)
    scal = PP._scal_rows(CT, jl, jn)
    inside = PP._inside_call_prob(pm, LENp, scal, B, N, True)
    live = np.arange(N)[None, :, None] < ns[:, None, None]
    inside = [np.where(live, np.asarray(x), np.float32(0)) for x in inside]
    bppo, glob = PP._prob_run_body(js, jn, CT, jl, N, False, True)
    ts = torch.as_tensor(seqs, dtype=torch.int64)
    tn, tl = torch.as_tensor(ns), torch.as_tensor(ls)
    port = TP8.contra_prob_mats_merged(ts, tn, TT, tl, N)
    KW = TPP._banded_window_kernel(TPP._contra_len_prob(TT, tl))
    return dict(
        ns=ns, tn=tn, tl=tl, inside=inside, bppo=np.asarray(bppo),
        glob=np.asarray(glob), port=port, KW=KW,
        scal=TPP._scal_rows(TT, tl),
    )


def assert_rel(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    err = np.abs(got - want)
    assert (err <= rtol * np.abs(want)).all(), (
        float((err / np.maximum(np.abs(want), 1e-30)).max())
    )


@pytest.mark.parametrize("k,name", [(0, "close"), (1, "ext"), (2, "one")])
def test_plain_inside_matches_jax_perseq_kernel(case, k, name):
    mi = case["port"][0]
    got = TP8.contra_inside(mi, case["KW"], case["scal"], case["tn"])
    assert_rel(got[k], case["inside"][k], RTOL)
    # cells at or past each sequence's length are exact zeros
    dead = np.arange(N)[None, :, None] >= case["ns"][:, None, None]
    assert (got[k].numpy()[np.broadcast_to(dead, got[k].shape)] == 0).all()


def test_plain_outside_matches_jax_perseq_kernel(case):
    _mi, mo_pre, acc, b0lo = case["port"]
    close, ext, one = (torch.as_tensor(x) for x in case["inside"])
    tn = case["tn"]
    QONE, extL, extR, glob = TPF.contra_outside_aux(tn, ext, one, N)
    np.testing.assert_array_equal(glob.numpy(), case["glob"])
    scal = case["scal"]
    mo = dict(mo_pre)
    mo["ACCB"] = (acc * extL[:, None, :] * (1.0 / glob)[:, None, None]
                  * scal[:, 1][:, None, None])
    mo["CLOSE"] = close
    got = TP8.contra_outside(mo, one, QONE, extR, b0lo, case["KW"], scal,
                             tn, 5)
    want = case["bppo"]
    # bppo entries are probabilities; the bound is absolute
    assert np.abs(got.numpy() - want).max() < 5e-5
    assert_rel(got.numpy()[want > 1e-3], want[want > 1e-3], RTOL)


def _synthetic_run(z, ns):
    """numpy run(ls) -> (bppo, glob) with glob = e^{n (z - ls)} in float32;
    bppo holds 1/glob so its sum is non-finite when glob underflows."""
    B = len(z)

    def run(ls):
        ls = np.asarray(ls, dtype=np.float64)
        with np.errstate(over="ignore", divide="ignore"):
            glob = np.exp(ns * (z - ls)).astype(np.float32)
            bppo = np.zeros((B, 2, 2), np.float32)
            bppo[:, 0, 0] = np.float32(1.0) / glob
        return bppo, glob

    return run


@pytest.mark.parametrize(
    "lengths",
    [(200, 180, 150, 120), (1800, 600, 1020, 513)],
    ids=["short", "long"],
)
@pytest.mark.parametrize("ls0", [None, PP.LN_SIGMA0_TURNER],
                         ids=["contra_seed", "turner_seed"])
@pytest.mark.parametrize(
    "label,z",
    [
        ("overflow", [2.2, 1.9, 0.95, 2.5]),      # glob = inf: walk up
        ("underflow", [0.0, -0.4, 0.85, 0.2]),    # glob = 0: walk down
        ("jump", [1.6, 0.1, 0.9, 1.45]),          # finite, out of band
    ],
)
def test_retrying_matches_jax(label, z, ls0, lengths):
    """The port's loop against JAX ``_retrying``, from the CONTRA default
    seed and from the Turner seed that ``mccaskill_turner_pallas_prob8``
    passes (``ls0=LN_SIGMA0_TURNER``), for lanes of the stacked tier and
    lanes past 512 nt (whose walk starts at min(0.9, 55/n) and grows 1.5x
    per same-direction step; there most lanes overflow or underflow and
    walk)."""
    z = np.asarray(z, np.float64)
    ns = np.array(lengths, np.int32)
    run = _synthetic_run(z, ns.astype(np.float64))
    Bz = len(z)
    shapes = (jax.ShapeDtypeStruct((Bz, 2, 2), jnp.float32),
              jax.ShapeDtypeStruct((Bz,), jnp.float32))
    bppo_j, ls_j = PP._retrying(
        lambda ls: jax.pure_callback(run, shapes, ls), Bz,
        ls0=None if ls0 is None else jnp.asarray(ls0, jnp.float32),
        ns=jnp.asarray(ns),
    )

    def trun(ls):
        bppo, glob = run(ls.numpy())
        return torch.as_tensor(bppo), torch.as_tensor(glob)

    bppo_t, ls_t = TPP._retrying(trun, torch.as_tensor(ns), ls0=ls0)
    np.testing.assert_array_equal(np.asarray(ls_j), ls_t.numpy())
    np.testing.assert_array_equal(np.asarray(bppo_j), bppo_t.numpy())
    seed = PP.LN_SIGMA0 if ls0 is None else ls0
    assert not np.array_equal(ls_t.numpy(), np.full(Bz, seed, np.float32)), label
