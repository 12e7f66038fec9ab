"""Plain versions of kernels K4 (Turner inside) and K5 (Turner outside) vs
the JAX per-sequence Turner Pallas kernels in interpret mode.

Tolerances as for K1/K2 (test_torch_fold.py): rtol 1e-4 on close, ext and
one, because JAX contracts the generic-interior window in three bf16
passes (``pallas_fold_prob._mm_3pass``, ~2^-17 relative per product)
where the port contracts it in FP32; bppo within 5e-5 absolute.  The
batch mixes lengths (sequence 0 fills the bucket) and plants a special
hairpin in sequence 1.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rna_algos_tpu.ops import pallas_fold_prob as PP
from rna_algos_tpu.ops.pallas_fold import LPAD, W, W2, WROWS

from rna_algos_tpu_torch.ops import pallas_fold as TPF
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as TP8

from .test_torch_fold import assert_rel
from .test_torch_turner_tables import TT, TT_J, turner_batch

N, B = 64, 8
RTOL = 1e-4


def _jax_turner_inside(js, jn, jl):
    """Kernel K10 (``_turner_inside_prob_kernel``) in interpret mode, called
    as ``pallas_fold_prob._turner_prob_run_body`` calls it."""
    pm = PP.turner_prob_mats(js, jn, TT_J, jl, N)
    LENBp, LENIp = PP._turner_len_prob(TT_J, jl)
    KB, K2, KI = PP._turner_banded_kernels(LENBp, LENIp)
    WCOL = PP._turner_wcols(KB, K2)
    scal = PP._turner_scal_rows(TT_J, jl, jn)
    f32 = jnp.float32
    return pl.pallas_call(
        functools.partial(PP._turner_inside_prob_kernel, N=N),
        grid=(B,),
        in_specs=[
            PP._SMEM_SPEC,
            *(PP._nn(N, N) for _ in range(18)),
            PP._nn(W2, W), PP._nn(W2, W), PP._nn(32, 32), PP._nn(32, 8),
        ],
        out_specs=(PP._nn(N, N), PP._nn(N, N), PP._nn(N, N)),
        out_shape=tuple(jax.ShapeDtypeStruct((B, N, N), f32) for _ in range(3)),
        scratch_shapes=[
            *(pltpu.VMEM((WROWS, N + LPAD), f32) for _ in range(4)),
            pltpu.VMEM((N, N + 8), f32), pltpu.VMEM((N, N + 8), f32),
            pltpu.VMEM((N, N), f32), pltpu.VMEM((N + 1, N), f32),
            pltpu.VMEM((2, N + 8), f32), pltpu.VMEM((N + 1, N), f32),
            pltpu.VMEM((N, N), f32), pltpu.VMEM((1, N + 8), f32),
        ],
        interpret=True,
    )(
        scal,
        pm["H"], pm["MBC"], pm["ACC"], pm["CANON"],
        pm["STKT"], pm["B01"], pm["B10"], pm["I11T"], pm["I12T"],
        pm["I21T"], pm["I22T"],
        pm["TMo1"], pm["TMo2"], pm["TMo3"], pm["AUGT"],
        pm["TMi1"], pm["TMi2"], pm["TMi3"],
        LENBp, LENIp, KI, WCOL,
    )


def _port_scales(tl):
    LENBp, LENIp = TPP._turner_len_prob(TT, tl)
    KB, K2, KI = TPP._turner_banded_kernels(LENBp, LENIp)
    KT = torch.stack([KI, KB, K2], dim=1).contiguous()
    return KT, TPP._turner_scal_rows(TT, tl, LENIp)


@pytest.fixture(scope="module")
def case():
    seqs, ns = turner_batch(B, N, 51)
    ls = np.random.default_rng(52).uniform(0.45, 0.55, B).astype(np.float32)
    js, jn, jl = jnp.asarray(seqs), jnp.asarray(ns), jnp.asarray(ls)
    live = np.arange(N)[None, :, None] < ns[:, None, None]
    inside = [np.where(live, np.asarray(x), np.float32(0))
              for x in _jax_turner_inside(js, jn, jl)]
    bppo, glob = PP._turner_prob_run_body(js, jn, TT_J, jl, N, True)
    ts = torch.as_tensor(seqs, dtype=torch.int64)
    tn, tl = torch.as_tensor(ns), torch.as_tensor(ls)
    pmats = TPP.turner_prob_mats(ts, tn, TT, tl, N)
    KT, scal = _port_scales(tl)
    return dict(ns=ns, tn=tn, inside=inside, bppo=np.asarray(bppo),
                glob=np.asarray(glob), pmats=pmats, KT=KT, scal=scal)


@pytest.mark.parametrize("k,name", [(0, "close"), (1, "ext"), (2, "one")])
def test_plain_inside_matches_jax_perseq_kernel(case, k, name):
    mi = TP8._turner_merge_inside(case["pmats"])
    got = TP8.turner_inside(mi, case["KT"], case["scal"], case["tn"])
    assert_rel(got[k], case["inside"][k], RTOL)
    # cells at or past each sequence's length are exact zeros
    dead = np.arange(N)[None, :, None] >= case["ns"][:, None, None]
    assert (got[k].numpy()[np.broadcast_to(dead, got[k].shape)] == 0).all()
    if name == "close":   # the planted special hairpin closes a pair
        assert got[k][1].max() > 0


def test_plain_outside_matches_jax_perseq_kernel(case):
    close, ext, one = (torch.as_tensor(x) for x in case["inside"])
    tn, scal = case["tn"], case["scal"]
    QONE, extL, extR, glob = TPF.contra_outside_aux(tn, ext, one, N)
    np.testing.assert_array_equal(glob.numpy(), case["glob"])
    mo = TP8._turner_merge_outside(close, case["pmats"], extL, glob,
                                   scal[:, 3])
    got = TP8.turner_outside(mo, one, QONE, extR, case["KT"], scal, tn, 5)
    want = case["bppo"]
    # bppo entries are probabilities; the bound is absolute
    assert np.abs(got.numpy() - want).max() < 5e-5
    assert_rel(got.numpy()[want > 1e-3], want[want > 1e-3], RTOL)
    assert want.max() > 0.5
