"""The long tier's routing and seed against the JAX package: the buckets
``kernel_bucket(n, contra)`` picks for n = 1..2048 against the JAX
``FoldEngine``'s promotions to the fused tiers (run with the TPU gate
forced on), the refusal past them, ``pallas_available`` and
``_estimate_ls0`` (the prefix seed) on a synthetic run."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from rna_algos_tpu.models import mccaskill as JM
from rna_algos_tpu.ops import pallas_fold_prob as PP
from rna_algos_tpu.parallel import runner as JR
from rna_algos_tpu.utils import platform as JPLAT

from rna_algos_tpu_torch.models import mccaskill as TM
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.parallel import runner as TR

from .test_torch_fold import _synthetic_run

LENGTHS = range(1, 2049)


@pytest.fixture
def on_tpu(monkeypatch):
    """The JAX package's TPU gate forced on, so its runner picks the fused
    tiers; the fold itself is replaced by one that records each bucket."""
    monkeypatch.setattr(JPLAT, "on_tpu", lambda: True)
    seen = {}

    def record(seqs, ns, tbl, N, **_kw):
        for n in np.asarray(ns).tolist():
            seen[n] = N
        B = seqs.shape[0]
        return np.zeros((B, 1, 1), np.float32), np.zeros((B, 1, 1), bool)

    monkeypatch.setattr(JM, "mccaskill_bpp_batch_auto", record)
    return seen


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_kernel_bucket_matches_jax_runner(on_tpu, contra):
    engine = JR.FoldEngine(uses_contra_model=contra)
    engine.fold_batch([[0] * n for n in LENGTHS])
    assert sorted(on_tpu) == list(LENGTHS)
    fused = 0
    for n in LENGTHS:
        N = on_tpu[n]
        if JM.pallas_available(contra, N):
            fused += 1
            assert TR.kernel_bucket(n, contra) == N, n
            assert TM.pallas_available(contra, N)
        else:
            # the JAX package folds it with the XLA scan, not ported
            with pytest.raises(NotImplementedError, match="A10"):
                TR.kernel_bucket(n, contra)
    assert fused == (2048 if contra else 1024)


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_kernel_bucket_refuses_past_the_tiers(contra):
    for n in (2049, 3000):
        with pytest.raises(NotImplementedError, match="A10"):
            TR.kernel_bucket(n, contra)
    seqs = torch.zeros((1, 2176), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="A10"):
        TM.mccaskill_bpp_batch_auto(seqs, torch.tensor([2100], dtype=torch.int32),
                                    {}, N=2176, contra=contra)


@pytest.mark.parametrize(
    "label,z,ns",
    [
        ("finite", [0.93, 0.71, 0.88, 1.02], [512, 512, 400, 512]),
        ("underflow", [0.2, 0.95, 0.85, 0.1], [512, 512, 300, 512]),
        ("overflow", [2.4, 0.9, 1.9, 0.86], [512, 480, 512, 512]),
    ],
)
def test_estimate_ls0_matches_jax(label, z, ns):
    """The prefix seed: ln_sigma0 + drift + ln(Z)/n where the prefix's
    scaled Z is finite and normal, the base seed where it is 0 or inf."""
    z = np.asarray(z, np.float64)
    ns = np.asarray(ns, np.int32)
    run = _synthetic_run(z, ns.astype(np.float64))
    shapes = (jax.ShapeDtypeStruct((len(z), 2, 2), jnp.float32),
              jax.ShapeDtypeStruct((len(z),), jnp.float32))
    want = PP._estimate_ls0(lambda ls: jax.pure_callback(run, shapes, ls),
                            len(z), jnp.asarray(ns), PP.LN_SIGMA0,
                            drift=PP.LS_PREFIX_DRIFT)

    def trun(ls):
        bppo, glob = run(ls.numpy())
        return torch.as_tensor(bppo), torch.as_tensor(glob)

    got = TPP._estimate_ls0(trun, torch.as_tensor(ns), TPP.LN_SIGMA0,
                            drift=TPP.LS_PREFIX_DRIFT)
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), maxulp=1)
    moved = got.numpy() != np.float32(TPP.LN_SIGMA0)
    assert moved.any() and (label == "finite" or not moved.all()), label
