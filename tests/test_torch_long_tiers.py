"""The long tier's routing and seed against the JAX package: the buckets
``kernel_bucket(n, contra)`` picks for n = 1..2048 and past 2048 against
the JAX ``FoldEngine``'s (run with the TPU gate forced on), the generic-N
path off the tiers, ``pallas_available`` and ``_estimate_ls0`` (the prefix
seed) on a synthetic run."""

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
from rna_algos_tpu_torch.ops import fold_scan as FS
from rna_algos_tpu_torch.ops import pallas_fold_prob as TPP
from rna_algos_tpu_torch.params import build_fold_score_sets
from rna_algos_tpu_torch.parallel import runner as TR
from rna_algos_tpu_torch.weights import contra_tables, turner_tables

from .test_torch_fold import _synthetic_run
from .scan_cases import single_torch_thread  # noqa: F401  (fixture)

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
        assert TR.kernel_bucket(n, contra) == N, n
        if JM.pallas_available(contra, N):
            fused += 1
            assert TM.pallas_available(contra, N)
        else:
            # the JAX package folds it with the XLA scan: the port's
            # generic-N path (K20/K21), at the same bucket
            assert not TM.pallas_available(contra, N), n
            assert N % 128 == 0 and N > 1024, (n, N)
    assert fused == (2048 if contra else 1024)


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
@pytest.mark.usefixtures("single_torch_thread")
def test_kernel_bucket_refuses_past_the_tiers(on_tpu, contra, monkeypatch):
    """(Named when these lengths were refused.) Past the tiers the port
    takes the JAX runner's bucket (pick_bucket's multiples of 128, with its
    RuntimeWarning past 2048) and the generic-N path:
    ``mccaskill_bpp_batch_auto`` at a bucket no tier takes (N = 160) runs
    the plain scan once a pass on the CPU."""
    lengths = (2049, 2177, 3000)
    with pytest.warns(RuntimeWarning, match="fused-kernel tiers"):
        JR.FoldEngine(uses_contra_model=contra).fold_batch(
            [[0] * n for n in lengths])
    for n in lengths:
        with pytest.warns(RuntimeWarning, match="fused-kernel tiers"):
            N = TR.kernel_bucket(n, contra)
        assert N == on_tpu[n] == ((n + 127) // 128) * 128
        assert not TM.pallas_available(contra, N)
    calls = []
    for name in ("scan_inside_plain", "scan_outside_plain"):
        orig = getattr(FS, name)
        monkeypatch.setattr(FS, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    N, B = 160, 2
    rng = np.random.default_rng(contra)
    seqs = torch.full((B, N), 4, dtype=torch.int64)
    ns = torch.tensor([N, 117], dtype=torch.int32)
    for k in range(B):
        seqs[k, :int(ns[k])] = torch.as_tensor(rng.integers(0, 4, int(ns[k])))
    tbl = (contra_tables(build_fold_score_sets(), "cpu") if contra
           else turner_tables("cpu"))
    bpp, presence = TM.mccaskill_bpp_batch_auto(seqs, ns, tbl, N=N,
                                                contra=contra)
    assert calls == ["scan_inside_plain", "scan_outside_plain"]
    assert bpp.shape == presence.shape == (B, N, N)
    assert torch.isfinite(bpp).all() and presence.any()
    assert not presence[1, :, 117:].any()


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
