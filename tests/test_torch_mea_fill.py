"""K23's plain version (``ops.mea_fill.mea_fill_batch_plain``) against the
JAX fill, bitwise for every record and gamma; the one-record entry points
as its slices; ``centroid_structures`` grouped by bucket against one record
at a time; the wrapper's refusal of a device with no kernel."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from rna_algos_tpu.models import centroid as JC

from rna_algos_tpu_torch.models import centroid as TC
from rna_algos_tpu_torch.ops import mea_fill as MF

from .conftest import REPO_ROOT

N = 96
GAMMAS = TC.DEFAULT_GAMMAS


def golden_bpps(records):
    gold = np.load(REPO_ROOT / "tests" / "golden" / "trna_bpps.npz")
    out = np.zeros((len(records), N, N), np.float32)
    lengths = []
    for r, key in enumerate(records):
        bpp = gold[key].astype(np.float32)
        n = bpp.shape[0]
        out[r, :n, :n] = bpp
        lengths.append(n)
    return out, lengths


CASES = {
    "random": lambda: (chip_smoke.mea_inputs(N, 3, seed=23, device="cpu")
                       .numpy(), [96, 90, 84]),
    "golden": lambda: golden_bpps(("rec0_contra", "rec2_turner",
                                   "rec5_contra")),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def batch(request):
    bpps, lengths = CASES[request.param]()
    assert len(set(lengths)) == 3
    fills = MF.mea_fill_batch_plain(torch.as_tensor(bpps), GAMMAS).numpy()
    return bpps, lengths, fills


def test_plain_batch_is_bitwise_the_jax_fill(batch):
    bpps, _lengths, fills = batch
    assert fills.shape == (3, len(GAMMAS), N, N)
    for r in range(3):
        for k, g in enumerate(GAMMAS):
            want = np.asarray(JC.mea_fill(jnp.asarray(bpps[r]), g, N=N))
            np.testing.assert_array_equal(want.view(np.int32),
                                          fills[r, k].view(np.int32))


def test_one_record_entries_are_the_batch_slices(batch):
    bpps, _lengths, fills = batch
    for r in range(3):
        got = TC.mea_fill_gammas(torch.as_tensor(bpps[r]), GAMMAS, N).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      fills[r].view(np.int32))
    one = TC.mea_fill(torch.as_tensor(bpps[1]), GAMMAS[9], N).numpy()
    np.testing.assert_array_equal(one.view(np.int32),
                                  fills[1, 9].view(np.int32))


@pytest.mark.parametrize("chunk_bytes", [1, None],
                         ids=["one_record_a_launch", "default_cap"])
def test_grouped_structures_equal_one_record_at_a_time(monkeypatch,
                                                       chunk_bytes):
    """Records of buckets 64, 96 and 128 in mixed order: the grouped call
    gives each record the strings it gets alone, in input order."""
    if chunk_bytes is not None:
        monkeypatch.setattr(TC, "MEA_FILL_CHUNK_BYTES", chunk_bytes)
    lengths = (70, 40, 110, 90, 64, 75)
    rng = np.random.default_rng(5)
    results = []
    for n in lengths:
        up = np.triu(np.where(rng.random((n, n)) < 0.08,
                              rng.random((n, n)), 0.0), 1).astype(np.float32)
        results.append((up + up.T, None, n))
    gammas = (0.5, 4.0, 64.0)
    grouped = TC.centroid_structures(results, gammas, "cpu")
    for k, rec in enumerate(results):
        alone = TC.centroid_structures([rec], gammas, "cpu")
        for g in gammas:
            assert grouped[g][k] == alone[g][0]
            assert len(grouped[g][k]) == lengths[k]
    assert any("(" in s for s in grouped[64.0])


def test_wrapper_raises_on_a_device_without_a_kernel():
    bpps = torch.zeros((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        MF.mea_fill_batch(bpps, GAMMAS)
    assert MF.state_in_shared(256) and not MF.state_in_shared(384)
