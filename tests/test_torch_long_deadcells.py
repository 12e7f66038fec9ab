"""The dead-cell contract of the probability-space wavefronts, on the CPU.

A cell (d, i) of the [d, i] tables is dead when i + d >= n: its pair
(i, i + d) ends past the sequence.  The long kernels K8, K9 (CONTRA) and
K12, K13 (Turner) skip such cells and leave them the zeros the wrappers
pass, so nothing downstream of them may read one.  Here the plain path, on a ragged batch at
N = 128, has close, ext and one set to NaN at every dead cell before the
outside auxiliaries, and bppo set to NaN there before the finish: the
settled ln_sigma, the live BPPs and the presence must be bitwise those of
the untouched path.  The plain outside's pm sum runs over its live terms
only (t < n - 2 - d - i): it was the one reader of a dead `one` cell,
which it multiplied by a g of 0."""

import pytest
import torch

from rna_algos_tpu_torch.models import mccaskill as M
from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
from rna_algos_tpu_torch.params import build_fold_score_sets
from rna_algos_tpu_torch.weights import contra_tables, turner_tables

import chip_smoke

N = 128
LENGTHS = (40, 77, 101, 120)


def dead_cells(ns, N):
    """(B, N, N) [d, i] mask of the cells with i + d >= n."""
    r = torch.arange(N)
    return (r[None, :, None] + r[None, None, :]) >= ns.view(-1, 1, 1)


def poisoned(fn, mask):
    """``fn`` with NaN written into every dead cell of its outputs."""
    def call(*args):
        out = fn(*args)
        nan = torch.full((), float("nan"))
        outs = out if isinstance(out, tuple) else (out,)
        outs = tuple(torch.where(mask, nan, x) for x in outs)
        return outs if isinstance(out, tuple) else outs[0]
    return call


@pytest.mark.parametrize("model", ["contra", "turner"])
def test_dead_cells_are_never_read(model):
    gen = torch.Generator().manual_seed(17)
    seqs = [torch.randint(0, 4, (n,), generator=gen).tolist()
            for n in LENGTHS]
    arr, ns = chip_smoke.padded(seqs, N, "cpu")
    mask = dead_cells(ns, N)
    if model == "contra":
        tbl = contra_tables(build_fold_score_sets(), "cpu")

        def run_with(inside):
            return lambda ls: P8._prob8_run_body(arr, ns, tbl, ls, N, False,
                                                 inside=inside)
        inside, ls0 = P8.contra_inside, None
    else:
        tbl = turner_tables("cpu")

        def run_with(inside):
            return lambda ls: P8._turner_prob8_run_body(arr, ns, tbl, ls, N,
                                                        inside=inside)
        inside, ls0 = P8.turner_inside, PP.LN_SIGMA0_TURNER
    bppo_ref, ls_ref = PP._retrying(run_with(inside), ns, ls0=ls0)
    bppo, ls = PP._retrying(run_with(poisoned(inside, mask)), ns, ls0=ls0)
    assert torch.equal(ls, ls_ref)
    assert not bool(torch.isnan(bppo).any())
    bppo = torch.where(mask, torch.full((), float("nan")), bppo)
    bpp_ref, pres_ref = M._prob_finish(bppo_ref, ns, N)
    bpp, pres = M._prob_finish(bppo, ns, N)
    assert torch.equal(bpp.view(torch.int32), bpp_ref.view(torch.int32))
    assert torch.equal(pres, pres_ref)
    assert int(pres.sum()) > 0
