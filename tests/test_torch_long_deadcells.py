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
which it multiplied by a g of 0.  The parity tier's inside kernels K16 and
K18 leave their dead cells the wrappers' fills too: the same contract,
held on the plain log path below (its outside pass sums pm over its live
terms only, for the same reason)."""

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


LOG_N = 32
LOG_LENGTHS = (32, 19, 7, 3)


@pytest.mark.parametrize("model", ["contra", "turner"])
def test_log_outside_never_reads_dead_cells(model):
    """The plain version of the parity tier's outside pass computes no dead
    cell and reads none of its own: with NaN written into every dead cell of
    the close it is handed (ext and one feed the outside auxiliaries, which
    sum over the whole sequence), its bppo is bitwise that of the untouched
    run, and -inf in every dead cell.  This pins the plain version only;
    K17 and K19 are held to the same on the card
    (test_torch_cuda.py::test_log_outside_kernel_never_reads_dead_cells,
    chip_smoke.check_log_dead_cells) and bitwise to this plain version."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF

    gen = torch.Generator().manual_seed(23)
    seqs = [torch.randint(0, 4, (n,), generator=gen).tolist()
            for n in LOG_LENGTHS]
    arr, ns = chip_smoke.padded(seqs, LOG_N, "cpu")
    mask = dead_cells(ns, LOG_N)
    if model == "contra":
        fold, tbl = (PF.mccaskill_contra_pallas,
                     contra_tables(build_fold_score_sets(), "cpu"))
    else:
        fold, tbl = PF.mccaskill_turner_pallas, turner_tables("cpu")
    inside = getattr(PF, f"{model}_inside_log")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bppo_ref = fold(arr, ns, tbl, LOG_N)[0]
        def close_poisoned(*args):
            close, ext, one = inside(*args)
            return (torch.where(mask, torch.full((), float("nan")), close),
                    ext, one)

        setattr(PF, f"{model}_inside_log", close_poisoned)
        bppo = fold(arr, ns, tbl, LOG_N)[0]
    finally:
        setattr(PF, f"{model}_inside_log", inside)
        torch.set_num_threads(threads)
    assert torch.equal(bppo.view(torch.int32), bppo_ref.view(torch.int32))
    assert bool((bppo[mask] == float("-inf")).all())
    assert int(torch.isfinite(bppo).sum()) > 0


@pytest.mark.parametrize("model", ["contra", "turner"])
def test_log_inside_dead_cells_never_read(model):
    """K16 and K18 compute live cells only and leave the dead ones their
    fills, so nothing after the parity tier's inside pass may read a dead
    cell: with NaN written into every dead cell of the close, ext and one
    of the plain inside pass, the rest of the parity path (the outside
    auxiliaries, ``onep``, the plain outside pass, the finish) gives
    bitwise the bppo, BPPs and presence of the untouched run."""
    from rna_algos_tpu_torch.ops import pallas_fold as PF

    gen = torch.Generator().manual_seed(29)
    seqs = [torch.randint(0, 4, (n,), generator=gen).tolist()
            for n in LOG_LENGTHS]
    arr, ns = chip_smoke.padded(seqs, LOG_N, "cpu")
    mask = dead_cells(ns, LOG_N)
    if model == "contra":
        fold, tbl = (PF.mccaskill_contra_pallas,
                     contra_tables(build_fold_score_sets(), "cpu"))
    else:
        fold, tbl = PF.mccaskill_turner_pallas, turner_tables("cpu")
    name = f"{model}_inside_log"
    inside = getattr(PF, name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bppo_ref = fold(arr, ns, tbl, LOG_N)[0]
        setattr(PF, name, poisoned(inside, mask))
        bppo = fold(arr, ns, tbl, LOG_N)[0]
    finally:
        setattr(PF, name, inside)
        torch.set_num_threads(threads)
    assert torch.equal(bppo.view(torch.int32), bppo_ref.view(torch.int32))
    bpp_ref, pres_ref = M._log_finish(bppo_ref, ns, LOG_N)
    bpp, pres = M._log_finish(bppo, ns, LOG_N)
    assert torch.equal(bpp.view(torch.int32), bpp_ref.view(torch.int32))
    assert torch.equal(pres, pres_ref)
    assert int(pres.sum()) > 0


@pytest.mark.parametrize("model", ["contra", "turner"])
def test_log_outside_lets_no_dead_table_cell_through(model):
    """The plain outside log pass through ``chip_smoke.check_log_dead_cells``
    (the check K17/K19 meet on the card), on chip_smoke.py's N = 32 edge
    batch: NaN in every dead cell of each [d, i] table it is handed leaves
    its bppo bitwise unchanged."""
    lengths = chip_smoke.LOG_EDGE[LOG_N]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        x = chip_smoke.log_inputs(model, LOG_N, len(lengths), seed=7,
                                  device="cpu", lengths=lengths)
        chip_smoke.check_log_dead_cells(x)
    finally:
        torch.set_num_threads(threads)
