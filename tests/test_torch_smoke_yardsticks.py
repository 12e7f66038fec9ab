"""The yardsticks ``chip_smoke.py`` sets beside each long kernel, on the CPU.

The cluster kernels K8, K9 (CONTRA) and K12, K13 (Turner) read their input
tables on live cells only (i + d < n), so ``chip_smoke.work`` must charge
them those cells' bytes and no more, and ``chip_smoke.reread_ms`` must give
each its own pass's HBM re-read floor: an inside kernel re-reads 16 B a
bifurcation term t >= 1 of each live cell (rm, rmmb, ext, one), an outside
kernel 8 B a pm term and 12 B an sa/sbc term.  Counted here by brute force
over the cells of a tiny ragged batch."""

import pytest
import torch

import chip_smoke

N = 64
LENGTHS = (9, 33, 50, 64)
LONG = ("contra_inside_long", "contra_outside_long", "turner_inside_long",
        "turner_outside_long")
# [d, i] input tables each long kernel reads (the outside's ONE and QONE
# among them) and tables it writes
TABLES = {"contra_inside_long": (9, 3), "contra_outside_long": (11, 1),
          "turner_inside_long": (18, 3), "turner_outside_long": (20, 1)}


def batch():
    ns = torch.tensor(LENGTHS, dtype=torch.int32)
    return {"seqs": torch.zeros((len(LENGTHS), N), dtype=torch.int64),
            "ns": ns}


def live_cells():
    """Every live cell (n, d, i) of the batch."""
    return [(n, d, i) for n in LENGTHS for d in range(n) for i in range(n - d)]


@pytest.mark.parametrize("kernel", LONG)
def test_long_kernels_are_live_only(kernel):
    assert kernel in chip_smoke.LIVE_ONLY


@pytest.mark.parametrize("kernel", LONG)
def test_work_charges_live_cell_input_bytes(kernel):
    nbytes, _ = chip_smoke.work(kernel, batch())
    ins, outs = TABLES[kernel]
    whole = 4 * len(LENGTHS) * N * N
    assert nbytes == ins * 4 * len(live_cells()) + outs * whole


@pytest.mark.parametrize("kernel", ("contra_inside_long",
                                    "turner_inside_long"))
def test_reread_of_inside_kernels_is_16_bytes_a_term(kernel):
    terms = sum(max(d - 1, 0) for _, d, _ in live_cells())
    want = 16.0 * terms / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert chip_smoke.reread_ms(kernel, batch()) == pytest.approx(want,
                                                                 rel=1e-12)


@pytest.mark.parametrize("kernel", ("contra_outside_long",
                                    "turner_outside_long"))
def test_reread_of_outside_kernels(kernel):
    pm = sum(max(n - 2 - d - i, 0) for n, d, i in live_cells())
    sums = sum(min(i, n - 1 - d) for n, d, i in live_cells())
    want = (8.0 * pm + 12.0 * sums) / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert chip_smoke.reread_ms(kernel, batch()) == pytest.approx(want,
                                                                 rel=1e-12)


@pytest.mark.parametrize("kernel", ("turner_inside", "contra_outside",
                                    "skew"))
def test_reread_refuses_other_kernels(kernel):
    with pytest.raises(ValueError):
        chip_smoke.reread_ms(kernel, batch())


def test_turner_long_shapes_cover_the_main_paths_and_waves():
    """Every main-path shape of the Turner long tier, the prefix pass's
    (N = 512 at the 1,024 batch) and one batch of more clusters than fit
    at once are checked on the card."""
    checked = set(chip_smoke.LONG_CHECK["turner"])
    assert set(chip_smoke.LONG_MAIN["turner"]) <= checked
    assert (512, chip_smoke.LONG_BATCHES[1024][0]) in checked
    assert (512, 80) in checked
