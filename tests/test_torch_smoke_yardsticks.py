"""The yardsticks ``chip_smoke.py`` sets beside each long kernel, on the CPU.

The cluster kernels K8, K9 (CONTRA) and K12, K13 (Turner) read their input
tables on live cells only (i + d < n), so ``chip_smoke.work`` must charge
them those cells' bytes and no more, and ``chip_smoke.reread_ms`` must give
each its own pass's HBM re-read floor: an inside kernel re-reads 16 B a
bifurcation term t >= 1 of each live cell (rm, rmmb, ext, one), an outside
kernel 8 B a pm term and 12 B an sa/sbc term.  The parity kernels K16-K19
are charged the terms and the input cells this run's data needs
(``log_inside_terms``, ``log_inside_bytes``, ``log_outside_terms``,
``log_outside_bytes``).  Counted here by brute force
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


def outside_batch(seed=5, min_span=5):
    """A ragged batch with -inf CLOSE cells, as an outside log call sees it."""
    gen = torch.Generator().manual_seed(seed)
    close = torch.where(torch.rand((len(LENGTHS), N, N), generator=gen) < 0.6,
                        float("-inf"), 0.0)
    return close, dict(batch(), outside_args=({"CLOSE": close}, min_span))


def test_log_outside_terms_count_what_the_data_needs():
    """``chip_smoke.log_outside_terms`` (the bound of K17/K19): r = n-1-d-i
    pm terms at every live cell; where CLOSE is finite and d + 1 >= min_span
    also the window leaves (a < min(i, 31), b < min(31 - a, r)) and min(i, k)
    context terms; by brute force on a batch with -inf CLOSE cells."""
    close, inp = outside_batch()
    min_span = inp["outside_args"][-1]
    want = [0, 0, 0, 0]
    for b, n in enumerate(LENGTHS):
        for d in range(n):
            for i in range(n - d):
                r, k = n - 1 - d - i, n - 1 - d
                want[0] += 1
                want[2] += r
                if close[b, d, i] > float("-inf") and d + 1 >= min_span:
                    want[1] += sum(min(31 - a, r) for a in range(min(i, 31)))
                    want[3] += min(i, k)
    assert list(chip_smoke.log_outside_terms(inp)) == want


@pytest.mark.parametrize("kernel,others,vectors,lens", [
    ("contra_outside_log", 7, 2, 1), ("turner_outside_log", 16, 1, 2)])
def test_log_outside_bytes_count_what_the_data_needs(kernel, others, vectors,
                                                     lens):
    """``chip_smoke.log_outside_bytes`` (the bytes of K17/K19's bound): the
    distinct input cells the terms read, by brute force.  CLOSE at every
    live cell; the other [d, i] tables (7 CONTRA, 16 Turner) at the full
    cells (CLOSE finite, d + 1 >= min_span); ONEP at (s, i + d + 1), s < r,
    of every live cell of a span reaching min_span; QONE at (t, i), 1 <= t
    <= min(i, k), of the full cells; the lane vectors (EXTL, and B0LO for
    CONTRA) at the full cells' lanes, EXTR at their j + 1; the (32, 31)
    length tables, scal (B, 8) and ns whole; bppo written whole."""
    close, inp = outside_batch()
    min_span = inp["outside_args"][-1]
    live = full = 0
    onep, qone, lanes, extr = set(), set(), set(), set()
    for b, n in enumerate(LENGTHS):
        for d in range(n):
            for i in range(n - d):
                r, k = n - 1 - d - i, n - 1 - d
                live += 1
                if d + 1 >= min_span:
                    onep.update((b, s, i + d + 1) for s in range(r))
                if close[b, d, i] > float("-inf") and d + 1 >= min_span:
                    full += 1
                    qone.update((b, t, i) for t in range(1, min(i, k) + 1))
                    lanes.add((b, i))
                    extr.add((b, i + d + 1))
    B = len(LENGTHS)
    cells = (live + others * full + len(onep) + len(qone)
             + vectors * len(lanes) + len(extr)
             + lens * 32 * 31 + B * 8 + B + B * N * N)
    assert chip_smoke.log_outside_bytes(kernel, inp) == 4.0 * cells
    assert chip_smoke.log_work(kernel, inp)[0] == 4.0 * cells


def inside_batch(seed=5):
    """A ragged batch whose CANON is -inf at ~60% of the cells."""
    gen = torch.Generator().manual_seed(seed)
    canon = torch.where(torch.rand((len(LENGTHS), N, N), generator=gen) < 0.6,
                        float("-inf"), 0.0)
    return canon, dict(batch(), inside_args=({"CANON": canon},))


def full_cells(canon):
    """Every live cell (b, d, i) whose close the inside kernels compute:
    CANON finite from span MIN_SPAN_HAIRPIN_CLOSE on."""
    return {(b, d, i) for b, n in enumerate(LENGTHS) for d in range(n)
            for i in range(n - d)
            if canon[b, d, i] > float("-inf") and d + 1 >= 5}


def test_log_inside_terms_count_what_the_data_needs():
    """``chip_smoke.log_inside_terms`` (the bound of K16/K18): at every live
    cell d ext terms and d - 1 s1/s2 terms; at the full cells (CANON finite,
    d + 1 >= 5) the window leaves (a, b) with a + b <= min(d - 2, 30); by
    brute force on a batch with -inf CANON cells."""
    canon, inp = inside_batch()
    full = full_cells(canon)
    want = [0, len(full), 0, 0, 0]
    for n, d, i in live_cells():
        want[0] += 1
        want[3] += d
        want[4] += max(d - 1, 0)
    for _b, d, _i in full:
        want[2] += sum(1 for a in range(31) for bb in range(32)
                       if a + bb <= min(d - 2, 30))
    assert list(chip_smoke.log_inside_terms(inp)) == want


@pytest.mark.parametrize("kernel,others,shifted,lens", [
    ("contra_inside_log", 8, 1, 1), ("turner_inside_log", 17, 0, 2)])
def test_log_inside_bytes_count_what_the_data_needs(kernel, others, shifted,
                                                    lens):
    """``chip_smoke.log_inside_bytes`` (the bytes of K16/K18's bound), by
    brute force: CANON at every live cell, the other [d, i] tables at the
    full cells, CONTRA's JB at the full cells and their (d - 2, i + 1), the
    (32, 31) length tables, scal (B, 8) and ns whole; close, ext and one
    written whole."""
    canon, inp = inside_batch(seed=9)
    full = full_cells(canon)
    jb = full | {(b, d - 2, i + 1) for b, d, i in full}
    B = len(LENGTHS)
    cells = (len(live_cells()) + others * len(full) + shifted * len(jb)
             + lens * 32 * 31 + B * 8 + B + 3 * B * N * N)
    assert chip_smoke.log_inside_bytes(kernel, inp) == 4.0 * cells
    assert chip_smoke.log_work(kernel, inp)[0] == 4.0 * cells


def test_log_checks_reach_every_thread_group():
    """K16-K19 give a lane G = min(32, 1024 / N) threads (4, 8, 16, 32 at
    N = 256, 128, 64, 32), one kernel instantiation each; the main shapes
    and LOG_EDGE hold every one of them against the plain version."""
    shapes = {N for N, _B in chip_smoke.SHAPES_MAIN} | set(chip_smoke.LOG_EDGE)
    assert {min(32, 1024 // n) for n in shapes} == {4, 8, 16, 32}
