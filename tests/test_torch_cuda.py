"""Kernels K1-K5, K8, K9, K12-K22 against their plain versions on a
CUDA GPU: the checks of chip_smoke.py, at the main paths' buckets (K1/K2
and K4/K5 on live cells with their dead cells 0, also on edge batches at
each bucket <= 256 and with NaN in their dead input cells and scratch; the long
tier's at a centred per-sequence ln_sigma, K8/K9 and K12/K13 on live cells
with their dead cells 0, at every cluster size the check shapes take; the pair-HMM's
bitwise at each pair's settled ln_sigma, also with NaN-filled output
planes and on edge batches at N = 64 and 256; the parity tier's log kernels
on a few random sequences at N = 128 and 256; the generic-N scan's K20/K21
on the N = 160 edge batch and one parity path past 256; K15's fast
instance; the Durbin row scan K22 on its edge batch, past 4,096 columns
(a cluster of blocks a pair, and the runs in the global scratch), on two
SSU pairs that each span a cluster, and through AlignEngine beside K14 and
on a 4,100-nt record).  Skipped without
a GPU; run on the card with ``python -m pytest tests/test_torch_cuda.py -m cuda``."""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module", params=chip_smoke.SHAPES_CHECK,
                ids=lambda s: f"N{s[0]}_B{s[1]}")
def inputs(device, request):
    N, B = request.param
    return chip_smoke.kernel_inputs(N, B, seed=N + B, device=device)


@pytest.fixture(scope="module", params=chip_smoke.SHAPES_CHECK,
                ids=lambda s: f"N{s[0]}_B{s[1]}")
def turner_inputs(device, request):
    N, B = request.param
    return chip_smoke.turner_inputs(N, B, seed=N + B + 1, device=device)


LONG_SHAPES = [(m, N, B) for m, shapes in chip_smoke.LONG_CHECK.items()
               for N, B in shapes]


@pytest.fixture(scope="module", params=LONG_SHAPES,
                ids=lambda s: f"{s[0]}_N{s[1]}_B{s[2]}")
def long_inputs(device, request):
    model, N, B = request.param
    build = (chip_smoke.kernel_inputs if model == "contra"
             else chip_smoke.turner_inputs)
    return build(N, B, seed=N + B, device=device)


def test_long_inside_kernel_matches_plain(long_inputs):
    """K8 (CONTRA, N = 512, 1024, 2048) and K12 (Turner, N = 512, 1024)."""
    kernel = long_inputs["kernels"][0]
    chip_smoke.check_inside(long_inputs, chip_smoke.LABELS[kernel], kernel)


def test_long_outside_kernel_matches_plain(long_inputs):
    """K9 (CONTRA) and K13 (Turner) on bppo."""
    kernel = long_inputs["kernels"][1]
    err = chip_smoke.check_outside(long_inputs, chip_smoke.LABELS[kernel],
                                   kernel)
    assert err <= chip_smoke.ATOL_BPPO


def test_long_skew_kernel_bitwise(long_inputs):
    assert chip_smoke.check_skew(long_inputs) == 0.0


def test_skew_kernel_bitwise(inputs):
    assert chip_smoke.check_skew(inputs) == 0.0


def test_skew_kernel_18_tables_bitwise(turner_inputs):
    """The Turner precompute's 18 tables in one launch (past the former
    16-table cap), bitwise in both directions."""
    assert len(turner_inputs["pq"]) == 18
    assert chip_smoke.check_skew(turner_inputs) == 0.0


def test_turner_inside_kernel_matches_plain(turner_inputs):
    """K4 on live cells within RTOL_INSIDE, dead cells 0."""
    chip_smoke.check_inside(turner_inputs, "K4", "turner_inside")


def test_turner_outside_kernel_matches_plain(turner_inputs):
    """K5 on live cells within ATOL_BPPO, dead cells 0."""
    err = chip_smoke.check_outside(turner_inputs, "K5", "turner_outside")
    assert err <= chip_smoke.ATOL_BPPO


def test_inside_kernel_matches_plain(inputs):
    chip_smoke.check_inside(inputs)


def test_outside_kernel_matches_plain(inputs):
    assert chip_smoke.check_outside(inputs) <= chip_smoke.ATOL_BPPO


@pytest.fixture(scope="module", params=sorted(chip_smoke.PROB_EDGE),
                ids=lambda N: f"N{N}")
def edge_inputs(device, request):
    N = request.param
    lengths = chip_smoke.PROB_EDGE[N]
    return chip_smoke.kernel_inputs(N, len(lengths), seed=3 * N,
                                    device=device, lengths=lengths)


def test_inside_kernel_on_edge_batches(edge_inputs):
    """K1 at each bucket <= 256 of the probability path on n = 1-5, lengths
    just past a power of two and n = N: live cells within RTOL_INSIDE, dead
    cells 0."""
    chip_smoke.check_inside(edge_inputs)


def test_outside_kernel_on_edge_batches(edge_inputs):
    assert chip_smoke.check_outside(edge_inputs) <= chip_smoke.ATOL_BPPO


@pytest.mark.parametrize("which", [0, 1], ids=["K1", "K2"])
def test_prob_kernels_never_read_dead_cells(edge_inputs, which):
    """NaN in every dead cell of K1's or K2's [d, i] tables and in their
    scratch leaves their outputs bitwise unchanged, dead cells 0."""
    chip_smoke.check_prob_dead_cells(edge_inputs, which)


@pytest.mark.parametrize("which", [0, 1], ids=["K1", "K2"])
def test_prob_kernels_never_read_dead_cells_at_check_shapes(inputs, which):
    chip_smoke.check_prob_dead_cells(inputs, which)


@pytest.fixture(scope="module", params=sorted(chip_smoke.PROB_EDGE),
                ids=lambda N: f"N{N}")
def turner_edge_inputs(device, request):
    N = request.param
    lengths = chip_smoke.PROB_EDGE[N]
    return chip_smoke.turner_inputs(N, len(lengths), seed=3 * N + 1,
                                    device=device, lengths=lengths)


def test_turner_inside_kernel_on_edge_batches(turner_edge_inputs):
    """K4 at each bucket <= 256 of the probability path on n = 1-5,
    lengths just past a power of two and n = N: live cells within
    RTOL_INSIDE, dead cells 0."""
    chip_smoke.check_inside(turner_edge_inputs, "K4", "turner_inside")


def test_turner_outside_kernel_on_edge_batches(turner_edge_inputs):
    assert chip_smoke.check_outside(turner_edge_inputs, "K5",
                                    "turner_outside") <= chip_smoke.ATOL_BPPO


@pytest.mark.parametrize("which", [0, 1], ids=["K4", "K5"])
def test_turner_prob_kernels_never_read_dead_cells(turner_edge_inputs,
                                                   which):
    """NaN in every dead cell of K4's or K5's [d, i] tables and in their
    scratch leaves their outputs bitwise unchanged, dead cells 0."""
    chip_smoke.check_prob_dead_cells(turner_edge_inputs, which)


@pytest.mark.parametrize("which", [0, 1], ids=["K4", "K5"])
def test_turner_prob_kernels_never_read_dead_cells_at_check_shapes(
        turner_inputs, which):
    chip_smoke.check_prob_dead_cells(turner_inputs, which)


def test_block_sizes_at_the_main_shapes(device):
    """K1/K2 and K4/K5 each take a block size of 256, 512 or 1,024 threads
    a sequence at the main shapes and the edge batches."""
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

    shapes = list(chip_smoke.SHAPES_MAIN) + [
        (N, len(n)) for N, n in chip_smoke.PROB_EDGE.items()]
    for N, B in shapes:
        for sizes in (P8.contra_block_threads(B, N),
                      P8.turner_block_threads(B, N)):
            assert all(t in (256, 512, 1024) and t >= N for t in sizes)


def test_main_path_launches_every_kernel(device):
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3
    from rna_algos_tpu_torch.parallel.runner import FoldEngine

    counters = (K3.launches, P8.inside_launches, P8.outside_launches)
    for c in counters:
        c.reset()
    engine = FoldEngine(uses_contra_model=True, device=device)
    out = engine.fold_batch(chip_smoke.random_batch(8, 60, 120, seed=3))
    assert all(c.count >= 1 for c in counters)
    assert all(bpp.shape[0] == presence.shape[0] for bpp, presence in out)


def test_turner_main_path_launches_its_kernels(device):
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.ops import pallas_skew as K3
    from rna_algos_tpu_torch.parallel.runner import FoldEngine

    counters = (K3.launches, P8.turner_inside_launches,
                P8.turner_outside_launches)
    engine = FoldEngine(uses_contra_model=False, device=device)
    for c in counters + (P8.inside_launches, P8.outside_launches):
        c.reset()
    out = engine.fold_batch(chip_smoke.random_batch(8, 60, 120, seed=4))
    assert all(c.count >= 1 for c in counters)
    assert P8.inside_launches.count == P8.outside_launches.count == 0
    assert all(np.isfinite(bpp).all() for bpp, _ in out)


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_long_main_path_launches_its_kernels(device, contra):
    from rna_algos_tpu_torch.ops import pallas_fold_long as PL
    from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8
    from rna_algos_tpu_torch.parallel.runner import FoldEngine, kernel_bucket

    model = "contra" if contra else "turner"
    mine = (getattr(PL, f"{model}_inside_long_launches"),
            getattr(PL, f"{model}_outside_long_launches"))
    engine = FoldEngine(uses_contra_model=contra, device=device)
    seqs = chip_smoke.random_batch(4, 300, 700, seed=5)
    for c in mine:
        c.reset()
    out = engine.fold_batch(seqs)
    assert all(c.count >= 1 for c in mine)
    assert all(bpp.shape == (len(s), len(s)) and np.isfinite(bpp).all()
               for (bpp, _), s in zip(out, seqs))


@pytest.fixture(scope="module", params=[(6, 128), (12, 256)],
                ids=["trna_N128", "rfam_N256"])
def durbin_inputs(device, request):
    """A few pairs of each Durbin set (the tRNAs tiled, or random
    150-200 nt sequences) at its bucket."""
    from rna_algos_tpu_torch.utils.io import read_fasta

    count, N = request.param
    trnas = [r.seq for r in read_fasta(chip_smoke.ROOT / "assets"
                                       / "sampled_trnas.fa")]
    key = "trna_N128_P630" if N == 128 else "rfam_N256_P2016"
    seqs, _ = chip_smoke.durbin_sets(trnas)[key]
    seqs = seqs[:count]
    pairs = [(a, b) for a in range(count) for b in range(a + 1, count)]
    x = chip_smoke.durbin_inputs(seqs, pairs, device)
    assert x["N"] == N
    return x


@pytest.mark.parametrize("kernel", ["pairhmm_prob", "pairhmm_log"],
                         ids=["K14", "K15"])
def test_pairhmm_kernel_matches_plain(durbin_inputs, kernel):
    """K14 and K15 bitwise equal to their plain versions (forward and
    backward, planes and corners), also with the output planes NaN-filled
    before the launch (check_pairhmm raises otherwise)."""
    assert chip_smoke.check_pairhmm(durbin_inputs, kernel) == 0.0


@pytest.mark.parametrize("kernel", ["pairhmm_prob", "pairhmm_log"],
                         ids=["K14", "K15"])
def test_pairhmm_kernel_bitwise_on_edge_batches(device, kernel):
    """chip_smoke.DURBIN_EDGE: n = 3, n = N, n1 != n2 and mixed lengths in
    one launch, at N = 64 and 256."""
    for x in chip_smoke.durbin_edge_inputs(device).values():
        assert chip_smoke.check_pairhmm(x, kernel) == 0.0


@pytest.mark.parametrize("numerics", ["exact", "parity"])
def test_durbin_path_launches_its_kernel(device, numerics):
    from rna_algos_tpu_torch.ops import pallas_align as PA
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
    from rna_algos_tpu_torch.parallel.runner import AlignEngine

    mine, other = ((PAP.prob_launches, PA.log_launches) if numerics == "exact"
                   else (PA.log_launches, PAP.prob_launches))
    engine = AlignEngine(device=device, numerics=numerics)
    seqs = [np.array([4] + s + [4], np.int32)
            for s in chip_smoke.random_batch(5, 40, 120, seed=6)]
    pairs = [(0, 1), (3, 2), (4, 0), (1, 4)]
    for c in (mine, other):
        c.reset()
    out = engine.match_probs_pairs(seqs, pairs)
    assert mine.count >= 2 and other.count == 0
    assert list(out) == pairs
    assert all(p.shape == (len(seqs[a]), len(seqs[b])) and np.isfinite(p).all()
               for (a, b), p in out.items())


def test_pairhmm_log_fast_matches_plain(durbin_inputs):
    """K15's fast instance within RTOL_LOG_FAST of its plain version
    (check_pairhmm raises otherwise)."""
    assert chip_smoke.check_pairhmm(durbin_inputs,
                                    "pairhmm_log_fast") <= chip_smoke.RTOL_LOG_FAST


def test_rows_kernel_on_edge_batch(device):
    """K22 on chip_smoke.ROWS_EDGE's batch at (64, 96) (n = 2, 3, n = N,
    n1 != n2 in one rectangular bucket): bitwise under exact and parity,
    also with the planes NaN-filled, and within RTOL_LOG_FAST under
    fast."""
    fast_err = {}
    x = chip_smoke.rows_edge_inputs(device)[(64, 96)]
    chip_smoke.check_rows(x, "edge (64, 96)", ("exact", "parity", "fast"),
                          fast_err)
    assert fast_err["pairhmm_rows"] <= chip_smoke.RTOL_LOG_FAST


@pytest.mark.parametrize("key,scratch", [((128, 4224), 0), ((8, 40000), 1)],
                         ids=["N128x4224", "N8x40000"])
def test_rows_kernel_past_the_old_width_cap(device, key, scratch):
    """K22 past 4,096 columns (fault C5): a tRNA against 4,100-4,224-nt
    records at (128, 4224), a cluster of blocks a pair with the runs in
    registers; a few rows against 33,000-40,000-nt records, the runs in
    the global scratch.  Bitwise under exact and parity (planes and
    corners, also NaN-filled), within RTOL_LOG_FAST under fast."""
    from rna_algos_tpu_torch.ops.pairhmm_rows import rows_plan

    x = chip_smoke.rows_edge_inputs(device)[key]
    plan = rows_plan(key[1])
    assert plan["scratch"] == scratch and plan["C"] > 1
    fast_err = {}
    chip_smoke.check_rows(x, f"edge {key}", ("exact", "parity", "fast"),
                          fast_err)
    assert fast_err["pairhmm_rows"] <= chip_smoke.RTOL_LOG_FAST


def test_rows_kernel_ssu_pair_spans_a_cluster(device):
    """Two pairs of the SSU set's (1536, 1536) bucket: each pair's columns
    over a cluster of blocks; bitwise under exact and parity (also
    NaN-filled), within RTOL_LOG_FAST under fast."""
    from rna_algos_tpu_torch.ops.pairhmm_rows import rows_plan
    from rna_algos_tpu_torch.utils.io import read_fasta

    trnas = [r.seq for r in read_fasta(chip_smoke.ROOT / "assets"
                                       / "sampled_trnas.fa")]
    seqs, pairs = chip_smoke.rows_sets(trnas)["ssu_P28"]
    ssu = chip_smoke.rows_buckets(seqs, pairs)[(1536, 1536)][:2]
    x = chip_smoke.rows_inputs(seqs, ssu, (1536, 1536), device)
    assert rows_plan(1536)["C"] > 1
    fast_err = {}
    chip_smoke.check_rows(x, "ssu P2", ("exact", "parity", "fast"), fast_err)
    assert fast_err["pairhmm_rows"] <= chip_smoke.RTOL_LOG_FAST


def test_rows_path_past_4096_columns(device):
    """A tRNA against a 4,100-nt record through AlignEngine (bucket (96,
    4224)): K22 launched once a pass, the result cropped and bitwise the
    plain path's."""
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR
    from rna_algos_tpu_torch.parallel.runner import AlignEngine, align_bucket

    engine = AlignEngine(device=device)
    seqs = [np.array([4] + s + [4], np.int32)
            for s in (chip_smoke.random_batch(1, 76, 76, seed=9)
                      + chip_smoke.random_batch(1, 4100, 4100, seed=10))]
    assert align_bucket(len(seqs[0]), len(seqs[1]))[1] == 4224
    PR.launches.reset()
    out = engine.match_probs_pairs(seqs, [(0, 1)])
    assert PR.launches.count == 2
    with chip_smoke.plain_kernels():
        plain = engine.match_probs_pairs(seqs, [(0, 1)])
    assert out[(0, 1)].shape == (78, 4102)
    np.testing.assert_array_equal(out[(0, 1)], plain[(0, 1)])


def test_rows_path_launches_its_kernel(device):
    """A short pair (K14) and a pair with a 300-nt sequence (K22) through
    AlignEngine: each kernel launched, the result cropped, the K22 pair
    bitwise the plain path's."""
    from rna_algos_tpu_torch.ops import pairhmm_rows as PR
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
    from rna_algos_tpu_torch.parallel.runner import AlignEngine

    engine = AlignEngine(device=device)
    seqs = [np.array([4] + s + [4], np.int32)
            for s in (chip_smoke.random_batch(2, 60, 200, seed=7)
                      + chip_smoke.random_batch(1, 300, 300, seed=8))]
    pairs = [(0, 1), (0, 2)]
    PR.launches.reset()
    PAP.prob_launches.reset()
    out = engine.match_probs_pairs(seqs, pairs)
    assert PR.launches.count == 2 and PAP.prob_launches.count >= 2
    with chip_smoke.plain_kernels():
        plain = engine.match_probs_pairs(seqs, [(0, 2)])
    assert out[(0, 2)].shape == (len(seqs[0]), 302)
    np.testing.assert_array_equal(out[(0, 2)], plain[(0, 2)])


@pytest.fixture(scope="module", params=[("contra", 128), ("turner", 128),
                                        ("contra", 256), ("turner", 256)],
                ids=lambda s: f"{s[0]}_N{s[1]}")
def log_inputs(device, request):
    model, N = request.param
    return chip_smoke.log_inputs(model, N, 8, seed=N + 5, device=device)


@pytest.mark.parametrize("which", [0, 1], ids=["inside", "outside"])
def test_log_kernel_matches_plain(log_inputs, which):
    """K16/K17 (CONTRA) and K18/K19 (Turner): the -inf pattern identical,
    finite cells within 1e-4 * max(1, |x|), and bitwise (check_log raises
    otherwise); K16/K18 on the live cells, their dead cells holding the
    wrappers' fills."""
    kernel = log_inputs["kernels"][which]
    args = (log_inputs["inside_args"], log_inputs["outside_args"])[which]
    _abs, rel, _bitwise, _ms = chip_smoke.check_log(log_inputs, kernel, args)
    assert rel <= chip_smoke.RTOL_LOG


@pytest.mark.parametrize("model", ["contra", "turner"])
@pytest.mark.parametrize("N", sorted(chip_smoke.LOG_EDGE))
def test_log_outside_bitwise_on_edge_batches(device, model, N):
    """K17 / K19 on chip_smoke.py's edge batches (n = 1, 2, 3, trees
    smaller than a lane's thread group, all -inf context trees): bitwise
    equal to the plain version (check_log raises otherwise)."""
    lengths = chip_smoke.LOG_EDGE[N]
    x = chip_smoke.log_inputs(model, N, len(lengths), seed=5 * N + len(model),
                              device=device, lengths=lengths)
    kernel = x["kernels"][1]
    _abs, _rel, bitwise, _ms = chip_smoke.check_log(x, kernel,
                                                    x["outside_args"])
    assert bitwise


@pytest.mark.parametrize("model", ["contra", "turner"])
@pytest.mark.parametrize("N", sorted(chip_smoke.LOG_EDGE))
def test_log_inside_bitwise_on_edge_batches(device, model, N):
    """K16 / K18 on chip_smoke.py's edge batches (n = 1, 2, 3, spans below
    the window's and the bifurcation trees' group sizes): bitwise equal to
    the plain version on every live cell, the fills in every dead one
    (check_log raises otherwise)."""
    lengths = chip_smoke.LOG_EDGE[N]
    x = chip_smoke.log_inputs(model, N, len(lengths), seed=5 * N + len(model),
                              device=device, lengths=lengths)
    kernel = x["kernels"][0]
    _abs, _rel, bitwise, _ms = chip_smoke.check_log(x, kernel,
                                                    x["inside_args"])
    assert bitwise


@pytest.mark.parametrize("model", ["contra", "turner"])
@pytest.mark.parametrize("N", sorted(chip_smoke.LOG_EDGE))
def test_log_inside_kernel_never_reads_dead_cells(device, model, N):
    """K16 / K18 on the edge batches: NaN in every dead cell of the tables
    they are handed and in their scratch leaves close, ext and one bitwise
    unchanged, the fills in every dead cell (check_log_dead_cells raises
    otherwise)."""
    lengths = chip_smoke.LOG_EDGE[N]
    x = chip_smoke.log_inputs(model, N, len(lengths), seed=5 * N + len(model),
                              device=device, lengths=lengths)
    chip_smoke.check_log_dead_cells(x, which=0)


@pytest.mark.parametrize("model", ["contra", "turner"])
@pytest.mark.parametrize("N", sorted(chip_smoke.LOG_EDGE))
def test_log_outside_kernel_never_reads_dead_cells(device, model, N):
    """K17 / K19 themselves on the edge batches: NaN in every dead cell of
    the tables they are handed and in their scratch leaves bppo bitwise
    unchanged (check_log_dead_cells raises otherwise); the CPU test
    test_torch_long_deadcells.py pins the plain version."""
    lengths = chip_smoke.LOG_EDGE[N]
    x = chip_smoke.log_inputs(model, N, len(lengths), seed=5 * N + len(model),
                              device=device, lengths=lengths)
    chip_smoke.check_log_dead_cells(x)


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_parity_path_launches_its_kernels(device, contra):
    from rna_algos_tpu_torch.ops import pallas_fold as PF
    from rna_algos_tpu_torch.parallel.runner import FoldEngine, kernel_bucket

    model = "contra" if contra else "turner"
    mine = (getattr(PF, f"{model}_inside_log_launches"),
            getattr(PF, f"{model}_outside_log_launches"))
    engine = FoldEngine(uses_contra_model=contra, device=device,
                        numerics="parity")
    seqs = chip_smoke.random_batch(6, 60, 200, seed=7)
    for c in mine:
        c.reset()
    with chip_smoke.counted_plain_log() as n_plain:
        out = engine.fold_batch(seqs)
    buckets = {kernel_bucket(len(s), contra, "parity") for s in seqs}
    assert all(c.count == len(buckets) for c in mine)   # no retry loop
    assert n_plain[0] == 0
    assert all(bpp.shape == (len(s), len(s)) and np.isfinite(bpp).all()
               for (bpp, _), s in zip(out, seqs))


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("model", ["contra", "turner"])
def test_scan_kernels_match_plain(device, model, mode):
    """K20/K21 (the generic-N scan) against their plain versions on the
    edge batch at N = 160: bitwise on the live cells under exact, within
    RTOL_SCAN_FAST under fast; with NaN-poisoned state and dead cells,
    and with the narrowest groups on a small grid (the most leaves a
    thread, lanes in many rounds)."""
    ((N, lengths),) = chip_smoke.SCAN_EDGE.items()
    x = chip_smoke.scan_inputs(model, N, len(lengths), seed=3 * N,
                               device=device, lengths=lengths)
    err, fast_err = {"scan_inside": 0.0, "scan_outside": 0.0}, {}
    chip_smoke.check_scan(x, mode, err, fast_err,
                          chip_smoke.scan_plain(x, mode))
    plain = chip_smoke.scan_plain(x, "exact")
    chip_smoke.check_scan(x, "exact", err, fast_err, plain, poison=True)
    with chip_smoke.narrow_groups(*chip_smoke.SCAN_NARROW):
        chip_smoke.check_scan(x, "exact", err, fast_err, plain)
    assert err == {"scan_inside": 0.0, "scan_outside": 0.0}


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_scan_path_launches_its_kernels(device, contra):
    """Under parity past 256 the engine runs the generic-N scan: K20 and
    K21 one launch a pass, the plain scan never called, the BPPs equal to
    the plain path's."""
    from rna_algos_tpu_torch.ops import fold_scan as FS
    from rna_algos_tpu_torch.parallel.runner import FoldEngine

    engine = FoldEngine(uses_contra_model=contra, device=device,
                        numerics="parity")
    seqs = chip_smoke.random_batch(3, 260, 300, seed=11)
    for c in (FS.inside_launches, FS.outside_launches):
        c.reset()
    with chip_smoke.counted_plain_scan() as n_plain:
        out = engine.fold_batch(seqs)
    assert FS.inside_launches.count == FS.outside_launches.count == 1
    assert n_plain[0] == 0
    with chip_smoke.plain_kernels():
        plain = engine.fold_batch(seqs)
    for (bk, pk), (bp, pp) in zip(out, plain):
        np.testing.assert_array_equal(bk, bp)
        np.testing.assert_array_equal(pk, pp)


@pytest.mark.parametrize("contra", [True, False], ids=["contra", "turner"])
def test_one_device_mesh_is_bitwise_the_engine(device, contra):
    """A mesh of one card runs each bucket as the engine without a mesh
    does: bitwise the same BPPs and presence, the same kernels launched;
    and AlignEngine's probabilities bitwise too."""
    from rna_algos_tpu_torch.constants import PSEUDO_BASE
    from rna_algos_tpu_torch.ops import pallas_align_prob as PAP
    from rna_algos_tpu_torch.parallel.mesh import data_mesh
    from rna_algos_tpu_torch.parallel.runner import AlignEngine, FoldEngine

    mesh = data_mesh(["cuda:0"])
    seqs = chip_smoke.random_batch(12, 60, 200, seed=6)
    want = FoldEngine(uses_contra_model=contra, device=device).fold_batch(seqs)
    got = FoldEngine(uses_contra_model=contra, mesh=mesh).fold_batch(seqs)
    for (wb, wp), (gb, gp) in zip(want, got):
        assert wb.tobytes() == gb.tobytes() and (wp == gp).all()
    wrapped = [np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]])
               for s in seqs[:6]]
    pairs = [(a, b) for a in range(6) for b in range(a + 1, 6)]
    PAP.prob_launches.reset()
    got = AlignEngine(mesh=mesh).match_probs_pairs(wrapped, pairs)
    assert PAP.prob_launches.count >= 2
    want = AlignEngine(device=device).match_probs_pairs(wrapped, pairs)
    assert list(got) == list(want)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)


def test_phase_timer_times_a_cuda_phase_with_events(device):
    from rna_algos_tpu_torch.utils.trace import PhaseTimer, force, force_last

    t = PhaseTimer()
    x = torch.ones(2048, 2048, device=device)
    with t.phase("matmul", items=4, device=device):
        for _ in range(4):
            x = x @ x / 2048.0
    s = t.summary()["matmul"]
    assert s["calls"] == 1 and s["seconds"] > 0
    assert force({"a": x, "b": [x[:0], torch.ones(1)]}) == 2
    assert force_last([x, None]) == 1
