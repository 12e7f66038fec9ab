"""The schedule of K14 and K15 (``csrc/pairhmm.cu``), the Durbin pair-HMM
wavefronts: a plain-torch replica of the kernels' schedule against the
port's plain wavefront ``pallas_align._pairhmm_plain``, bitwise.

A kernel runs one block a pair, thread i on row i, warp k on rows
L k .. L k + L - 1 (L = 32 lanes).  After the set-up only the warps with
live rows (i <= n1 - 2) go on, and they step the diagonals d = 0 ..
n1 + n2 - 4 together, one barrier over them a diagonal.  Warp k computes
only the diagonals on which it has live cells, d = L k .. de_k (row L k at
j = 0 to its last row at j = n2 - 2).  A lane takes row i - 1's states at
d - 1 from a double-buffered shared row (buffer (d - 1) mod 2, slot i;
slot 0 is row -1) and keeps those at d - 2 from the step before; it writes
its own states of diagonal d into buffer d mod 2, slot i + 1.  The rows a
warp has not reached yet, and row -1, read zero.  The replica steps the
live warps of a diagonal one after the other in the order of k, so a warp
that wrote into the buffer its neighbour still reads would show.

Each warp keeps its last W diagonals in a tile and writes a window out row
by row (``flush_cells``: row i = L k + l holds cell (i, d0 + w - i) at w,
backward (n1-2-i, n2-2-j)), the last partial window at de_k.  Before the
walk each warp writes the semiring's zero into the cells of its plane rows
outside [0, n1-2] x [0, n2-2] (``outside_cells``: whole rows past n1-2, the
tail of the others, scalar stores up to the first column aligned to 4, then
4-float stores).  The planes start NaN, as the kernels' outputs do.

The replica runs at N = 32 and 64 on ragged pairs (n = 2-3, n1 != n2,
n = N), with 32 lanes a warp and with 8 (more warp boundaries at these
sizes; W is then 8); its planes and corners equal the plain version's bit
for bit, for both semirings and both passes.  A replica whose row exchange
is one diagonal short (a single buffer, so a warp reads its neighbour's
row of this diagonal instead of the last), or that skips the last partial
flush, fails.  For every (n1, n2) in 2..N at N = 32 and 64, the flush map
and the outside writes cover each of the N^2 cells exactly once.  Torch on
one thread."""

import numpy as np
import pytest
import torch

from rna_algos_tpu_torch.constants import PSEUDO_BASE
from rna_algos_tpu_torch.ops import pallas_align as PA

LANES = 32        # a warp, and RNA_PH_W: diagonals a window
LENGTHS = {32: ((3, 3), (32, 32), (3, 32), (32, 3), (17, 9), (2, 5)),
           64: ((64, 64), (3, 64), (64, 3), (40, 20), (20, 40), (33, 34))}
SEMIRINGS = {"prob": PA.ProbSemiring, "log": PA.LogSemiring}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def live_rows(n1, k, lanes=LANES):
    """Rows i <= n1 - 2 of warp k."""
    return min(lanes, n1 - 1 - lanes * k)


def last_diagonal(n1, n2, k, lanes=LANES):
    """de_k: row L k at j = 0 is the first live diagonal, the warp's last
    live row at j = n2 - 2 the last."""
    return lanes * k + live_rows(n1, k, lanes) - 1 + n2 - 2


def outside_cells(n1, n2, N, k, lanes=LANES):
    """Flat cells rna_ph_outside writes for warp k's plane rows."""
    cells = []
    for r in range(lanes * k, min(lanes * k + lanes, N)):
        c0 = max(n2 - 1, 0) if r <= n1 - 2 else 0
        a = min((c0 + 3) & ~3, N) if N % 4 == 0 else N
        cells.append(r * N + np.arange(c0, a))
        cells.append(r * N + np.arange(a, N))      # 4-float stores
    return np.concatenate(cells) if cells else np.zeros(0, np.int64)


def flush_cells(n1, n2, N, k, d0, cnt, backward, lanes=LANES):
    """rna_ph_flush of warp k's window of ``cnt`` diagonals from d0:
    (row l in the warp, w, flat cell) of each live cell."""
    rows = live_rows(n1, k, lanes)
    ll, ww = np.meshgrid(np.arange(max(rows, 0)), np.arange(cnt),
                         indexing="ij")
    i = lanes * k + ll
    j = d0 + ww - i
    keep = (j >= 0) & (j <= n2 - 2)
    if backward:
        cell = (n1 - 2 - i) * N + (n2 - 2 - j)
    else:
        cell = i * N + j
    return ll[keep], ww[keep], cell[keep]


def windows(n1, n2, k, lanes=LANES):
    """Warp k's windows (d0, cnt): W = L diagonals each from L k, the last
    one ending at de_k."""
    ds, de = lanes * k, last_diagonal(n1, n2, k, lanes)
    return [(d0, min(lanes, de + 1 - d0)) for d0 in range(ds, de + 1, lanes)]


def warp_live(n1, n2, k, lanes=LANES):
    return live_rows(n1, k, lanes) > 0 and n2 >= 2


def replica_pair(x1, x2, n1, n2, ms, ins, scal, backward, sr, lanes=LANES,
                 buffers=2, skip_last_flush=False):
    """One pair through the kernel's schedule: (plane (N, N), corner (3,)).
    ``buffers``: the shared rows the exchange alternates between."""
    N = x1.shape[0]
    nw = -(-N // lanes)
    m2m, m2i, ext, init_m, init_i = scal.unbind()
    zero = torch.tensor(sr.zero)
    one = torch.tensor(sr.one)
    s1 = PA._pass_seqs(x1[None], torch.tensor([n1]), backward)[0]
    s2 = PA._pass_seqs(x2[None], torch.tensor([n2]), backward)[0]
    b1 = torch.full((nw * lanes,), PSEUDO_BASE, dtype=torch.long)
    b1[:N] = s1
    em = ms.reshape(-1)[b1[:, None] * PA.NB + torch.arange(PA.NB)]  # (rows, 5)
    ins1 = ins[b1]
    plane = torch.full((N * N,), float("nan"))
    corner = torch.full((3,), sr.zero)
    for k in range(nw):
        plane[outside_cells(n1, n2, N, k, lanes)] = sr.zero
    # [buffer][M, I, D][1 + row]; slot 0 is row -1
    rows = torch.full((buffers, 3, nw * lanes + 1), sr.zero)
    lane = torch.arange(lanes)

    def step(k, d, nb1, nb2, own):
        """All lanes of warp k on diagonal d: (own states, tile column)."""
        ii = lanes * k + lane
        j = d - ii
        valid = (ii < n1 - 1) & (j >= 0) & (j < n2 - 1)
        b2 = s2[j.clamp(0, N - 1)]
        nm1, ni1, nd1 = nb1
        nm2, ni2, nd2 = nb2
        own_m, _, own_d = own
        tmm = torch.where((ii == 1) & (j == 1), init_m, m2m)
        fm = torch.where(valid & (ii >= 1) & (j >= 1),
                         sr.emit(sr.match(nm2, tmm, ni2, nd2, m2i),
                                 em[ii, b2]), zero)
        fm = torch.where(valid & (ii == 0) & (j == 0), one, fm)
        tmi = torch.where((ii == 1) & (j == 0), init_i, m2i)
        fi = torch.where(valid & (ii >= 1),
                         sr.emit(sr.pair(nm1, tmi, ni1, ext), ins1[ii]), zero)
        td = torch.where((ii == 0) & (j == 1), init_i, m2i)
        fd = torch.where(valid & (j >= 1),
                         sr.emit(sr.pair(own_m, td, own_d, ext), ins[b2]),
                         zero)
        if backward:
            tend = torch.where((ii == 0) & (j == 0), one, m2m)
            cell = torch.where(valid, sr.ss(fm, tend, fi, fd, m2i), zero)
        else:
            cell = fm
        hit = valid & (ii == n1 - 2) & (j == n2 - 2)
        if bool(hit.any()):
            corner[:] = torch.stack([fm[hit][0], fi[hit][0], fd[hit][0]])
        return torch.stack([fm, fi, fd]), cell

    warps = [k for k in range(nw) if warp_live(n1, n2, k, lanes)]
    state = {k: dict(own=torch.full((3, lanes), sr.zero),
                     nb1=torch.full((3, lanes), sr.zero),
                     tile=torch.full((lanes, lanes), float("nan")),
                     wins=iter(windows(n1, n2, k, lanes)), w=0)
             for k in warps}
    for st in state.values():
        st["d0"], st["cnt"] = next(st["wins"])
    for d in range(n1 + n2 - 3):
        for k in warps:           # between two barriers, in the order of k
            st = state[k]
            if not lanes * k <= d <= last_diagonal(n1, n2, k, lanes):
                continue
            nb2 = st["nb1"]
            st["nb1"] = rows[(d - 1) % buffers, :,
                             lanes * k:lanes * k + lanes].clone()
            st["own"], cell = step(k, d, st["nb1"], nb2, st["own"])
            rows[d % buffers, :, lanes * k + 1:lanes * k + lanes + 1] = \
                st["own"]
            st["tile"][:, st["w"]] = cell
            st["w"] += 1
            if st["w"] == st["cnt"]:
                if st["cnt"] == lanes or not skip_last_flush:
                    ll, ww, cells = flush_cells(n1, n2, N, k, st["d0"],
                                                st["cnt"], backward, lanes)
                    plane[cells] = st["tile"][ll, ww]
                st["w"] = 0
                st["d0"], st["cnt"] = next(st["wins"], (None, None))
    return plane.reshape(N, N), corner


def batch(N, lengths, seed, sr):
    """Sentinel-wrapped random pairs of the given wrapped lengths and
    random tables (log tables for the log semiring)."""
    rng = np.random.default_rng(seed)
    P = len(lengths)
    x1 = np.full((P, N), PSEUDO_BASE, np.int32)
    x2 = np.full((P, N), PSEUDO_BASE, np.int32)
    for p, (a, b) in enumerate(lengths):
        x1[p, 1:max(a - 1, 1)] = rng.integers(0, 4, max(a - 2, 0))
        x2[p, 1:max(b - 1, 1)] = rng.integers(0, 4, max(b - 2, 0))
    n1 = np.array([a for a, _ in lengths], np.int32)
    n2 = np.array([b for _, b in lengths], np.int32)
    ms = rng.uniform(0.3, 1.6, (P, PA.NB, PA.NB)).astype(np.float32)
    ins = rng.uniform(0.3, 1.2, (P, PA.NB)).astype(np.float32)
    scal = rng.uniform(0.2, 0.9, 5).astype(np.float32)
    if sr is PA.LogSemiring:
        ms, ins, scal = np.log(ms), np.log(ins), np.log(scal)
    return [torch.as_tensor(v) for v in (x1, x2, n1, n2, ms, ins, scal)]


def replica(args, backward, sr, **kw):
    x1, x2, n1, n2, ms, ins, scal = args
    outs = [replica_pair(x1[p], x2[p], int(n1[p]), int(n2[p]), ms[p], ins[p],
                         scal, backward, sr, **kw)
            for p in range(x1.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def bitwise(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


@pytest.mark.parametrize("lanes", [32, 8], ids=["L32", "L8"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("semiring", sorted(SEMIRINGS))
@pytest.mark.parametrize("N", sorted(LENGTHS), ids=lambda N: f"N{N}")
def test_replica_is_bitwise_the_plain_wavefront(N, semiring, backward, lanes):
    sr = SEMIRINGS[semiring]
    args = batch(N, LENGTHS[N], seed=N + len(semiring), sr=sr)
    want = PA._pairhmm_plain(*args, backward, sr)
    assert bitwise(replica(args, backward, sr, lanes=lanes), want)


@pytest.mark.parametrize("mutation", ["exchange_one_short", "no_last_flush"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_broken_replicas_fail(mutation, backward):
    """The check catches a row exchange one diagonal short (one buffer, so
    a warp reads its neighbour's row of this diagonal) and a skipped last
    partial flush."""
    sr = PA.ProbSemiring
    args = batch(32, LENGTHS[32], seed=5, sr=sr)
    want = PA._pairhmm_plain(*args, backward, sr)
    kw = ({"buffers": 1} if mutation == "exchange_one_short"
          else {"skip_last_flush": True})
    assert not bitwise(replica(args, backward, sr, lanes=8, **kw), want)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("N", [32, 64], ids=lambda N: f"N{N}")
def test_flush_map_and_outside_writes_cover_every_cell_once(N, backward):
    nw = N // LANES
    for n1 in range(2, N + 1):
        for n2 in range(2, N + 1):
            cells = [outside_cells(n1, n2, N, k) for k in range(nw)]
            for k in range(nw):
                if warp_live(n1, n2, k):
                    cells += [flush_cells(n1, n2, N, k, d0, cnt, backward)[2]
                              for d0, cnt in windows(n1, n2, k)]
            hits = np.bincount(np.concatenate(cells), minlength=N * N)
            assert hits.shape == (N * N,) and (hits == 1).all(), (n1, n2)
