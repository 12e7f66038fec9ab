"""K23's schedule (``csrc/mea_fill.cu``) replayed in integer numpy: which
thread of a fill takes which bifurcation term (i, d, t), t in [1, d - 1], of
which cell, in bands of K spans, over the threads of one block (the shared
form) or of a cluster of C blocks (the cluster form, where each block also
steps a halo of the lanes above its own).

* Term level, at every N from 2 to 49 and a few past it, in both forms at
  several block widths and cluster sizes: the owner of every live cell
  takes each of its terms exactly once and no other term; each operand is
  read at the address the kernel computes (the triangle by diagonal, a
  band's incremental column offsets) and is final when it is read (its
  span below the band in the bulk, below the span in a step); the owner
  writes every live cell exactly once (a halo writes the same cell again,
  with the same bits), a block steps a cell only after stepping every
  band cell that step reads, and a band's partial maxes go only to its
  live cells.
* Every N from 2 to 2,048, in each form: at every span the step's late
  terms fit the kernel's 2 (K - 1) slots and, with the band's bulk range,
  partition [1, d - 1]; a band's units cover every (lane, part) once and
  its parts' runs of t partition [1, d0 - 1]; every live cell of every
  span has a thread.
* Knock-outs: a replay that leaves out one late slot, takes the masked
  bulk terms one t late, narrows a halo by a lane or keeps it as wide at
  every span fails.
"""

import numpy as np
import pytest

# RNA_MEA_K, RNA_MEA_CLUSTER_T and RNA_MEA_MAX_C of csrc/mea_fill.cu
K = 8
CLUSTER_T = 512
MAX_C = 16


def diag(s, N):
    """mea_diag: offset of diagonal s of the triangle."""
    return s * N - (s * (s - 1)) // 2


def decode(addr, N):
    """(s, x) of triangle offsets: D[s][x] lives at diag(s) + x."""
    starts = diag(np.arange(N + 1), N)
    s = np.searchsorted(starts, addr, side="right") - 1
    return s, addr - starts[s]


def shared_threads(N):
    """rna_mea_fill_plan's block width of the shared form."""
    return min(1024, max(128, (N + 31) // 32 * 32))


def late_counts(d):
    """mea_cell's late slots of span(s) d: (d0, nlo, nhi), the lower slots
    t = 1 + k for k < nlo, the upper t = d0 + k for k < nhi (k < K - 1)."""
    d0 = d & ~(K - 1)
    nlo = np.where(d0 > 0, d - d0 - 1, d - 1)
    nhi = np.where(d0 > 0, d - d0, 0)
    return d0, nlo, nhi


def bulk_units(N, d0, nthr):
    """mea_bulk's deal of band d0 over nthr threads: (lp, g, the unit ids
    thread q takes, q = 0 .. nthr - 1 in turn: q, q + nthr, ...)."""
    nl = N - d0
    lp = (nl + 31) & ~31
    g = nthr // lp if nthr // lp > 1 else 1
    return lp, g, strided(lp * g, nthr)


def strided(n, nthr):
    """The items of range(n) thread q takes in ``for (x = q; x < n; x +=
    nthr)``, thread by thread."""
    grid = np.arange(nthr)[:, None] + nthr * np.arange(-(-n // nthr))[None, :]
    return grid[grid < n]


def step_cells(N, form, T, C, d, narrow=0, shrink=True):
    """The cells (lanes) of span d each block of the fill computes, as
    mea_fill_kernel deals them: [(block, lanes, owned)], ``owned`` marking
    the lanes the block owns.  The shared form, and one block a fill: lane
    q a thread (or q, q + nthr, ... with fewer threads than lanes).  A
    cluster of C > 1 blocks: block r owns the W = T - (K - 1) lanes from r
    W and steps the K - 1 - (d - d0) lanes above them too (its halo), while
    a thread a lane holds; else lanes q, q + nthr, ... again.  Knock-outs:
    ``narrow`` lanes fewer in each halo; ``shrink`` False keeps the halo
    as wide at every span of the band."""
    nthr = T * C
    H = K - 1 if form == "cluster" and C > 1 else 0
    W = T - H
    if C * W < N or H == 0:
        if nthr >= N:
            lanes = np.arange(min(nthr, N - d))
        else:
            lanes = strided(N - d, nthr)
        return [(0, lanes, np.ones(len(lanes), bool))]
    m = d - (d & ~(K - 1))
    out = []
    for r in range(C):
        lanes = r * W + np.arange(T)
        top = r * W + W + H - narrow - (m if shrink else 0)
        lanes = lanes[(lanes < N - d) & (lanes < top)]
        out.append((r, lanes, lanes < r * W + W))
    return out


def deps(d):
    """The band cells cell (x, x + d)'s step reads besides the bulk's
    partial, as (lane - x, span): c1, c2, m_in and the late terms' row and
    column operands, those at spans >= max(d0, 1) (the band's own)."""
    d0 = d & ~(K - 1)
    _, nlo, nhi = late_counts(np.array([d]))
    dys, es = [1, 0, 1], [d - 1, d - 1, d - 2]
    for k in range(int(nlo[0])):      # t = 1 + k
        dys += [0, k + 2]
        es += [1 + k, d - 2 - k]
    for k in range(int(nhi[0])):      # t = d0 + k
        dys += [0, d0 + k + 1]
        es += [d0 + k, d - 1 - d0 - k]
    dy, e = np.array(dys), np.array(es)
    keep = e >= max(d0, 1)
    return dy[keep], e[keep]


def replay(N, form, T, C=1, knock=None):
    """Every term a fill's threads take, every cell they write and every
    partial they fold, as the kernel deals them.  Returns (cnt, writes,
    halo, folds): cnt[i, d, t] the times the owner of cell (i, i + d)
    takes its term t, writes[i, d] the owner's writes of the cell,
    halo[i, d] the other blocks' writes of it (a cluster's halos: the same
    bits), folds the (i, d) of each atomicMax.  Raises if an operand is
    read at another address than its own or before it is final, or if a
    block steps a cell before it has stepped every band cell the step
    reads.  ``knock``: ("lo" | "hi", k) leaves out that late slot,
    ("late-mask",) takes the masked bulk terms at t > k, ("halo",) makes
    each halo a lane narrower, ("flat",) keeps it as wide at every span."""
    nthr = T * C
    if form == "shared":
        assert C == 1
    cnt = np.zeros((N, N, N), np.int16)
    folds = []
    for d0 in range(K, N, K):
        folds += bulk_band(N, d0, nthr, cnt, knock)
    writes = np.zeros((N, N), np.int16)
    halo = np.zeros((N, N), np.int16)
    have = {}        # block -> cells of the band it has stepped
    rows = []
    for d in range(1, N):
        if d % K == 0 or d == 1:
            have = {}
        blocks = step_cells(N, form, T, C, d, narrow=knock == ("halo",),
                            shrink=knock != ("flat",))
        dy, e = deps(d)
        for r, lanes, owned in blocks:
            mine = have.setdefault(r, np.zeros((2 * N, N), bool))
            if len(blocks) > 1 and len(lanes) and len(dy):
                # only the block's barrier parts steps of a band
                assert mine[lanes[:, None] + dy, e].all(), (N, T, C, r, d)
            mine[lanes, d] = True
            np.add.at(writes, (lanes[owned], d), 1)
            np.add.at(halo, (lanes[~owned], d), 1)
            rows.append((np.full(owned.sum(), d), lanes[owned]))
    d = np.concatenate([r[0] for r in rows])
    i = np.concatenate([r[1] for r in rows])
    d0, nlo, nhi = late_counts(d)
    for k in range(K - 1):
        for part, live in (("lo", k < nlo), ("hi", k < nhi)):
            if knock == (part, k):
                continue
            di, ii, d0i = d[live], i[live], d0[live]
            if part == "lo":
                t = np.full_like(di, 1 + k)
                row = diag(1 + k, N) + ii
                col = diag(di - 2 - k, N) + ii + k + 2
            else:
                t = d0i + k
                row = diag(d0i + k, N) + ii
                col = diag(di - 1 - d0i - k, N) + ii + d0i + k + 1
            check_operands(N, ii, di, t, row, col, limit=di)
            np.add.at(cnt, (ii, di, t), 1)
    return cnt, writes, halo, folds


def bulk_band(N, d0, nthr, cnt, knock=None):
    """mea_bulk and mea_bulk_terms of band d0 into ``cnt``; the (i, d) of
    the atomicMax folds."""
    lp, g, units = bulk_units(N, d0, nthr)
    u, i = units // lp, units % lp
    keep = i < N - d0
    u, i = u[keep], i[keep]
    kmax = np.minimum(K, N - d0 - i)
    L = (d0 - 2 + g) // g                                # a part's run
    t0 = 1 + u * L
    t = t0[:, None] + np.arange(L)[None, :]              # (units, steps)
    t = np.where(t < np.minimum(t0 + L, d0)[:, None], t, d0)   # d0: none
    s = d0 - 1 - t
    o = diag(s, N) + i[:, None] + t + 1
    row = diag(t, N) + i[:, None]
    for k in range(K):
        masked = t < K
        take = (t < d0) & (k < kmax[:, None])
        if knock == ("late-mask",):
            take &= ~masked | (t > k)
        else:
            take &= ~masked | (t >= k)
        ii = np.broadcast_to(i[:, None], t.shape)[take]
        check_operands(N, ii, d0 + k, t[take], row[take], o[take],
                       limit=d0)
        np.add.at(cnt, (ii, np.full_like(ii, d0 + k), t[take]), 1)
        o = o + N - s - k                                # diagonal s+k -> +1
    live = np.arange(K)[None, :] < kmax[:, None]
    kk = np.broadcast_to(np.arange(K), live.shape)
    return [(np.broadcast_to(i[:, None], live.shape)[live], d0 + kk[live])]


def check_operands(N, i, d, t, row, col, limit):
    """The row operand of term t of cell (i, i + d) is M(i, i + t) =
    D[t][i], its column operand M(i + t + 1, i + d) = D[d - 1 - t][i + t +
    1], both in the triangle, both of spans below ``limit``."""
    if np.size(i) == 0:
        return
    rs, rx = decode(row, N)
    cs, cx = decode(col, N)
    assert (rs == t).all() and (rx == i).all()
    assert (cs == d - 1 - t).all() and (cx == i + t + 1).all()
    assert (rx < N - rs).all() and (cx < N - cs).all()
    assert (rs < limit).all() and (cs < limit).all()


def expected(N):
    """want[i, d, t]: term t of cell (i, i + d) is a term of a live cell."""
    i, d, t = np.ogrid[:N, :N, :N]
    return ((i + d < N) & (t >= 1) & (t <= d - 1)).astype(np.int16)


def check_replay(N, form, T, C=1, knock=None):
    cnt, writes, halo, folds = replay(N, form, T, C, knock)
    assert np.array_equal(cnt, expected(N)), (N, form, T, C)
    i, d = np.ogrid[:N, :N]
    live = ((i + d < N) & (d >= 1)).astype(np.int16)
    assert np.array_equal(writes, live)
    assert (halo <= live).all()
    for fi, fd in folds:
        assert (fi + fd < N).all() and (fd >= K).all()


# (form, T, C) as the kernel may be launched: the plan's shared widths
# and narrower / wider ones, the cluster form's blocks and cluster sizes
CONFIGS = ([("shared", None, 1), ("shared", 1024, 1)]
           + [("cluster", t, c) for t, c in ((32, 1), (32, 4), (64, 16),
                                              (CLUSTER_T, 2))])


def launch(form, T, C, N):
    return form, (shared_threads(N) if T is None else T), C


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_k23_terms_each_taken_once(config):
    """Every N from 2 to 49, 63-65, and 97 and 130 at the plan's shared
    widths, term level: each term of each live cell once, the
    operands at their addresses and final, each live cell written once."""
    form = config[0]
    Ns = list(range(2, 50)) + [63, 64, 65] + ([97, 130] if config[1] is None
                                             else [])
    for N in Ns:
        check_replay(N, *launch(*config, N))


def test_k23_deal_at_every_n():
    """Every N from 2 to 2,048, both forms (the shared form up to N = 332,
    the plan's widths; the cluster form at every cluster size): the late
    slots and the bulk range partition [1, d - 1] at every span, a band's
    units cover each (lane, part) once and its parts' t's [1, d0 - 1],
    every live cell of a span has a thread."""
    for N in range(2, 2049):
        d = np.arange(1, N)
        d0, nlo, nhi = late_counts(d)
        assert (nlo <= K - 1).all() and (nhi <= K - 1).all()
        lo_n = np.maximum(nlo, 0)
        # bulk: t in [max(1, d - d0), d0 - 1] past the first band
        b_lo = np.maximum(1, d - d0)
        b_n = np.where(d0 > 0, d0 - b_lo, 0)
        assert ((lo_n + b_n + nhi) == d - 1).all()
        first = d0 > 0
        assert (lo_n[first] == b_lo[first] - 1).all()    # lo ends below
        widths = [CLUSTER_T * c for c in (1, 2, 4, 8, MAX_C)]
        if (N * (N + 1) // 2 + K * N) * 4 <= 232448:
            assert shared_threads(N) >= N      # a thread a lane
            widths.append(shared_threads(N))
        d0 = np.arange(K, N, K)
        if not d0.size:
            continue
        nl = N - d0
        lp = (nl + 31) & ~31
        for nthr in widths:
            g = np.where(nthr // lp > 1, nthr // lp, 1)
            # whole warps a part (a warp's lanes vote on its fast path in
            # lockstep), every (lane, part) a unit, a thread at most one
            # unit where the threads outnumber the lanes
            assert nthr % 32 == 0
            assert (lp % 32 == 0).all() and (lp >= nl).all()
            assert (g >= 1).all() and (lp * g <= np.maximum(nthr, lp)).all()
    # part u of g takes the run [1 + u L, 1 + (u + 1) L), L = ceil((d0 -
    # 1) / g): for every band start d0 and every g a band can have (1 ..
    # 8,192 / 32) the runs partition [1, d0 - 1]
    d0 = np.arange(K, 2048, K, dtype=np.int32)[:, None, None]
    g = np.arange(1, 257, dtype=np.int32)[None, :, None]
    u = np.arange(256, dtype=np.int32)[None, None, :]
    L = (d0 - 2 + g) // g
    lo = 1 + u * L
    hi = np.minimum(lo + L, d0)
    runs = np.where(u < g, np.maximum(0, hi - lo), 0)
    assert (runs.sum(axis=2) == d0[:, :, 0] - 1).all()


@pytest.mark.parametrize("knock", [("lo", 0), ("hi", 0), ("hi", 3),
                                   ("late-mask",)],
                         ids=["lo-slot", "hi-slot-0", "hi-slot-3",
                              "late-mask"])
def test_k23_replay_catches_a_lost_term(knock):
    """The replay is not vacuous: a slot left out, or the masked bulk
    taking t > k where the kernel takes t >= k, loses a term of some cell
    (the last upper slot, t = d - 1, is M(i, j - 1) + M(j, j) = c2 and
    would not show in the fill's bits: here it does)."""
    with pytest.raises(AssertionError):
        for N in (12, 20, 40):
            check_replay(N, "shared", 128, knock=knock)


def test_k23_halo_is_no_narrower_than_it_must_be():
    """A cluster's halos one lane narrower than the kernel's (K - 2 lanes
    at a band's first span) leave a block's top owned lane unstepped at a
    band's last span: the replay fails."""
    check_replay(64, "cluster", 32, 4)
    with pytest.raises(AssertionError):
        check_replay(64, "cluster", 32, 4, knock=("halo",))


def test_k23_halo_narrows_a_lane_a_span():
    """A halo as wide at a band's every span as at its first steps cells
    whose band cells no step of the block gave: the replay fails on the
    dependency check."""
    with pytest.raises(AssertionError, match=r"\(64, 32, 4, 0, "):
        check_replay(64, "cluster", 32, 4, knock=("flat",))
