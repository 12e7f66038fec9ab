"""The summation order of K1 and K2 (``csrc/narrow.cuh``), the CONTRA
probability wavefronts at N <= 256: a plain-torch replica of the kernels'
split sums, float32, against the port's plain versions
``contra_inside_plain`` and ``contra_outside_plain``.

A kernel runs one block of T = 256, 512 or 1,024 threads a sequence
(``rna_nw_threads``) and computes the live lanes of a span only (i + d < n),
m = n - d of them.  Each live lane's O(d) sums split into k = T / m32 parts
(m32: m rounded up to whole warps): part p takes the lane's terms p, p + k,
p + 2k, ... (inside the bifurcation terms t = 1 + p + k j, t < d; outside
the multibranch terms u = p + k j), and the lane's owner adds the parts in
order p = 0 .. k - 1 (inside after the term t = 0, its own rm).  The 2-loop
window is computed only where the cell can close (inside: d >= 4 and JS !=
0; outside: CLOSE a positive normal float and the span reaching min_span),
by a group of GW threads, the largest power of two <= 32 with K GW <= T for
the span's K such cells: its 31 rows a = 0..30 are dealt to the group's
threads in a snake (row q GW + g on even rounds q, q GW + GW - 1 - g on odd
ones) and the threads' partial sums meet in a halving tree.  Elsewhere the
window is 0, which changes nothing: every term it would have fed is 0 there.

The replica follows that partition span by span on a ragged batch at N = 32
and 64, for every T the launch rule can choose there (so every part count k
and group size GW those shapes produce), with the kernels' tolerances
(``chip_smoke.RTOL_INSIDE`` on close, ext and one, ``chip_smoke.ATOL_BPPO``
on bppo), on live cells.  A replica that drops one term from every lane's
sums must fail them.  Torch on one thread."""

import pytest
import torch

from rna_algos_tpu_torch.ops import pallas_fold_prob as PP
from rna_algos_tpu_torch.ops import pallas_fold_prob8 as P8

import chip_smoke

W = 32                # RNA_WIN: the banded window matrix is W x W
ROWS = W - 1          # its rows a = 0..30
THREADS = (256, 512, 1024)
LENGTHS = {32: (32, 19, 7, 3), 64: (64, 33, 17, 5)}
MIN_SPAN = 5          # the main path's min_span


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(LENGTHS), ids=lambda N: f"N{N}")
def inputs(request):
    N = request.param
    return chip_smoke.kernel_inputs(N, len(LENGTHS[N]), seed=31 + N,
                                    device="cpu", lengths=LENGTHS[N])


def group_size(K, T):
    """rna_nw_group: threads a closable cell's window gets."""
    g = 32
    while g > 1 and K * g > T:
        g //= 2
    return g


def parts(m, T):
    """rna_nw_part: the parts k of each of m live lanes' sums."""
    m32 = (m + 31) // 32 * 32
    return T // m32


def snake_rows(GW):
    """(GW, ROWS) one-hot: the rows a dealt to thread g of a group."""
    owner = torch.zeros((GW, ROWS))
    q = 0
    while q * GW < ROWS:
        for g in range(GW):
            a = q * GW + (GW - 1 - g if q & 1 else g)
            if a < ROWS:
                owner[g, a] = 1.0
        q += 1
    assert torch.equal(owner.sum(0), torch.ones(ROWS))
    return owner


def halve(x):
    """The halving tree over the last dim (a power of two): x[g] + x[g + h],
    h = GW/2 .. 1 (__shfl_xor_sync)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def split_window(prod, GW, drop):
    """The window of K cells from their terms prod (K, ROWS, W) (0 where
    r <= a): per-thread partials over the snake's rows, then the tree."""
    if drop == "window":
        # the largest term of every cell left out
        flat = prod.reshape(prod.shape[0], -1)
        flat = flat.scatter(1, flat.abs().argmax(1, keepdim=True), 0.0)
        prod = flat.view_as(prod)
    partial = torch.einsum("kar,ga->kg", prod, snake_rows(GW))
    return halve(partial)


def split_parts(terms, first, k, drop):
    """Lanes' sums over their terms (lanes, L) in k parts: term e (index
    first + e) goes to part (first + e) % k when ``first`` is the first
    part's first term; the parts are added in order p = 0 .. k - 1."""
    if drop == "parts" and terms.shape[1]:
        terms = terms.scatter(1, terms.abs().argmax(1, keepdim=True), 0.0)
    L = terms.shape[1]
    part = (torch.arange(L) + first) % k
    sums = torch.zeros((terms.shape[0], k))
    sums.index_add_(1, part, terms)
    out = torch.zeros(terms.shape[0])
    for p in range(k):
        out = out + sums[:, p]
    return out


def inside_replica(mi, KW, scal, ns, T, drop=None, seen=None):
    """K1's sums, one sequence at a time: (close, ext, one) (B, N, N)."""
    B, N, _ = mi["H"].shape
    out = [torch.zeros((B, N, N)) for _ in range(3)]
    a = torch.arange(ROWS)[:, None]
    r = torch.arange(W)[None, :]
    band = r > a
    for b in range(B):
        n = int(ns[b])
        H, MBC, ACC, JS, STK, I11, B0R, B0L, JB = (
            mi[k][b] for k in P8.INSIDE_TABLES)
        eu1, ebp, mbu1, mbbp = (float(v) for v in scal[b])
        kw = KW[b, :ROWS]
        ring = torch.zeros((N + 32, N + 33))    # span s at row s + 32
        close, ext, one = (o[b] for o in out)
        rmh, rmmh = torch.zeros((N, N)), torch.zeros((N, N))
        s2r = torch.zeros((N, N + 1))
        s1 = torch.zeros(N + 1)
        rm, rmm = torch.zeros(N), torch.zeros(N)
        epow = 1.0
        for d in range(n):
            m = n - d
            i = torch.arange(m)
            win = torch.zeros(m)
            cells = torch.nonzero((JS[d, :m] != 0) & (d >= 4))[:, 0]
            if len(cells):
                GW = group_size(len(cells), T)
                x = ring[d + 31 - r, cells[:, None, None] + 1 + a]
                prod = torch.where(band, kw * x, torch.zeros(()))
                win[cells] = split_window(prod, GW, drop)
                if seen is not None:
                    seen["GW"].add(GW)
            row = lambda age, off: ring[d + 31 - age, off:off + m]
            two = JS[d, :m] * win
            two = two + STK[d, :m] * row(1, 1)
            two = two + B0R[d, :m] * row(2, 1)
            two = two + B0L[d, :m] * row(2, 2)
            two = two + I11[d, :m] * row(3, 2)
            mb = s2r[d - 2, 1:m + 1] * MBC[d, :m] if d >= 2 else 0.0
            c = H[d, :m] + two + mb
            if d + 1 < MIN_SPAN:
                c = torch.zeros(m)
            close[d, :m] = c
            ca = c * ACC[d, :m]
            rm[:m] = rm[:m] * eu1 + ca * ebp
            rmm[:m] = rmm[:m] * mbu1 + ca * mbbp
            epow = epow * eu1
            rmh[d, :m], rmmh[d, :m] = rm[:m], rmm[:m]
            ring[d + 32, :m] = c * JB[d, :m]
            k = parts(m, T)
            if seen is not None:
                seen["k"].add(k)
            t = torch.arange(1, max(d, 1))
            es_t = rmh[d - t[None, :], i[:, None] + t] * ext[t - 1][:, :m].T
            s2_t = one[t - 1][:, :m].T * rmmh[d - t[None, :], i[:, None] + t]
            # part p takes t = 1 + p + k j: term index e = t - 1 from part 0
            es = rm[:m] + split_parts(es_t, 0, k, drop)
            s2 = split_parts(s2_t, 0, k, None)
            nb = rmmh[d - 1, 1:m + 1] if d >= 1 else torch.zeros(m)
            s1v = mbu1 * (nb + s1[1:m + 1])
            s1 = torch.zeros(N + 1)
            s1[:m] = s1v
            s2r[d, :m] = s2
            ext[d, :m] = epow + es
            one[d, :m] = rmm[:m] + s1v + s2
    return tuple(out)


def outside_replica(mo, one, QONE, extR, b0lo, KW, scal, ns, min_span, T,
                    drop=None, seen=None):
    """K2's sums, one sequence at a time: bppo (B, N, N)."""
    B, N, _ = one.shape
    bppo = torch.zeros((B, N, N))
    a = torch.arange(ROWS)[:, None]
    r = torch.arange(W)[None, :]
    band = r > a
    for b in range(B):
        n = int(ns[b])
        CLOSE, MBC, ACCB, ACCMB, STKO, I11O, B0RO, JRB, JSN = (
            mo[k][b] for k in P8.OUTSIDE_TABLES)
        mbu1 = float(scal[b, 2])
        kw = KW[b, :ROWS]
        ring = torch.zeros((N + 32, N + 32))    # span s at row s, lane l at 32 + l
        g_h, pm_h, pm2_h = (torch.zeros((N + 1, N)) for _ in range(3))
        qa_prev = torch.zeros(N)
        g_prev, p2prev = torch.zeros(N), torch.zeros(N)
        for d in range(n - 1, -1, -1):
            m = n - d
            i = torch.arange(m)
            span_ok = d + 1 >= min_span
            c = CLOSE[d, :m]
            pos = c >= PP.FLT_MIN
            inv = torch.where(pos, 1.0 / torch.where(pos, c, 1.0), 0.0)
            base = c * ACCB[d, :m] * extR[b, d + 1:d + 1 + m]
            win = torch.zeros(m)
            cells = torch.nonzero(pos & span_ok)[:, 0]
            if len(cells):
                GW = group_size(len(cells), T)
                x = ring[d + 1 + r, 32 + cells[:, None, None] - 1 - a]
                prod = torch.where(band, kw * x, torch.zeros(()))
                win[cells] = split_window(prod, GW, drop)
                if seen is not None:
                    seen["GW"].add(GW)
            at = lambda age, off: ring[d + 1 + age, 32 - off:32 - off + m]
            jrb = JRB[d, :m]
            two = jrb * win
            two = two + STKO[d, :m] * at(1, 1)
            two = two + B0RO[d, :m] * at(2, 1)
            two = two + jrb * b0lo[b, :m] * at(2, 2)
            two = two + I11O[d, :m] * at(3, 2)
            two = two * c
            k = parts(m, T)
            if seen is not None:
                seen["k"].add(k)
            # pm: u < n - 2 - d - i; sa, sbc: u < min(i, n - 1 - d)
            U = max(n - 1 - d, 1)
            u = torch.arange(U)[None, :]
            okp = u < (n - 2 - d - i)[:, None]
            oks = u < torch.minimum(i, torch.tensor(n - 1 - d))[:, None]
            gi = (d + 2 + u).clamp(max=N)
            pm_t = torch.where(okp, g_h[gi, i[:, None]] * one[b][
                u.clamp(max=N - 1), (i[:, None] + d + 1).clamp(max=N - 1)],
                0.0)
            src_r = (d + 1 + u).clamp(max=N)
            src_l = (i[:, None] - 1 - u).clamp(min=0)
            q = QONE[b][(u + 1).clamp(max=N - 1), i[:, None]]
            sa_t = torch.where(oks, pm2_h[src_r, src_l] * q, 0.0)
            sbc_t = torch.where(oks, pm_h[src_r, src_l] * q, 0.0)
            pm = split_parts(pm_t, 0, k, drop)
            sa = split_parts(sa_t, 0, k, None)
            sbc = split_parts(sbc_t, 0, k, None)
            pm_new = pm if span_ok else torch.zeros(m)
            pm2_raw = g_prev[:m] + mbu1 * p2prev[:m]
            p2prev[:m] = pm2_raw
            pm2_new = pm2_raw if span_ok else torch.zeros(m)
            qa = torch.zeros(m)
            if m > 1:
                qa[1:] = pm_h[d + 1, :m - 1] + mbu1 * qa_prev[:m - 1]
            bp = base + two + c * ACCMB[d, :m] * (sa + sbc + qa)
            bp = torch.where(pos, bp, torch.zeros(())) if span_ok else torch.zeros(m)
            bppo[b, d, :m] = bp
            ring[d, 32:32 + m] = bp * JSN[d, :m] * inv
            g_prev[:m] = bp * MBC[d, :m] * inv
            g_h[d, :m] = g_prev[:m]
            pm_h[d, :m] = pm_new
            pm2_h[d, :m] = pm2_new
            qa_prev = torch.zeros(N)
            qa_prev[:m] = qa
    return bppo


def live(x):
    return chip_smoke.log_live(x, x["mi"]["H"])


def inside_agrees(x, got):
    want = P8.contra_inside_plain(*x["inside_args"])
    mask = live(x)
    return all(bool((g[mask] - w[mask]).abs().le(
        chip_smoke.RTOL_INSIDE * w[mask].abs() + chip_smoke.ATOL_TINY).all())
        for g, w in zip(got, want))


def outside_args(x):
    """K2's arguments as the main path hands them: CLOSE 0 at every dead
    cell, as K1 leaves it (the plain inside pass computes those cells)."""
    mo, one, QONE, extR, b0lo, KW, scal, ns, min_span = x["outside_args"]
    mo = dict(mo, CLOSE=torch.where(live(x), mo["CLOSE"], torch.zeros(())))
    return mo, one, QONE, extR, b0lo, KW, scal, ns, min_span


def outside_agrees(x, got):
    want = P8.contra_outside_plain(*outside_args(x))
    mask = live(x)
    return float((got[mask] - want[mask]).abs().max()) <= chip_smoke.ATOL_BPPO


def launchable(N):
    return [T for T in THREADS if T >= N]


@pytest.mark.parametrize("T", THREADS)
def test_inside_split_matches_plain(inputs, T):
    seen = {"k": set(), "GW": set()}
    got = inside_replica(*inputs["inside_args"], T, seen=seen)
    assert inside_agrees(inputs, got)
    N = inputs["mi"]["H"].shape[1]
    # every part count of this T at N: k = T / m32 for m32 = 32 .. N
    assert seen["k"] == {T // m32 for m32 in range(32, N + 1, 32)}
    assert seen["GW"]


@pytest.mark.parametrize("T", THREADS)
def test_outside_split_matches_plain(inputs, T):
    seen = {"k": set(), "GW": set()}
    got = outside_replica(*outside_args(inputs), T, seen=seen)
    assert outside_agrees(inputs, got)
    N = inputs["mi"]["H"].shape[1]
    assert seen["k"] == {T // m32 for m32 in range(32, N + 1, 32)}
    assert seen["GW"]


@pytest.mark.parametrize("drop", ["parts", "window"])
def test_inside_split_with_a_term_dropped_fails(inputs, drop):
    got = inside_replica(*inputs["inside_args"], 256, drop=drop)
    assert not inside_agrees(inputs, got)


@pytest.mark.parametrize("drop", ["parts", "window"])
def test_outside_split_with_a_term_dropped_fails(inputs, drop):
    got = outside_replica(*outside_args(inputs), 256, drop=drop)
    assert not outside_agrees(inputs, got)


def test_group_sizes_and_snake():
    """Every group size 1-32 deals each row once, and the rule gives a
    closable count K <= N <= T at least one thread, at most a warp."""
    for GW in (1, 2, 4, 8, 16, 32):
        snake_rows(GW)
    for T in THREADS:
        for K in range(1, T + 1):
            g = group_size(K, T)
            assert 1 <= g <= 32 and K * g <= T
