"""McCaskill's log-space kernels and the host preparation of every fold
kernel (``rna_algos_tpu.ops.pallas_fold``).

The table assembly the probability-space tiers share (``contra_pq_tables``,
``_contra_len_di``, ``turner_precompute_di``, ``_turner_len_di``,
``_skew_qone``, ``contra_outside_aux``) and the parity tier: the log-space
[d, i] tables (``contra_precompute_di``, ``onep``), the reductions that fix
the association of every cubic log-add (``_win_rows``, ``_live_heights``,
``_lse_rows``), kernels K16-K19 (CONTRA and Turner, inside and outside) with
their plain versions, and the whole log-space folds
``mccaskill_contra_pallas`` / ``mccaskill_turner_pallas``.  Everything takes
a leading batch dimension.
"""

import functools

import numpy as np
import torch

from ..constants import (
    MAX_HAIRPIN_LEN_EXTRAPOLATION,
    MAX_LOOP_LEN,
    MIN_HAIRPIN_LEN,
    MIN_HAIRPIN_LEN_EXTRAPOLATION,
    MIN_SPAN_HAIRPIN_CLOSE,
    NEG_INF,
)
from ..numerics import lse_pair

from . import _build
from . import scores as S
from .diag import shift_pq
from .lut import sep_lookup as SEP
from .pallas_skew import skew_pq_batch

W = 31    # 2-loop window extent (MAX_LOOP_LEN + 1)
W2 = 32   # window rows (the extra row is a zero pad)


def contra_pq_tables(seqs, ns, ct, N):
    """[p, q]-layout log score tables: (pq dict of (B, N, N), vb0_m1,
    vb0_x1 (B, N)).  ``seqs`` (B, N) int64, ``ns`` (B,) int."""
    hc = ct["helix_close_scores"]
    tm = ct["terminal_mismatch_scores"]
    dl = ct["dangling_scores_left"]
    dr = ct["dangling_scores_right"]
    bp = ct["basepair_scores"]
    stk = ct["stack_scores"]
    b0x1 = ct["bulge_scores_0x1"]
    i1x1 = ct["interior_scores_1x1"]
    device = seqs.device
    zero = torch.zeros((), device=device)

    pvec = torch.arange(N, device=device)
    x0 = seqs
    x1 = S.sget(seqs, pvec + 1)
    m1 = S.sget(seqs, pvec - 1)
    qv = pvec[None, None, :]
    pv = pvec[None, :, None]
    n = ns.to(device).view(-1, 1, 1)

    JSpq = SEP(hc, (x0,), (x0,)) + SEP(
        tm, (x0, x1), (x0, m1), perm=(0, 2, 1, 3)
    )
    JSrevpq = SEP(hc, (x0,), (x0,), perm=(1, 0)) + SEP(
        tm, (x0, m1), (x0, x1), perm=(1, 3, 0, 2)
    )
    BPpq = SEP(bp, (x0,), (x0,))
    MBCpq = (
        ct["multibranch_score_base"]
        + ct["multibranch_score_basepair"]
        + SEP(hc, (x0,), (x0,))
        + SEP(dl, (x0, x1), (x0,), perm=(0, 2, 1))
        + SEP(dr, (x0,), (x0, m1))
    )
    ACCpq = (
        SEP(hc, (x0,), (x0,), perm=(1, 0))
        + torch.where(
            qv < n - 1, SEP(dl, (x0,), (x0, x1), perm=(1, 0, 2)), zero
        )
        + torch.where(pv > 0, SEP(dr, (x0, m1), (x0,), perm=(1, 2, 0)), zero)
        + BPpq
    )
    canon_pq = SEP(S.canon_mat(device), (x0,), (x0,)) * (qv < n)
    vb0_m1 = b0x1[m1]
    vb0_x1 = b0x1[x1]
    pq = {
        "JS": JSpq,
        "MBC": MBCpq,
        "ACC": ACCpq,
        "CANON": canon_pq,
        "JB": JSrevpq + BPpq,
        "STK": SEP(stk, (x0, x1), (x0, m1), perm=(0, 2, 1, 3))
        + SEP(bp, (x1,), (m1,)),
        "I11": SEP(i1x1, (x1,), (m1,)),
        "B0R": torch.broadcast_to(vb0_m1[:, None, :], (seqs.shape[0], N, N)),
    }
    return pq, vb0_m1, vb0_x1


def _contra_len_di(ct):
    """(W2, W) [b, a] log length/feature constants of the 2-loop body; row
    b = W is a zero pad."""
    bulge, interior = S._contra_len_consts(ct)  # [a, b]
    ab = torch.arange(W, device=bulge.device)
    a, b = ab[:, None], ab[None, :]
    body = torch.where((a == 0) | (b == 0), bulge, interior)
    return torch.cat([body.T, torch.zeros((1, W), device=bulge.device)], dim=0)


def turner_precompute_di(seqs, ns, tt, N):
    """(B, N, N) [d, i] log-space Turner score tables of both kernels.

    As in the JAX package: the position-separable [p, q] lookups, one K3
    skew of all 18 of them, then the [d, i] assembly (hairpin cases with
    the special-hairpin override, the AU/GU terms, and each small-loop raw
    table used twice: minus the inner-pair aug for the inside, translated
    by its (span, lane) offset minus the outer-pair aug for the outside)."""
    stk = tt["stack"]
    i1 = tt["int_1x1"]
    i2 = tt["int_1x2"]
    i4 = tt["int_2x2"]
    b1 = tt["bulge_init"][1]
    dev = seqs.device
    zero = torch.zeros((), device=dev)

    pvec = torch.arange(N, device=dev)
    x0 = seqs
    x1, x2, x3 = (S.sget(seqs, pvec + k) for k in (1, 2, 3))
    m1, m2, m3 = (S.sget(seqs, pvec - k) for k in (1, 2, 3))
    qv = pvec[None, None, :]
    pv = pvec[None, :, None]
    n = ns.to(dev).view(-1, 1, 1)

    augu_pq = SEP(S.augu_mat(dev), (x0,), (x0,)) * tt["augu_penalty"]
    MBCpq = (
        tt["init_multibranch_base"]
        + SEP(tt["tm_multibranch"], (x0, x1), (x0, m1), perm=(1, 3, 0, 2))
        + augu_pq
    )
    c_tm = SEP(tt["tm_multibranch"], (x0, m1), (x0, x1), perm=(0, 2, 1, 3))
    c_d5 = SEP(tt["dangle5"], (x0, m1), (x0,), perm=(0, 2, 1))
    c_d3 = SEP(tt["dangle3"], (x0,), (x0, x1))
    has_l = pv > 0
    has_r = qv < n - 1
    ACCpq = (
        torch.where(
            has_l & has_r,
            c_tm,
            torch.where(has_l, c_d5, torch.where(has_r, c_d3, zero)),
        )
        + augu_pq
    )
    canon_pq = SEP(S.canon_mat(dev), (x0,), (x0,)) * (qv < n)

    def tm_o(f):
        return SEP(tt[f], (x0, x1), (x0, m1), perm=(0, 2, 1, 3))

    def tm_i(f):
        return SEP(tt[f], (x0, m1), (x0, x1), perm=(1, 3, 0, 2))

    pq = {
        "AUG": augu_pq,
        "TMH": tm_o("tm_hairpin"),
        "MBC": MBCpq,
        "ACC": ACCpq,
        "CANON": canon_pq,
        "TMo1": tm_o("tm_interior"),
        "TMo2": tm_o("tm_1xmany"),
        "TMo3": tm_o("tm_2x3"),
        "TMi1": tm_i("tm_interior"),
        "TMi2": tm_i("tm_1xmany"),
        "TMi3": tm_i("tm_2x3"),
        "STK": SEP(stk, (x0, x1), (x0, m1), perm=(0, 2, 1, 3)),
        "B01": b1 + SEP(stk, (x0, x1), (x0, m2), perm=(0, 2, 1, 3)),
        "B10": b1 + SEP(stk, (x0, x2), (x0, m1), perm=(0, 2, 1, 3)),
        "I11": SEP(i1, (x0, x1, x2), (x0, m1, m2), perm=(0, 2, 4, 1, 3, 5)),
        "I12": SEP(i2, (x0, x1, x2), (x0, m1, m2, m3),
                   perm=(0, 2, 5, 1, 3, 4, 6)),
        "I21": SEP(i2, (x3, x2, x1, x0), (m2, m1, x0),
                   perm=(1, 3, 4, 6, 0, 2, 5)),
        "I22": SEP(i4, (x0, x1, x2, x3), (x0, m1, m2, m3),
                   perm=(0, 2, 4, 6, 1, 3, 5, 7)),
    }
    names = sorted(pq)
    skewed = skew_pq_batch([pq[k].contiguous() for k in names])
    sk = {k: v.transpose(1, 2) for k, v in zip(names, skewed)}  # [d, i]
    aug_di = sk["AUG"]

    # hairpin; hlen = d - 1 along the span axis
    hlen = torch.arange(N, device=dev)[:, None] - 1
    hp = tt["hairpin_init"]
    init_in = hp[hlen.clamp(0, MAX_HAIRPIN_LEN_EXTRAPOLATION)]
    extrap = hp[MIN_HAIRPIN_LEN_EXTRAPOLATION - 1] + tt[
        "coeff_hairpin_extrap"
    ] * torch.log(
        hlen.clamp(min=1).to(torch.float32)
        / np.float32(MIN_HAIRPIN_LEN_EXTRAPOLATION - 1)
    )
    init = torch.where(hlen <= MAX_HAIRPIN_LEN_EXTRAPOLATION, init_in, extrap)
    generic = torch.where(
        hlen == MIN_HAIRPIN_LEN,
        hp[hlen.clamp(0, MAX_LOOP_LEN)],
        init + sk["TMH"],
    ) + aug_di
    H_sp_di = S.special_hairpin_id(seqs, tt, N).transpose(1, 2)
    out = {
        "H": torch.where(torch.isfinite(H_sp_di), H_sp_di, generic),
        "MBC": sk["MBC"],
        "ACC": sk["ACC"],
        "CANON": torch.where(
            sk["CANON"] > 0.5, zero, torch.full((), NEG_INF, device=dev)
        ),
        "AUGT": aug_di,
    }
    for k in ("TMo1", "TMo2", "TMo3", "TMi1", "TMi2", "TMi3"):
        out[k] = sk[k]
    # small-loop raw tables: name -> (a+b+2 span offset, a+1 lane offset)
    raw_off = {
        "STK": (2, 1), "B01": (3, 1), "B10": (3, 2), "I11": (4, 2),
        "I12": (5, 2), "I21": (5, 3), "I22": (6, 3),
    }
    in_name = {"STK": "STKT", "I11": "I11T", "I12": "I12T", "I21": "I21T",
               "I22": "I22T"}
    for key, (p, l) in raw_off.items():
        raw = sk[key]
        out[in_name.get(key, key)] = raw - shift_pq(aug_di, -p, l)
        out[key + "O"] = shift_pq(raw, p, -l) - shift_pq(aug_di, p, -l)
    return {k: v.contiguous() for k, v in out.items()}


def _turner_len_di(tt):
    """(W2, W) [b, a] log Turner 2-loop constants (bulge init, interior
    init + Ninio); row b = W is a zero pad."""
    init_int, init_bulge, ninio = S._turner_len_consts(tt)  # [a, b]
    pad = torch.zeros((1, W), device=init_int.device)
    return (
        torch.cat([init_bulge.T, pad], dim=0),
        torch.cat([(init_int + ninio).T, pad], dim=0),
    )


def _skew_qone(one_di, N, neg=0.0):
    """QONE[.., t, l] = one(l-t+1, l-1) = one_di[.., t-2, l+1-t] for t >= 2
    and l >= t-1, else ``neg`` (0 in probability space, -inf in log
    space)."""
    device = one_di.device
    t = torch.arange(N, device=device)[:, None]
    l = torch.arange(N, device=device)[None, :]
    ok = (t >= 2) & (l >= t - 1)
    rows = (t - 2).clamp(min=0).expand(N, N)
    cols = (l + 1 - t).clamp(0, N - 1)
    vals = one_di[..., rows, cols]
    return torch.where(ok, vals, torch.full((), neg, device=device))


def contra_outside_aux(ns, ext_di, one_di, N, neg=0.0, one_val=1.0):
    """Outside-kernel inputs derived from the inside outputs.  ``neg`` is
    the empty-ensemble fill and ``one_val`` the unit-ensemble fill: (0, 1)
    in scaled probability space (the defaults), (-inf, 0) in log space.

    Returns (QONE (B, N, N), extL (B, N) = ext(0, i-1), extR (B, 2N) =
    ext(p, n-1) padded with ``one_val``, glob (B,) = ext(0, n-1)).  Unlike
    the TPU version, nothing is pre-rotated by 2N - n: the outside kernels
    index ``one`` (or ``onep``) and ``extR`` at j + 1 directly."""
    device = ext_di.device
    B = ext_di.shape[0]
    ones = torch.full((B, 1), one_val, device=device)
    extL = ext_di[:, :, 0]                              # ext(0, p)
    extL_sh = torch.cat([ones, extL[:, :-1]], dim=1)    # ext(0, i-1)
    pvec = torch.arange(N, device=device)[None, :]
    n = ns.to(device).view(-1, 1)
    rows = (n - 1 - pvec).clamp(0, N - 1)
    vals = torch.gather(ext_di, 1, rows[:, None, :].expand(B, 1, N))[:, 0]
    extR = torch.where(pvec <= n - 1, vals,
                       torch.full((), one_val, device=device))
    extR_pad = torch.cat(
        [extR, torch.full((B, N), one_val, device=device)], dim=1)
    return _skew_qone(one_di, N, neg), extL_sh, extR_pad, extR[:, 0]


# ---------------------------------------------------------------------------
# Parity tier: log-space tables
# ---------------------------------------------------------------------------

MAX_N_LOG = 256   # largest bucket of the log kernels (RNA_LOG_MAX_N)
N_SCAL = 8        # the scalar row: the model's weights, glob at 4


def contra_precompute_di(seqs, ns, ct, N):
    """(B, N, N) [d, i] log-space CONTRA tables of K16 and K17: the [p, q]
    lookups of ``contra_pq_tables``, one K3 skew of all of them, then the
    [d, i] assembly: the hairpin, the CANON mask (0 / -inf), the 2-loop
    specials of the inside pass and their outside translations (STKO,
    I11O, B0RO: plain [d, i] shifts, 0 fill; B0LO the (B, N) lane
    vector)."""
    B = seqs.shape[0]
    dev = seqs.device
    pq, vb0_m1, vb0_x1 = contra_pq_tables(seqs, ns, ct, N)
    names = sorted(pq)
    skewed = skew_pq_batch([pq[k].contiguous() for k in names])
    sk = {k: v.transpose(1, 2) for k, v in zip(names, skewed)}   # [d, i]
    hlen = torch.arange(N, device=dev)[:, None] - 1
    hp = ct["hairpin_scores_len_cumulative"]
    neg = torch.full((), NEG_INF, device=dev)
    out = {
        "H": torch.where(
            (hlen >= 0) & (hlen <= MAX_LOOP_LEN),
            hp[hlen.clamp(0, MAX_LOOP_LEN)] + sk["JS"], neg),
        "MBC": sk["MBC"],
        "ACC": sk["ACC"],
        "JS": sk["JS"],
        "CANON": torch.where(sk["CANON"] > 0.5,
                             torch.zeros((), device=dev), neg),
        "JB": sk["JB"],
        "STK": sk["STK"],
        "I11": sk["I11"],
        "B0R": sk["B0R"],
        "B0L": torch.broadcast_to(vb0_x1[:, None, :], (B, N, N)),
        "STKO": shift_pq(sk["STK"], 2, -1),
        "I11O": shift_pq(sk["I11"], 4, -2),
        "B0RO": shift_pq(sk["B0R"], 2, 0),
        "B0LO": vb0_m1,
    }
    return {k: v.contiguous() for k, v in out.items()}


def onep(one_di, N, neg=NEG_INF):
    """ONEP[.., s, c] = one(c, c+s-1) = one_di[.., s-1, c] for s >= 1 and
    c < N, else ``neg``: (B, N, 2N), the one(j+1, .) rows the outside
    kernels read at c = j + 1 (the TPU version's table before its
    pre-rotation by 2N - n)."""
    B = one_di.shape[0]
    out = torch.full((B, N, 2 * N), neg, device=one_di.device)
    out[:, 1:, :N] = one_di[:, :N - 1]
    return out


def _contra_scal(ct, B, glob=None):
    """The (B, N_SCAL) scalar row of K16/K17: [ext_unpair, ext_bp,
    mb_unpair, mb_bp, glob, 0, 0, 0]."""
    dev = ct["external_score_unpair"].device
    scal = torch.zeros((B, N_SCAL), device=dev)
    scal[:, :4] = torch.stack([
        ct["external_score_unpair"], ct["external_score_basepair"],
        ct["multibranch_score_unpair"], ct["multibranch_score_basepair"],
    ]).to(torch.float32)
    if glob is not None:
        scal[:, 4] = glob
    return scal


def _turner_scal(tt, B, glob=None):
    """The (B, N_SCAL) scalar row of K18/K19: [coeff_num_branches, 0, 0, 0,
    glob, 0, 0, 0]."""
    dev = tt["coeff_num_branches"].device
    scal = torch.zeros((B, N_SCAL), device=dev)
    scal[:, 0] = tt["coeff_num_branches"]
    if glob is not None:
        scal[:, 4] = glob
    return scal


# ---------------------------------------------------------------------------
# Parity tier: the reductions
# ---------------------------------------------------------------------------

def _win_rows(a):
    """Rows of the window tree at lane shift ``a`` (the JAX kernels' block
    height): the next power of two >= the 31 - a live rows, at least 8."""
    live = W - a
    if live <= 8:
        return 8
    if live <= 16:
        return 16
    return W2


def _live_heights(N):
    """The JAX kernels' power-of-two ladder of reduction heights (32, 64,
    ..., N): step k reduces the first height above k (``_live_height``)."""
    hs, h = [], 32
    while h < N:
        hs.append(h)
        h *= 2
    hs.append(N)
    return hs


def _live_height(N, k):
    return next(h for h in _live_heights(N) if k < h)


def _lse(a, b):
    return lse_pair(a, b, "parity")


def _lse_rows(x):
    """Cubic-LSE tree over axis 0 (the rows), the parity branch of the JAX
    ``_lse_rows``: a power-of-two height halves level by level, x[k] with
    x[k + h/2]; another height splits at the largest power of two below it.

    lse_pair(x, -inf) is x exactly, so rows of -inf past the live ones are
    identities: any power-of-two height covering the live rows gives the
    same bits.  The plain versions reduce the JAX kernels' heights
    (``_win_rows``, ``_live_height``); the kernels the least power of two
    covering the live rows (``csrc/fold_log.cuh``)."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    if n & (n - 1) == 0:
        while x.shape[0] > 1:
            h = x.shape[0] // 2
            x = _lse(x[:h], x[h:])
        return x[0]
    p = 1
    while p * 2 < n:
        p *= 2
    return _lse(_lse_rows(x[:p]), _lse_rows(x[p:]))


def _fold_windows(tl):
    """The 2-loop term of a span from its (B, 31, 32, N) [a, b] window
    terms: the tree over the ``_win_rows(a)`` rows b at each shift a, added
    to the sum in order a = 0..30 (the JAX kernels' window loop)."""
    sums = [None] * W
    for h in sorted({_win_rows(a) for a in range(W)}):
        shifts = [a for a in range(W) if _win_rows(a) == h]
        trees = _lse_rows(tl[:, shifts, :h].permute(2, 0, 1, 3))
        for k, a in enumerate(shifts):
            sums[a] = trees[:, k]
    two = torch.full_like(sums[0], NEG_INF)
    for a in range(W):
        two = _lse(two, sums[a])
    return two


class _LogInRing:
    """Plain-version inside window buffer: span s at row s + 32 (rows below
    32 are the spans < 0), lanes 0..N-1 and a 33-lane pad, all -inf until
    written.  ``window(d)`` is the (B, 31, 32, N) block of the pair's inner
    cells: span d-2-a-b at lane i+1+a."""

    def __init__(self, B, N, dev):
        self.N = N
        self.buf = torch.full((B, N + 32, N + 33), NEG_INF, device=dev)
        a = torch.arange(W, device=dev)[:, None]
        b = torch.arange(W2, device=dev)[None, :]
        self.rows = 30 - a - b
        self.lanes = torch.arange(N, device=dev)[None, :] + 1 + a

    def window(self, d):
        rows = (self.rows + d).clamp(min=0)
        return self.buf[:, rows[:, :, None], self.lanes[:, None, :]]

    def put(self, d, row):
        self.buf[:, d + 32, :self.N] = row


class _LogOutRing:
    """Plain-version outside window buffer: span s at row s (rows past the
    spans written stay -inf), lane l at column 32 + l (-inf to the left).
    ``window(d)`` is the (B, 31, 32, N) block of the outer cells: span
    d+2+a+b at lane i-1-a."""

    def __init__(self, B, N, dev):
        self.N = N
        self.buf = torch.full((B, N + 64, N + 32), NEG_INF, device=dev)
        a = torch.arange(W, device=dev)[:, None]
        b = torch.arange(W2, device=dev)[None, :]
        self.rows = 2 + a + b
        self.lanes = torch.arange(N, device=dev)[None, :] + 31 - a

    def window(self, d):
        rows = self.rows + d
        return self.buf[:, rows[:, :, None], self.lanes[:, None, :]]

    def put(self, d, row):
        self.buf[:, d, 32:] = row


def _window_grid(dev):
    """(a, b) grids of the window: the loop-length cap (a + b <= 30) and
    the bulge cells (a == 0 or b == 0), each (1, 31, 32, 1)."""
    a = torch.arange(W, device=dev)[:, None]
    b = torch.arange(W2, device=dev)[None, :]
    live = (a + b <= MAX_LOOP_LEN)[None, :, :, None]
    bulge = ((a == 0) | (b == 0))[None, :, :, None]
    return live, bulge


def _lanes4(x):
    """(B, N) -> (B, 1, 1, N)."""
    return x[:, None, None, :]


def _len4(L):
    """(W2, W) [b, a] constants -> (1, 31, 32, 1) [a, b]."""
    return L.T[None, :, :, None]


# ---------------------------------------------------------------------------
# Inside: the recurrences K16 and K18 share
# ---------------------------------------------------------------------------

def _inside_log_plain(H, MBC, ACC, CANON, scal, ns, two_at, insert, contra):
    """The log-space inside pass for the whole batch: (close, ext, one),
    each (B, N, N) [d, i]; rows at or past a sequence's length keep the
    JAX kernels' fills (-inf, 0, -inf).  ``two_at(d)`` is the 2-loop term
    of span d; ``insert(d, close)`` records span d in the windows."""
    B, N, _ = H.shape
    dev = H.device
    neg = torch.full((), NEG_INF, device=dev)
    close = torch.full((B, N, N), NEG_INF, device=dev)
    ext = torch.zeros((B, N, N), device=dev)
    one = torch.full((B, N, N), NEG_INF, device=dev)
    RM = torch.full((B, N, 2 * N), NEG_INF, device=dev)    # rm, span rows
    RMM = torch.full((B, N, 2 * N), NEG_INF, device=dev)   # rmmb
    S2 = torch.full((B, N, N + 1), NEG_INF, device=dev)    # s2, lane pad
    lanes = torch.arange(N, device=dev)
    s0, s1_, s2_, s3 = (scal[:, k:k + 1] for k in range(4))
    ns_d = ns.to(dev).view(-1, 1)
    rm = torch.full((B, N), NEG_INF, device=dev)
    rmm = rm
    for d in range(int(ns.max())):
        two = two_at(d)
        mb = S2[:, d - 2, 1:] + MBC[:, d] if d >= 2 else neg.expand(B, N)
        c = _lse(_lse(H[:, d], two), mb) + CANON[:, d]
        if d + 1 < MIN_SPAN_HAIRPIN_CLOSE:
            c = neg.expand(B, N)
        acc = c + ACC[:, d]
        if contra:       # s0..s3: ext_unpair, ext_bp, mb_unpair, mb_bp
            rm = _lse(rm + s0, acc + s1_)
            rmm = _lse(rmm + s2_, acc + s3)
        else:            # s0: the branch coefficient
            rm = _lse(rm, acc)
            rmm = rm
        RM[:, d, :N] = rm
        RMM[:, d, :N] = rmm
        t = torch.arange(_live_height(N, d), device=dev)
        rows = (d - t).clamp(min=0)[:, None]
        cols = lanes[None, :] + t[:, None]
        fq, fqm = RM[:, rows, cols], RMM[:, rows, cols]      # (B, P, N)
        tc = t[None, :, None]
        prev = (t - 1).clamp(min=0)
        extr = torch.where(tc == 0, torch.zeros((), device=dev),
                           ext[:, prev])
        onet = torch.where(tc == 0, neg, one[:, prev])
        terms = torch.where(tc <= d - 1, fq + extr, neg)
        live = (tc >= 1) & (tc <= d - 1)
        if contra:
            base = s0 * float(d + 1)
            x = torch.where(live, fqm, neg)
            s1 = _lse(rmm, _lse_rows(
                (x + s2_[:, :, None] * t.to(torch.float32)[None, :, None])
                .transpose(0, 1)))
        else:
            base = torch.zeros((B, 1), device=dev)
            x = torch.where(live, fq + s0[:, :, None], neg)
            s1 = _lse(rm + s0, _lse_rows(x.transpose(0, 1)))
        ext_new = _lse(base, _lse_rows(terms.transpose(0, 1)))
        s2 = _lse_rows((onet + x).transpose(0, 1))
        S2[:, d, :N] = s2
        act = d < ns_d
        close[:, d] = torch.where(act, c, neg)
        ext[:, d] = torch.where(act, ext_new, torch.zeros((), device=dev))
        one[:, d] = torch.where(act, _lse(s1, s2), neg)
        insert(d, c)
    return close, ext, one


# ---------------------------------------------------------------------------
# Outside: the recurrences K17 and K19 share
# ---------------------------------------------------------------------------

def _outside_log_plain(CLOSE, MBC, ACC, ONEP, QONE, EXTL, EXTR, scal, ns,
                       min_span, two_at, insert, contra):
    """The log-space outside pass for the whole batch: bppo (B, N, N)
    [d, i], -inf where close is -inf, below ``min_span`` and in every cell
    past a sequence's end (i + d >= n).  ``two_at(d, close)`` is the 2-loop
    context of span d (close added); ``insert(d, bppo, act)`` records span
    d in the windows (-inf where ``act`` is False: the cells past the end
    stay empty, as K17/K19, which never compute them, leave them)."""
    B, N, _ = CLOSE.shape
    dev = CLOSE.device
    neg = torch.full((), NEG_INF, device=dev)
    bppo = torch.full((B, N, N), NEG_INF, device=dev)
    G = torch.full((B, N + 1, N), NEG_INF, device=dev)       # g, span rows
    PM = torch.full((B, 2 * N, 2 * N), NEG_INF, device=dev)  # lane N + l
    PM2 = torch.full((B, 2 * N, 2 * N), NEG_INF, device=dev)
    lanes = torch.arange(N, device=dev)
    s0, s1_, s2_, s3, glob = (scal[:, k:k + 1] for k in range(5))
    tq = (torch.arange(N, device=dev) - 1).to(torch.float32)[None, :, None]
    if contra:           # s0..s3: ext_unpair, ext_bp, mb_unpair, mb_bp
        qmb = _lse(QONE, s2_[:, :, None] * tq)
        mb_bp = s3
    else:                # s0: the branch coefficient
        qmb = _lse(QONE, torch.zeros((), device=dev))
        mb_bp = s0
    ns_d = ns.to(dev).view(-1, 1)
    n_max = int(ns.max())
    for d in range(n_max - 1, -1, -1):
        act = d + lanes[None, :] <= ns_d - 1     # live cells of span d
        span_ok = d + 1 >= min_span
        c = CLOSE[:, d]
        acc = c + ACC[:, d]
        base = ((EXTL + acc) + EXTR[:, d + 1:d + 1 + N]) - glob
        if contra:
            base = base + s1_
        two = two_at(d, c)
        acc_mb = (acc + mb_bp)[:, None, :]
        # one height for the batch: the first rung above the longest
        # sequence's step n - 1 - d
        s = t = torch.arange(_live_height(N, n_max - 1 - d), device=dev)
        g = G[:, (d + 1 + s).clamp(max=N)]                      # (B, P, N)
        # the live terms only, s < n - 1 - d - i: past them g is -inf and
        # ONEP holds the inside pass's dead cells
        live_s = (s[None, :, None] + d + lanes[None, None, :]
                  < ns_d[:, :, None] - 1)
        one_s = ONEP[:, s, d + 1:d + 1 + N]
        pm = _lse_rows(torch.where(live_s, g + one_s, neg).transpose(0, 1))
        if contra:
            pm2 = _lse_rows((g + s2_[:, :, None]
                             * s.to(torch.float32)[None, :, None])
                            .transpose(0, 1))
        else:
            pm2 = _lse_rows(g.transpose(0, 1))
        if not span_ok:
            pm = pm2 = neg.expand(B, N)
        rows = (d + t)[:, None]
        cols = N + lanes[None, :] - t[:, None]
        m1 = (t >= 1)[None, :, None]
        ta = torch.where(m1, (acc_mb + PM2[:, rows, cols]) + QONE[:, t], neg)
        tbc = torch.where(m1, (acc_mb + PM[:, rows, cols]) + qmb[:, t], neg)
        mb_ctx = _lse(_lse_rows(ta.transpose(0, 1)),
                      _lse_rows(tbc.transpose(0, 1)))
        bp = _lse(_lse(base, two), mb_ctx)
        ok = c > NEG_INF
        bp = torch.where(ok & span_ok, bp, neg)
        bppo[:, d] = torch.where(act, bp, neg)
        G[:, d] = torch.where(act & ok, (bp + MBC[:, d]) - c, neg)
        PM[:, d, N:] = torch.where(act, pm, neg)
        PM2[:, d, N:] = torch.where(act, pm2, neg)
        insert(d, bp, act)
    return bppo


# ---------------------------------------------------------------------------
# K16 / K17: CONTRA
# ---------------------------------------------------------------------------

CONTRA_INSIDE_LOG_TABLES = (
    "H", "MBC", "ACC", "JS", "STK", "I11", "B0R", "B0L", "CANON", "JB",
)
CONTRA_OUTSIDE_LOG_TABLES = (
    "CLOSE", "MBC", "ACC", "STKO", "I11O", "B0RO", "JB", "JS",
)

contra_inside_log_launches = _build.LaunchCounter("contra_inside_log")
contra_outside_log_launches = _build.LaunchCounter("contra_outside_log")


def contra_inside_log_plain(mats, LEN, scal, ns):
    """Plain version of K16 for the whole batch: (close, ext, one)."""
    H, MBC, ACC, JS, STK, I11, B0R, B0L, CANON, JB = (
        mats[k] for k in CONTRA_INSIDE_LOG_TABLES)
    B, N, _ = H.shape
    dev = H.device
    ring = _LogInRing(B, N, dev)            # close + jb
    live, _bulge = _window_grid(dev)
    len4 = _len4(LEN)

    def two_at(d):
        body = _lanes4(JS[:, d]) + len4
        # the stack replaces js/jb/len: subtract the jb(d-2, i+1) that the
        # window cell carries (0 where that span or lane does not exist)
        jbr = torch.zeros((B, N), device=dev)
        if d >= 2:
            jbr[:, :N - 1] = JB[:, d - 2, 1:]
        body[:, 0, 0] = STK[:, d] - jbr
        body[:, 0, 1] = body[:, 0, 1] + B0R[:, d]
        body[:, 1, 0] = body[:, 1, 0] + B0L[:, d]
        body[:, 1, 1] = body[:, 1, 1] + I11[:, d]
        tl = torch.where(live, body, NEG_INF) + ring.window(d)
        return _fold_windows(tl)

    def insert(d, c):
        ring.put(d, c + JB[:, d])

    return _inside_log_plain(H, MBC, ACC, CANON, scal, ns, two_at, insert,
                             contra=True)


def contra_outside_log_plain(mo, ONEP, QONE, B0LO, EXTL, EXTR, LEN, scal, ns,
                             min_span):
    """Plain version of K17 for the whole batch: bppo (B, N, N) [d, i]."""
    CLOSE, MBC, ACC, STKO, I11O, B0RO, JB, JS = (
        mo[k] for k in CONTRA_OUTSIDE_LOG_TABLES)
    B, N, _ = CLOSE.shape
    dev = CLOSE.device
    ring = _LogOutRing(B, N, dev)           # bppo - close + js
    live, _bulge = _window_grid(dev)
    len4 = _len4(LEN)
    ns_d = ns.to(dev).view(-1, 1)
    lanes = torch.arange(N, device=dev)

    def two_at(d, c):
        body = _lanes4(JB[:, d]) + len4
        # the stack replaces jrb/jsn/len: subtract the js(d+2, i-1) that the
        # window cell carries (0 where that cell is past the sequence's end,
        # i + d + 1 >= n, and never read)
        jsr = torch.zeros((B, N), device=dev)
        if d + 2 <= N - 1:
            jsr[:, 1:] = torch.where(lanes[None, 1:] + d + 1 <= ns_d - 1,
                                     JS[:, d + 2, :N - 1],
                                     torch.zeros((), device=dev))
        body[:, 0, 0] = STKO[:, d] - jsr
        body[:, 0, 1] = body[:, 0, 1] + B0RO[:, d]
        body[:, 1, 0] = body[:, 1, 0] + B0LO
        body[:, 1, 1] = body[:, 1, 1] + I11O[:, d]
        tl = torch.where(live, body, NEG_INF) + ring.window(d)
        return _fold_windows(tl + _lanes4(c))

    def insert(d, bp, act):
        c = CLOSE[:, d]
        ring.put(d, torch.where(act & (c > NEG_INF), (bp - c) + JS[:, d],
                                NEG_INF))

    return _outside_log_plain(CLOSE, MBC, ACC, ONEP, QONE, EXTL, EXTR, scal,
                              ns, min_span, two_at, insert, contra=True)


def _log_device(name, t):
    """'cpu' or 'cuda' for a log kernel's input, else raise; N checked."""
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    N = t.shape[-1]
    if dev.type == "cuda" and (N < 32 or N > MAX_N_LOG or N & (N - 1)):
        raise ValueError(f"{name}: N = {N} (need a power of two in "
                         f"[32, {MAX_N_LOG}])")
    return dev.type


def _outside_log_scratch(B, N, dev):
    """K17's and K19's scratch: g (B, N, N) transposed ([i][d]), (pm2, pm)
    (B, N, N, 2) by pair end ([i + d][i]), QONEMB (B, N, N) transposed."""
    return (torch.empty((B, N, N), device=dev),
            torch.empty((B, N, N, 2), device=dev),
            torch.empty((B, N, N), device=dev))


def _inside_log_scratch(B, N, dev, contra):
    """K16's and K18's scratch: rm (Turner) or (rm, rmmb) (CONTRA) by pair
    end ([i + d][i]), (ext, one) transposed ([i][d], (B, N, N, 2))."""
    rm = torch.empty((B, N, N, 2) if contra else (B, N, N), device=dev)
    return rm, torch.empty((B, N, N, 2), device=dev)


def log_group(N):
    """Threads a lane of K17 and K19 at N, and the fewest K16 and K18 give
    a lane: one block of 1,024 threads a sequence, at most a warp a lane
    (csrc/fold_log.cuh ``rna_log_group``); no cluster.  The batch does not
    enter: at the main shapes half as many threads a lane ran K17/K19
    1.4-1.6x slower (an H100 80GB HBM3 at 700 W, PERF.md section 6)."""
    return _build.library().lib.rna_log_group_of(N)


def _check_log(entry, tables, names, extra, extra_shapes, B, N, dev):
    ins = {k: tables[k] for k in names}
    ins.update(extra)
    shapes = {k: (B, N, N) for k in names}
    shapes.update(extra_shapes)
    _build.check_cuda(entry, ins, shapes, dev)


def contra_inside_log(mats, LEN, scal, ns):
    """Kernel K16 (``csrc/contra_inside_log.cu``) for CUDA tensors, its
    plain version for CPU tensors.  ``mats``: the (B, N, N) [d, i] tables
    of ``contra_precompute_di`` (CONTRA_INSIDE_LOG_TABLES); ``LEN`` (32, 31)
    ``_contra_len_di``; ``scal`` (B, 8) ``_contra_scal``; ``ns`` (B,) int32.
    Returns (close, ext, one), each (B, N, N) [d, i]; the kernel leaves
    the cells past a sequence's end (i + d >= n) their fills (-inf, 0,
    -inf), which nothing downstream reads."""
    H = mats["H"]
    if _log_device("contra_inside_log", H) == "cpu":
        return contra_inside_log_plain(mats, LEN, scal, ns)
    dev = H.device
    B, N, _ = H.shape
    _check_log("rna_contra_inside_log", mats, CONTRA_INSIDE_LOG_TABLES,
               dict(LEN=LEN, scal=scal, ns=ns),
               dict(LEN=(W2, W), scal=(B, N_SCAL), ns=(B,)), B, N, dev)
    close = torch.full((B, N, N), NEG_INF, device=dev)
    ext = torch.zeros((B, N, N), device=dev)
    one = torch.full((B, N, N), NEG_INF, device=dev)
    rmp, eo = _inside_log_scratch(B, N, dev, contra=True)
    args = [LEN, scal, ns, close, ext, one, rmp, eo]
    _build.library().call(
        "rna_contra_inside_log",
        _build.ptr_array(mats, CONTRA_INSIDE_LOG_TABLES),
        *[_build.ptr(t) for t in args], B, N, _build.stream_ptr(dev),
    )
    contra_inside_log_launches.add()
    return close, ext, one


def contra_outside_log(mo, ONEP, QONE, B0LO, EXTL, EXTR, LEN, scal, ns,
                       min_span):
    """Kernel K17 (``csrc/contra_outside_log.cu``) for CUDA tensors, its
    plain version for CPU tensors.  ``mo``: the (B, N, N) tables of
    CONTRA_OUTSIDE_LOG_TABLES (CLOSE the inside's close); ``ONEP`` (B, N,
    2N) ``onep``; ``QONE`` (B, N, N), ``EXTL`` (B, N), ``EXTR`` (B, 2N)
    from ``contra_outside_aux`` in log space; ``B0LO`` (B, N); ``LEN``
    (32, 31); ``scal`` (B, 8) with glob; ``ns`` (B,) int32.  Returns bppo
    (B, N, N) [d, i]: the log outside x inside weight of each pair."""
    CLOSE = mo["CLOSE"]
    if _log_device("contra_outside_log", CLOSE) == "cpu":
        return contra_outside_log_plain(mo, ONEP, QONE, B0LO, EXTL, EXTR,
                                        LEN, scal, ns, min_span)
    dev = CLOSE.device
    B, N, _ = CLOSE.shape
    _check_log("rna_contra_outside_log", mo, CONTRA_OUTSIDE_LOG_TABLES,
               dict(ONEP=ONEP, QONE=QONE, B0LO=B0LO, EXTL=EXTL, EXTR=EXTR,
                    LEN=LEN, scal=scal, ns=ns),
               dict(ONEP=(B, N, 2 * N), QONE=(B, N, N), B0LO=(B, N),
                    EXTL=(B, N), EXTR=(B, 2 * N), LEN=(W2, W),
                    scal=(B, N_SCAL), ns=(B,)), B, N, dev)
    bppo = torch.full((B, N, N), NEG_INF, device=dev)
    g, pp, qmb = _outside_log_scratch(B, N, dev)
    args = [ONEP, QONE, B0LO, EXTL, EXTR, LEN, scal, ns, bppo, g, pp, qmb]
    _build.library().call(
        "rna_contra_outside_log",
        _build.ptr_array(mo, CONTRA_OUTSIDE_LOG_TABLES),
        *[_build.ptr(t) for t in args], B, N, int(min_span),
        _build.stream_ptr(dev),
    )
    contra_outside_log_launches.add()
    return bppo


def mccaskill_contra_pallas(seqs, ns, ct, N, allows_short_hairpins=False):
    """CONTRA McCaskill in log space through K16 and K17, the parity tier.
    ``seqs`` (B, N) int64, ``ns`` (B,) int32, ``ct`` ``weights.contra_tables``.
    Returns (bppo, close, ext, one), each (B, N, N) [d, i], as the JAX
    function does."""
    B = seqs.shape[0]
    ns = ns.to(torch.int32)
    mats = contra_precompute_di(seqs, ns, ct, N)
    LEN = _contra_len_di(ct).contiguous()
    close, ext, one = contra_inside_log(mats, LEN, _contra_scal(ct, B), ns)
    QONE, extL, extR, glob = contra_outside_aux(ns, ext, one, N, NEG_INF, 0.0)
    mo = {k: mats[k] for k in CONTRA_OUTSIDE_LOG_TABLES if k != "CLOSE"}
    mo["CLOSE"] = close
    min_span = 2 if allows_short_hairpins else MIN_SPAN_HAIRPIN_CLOSE
    bppo = contra_outside_log(
        mo, onep(one, N), QONE.contiguous(), mats["B0LO"],
        extL.contiguous(), extR.contiguous(), LEN, _contra_scal(ct, B, glob),
        ns, min_span)
    return bppo, close, ext, one


# ---------------------------------------------------------------------------
# K18 / K19: Turner
# ---------------------------------------------------------------------------

TURNER_INSIDE_LOG_TABLES = (
    "H", "MBC", "ACC", "CANON", "STKT", "B01", "B10", "I11T", "I12T",
    "I21T", "I22T", "TMo1", "TMo2", "TMo3", "AUGT", "TMi1", "TMi2", "TMi3",
)
TURNER_OUTSIDE_LOG_TABLES = (
    "CLOSE", "MBC", "ACC", "STKO", "B01O", "B10O", "I11O", "I12O", "I21O",
    "I22O", "TMo1", "TMo2", "TMo3", "AUGT", "TMi1", "TMi2", "TMi3",
)
# The small-loop cells (a, b) whose score replaces the generic body, in the
# order of the tables above (inside STKT..I22T, outside STKO..I22O).
TURNER_SPECIAL_CELLS = ((0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (2, 1),
                        (2, 2))

turner_inside_log_launches = _build.LaunchCounter("turner_inside_log")
turner_outside_log_launches = _build.LaunchCounter("turner_outside_log")


def _turner_family(dev):
    """(1, 31, 32, 1) terminal-mismatch family of each window cell: 2 where
    a == 1 or b == 1 (1 x n loops), 3 at the 2 x 3 cells (2, 3) and
    (3, 2), else 1 (generic interior)."""
    a = torch.arange(W, device=dev)[:, None]
    b = torch.arange(W2, device=dev)[None, :]
    fam = torch.ones((W, W2), dtype=torch.int64, device=dev)
    fam = torch.where((a == 2) & (b == 3) | (a == 3) & (b == 2), 3, fam)
    fam = torch.where((a == 1) | (b == 1), 2, fam)
    return fam[None, :, :, None]


def _turner_window(blk, wins, tmo, aug, specials, LENB, LENI, live, bulge,
                   fam):
    """The (B, 31, 32, N) Turner window terms ``_turner_tl``: the bulge
    body LENB + aug; else LENI + TM(pair) + TM(window cell) + aug of the
    cell's family; the seven small-loop cells replaced by their tables;
    the loop-length cap; + the merged window ``blk``."""
    pick = functools.partial(torch.where, fam == 2)

    def by_family(x1, x2, x3):
        return pick(x2, torch.where(fam == 3, x3, x1))

    aug4 = _lanes4(aug)
    gen = ((_len4(LENI) + by_family(*(_lanes4(t) for t in tmo)))
           + by_family(*wins)) + aug4
    body = torch.where(bulge, _len4(LENB) + aug4, gen)
    for (a, b), row in zip(TURNER_SPECIAL_CELLS, specials):
        body[:, a, b] = row
    return torch.where(live, body, NEG_INF) + blk


def turner_inside_log_plain(mats, LENB, LENI, scal, ns):
    """Plain version of K18 for the whole batch: (close, ext, one).  Window
    rings: close + AUGT (the merged window) and the three inner
    terminal-mismatch tables TMi1..3."""
    B, N, _ = mats["H"].shape
    dev = mats["H"].device
    caw, *tws = (_LogInRing(B, N, dev) for _ in range(4))
    live, bulge = _window_grid(dev)
    fam = _turner_family(dev)
    specials = TURNER_INSIDE_LOG_TABLES[4:11]

    def two_at(d):
        tl = _turner_window(
            caw.window(d), [r.window(d) for r in tws],
            [mats[k][:, d] for k in ("TMo1", "TMo2", "TMo3")],
            mats["AUGT"][:, d], [mats[k][:, d] for k in specials],
            LENB, LENI, live, bulge, fam)
        return _fold_windows(tl)

    def insert(d, c):
        caw.put(d, c + mats["AUGT"][:, d])
        for r, k in zip(tws, ("TMi1", "TMi2", "TMi3")):
            r.put(d, mats[k][:, d])

    return _inside_log_plain(mats["H"], mats["MBC"], mats["ACC"],
                             mats["CANON"], scal, ns, two_at, insert,
                             contra=False)


def turner_outside_log_plain(mo, ONEP, QONE, EXTL, EXTR, LENB, LENI, scal,
                             ns, min_span):
    """Plain version of K19 for the whole batch: bppo (B, N, N) [d, i].
    Window rings: bppo - close + AUGT and the three outer
    terminal-mismatch tables TMo1..3 of each span reached."""
    CLOSE = mo["CLOSE"]
    B, N, _ = CLOSE.shape
    dev = CLOSE.device
    og, *tws = (_LogOutRing(B, N, dev) for _ in range(4))
    live, bulge = _window_grid(dev)
    fam = _turner_family(dev)
    specials = TURNER_OUTSIDE_LOG_TABLES[3:10]

    def two_at(d, c):
        tl = _turner_window(
            og.window(d), [r.window(d) for r in tws],
            [mo[k][:, d] for k in ("TMi1", "TMi2", "TMi3")],
            mo["AUGT"][:, d], [mo[k][:, d] for k in specials],
            LENB, LENI, live, bulge, fam)
        return _fold_windows(tl + _lanes4(c))

    def insert(d, bp, act):
        c = CLOSE[:, d]
        og.put(d, torch.where(act & (c > NEG_INF),
                              (bp - c) + mo["AUGT"][:, d], NEG_INF))
        for r, k in zip(tws, ("TMo1", "TMo2", "TMo3")):
            r.put(d, torch.where(act, mo[k][:, d], NEG_INF))

    return _outside_log_plain(CLOSE, mo["MBC"], mo["ACC"], ONEP, QONE, EXTL,
                              EXTR, scal, ns, min_span, two_at, insert,
                              contra=False)


def turner_inside_log(mats, LENB, LENI, scal, ns):
    """Kernel K18 (``csrc/turner_inside_log.cu``) for CUDA tensors, its
    plain version for CPU tensors.  ``mats``: the (B, N, N) [d, i] tables
    of ``turner_precompute_di`` (TURNER_INSIDE_LOG_TABLES); ``LENB``,
    ``LENI`` (32, 31) ``_turner_len_di``; ``scal`` (B, 8)
    ``_turner_scal``; ``ns`` (B,) int32.  Returns (close, ext, one), the
    cells past a sequence's end left their fills as K16 leaves them."""
    H = mats["H"]
    if _log_device("turner_inside_log", H) == "cpu":
        return turner_inside_log_plain(mats, LENB, LENI, scal, ns)
    dev = H.device
    B, N, _ = H.shape
    _check_log("rna_turner_inside_log", mats, TURNER_INSIDE_LOG_TABLES,
               dict(LENB=LENB, LENI=LENI, scal=scal, ns=ns),
               dict(LENB=(W2, W), LENI=(W2, W), scal=(B, N_SCAL), ns=(B,)),
               B, N, dev)
    close = torch.full((B, N, N), NEG_INF, device=dev)
    ext = torch.zeros((B, N, N), device=dev)
    one = torch.full((B, N, N), NEG_INF, device=dev)
    rmp, eo = _inside_log_scratch(B, N, dev, contra=False)
    args = [LENB, LENI, scal, ns, close, ext, one, rmp, eo]
    _build.library().call(
        "rna_turner_inside_log",
        _build.ptr_array(mats, TURNER_INSIDE_LOG_TABLES),
        *[_build.ptr(t) for t in args], B, N, _build.stream_ptr(dev),
    )
    turner_inside_log_launches.add()
    return close, ext, one


def turner_outside_log(mo, ONEP, QONE, EXTL, EXTR, LENB, LENI, scal, ns,
                       min_span):
    """Kernel K19 (``csrc/turner_outside_log.cu``) for CUDA tensors, its
    plain version for CPU tensors.  ``mo``: the (B, N, N) tables of
    TURNER_OUTSIDE_LOG_TABLES (CLOSE the inside's close); the rest as for
    ``contra_outside_log``.  Returns bppo (B, N, N) [d, i]."""
    CLOSE = mo["CLOSE"]
    if _log_device("turner_outside_log", CLOSE) == "cpu":
        return turner_outside_log_plain(mo, ONEP, QONE, EXTL, EXTR, LENB,
                                        LENI, scal, ns, min_span)
    dev = CLOSE.device
    B, N, _ = CLOSE.shape
    _check_log("rna_turner_outside_log", mo, TURNER_OUTSIDE_LOG_TABLES,
               dict(ONEP=ONEP, QONE=QONE, EXTL=EXTL, EXTR=EXTR, LENB=LENB,
                    LENI=LENI, scal=scal, ns=ns),
               dict(ONEP=(B, N, 2 * N), QONE=(B, N, N), EXTL=(B, N),
                    EXTR=(B, 2 * N), LENB=(W2, W), LENI=(W2, W),
                    scal=(B, N_SCAL), ns=(B,)), B, N, dev)
    bppo = torch.full((B, N, N), NEG_INF, device=dev)
    g, pp, qmb = _outside_log_scratch(B, N, dev)
    args = [ONEP, QONE, EXTL, EXTR, LENB, LENI, scal, ns, bppo, g, pp, qmb]
    _build.library().call(
        "rna_turner_outside_log",
        _build.ptr_array(mo, TURNER_OUTSIDE_LOG_TABLES),
        *[_build.ptr(t) for t in args], B, N, int(min_span),
        _build.stream_ptr(dev),
    )
    turner_outside_log_launches.add()
    return bppo


def mccaskill_turner_pallas(seqs, ns, tt, N):
    """Turner McCaskill in log space through K18 and K19, the parity tier.
    ``tt`` ``weights.turner_tables``.  Returns (bppo, close, ext, one), each
    (B, N, N) [d, i]."""
    B = seqs.shape[0]
    ns = ns.to(torch.int32)
    mats = turner_precompute_di(seqs, ns, tt, N)
    LENB, LENI = (x.contiguous() for x in _turner_len_di(tt))
    close, ext, one = turner_inside_log(mats, LENB, LENI, _turner_scal(tt, B),
                                        ns)
    QONE, extL, extR, glob = contra_outside_aux(ns, ext, one, N, NEG_INF, 0.0)
    mo = {k: mats[k] for k in TURNER_OUTSIDE_LOG_TABLES if k != "CLOSE"}
    mo["CLOSE"] = close
    bppo = turner_outside_log(
        mo, onep(one, N), QONE.contiguous(), extL.contiguous(),
        extR.contiguous(), LENB, LENI, _turner_scal(tt, B, glob), ns,
        MIN_SPAN_HAIRPIN_CLOSE)
    return bppo, close, ext, one
